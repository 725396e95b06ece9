"""The frame encoder: CNN-pruned All-Intra mode decision + wavefront
reconstruction (port of hevctpu/pipeline/encoder.py, main path).

  Stage 1 (dense "search"): for every CU/PU position at every depth, all
  35 modes are scored by SATD (K1, ops/satd_fused.py), the top candidates
  plus the MPMs are RD-evaluated (on the card under the global rate
  model, one launch of stage 1's RD kernel a size, ops/stage1_rd.py), and
  the TU tree, NxN and chroma decisions follow, all as batched tensor ops
  over the frame.

  Stage 2 (wavefront reconstruction): with the partition fixed by the CNN
  labels and the modes by stage 1, CTUs are reconstructed in wavefront
  diagonals (d = 2r + c), TUs in z-order within each CTU, exactly as a
  decoder would: predict -> transform -> RDOQ/TS/SBH -> dequant ->
  inverse -> recon.

The JAX package runs stage 2 as nested lax.scans over every TU step of
a static schedule, with fire masks taken on the device. The port keeps
that form (_Wavefront: every diagonal at its fixed width, TU decisions
on the device). On the card its gather and scatter are captured once per
batch size, QP map and tile as CUDA graphs and replayed, and between
them one launch of the stage-2 kernel (ops/stage2_ctu.py) codes each
CTU's own TUs, with nothing read back to the host; eagerly on the CPU,
424 masked TU steps a diagonal, it is the kernel's plain version. The
CPU's encodes run stage 2 planned on the host: the fire masks and
availability vectors depend only on stage 1's partition and the
geometry, so they are planned once per batch (_stage2_plan), uploaded in
one copy, and a step that fires for no CTU of its diagonal is skipped (a
masked step writes nothing). All update the extended recon buffers in
place and give the same planes.

The options follow the JAX package: the full-RD quadtree search
(search="rd"), per-CTU QP maps (qp_map, for LCU-level rate control), the
coding-tool switches, the context rate model (rate_model="ctx"), recon-
feedback decisions (two_pass: stage 1 again on the first pass's recon
boundaries) and the lite transfer (lite=True: the output dict packed on
the device, unpacked by collect). Under a parallel.Mesh of more than one
tile (parallel.ShardedEncoder), stage 2 runs on this rank's tile of CTU
columns, with halo exchanges between the tiles after every diagonal.

The dispatch (encode_dispatch, encode_fused_dispatch) returns once the
inputs are uploaded, as the JAX package's returns before the device
finishes: the encode runs on one worker thread an encoder, in dispatch
order, and collect() waits for it. Each dispatch carries its record
(Dispatch.trace, pipeline/trace.py): host spans of the caller's upload and
collect, of the worker's stages and of every stage-2 diagonal, and the
stage clock.
"""

from __future__ import annotations

import collections.abc
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from hevctpu_torch import device_table, get_device, rom
from hevctpu_torch.ops import (ctu, deblock, intra, intra_mm, quant, rate,
                               rate_ctx, rd, sao, satd_fused, stage1_rd,
                               stage2_ctu, transforms)
from hevctpu_torch.ops.quant import seqsum
from hevctpu_torch.pipeline import trace

# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geometry:
    h: int
    w: int

    @property
    def rc(self) -> int:
        return -(-self.h // 64)

    @property
    def cc(self) -> int:
        return -(-self.w // 64)

    @property
    def hp(self) -> int:
        return self.rc * 64

    @property
    def wp(self) -> int:
        return self.cc * 64

    @functools.cached_property
    def wavefront(self):
        """(act_r, act_c, act_mask) [D, A]: CTUs active on each diagonal
        d = 2r + c (the WPP dependency order); wavefront_tiled's one
        tile."""
        return tuple(t[0] for t in self.wavefront_tiled(1))

    @functools.cached_property
    def bh_bw(self):
        bh = np.clip(self.h - 64 * np.arange(self.rc), 0, 64).astype(np.int32)
        bw = np.clip(self.w - 64 * np.arange(self.cc), 0, 64).astype(np.int32)
        return bh, bw

    @functools.lru_cache(maxsize=None)
    def wavefront_tiled(self, tiles: int):
        """Per-tile wavefront tables [T, D, A]: each tile owns cc/tiles
        contiguous CTU columns; a diagonal's active set is restricted to
        the tile's own columns (act_c stays GLOBAL for coordinate math;
        subtract the tile's base for local indexing). D is the global
        number of diagonals, the same for every tile; A is the largest
        per-tile per-diagonal occupancy."""
        rc, cc = self.rc, self.cc
        if cc % tiles:
            raise ValueError(f"{cc} CTU columns do not divide into {tiles} "
                             f"tiles")
        cl = cc // tiles
        d_tot = 2 * (rc - 1) + cc
        sets = [[[(r, c) for r in range(rc) for c in range(cc)
                  if 2 * r + c == d and t * cl <= c < (t + 1) * cl]
                 for d in range(d_tot)] for t in range(tiles)]
        a = max(len(cells) for per_t in sets for cells in per_t)
        a = max(a, 1)
        act_r = np.zeros((tiles, d_tot, a), dtype=np.int32)
        act_c = np.zeros((tiles, d_tot, a), dtype=np.int32)
        act_m = np.zeros((tiles, d_tot, a), dtype=bool)
        for t in range(tiles):
            for d, cells in enumerate(sets[t]):
                for j, (r, c) in enumerate(cells):
                    act_r[t, d, j], act_c[t, d, j] = r, c
                    act_m[t, d, j] = True
        return act_r, act_c, act_m


def pad_plane(p: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Edge-replicate pad [..., H, W] -> [..., hp, wp]."""
    h, w = p.shape[-2:]
    ri = torch.clamp(torch.arange(hp, device=p.device), max=h - 1)
    ci = torch.clamp(torch.arange(wp, device=p.device), max=w - 1)
    return p.index_select(-2, ri).index_select(-1, ci)


def to_blocked(plane: torch.Tensor, n: int) -> torch.Tensor:
    """[..., R*n, C*n] -> [..., R, C, n, n] (a view)."""
    s = plane.shape
    r, c = s[-2] // n, s[-1] // n
    return plane.reshape(*s[:-2], r, n, c, n).transpose(-3, -2)


def from_blocked(b: torch.Tensor) -> torch.Tensor:
    s = b.shape
    return b.transpose(-3, -2).reshape(*s[:-4], s[-4] * s[-2],
                                       s[-3] * s[-1])


def _rep2(x: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat each of the last two axes k times."""
    return x.repeat_interleave(k, dim=-2).repeat_interleave(k, dim=-1)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """Float 2x2 pooling sum over the last two axes (order-fixed)."""
    *lead, r, c = x.shape
    return seqsum(x.reshape(*lead, r // 2, 2, c // 2, 2), (-3, -1))


# ---------------------------------------------------------------------------
# Stage 1: dense mode decision
# ---------------------------------------------------------------------------

# Row chunk budget of the dense RD intermediates (memory only).
_CHUNK_BYTES = 1 << 30


@functools.lru_cache(maxsize=None)
def _grid_avail(geom: Geometry, n: int, scale: int = 1) -> np.ndarray:
    """Static availability mask [R, C, 4n+1] for every aligned n x n block
    of the plane (scale=2 for chroma: CTU span 32, half-res picture)."""
    span = 64 // scale
    hp, wp = geom.hp // scale, geom.wp // scale
    gy, gx = np.meshgrid(np.arange(0, hp, n), np.arange(0, wp, n),
                         indexing="ij")
    gy, gx = gy.ravel(), gx.ravel()
    zm = ctu.morton(span // 4)
    av = ctu.boundary_available(
        gy % span, gx % span, n, zm[(gy % span) // 4, (gx % span) // 4],
        (gy // span) * span, (gx // span) * span,
        geom.h // scale, geom.w // scale, scale=scale)
    return av.reshape(hp // n, wp // n, 4 * n + 1)


@functools.lru_cache(maxsize=None)
def _grid_avail_t(geom: Geometry, n: int, scale: int,
                  device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_grid_avail(geom, n, scale), device=device)


def _grid_refs(bsrc: torch.Tensor, geom: Geometry, n: int, scale: int):
    """Filled + smoothed references of every aligned n x n block, read from
    the plane bsrc: (top_ext, left_ext, top_f, left_f), each
    [B, R, C, 2n+1]."""
    bounds = intra_mm.grid_boundaries(bsrc, n)
    filled = intra.fill_reference(bounds,
                                  _grid_avail_t(geom, n, scale, bsrc.device))
    top_e, left_e = intra.split_boundary(filled, n)
    return (top_e, left_e) + intra.smooth_reference(top_e, left_e, n)


def _dense_costs(plane: torch.Tensor, geom: Geometry, n: int,
                 bsrc: torch.Tensor | None = None) -> torch.Tensor:
    """SATD of all 35 luma modes at every aligned n x n position, through
    K1: plane [B, hp, wp] -> [B, R, C, 35] int32. bsrc (default: plane)
    is the plane the neighbor boundaries are read from: a prior pass's
    reconstruction under two_pass."""
    refs = _grid_refs(plane if bsrc is None else bsrc, geom, n, 1)
    return satd_fused.dense_mode_costs(*refs, to_blocked(plane, n), n)


_MODE_IDX = np.arange(35, dtype=np.int32)
_MB_GLOBAL = (1.8, 2.8, 5.8)  # fitted (mpm0, mpm1/2, rem) signaling bits


def _mode_bits_tab(qp: int, rate_model: str):
    """(mpm_idx0, mpm_idx1/2, non-mpm) signaling bits."""
    if rate_model == "ctx":
        return rate_ctx.mode_signal_bits(qp)
    return _MB_GLOBAL


def _mpm_modes(best: torch.Tensor):
    """3-entry MPM list per grid position (H.265 8.4.2) from the grid of
    provisional decisions `best` [B, R, C] (left/above same-size
    neighbors; unavailable counts as DC). Returns (m0, m1, m2) int32."""
    a = F.pad(best[:, :, :-1], (1, 0), value=rom.DC_IDX)         # left
    bm = F.pad(best[:, :-1, :], (0, 0, 1, 0), value=rom.DC_IDX)  # above
    eq = a == bm
    a_small = a < 2
    m0 = torch.where(eq, torch.where(a_small, rom.PLANAR_IDX, a), a)
    m1 = torch.where(eq, torch.where(a_small, rom.DC_IDX,
                                     2 + ((a + 29) % 32)), bm)
    m2_eq = torch.where(a_small, rom.VER_IDX, 2 + ((a - 1) % 32))
    has_pl = (a == rom.PLANAR_IDX) | (bm == rom.PLANAR_IDX)
    has_dc = (a == rom.DC_IDX) | (bm == rom.DC_IDX)
    m2_ne = torch.where(~has_pl, rom.PLANAR_IDX,
                        torch.where(~has_dc, rom.DC_IDX, rom.VER_IDX))
    m2 = torch.where(eq, m2_eq, m2_ne)
    i32 = torch.int32
    return m0.to(i32), m1.to(i32), m2.to(i32)


def _mode_bits_at(cand: torch.Tensor, m0, m1, m2, scale: float,
                  mb=_MB_GLOBAL) -> torch.Tensor:
    """scale-weighted signaling cost [..., K] float32 of the candidate
    modes given the MPM triple: prev_intra_luma_pred_flag + mpm_idx, or
    flag + 5 bypass bins; mb holds the three totals (_mode_bits_tab)."""
    is0 = cand == m0[..., None]
    is12 = (cand == m1[..., None]) | (cand == m2[..., None])
    bits = torch.where(is0, mb[0], torch.where(is12, mb[1], mb[2]))
    return (scale * bits).to(torch.float32)


def _dense_rd_candidates(plane: torch.Tensor, geom: Geometry, n: int,
                         cand: torch.Tensor, qp: int, lam: float, *,
                         is_luma: bool = True, scale: int = 1,
                         bsrc: torch.Tensor | None = None,
                         rate_model: str = "ctx",
                         cbf_ctx: int | None = None) -> torch.Tensor:
    """Full-RD cost [B, R, C, K] float32 of the candidate modes cand
    [B, R, C, K] at every aligned n x n position (residual RD only;
    mode-signaling bits are the caller's). Boundaries come from bsrc
    (default: plane), blocks from plane. On the card under "global" the
    whole call is one launch of stage 1's RD kernel (ops/stage1_rd.py);
    elsewhere, and under "ctx", its plain version _dense_rd_plain."""
    if rate_model == "global" and plane.device.type == "cuda":
        return stage1_rd.rd_costs(
            plane.to(torch.int32).contiguous(),
            (plane if bsrc is None else bsrc).to(torch.int32).contiguous(),
            _grid_avail_t(geom, n, scale, plane.device),
            cand.to(torch.int32).contiguous(), n, qp, lam, is_luma=is_luma)
    return _dense_rd_plain(plane, geom, n, cand, qp, lam, is_luma=is_luma,
                           scale=scale, bsrc=bsrc, rate_model=rate_model,
                           cbf_ctx=cbf_ctx)


def _dense_rd_plain(plane: torch.Tensor, geom: Geometry, n: int,
                    cand: torch.Tensor, qp: int, lam: float, *,
                    is_luma: bool = True, scale: int = 1,
                    bsrc: torch.Tensor | None = None,
                    rate_model: str = "ctx",
                    cbf_ctx: int | None = None) -> torch.Tensor:
    """_dense_rd_candidates in aten ops, on any device: predict all 35
    (one matmul), gather the K candidates, transform + quant + rate for
    those (rate_model and cbf_ctx go to rd.mode_rd_costs), in row chunks
    of at most _CHUNK_BYTES of intermediates."""
    b, hp, wp = plane.shape
    r_n, c_n = hp // n, wp // n
    kc = cand.shape[-1]
    refs = _grid_refs(plane if bsrc is None else bsrc, geom, n, scale)
    blocks = to_blocked(plane, n)
    log2 = int(np.log2(n))
    per_tu = 18 if rate_model == "ctx" else 6    # live [.., K, n, n] words
    per_row = b * c_n * (35 + per_tu * kc) * n * n * 8
    rows = int(max(1, min(r_n, _CHUNK_BYTES // per_row)))
    out = []
    for r0 in range(0, r_n, rows):
        sl = slice(r0, r0 + rows)
        preds = intra_mm.predict_all_modes_mm(
            *(x[:, sl] for x in refs), n, is_luma=is_luma)
        cd = cand[:, sl].long()
        sel = torch.gather(preds, -3, cd[..., None, None].expand(
            cd.shape + (n, n)))
        rdc, _, _ = rd.mode_rd_costs(sel, blocks[:, sl], log2, qp, lam=lam,
                                     dst=(is_luma and n == 4),
                                     is_luma=is_luma, rate_model=rate_model,
                                     cbf_ctx=cbf_ctx)
        out.append(rdc)
    return torch.cat(out, dim=1)


# SATD-preselection candidate count per block size (HM's
# g_aucIntraModeNumFast_UseMPM); the 3 MPMs are force-included on top.
_NUM_CAND = {4: 8, 8: 8, 16: 3, 32: 3, 64: 3}


def _pass1_candidates(satd: torch.Tensor, lam: float, n: int,
                      mb=_MB_GLOBAL):
    """HM's pass-1 preselection: SATD + sqrt(λ)·mode-bits, keep top-N
    (lowest cost, lower mode first on ties, as lax.top_k), then the 3
    MPMs from the provisional SATD argmin grid. satd [B, R, C, 35] ->
    (cand [B, R, C, N+3] int32, (m0, m1, m2))."""
    prov = satd.argmin(dim=-1).to(torch.int32)
    m0, m1, m2 = _mpm_modes(prov)
    all_modes = torch.as_tensor(_MODE_IDX, device=satd.device).expand(
        satd.shape)
    p1 = satd.to(torch.float32) + _mode_bits_at(
        all_modes, m0, m1, m2, float(np.sqrt(lam)), mb)
    topn = torch.sort(p1, dim=-1, stable=True).indices[..., :_NUM_CAND[n]]
    cand = torch.cat([topn.to(torch.int32), m0[..., None], m1[..., None],
                      m2[..., None]], dim=-1)
    return cand, (m0, m1, m2)


def _best_of(rdc: torch.Tensor, cand: torch.Tensor):
    """(mode, cost) of the cheapest candidate (first on ties)."""
    cost, best = torch.min(rdc, dim=-1)
    return torch.gather(cand, -1, best[..., None])[..., 0], cost


def _dense_mode_decision(plane: torch.Tensor, geom: Geometry, qp: int,
                         bsrc: torch.Tensor | None = None,
                         rate_model: str = "ctx"):
    """RD-best luma mode + cost for every CU/PU position at every depth:
    pass 1 scores all 35 modes by SATD + sqrt(λ)·mode-bits (K1), pass 2
    full-RDs the top-N + 3 MPM candidates. Returns (modes {n: [B,R,C]
    int32}, costs {n: [B,R,C] float32}) for n in (64, 32, 16, 8, 4); the
    64 entry evaluates its candidates as four 32x32 TUs. Boundaries come
    from bsrc (default: plane)."""
    lam = rate.lambda_rd(qp)
    mb = _mode_bits_tab(qp, rate_model)
    modes, costs = {}, {}
    satd32 = None
    for n in (32, 16, 8, 4):
        satd = _dense_costs(plane, geom, n, bsrc)
        cand, (m0, m1, m2) = _pass1_candidates(satd, lam, n, mb)
        rdc = (_dense_rd_candidates(plane, geom, n, cand, qp, lam,
                                    bsrc=bsrc, rate_model=rate_model)
               + _mode_bits_at(cand, m0, m1, m2, lam, mb))
        modes[n], costs[n] = _best_of(rdc, cand)
        if n == 32:
            satd32 = satd
    # 64-CU: pool quadrant SATDs per mode, preselect, then RD the four
    # 32x32 TUs at each shared candidate mode.
    b, r32, c32 = satd32.shape[:3]
    s64 = satd32.reshape(b, r32 // 2, 2, c32 // 2, 2, 35).sum(
        dim=(2, 4)).to(torch.int32)
    cand64, (m0, m1, m2) = _pass1_candidates(s64, lam, 64, mb)
    rd_q = _dense_rd_candidates(plane, geom, 32, _rep2(cand64.movedim(-1, 1),
                                                       2).movedim(1, -1),
                                qp, lam, bsrc=bsrc, rate_model=rate_model)
    kc = cand64.shape[-1]
    rd64 = (seqsum(rd_q.reshape(b, r32 // 2, 2, c32 // 2, 2, kc), (2, 4))
            + _mode_bits_at(cand64, m0, m1, m2, lam, mb))
    modes[64], costs[64] = _best_of(rd64, cand64)
    return modes, costs


_CHROMA_LIST = np.array([rom.PLANAR_IDX, rom.VER_IDX, rom.HOR_IDX,
                         rom.DC_IDX], np.int32)
_CHROMA_SEL_BITS = (2.6, 2.6, 2.6, 2.6, 0.6)   # 4 list entries, DM


def _dense_chroma_decision(up, vp, geom: Geometry, qp: int, qp_c: int,
                           luma_modes: dict, bsrc_u=None, bsrc_v=None,
                           rate_model: str = "ctx"):
    """Per-CU chroma mode selection: joint Cb+Cr RD of the 4 list modes
    (with the ==luma -> 34 substitution) and DM, keyed by luma CU size n
    in (64, 32, 16, 8); boundaries from bsrc_u/bsrc_v (default: the
    planes). Returns (csel {n: [B,R,C] int32, 0..3 list index or 4 = DM},
    cmode {n: [B,R,C] int32 resolved chroma mode}, ccost {n: [B,R,C]
    float32 w_c-weighted joint chroma RD at the choice})."""
    lam = rate.lambda_rd(qp)
    w_c = rate.chroma_dist_weight(qp, qp_c)
    lam_c = lam / w_c
    sel = (rate_ctx.chroma_sel_bits(qp) if rate_model == "ctx"
           else _CHROMA_SEL_BITS)
    sel_bits = torch.as_tensor(sel, dtype=torch.float32,
                               device=up.device) * lam_c
    chroma_list = torch.as_tensor(_CHROMA_LIST, device=up.device)
    csel, cmode, ccost = {}, {}, {}
    for n in (64, 32, 16, 8):
        m = n // 2
        lm = luma_modes[n]
        cand = chroma_list.expand(lm.shape + (4,))
        cand = torch.where(cand == lm[..., None], 34, cand)
        cand = torch.cat([cand, lm[..., None]], dim=-1)        # slot 4 = DM
        rd_u = _dense_rd_candidates(up, geom, m, cand, qp_c, lam_c,
                                    is_luma=False, scale=2, bsrc=bsrc_u,
                                    rate_model=rate_model, cbf_ctx=0)
        rd_v = _dense_rd_candidates(vp, geom, m, cand, qp_c, lam_c,
                                    is_luma=False, scale=2, bsrc=bsrc_v,
                                    rate_model=rate_model, cbf_ctx=0)
        jc = rd_u + rd_v + sel_bits
        jmin, best = torch.min(jc, dim=-1)
        csel[n] = best.to(torch.int32)
        cmode[n] = torch.gather(cand, -1, best[..., None])[..., 0]
        ccost[n] = w_c * jmin
    return csel, cmode, ccost


def _rd_split_labels(costs: dict, qp: int,
                     rate_model: str = "ctx") -> torch.Tensor:
    """Bottom-up RD quadtree decision -> per-CTU 16-label vectors: the
    merged cost of the four children (+ the split_cu_flag bins) against
    the parent CU, pooled 2x2 at each level. Under "ctx" every other
    syntax element is already in the per-CU costs, and the split_cu_flag
    bins are priced at init state (middle neighbor-depth context); the
    "global" model keeps the fitted per-CU and split overheads. costs
    {n: [B, R, C]} for n in (64, 32, 16, 8). Returns labels
    [B, rc*cc, 16] int32 in the CNN-label layout."""
    lam = rate.lambda_rd(qp)
    if rate_model == "ctx":
        s0, s1 = rate_ctx.split_cu_bits(qp)
        oh_cu = 0.0
        oh_self, oh_split = lam * s0, lam * s1
    else:
        oh_cu = lam * 3.2    # per-CU fixed bins: chroma mode + cbf flags
        oh_self, oh_split = 0.0, lam * 0.8  # split_cu_flag bin

    c8 = costs[8] + oh_cu                    # min CU: no split flag
    c16_split = _pool2(c8) + oh_split
    c16_self = costs[16] + oh_cu + oh_self
    take16 = c16_self <= c16_split
    c16 = torch.minimum(c16_self, c16_split)

    c32_split = _pool2(c16) + oh_split
    c32_self = costs[32] + oh_cu + oh_self
    take32 = c32_self <= c32_split
    c32 = torch.minimum(c32_self, c32_split)

    c64_split = _pool2(c32) + oh_split
    c64_self = costs[64] + 4 * oh_cu + oh_self         # codes as 4 TU32s
    take64 = c64_self <= c64_split

    # labels per 16x16 block: 0/1/2/3 by the nesting decisions
    lab = torch.where(_rep2(take64, 4), 0,
                      torch.where(_rep2(take32, 2), 1,
                                  torch.where(take16, 2, 3)))
    b, r16, c16n = lab.shape
    rc, cc = r16 // 4, c16n // 4
    lab = lab.reshape(b, rc, 4, cc, 4).permute(0, 1, 3, 2, 4)
    return lab.reshape(b, rc * cc, 16).to(torch.int32)


def _tu_tree_decision(plane: torch.Tensor, geom: Geometry, qp: int,
                      cu_log2: int, mode_cu: torch.Tensor, bsrc=None,
                      rate_model: str = "ctx"):
    """Intra TU quadtree RD decision (checkFull vs checkSplit, max depth 3)
    for every CU position of size 2^cu_log2 with per-CU mode mode_cu
    [B, Rc, Cc]: the RD of each TU size over the whole frame (boundaries
    from bsrc, default plane), folded bottom-up. Returns (cost [B,Rc,Cc]
    best-tree luma RD, rd_full [B,Rc,Cc] unsplit-TU RD, tusz [B, h8, w8]
    per-slot leaf log2)."""
    lam = rate.lambda_rd(qp)
    top = min(cu_log2, 5)
    bottom = max(2, cu_log2 - 3)
    b = plane.shape[0]

    rd_map = {}
    for s_log2 in range(bottom, top + 1):
        mode_s = _rep2(mode_cu, 1 << (cu_log2 - s_log2))
        rd_map[s_log2] = _dense_rd_candidates(
            plane, geom, 1 << s_log2, mode_s[..., None], qp, lam, bsrc=bsrc,
            rate_model=rate_model,
            cbf_ctx=1 if s_log2 == top else 0)[..., 0]

    t = rd_map[bottom]
    split = {}
    for s_log2 in range(bottom + 1, top + 1):
        if rate_model == "ctx":
            # split_transform_flag at ctx 5-log2 (init state) + ~1 bin of
            # duplicated chroma cbf signaling at the split node
            st0, st1 = rate_ctx.split_tu_bits(qp, s_log2)
            oh = lam * (st1 - st0 + 1.0)
        else:
            oh = lam * 1.8    # split_transform_flag + duplicated chroma cbf
        tsplit = _pool2(t) + oh
        split[s_log2] = tsplit < rd_map[s_log2]
        t = torch.minimum(rd_map[s_log2], tsplit)

    if top < cu_log2:                 # CU64: four 32 trees, split inferred
        cost, rd_full = _pool2(t), _pool2(rd_map[5])
    else:
        cost, rd_full = t, rd_map[top]

    # leaf-size map at 8x8-slot granularity, top-down
    tusz = torch.full((b, geom.hp // 8, geom.wp // 8), top, dtype=torch.int32,
                      device=plane.device)
    ex = None
    for s_log2 in range(top, bottom, -1):
        sp = split[s_log2]
        if ex is not None:
            sp = sp & ex
        tusz = torch.where(_rep2(sp, max((1 << s_log2) // 8, 1)),
                           s_log2 - 1, tusz)
        ex = _rep2(sp, 2)
    return cost, rd_full, tusz


# ---------------------------------------------------------------------------
# Stage 2: wavefront reconstruction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _zorder_avail_np(oy: int, ox: int, n: int, span: int) -> np.ndarray:
    """Static decoded-before mask [4n+1] for a TU at CTU-local origin
    (oy, ox): z-order within the CTU, wavefront order across CTUs. The
    in-picture check is applied separately."""
    dy, dx = ctu.boundary_offsets(n)
    ly, lx = oy + dy, ox + dx
    same = (ly >= 0) & (lx >= 0) & (ly < span) & (lx < span)
    zmap = ctu.morton(span // 4)
    zb = zmap[np.clip(ly, 0, span - 1) // 4, np.clip(lx, 0, span - 1) // 4]
    z_tu = zmap[oy // 4, ox // 4]
    above = ly < 0
    left_of = (lx < 0) & (ly >= 0) & (ly < span)
    return np.where(same, zb < z_tu, above | left_of)


@functools.lru_cache(maxsize=None)
def _block16_schedule():
    """Static per-iteration tables of the z-order scan over the 16 16-pel
    blocks of a CTU: origins, quadrant-leader flags and decoded-before
    vectors of the TU32/TU16/TU8/TU4 substeps (luma + chroma)."""
    ty = np.zeros(16, np.int32)
    tx = np.zeros(16, np.int32)
    is_q = np.zeros(16, bool)
    av32 = np.zeros((16, 129), bool)
    av32c = np.zeros((16, 65), bool)
    av16 = np.zeros((16, 65), bool)
    av16c = np.zeros((16, 33), bool)
    av8 = np.zeros((16, 4, 33), bool)
    av8c = np.zeros((16, 4, 17), bool)
    av4 = np.zeros((16, 4, 4, 17), bool)
    for t in range(16):
        qy, qx = ((t // 4) // 2) * 32, ((t // 4) % 2) * 32
        y, x = qy + ((t % 4) // 2) * 16, qx + ((t % 4) % 2) * 16
        ty[t], tx[t], is_q[t] = y, x, (t % 4) == 0
        av32[t] = _zorder_avail_np(qy, qx, 32, 64)
        av32c[t] = _zorder_avail_np(qy // 2, qx // 2, 16, 32)
        av16[t] = _zorder_avail_np(y, x, 16, 64)
        av16c[t] = _zorder_avail_np(y // 2, x // 2, 8, 32)
        for e in range(4):
            ey, ex = y + (e // 2) * 8, x + (e % 2) * 8
            av8[t, e] = _zorder_avail_np(ey, ex, 8, 64)
            av8c[t, e] = _zorder_avail_np(ey // 2, ex // 2, 4, 32)
            for q in range(4):
                av4[t, e, q] = _zorder_avail_np(ey + (q // 2) * 4,
                                                ex + (q % 2) * 4, 4, 64)
    return ty, tx, is_q, av32, av32c, av16, av16c, av8, av8c, av4


@functools.lru_cache(maxsize=None)
def _kernel_schedule():
    """_Wavefront's walk as the stage-2 kernel reads it
    (ops/stage2_ctu.py): (steps [340, 8] int32, masks int32). A step per
    TU of _tu_order, from _block16_schedule: n, oy, ox (CTU-local luma),
    the leaf log2 at which its luma TU fires (_tu; 2 for the TU4 steps of
    _block), its chroma rule (0 none, 1 leaf == log2 n, 2 leaf <= 3: the
    4x4 chroma TU under a TU4 leaf), the offsets in masks of its luma
    [4n+1] and chroma [2n+1] decoded-before masks (0 where none), 0."""
    ty, tx, _, av32, av32c, av16, av16c, av8, av8c, av4 = _block16_schedule()
    steps, masks, size = [], [], [0]

    def at(mask):
        masks.append(mask)
        size[0] += mask.size
        return size[0] - mask.size

    for q in range(4):
        t = 4 * q
        steps.append((32, ty[t], tx[t], 5, 1, at(av32[t]), at(av32c[t]), 0))
        for t in range(4 * q, 4 * q + 4):
            steps.append((16, ty[t], tx[t], 4, 1, at(av16[t]), at(av16c[t]),
                          0))
            for e in range(4):
                ey, ex = ty[t] + (e // 2) * 8, tx[t] + (e % 2) * 8
                steps.append((8, ey, ex, 3, 2, at(av8[t, e]),
                              at(av8c[t, e]), 0))
                for k in range(4):
                    steps.append((4, ey + (k // 2) * 4, ex + (k % 2) * 4, 2,
                                  0, at(av4[t, e, k]), 0, 0))
    return (np.array(steps, np.int32),
            np.concatenate(masks).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _tu_order():
    """The z-order TU steps of one CTU as (size, oy, ox): ctu.tu_schedule
    with each TU8 step followed by its four TU4 steps (the reference's
    scan order)."""
    steps = []
    for n, oy, ox, _ in ctu.tu_schedule():
        steps.append((n, oy, ox))
        if n == 8:
            steps += [(4, oy + (q // 2) * 4, ox + (q % 2) * 4)
                      for q in range(4)]
    return tuple(steps)


class _Upload:
    """Host arrays packed into one buffer per dtype and copied to the
    device in one transfer; add() returns a handle that get() views."""

    def __init__(self):
        self._parts = {np.dtype(np.int64): [], np.dtype(bool): []}
        self._size = dict.fromkeys(self._parts, 0)
        self._buf = {}

    def add(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        key = arr.dtype
        handle = (key, self._size[key], arr.shape)
        self._parts[key].append(arr.ravel())
        self._size[key] += arr.size
        return handle

    def upload(self, device: torch.device):
        for key, parts in self._parts.items():
            host = np.concatenate(parts) if parts else np.zeros(0, key)
            self._buf[key] = torch.from_numpy(host).to(device)

    def get(self, handle) -> torch.Tensor:
        key, off, shape = handle
        return self._buf[key][off: off + int(np.prod(shape))].view(shape)


def _stage2_plan(geom: Geometry, wavefront, tz: np.ndarray, c8: np.ndarray,
                 upload: _Upload, c0: int = 0):
    """Host plan of the wavefront: per diagonal the active CTUs (frame-
    major rows; columns local to the tile) and the TU steps that fire for
    at least one of them, each with its firing mask and availability (in
    picture & decoded before, in global picture coordinates: a tile-
    sharded stream has no HEVC tiles, so a CTU across a tile edge is
    available as in the single-device encode). wavefront is the tile's
    (act_r, act_c, act_m) [D, A] with global columns, c0 the tile's first
    column; tz/c8 [B, rc, cl, 8, 8] are the tile's leaf-TU-size and coded
    slot maps. A diagonal with none of the tile's CTUs plans no step."""
    act_r, act_c, act_m = wavefront
    b = tz.shape[0]
    plan = []
    for dr, dc, dm in zip(act_r, act_c, act_m):
        r = np.tile(dr[dm].astype(np.int64), b)
        c = np.tile(dc[dm].astype(np.int64), b)
        bi = np.repeat(np.arange(b, dtype=np.int64), int(dm.sum()))
        tzd, c8d = tz[bi, r, c - c0], c8[bi, r, c - c0]      # [BA, 8, 8]

        def avail(oy, ox, n, cy, cx, hh, ww, span):
            dy, dx = ctu.boundary_offsets(n)
            fy = cy[:, None] + oy + dy
            fx = cx[:, None] + ox + dx
            inside = (fy >= 0) & (fx >= 0) & (fy < hh) & (fx < ww)
            return upload.add(inside & _zorder_avail_np(oy, ox, n, span))

        steps = []
        for n, oy, ox in _tu_order():
            sy, sx = oy // 8, ox // 8
            coded = c8d[:, sy, sx]
            leaf = tzd[:, sy, sx]
            lum = coded & (leaf == int(np.log2(n)))
            chro = coded & ((leaf <= 3) if n == 8 else lum)
            lstep = cstep = None
            if lum.any():
                lstep = (upload.add(lum),
                         avail(oy, ox, n, r * 64, c * 64, geom.h, geom.w, 64))
            if n > 4 and chro.any():
                cy, cx = np.tile(r * 32, 2), np.tile(c * 32, 2)
                cstep = (upload.add(np.tile(chro, 2)),
                         avail(oy // 2, ox // 2, n // 2, cy, cx,
                               geom.h // 2, geom.w // 2, 32))
            if lstep or cstep:
                steps.append((n, oy, ox, lstep, cstep))
        plan.append((upload.add(np.stack([bi, r, c - c0])), steps))
    return plan


def _tu_chain(vals, av, orig_blk, mode, n: int, qp, *, is_luma: bool,
              rdoq_lam, dst: bool, ts_lam, rate_qp: int, sbh: bool):
    """One TU for every row, from its boundary samples vals [R, 4n+1] in
    scan order (left column bottom-to-top, corner, top row) with their
    availability av and the source block orig_blk [R, n, n]: predict ->
    transform -> RDOQ, or hard-decision quant when rdoq_lam is 0.0 (+ the
    TS trial at 4x4 unless ts_lam is 0.0) -> SBH if sbh -> dequant ->
    inverse -> recon. qp, rdoq_lam and ts_lam are scalars, or per-row [R]
    tensors under a per-CTU QP map (the rate tables then stay at the
    static slice QP rate_qp). Returns (recon, levels, cbf, transform-skip
    flags or None when the trial is off)."""
    filled = intra.fill_reference(vals, av)
    top_e, left_e = intra.split_boundary(filled, n)
    top_f, left_f = intra.smooth_reference(top_e, left_e, n)
    pred = intra_mm.predict_selected_mode_mm(top_e, left_e, top_f, left_f,
                                             mode, n, is_luma=is_luma)
    res = orig_blk - pred
    log2 = int(np.log2(n))
    coef = transforms.forward_transform(res, log2, dst=dst)
    scan_tu = quant.scan_sel(mode, log2, is_luma)

    def quantize(cf, qp_, lam, scan):
        if quant.lam_on(rdoq_lam):
            return quant.quantize_rdoq(cf, log2, qp_, lam, scan=scan,
                                       rate_qp=rate_qp)
        return quant.quantize(cf, log2, qp_)

    use_ts = None
    if n == 4 and quant.lam_on(ts_lam):
        # transform-skip trial: the scaled residual quantizes in the same
        # dynamic range as the transform, so the two candidates compare
        # directly in the coefficient domain. Both go through one call,
        # as rows R..2R-1 after the transform's (rows are independent).
        def twice(x):
            return torch.cat([x, x]) if isinstance(x, torch.Tensor) else x

        shift = rom.MAX_TR_DYNAMIC_RANGE - 8 - log2
        coef_s = res * (1 << shift)
        cf2, qp2 = torch.cat([coef, coef_s]), twice(qp)
        lvl2 = quantize(cf2, qp2, twice(rdoq_lam), scan_tu.repeat(2))
        d = quant.exact_sq_sum(cf2 - quant.dequantize(lvl2, log2, qp2))
        j = d * 4.0 ** (log2 - 7) + twice(ts_lam / rate.BITS_ONE) * (
            rate.estimate_tu_bits(lvl2, log2, rate_qp).to(torch.float32))
        j_t, j_s = j.chunk(2)
        lvl_t, lvl_s = lvl2.chunk(2)
        use_ts = j_s < j_t
        lvl = torch.where(use_ts[:, None, None], lvl_s, lvl_t)
        coef = torch.where(use_ts[:, None, None], coef_s, coef)
    else:
        lvl = quantize(coef, qp, rdoq_lam, scan_tu)
    if sbh:
        lvl = quant.sign_bit_hide(lvl, coef, log2, qp, scan_tu)
    cbf = (lvl != 0).flatten(1).any(dim=1)
    deq = quant.dequantize(lvl, log2, qp)
    rinv = transforms.inverse_transform(deq, log2, dst=dst)
    if use_ts is not None:
        shift = rom.MAX_TR_DYNAMIC_RANGE - 8 - log2
        rinv = torch.where(use_ts[:, None, None],
                           (deq + (1 << (shift - 1))) >> shift, rinv)
    return torch.clamp(pred + rinv, 0, 255), lvl, cbf, use_ts


def _flags(cbf, use_ts, fire):
    """(cbf & fire, transform-skip & cbf & fire)."""
    cbf = cbf & fire
    return cbf, (use_ts & cbf if use_ts is not None
                 else torch.zeros_like(cbf))


def _tu_step(ext, levels, orig, mode, fire, oy: int, ox: int, n: int,
             qp, av, *, is_luma: bool, rdoq_lam, dst: bool, ts_lam,
             rate_qp: int, sbh: bool):
    """One masked TU at the static CTU-local origin (oy, ox) for every row
    (_tu_chain), written into ext and levels in place where `fire`.

    ext [R, span+1+span//2, 2span+2] is the extended CTU-local recon
    (row 0 = above strip, column 0 = left strip, (1+y, 1+x) = pixel
    (y, x); the extra rows/cols are never-available filler). av [R, 4n+1]
    is the availability of the boundary samples. Returns (cbf & fire,
    transform-skip & cbf & fire)."""
    assert (0 <= oy and oy + 2 * n + 1 <= ext.shape[1]
            and 0 <= ox and ox + 2 * n + 1 <= ext.shape[2])
    vals = torch.cat([ext[:, oy + 1: oy + 1 + 2 * n, ox].flip(-1),
                      ext[:, oy, ox: ox + 2 * n + 1]], dim=1)
    recon, lvl, cbf, use_ts = _tu_chain(
        vals, av, orig[:, oy: oy + n, ox: ox + n], mode, n, qp,
        is_luma=is_luma, rdoq_lam=rdoq_lam, dst=dst, ts_lam=ts_lam,
        rate_qp=rate_qp, sbh=sbh)
    fb = fire[:, None, None]
    win = ext[:, oy + 1: oy + 1 + n, ox + 1: ox + 1 + n]
    win.copy_(torch.where(fb, recon, win))
    lwin = levels[:, oy: oy + n, ox: ox + n]
    lwin.copy_(torch.where(fb, lvl, lwin))
    return _flags(cbf, use_ts, fire)


@functools.lru_cache(maxsize=None)
def _arange_t(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _tu_step_dyn(ext, levels, orig, mode, fire, oy, ox, n: int, qp, av_z, *,
                 is_luma: bool, ctu_yx, frame_hw, rdoq_lam=0.0,
                 sbh: bool = False, dst: bool = False, ts_lam=0.0,
                 rate_qp: int | None = None):
    """_tu_step at an origin held in integer tensors oy, ox (one element
    each) on ext's device, as the reference's scan bodies run it: the
    windows are index gathers, the write a masked index write, and the
    availability the static decoded-before mask av_z [4n+1] joined here
    to the in-picture check of the CTUs at picture origins ctu_yx
    ([R], [R]) in a frame_hw plane. Nothing reads back to the host."""
    if rate_qp is None:
        if not quant.is_static_qp(qp):
            raise ValueError("a per-row qp needs an explicit static rate_qp")
        rate_qp = int(qp)
    ar = _arange_t(2 * n + 1, ext.device)
    oy, ox = oy.reshape(1), ox.reshape(1)
    vals = torch.cat([ext[:, oy + 1 + ar[: 2 * n], ox].flip(-1),
                      ext[:, oy, ox + ar]], dim=1)
    dy, dx = ctu._offsets_t(n, ext.device)
    fy = ctu_yx[0][:, None] + oy + dy
    fx = ctu_yx[1][:, None] + ox + dx
    inside = (fy >= 0) & (fx >= 0) & (fy < frame_hw[0]) & (fx < frame_hw[1])
    rows, cols = (oy + ar[:n])[:, None], (ox + ar[:n])[None, :]
    recon, lvl, cbf, use_ts = _tu_chain(
        vals, inside & av_z, orig[:, rows, cols], mode, n, qp,
        is_luma=is_luma, rdoq_lam=rdoq_lam, dst=dst, ts_lam=ts_lam,
        rate_qp=rate_qp, sbh=sbh)
    fb = fire[:, None, None]
    ext[:, rows + 1, cols + 1] = torch.where(fb, recon,
                                             ext[:, rows + 1, cols + 1])
    levels[:, rows, cols] = torch.where(fb, lvl, levels[:, rows, cols])
    return _flags(cbf, use_ts, fire)


# The JAX encoder's per-CTU λ scale jnp.exp2(Δ/3) in float32, as XLA
# compiles it inside the encoder's jit (the division folded into one
# exp(Δ·c)), for Δ = -51..51: float32 bit patterns. A correctly rounded
# exp of the same float32 argument Δ·c is 1 ULP away at Δ in {-50, -41,
# -35, 38}, and another device's exp may round elsewhere, so the port
# reads the values instead of computing them (tests/test_torch_cuqp.py
# holds the table to the JAX package).
_LAMBDA_SCALE_BITS = (
    0x36FFFFF7, 0x37214518, 0x374B2FFB, 0x377FFFFF, 0x37A14512, 0x37CB2FF5,
    0x38000004, 0x38214518, 0x384B2FEE, 0x38800000, 0x38A1451C, 0x38CB2FF5,
    0x38FFFFF8, 0x39214518, 0x394B2FFB, 0x39800000, 0x39A14512, 0x39CB2FF5,
    0x3A000000, 0x3A214518, 0x3A4B2FF5, 0x3A800000, 0x3AA14518, 0x3ACB2FF5,
    0x3B000000, 0x3B214518, 0x3B4B2FF5, 0x3B800000, 0x3BA14518, 0x3BCB2FF5,
    0x3C000000, 0x3C214518, 0x3C4B2FF5, 0x3C800000, 0x3CA14518, 0x3CCB2FF5,
    0x3D000000, 0x3D214518, 0x3D4B2FF5, 0x3D800000, 0x3DA14518, 0x3DCB2FF5,
    0x3E000000, 0x3E214518, 0x3E4B2FF5, 0x3E800000, 0x3EA14518, 0x3ECB2FF5,
    0x3F000000, 0x3F214518, 0x3F4B2FF5, 0x3F800000, 0x3FA14518, 0x3FCB2FF5,
    0x40000000, 0x40214518, 0x404B2FF5, 0x40800000, 0x40A14518, 0x40CB2FF5,
    0x41000000, 0x41214518, 0x414B2FF5, 0x41800000, 0x41A14518, 0x41CB2FF5,
    0x42000000, 0x42214518, 0x424B2FF5, 0x42800000, 0x42A14518, 0x42CB2FF5,
    0x43000000, 0x43214518, 0x434B2FF5, 0x43800000, 0x43A14518, 0x43CB2FF5,
    0x44000000, 0x44214518, 0x444B2FF5, 0x44800000, 0x44A14518, 0x44CB2FF5,
    0x45000000, 0x45214518, 0x454B2FFC, 0x45800000, 0x45A14513, 0x45CB2FF6,
    0x46000004, 0x46214518, 0x464B2FEF, 0x46800000, 0x46A1451D, 0x46CB2FF6,
    0x46FFFFF8, 0x47214518, 0x474B2FFC, 0x47800000, 0x47A14513, 0x47CB2FF6,
    0x48000004,
)


@functools.lru_cache(maxsize=None)
def _lambda_scale_table(device: torch.device) -> torch.Tensor:
    bits = np.array(_LAMBDA_SCALE_BITS, dtype=np.uint32)
    return torch.as_tensor(bits.view(np.float32), device=device)


def lambda_scale(dqp: torch.Tensor) -> torch.Tensor:
    """Per-CTU λ scale 2^(Δ/3) for integer QP deltas Δ in [-51, 51],
    float32, bit-identical to the JAX encoder's on every device."""
    return _lambda_scale_table(dqp.device)[(dqp + 51).long()]


def _make_ext(top: torch.Tensor, left: torch.Tensor,
              span: int) -> torch.Tensor:
    """[R, span+1+span//2, 2span+2] extended local buffer: row 0 = above
    strip (corner + above + above-right, last sample repeated), column 0
    = left strip, everything else zero until TUs write it."""
    ext = torch.zeros((top.shape[0], span + 1 + span // 2, 2 * span + 2),
                      dtype=torch.int32, device=top.device)
    ext[:, 0, : 2 * span + 1] = top
    ext[:, 0, 2 * span + 1] = top[:, -1]
    ext[:, 1: span + 1, 0] = left
    return ext


def _tile_edges(ry: torch.Tensor, ru: torch.Tensor, rv: torch.Tensor):
    """A tile's halo payloads [B, rc, 64 + 32 + 32] (Y, U, V) from its
    blocked recon [B, rc, cl, n, n]: the right-edge column of its last
    CTU column (for the tile on its right) and the bottom row of its
    first (for the tile on its left)."""
    planes = (ry, ru, rv)
    return (torch.cat([p[:, :, -1, :, -1] for p in planes], dim=-1),
            torch.cat([p[:, :, 0, -1, :] for p in planes], dim=-1))


def _diag_ext(ry, ru, rv, bi, ri, ci, cl: int, halos=None):
    """The extended local buffers (ext_y [R, 97, 130], ext_c [2R, 49, 66],
    chroma rows U then V; _make_ext) of CTUs (bi, ri, ci) [R] from the
    blocked recon (ry, ru, rv) [B, rc, cl, n, n], ci local to a tile of cl
    columns: the above strip (corner + above + above-right) and the left
    strip, read at clamped indices (availability masks them later). At
    the tile's edges the neighbors come from halos (halo_l, halo_r)
    [B, rc, 64 + 32 + 32] when given."""
    rim = torch.clamp_min(ri - 1, 0)
    cim = torch.clamp_min(ci - 1, 0)
    cip = torch.clamp_max(ci + 1, cl - 1)
    at_l = (ci == 0)[:, None]
    at_r = (ci == cl - 1)[:, None]

    def strips(rp, span, lo):
        corner = rp[bi, rim, cim, span - 1, span - 1][:, None]
        above_r = rp[bi, rim, cip, span - 1, :]
        left = rp[bi, ri, cim, :, span - 1]
        if halos is not None:
            hl = halos[0][..., lo: lo + span]
            hr = halos[1][..., lo: lo + span]
            corner = torch.where(at_l, hl[bi, rim, span - 1:], corner)
            above_r = torch.where(at_r, hr[bi, rim], above_r)
            left = torch.where(at_l, hl[bi, ri], left)
        top = torch.cat([corner, rp[bi, rim, ci, span - 1, :], above_r],
                        dim=-1)
        return top, left

    top_y, left_y = strips(ry, 64, 0)
    top_u, left_u = strips(ru, 32, 64)
    top_v, left_v = strips(rv, 32, 96)
    return (_make_ext(top_y, left_y, 64),
            _make_ext(torch.cat([top_u, top_v]), torch.cat([left_u, left_v]),
                      32))


# captures kept per FrameEncoder, the least recently used dropped first
_GRAPH_CACHE = 4


@functools.lru_cache(maxsize=None)
def _schedule_t(device: torch.device) -> dict:
    """_block16_schedule's tables on device: the 16-blocks' origins
    (int64) and the decoded-before masks of their substeps."""
    ty, tx, _, *av = _block16_schedule()
    names = ("av32", "av32c", "av16", "av16c", "av8", "av8c", "av4")
    tabs = {k: device_table(a, device) for k, a in zip(names, av)}
    tabs["ty"] = device_table(ty, device, torch.int64)
    tabs["tx"] = device_table(tx, device, torch.int64)
    return tabs


def _pick(arr: torch.Tensor, sy, sx) -> torch.Tensor:
    """arr[:, sy, sx] at one-element index tensors -> [R]."""
    return arr[:, sy, sx][:, 0]


def _put_slot(arr: torch.Tensor, sy, sx, fire, val):
    """arr[:, sy, sx] = val where fire, at one-element index tensors."""
    arr[:, sy, sx] = torch.where(fire, val, _pick(arr, sy, sx))[:, None]


def _graph_nodes(graph) -> int | None:
    """Node count of a captured graph kept with keep_graph=True
    (cuGraphGetNodes from libcuda), or None where libcuda cannot be
    loaded or refuses."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(n))
    return n.value if rc == 0 else None


class _Wavefront:
    """The reference's stage 2 (hevctpu/pipeline/encoder.py,
    _reconstruct) for one encoder, batch size, tile and QP-map presence.

    Every diagonal of Geometry.wavefront_tiled runs at its fixed width A,
    inactive rows masked, through the full static schedule of a CTU
    (ctu.tu_schedule, each TU8 step followed by its four TU4 steps): 424
    masked _tu_step_dyn calls a diagonal, fire masks taken on the device
    from the leaf-TU-size and coded-slot maps, TU origins read from device
    tables at device counters (d: diagonal, q: quadrant, t: 16-block).
    A diagonal is four segments: _open gathers its CTUs' strips, blocks,
    maps and QPs, _quad runs a quadrant's TU32 step, _block a 16-block's
    TU16, TU8 and TU4 steps, _close scatters the results, inactive rows
    to the spare CTU row rc (the reference drops them out of range), and
    steps d. Everything a segment hands the next lives in a static buffer
    (self.buf, allocated by the first diagonal). On the CPU the segments
    run eagerly: stage 2's plain version. On the card _open and _close
    are captured once as CUDA graphs and replayed D times each, and
    between them one launch of the stage-2 kernel (ops/stage2_ctu.py)
    does the quadrants' and blocks' work, each CTU and plane walking only
    the TUs it codes. Nothing reads back to the host."""

    def __init__(self, enc, b: int, device: torch.device, tiles: int = 1,
                 ti: int = 0):
        g = enc.geom
        # a proxy: the encoder owns its wavefronts (enc._stage2), and a
        # cycle would leave their graphs to the garbage collector
        self.enc = weakref.proxy(enc)
        self.b, self.device = b, device
        self.rc, self.cl = g.rc, g.cc // tiles
        self.tiled = tiles > 1
        act_r, act_c, act_m = (t[ti] for t in g.wavefront_tiled(tiles))
        self.diagonals, self.a = act_r.shape
        i64 = functools.partial(device_table, device=device,
                                dtype=torch.int64)
        self.act_r, self.act_c = i64(act_r), i64(act_c)
        self.act_cl = i64(np.where(act_m, act_c - ti * self.cl, 0))
        self.act_m = device_table(act_m, device)
        self.bi = torch.arange(b, device=device).repeat_interleave(self.a)
        self.d, self.q, self.t = (torch.zeros(1, dtype=torch.int64,
                                              device=device)
                                  for _ in range(3))
        # the schedule tables of _quad and _block, which run on the CPU
        # only (the kernel takes its own, ops/stage2_ctu.py)
        self.sched = _schedule_t(device) if device.type != "cuda" else None
        self.buf = {}
        self.qps = None

        def zeros(n, dtype=torch.int32):
            return torch.zeros((b, self.rc + 1, self.cl, n, n), dtype=dtype,
                               device=device)

        # the reconstruction, blocked, with a spare CTU row rc
        self.state = {"recon_y": zeros(64), "recon_u": zeros(32),
                      "recon_v": zeros(32), "levels_y": zeros(64),
                      "levels_u": zeros(32), "levels_v": zeros(32)}
        for k, n in (("cbf_y", 8), ("cbf_u", 8), ("cbf_v", 8),
                     ("cbf4_y", 16), ("ts4_y", 16), ("ts8_u", 8),
                     ("ts8_v", 8)):
            self.state[k] = zeros(n, torch.bool)
        # on the card: the graphs of _open and _close, and the kernel's
        # arguments (pointers into self.buf)
        self.plan = None
        self.kernel_args = None

    def _put(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Copy value into the static buffer `name` (made by the first
        call, with value's shape and dtype); returns the buffer."""
        buf = self.buf.get(name)
        if buf is None:
            buf = self.buf[name] = value.clone()
        else:
            buf.copy_(value)
        return buf

    # -- segments ----------------------------------------------------------

    def _open(self):
        """Gather diagonal d's CTUs into the diagonal's buffers; reset the
        quadrant and block counters."""
        b, a, B, st, bi = self.b, self.a, self.buf, self.state, self.bi

        def rows(table):               # diagonal d's entries, every frame
            return table[self.d].reshape(a).repeat(b)

        # ci is the GLOBAL column (picture coordinates), cil the tile's
        ri, ci, cil = rows(self.act_r), rows(self.act_c), rows(self.act_cl)
        ext_y, ext_c = _diag_ext(
            st["recon_y"], st["recon_u"], st["recon_v"], bi, ri, cil,
            self.cl, (B["halo_l"], B["halo_r"]) if self.tiled else None)
        new = dict(ri=ri, cil=cil, mk=rows(self.act_m), ext_y=ext_y,
                   ext_c=ext_c, oyl=B["in_y"][bi, ri, cil],
                   ouv=torch.cat([B["in_u"][bi, ri, cil],
                                  B["in_v"][bi, ri, cil]]),
                   ctu_y=ri * 64, ctu_x=ci * 64, ctu_yc=(ri * 32).repeat(2),
                   ctu_xc=(ci * 32).repeat(2))
        for k in ("tz", "c8", "msl", "cm8", "mm4"):
            new[k] = B["in_" + k][bi, ri, cil]
        flags = torch.zeros_like(new["c8"], dtype=torch.bool)
        flags4 = torch.zeros_like(new["mm4"], dtype=torch.bool)
        new.update(vy=torch.zeros_like(new["oyl"]),
                   vc=torch.zeros_like(new["ouv"]), cy8=flags,
                   cc8=flags.repeat(2, 1, 1), tc8=flags.repeat(2, 1, 1),
                   cy4=flags4, ty4=flags4)
        for k, v in new.items():
            self._put(k, v)
        qps = self.enc._ctu_qps(B.get("in_qp_map"), bi, ri, ci)
        self.qps = tuple(self._put(f"qp{i}", v)
                         if isinstance(v, torch.Tensor) else v
                         for i, v in enumerate(qps))
        self.q.zero_()
        self.t.zero_()

    def _tu(self, n: int, oy, ox, av, av_c):
        """The luma and chroma TU steps of size n at origin (oy, ox): luma
        fires where the slot's leaf TU is n, chroma there too and, at
        n = 8, under a TU4 leaf (its chroma TU is 4x4)."""
        enc, g, B = self.enc, self.enc.geom, self.buf
        qp_l, qp_c2, rl_y, rl_c, tl_y, tl_c = self.qps
        sy, sx = oy // 8, ox // 8
        leaf, coded = _pick(B["tz"], sy, sx), _pick(B["c8"], sy, sx) & B["mk"]
        log2 = n.bit_length() - 1
        fire = (leaf == log2) & coded
        fire_c = (((leaf <= 3) & coded) if n == 8 else fire).repeat(2)
        cbf, _ = _tu_step_dyn(
            B["ext_y"], B["vy"], B["oyl"], _pick(B["msl"], sy, sx), fire, oy,
            ox, n, qp_l, av, is_luma=True, ctu_yx=(B["ctu_y"], B["ctu_x"]),
            frame_hw=(g.h, g.w), rdoq_lam=rl_y, sbh=enc.sbh, rate_qp=enc.qp)
        _put_slot(B["cy8"], sy, sx, fire, cbf)
        cbf, ts = _tu_step_dyn(
            B["ext_c"], B["vc"], B["ouv"], _pick(B["cm8"], sy, sx).repeat(2),
            fire_c, oy // 2, ox // 2, n // 2, qp_c2, av_c, is_luma=False,
            ctu_yx=(B["ctu_yc"], B["ctu_xc"]), frame_hw=(g.h // 2, g.w // 2),
            rdoq_lam=rl_c, sbh=enc.sbh, ts_lam=tl_c, rate_qp=enc.qp_c)
        _put_slot(B["cc8"], sy, sx, fire_c, cbf)
        _put_slot(B["tc8"], sy, sx, fire_c, ts)

    def _quad(self):
        """Quadrant q's TU32 step (at its leader block 4q)."""
        s, t = self.sched, self.q * 4
        self._tu(32, s["ty"][t], s["tx"][t], s["av32"][t][0],
                 s["av32c"][t][0])
        self.q += 1

    def _block(self):
        """16-block t's TU16 step, then per 8-slot in z-order its TU8 step
        and its four TU4 steps (NxN PUs or a TU split: mode4 holds either
        mode)."""
        enc, s, t, B = self.enc, self.sched, self.t, self.buf
        ty, tx = s["ty"][t], s["tx"][t]
        self._tu(16, ty, tx, s["av16"][t][0], s["av16c"][t][0])
        for e in range(4):
            ey, ex = ty + (e // 2) * 8, tx + (e % 2) * 8
            self._tu(8, ey, ex, s["av8"][t][0, e], s["av8c"][t][0, e])
            if not (enc.nxn or enc.tu_split):
                continue
            sy, sx = ey // 8, ex // 8
            fire = ((_pick(B["tz"], sy, sx) == 2) & _pick(B["c8"], sy, sx)
                    & B["mk"])
            qp_l, _, rl_y, _, tl_y, _ = self.qps
            for q in range(4):
                oy, ox = ey + (q // 2) * 4, ex + (q % 2) * 4
                s4y, s4x = oy // 4, ox // 4
                cbf, ts = _tu_step_dyn(
                    B["ext_y"], B["vy"], B["oyl"], _pick(B["mm4"], s4y, s4x),
                    fire, oy, ox, 4, qp_l, s["av4"][t][0, e, q],
                    is_luma=True, ctu_yx=(B["ctu_y"], B["ctu_x"]),
                    frame_hw=(enc.geom.h, enc.geom.w), rdoq_lam=rl_y,
                    sbh=enc.sbh, dst=True, ts_lam=tl_y, rate_qp=enc.qp)
                _put_slot(B["cy4"], s4y, s4x, fire, cbf)
                _put_slot(B["ty4"], s4y, s4x, fire, ts)
        self.t += 1

    def _close(self):
        """Scatter the diagonal's results into the state (inactive rows
        into the spare row, where their duplicate indices are harmless)
        and step d."""
        B, st, ba = self.buf, self.state, self.bi.shape[0]
        idx = (self.bi, torch.where(B["mk"], B["ri"], self.rc), B["cil"])
        for k, v in (("recon_y", B["ext_y"][:, 1:65, 1:65]),
                     ("recon_u", B["ext_c"][:ba, 1:33, 1:33]),
                     ("recon_v", B["ext_c"][ba:, 1:33, 1:33]),
                     ("levels_y", B["vy"]), ("levels_u", B["vc"][:ba]),
                     ("levels_v", B["vc"][ba:]), ("cbf_y", B["cy8"]),
                     ("cbf_u", B["cc8"][:ba]), ("cbf_v", B["cc8"][ba:]),
                     ("cbf4_y", B["cy4"]), ("ts4_y", B["ty4"]),
                     ("ts8_u", B["tc8"][:ba]), ("ts8_v", B["tc8"][ba:])):
            st[k][idx] = v
        self.d += 1

    # -- driving -----------------------------------------------------------

    def _capture(self):
        """Capture _open and _close as CUDA graphs on a side stream, after
        one eager run of each that makes the buffers and warms the tables
        and libraries (and leaves state and counters for run() to reset),
        and set the kernel's arguments up. The capture tolerates other
        threads' CUDA calls (the caller of a dispatch uploads meanwhile).
        The garbage collector stays off meanwhile: a graph it destroyed on
        this thread would invalidate the capture. A failure raises. Counts
        the capture, its ms and the graphs' nodes (trace.counters())."""
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        segments = (self._open, self._close)
        graphs, nodes = [], []
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                for fn in segments:
                    fn()
                pool = torch.cuda.graph_pool_handle()
                for fn in segments:
                    gr = torch.cuda.CUDAGraph(keep_graph=True)
                    gr.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
                    try:
                        fn()
                    except BaseException:
                        with contextlib.suppress(Exception):
                            gr.capture_end()
                        raise
                    gr.capture_end()
                    nodes.append(_graph_nodes(gr))
                    gr.instantiate()
                    graphs.append(gr)
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        enc = self.enc
        self.kernel_args = stage2_ctu.make_args(
            self.buf, self.qps, rows=self.b * self.a,
            hw=(enc.geom.h, enc.geom.w), rate_qps=(enc.qp, enc.qp_c),
            sbh=enc.sbh, tu4=enc.nxn or enc.tu_split,
            schedule=_kernel_schedule)
        trace.count("stage2.captures")
        trace.count("stage2.capture_ms", (time.perf_counter() - t0) * 1e3)
        if None not in nodes:
            trace.count("stage2.graph_nodes", sum(nodes))
        self.plan = tuple(graphs)

    def run(self, inputs: dict, shard=None) -> dict:
        """Stage 2 of one batch: inputs {y, u, v: blocked source planes;
        tz, c8, msl, cm8, mm4: the tile's blocked maps; qp_map (optional):
        [B, rc, cc]}; shard a parallel.Mesh whose halos are exchanged
        between diagonals (outside the graphs, copied into the halo
        buffers). Returns the 13 output planes, owning their memory.
        Inside a dispatch, the capture and each diagonal are spans of its
        record (trace.py); the replays and kernel launches are counted."""
        for k, v in inputs.items():
            self._put("in_" + k, v)
        if self.tiled:
            z = torch.zeros((self.b, self.rc, 128), dtype=torch.int32,
                            device=self.device)
            self._put("halo_l", z), self._put("halo_r", z)
        graphs = self.device.type == "cuda"
        if graphs and self.plan is None:
            with trace.span("stage2.capture"):
                self._capture()
        for t in self.state.values():
            t.zero_()
        self.d.zero_()
        for d in range(self.diagonals):
            with trace.diagonal():
                if shard is not None and d:
                    # every tile, every diagonal: the exchange is collective
                    halo_l, halo_r = shard.exchange(*_tile_edges(
                        *(self.state[k][:, : self.rc]
                          for k in ("recon_y", "recon_u", "recon_v"))))
                    self._put("halo_l", halo_l), self._put("halo_r", halo_r)
                if graphs:
                    g_open, g_close = self.plan
                    g_open.replay()
                    stage2_ctu.launch(self.kernel_args, self.device)
                    g_close.replay()
                    trace.count("stage2.replays", 2)
                else:
                    self._open()
                    for _ in range(4):
                        self._quad()
                        for _ in range(4):
                            self._block()
                    self._close()
        out = {}
        for k, t in self.state.items():
            o = from_blocked(t[:, : self.rc])
            out[k] = o.clone() if o._base is not None else o
        return out


def _checksum_plane(plane: torch.Tensor) -> torch.Tensor:
    """[B, H, W] pels -> [B] int64 holding the uint32 checksum picture
    hash (TComPicYuvMD5::compChecksum)."""
    h, w = plane.shape[-2:]
    x = torch.arange(w, device=plane.device)
    y = torch.arange(h, device=plane.device)
    mask = (((y & 0xff) ^ (y >> 8))[:, None]
            ^ ((x & 0xff) ^ (x >> 8))[None, :]) & 0xff
    vals = (plane.to(torch.int64) & 0xff) ^ mask
    return vals.sum(dim=(-2, -1)) & 0xffffffff


# ---------------------------------------------------------------------------
# Lite transfer: a smaller device->host dict. Recon planes are replaced by
# the device checksum picture hash (the one hash type that is a parallel
# reduction), levels ship as int8 with a sparse escape sidecar, and boolean
# planes ship bitpacked.
# ---------------------------------------------------------------------------

_ESC_MAX = 4096  # escape slots per plane per frame (|level| > 127)


def _pack_bits_device(x: torch.Tensor) -> torch.Tensor:
    """Boolean [B, ...] -> uint8 [B, ceil(N/8)] (row-major, MSB first:
    np.unpackbits-compatible)."""
    b = x.shape[0]
    flat = x.reshape(b, -1).to(torch.int32)
    flat = F.pad(flat, (0, (-flat.shape[1]) % 8))
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=x.device)
    return (flat.reshape(b, -1, 8) * w).sum(dim=-1).to(torch.uint8)


def _unpack_bits_host(packed: np.ndarray, shape) -> np.ndarray:
    b = packed.shape[0]
    n = int(np.prod(shape))
    bits = np.unpackbits(np.asarray(packed, np.uint8), axis=1)[:, :n]
    return bits.reshape((b,) + tuple(shape)).astype(bool)


def _pack_levels_device(lvl: torch.Tensor):
    """int levels [B, H, W] -> (int8 plane clipped to ±127, esc_pos
    [B, _ESC_MAX] int32 flat positions of the first _ESC_MAX escapes
    (|v| > 127) in raster order, -1 filled, esc_val [B, _ESC_MAX] int32
    their levels, 0 filled, esc_n [B] int32 the escape count). Fixed
    shapes and no host sync: each escape's rank (a cumsum) is its slot."""
    b = lvl.shape[0]
    flat = lvl.reshape(b, -1).to(torch.int32)
    esc = flat.abs() > 127
    esc_n = esc.sum(dim=-1).to(torch.int32)
    rank = esc.to(torch.int64).cumsum(dim=-1) - 1
    slot = torch.where(esc & (rank < _ESC_MAX), rank, _ESC_MAX)
    pos = torch.full((b, _ESC_MAX + 1), -1, dtype=torch.int64,
                     device=lvl.device)
    src = torch.arange(flat.shape[1], device=lvl.device).expand_as(flat)
    pos = pos.scatter(1, slot, src)[:, :_ESC_MAX]      # slot _ESC_MAX: spill
    val = torch.gather(flat, 1, torch.clamp_min(pos, 0))
    val = torch.where(pos >= 0, val, 0)
    lv8 = torch.clamp(lvl, -127, 127).to(torch.int8)
    return lv8, pos.to(torch.int32), val, esc_n


def _unpack_levels_host(lv8, pos, val, esc_n, dtype) -> np.ndarray:
    n_max = int(np.max(esc_n)) if esc_n.size else 0
    if n_max > _ESC_MAX:
        raise ValueError(
            f"level escape sidecar overflow ({n_max} > {_ESC_MAX}): "
            "re-encode without lite transfer (lite=False)")
    out = np.asarray(lv8).astype(dtype)
    if n_max:
        flat = out.reshape(out.shape[0], -1)
        for i in range(out.shape[0]):
            p = pos[i][pos[i] >= 0]
            flat[i, p] = val[i][: len(p)]
    return out


# boolean output planes, bitpacked by the lite transfer
_LITE_BOOL_KEYS = ("cbf_y", "cbf_u", "cbf_v", "cbf4_y", "ts4_y",
                   "ts8_u", "ts8_v")


def _sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences over the last two axes, exact in int64:
    float32 rounds it past 2**24, which a 1080p luma plane passes at a
    mean squared error of 8 (the JAX package sums in float32)."""
    d = (a.to(torch.int64) - b.to(torch.int64))
    return (d * d).sum(dim=(-2, -1))


class Dispatch(collections.abc.Mapping):
    """What encode_dispatch and encode_fused_dispatch return: one encode
    queued on its encoder's worker thread, standing where its on-device
    output dict will be. Reading it (a key, iteration, len) waits for the
    encode and re-raises, with its traceback, whatever the encode raised;
    result() is the dict itself. trace is the dispatch's record
    (pipeline/trace.py: its spans, its stage clock, stage 2's diagonal
    events), freed with the handle."""

    def __init__(self, future: concurrent.futures.Future,
                 record: trace.Record):
        self._future = future
        self.trace = record

    @property
    def clock(self) -> trace.StageClock:
        """The record's stage clock."""
        return self.trace.clock

    def done(self) -> bool:
        """True once the encode has returned or raised (does not wait)."""
        return self._future.done()

    def result(self) -> dict:
        """The on-device output dict, waiting for the encode."""
        return self._future.result()

    def __getitem__(self, key):
        return self.result()[key]

    def __iter__(self):
        return iter(self.result())

    def __len__(self):
        return len(self.result())


_OUT_CAST = {"recon_y": torch.uint8, "recon_u": torch.uint8,
             "recon_v": torch.uint8, "levels_y": torch.int16,
             "levels_u": torch.int16, "levels_v": torch.int16,
             "depth8": torch.int8, "mode8": torch.int8, "mode4": torch.int8,
             "csel8": torch.int8, "tusz8": torch.int8,
             "sao_type": torch.int8, "sao_eo": torch.int8,
             "sao_bp": torch.int8, "sao_off": torch.int8,
             "sao_merge": torch.int8, "qp_ctu": torch.int8}


class FrameEncoder:
    """Encodes batches of frames of one geometry at one QP on one device.

    search selects the partition source:
      * "cnn" — the CU quadtree is the CNN's pruned prediction, the
        reference pipeline's gate semantics; labels come from the caller
        (encode) or from ConvNet2 on the same device (encode_fused).
      * "rd"  — full RD quadtree search: per-depth dense RD costs compared
        bottom-up (_rd_split_labels); labels are ignored.
    rate_model selects stage 1's rate estimator: "global" (per-bin-type
    weights, ops/rate.py) or "ctx" (the exact residual bin stream at
    frozen context states, ops/rate_ctx.py). two_pass runs stage 1 again
    with neighbor boundaries read from the first pass's pre-filter
    reconstruction (recon feedback), then reconstructs with the second
    decisions. The coding-tool switches (rdoq, sbh, ts, nxn, tu_split,
    deblock, sao) turn their tool off when False, as in the JAX
    package."""

    def __init__(self, h: int, w: int, qp: int, *, device=None,
                 deblock: bool = True, search: str = "cnn",
                 rdoq: bool = True, sao: bool = True, sbh: bool = True,
                 nxn: bool = True, tu_split: bool = True, ts: bool = True,
                 two_pass: bool = False, rate_model: str = "global"):
        if h % 8 or w % 8:
            raise ValueError("HEVC requires dims % minCU == 0")
        if search not in ("cnn", "rd"):
            raise ValueError(f"search must be cnn|rd, got {search!r}")
        if rate_model not in ("ctx", "global"):
            raise ValueError(f"rate_model must be ctx|global, got "
                             f"{rate_model!r}")
        self.device = get_device(device)
        self.geom = Geometry(h, w)
        self.qp = int(qp)
        self.qp_c = rom.chroma_qp_from_luma(self.qp)
        self.search = search
        self.rate_model = rate_model
        self.two_pass = two_pass
        self.deblock, self.sao, self.sbh = deblock, sao, sbh
        self.nxn, self.tu_split, self.ts = nxn, tu_split, ts
        lam = rate.lambda_rd(self.qp)
        w_c = rate.chroma_dist_weight(self.qp, self.qp_c)
        # RDOQ and the TS trial use λ (0.0 switches the tool off); chroma
        # distortion is weighted by w_c in the RD cost, so chroma's
        # effective λ is λ / w_c.
        self.rdoq_lam = lam if rdoq else 0.0
        self.ts_lam = lam if ts else 0.0
        self.rdoq_lam_c = self.rdoq_lam / w_c
        self.ts_lam_c = self.ts_lam / w_c
        # one worker thread runs every dispatched encode in dispatch order
        # (created on first dispatch); _last is the newest dispatch
        self._worker = None
        self._last = None
        self._copy_stream = None
        # a parallel.Mesh of more than one tile runs stage 2 per tile
        # (parallel.ShardedEncoder sets it); stage 1 and the filters stay
        # full-width on every rank
        self.shard = None
        # stage 2's captured wavefronts on the card, by (batch, QP map,
        # tile), least recently used first
        self._stage2 = collections.OrderedDict()

    # -- public API --------------------------------------------------------

    def _upload(self, a, dtype) -> torch.Tensor:
        """A host array as a tensor on the encoder's device that owns its
        data: the dispatch returns before the worker reads it, and on the
        CPU torch.as_tensor alone would alias the caller's array. On the
        card the copy runs from pinned memory on a side stream, so that it
        does not wait behind the kernels (stage 2's graph replays) queued
        on the encoder's stream, which waits for the copy instead."""
        host = torch.as_tensor(np.asarray(a, dtype))
        if self.device.type != "cuda":
            return host.clone()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        main = torch.cuda.default_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            t = host.pin_memory().to(self.device, non_blocking=True)
        t.record_stream(main)
        main.wait_stream(self._copy_stream)
        return t

    def _to_device(self, *planes):
        return [self._upload(p, np.uint8) for p in planes]

    def _submit(self, rec: trace.Record, fn, *args) -> Dispatch:
        """Queue fn(*args) on the worker: in grad-free mode, on the
        encoder's device and its default stream, with the caller's torch
        thread count (a thread keeps the count it started with), rec the
        current record there, under its span "worker"."""
        if self._worker is None:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="FrameEncoder")
        threads = torch.get_num_threads()
        dev = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())

        def run():
            if torch.get_num_threads() != threads:
                torch.set_num_threads(threads)
            with torch.no_grad(), dev, trace.active(rec), rec.span("worker"):
                rec.clock.mark(None)
                return fn(*args)

        self._last = Dispatch(self._worker.submit(run), rec)
        return self._last

    def encode(self, y, u, v, labels=None, qp_map=None) -> dict:
        """y [B,H,W], u/v [B,H/2,W/2] uint8-valued; labels [B, rc*cc, 16]
        (required for search="cnn"). qp_map [B, rc, cc] optional per-CTU
        absolute QPs (cu_qp_delta / LCU-level rate control): quantization,
        λ and deblocking follow the map, and the output carries the
        effective map the entropy coder signals as "qp_ctu". Returns a
        dict of numpy arrays."""
        if labels is None:
            if self.search != "rd":
                raise ValueError("search='cnn' needs labels")
            labels = np.zeros((np.shape(y)[0], self.geom.rc * self.geom.cc,
                               16), np.int8)
        return self.collect(self.encode_dispatch(y, u, v, labels, qp_map))

    def encode_dispatch(self, y, u, v, labels, qp_map=None) -> Dispatch:
        """encode() up to the on-device output dict; labels [B, rc*cc, 16]
        are required here. Blocks only to check the arguments and upload
        the planes, labels and map (the upload copies them, so the caller
        may reuse its arrays at once); stage 1, stage 2 and the filters
        run on the encoder's worker thread, after any encode dispatched
        before. Returns a Dispatch; pass it to collect()."""
        rec = trace.Record(self.device)
        with rec.span("dispatch"):
            if qp_map is not None and self.shard is not None:
                raise ValueError("per-CTU QP maps are not supported under "
                                 "tile sharding")
            rec.clock.mark("start")
            y, u, v = self._to_device(y, u, v)
            lab = self._upload(labels, np.int8).to(torch.int32)
            if qp_map is not None:
                qp_map = self._upload(qp_map, np.uint8).to(torch.int32)
            rec.clock.mark("upload")
        return self._submit(rec, self._encode_impl, y, u, v, lab, qp_map)

    def encode_fused(self, cnn, y, u, v, *, lite: bool = False) -> dict:
        """ConvNet2 depth labels + encode on the encoder's device; cnn is a
        ConvNet2 (models.convnet2.load_model) on that device. lite=True
        ships the packed dict (see encode_fused_dispatch) and returns it
        unpacked: no recon planes, the hash SEI comes from the device
        checksum (hash_type="checksum")."""
        return self.collect(self.encode_fused_dispatch(cnn, y, u, v,
                                                       lite=lite), lite=lite)

    def encode_fused_dispatch(self, cnn, y, u, v, *,
                              lite: bool = False) -> Dispatch:
        """Queue the labels + encode and return at once, as the JAX
        package's does, so that the caller can collect and entropy-code
        one batch while the next one encodes. Blocks only to check that
        cnn is on the encoder's device and to upload the planes (copied,
        so the caller may reuse its arrays at once); the labels, stage 1,
        stage 2, the filters and the lite packing run on the encoder's
        worker thread, after any encode dispatched before. Returns a Dispatch;
        pass it to collect() with the same lite. lite=True packs the dict
        on the device for a smaller transfer: no recon planes, levels as
        int8 + an escape sidecar, bool planes bitpacked."""
        rec = trace.Record(self.device)
        with rec.span("dispatch"):
            dev = next(cnn.parameters()).device
            if dev != self.device:
                raise ValueError(f"ConvNet2 is on {dev}, the encoder on "
                                 f"{self.device}")
            rec.clock.mark("start")
            y, u, v = self._to_device(y, u, v)
            rec.clock.mark("upload")
        return self._submit(rec, self._encode_fused_impl, cnn, y, u, v, lite)

    def _encode_fused_impl(self, cnn, y, u, v, lite):
        from hevctpu_torch.models import convnet2

        g = self.geom
        with trace.stage("cnn"):
            labels = convnet2.predict_frame_labels(
                cnn, y.to(torch.int32), u.to(torch.int32), v.to(torch.int32),
                g.h, g.w)
        out = self._encode_impl(y, u, v, labels.to(torch.int32))
        out["labels"] = labels.to(torch.int8)
        if not lite:
            return out
        with trace.span("pack"):
            return self._pack_lite(out)

    def collect(self, dev_out, *, lite: bool = False) -> dict:
        """Fetch a dispatched output (a Dispatch, which this waits for and
        whose exception it re-raises, or a dict of tensors) to host numpy
        arrays; lite=True unpacks the lite dict to the standard layout
        without recon planes. A Dispatch's collect is a span of its
        record."""
        if isinstance(dev_out, Dispatch):
            with dev_out.trace.span("collect"):
                return self.collect(dev_out.result(), lite=lite)
        out = {k: t.cpu().numpy() for k, t in dev_out.items()}
        out["hash_checksum"] = out["hash_checksum"].astype(np.uint32)
        if lite:
            out = self._unpack_lite(out)
        out["sbh"] = np.bool_(self.sbh)
        return out

    def stage_ms(self) -> dict:
        """Milliseconds of each stage of the newest dispatched encode
        (upload, cnn, stage1, stage2, filters; under two_pass also
        pass1_stage2 and pass2_stage1 between stage1 and stage2), waiting
        for that encode and the device to finish and re-raising what the
        encode raised; {} before the first dispatch. An encode's stages
        start when the worker takes it up; on the card, the upload of a
        dispatch made while another encode runs shares the stream with
        that encode's kernels, and its time counts them."""
        if self._last is None:
            return {}
        self._last.result()
        return self._last.trace.stage_ms()

    def _pack_lite(self, out: dict) -> dict:
        """Device-side lite packing of an output dict."""
        packed = {k: t for k, t in out.items() if not k.startswith("recon_")}
        for comp in ("y", "u", "v"):
            lv8, pos, val, n = _pack_levels_device(out[f"levels_{comp}"])
            packed[f"levels_{comp}"] = lv8
            packed[f"esc_pos_{comp}"] = pos
            packed[f"esc_val_{comp}"] = val
            packed[f"esc_n_{comp}"] = n
        for k in _LITE_BOOL_KEYS:
            if k in packed:
                packed[k] = _pack_bits_device(out[k])
        return packed

    def _unpack_lite(self, out: dict) -> dict:
        """Host numpy lite dict -> the standard layout (int16 levels, bool
        planes at their logical shapes), still without recon planes."""
        g = self.geom
        s4, s8 = (g.hp // 4, g.wp // 4), (g.hp // 8, g.wp // 8)
        shapes = {"cbf_y": s8, "cbf_u": s8, "cbf_v": s8, "cbf4_y": s4,
                  "ts4_y": s4, "ts8_u": s8, "ts8_v": s8}
        res = dict(out)
        for comp in ("y", "u", "v"):
            res[f"levels_{comp}"] = _unpack_levels_host(
                out[f"levels_{comp}"], *(res.pop(f"esc_{k}_{comp}")
                                         for k in ("pos", "val", "n")),
                np.int16)
        for k in _LITE_BOOL_KEYS:
            if k in res:
                res[k] = _unpack_bits_host(out[k], shapes[k])
        return res

    # -- implementation ----------------------------------------------------

    def _encode_impl(self, y, u, v, labels, qp_map=None):
        """Stage 1, stage 2 and the filters of one batch on the device, each
        a stage of the current record (trace.stage: a span, then the stage
        clock's mark) inside a dispatch."""
        g = self.geom

        def reconstruct(dec):
            out = self._reconstruct(yp, up, vp, dec["mode_slot"],
                                    dec["cmode_slot"],
                                    to_blocked(dec["tusz_frame"], 8),
                                    dec["coded8"],
                                    to_blocked(dec["mode4_frame"], 16),
                                    qp_map, self.shard)
            if self.shard is not None:
                # every rank of the tile group filters the full width
                out = {k: self.shard.gather_width(t) for k, t in out.items()}
            return out

        with trace.stage("stage1"):
            yp = pad_plane(y.to(torch.int32), g.hp, g.wp)
            up = pad_plane(u.to(torch.int32), g.hp // 2, g.wp // 2)
            vp = pad_plane(v.to(torch.int32), g.hp // 2, g.wp // 2)
            dec = self._decide(yp, up, vp, labels)
        if self.two_pass:
            # Recon feedback (HM decides against reconstructed neighbors
            # mid-search): stage 1 again with boundaries read from the
            # first pass's pre-filter recon, the padded [hp, wp] planes
            # the decoder will approximately see.
            with trace.stage("pass1_stage2"):
                out1 = reconstruct(dec)
            with trace.stage("pass2_stage1"):
                dec = self._decide(yp, up, vp, labels,
                                   bsrc=(out1["recon_y"], out1["recon_u"],
                                         out1["recon_v"]))
        with trace.stage("stage2"):
            out = reconstruct(dec)
        with trace.stage("filters"):
            if qp_map is not None:
                out["qp_ctu"] = self._effective_qp_map(out, qp_map)
            out["depth8"] = from_blocked(dec["depth8"])
            out["coded8"] = from_blocked(dec["coded8"])
            out["mode8"] = dec["mode8_frame"]
            out["csel8"] = dec["csel8_frame"]
            out["nxn8"] = dec["nxn8_frame"]
            out["mode4"] = dec["mode4_frame"]
            if self.tu_split:
                out["tusz8"] = dec["tusz_frame"]
            if not self.ts:
                for k in ("ts4_y", "ts8_u", "ts8_v"):
                    del out[k]
            out = self._loop_filters_and_cast(yp, up, vp, out,
                                              dec["tusz_frame"])
        return out

    def _effective_qp_map(self, out: dict, qp_map: torch.Tensor):
        """The wire QP map [B, rc, cc]: a CTU with no coded cbf signals no
        delta, so its QP is the predicted (previous effective) one, "the
        last CTU with residual wins" in raster order (8.6.1 qPY_PREV with
        QG == CTB); the slice QP before the first such CTU. Deblocking and
        the entropy coder see this map, not the desired one."""
        g = self.geom

        def pool_ctu(x, s):
            return x.reshape(x.shape[0], g.rc, s, g.cc, s).any(dim=4).any(
                dim=2)

        any_c = (pool_ctu(out["cbf_y"], 8) | pool_ctu(out["cbf_u"], 8)
                 | pool_ctu(out["cbf_v"], 8) | pool_ctu(out["cbf4_y"], 16))
        b = qp_map.shape[0]
        des = qp_map.reshape(b, -1)
        pos = torch.arange(des.shape[1], device=des.device).expand_as(des)
        last = torch.cummax(torch.where(any_c.reshape(b, -1), pos, -1),
                            dim=1).values
        vals = torch.gather(des, 1, torch.clamp_min(last, 0))
        return torch.where(last >= 0, vals, self.qp).reshape(qp_map.shape)

    def _decide(self, yp, up, vp, labels, bsrc=None):
        """Stage 1: all mode/partition/TU decisions for the batch. bsrc is
        an optional (y, u, v) of planes the neighbor boundaries are read
        from (two_pass); None reads them from the original planes."""
        g = self.geom
        b = yp.shape[0]
        rm = self.rate_model
        by, bu, bv = bsrc if bsrc is not None else (None, None, None)
        modes, costs = _dense_mode_decision(yp, g, self.qp, bsrc=by,
                                            rate_model=rm)

        # Intra TU quadtree per CU size: each CU's full-TU cost becomes its
        # best-tree cost, and the per-slot leaf-size maps go to stage 2.
        tz = {}
        if self.tu_split:
            for n, cu_log2 in ((64, 6), (32, 5), (16, 4), (8, 3)):
                t_cost, rd_full, tz[n] = _tu_tree_decision(
                    yp, g, self.qp, cu_log2, modes[n], bsrc=by,
                    rate_model=rm)
                costs[n] = costs[n] + (t_cost - rd_full)

        # PART_NxN vs PART_2Nx2N at depth 3: four 4x4 DST TUs with their
        # own modes vs one 8x8 TU.
        if self.nxn:
            c_nxn = _pool2(costs[4])
            if rm == "ctx":
                # the part_mode bin of max-depth CUs (bin 1 = 2Nx2N, 0 =
                # NxN), init-state priced
                pm_nxn, pm_2n = rate_ctx.part_mode_bits(self.qp)
                lam_pm = rate.lambda_rd(self.qp)
                c_nxn = c_nxn + lam_pm * pm_nxn
                costs[8] = costs[8] + lam_pm * pm_2n
            nxn_map = c_nxn < costs[8]
            costs[8] = torch.minimum(costs[8], c_nxn)
        else:
            nxn_map = torch.zeros_like(costs[8], dtype=torch.bool)

        csel, cmodes, ccosts = _dense_chroma_decision(
            up, vp, g, self.qp, self.qp_c, modes, bsrc_u=bu, bsrc_v=bv,
            rate_model=rm)

        # Partition: the CNN labels, or the RD quadtree decision (costs[8]
        # already holds the NxN alternative; its chroma is ccosts[8]
        # either way, one 4x4 chroma TU per 8x8 luma CU).
        if self.search == "rd":
            labels = _rd_split_labels(
                {n: costs[n] + ccosts[n] for n in ccosts}, self.qp, rm)
        bh, bw = (torch.as_tensor(x, device=yp.device) for x in g.bh_bw)
        depth8, coded8 = ctu.derive_slot_depths(
            labels.reshape(b, g.rc, g.cc, 16), bh[None, :, None],
            bw[None, None, :])                       # [B, rc, cc, 8, 8]

        def slot_map(per_size):  # the CU's value at every 8x8 slot
            return torch.where(
                depth8 == 0, per_size[64][..., None, None],
                torch.where(depth8 == 1, _rep2(to_blocked(per_size[32], 2), 4),
                            torch.where(depth8 == 2,
                                        _rep2(to_blocked(per_size[16], 4), 2),
                                        to_blocked(per_size[8], 8))))

        mode_slot = slot_map(modes)
        cmode_slot = slot_map(cmodes)
        csel_slot = slot_map(csel)

        # NxN slots + the per-4x4 luma mode map (each NxN PU its own mode)
        nxn_slot = to_blocked(nxn_map, 8) & (depth8 == 3) & coded8
        nxn8_frame = from_blocked(nxn_slot)
        mode8_frame = from_blocked(mode_slot)
        mode4_frame = torch.where(_rep2(nxn8_frame, 2), modes[4],
                                  _rep2(mode8_frame, 2))

        # chroma DM of NxN CUs resolves against PU0's luma mode (8.4.3)
        csel8_frame = from_blocked(csel_slot)
        cmode8_frame = from_blocked(cmode_slot)
        pu0 = modes[4][:, ::2, ::2]
        cand = torch.as_tensor(_CHROMA_LIST, device=yp.device)[
            torch.clamp(csel8_frame, 0, 3).long()]
        cand = torch.where(cand == pu0, 34, cand)
        resolved = torch.where(csel8_frame == 4, pu0, cand)
        cmode8_frame = torch.where(nxn8_frame, resolved, cmode8_frame)

        # per-slot leaf TU size: the chosen CU size's tree (2 = four 4x4)
        d8f = from_blocked(depth8)
        if self.tu_split:
            tusz_frame = torch.where(
                d8f == 0, tz[64], torch.where(d8f == 1, tz[32], torch.where(
                    d8f == 2, tz[16], tz[8])))
        else:
            tusz_frame = ctu.tu_size_for_slot(d8f)
        tusz_frame = torch.where(nxn8_frame, 2, tusz_frame).to(torch.int32)

        return dict(mode_slot=mode_slot,
                    cmode_slot=to_blocked(cmode8_frame, 8),
                    tusz_frame=tusz_frame, coded8=coded8, depth8=depth8,
                    mode4_frame=mode4_frame, mode8_frame=mode8_frame,
                    csel8_frame=csel8_frame, nxn8_frame=nxn8_frame)

    def _loop_filters_and_cast(self, yp, up, vp, out, tusz_frame):
        """Deblock (per-slot QPs under a QP map), then SAO against the
        original, each when on; crop, picture digests and SSE, and the
        output casts."""
        g = self.geom
        fy, fu, fv = out["recon_y"], out["recon_u"], out["recon_v"]
        if self.deblock:
            db_qp = (_rep2(out["qp_ctu"], 8) if "qp_ctu" in out
                     else self.qp)
            fy, fu, fv = deblock.deblock_frame(fy, fu, fv, tusz_frame, db_qp,
                                               g.h, g.w)
        if self.sao:
            ys = sao.ctu_stats(yp, fy, g.h, g.w, 64)
            us = sao.ctu_stats(up, fu, g.h // 2, g.w // 2, 32)
            vs = sao.ctu_stats(vp, fv, g.h // 2, g.w // 2, 32)
            st, se, sbp, soff, smrg = sao.decide_params(ys, us, vs, self.qp,
                                                        self.qp_c)
            fy = sao.apply_sao(fy, st, se, sbp, soff, 0, g.h, g.w, 64)
            fu = sao.apply_sao(fu, st, se, sbp, soff, 1, g.h // 2, g.w // 2,
                               32)
            fv = sao.apply_sao(fv, st, se, sbp, soff, 2, g.h // 2, g.w // 2,
                               32)
            out["sao_type"], out["sao_eo"] = st, se
            out["sao_bp"], out["sao_off"] = sbp, soff
            out["sao_merge"] = smrg
        out["recon_y"] = fy[:, : g.h, : g.w]
        out["recon_u"] = fu[:, : g.h // 2, : g.w // 2]
        out["recon_v"] = fv[:, : g.h // 2, : g.w // 2]
        out["hash_checksum"] = torch.stack(
            [_checksum_plane(out[k]) for k in ("recon_y", "recon_u",
                                               "recon_v")], dim=-1)
        out["sse"] = torch.stack(
            [_sse(out["recon_y"], yp[:, : g.h, : g.w]),
             _sse(out["recon_u"], up[:, : g.h // 2, : g.w // 2]),
             _sse(out["recon_v"], vp[:, : g.h // 2, : g.w // 2])], dim=-1)
        return {k: (t.to(_OUT_CAST[k]) if k in _OUT_CAST else t)
                for k, t in out.items()}

    def _ctu_qps(self, qp_map, bi, ri, ci):
        """Quantizer settings of one diagonal's CTUs: (luma qp, chroma qp
        [2BA], RDOQ λ luma/chroma, TS λ luma/chroma). Static scalars
        without a QP map; with one, each CTU's QP is gathered, chroma QP
        goes through Table 8-10 and the λs scale by 2^((qp - sliceQP)/3)
        (`lambda_scale`)."""
        if qp_map is None:
            return (self.qp, self.qp_c, self.rdoq_lam, self.rdoq_lam_c,
                    self.ts_lam, self.ts_lam_c)
        qp_l = qp_map[bi, ri, ci]
        sc = lambda_scale(qp_l - self.qp)
        qp_c2 = deblock.qp_tables(qp_l.device)[2][
            torch.clamp(qp_l, 0, 57).long()].repeat(2)
        sc2 = sc.repeat(2)

        def scaled(lam, s):
            return lam * s if lam else 0.0

        return (qp_l, qp_c2, scaled(self.rdoq_lam, sc),
                scaled(self.rdoq_lam_c, sc2), scaled(self.ts_lam, sc),
                scaled(self.ts_lam_c, sc2))

    def _reconstruct(self, yp, up, vp, mode_slot, cmode_slot, tusz_slot,
                     coded8, mode4_blk, qp_map=None, shard=None):
        """Stage 2, the wavefront reconstruction. On the card the
        kernel form: the traced form's gather and scatter replayed from
        CUDA graphs captured once per (batch, QP map or not, tile) and
        cached on the encoder, the stage-2 kernel between them
        (_reconstruct_traced); on the CPU the host-planned form
        (_reconstruct_planned). Both give the same 13 planes."""
        fn = (self._reconstruct_traced if yp.device.type == "cuda"
              else self._reconstruct_planned)
        return fn(yp, up, vp, mode_slot, cmode_slot, tusz_slot, coded8,
                  mode4_blk, qp_map, shard)

    def _reconstruct_traced(self, yp, up, vp, mode_slot, cmode_slot,
                            tusz_slot, coded8, mode4_blk, qp_map=None,
                            shard=None):
        """The reference's stage 2 (_Wavefront): every diagonal at its
        fixed width, the static TU schedule with fire decisions taken on
        the device. On the card the gather and scatter replay captured
        CUDA graphs and the stage-2 kernel codes each CTU's TUs between
        them, with nothing read back to the host; on the CPU the
        segments run eagerly (424 masked steps a diagonal, the kernel's
        plain version). Arguments and outputs as
        _reconstruct_planned's."""
        b = yp.shape[0]
        tiles, ti = (1, 0) if shard is None else (shard.tile,
                                                  shard.tile_index)
        cl = self.geom.cc // tiles
        own = slice(ti * cl, ti * cl + cl)
        inputs = dict(y=to_blocked(yp, 64), u=to_blocked(up, 32),
                      v=to_blocked(vp, 32), tz=tusz_slot, c8=coded8,
                      msl=mode_slot, cm8=cmode_slot, mm4=mode4_blk)
        inputs = {k: t[:, :, own] for k, t in inputs.items()}
        if qp_map is not None:
            inputs["qp_map"] = qp_map
        if yp.device.type != "cuda":
            return _Wavefront(self, b, yp.device, tiles, ti).run(inputs,
                                                                 shard)
        key = (b, qp_map is not None, tiles, ti)
        wf = self._stage2.pop(key, None)
        if wf is None:
            wf = _Wavefront(self, b, yp.device, tiles, ti)
        self._stage2[key] = wf
        while len(self._stage2) > _GRAPH_CACHE:
            self._stage2.popitem(last=False)
            trace.count("stage2.evictions")
        return wf.run(inputs, shard)

    def _reconstruct_planned(self, yp, up, vp, mode_slot, cmode_slot,
                             tusz_slot, coded8, mode4_blk, qp_map=None,
                             shard=None):
        """Stage 2's plain version, planned on the host: the partition
        is read back (_stage2_plan) and each diagonal runs only the TU
        steps some of its CTUs fire, in z-order. qp_map [B, rc, cc] gives
        each CTU its own QP and λs.

        shard (a parallel.Mesh with more than one tile) runs this rank's
        tile of cc/tiles CTU columns: the inputs stay global, the state
        and the outputs are the tile's [B, rc, cl, ...]. The cross-tile
        dependencies, the left CTU's right edge (and the above-left
        corner) and the above-right CTU's bottom row, come from halos
        that every tile exchanges after every diagonal, whether or not it
        had a CTU on it (shard.exchange is collective)."""
        g = self.geom
        b = yp.shape[0]
        dev = yp.device
        rc = g.rc
        i32 = torch.int32
        tiles, ti = (1, 0) if shard is None else (shard.tile,
                                                  shard.tile_index)
        cl = g.cc // tiles
        c0 = ti * cl
        own = slice(c0, c0 + cl)

        def zeros(*shape, dtype=i32):
            return torch.zeros((b, rc, cl) + shape, dtype=dtype, device=dev)

        oy_b, ou_b, ov_b = (to_blocked(yp, 64)[:, :, own],
                            to_blocked(up, 32)[:, :, own],
                            to_blocked(vp, 32)[:, :, own])
        mode_slot, cmode_slot, mode4_blk = (
            mode_slot[:, :, own], cmode_slot[:, :, own], mode4_blk[:, :, own])
        ry, ru, rv = zeros(64, 64), zeros(32, 32), zeros(32, 32)
        lvy, lvu, lvv = zeros(64, 64), zeros(32, 32), zeros(32, 32)
        cby, cbu, cbv = (zeros(8, 8, dtype=torch.bool) for _ in range(3))
        cb4, t4b = (zeros(16, 16, dtype=torch.bool) for _ in range(2))
        tub, tvb = (zeros(8, 8, dtype=torch.bool) for _ in range(2))
        # halos: from the left tile its right-edge columns, from the right
        # tile its first column's bottom rows, [B, rc, 64 + 32 + 32] (Y, U,
        # V); zero before the first exchange and beyond the picture's edges
        # (dead there: availability masks them off)
        halo_l = halo_r = torch.zeros((b, rc, 128), dtype=i32, device=dev)

        upload = _Upload()
        plan = _stage2_plan(g, tuple(t[ti] for t in g.wavefront_tiled(tiles)),
                            tusz_slot[:, :, own].cpu().numpy(),
                            coded8[:, :, own].cpu().numpy(), upload, c0)
        upload.upload(dev)

        for d, (idx, steps) in enumerate(plan):
            with trace.diagonal():
                if shard is not None and d:
                    # every tile, every diagonal: the exchange is collective
                    halo_l, halo_r = shard.exchange(*_tile_edges(ry, ru, rv))
                bi, ri, ci = upload.get(idx)
                ba = bi.shape[0]
                if ba == 0:
                    continue
                ext_y, ext_c = _diag_ext(ry, ru, rv, bi, ri, ci, cl,
                                         None if shard is None
                                         else (halo_l, halo_r))
                oyl = oy_b[bi, ri, ci]                         # [BA, 64, 64]
                ouv = torch.cat([ou_b[bi, ri, ci], ov_b[bi, ri, ci]])
                msl = mode_slot[bi, ri, ci]                    # [BA, 8, 8]
                cm8 = cmode_slot[bi, ri, ci]
                mm4 = mode4_blk[bi, ri, ci]                    # [BA, 16, 16]
                vy = torch.zeros((ba, 64, 64), dtype=i32, device=dev)
                vc = torch.zeros((2 * ba, 32, 32), dtype=i32, device=dev)
                cy8 = torch.zeros((ba, 8, 8), dtype=torch.bool, device=dev)
                cc8 = torch.zeros((2 * ba, 8, 8), dtype=torch.bool, device=dev)
                cy4 = torch.zeros((ba, 16, 16), dtype=torch.bool, device=dev)
                ty4 = torch.zeros((ba, 16, 16), dtype=torch.bool, device=dev)
                tc8 = torch.zeros((2 * ba, 8, 8), dtype=torch.bool, device=dev)
                qp_l, qp_c2, rl_y, rl_c, tl_y, tl_c = self._ctu_qps(qp_map, bi,
                                                                    ri, ci)

                for n, oy, ox, lstep, cstep in steps:
                    if n == 4:
                        fire, av = (upload.get(h) for h in lstep)
                        sy, sx = oy // 4, ox // 4
                        cbf, ts = _tu_step(
                            ext_y, vy, oyl, mm4[:, sy, sx], fire, oy, ox, 4,
                            qp_l, av, is_luma=True, rdoq_lam=rl_y, dst=True,
                            ts_lam=tl_y, rate_qp=self.qp, sbh=self.sbh)
                        cy4[:, sy, sx] = torch.where(fire, cbf, cy4[:, sy, sx])
                        ty4[:, sy, sx] = torch.where(fire, ts, ty4[:, sy, sx])
                        continue
                    sy, sx = oy // 8, ox // 8
                    if lstep:
                        fire, av = (upload.get(h) for h in lstep)
                        cbf, _ = _tu_step(
                            ext_y, vy, oyl, msl[:, sy, sx], fire, oy, ox, n,
                            qp_l, av, is_luma=True, rdoq_lam=rl_y, dst=False,
                            ts_lam=0.0, rate_qp=self.qp, sbh=self.sbh)
                        cy8[:, sy, sx] = torch.where(fire, cbf, cy8[:, sy, sx])
                    if cstep:
                        fire, av = (upload.get(h) for h in cstep)
                        cbf, ts = _tu_step(
                            ext_c, vc, ouv, cm8[:, sy, sx].repeat(2), fire,
                            oy // 2, ox // 2, n // 2, qp_c2, av,
                            is_luma=False, rdoq_lam=rl_c, dst=False,
                            ts_lam=tl_c, rate_qp=self.qp_c, sbh=self.sbh)
                        cc8[:, sy, sx] = torch.where(fire, cbf, cc8[:, sy, sx])
                        tc8[:, sy, sx] = torch.where(fire, ts, tc8[:, sy, sx])

                # scatter the CTUs' local results (every index is distinct)
                ry[bi, ri, ci] = ext_y[:, 1:65, 1:65]
                ru[bi, ri, ci] = ext_c[:ba, 1:33, 1:33]
                rv[bi, ri, ci] = ext_c[ba:, 1:33, 1:33]
                lvy[bi, ri, ci] = vy
                lvu[bi, ri, ci] = vc[:ba]
                lvv[bi, ri, ci] = vc[ba:]
                cby[bi, ri, ci] = cy8
                cbu[bi, ri, ci] = cc8[:ba]
                cbv[bi, ri, ci] = cc8[ba:]
                cb4[bi, ri, ci] = cy4
                t4b[bi, ri, ci] = ty4
                tub[bi, ri, ci] = tc8[:ba]
                tvb[bi, ri, ci] = tc8[ba:]

        return {
            "recon_y": from_blocked(ry), "recon_u": from_blocked(ru),
            "recon_v": from_blocked(rv),
            "levels_y": from_blocked(lvy), "levels_u": from_blocked(lvu),
            "levels_v": from_blocked(lvv),
            "cbf_y": from_blocked(cby), "cbf_u": from_blocked(cbu),
            "cbf_v": from_blocked(cbv), "cbf4_y": from_blocked(cb4),
            "ts4_y": from_blocked(t4b), "ts8_u": from_blocked(tub),
            "ts8_v": from_blocked(tvb),
        }
