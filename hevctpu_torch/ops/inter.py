"""Inter-prediction ops: MC interpolation, dense motion search, MV costs,
weighted prediction and merge candidates (port of hevctpu/ops/inter.py).

Inert at the All-Intra operating point: no encode path calls them; they
are held to the JAX package's functions on the same inputs
(tests/test_torch_inter.py). Plain torch on the inputs' device, int32
arithmetic as in the reference (IF_INTERNAL_PREC=14, IF_FILTER_PREC=6,
headroom 6 at 8-bit); edge replication by clamped indices, since
F.pad(mode="replicate") takes no integer tensors. wp_estimate is numpy
(float64), as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Fractional-sample filters (H.265 Tables 8-10/8-11; spec-mandated).
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], np.int32)

CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2]], np.int32)

_PREC = 14            # IF_INTERNAL_PREC
_FPREC = 6            # IF_FILTER_PREC
_OFFS = 1 << (_PREC - 1)
_HEADROOM = _PREC - 8  # = 6 at 8-bit


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device).to(torch.int32)


def _edge_pad(plane: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Edge-replicate pad of the last two axes by lo before and hi after."""
    h, w = plane.shape[-2:]
    ri = torch.clamp(torch.arange(-lo, h + hi, device=plane.device), 0, h - 1)
    ci = torch.clamp(torch.arange(-lo, w + hi, device=plane.device), 0, w - 1)
    return plane.index_select(-2, ri).index_select(-1, ci)


def _pad_ref(plane: torch.Tensor, taps: int, extra: int = 0) -> torch.Tensor:
    """Edge-replicate pad for out-of-picture MC reads (HM pads the
    reference picture margins the same way, TComPicYuv::extendPicBorder).
    Pads taps//2-1+extra left/top and taps//2+extra right/bottom."""
    return _edge_pad(plane, taps // 2 - 1 + extra, taps // 2 + extra)


def _filter_pass(win: torch.Tensor, coeff: torch.Tensor, axis: int,
                 taps: int, n: int) -> torch.Tensor:
    """Apply one separable pass: win [..., H, W] (already padded along
    `axis` by taps-1), coeff [..., taps] per-block filters. Returns the
    un-normalized 32-bit accumulator with n output samples along axis."""
    out = None
    for k in range(taps):
        term = win.narrow(axis, k, n) * coeff[..., k, None, None]
        out = term if out is None else out + term
    return out


def _mc_grid(plane: torch.Tensor, mv: torch.Tensor, n: int,
             filters: np.ndarray, fshift: int) -> torch.Tensor:
    """The aligned n x n grid's MC predictions [B, R, C, n, n]: luma
    (8 taps, quarter-pel, fshift 2) or chroma (4 taps, eighth-pel from
    the luma vector, fshift 3)."""
    taps = filters.shape[1]
    lo = taps // 2 - 1
    b, h, w = plane.shape
    r, c = h // n, w // n
    dev = plane.device
    plane = _int32(plane, dev)
    mv = _int32(mv, dev)
    ref = _pad_ref(plane, taps)
    iy, ix = mv[..., 0] >> fshift, mv[..., 1] >> fshift
    fmask = (1 << fshift) - 1
    fy, fx = (mv[..., 0] & fmask).long(), (mv[..., 1] & fmask).long()

    # gather the (n+taps-1)^2 source patch per block, clamped in the
    # padded plane (edge replication == HM's picture border extension)
    gy = torch.arange(r, device=dev) * n
    gx = torch.arange(c, device=dev) * n
    by = gy[None, :, None] + iy                     # [B, R, C] top-left y
    bx = gx[None, None, :] + ix
    span = torch.arange(n + taps - 1, device=dev)
    oy = torch.clamp(by[..., None] + span, 0, h + taps - 2).long()
    ox = torch.clamp(bx[..., None] + span, 0, w + taps - 2).long()
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    patch = ref[bi, oy[..., :, None], ox[..., None, :]]  # [B,R,C,n+t-1,..]

    tab = torch.as_tensor(filters, device=dev)
    cfy, cfx = tab[fy], tab[fx]                     # [B, R, C, taps]

    # horizontal pass (isFirst): shift 0, offset -OFFS; vertical pass
    # (isLast): shift 12 with HM's combined offset
    mid = _filter_pass(patch, cfx, -1, taps, n) - _OFFS
    two = (_filter_pass(mid, cfy, -2, taps, n)
           + (1 << 11) + (_OFFS << _FPREC)) >> 12
    # single-pass variants (one frac 0) and the pure copy
    honly = (_filter_pass(patch[..., lo: lo + n, :], cfx, -1, taps, n)
             + 32) >> 6
    vonly = (_filter_pass(patch[..., :, lo: lo + n], cfy, -2, taps, n)
             + 32) >> 6
    copy = patch[..., lo: lo + n, lo: lo + n]

    fy_, fx_ = fy[..., None, None], fx[..., None, None]
    out = torch.where((fy_ == 0) & (fx_ == 0), copy,
                      torch.where(fy_ == 0, honly,
                                  torch.where(fx_ == 0, vonly, two)))
    return torch.clamp(out, 0, 255)


def mc_luma_grid(plane: torch.Tensor, mv: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Motion-compensated luma prediction for the aligned n x n grid.

    plane [B, H, W] int32 reference samples; mv [B, R, C, 2] quarter-pel
    motion vectors (mv[..., 0] = dy, mv[..., 1] = dx) for each grid
    block. Returns [B, R, C, n, n] int32 predictions in [0, 255] — the
    two-pass 8-tap arithmetic of TComInterpolationFilter::filter
    (horizontal first into 14-bit intermediates, vertical with the
    combined rounding, single-pass shortcuts when one frac is 0)."""
    return _mc_grid(plane, mv, n, LUMA_FILTERS, 2)


def mc_chroma_grid(plane: torch.Tensor, mv: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Chroma MC for the aligned n x n chroma grid: 4-tap eighth-pel
    (mv is the LUMA quarter-pel vector; chroma frac = mv & 7 at half
    resolution, H.265 8.5.4.2.2.2)."""
    return _mc_grid(plane, mv, n, CHROMA_FILTERS, 3)


def bi_average(pred0: torch.Tensor, pred1: torch.Tensor) -> torch.Tensor:
    """Default bi-prediction average of two 14-bit MC intermediates
    (H.265 8.5.4.2.3; TComYuv::addAvg semantics at 8-bit: shift 7)."""
    dev = pred0.device if isinstance(pred0, torch.Tensor) else None
    shift = _PREC + 1 - 8
    offset = (1 << (shift - 1)) + 2 * _OFFS
    return torch.clamp((_int32(pred0, dev) + _int32(pred1, dev) + offset)
                       >> shift, 0, 255)


def _blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, H, W] -> [B, R, C, n, n]."""
    b, h, w = x.shape
    return x.reshape(b, h // n, n, w // n, n).transpose(2, 3)


def sad_full_search(cur: torch.Tensor, ref: torch.Tensor, n: int,
                    srange: int):
    """Dense integer-pel motion search for every aligned n x n block.

    cur, ref [B, H, W] int32. Evaluates the FULL (2*srange+1)^2 SAD
    window for every block (a superset of the TZ diamond's candidates,
    TEncSearch::xTZSearch). Ties go to the first candidate in raster
    order of (dy, dx), as argmin takes the first minimum.

    Returns (mv [B, R, C, 2] int32 integer-pel in quarter-pel units,
    best_sad [B, R, C] int32)."""
    dev = cur.device if isinstance(cur, torch.Tensor) else None
    cur, ref = _int32(cur, dev), _int32(ref, dev)
    b, h, w = cur.shape
    cb = _blocks(cur, n)
    refp = _edge_pad(ref, srange, srange)
    k = 2 * srange + 1
    sads = torch.stack([
        (cb - _blocks(refp[:, dy: dy + h, dx: dx + w], n)).abs().sum(
            dim=(-2, -1))
        for dy in range(k) for dx in range(k)], dim=-1)      # [B,R,C,K*K]
    best = torch.argmin(sads, dim=-1)
    dy = best // k - srange
    dx = best % k - srange
    mv = torch.stack([dy * 4, dx * 4], dim=-1).to(torch.int32)
    return mv, sads.min(dim=-1).values.to(torch.int32)


def frac_refine(cur: torch.Tensor, ref: torch.Tensor, mv: torch.Tensor,
                n: int):
    """Quarter-pel refinement: evaluate the 8 half-pel then the 8
    quarter-pel neighbors of the running best (the reference's two-stage
    xPatternSearchFracDIF, TEncSearch.cpp:4538), SAD-scored on the
    interpolated prediction. mv [B, R, C, 2] quarter-pel. Returns the
    refined (mv, sad)."""
    dev = cur.device if isinstance(cur, torch.Tensor) else None
    cur, ref, mv = (_int32(x, dev) for x in (cur, ref, mv))
    cb = _blocks(cur, n)

    def sad_at(m):
        p = mc_luma_grid(ref, m, n)
        return (cb - p).abs().sum(dim=(-2, -1)).to(torch.int32)

    best_mv, best_sad = mv, sad_at(mv)
    for step in (2, 1):                       # half-pel, then quarter-pel
        center = best_mv                      # fixed stage center
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dy == 0 and dx == 0:
                    continue
                cand = center + torch.tensor([dy, dx], dtype=torch.int32,
                                             device=cur.device)
                s = sad_at(cand)
                take = s < best_sad
                best_mv = torch.where(take[..., None], cand, best_mv)
                best_sad = torch.minimum(s, best_sad)
    return best_mv, best_sad


def amvp_candidates(mv_field: torch.Tensor):
    """Spatial AMVP predictors from a dense per-block MV field
    [B, R, C, 2]: candidate A = left neighbor, candidate B = above
    neighbor (out-of-picture neighbors fall back to the zero MV).
    Returns (mvp_a, mvp_b)."""
    f = _int32(mv_field, mv_field.device if isinstance(mv_field, torch.Tensor)
               else None)
    za, zb = torch.zeros_like(f), torch.zeros_like(f)
    za[:, :, 1:] = f[:, :, :-1]
    zb[:, 1:] = f[:, :-1]
    return za, zb


@functools.lru_cache(maxsize=None)
def _eg1_len_table(maxv: int = 1 << 15) -> np.ndarray:
    out = np.zeros(maxv, np.int32)
    for v in range(maxv):
        # 1st-order Exp-Golomb codeword length
        k, vv = 1, v
        length = 0
        while vv >= (1 << k):
            vv -= 1 << k
            k += 1
            length += 2
        out[v] = length + 1 + k
    return out


def mvd_bits(mvd: torch.Tensor) -> torch.Tensor:
    """Signaling bits of an MV difference [..., 2] under the mvd_coding
    binarization (7.3.8.9: greater0 + greater1 flags, EG1 remainder,
    sign). Returns [...] int32 bits."""
    dev = mvd.device if isinstance(mvd, torch.Tensor) else None
    a = _int32(mvd, dev).abs()
    eg1 = torch.as_tensor(_eg1_len_table(), device=a.device)
    per = torch.where(
        a == 0, 1,
        torch.where(a == 1, 3,
                    2 + eg1[torch.clamp(a - 2, 0, eg1.shape[0] - 1).long()]
                    + 1))
    return per.sum(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Weighted prediction (TComWeightPrediction.cpp:46-64 sample formulas,
# WeightPredAnalysis.cpp:351-440 parameter estimation)
# ---------------------------------------------------------------------------


def wp_acdc(plane: torch.Tensor):
    """Per-frame (DC, AC) moments of [B, H, W] samples: DC = the rounded
    per-sample mean ((Σx + N/2) / N) int32, AC = Σ|x − DC| float32. The
    sums of integers are taken exactly (float64, exact below 2^53) and
    rounded once to float32; the JAX package sums in float32 in an order
    XLA picks, exact while the sums stay below 2^24 (an 8-bit frame below
    ~65k samples for DC) and within float32 rounding above."""
    dev = plane.device if isinstance(plane, torch.Tensor) else None
    x = _int32(plane, dev)
    n = x.shape[-2] * x.shape[-1]
    s = x.to(torch.float64).sum(dim=(-2, -1)).to(torch.float32)
    dc = torch.floor((s + n / 2) / n).to(torch.int32)
    ac = (x - dc[..., None, None]).abs().to(torch.float64).sum(
        dim=(-2, -1)).to(torch.float32)
    return dc, ac


def wp_estimate(cur_dc, cur_ac, ref_dc, ref_ac, *, log2_denom: int = 6,
                bit_depth: int = 8, chroma: bool = False):
    """Explicit WP (weight, offset, valid) from current/reference moments
    — WeightPredAnalysis::xUpdatingWPParameters exactly: weight =
    round((AC_cur/AC_ref)·2^denom) with the ±16/15 ratio clip, offset =
    (DC_cur·2^denom − w·DC_ref + round) >> realDenom, luma offset
    clipped to [−128, 127], chroma offset clipped through the predicted
    form; valid = |w − 2^denom| < 128 (numpy, float64)."""
    cur_dc, cur_ac, ref_dc, ref_ac = (
        np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v,
                   np.float64) for v in (cur_dc, cur_ac, ref_dc, ref_ac))
    rng = 128
    real_denom = log2_denom + (bit_depth - 8)
    real_off = 1 << max(real_denom - 1, 0)
    ratio = np.where(ref_ac == 0, 1.0,
                     np.clip(cur_ac / np.maximum(ref_ac, 1e-30),
                             -16.0, 15.0))
    weight = np.floor(0.5 + ratio * (1 << log2_denom)).astype(np.int64)
    offset = ((cur_dc.astype(np.int64) << log2_denom)
              - weight * ref_dc.astype(np.int64)
              + real_off) >> real_denom if real_denom > 0 else (
        (cur_dc.astype(np.int64) << log2_denom)
        - weight * ref_dc.astype(np.int64))
    if chroma:
        pred = rng - ((rng * weight) >> log2_denom)
        delta = np.clip(offset - pred, -4 * rng, 4 * rng - 1)
        offset = np.clip(delta + pred, -rng, rng - 1)
    else:
        offset = np.clip(offset, -rng, rng - 1)
    valid = np.abs(weight - (1 << log2_denom)) < rng
    return (weight.astype(np.int32), offset.astype(np.int32),
            valid.astype(bool))


def wp_apply(pred14: torch.Tensor, weight, offset, *, log2_denom: int = 6,
             bit_depth: int = 8) -> torch.Tensor:
    """Uni-directional weighted sample prediction (8.5.3.3.4.3;
    TComWeightPrediction::weightUnidir) of the 14-bit MC intermediates
    before the final rounding shift; returns clipped pels."""
    dev = pred14.device if isinstance(pred14, torch.Tensor) else None
    shift_num = max(2, _PREC - bit_depth)
    shift = log2_denom + shift_num
    rnd = 1 << (shift - 1) if shift > 0 else 0
    maxv = (1 << bit_depth) - 1
    w, o = _int32(weight, dev), _int32(offset, dev)
    out = ((w * (_int32(pred14, dev) + _OFFS) + rnd) >> shift) + o
    return torch.clamp(out, 0, maxv)


def wp_apply_bi(pred14_0: torch.Tensor, pred14_1: torch.Tensor, w0, o0, w1,
                o1, *, log2_denom: int = 6,
                bit_depth: int = 8) -> torch.Tensor:
    """Bi-directional weighted sample prediction
    (TComWeightPrediction::weightBidir): (w0*(P0+OFFS) + w1*(P1+OFFS) +
    round + (offset << (shift-1))) >> shift, offset = (o0 + o1 + 1) >> 1."""
    dev = pred14_0.device if isinstance(pred14_0, torch.Tensor) else None
    shift_num = max(2, _PREC - bit_depth)
    shift = log2_denom + shift_num + 1
    rnd = 1 << (shift - 1) if shift > 0 else 0
    maxv = (1 << bit_depth) - 1
    w0, o0, w1, o1 = (_int32(v, dev) for v in (w0, o0, w1, o1))
    off = (o0 + o1 + 1) >> 1
    out = (w0 * (_int32(pred14_0, dev) + _OFFS)
           + w1 * (_int32(pred14_1, dev) + _OFFS)
           + rnd + (off << (shift - 1))) >> shift
    return torch.clamp(out, 0, maxv)


def wp_select(cur: torch.Tensor, ref: torch.Tensor, weight, offset, *,
              log2_denom: int = 6) -> torch.Tensor:
    """Per-frame WP on/off decision (WeightPredAnalysis::xSelectWP): use
    explicit weighting iff SAD(cur, weighted ref) < SAD(cur, ref) with
    the zero-MV alignment HM's fast check uses. cur/ref [B, H, W] pels;
    returns bool [B]."""
    dev = cur.device if isinstance(cur, torch.Tensor) else None
    cur, ref = _int32(cur, dev), _int32(ref, dev)
    # lift pels to the 14-bit intermediate domain the weighting stage
    # sees (pel << headroom, re-centered by -IF_INTERNAL_OFFS)
    p14 = (ref << _HEADROOM) - _OFFS
    wref = wp_apply(p14, weight, offset, log2_denom=log2_denom)
    sad_w = (cur - wref).abs().sum(dim=(-2, -1))
    sad_0 = (cur - ref).abs().sum(dim=(-2, -1))
    return sad_w < sad_0


# ---------------------------------------------------------------------------
# Merge candidate derivation (8.5.3.2.3; TComDataCU::getInterMergeCandidates)
# on the dense block grid.
# ---------------------------------------------------------------------------


def merge_candidates(mv_field: torch.Tensor):
    """Spatial merge candidates per grid block from a dense MV field
    [B, R, C, 2]: the A1 (left), B1 (above), B0 (above-right), A0
    (below-left), B2 (above-left) positions with the spec's pairwise
    pruning (B1 vs A1, B0 vs B1, A0 vs A1; B2 only when fewer than four
    candidates and differing from both A1 and B1). Returns
    (cands [B, R, C, 5, 2], valid [B, R, C, 5]) in candidate order."""
    dev = mv_field.device if isinstance(mv_field, torch.Tensor) else None
    f = _int32(mv_field, dev)
    _, r, c, _ = f.shape

    def shift2(dy, dx):
        m = torch.roll(f, (-dy, -dx), dims=(1, 2))
        ry = torch.arange(r, device=f.device)[None, :, None] + dy
        rx = torch.arange(c, device=f.device)[None, None, :] + dx
        ok = (ry >= 0) & (ry < r) & (rx >= 0) & (rx < c)
        return torch.where(ok[..., None], m, 0), ok

    a1, va1 = shift2(0, -1)    # left
    b1, vb1 = shift2(-1, 0)    # above
    b0, vb0 = shift2(-1, 1)    # above-right
    a0, vb_a0 = shift2(1, -1)  # below-left (valid only under z-order walks)
    b2, vb2 = shift2(-1, -1)   # above-left

    def ne(x, y):
        return (x != y).any(dim=-1)

    v1 = va1.expand(f.shape[:3])
    v2 = vb1 & (~va1 | ne(b1, a1))
    v3 = vb0 & (~vb1 | ne(b0, b1))
    v4 = vb_a0 & (~va1 | ne(a0, a1))
    count4 = (v1.to(torch.int32) + v2.to(torch.int32) + v3.to(torch.int32)
              + v4.to(torch.int32))
    v5 = vb2 & (count4 < 4) & (~va1 | ne(b2, a1)) & (~vb1 | ne(b2, b1))
    cands = torch.stack([a1, b1, b0, a0, b2], dim=-2)
    valid = torch.stack([v1, v2, v3, v4, v5], dim=-1)
    return cands, valid
