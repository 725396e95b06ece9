"""HEVC deblocking filter as batched tensor ops (port of
hevctpu/ops/deblock.py).

All vertical edges of the picture filter in one vectorized pass (the 8-pel
edge grid folds into a block axis by reshape), then all horizontal edges
on the transposed result. All-Intra means every TU boundary has bS = 2,
so the bS map is the TU-edge mask from the per-slot leaf TU sizes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import rom

# H.265 Table 8-12: beta' and tc' indexed by Q.
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13,
    14, 16, 18, 20, 22, 24], dtype=np.int32)


def tu_edge_mask(tusz8: torch.Tensor, w: int) -> torch.Tensor:
    """Vertical TU-edge flags on the luma 8-grid: True where the left edge
    of slot (sy, sx) is a TU boundary inside the picture. tusz8 [..., Sy,
    Sx] leaf TU log2 per 8x8 slot; 4x4 TUs clip to the 8-grid."""
    step8 = 1 << (torch.clamp(tusz8, 3, 5) - 3)
    pos = torch.arange(tusz8.shape[-1], device=tusz8.device)[None, :]
    aligned = (pos % step8) == 0
    inside = (pos > 0) & (pos * 8 < w)
    return aligned & inside


@functools.lru_cache(maxsize=None)
def qp_tables(device: torch.device):
    """(β, tc, chroma QP) tables on device, for per-slot QP maps."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in (BETA_TABLE, TC_TABLE, rom.CHROMA_QP_TABLE))


def _luma_vertical(plane: torch.Tensor, edge8: torch.Tensor, qp,
                   bit_depth: int = 8) -> torch.Tensor:
    """Filter all vertical luma edges of plane [B, H, W] (multiples of 8);
    edge8 [B, H/8, W/8] slot edge flags. qp: static int, or a per-slot
    map [B, H/8, W/8]: each edge's Q is then the average of the two
    sides' QPs ((QpQ + QpP + 1) >> 1, 8.7.2.5.3) and beta/tc are
    gathered per edge."""
    b, h, w = plane.shape
    e = w // 8
    if isinstance(qp, (int, np.integer)):
        beta = int(BETA_TABLE[min(max(qp, 0), 51)]) << (bit_depth - 8)
        tc = tc4 = int(TC_TABLE[min(max(qp + 2, 0), 53)]) << (bit_depth - 8)
        if tc == 0 and beta == 0:
            return plane
    else:
        beta_t, tc_t, _ = qp_tables(plane.device)
        qe = (qp[:, :, :-1] + qp[:, :, 1:] + 1) >> 1       # [B, H/8, E-1]
        qe = qe.repeat_interleave(2, dim=1).long()         # [B, H/4, E-1]
        beta = beta_t[torch.clamp(qe, 0, 51)] << (bit_depth - 8)
        tc = tc_t[torch.clamp(qe + 2, 0, 53)] << (bit_depth - 8)
        tc4 = tc[:, :, None, :]                            # line axis
    maxv = (1 << bit_depth) - 1

    blk = plane.reshape(b, h, e, 8)
    # samples p3..p0 q0..q3 around edge k (x = 8(k+1)), 4-line segments
    pq = torch.cat([blk[:, :, :-1, 4:], blk[:, :, 1:, :4]], dim=-1)
    pq = pq.reshape(b, h // 4, 4, e - 1, 8)
    p3, p2, p1, p0 = (pq[..., i] for i in range(4))
    q0, q1, q2, q3 = (pq[..., 4 + i] for i in range(4))

    # decisions from lines 0 and 3 (8.7.2.5.3)
    dp = (p2 - 2 * p1 + p0).abs()                  # [B, S, 4, E]
    dq = (q2 - 2 * q1 + q0).abs()
    dp0, dp3 = dp[:, :, 0], dp[:, :, 3]
    dq0, dq3 = dq[:, :, 0], dq[:, :, 3]
    d = dp0 + dq0 + dp3 + dq3                      # [B, S, E]
    edge_seg = edge8.repeat_interleave(2, dim=1)[..., 1:]
    filt = (d < beta) & edge_seg

    def dsam(i):
        return ((2 * (dp[:, :, i] + dq[:, :, i]) < (beta >> 2))
                & ((p3[:, :, i] - p0[:, :, i]).abs()
                   + (q0[:, :, i] - q3[:, :, i]).abs() < (beta >> 3))
                & ((p0[:, :, i] - q0[:, :, i]).abs() < ((5 * tc + 1) >> 1)))

    strong = dsam(0) & dsam(3)                     # [B, S, E]
    dep1 = dp0 + dp3 < ((beta + (beta >> 1)) >> 3)
    deq1 = dq0 + dq3 < ((beta + (beta >> 1)) >> 3)

    # strong filter (8.7.2.5.7), clip +-2tc
    def sclip(orig, val):
        return torch.minimum(torch.maximum(val, orig - 2 * tc4),
                             orig + 2 * tc4)

    sp0 = sclip(p0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = sclip(p1, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = sclip(p2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = sclip(q0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = sclip(q1, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = sclip(q2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    # weak filter (8.7.2.5.7)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = delta.abs() < tc4 * 10
    dlt = torch.clamp(delta, -tc4, tc4)
    wp0 = torch.clamp(p0 + dlt, 0, maxv)
    wq0 = torch.clamp(q0 - dlt, 0, maxv)
    dltp = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1,
                       -(tc4 >> 1), tc4 >> 1)
    wp1 = torch.clamp(p1 + dltp, 0, maxv)
    dltq = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1,
                       -(tc4 >> 1), tc4 >> 1)
    wq1 = torch.clamp(q1 + dltq, 0, maxv)

    st = strong[:, :, None, :] & filt[:, :, None, :]
    wk = (~strong[:, :, None, :]) & filt[:, :, None, :] & weak_on
    wkp1 = wk & dep1[:, :, None, :]
    wkq1 = wk & deq1[:, :, None, :]

    np0 = torch.where(st, sp0, torch.where(wk, wp0, p0))
    np1 = torch.where(st, sp1, torch.where(wkp1, wp1, p1))
    np2 = torch.where(st, sp2, p2)
    nq0 = torch.where(st, sq0, torch.where(wk, wq0, q0))
    nq1 = torch.where(st, sq1, torch.where(wkq1, wq1, q1))
    nq2 = torch.where(st, sq2, q2)

    out = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], dim=-1)
    out = out.reshape(b, h, e - 1, 8)
    blk = blk.clone()
    blk[:, :, :-1, 4:] = out[..., :4]
    blk[:, :, 1:, :4] = out[..., 4:]
    return blk.reshape(b, h, w)


def _chroma_vertical(plane: torch.Tensor, edge_rows: torch.Tensor,
                     qp_c, bit_depth: int = 8) -> torch.Tensor:
    """Filter all vertical chroma edges (8.7.2.5.5; bS = 2 edges only).
    plane [B, Hc, Wc]; edge_rows [B, Hc, Wc/8] per-chroma-row edge flags.
    qp_c: static int, or a per-edge chroma QP [B, Hc, Wc/8 - 1]."""
    b, h, w = plane.shape
    e = w // 8
    if isinstance(qp_c, (int, np.integer)):
        tc = int(TC_TABLE[min(max(qp_c + 2, 0), 53)]) << (bit_depth - 8)
        if tc == 0 or e < 2:
            return plane
    else:
        if e < 2:
            return plane
        tc_t = qp_tables(plane.device)[1]
        tc = tc_t[torch.clamp(qp_c + 2, 0, 53).long()] << (bit_depth - 8)
    maxv = (1 << bit_depth) - 1
    blk = plane.reshape(b, h, e, 8)
    pq = torch.cat([blk[:, :, :-1, 6:], blk[:, :, 1:, :2]], dim=-1)
    p1, p0, q0, q1 = (pq[..., i] for i in range(4))
    delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, maxv)
    nq0 = torch.clamp(q0 - delta, 0, maxv)
    filt = edge_rows[..., 1:]                           # [B, H, E-1]
    blk = blk.clone()
    blk[:, :, :-1, 7] = torch.where(filt, np0, p0)
    blk[:, :, 1:, 0] = torch.where(filt, nq0, q0)
    return blk.reshape(b, h, w)


def _chroma_edge_qp(qmap: torch.Tensor) -> torch.Tensor:
    """[B, S_y, S_x] luma slot QPs -> [B, Hc, Ec-1] chroma QP of every
    vertical chroma edge (the two sides averaged, then Table 8-10)."""
    ec = qmap.shape[-1] // 2                   # chroma 8-blocks per row
    qa = qmap[:, :, 1::2][:, :, :ec - 1]
    qb = qmap[:, :, 2::2][:, :, :ec - 1]
    qavg = (qa + qb + 1) >> 1
    qc = qp_tables(qmap.device)[2][torch.clamp(qavg, 0, 57).long()]
    return qc.repeat_interleave(4, dim=1)      # luma slot row = 4 chroma rows


def deblock_frame(y, u, v, tusz8, qp, h: int, w: int, bit_depth: int = 8):
    """Full-frame deblocking: vertical edges of all 3 planes, then the
    horizontal edges on the transposed result (spec filter order).

    y [B, HP, WP], u/v [B, HP/2, WP/2] (CTU-padded recon), tusz8
    [B, HP/8, WP/8] leaf TU log2 per slot. qp: static int, or a per-slot
    luma QP map [B, HP/8, WP/8] (cu_qp_delta: per-edge thresholds from
    the averaged side QPs, 8.7.2.5.3/8.7.2.5.5). Returns the filtered
    planes."""
    scalar_qp = isinstance(qp, (int, np.integer))

    def run(yy, uu, vv, d8, qmap, width):
        ey = tu_edge_mask(d8, width)
        # chroma edges: every 2nd luma slot column; one luma slot row is
        # 4 chroma rows
        ec_rows = ey[:, :, ::2].repeat_interleave(4, dim=1)
        qc = (rom.chroma_qp_from_luma(qmap) if scalar_qp
              else _chroma_edge_qp(qmap))
        return (_luma_vertical(yy, ey, qmap, bit_depth),
                _chroma_vertical(uu, ec_rows, qc, bit_depth),
                _chroma_vertical(vv, ec_rows, qc, bit_depth))

    qmap = int(qp) if scalar_qp else qp
    y, u, v = run(y, u, v, tusz8, qmap, w)
    yt, ut, vt = run(*(p.transpose(-1, -2).contiguous() for p in (y, u, v)),
                     tusz8.transpose(-1, -2),
                     qmap if scalar_qp else qmap.transpose(-1, -2), h)
    return tuple(p.transpose(-1, -2).contiguous() for p in (yt, ut, vt))
