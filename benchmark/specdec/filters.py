"""The in-loop filters of H.265 on an intra picture of 8 bits: the
deblocking filter (8.7.2; every edge intra, so bS is 2 on every
transform block edge of the 8x8 grid) and sample adaptive offset
(8.7.3); and the picture checksum of the decoded picture hash SEI
(D.3.19)."""

from __future__ import annotations

import numpy as np

from specdec import tables


def _edges(tu4: np.ndarray, step: int):
    """(row, column) in 4x4 units of the q side of each vertical edge
    segment of the luma grid of `step` samples: a transform block edge
    there, not the picture's left border."""
    cols = np.arange(step // 4, tu4.shape[1], step // 4)
    diff = tu4[:, cols - 1] != tu4[:, cols]
    r, c = np.nonzero(diff)
    return r, cols[c]


def _luma_vertical(rec, tu4, beta, tc):
    r4, c4 = _edges(tu4, 8)
    if not len(r4):
        return rec
    out = rec.copy()
    lines = r4[:, None] * 4 + np.arange(4)[None, :]        # [S, 4]
    x = c4[:, None, None] * 4
    k = np.arange(4)[None, None, :]
    p = rec[lines[:, :, None], x - 1 - k]                  # [S, line, i]
    q = rec[lines[:, :, None], x + k]
    p0, p1, p2, p3 = (p[..., i] for i in range(4))
    q0, q1, q2, q3 = (q[..., i] for i in range(4))
    dp = np.abs(p2 - 2 * p1 + p0)                           # [S, line]
    dq = np.abs(q2 - 2 * q1 + q0)
    dpq0, dpq3 = dp[:, 0] + dq[:, 0], dp[:, 3] + dq[:, 3]
    d = dpq0 + dpq3
    on = d < beta

    def sam(li, dpq):
        return ((2 * dpq < (beta >> 2))
                & (np.abs(p3[:, li] - p0[:, li])
                   + np.abs(q0[:, li] - q3[:, li]) < (beta >> 3))
                & (np.abs(p0[:, li] - q0[:, li]) < ((5 * tc + 1) >> 1)))

    strong = on & sam(0, dpq0) & sam(3, dpq3)
    side = (beta + (beta >> 1)) >> 3
    dep = on & (dp[:, 0] + dp[:, 3] < side)
    deq = on & (dq[:, 0] + dq[:, 3] < side)
    weak = on & ~strong

    t2 = 2 * tc
    sp0 = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - t2,
                  p0 + t2)
    sp1 = np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - t2, p1 + t2)
    sp2 = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - t2,
                  p2 + t2)
    sq0 = np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - t2,
                  q0 + t2)
    sq1 = np.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - t2, q1 + t2)
    sq2 = np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - t2,
                  q2 + t2)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    act = weak[:, None] & (np.abs(delta) < tc * 10)
    delta = np.clip(delta, -tc, tc)
    wp0 = np.clip(p0 + delta, 0, 255)
    wq0 = np.clip(q0 - delta, 0, 255)
    h = tc >> 1
    wp1 = np.clip(p1 + np.clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -h,
                               h), 0, 255)
    wq1 = np.clip(q1 + np.clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -h,
                               h), 0, 255)

    s = strong[:, None]
    np_ = [np.where(s, sp0, np.where(act, wp0, p0)),
           np.where(s, sp1, np.where(act & dep[:, None], wp1, p1)),
           np.where(s, sp2, p2)]
    nq = [np.where(s, sq0, np.where(act, wq0, q0)),
          np.where(s, sq1, np.where(act & deq[:, None], wq1, q1)),
          np.where(s, sq2, q2)]
    for i in range(3):
        out[lines, x[..., 0] - 1 - i] = np_[i]
        out[lines, x[..., 0] + i] = nq[i]
    return out


def _chroma_vertical(rec, tu4, tc):
    """Chroma edges on the 8x8 chroma grid (16 luma samples) where the
    luma grid has a transform block edge."""
    r4, c4 = _edges(tu4, 16)
    if not len(r4):
        return rec
    out = rec.copy()
    lines = r4[:, None] * 2 + np.arange(2)[None, :]        # 4 luma rows
    x = (c4 * 2)[:, None]                                   # chroma column
    p0, p1 = rec[lines, x - 1], rec[lines, x - 2]
    q0, q1 = rec[lines, x], rec[lines, x + 1]
    delta = np.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    out[lines, x - 1] = np.clip(p0 + delta, 0, 255)
    out[lines, x] = np.clip(q0 - delta, 0, 255)
    return out


def deblock(rec: list, tu4: np.ndarray, qp: int, cqp_offsets, beta_div2,
            tc_div2) -> list:
    """Deblocks the three planes of a picture of one slice QP: vertical
    edges of the whole picture, then horizontal edges."""
    beta = tables.BETA[min(max(qp + 2 * beta_div2, 0), 51)]
    tc = tables.TC[min(max(qp + 2 + 2 * tc_div2, 0), 53)]
    tcc = [tables.TC[min(max(tables.qp_chroma(qp + off) + 2 + 2 * tc_div2,
                             0), 53)] for off in cqp_offsets]
    y = _luma_vertical(rec[0], tu4, beta, tc)
    y = _luma_vertical(y.T, tu4.T, beta, tc).T
    out = [np.ascontiguousarray(y)]
    for c in (1, 2):
        p = _chroma_vertical(rec[c], tu4, tcc[c - 1])
        p = _chroma_vertical(p.T, tu4.T, tcc[c - 1]).T
        out.append(np.ascontiguousarray(p))
    return out


_EO = {0: ((0, -1), (0, 1)), 1: ((-1, 0), (1, 0)), 2: ((-1, -1), (1, 1)),
       3: ((-1, 1), (1, -1))}                               # (dy, dx) pairs


def sao(planes: list, ctb_log2: int, typ, off, bp, eo) -> list:
    """Sample adaptive offset of each CTB of each plane (8.7.3), reading
    the deblocked samples."""
    out = []
    for c, rec in enumerate(planes):
        res = rec.copy()
        size = (1 << ctb_log2) >> (1 if c else 0)
        ph, pw = rec.shape
        pad = np.pad(rec, 1, mode="edge")
        for ry in range(typ.shape[0]):
            for rx in range(typ.shape[1]):
                t = int(typ[ry, rx, c])
                if t == 0:
                    continue
                y0, x0 = ry * size, rx * size
                y1, x1 = min(y0 + size, ph), min(x0 + size, pw)
                blk = rec[y0:y1, x0:x1]
                vals = np.concatenate([[0], off[ry, rx, c]])
                if t == 1:
                    table = np.zeros(32, np.int64)
                    for k in range(4):
                        table[(k + int(bp[ry, rx, c])) & 31] = k + 1
                    idx = table[blk >> 3]
                else:
                    (ay, ax), (by, bx) = _EO[int(eo[ry, rx, c])]
                    a = pad[y0 + 1 + ay: y1 + 1 + ay, x0 + 1 + ax: x1 + 1 + ax]
                    b = pad[y0 + 1 + by: y1 + 1 + by, x0 + 1 + bx: x1 + 1 + bx]
                    e = 2 + np.sign(blk - a) + np.sign(blk - b)
                    idx = np.choose(e, [1, 2, 0, 3, 4])
                    yy = np.arange(y0, y1)[:, None]
                    xx = np.arange(x0, x1)[None, :]
                    outside = ((yy + min(ay, by) < 0) | (yy + max(ay, by) >= ph)
                               | (xx + min(ax, bx) < 0)
                               | (xx + max(ax, bx) >= pw))
                    idx = np.where(outside, 0, idx)
                res[y0:y1, x0:x1] = np.clip(blk + vals[idx], 0, 255)
        out.append(res)
    return out


def checksum(plane: np.ndarray) -> int:
    """picture_checksum of one 8-bit plane (D.3.19)."""
    h, w = plane.shape
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    mask = (x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)
    return int(((plane.astype(np.int64) & 0xFF) ^ mask).sum()) & 0xFFFFFFFF
