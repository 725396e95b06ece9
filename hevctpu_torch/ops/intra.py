"""HEVC intra reference samples: availability fill, split and smoothing,
plus the static angular tables (port of hevctpu/ops/intra.py; prediction
itself is ops/intra_mm.py's single matmul).

Conventions:
  * ``top_ext``  [..., 2N+1]: index 0 is the corner p[-1][-1], index 1+x is
    p[x][-1] for x in [0, 2N).
  * ``left_ext`` [..., 2N+1]: index 0 is the corner, index 1+y is p[-1][y].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import rom


@functools.lru_cache(maxsize=None)
def _angular_tables(n: int):
    """Static gather tables for the 33 angular modes at size n (numpy):
    src [33, 3n+2] (0 top_ext, 1 left_ext), idx [33, 3n+2] index into the
    chosen ext array, didx [33, n] integer offset ((r+1)*angle)>>5, fact
    [33, n] fractional weight ((r+1)*angle)&31. Slot i holds ref[i - n]."""
    ln = 3 * n + 2
    src = np.zeros((33, ln), dtype=np.int32)
    idx = np.zeros((33, ln), dtype=np.int32)
    didx = np.zeros((33, n), dtype=np.int32)
    fact = np.zeros((33, n), dtype=np.int32)
    for mi, mode in enumerate(range(2, 35)):
        angle = int(rom.INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18
        main, side = (0, 1) if vertical else (1, 0)
        for i in range(ln):
            x = i - n
            if x >= 0:
                src[mi, i] = main
                idx[mi, i] = min(x, 2 * n)
            else:
                src[mi, i] = side
                if angle < 0:
                    inv = (int(rom.INTRA_INV_ANGLE[mode - 11])
                           if 11 <= mode <= 25 else 0)
                    j = (x * inv + 128) >> 8
                    idx[mi, i] = min(max(j, 0), 2 * n)
                else:
                    idx[mi, i] = 0  # unused
        for r in range(n):
            didx[mi, r] = ((r + 1) * angle) >> 5
            fact[mi, r] = ((r + 1) * angle) & 31
    return src, idx, didx, fact


@functools.lru_cache(maxsize=None)
def _filter_flags(n: int) -> np.ndarray:
    """use-filtered-reference flag per mode [35] (luma; H.265 8.4.4.2.3)."""
    flags = np.zeros(35, dtype=bool)
    if n < 8:
        return flags
    thresh = rom.INTRA_FILTER_THRES[int(np.log2(n))]
    for mode in range(35):
        if mode == rom.DC_IDX:
            continue
        if mode == rom.PLANAR_IDX:
            flags[mode] = True
            continue
        min_dist = min(abs(mode - rom.HOR_IDX), abs(mode - rom.VER_IDX))
        flags[mode] = min_dist > thresh
    return flags


def fill_reference(boundary: torch.Tensor, avail: torch.Tensor,
                   bit_depth: int = 8) -> torch.Tensor:
    """Availability substitution over the boundary scan (H.265 8.4.4.2.2).

    ``boundary`` [..., 4N+1] in scan order (left column bottom-to-top,
    corner, top row left-to-right); ``avail`` a bool mask broadcastable to
    it. Unavailable samples take the previous available one in scan order;
    leading unavailable ones the first available; none available -> all
    1 << (bit_depth - 1)."""
    avail = avail.expand(boundary.shape)
    ln = boundary.shape[-1]
    pos = torch.arange(ln, dtype=torch.int32, device=boundary.device)
    marked = torch.where(avail, pos, -1)
    fill_idx = torch.cummax(marked, dim=-1).values
    first = avail.to(torch.uint8).argmax(dim=-1, keepdim=True)
    fill_idx = torch.where(fill_idx < 0, first.to(torch.int32), fill_idx)
    out = torch.gather(boundary, -1, fill_idx.long())
    any_avail = avail.any(dim=-1, keepdim=True)
    return torch.where(any_avail, out, 1 << (bit_depth - 1))


def split_boundary(boundary: torch.Tensor, n: int):
    """Scan-order boundary [..., 4n+1] -> (top_ext, left_ext) [..., 2n+1]."""
    left = boundary[..., : 2 * n].flip(-1)  # p[-1][0] ... p[-1][2n-1]
    corner = boundary[..., 2 * n: 2 * n + 1]
    top = boundary[..., 2 * n + 1:]
    return torch.cat([corner, top], dim=-1), torch.cat([corner, left], dim=-1)


def smooth_reference(top_ext: torch.Tensor, left_ext: torch.Tensor, n: int,
                     *, bit_depth: int = 8):
    """[1 2 1] smoothing of the reference arrays; at 32x32 the bilinear
    strong filter (strong_intra_smoothing, always on in this encoder)
    replaces it when both boundaries are flat (8.4.4.2.3)."""
    corner = top_ext[..., 0:1]
    c = (left_ext[..., 1:2] + 2 * corner + top_ext[..., 1:2] + 2) >> 2

    def f121(ext):
        mid = (ext[..., :-2] + 2 * ext[..., 1:-1] + ext[..., 2:] + 2) >> 2
        return torch.cat([c, mid, ext[..., -1:]], dim=-1)

    top_f = f121(top_ext)
    left_f = f121(left_ext)

    if n == 32:
        thr = 1 << (bit_depth - 5)
        flat_t = (corner + top_ext[..., 2 * n: 2 * n + 1]
                  - 2 * top_ext[..., n: n + 1]).abs() < thr
        flat_l = (corner + left_ext[..., 2 * n: 2 * n + 1]
                  - 2 * left_ext[..., n: n + 1]).abs() < thr
        use_strong = flat_t & flat_l
        i = torch.arange(2 * n + 1, dtype=torch.int32, device=top_ext.device)

        def bilinear(ext):
            end = ext[..., 2 * n: 2 * n + 1]
            s = ((64 - i) * corner + i * end + 32) >> 6
            return torch.cat([s[..., : 2 * n], end], dim=-1)

        top_f = torch.where(use_strong, bilinear(top_ext), top_f)
        left_f = torch.where(use_strong, bilinear(left_ext), left_f)
    return top_f, left_f
