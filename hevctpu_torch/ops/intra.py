"""HEVC intra reference samples: availability fill, split and smoothing,
the static angular tables, and the direct (gather) form of all-35-mode
prediction (port of hevctpu/ops/intra.py). The encoder predicts with
ops/intra_mm.py's single matmul; predict_all_modes and predict_one_mode
here follow H.265 8.4.4.2 term by term and are the oracle that the matmul
form, and through it K1's tap table, is held against.

Conventions:
  * ``top_ext``  [..., 2N+1]: index 0 is the corner p[-1][-1], index 1+x is
    p[x][-1] for x in [0, 2N).
  * ``left_ext`` [..., 2N+1]: index 0 is the corner, index 1+y is p[-1][y].
  * Predictions are [..., N, N] indexed [y, x].
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


# ---------------------------------------------------------------------------
# Prediction (gather form)
# ---------------------------------------------------------------------------


def _angular_all(top: torch.Tensor, left: torch.Tensor, n: int):
    """All 33 angular modes, generic orientation. Inputs [..., 33, 2n+1]
    already per-mode-selected (filtered or not). Output [..., 33, n, n]
    where modes >= 18 are [y, x] and modes < 18 are [x, y] (the caller
    transposes)."""
    src, idx, didx, fact = _angular_tables(n)
    dev = top.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    idxt = t(idx).long().expand(top.shape[:-1] + (idx.shape[-1],))
    refline = torch.where(t(src) == 0, torch.gather(top, -1, idxt),
                          torch.gather(left, -1, idxt))   # [..., 33, 3n+2]
    gidx = np.minimum(np.arange(n)[None, None, :] + didx[:, :, None]
                      + 1 + n, 3 * n + 1)                 # [33, n, n]
    m_ix = torch.arange(33, device=dev)[:, None, None].expand(33, n, n)
    a = refline[..., m_ix, t(gidx)]
    b = refline[..., m_ix, t(np.minimum(gidx + 1, 3 * n + 1))]
    f = t(fact)[:, :, None]
    return ((32 - f) * a + f * b + 16) >> 5


def _planar_dc(top_ext, left_ext, top_f, left_f, n: int, is_luma: bool,
               use_f: np.ndarray):
    """(planar, DC) predictions [..., n, n]: planar on the filtered refs
    when the mode-0 flag says so, DC on the unfiltered ones with the
    [1 3]/4 edge and [1 2 1]/4 corner filters for luma n < 32."""
    log2 = int(np.log2(n))
    tp = top_f if use_f[rom.PLANAR_IDX] else top_ext
    lp = left_f if use_f[rom.PLANAR_IDX] else left_ext
    xs = torch.arange(n, dtype=torch.int32, device=top_ext.device)
    t_row = tp[..., 1: n + 1][..., None, :]          # [..., 1, n]
    l_col = lp[..., 1: n + 1][..., :, None]          # [..., n, 1]
    tr = tp[..., n + 1: n + 2][..., None, :]         # p[n][-1]
    bl = lp[..., n + 1: n + 2][..., :, None]         # p[-1][n]
    planar = ((n - 1 - xs)[None, :] * l_col + (xs + 1)[None, :] * tr
              + (n - 1 - xs)[:, None] * t_row + (xs + 1)[:, None] * bl
              + n) >> (log2 + 1)

    dc = (top_ext[..., 1: n + 1].sum(-1) + left_ext[..., 1: n + 1].sum(-1)
          + n) >> (log2 + 1)
    dc_blk = dc[..., None, None].expand(planar.shape).clone()
    if is_luma and n < 32:
        t_u = top_ext[..., 1: n + 1]
        l_u = left_ext[..., 1: n + 1]
        dc_blk[..., 0, :] = (t_u + 3 * dc[..., None] + 2) >> 2
        dc_blk[..., 1:, 0] = (l_u[..., 1:] + 3 * dc[..., None] + 2) >> 2
        dc_blk[..., 0, 0] = (l_u[..., 0] + 2 * dc + t_u[..., 0] + 2) >> 2
    return planar.to(top_ext.dtype), dc_blk.to(top_ext.dtype)


def predict_all_modes(top_ext: torch.Tensor, left_ext: torch.Tensor,
                      top_f: torch.Tensor, left_f: torch.Tensor, n: int, *,
                      is_luma: bool = True,
                      bit_depth: int = 8) -> torch.Tensor:
    """Predict all 35 intra modes. ext arrays [..., 2n+1] int; out
    [..., 35, n, n]. Chroma never filters references (4:2:0) and skips
    the DC/edge boundary filters (H.265 8.4.4.2)."""
    maxv = (1 << bit_depth) - 1
    use_f = _filter_flags(n) if is_luma else np.zeros(35, dtype=bool)
    sel = torch.as_tensor(use_f[2:], device=top_ext.device)[:, None]
    topm = torch.where(sel, top_f[..., None, :], top_ext[..., None, :])
    leftm = torch.where(sel, left_f[..., None, :], left_ext[..., None, :])
    ang = _angular_all(topm, leftm, n)                # [..., 33, n, n]

    # Edge filters of exactly horizontal / vertical (luma, n < 32): in
    # the generic orientation both filter column 0 against the side refs.
    if is_luma and n < 32:
        corner = top_ext[..., 0:1]
        for mode, main, side in ((rom.VER_IDX, top_ext, left_ext),
                                 (rom.HOR_IDX, left_ext, top_ext)):
            ang[..., mode - 2, :, 0] = torch.clamp(
                main[..., 1:2] + ((side[..., 1: n + 1] - corner) >> 1),
                0, maxv)

    # The horizontal family (modes 2..17) back to [y, x].
    ang = torch.cat([ang[..., :16, :, :].transpose(-1, -2),
                     ang[..., 16:, :, :]], dim=-3)
    planar, dc = _planar_dc(top_ext, left_ext, top_f, left_f, n, is_luma,
                            use_f)
    return torch.cat([planar[..., None, :, :], dc[..., None, :, :],
                      ang.to(top_ext.dtype)], dim=-3)


def predict_one_mode(top_ext, left_ext, top_f, left_f, mode, n, *,
                     is_luma=True, bit_depth=8):
    """Predict one mode per batch element: ext arrays [..., 2n+1], mode
    [...] int in [0, 34]; out [..., n, n]. Planar, DC and the element's
    one angular mode, its gather tables indexed by the mode."""
    maxv = (1 << bit_depth) - 1
    dev = top_ext.device
    use_f_tab = _filter_flags(n) if is_luma else np.zeros(35, dtype=bool)
    mode = torch.as_tensor(mode, device=dev).long()
    use_f = torch.as_tensor(use_f_tab, device=dev)[mode][..., None]
    top_in = torch.where(use_f, top_f, top_ext)
    left_in = torch.where(use_f, left_f, left_ext)

    src, idx, didx, fact = (torch.as_tensor(a, device=dev)
                            for a in _angular_tables(n))
    mi = torch.clamp(mode - 2, 0, 32)
    idx_r = idx[mi].long()                                    # [..., 3n+2]
    refline = torch.where(src[mi] == 0, torch.gather(top_in, -1, idx_r),
                          torch.gather(left_in, -1, idx_r))
    cols = torch.arange(n, device=dev)
    gidx = torch.clamp_max(didx[mi][..., :, None] + cols + 1 + n,
                           3 * n + 1).long()                  # [..., n, n]
    flat = gidx.flatten(-2)
    a = torch.gather(refline, -1, flat).reshape(gidx.shape)
    b = torch.gather(refline, -1, torch.clamp_max(flat + 1, 3 * n + 1)
                     ).reshape(gidx.shape)
    f = fact[mi][..., :, None]
    ang = ((32 - f) * a + f * b + 16) >> 5

    if is_luma and n < 32:
        corner = top_ext[..., 0:1]
        is_ver = (mode == rom.VER_IDX)[..., None]
        is_hor = (mode == rom.HOR_IDX)[..., None]
        main = torch.where(is_ver, top_ext[..., 1:2], left_ext[..., 1:2])
        side = torch.where(is_ver, left_ext[..., 1: n + 1],
                           top_ext[..., 1: n + 1])
        col = torch.clamp(main + ((side - corner) >> 1), 0, maxv)
        edge = ang.clone()
        edge[..., :, 0] = col
        ang = torch.where((is_ver | is_hor)[..., None], edge, ang)
    ang = torch.where((mode < 18)[..., None, None], ang.transpose(-1, -2),
                      ang)

    planar, dc = _planar_dc(top_ext, left_ext, top_f, left_f, n, is_luma,
                            use_f_tab)
    mode_b = mode[..., None, None]
    return torch.where(mode_b == rom.PLANAR_IDX, planar,
                       torch.where(mode_b == rom.DC_IDX, dc,
                                   ang.to(top_ext.dtype)))
