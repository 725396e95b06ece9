"""All-35-mode intra prediction as ONE static matmul per block size (port
of hevctpu/ops/intra_mm.py).

After reference fill and filtering, every HEVC intra mode is an exact
linear map of the reference vector refs = [top_ext, left_ext, top_f,
left_f, 1] followed by one rounding shift: the static integer tensor
P [4*(2N+1)+1, 35, N, N]. The nonlinear leftovers (the DC edge filter and
the VER/HOR edge columns, luma N < 32) are elementwise patches.

Exactness: refs are 0..255, P's weights are nonnegative with each
output's L1 <= 96, so every partial sum is an integer below 2^24 and a
float32 product (TF32 off) is exact in any summation order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import rom
from hevctpu_torch.ops import intra


@functools.lru_cache(maxsize=None)
def prediction_tensor(n: int, is_luma: bool):
    """Static (P, shift): P int32 [4*(2n+1)+1, 35, n, n] such that
    pred[m] = (refs @ P[:, m]) >> shift for all 35 modes (before the
    DC/VER/HOR edge patches)."""
    log2 = int(np.log2(n))
    ln = 2 * n + 1
    k = 4 * ln + 1
    shift = max(5, log2 + 1)
    ang_scale = 1 << (shift - 5)
    pdc_scale = 1 << (shift - (log2 + 1))
    use_f = (intra._filter_flags(n) if is_luma
             else np.zeros(35, dtype=bool))
    p = np.zeros((k, 35, n, n), dtype=np.int64)

    def slot(arr_id: int, i: int) -> int:
        # arr_id: 0 top_ext, 1 left_ext, 2 top_f, 3 left_f
        return arr_id * ln + i

    const = k - 1

    # planar (mode 0), H.265 8.4.4.2.4 on (possibly) filtered refs
    t_id, l_id = (2, 3) if use_f[rom.PLANAR_IDX] else (0, 1)
    for y in range(n):
        for x in range(n):
            p[slot(l_id, 1 + y), 0, y, x] += (n - 1 - x) * pdc_scale
            p[slot(t_id, n + 1), 0, y, x] += (x + 1) * pdc_scale
            p[slot(t_id, 1 + x), 0, y, x] += (n - 1 - y) * pdc_scale
            p[slot(l_id, n + 1), 0, y, x] += (y + 1) * pdc_scale
    p[const, 0] += n * pdc_scale

    # DC (mode 1): mean of the unfiltered N-extent refs
    for i in range(1, n + 1):
        p[slot(0, i), 1] += pdc_scale
        p[slot(1, i), 1] += pdc_scale
    p[const, 1] += n * pdc_scale

    # angular modes 2..34 (modes < 18 stored transposed into [y, x])
    src, idx, didx, fact = intra._angular_tables(n)
    for mi in range(33):
        mode = mi + 2
        t_id, l_id = (2, 3) if use_f[mode] else (0, 1)

        def ref_slot(i: int) -> int:
            a = t_id if src[mi, i] == 0 else l_id
            return slot(a, idx[mi, i])

        for r in range(n):
            f = int(fact[mi, r])
            for c in range(n):
                g = min(c + int(didx[mi, r]) + 1 + n, 3 * n + 1)
                g1 = min(g + 1, 3 * n + 1)
                oy, ox = (r, c) if mode >= 18 else (c, r)
                p[ref_slot(g), mode, oy, ox] += (32 - f) * ang_scale
                p[ref_slot(g1), mode, oy, ox] += f * ang_scale
        p[const, mode] += 16 * ang_scale

    assert p.max() <= 255 and p.sum(axis=0).max() <= 96
    return p.astype(np.int32), shift


@functools.lru_cache(maxsize=None)
def _pred_matrix_bf16(n: int, is_luma: bool):
    """(P reshaped [K, 35*n*n] float32, shift); every entry is bf16-exact
    (<= 255), the name kept from the JAX package."""
    p, shift = prediction_tensor(n, is_luma)
    return np.ascontiguousarray(
        p.reshape(p.shape[0], 35 * n * n)).astype(np.float32), shift


@functools.lru_cache(maxsize=None)
def pred_matrix(n: int, is_luma: bool, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """_pred_matrix_bf16's P as a tensor of `dtype` on `device`."""
    return torch.as_tensor(_pred_matrix_bf16(n, is_luma)[0], device=device
                           ).to(dtype).contiguous()


def pack_refs(top_ext, left_ext, top_f, left_f) -> torch.Tensor:
    """Four [..., 2n+1] reference arrays -> refs [..., 8n+5] =
    [top_ext | left_ext | top_f | left_f | 1]."""
    ones = torch.ones(top_ext.shape[:-1] + (1,), dtype=top_ext.dtype,
                      device=top_ext.device)
    return torch.cat([top_ext, left_ext, top_f, left_f, ones], dim=-1)


def predict_all_modes_mm(top_ext, left_ext, top_f, left_f, n: int, *,
                         is_luma: bool = True, bit_depth: int = 8):
    """All 35 intra predictions as one matmul. ext arrays [..., 2n+1]
    int32; out [..., 35, n, n] int32."""
    _, shift = _pred_matrix_bf16(n, is_luma)
    lead = top_ext.shape[:-1]
    refs = pack_refs(top_ext, left_ext, top_f, left_f).to(torch.float32)
    acc = refs @ pred_matrix(n, is_luma, torch.float32, refs.device)
    pred = (acc.to(torch.int32) >> shift).reshape(lead + (35, n, n))

    if is_luma and n < 32:
        maxv = (1 << bit_depth) - 1
        corner = top_ext[..., 0:1]
        # VER (26): pred[y][0] gets the left-gradient correction.
        pred[..., rom.VER_IDX, :, 0] = torch.clamp(
            top_ext[..., 1:2] + ((left_ext[..., 1: n + 1] - corner) >> 1),
            0, maxv)
        # HOR (10): transposed family, the corrected column lands on row 0.
        pred[..., rom.HOR_IDX, 0, :] = torch.clamp(
            left_ext[..., 1:2] + ((top_ext[..., 1: n + 1] - corner) >> 1),
            0, maxv)
        # DC edge filter ([1 3]/4 on row 0 / col 0, [1 2 1]/4 corner).
        dc = pred[..., rom.DC_IDX, n - 1, n - 1].clone()
        t_u = top_ext[..., 1: n + 1]
        l_u = left_ext[..., 1: n + 1]
        pred[..., rom.DC_IDX, 0, :] = (t_u + 3 * dc[..., None] + 2) >> 2
        pred[..., rom.DC_IDX, 1:, 0] = (l_u[..., 1:] + 3 * dc[..., None]
                                        + 2) >> 2
        pred[..., rom.DC_IDX, 0, 0] = (l_u[..., 0] + 2 * dc + t_u[..., 0]
                                       + 2) >> 2
    return pred


def predict_selected_mode_mm(top_ext, left_ext, top_f, left_f, mode, n: int,
                             *, is_luma: bool = True, bit_depth: int = 8):
    """Predict one mode per batch row: all-35 matmul + select.
    ext arrays [..., 2n+1], mode [...] int; out [..., n, n]."""
    pred_all = predict_all_modes_mm(top_ext, left_ext, top_f, left_f, n,
                                    is_luma=is_luma, bit_depth=bit_depth)
    idx = mode.long()[..., None, None, None].expand(
        mode.shape + (1, n, n))
    return torch.gather(pred_all, -3, idx)[..., 0, :, :]


def grid_boundaries(plane: torch.Tensor, n: int) -> torch.Tensor:
    """Scan-order boundaries [B, R, C, 4n+1] for every aligned n x n block
    of plane [B, HP, WP] (left bottom-to-top, corner, top left-to-right).
    Out-of-plane reads clamp to the edge; those positions are always
    masked unavailable."""
    b, hp, wp = plane.shape
    r, c = hp // n, wp // n

    # rows y = r*n - 1 (clamped), columns x = c*n - 1 (clamped)
    rows = torch.cat([plane[:, :1, :], plane[:, n - 1:: n, :]], dim=1)[:, :r]
    cols = torch.cat([plane[:, :, :1], plane[:, :, n - 1:: n]],
                     dim=2)[:, :, :c]

    # top windows [c*n-1, c*n+2n-1] from `rows`, via 3 block slices
    rowp = torch.cat([rows[:, :, :1], rows,
                      rows[:, :, -1:].expand(b, r, 2 * n)], dim=2)
    blk = rowp[:, :, : (c + 2) * n].reshape(b, r, c + 2, n)
    top = torch.cat([blk[:, :, :c, :], blk[:, :, 1: c + 1, :],
                     blk[:, :, 2: c + 2, :1]], dim=-1)    # [B, R, C, 2n+1]
    corner = top[:, :, :, 0]

    # left windows [r*n, r*n+2n) from `cols`, below-extension clamped
    colp = torch.cat([cols, cols[:, -1:, :].expand(b, n, c)], dim=1)
    cblk = colp.reshape(b, r + 1, n, c)
    left = torch.cat([cblk[:, :r], cblk[:, 1: r + 1]], dim=2)
    left = left.movedim(-1, 2)                              # [B, R, C, 2n]

    return torch.cat([left.flip(-1), corner[..., None], top[..., 1:]],
                     dim=-1)
