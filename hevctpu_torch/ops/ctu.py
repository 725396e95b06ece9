"""CTU partition derivation and static z-order/availability tables (port
of hevctpu/ops/ctu.py).

The CNN's per-16x16 depth labels determine the CU quadtree (the
reference's 3-way pruning gate, TEncCu.cpp:496-520), materialized with
HEVC's implicit picture-boundary splits over an 8x8 grid of 8x8-pel
"slots" per CTU. depth in {0,1,2,3} -> CU size {64,32,16,8}; "coded"
means the slot lies inside the picture.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import device_table

_SY, _SX = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
_BLK16 = (_SY // 2) * 4 + (_SX // 2)                       # [8,8] -> 0..15
_QLEADER = ((_SY // 4) * 2) * 4 + ((_SX // 4) * 2)         # quadrant leader


@functools.lru_cache(maxsize=None)
def _slot_tables(device: torch.device):
    t = functools.partial(torch.as_tensor, device=device)
    return (t(_BLK16.ravel(), dtype=torch.int64),
            t(_QLEADER.ravel(), dtype=torch.int64),
            t(_SY, dtype=torch.int32), t(_SX, dtype=torch.int32))


def derive_slot_depths(labels: torch.Tensor, bh: torch.Tensor,
                       bw: torch.Tensor):
    """labels [..., 16] (legal), bh/bw [...] = CTU rows/cols inside the
    picture (1..64). Returns (depth8 int32, coded8 bool), both [..., 8, 8]:
    label-derived CU depth max'd with the implicit boundary splits, and
    whether the slot is inside the picture."""
    blk16, qlead, sy, sx = _slot_tables(labels.device)
    lead = labels.shape[:-1]
    lab_blk = labels[..., blk16].reshape(lead + (8, 8))
    lab_q = labels[..., qlead].reshape(lead + (8, 8))
    lab0 = labels[..., 0:1, None]

    d_lab = torch.where(lab_blk == 2, 2, 3)
    d_lab = torch.where(lab_q == 1, 1, d_lab)
    d_lab = torch.where(lab0 == 0, 0, d_lab)

    bh = bh[..., None, None]
    bw = bw[..., None, None]
    d_bnd = torch.where((bh < 64) | (bw < 64), 1, 0)
    cross32 = ((sy // 4) * 32 + 32 > bh) | ((sx // 4) * 32 + 32 > bw)
    d_bnd = torch.where(cross32, 2, d_bnd)
    cross16 = ((sy // 2) * 16 + 16 > bh) | ((sx // 2) * 16 + 16 > bw)
    d_bnd = torch.where(cross16, 3, d_bnd)

    coded = (sy * 8 < bh) & (sx * 8 < bw)
    depth = torch.maximum(d_lab, d_bnd).to(torch.int32)
    return depth, coded.expand(depth.shape)


@functools.lru_cache(maxsize=None)
def morton(n: int) -> np.ndarray:
    """[n, n] z-scan index of each (y, x) cell."""
    out = np.zeros((n, n), dtype=np.int32)
    for y in range(n):
        for x in range(n):
            z = 0
            for b in range(n.bit_length()):
                z |= ((x >> b) & 1) << (2 * b)
                z |= ((y >> b) & 1) << (2 * b + 1)
            out[y, x] = z
    return out


@functools.lru_cache(maxsize=None)
def boundary_offsets(n: int):
    """Static scan-order boundary sample offsets (dy, dx), length 4n+1,
    relative to a TU origin: left column bottom-to-top, corner, top row
    left-to-right (intra.fill_reference's order)."""
    dy = np.concatenate([np.arange(2 * n - 1, -1, -1), [-1],
                         np.full(2 * n, -1)]).astype(np.int32)
    dx = np.concatenate([np.full(2 * n, -1), [-1],
                         np.arange(0, 2 * n)]).astype(np.int32)
    return dy, dx


def boundary_available(oy, ox, n: int, z_tu, ctu_y, ctu_x, h: int, w: int,
                       scale: int = 1) -> np.ndarray:
    """Availability mask [..., 4n+1] (numpy) for TUs at CTU-local origins
    (oy, ox), size n, z-index z_tu (4x4 units), in CTUs at picture origins
    (ctu_y, ctu_x) of the component's grid (span 64/scale): inside the
    picture AND decoded before the TU (z-order within the CTU; left /
    above / above-right CTUs in wavefront order)."""
    span = 64 // scale
    dy, dx = boundary_offsets(n)
    oy, ox, z_tu = np.asarray(oy), np.asarray(ox), np.asarray(z_tu)
    ly = oy[..., None] + dy
    lx = ox[..., None] + dx
    fy = np.asarray(ctu_y)[..., None] + ly
    fx = np.asarray(ctu_x)[..., None] + lx
    inside = (fy >= 0) & (fx >= 0) & (fy < h) & (fx < w)

    same_ctu = (ly >= 0) & (lx >= 0) & (ly < span) & (lx < span)
    zmap = morton(span // 4)
    zb = zmap[np.clip(ly, 0, span - 1) // 4, np.clip(lx, 0, span - 1) // 4]
    decoded_same = zb < z_tu[..., None]
    above = ly < 0
    left_of = (lx < 0) & (ly >= 0) & (ly < span)
    decoded = np.where(same_ctu, decoded_same, above | left_of)
    return inside & decoded


@functools.lru_cache(maxsize=None)
def tu_schedule():
    """The static per-CTU TU schedule: 84 steps (size, origin_y, origin_x,
    z of the origin in 4x4 units) in z-order: per 32-quadrant a 32-step,
    per 16-block inside it a 16-step, per 8-slot inside that an 8-step. A
    step fires where the partition says a TU of its size starts there
    (masks decided on the device)."""
    steps = []
    z16 = morton(16)
    for q in range(4):
        qy, qx = (q // 2) * 32, (q % 2) * 32
        steps.append((32, qy, qx, int(z16[qy // 4, qx // 4])))
        for t in range(4):
            ty, tx = qy + (t // 2) * 16, qx + (t % 2) * 16
            steps.append((16, ty, tx, int(z16[ty // 4, tx // 4])))
            for e in range(4):
                ey, ex = ty + (e // 2) * 8, tx + (e % 2) * 8
                steps.append((8, ey, ex, int(z16[ey // 4, ex // 4])))
    return steps


def tu_size_for_slot(depth8: torch.Tensor) -> torch.Tensor:
    """Per-slot luma TU size log2: the CU size clamped to the 32 max TU."""
    return torch.clamp_max(6 - depth8, 5)


@functools.lru_cache(maxsize=None)
def _morton_t(n: int, device: torch.device) -> torch.Tensor:
    return device_table(morton(n), device, torch.int64)


@functools.lru_cache(maxsize=None)
def _offsets_t(n: int, device: torch.device):
    return tuple(device_table(o, device, torch.int64)
                 for o in boundary_offsets(n))


def boundary_available_traced(oy, ox, n: int, ctu_y, ctu_x, h: int, w: int,
                              scale: int = 1) -> torch.Tensor:
    """boundary_available with the TU origin (oy, ox) held in integer
    tensors (broadcast against ctu_y/ctu_x [...]): the TU's z-index comes
    from the Morton table, kept on the origin's device. Returns the
    availability [..., 4n+1]."""
    span = 64 // scale
    oy, ox = torch.as_tensor(oy), torch.as_tensor(ox)
    dev = oy.device
    dy, dx = _offsets_t(n, dev)
    ly = oy[..., None] + dy
    lx = ox[..., None] + dx
    fy = torch.as_tensor(ctu_y, device=dev)[..., None] + ly
    fx = torch.as_tensor(ctu_x, device=dev)[..., None] + lx
    inside = (fy >= 0) & (fx >= 0) & (fy < h) & (fx < w)

    same_ctu = (ly >= 0) & (lx >= 0) & (ly < span) & (lx < span)
    zmap = _morton_t(span // 4, dev)
    zb = zmap[torch.clamp(ly, 0, span - 1) // 4,
              torch.clamp(lx, 0, span - 1) // 4]
    z_tu = torch.take(zmap, oy // 4 * (span // 4) + ox // 4)[..., None]
    above = ly < 0
    left_of = (lx < 0) & (ly >= 0) & (ly < span)
    decoded = torch.where(same_ctu, zb < z_tu, above | left_of)
    return inside & decoded
