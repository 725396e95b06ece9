"""Vectorized rate estimation: λ and approximate CABAC bit counts (port of
hevctpu/ops/rate.py, the global per-bin-type weight model).

A stateless, data-parallel estimate of the reference's counting-CABAC
trials (TEncBinCABACCounter): static weights per bin type instead of
evolving context states. Bit costs are fixed point (1/BITS_ONE bit units,
int32).

Two floating-point floors of the JAX package are integer forms here, so
that no device's log2 rounding can move a Rice bound:
floor(log2(1 + s/8)) == bit_length(8 + s) - 4 and
floor(log2(big + 0.5)) == bit_length(big) - 1 (big >= 1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import rom

BITS_ONE = 256  # fixed-point scale: 256 == one bit

W_SIG0 = int(0.35 * BITS_ONE)       # sig_coeff_flag = 0
W_SIG1 = int(0.95 * BITS_ONE)       # sig_coeff_flag = 1
W_GT1_0 = int(0.55 * BITS_ONE)      # coeff_abs_level_greater1 = 0
W_GT1_1 = int(1.25 * BITS_ONE)      # coeff_abs_level_greater1 = 1
W_GT2_0 = int(0.60 * BITS_ONE)      # coeff_abs_level_greater2 = 0
W_GT2_1 = int(1.05 * BITS_ONE)      # coeff_abs_level_greater2 = 1
W_CSBF = int(0.80 * BITS_ONE)       # coded_sub_block_flag
W_LAST = int(0.80 * BITS_ONE)       # last_sig prefix ctx bin
W_CBF1 = int(0.80 * BITS_ONE)       # cbf = 1
W_CBF0 = int(0.50 * BITS_ONE)       # cbf = 0
W_SIGN = BITS_ONE                   # sign bypass

_W_FIELDS = ("sig0", "sig1", "gt1_0", "gt1_1", "gt2_0", "gt2_1",
             "csbf", "last", "cbf1", "cbf0")
_W_DEFAULT = {"sig0": W_SIG0, "sig1": W_SIG1, "gt1_0": W_GT1_0,
              "gt1_1": W_GT1_1, "gt2_0": W_GT2_0, "gt2_1": W_GT2_1,
              "csbf": W_CSBF, "last": W_LAST, "cbf1": W_CBF1,
              "cbf0": W_CBF0}


@functools.lru_cache(maxsize=None)
def bin_weights(qp: int | None) -> dict:
    """Per-bin-type weights for a static QP: the fitted table entry of the
    nearest fitted QP, else the hand-calibrated defaults."""
    if qp is None:
        return _W_DEFAULT
    from hevctpu_torch.ops.rate_weights import FITTED
    near = min(sorted(FITTED), key=lambda q: abs(q - qp))
    return dict(zip(_W_FIELDS, FITTED[near]))


def lambda_rd(qp: int) -> float:
    """HM's All-Intra I-slice λ = 0.57 · 2^((QP-12)/3)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def lambda_per_unit(qp: int) -> float:
    """λ in distortion per 1/BITS_ONE bit: an estimate_tu_bits() result
    times this is comparable with a distortion."""
    return lambda_rd(qp) / BITS_ONE


def chroma_dist_weight(qp: int, qp_c: int) -> float:
    """HM's chroma SSE weight 2^((QP-QPc)/3)."""
    return 2.0 ** ((qp - qp_c) / 3.0)


# ---------------------------------------------------------------------------
# Static per-size tables
# ---------------------------------------------------------------------------


def _group_min(group: int) -> int:
    if group < 2:
        return group
    return (2 + (group & 1)) << ((group >> 1) - 1)


@functools.lru_cache(maxsize=None)
def _last_pos_counts(n: int) -> np.ndarray:
    """(prefix ctx bins, suffix bypass bits) of coding one axis of the
    last-sig position (9.3.3.8: ctx-coded prefix + bypass suffix) per
    position, [n, 2]."""
    out = np.zeros((n, 2), dtype=np.int64)
    g = 4 if n == 4 else (6 if n == 8 else (8 if n == 16 else 10))
    for pos in range(n):
        group = 0
        while group + 1 < g and pos >= _group_min(group + 1):
            group += 1
        out[pos] = (min(group + 1, g), max(0, (group >> 1) - 1))
    return out


@functools.lru_cache(maxsize=None)
def _last_pos_bits(n: int, w_last: int = W_LAST) -> np.ndarray:
    """Approximate bits of coding one axis of the last-sig position, [n]
    in 1/BITS_ONE units."""
    c = _last_pos_counts(n)
    return c[:, 0] * w_last + c[:, 1] * BITS_ONE


@functools.lru_cache(maxsize=None)
def _scan_pos(n: int) -> np.ndarray:
    """[n, n] scan position (diag CG-composed scan) of each (y, x)."""
    log2 = int(np.log2(n))
    scan = (rom.tb_scan(rom.SCAN_DIAG, log2) if n >= 4
            else rom.scan_order(rom.SCAN_DIAG, n))
    pos = np.zeros((n, n), dtype=np.int32)
    for i, (y, x) in enumerate(scan):
        pos[y, x] = i
    return pos


@functools.lru_cache(maxsize=None)
def _tables(n: int, w_last: int, device: torch.device):
    """(pos [n,n], order [n*n] scan pos -> flat, last-bits [n],
    cg pos [n/4,n/4] or None) as int32 tensors on `device`."""
    pos = _scan_pos(n)
    order = np.zeros(n * n, np.int32)
    order[pos.reshape(-1)] = np.arange(n * n, dtype=np.int32)
    t = functools.partial(torch.as_tensor, dtype=torch.int32, device=device)
    cg_pos = t(_scan_pos(n // 4)) if n > 4 else None
    return t(pos), t(order), t(_last_pos_bits(n, w_last)), cg_pos


# ---------------------------------------------------------------------------
# Bit estimates
# ---------------------------------------------------------------------------


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Number of bits of each nonnegative integer (0 for 0), int32. Exact:
    frexp of a float64 holding an integer below 2^53."""
    return torch.frexp(x.to(torch.float64))[1].to(torch.int32)


def rice_param(cg_sum: torch.Tensor) -> torch.Tensor:
    """Per-CG Rice parameter clip(floor(log2(1 + cg_sum/8)), 0, 4), in
    integers: bit_length(8 + cg_sum) - 4."""
    return torch.clamp(bit_length(cg_sum + 8) - 4, 0, 4)


def golomb_rice_bits(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact coeff_abs_level_remaining length in whole bits (9.3.3.9).
    v, k int32 (k in [0, 4])."""
    small = (v >> k) < 3
    bits_small = (v >> k) + 1 + k
    u = torch.clamp_min(v - (3 << k), 0)
    big = torch.clamp_min(u + (1 << k), 1)
    lvl = bit_length(big) - 1          # floor(log2(big + 0.5))
    bits_big = 4 + 2 * lvl - k
    return torch.where(small, bits_small, bits_big)


def level_bits(absl: torch.Tensor, k: torch.Tensor,
               w: dict | None = None) -> torch.Tensor:
    """Approximate bits (1/BITS_ONE units) to code one coefficient of
    |level| = absl with Rice parameter k: the sig/gt1/gt2/remaining/sign
    ladder (7.3.8.11)."""
    w = w or _W_DEFAULT
    zero = torch.zeros_like(absl)
    b0 = torch.where(absl > 0, w["sig1"], w["sig0"])
    b1 = torch.where(absl > 1, w["gt1_1"],
                     torch.where(absl == 1, w["gt1_0"], zero))
    b2 = torch.where(absl > 2, w["gt2_1"],
                     torch.where(absl == 2, w["gt2_0"], zero))
    rem = golomb_rice_bits(torch.clamp_min(absl - 3, 0), k) * BITS_ONE
    b3 = torch.where(absl > 2, rem, zero)
    sign = torch.where(absl > 0, W_SIGN, zero)
    return (b0 + b1 + b2 + b3 + sign).to(torch.int32)


def _repeat4(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)


def cg_sums(x: torch.Tensor) -> torch.Tensor:
    """[..., N, N] int -> [..., N/4, N/4] int32 sums per 4x4 group."""
    n = x.shape[-1]
    return x.reshape(*x.shape[:-2], n // 4, 4, n // 4, 4).sum(
        dim=(-3, -1)).to(torch.int32)


def estimate_tu_bits(levels: torch.Tensor, log2: int,
                     qp: int | None = None) -> torch.Tensor:
    """Approximate CABAC bits for quantized TUs [..., N, N] -> [...] int32
    (1/BITS_ONE units): cbf, last position, coded_sub_block_flags and the
    per-coefficient ladder. A zero TU costs the cbf=0 weight."""
    w = bin_weights(qp)
    n = 1 << log2
    pos, order, lb, cg_pos = _tables(n, w["last"], levels.device)
    absl = levels.abs().to(torch.int32)
    nz = absl > 0
    any_nz = nz.flatten(-2).any(dim=-1)

    last_scan = torch.where(nz, pos, -1).amax(dim=(-2, -1))
    last_flat = order[torch.clamp_min(last_scan, 0).long()]
    last_bits = lb[(last_flat // n).long()] + lb[(last_flat % n).long()]

    cg_sum = cg_sums(absl)
    cg_nz = cg_sum > 0
    k_full = _repeat4(rice_param(cg_sum))
    if n > 4:
        last_cg_scan = torch.where(cg_nz, cg_pos, -1).amax(dim=(-2, -1))
        csbf_bits = torch.clamp_min(last_cg_scan - 1, 0) * w["csbf"]
        coeff_mask = _repeat4(cg_nz)
    else:
        csbf_bits = torch.zeros_like(last_scan)
        coeff_mask = torch.ones_like(nz)

    in_range = pos <= last_scan[..., None, None]
    lb_coeff = level_bits(absl, k_full, w)
    coeff_bits = torch.where(coeff_mask & in_range, lb_coeff, 0).sum(
        dim=(-2, -1))
    total = w["cbf1"] + last_bits + csbf_bits + coeff_bits
    return torch.where(any_nz, total, w["cbf0"]).to(torch.int32)


def tu_bit_features(levels: np.ndarray, log2: int) -> np.ndarray:
    """Per-bin-type counts behind estimate_tu_bits, for the offline weight
    regression (pipeline/calibrate.py). levels [N, N] int (numpy).
    Returns [len(_W_FIELDS) + 1] float64: counts for (sig0, sig1, gt1_0,
    gt1_1, gt2_0, gt2_1, csbf, last-prefix, cbf1, cbf0) followed by the
    bypass bits (remainders, signs, last suffix), so that counts . weights
    + bypass * BITS_ONE == estimate_tu_bits for the same weights. Every
    count is an exact integer."""
    n = 1 << log2
    absl = np.abs(np.asarray(levels, np.int64))
    nz = absl > 0
    f = np.zeros(len(_W_FIELDS) + 1, np.float64)
    if not nz.any():
        f[_W_FIELDS.index("cbf0")] = 1
        return f
    f[_W_FIELDS.index("cbf1")] = 1

    pos = _scan_pos(n)
    last_scan = int(np.max(np.where(nz, pos, -1)))
    ly, lx = np.argwhere(pos == last_scan)[0]
    lc = _last_pos_counts(n)
    f[_W_FIELDS.index("last")] = lc[ly, 0] + lc[lx, 0]
    bypass = int(lc[ly, 1] + lc[lx, 1])

    cg_sum = absl.reshape(n // 4, 4, n // 4, 4).sum(axis=(1, 3))
    cg_nz = cg_sum > 0
    k_cg = rice_param(torch.as_tensor(cg_sum)).numpy()
    k_full = np.repeat(np.repeat(k_cg, 4, axis=0), 4, axis=1)
    if n > 4:
        last_cg = int(np.max(np.where(cg_nz, _scan_pos(n // 4), -1)))
        f[_W_FIELDS.index("csbf")] = max(last_cg - 1, 0)
        coeff_mask = np.repeat(np.repeat(cg_nz, 4, axis=0), 4, axis=1)
    else:
        coeff_mask = np.ones_like(nz)
    in_range = (pos <= last_scan) & coeff_mask

    a = absl[in_range]
    for field, count in (("sig0", a == 0), ("sig1", a > 0),
                         ("gt1_0", a == 1), ("gt1_1", a > 1),
                         ("gt2_0", a == 2), ("gt2_1", a > 2)):
        f[_W_FIELDS.index(field)] = int(count.sum())
    big = a > 2
    if big.any():
        rem = golomb_rice_bits(
            torch.as_tensor(a[big] - 3, dtype=torch.int32),
            torch.as_tensor(k_full[in_range][big], dtype=torch.int32))
        bypass += int(rem.sum())
    bypass += int((a > 0).sum())         # signs
    f[-1] = bypass
    return f


def estimate_mode_bits(is_mpm: torch.Tensor,
                       mpm_idx: torch.Tensor) -> torch.Tensor:
    """Luma intra mode signaling cost (xModeBitsIntra semantics): the
    prev_intra_luma_pred_flag ctx bin + mpm_idx bypass bins or 5 bypass
    bins. In 1/BITS_ONE units."""
    mpm_flag = int(0.8 * BITS_ONE)
    bits_mpm = mpm_flag + torch.where(mpm_idx == 0, BITS_ONE, 2 * BITS_ONE)
    bits_rem = mpm_flag + 5 * BITS_ONE
    return torch.where(is_mpm, bits_mpm, bits_rem).to(torch.int32)
