"""Quantization / dequantization + vectorized RDOQ and SBH (port of
hevctpu/ops/quant.py).

The QP is a static int, or (cu_qp_delta operating points) an integer
tensor over the leading TU dims: per-CTU QP maps gather to per-TU values,
and the scale and shifts become elementwise (TComTrQuant setQpParam).
All of that is integer arithmetic, bit-exact on every device.

Forward quant is the reference's hard-decision quantizer; dequantization
is the normative H.265 8.6.3 formula (flat scaling). quantize_rdoq is the
JAX package's data-parallel RDOQ: per coefficient {round, round-1, 0} by
distortion + λ·(stateless bits), 4x4 coefficient-group zeroing, then the
last-position pass (the package's default), then arbitration against the
hard-decision result.

Float sums here are order-fixed so that every device computes the same
decision: distortion sums of integer errors are exact int64 sums, short
float sums add left to right in float32 (seqsum, the order XLA's CPU
reduction uses, so exact ties stay ties as in the JAX package), and the
scan cumsums accumulate in float64 and round once to float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import rom
from hevctpu_torch.ops import rate


def transform_shift(log2_size: int, bit_depth: int = 8) -> int:
    return rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size


def is_static_qp(qp) -> bool:
    """True for a static int QP, False for a per-TU QP tensor."""
    return isinstance(qp, (int, np.integer))


@functools.lru_cache(maxsize=None)
def _scale_tables(device: torch.device):
    return tuple(torch.as_tensor(np.asarray(t, np.int32), device=device)
                 for t in (rom.QUANT_SCALES, rom.INV_QUANT_SCALES))


def _qp_split(qp, ref: torch.Tensor, inverse: bool = False):
    """(QP // 6, (inverse) quant scale of QP % 6): ints for a static QP;
    for a per-TU QP tensor, int32 tensors broadcast against the
    [..., N, N]-like ref."""
    if is_static_qp(qp):
        table = rom.INV_QUANT_SCALES if inverse else rom.QUANT_SCALES
        return int(qp) // 6, int(table[int(qp) % 6])
    q = qp.to(torch.int32)
    q = q.reshape(q.shape + (1,) * (ref.dim() - q.dim()))
    return q // 6, _scale_tables(ref.device)[int(inverse)][(q % 6).long()]


def quantize(coef: torch.Tensor, log2_size: int, qp, *,
             bit_depth: int = 8) -> torch.Tensor:
    """Hard-decision quantization of [..., N, N] coefficients -> levels
    (intra rounding offset 171/512); qp static or per TU."""
    qdiv, scale = _qp_split(qp, coef)
    qbits = rom.QUANT_SHIFT + qdiv + transform_shift(log2_size, bit_depth)
    level = torch.clamp((coef.abs() * scale + (171 << (qbits - 9)))
                        >> qbits, 0, 32767)
    return torch.where(coef < 0, -level, level)


def dequantize(level: torch.Tensor, log2_size: int, qp, *,
               bit_depth: int = 8) -> torch.Tensor:
    """Normative dequant (H.265 8.6.3, m=16): levels -> coefficients. A
    per-TU qp evaluates both shift directions of the formula elementwise,
    with clamped shift amounts."""
    qdiv, scale = _qp_split(qp, level, inverse=True)
    scale = scale * 16
    e = qdiv - (bit_depth + log2_size - 5)
    if is_static_qp(qp):
        if e < 0:
            d = (level * scale + (1 << (-e - 1))) >> (-e)
        else:
            d = (level * scale) << e
    else:
        neg = torch.clamp_min(-e, 0)
        rnd = torch.where(e < 0, 1 << torch.clamp_min(neg - 1, 0), 0)
        d = torch.where(e < 0, (level * scale + rnd) >> neg,
                        (level * scale) << torch.clamp_min(e, 0))
    return torch.clamp(d, -32768, 32767)


def exact_sq_sum(err: torch.Tensor) -> torch.Tensor:
    """Σ err² over the trailing [N, N] of integer errors, exact (int64),
    returned as float32 (one rounding, the same on every device)."""
    e = err.to(torch.int64)
    return (e * e).sum(dim=(-2, -1)).to(torch.float32)


def seqsum(x: torch.Tensor, dims) -> torch.Tensor:
    """Sum over the (few) axes `dims`, adding the elements left to right in
    row-major order of those axes: the same float rounding on every
    device, and the order XLA's CPU backend uses for short reductions."""
    dims = [d % x.dim() for d in ((dims,) if isinstance(dims, int)
                                  else dims)]
    keep = [d for d in range(x.dim()) if d not in dims]
    x = x.permute(*keep, *dims).flatten(len(keep))
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


@functools.lru_cache(maxsize=None)
def _tb_scan_tables(log2_size: int):
    """(pos [3, N, N] scan position of each (y, x), idx [3, N*N] flat
    y*N+x of each scan position) for diag/hor/ver (H.265 6.5.3)."""
    n = 1 << log2_size
    pos = np.zeros((3, n, n), np.int32)
    idx = np.zeros((3, n * n), np.int32)
    for s in range(3):
        order = (rom.tb_scan(s, log2_size) if n > 4
                 else rom.scan_order(s, n))
        for i, (y, x) in enumerate(order):
            pos[s, y, x] = i
            idx[s, i] = y * n + x
    return pos, idx


def _last_bits_scan(log2_size: int, w_last: int) -> np.ndarray:
    """[3, N*N] last-position signaling bits (1/256 units) if scan pos p
    is the last significant coefficient, per scan type."""
    n = 1 << log2_size
    _, idx = _tb_scan_tables(log2_size)
    lb = rate._last_pos_bits(n, w_last)
    return lb[idx // n] + lb[idx % n]


@functools.lru_cache(maxsize=None)
def _rdoq_tables(log2_size: int, w_last: int, device: torch.device):
    pos, idx = _tb_scan_tables(log2_size)
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(idx, dtype=torch.int64, device=device),
            torch.as_tensor(_last_bits_scan(log2_size, w_last),
                            dtype=torch.float32, device=device))


def _pool_cg(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    return seqsum(x.reshape(*x.shape[:-2], n // 4, 4, n // 4, 4), (-3, -1))


def quantize_rdoq(coef: torch.Tensor, log2_size: int, qp, lam, *,
                  bit_depth: int = 8, scan: torch.Tensor | None = None,
                  rate_qp: int | None = None) -> torch.Tensor:
    """RD-optimized quantization of [..., N, N] coefficients -> levels.
    scan [...] int32 (0 diag, 1 hor, 2 ver per TU) selects the coefficient
    scan (mode-dependent for N <= 8); None = diagonal.

    qp and lam may be per-TU tensors [...] (cu_qp_delta); the rate tables
    then stay at the static slice QP rate_qp, since context
    initialization depends on SliceQpY only (9.3.2.2)."""
    if rate_qp is None:
        if not is_static_qp(qp):
            raise ValueError("a per-TU qp needs an explicit static rate_qp")
        rate_qp = int(qp)
    absc = coef.abs()
    qdiv, scale = _qp_split(qp, coef)
    qbits = rom.QUANT_SHIFT + qdiv + transform_shift(log2_size, bit_depth)
    l1 = torch.clamp((absc * scale + (1 << (qbits - 1))) >> qbits, 0, 32767)
    l0 = torch.clamp_min(l1 - 1, 0)

    n = 1 << log2_size
    k = rate._repeat4(rate.rice_param(rate.cg_sums(l1)))
    dscale = 4.0 ** (log2_size - 7)
    lam_u = lam / rate.BITS_ONE
    if isinstance(lam, torch.Tensor):   # per-TU λ [...]: explicit axes
        lam2, lam1 = lam_u[..., None, None], lam_u[..., None]
    else:
        lam2 = lam1 = lam_u
    wq = rate.bin_weights(rate_qp)

    def cost(lvl):
        deq = dequantize(lvl, log2_size, qp, bit_depth=bit_depth)
        err = (absc - deq).to(torch.float32)
        return err * err * dscale + lam2 * rate.level_bits(
            lvl, k, wq).to(torch.float32)

    c1, c0, cz = cost(l1), cost(l0), cost(torch.zeros_like(l1))
    best = torch.where((c0 < c1) & (l0 < l1), l0, l1)
    cbest = torch.minimum(torch.where(l0 < l1, c0, c1), c1)
    lvl = torch.where(cz <= cbest, 0, best)
    csel = torch.minimum(cz, cbest)

    # CG zeroing: the group's coded cost (+ csbf bin) against all-zero.
    if n > 4:
        coded_cost = _pool_cg(csel) + lam2 * wq["csbf"]
        zero_cost = _pool_cg(cz)
        kill = rate._repeat4(zero_cost < coded_cost)
        lvl = torch.where(kill, 0, lvl)
        csel = torch.where(kill, cz, csel)

    # Last-position optimization over the scan: two cumulative sums.
    pos_t, idx_t, lastb = _rdoq_tables(log2_size, wq["last"], coef.device)
    dz = absc.to(torch.float32) ** 2 * dscale       # zero-out distortion
    mdcs = scan is not None and n <= 8
    lead = lvl.shape[:-2]
    keep_any = zero_any = None
    for s in range(3 if mdcs else 1):
        idx = idx_t[s]

        def flat(x):
            return x.reshape(*lead, n * n)[..., idx]

        c_scan, z_scan, l_scan = flat(csel), flat(dz), flat(lvl)
        csum = c_scan.to(torch.float64).cumsum(-1).to(torch.float32)
        zsum = z_scan.to(torch.float64).cumsum(-1).to(torch.float32)
        tail_zero = zsum[..., -1:] - zsum
        j_q = csum + tail_zero + lam1 * (lastb[s] + float(wq["cbf1"]))
        j_q = torch.where(l_scan != 0, j_q, torch.inf)
        j_best, q_best = torch.min(j_q, dim=-1)
        j_zero = zsum[..., -1] + lam_u * float(wq["cbf0"])
        any_nz = (l_scan != 0).any(dim=-1)
        keep_s = pos_t[s] <= q_best[..., None, None]
        zero_s = (~any_nz) | (j_zero < j_best)
        if not mdcs:
            keep_any, zero_any = keep_s, zero_s
        elif keep_any is None:
            keep_any, zero_any = keep_s, zero_s
        else:
            sel = scan == s
            keep_any = torch.where(sel[..., None, None], keep_s, keep_any)
            zero_any = torch.where(sel, zero_s, zero_any)
    lvl = torch.where(zero_any[..., None, None] | ~keep_any, 0, lvl)

    # Final arbitration against hard decision with the full TU estimator.
    hdq = quantize(coef, log2_size, qp, bit_depth=bit_depth).abs()

    def full_j(lv):
        deq = dequantize(lv, log2_size, qp, bit_depth=bit_depth)
        d = exact_sq_sum(absc - deq) * dscale
        return d + lam_u * rate.estimate_tu_bits(
            lv, log2_size, rate_qp).to(torch.float32)

    take_rdoq = (full_j(lvl) <= full_j(hdq))[..., None, None]
    lvl = torch.where(take_rdoq, lvl, hdq)
    return torch.where(coef < 0, -lvl, lvl)


@functools.lru_cache(maxsize=None)
def _pos_in_cg() -> np.ndarray:
    """[3, 4, 4] within-group scan position of each (y, x) for the diag /
    horizontal / vertical scans (H.265 6.5.3)."""
    out = np.zeros((3, 4, 4), np.int32)
    for s in range(3):
        for i, (y, x) in enumerate(rom.scan_order(s, 4)):
            out[s, y, x] = i
    return out


@functools.lru_cache(maxsize=None)
def _pos_in_cg_t(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_pos_in_cg(), device=device)


def scan_sel(mode: torch.Tensor, log2_size: int,
             is_luma: bool) -> torch.Tensor:
    """Mode-dependent scan index (H.265 7.4.9.11): 0 diag, 1 hor, 2 ver."""
    if log2_size == 2 or (log2_size == 3 and is_luma):
        ver = (mode >= 6) & (mode <= 14)
        hor = (mode >= 22) & (mode <= 30)
        return torch.where(ver, 2, torch.where(hor, 1, 0)).to(torch.int32)
    return torch.zeros(mode.shape, dtype=torch.int32, device=mode.device)


def sign_bit_hide(lvl: torch.Tensor, coef: torch.Tensor, log2_size: int,
                  qp, scan: torch.Tensor, *,
                  bit_depth: int = 8) -> torch.Tensor:
    """Encoder-side sign-data hiding (TComTrQuant::signBitHidingHDQ,
    vectorized over TUs): for each 4x4 group with lastNZ - firstNZ > 3
    whose parity disagrees with the first coefficient's sign, nudge the
    ±1-cheapest coefficient. lvl/coef [..., N, N]; scan [...] and a
    per-TU qp tensor [...] index the TUs."""
    n = 1 << log2_size
    nc = n // 4
    pos = _pos_in_cg_t(lvl.device)[scan.long()]            # [..., 4, 4]

    def cgv(x):  # [..., N, N] -> [..., nc, nc, 4, 4]
        return x.reshape(*x.shape[:-2], nc, 4, nc, 4).transpose(-3, -2)

    def uncgv(x):
        return x.transpose(-3, -2).reshape(*x.shape[:-4], n, n)

    lc = cgv(lvl)
    absl = lc.abs()
    nz = absl > 0
    p = pos[..., None, None, :, :].expand(lc.shape)
    first = torch.where(nz, p, 16).amin(dim=(-2, -1))     # [..., nc, nc]
    last = torch.where(nz, p, -1).amax(dim=(-2, -1))
    hide = (last - first) > 3
    sum_abs = absl.sum(dim=(-2, -1))
    at_first = nz & (p == first[..., None, None])
    first_neg = (at_first & (lc < 0)).flatten(-2).any(dim=-1)
    bad = hide & (((sum_abs & 1) == 1) != first_neg)

    absc = cgv(coef.abs()).to(torch.float32)

    def err(a):
        return torch.square(absc - dequantize(a, log2_size, qp,
                                              bit_depth=bit_depth)
                            .to(torch.float32))

    e0 = err(absl)
    d_up = err(absl + 1) - e0
    d_dn = err(torch.clamp_min(absl - 1, 0)) - e0
    interior = (p > first[..., None, None]) & (p < last[..., None, None])
    up_ok = nz | interior
    dn_ok = (absl >= 2) | ((absl == 1) & ~at_first
                           & (p != last[..., None, None]))
    flat = torch.cat(
        [torch.where(up_ok, d_up, torch.inf).flatten(-2),
         torch.where(dn_ok, d_dn, torch.inf).flatten(-2)], dim=-1)
    idx = flat.argmin(dim=-1)                               # [..., nc, nc]
    onehot = idx[..., None] == torch.arange(32, device=lvl.device)
    up_m = onehot[..., :16].reshape(lc.shape) & bad[..., None, None]
    dn_m = onehot[..., 16:].reshape(lc.shape) & bad[..., None, None]
    sgn = torch.where(lc != 0, torch.sign(lc),
                      torch.where(cgv(coef) < 0, -1, 1)).to(lc.dtype)
    zero = torch.zeros_like(lc)
    out = lc + torch.where(up_m, sgn, zero) - torch.where(dn_m, sgn, zero)
    return uncgv(out)
