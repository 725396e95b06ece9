"""Dense rate-distortion candidate evaluation for the mode search (port of
hevctpu/ops/rd.py, global rate model).

Every candidate is predicted -> transformed -> quantized, with distortion
measured in the transform domain (HEVC's integer DCT is 2^(7-log2N) times
an orthonormal transform, so pixel SSE == coefficient SSE x 4^(log2N-7))
and rate from the stateless estimator (ops/rate.py).
"""

from __future__ import annotations

import torch

from hevctpu_torch.ops import quant, rate, transforms


def mode_rd_costs(preds: torch.Tensor, orig: torch.Tensor, log2: int,
                  qp: int, *, lam: float, dst: bool = False):
    """RD cost of coding each candidate prediction under the global rate
    model (the context model, rate_model="ctx", is not ported).

    preds [..., M, N, N] int32, orig [..., N, N] int32. Returns
    (rd [..., M] float32, bits [..., M] int32 in 1/BITS_ONE units,
    dist [..., M] float32 ~ pixel-domain SSE)."""
    res = orig[..., None, :, :] - preds
    coef = transforms.forward_transform(res, log2, dst=dst)
    lvl = quant.quantize(coef, log2, qp)
    deq = quant.dequantize(lvl, log2, qp)
    dist = quant.exact_sq_sum(coef - deq) * (4.0 ** (log2 - 7))
    bits = rate.estimate_tu_bits(lvl, log2, qp)
    rd = dist + (lam / rate.BITS_ONE) * bits.to(torch.float32)
    return rd, bits, dist
