"""Dense rate-distortion candidate evaluation for the mode search (port of
hevctpu/ops/rd.py).

Every candidate is predicted -> transformed -> quantized, with distortion
measured in the transform domain (HEVC's integer DCT is 2^(7-log2N) times
an orthonormal transform, so pixel SSE == coefficient SSE x 4^(log2N-7))
and rate from a stateless estimator: the per-bin-type weight model
(ops/rate.py, rate_model="global") or the exact residual bin stream at
frozen context states (ops/rate_ctx.py, rate_model="ctx").
"""

from __future__ import annotations

import torch

from hevctpu_torch.ops import quant, rate, rate_ctx, transforms


def mode_rd_costs(preds: torch.Tensor, orig: torch.Tensor, log2: int,
                  qp: int, *, lam: float, dst: bool = False,
                  is_luma: bool = True, rate_model: str = "ctx",
                  cbf_ctx: int | None = None):
    """RD cost of coding each candidate prediction.

    preds [..., M, N, N] int32, orig [..., N, N] int32. Returns
    (rd [..., M] float32, bits [..., M] in 1/BITS_ONE units — float32
    under "ctx", int32 under "global" — and dist [..., M] float32 ~
    pixel-domain SSE). cbf_ctx is the cbf flag's context index under
    "ctx" (luma: 1 at CU-root TUs, the default, else 0; chroma: the
    transform depth, default 0)."""
    res = orig[..., None, :, :] - preds
    coef = transforms.forward_transform(res, log2, dst=dst)
    lvl = quant.quantize(coef, log2, qp)
    deq = quant.dequantize(lvl, log2, qp)
    dist = quant.exact_sq_sum(coef - deq) * (4.0 ** (log2 - 7))
    if rate_model == "ctx":
        bits = rate_ctx.estimate_tu_bits_ctx(
            lvl, log2, qp, is_luma=is_luma,
            cbf_ctx=1 if cbf_ctx is None and is_luma else (cbf_ctx or 0))
    else:
        bits = rate.estimate_tu_bits(lvl, log2, qp)
    rd = dist + (lam / rate.BITS_ONE) * bits.to(torch.float32)
    return rd, bits, dist
