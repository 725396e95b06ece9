"""HEVC core transforms as batched matmuls (port of hevctpu/ops/transforms.py).

An NxN forward/inverse transform is two small matmuls against the spec
matrices, batched over thousands of TUs. PyTorch has no integer matmul on
CUDA, and float32 is not exact here (the second forward stage at 32x32
exceeds 2^24), so the products run in float64: every operand is an
integer, |T| <= 90 and |x| < 2^23, so every partial sum stays far below
2^53 and the result is the exact integer product.

All entry points take [..., N, N] int32 blocks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch import rom


@functools.lru_cache(maxsize=None)
def _mat_np(log2_size: int, dst: bool, transpose: bool) -> np.ndarray:
    m = rom.DST4 if dst else rom.dct_matrix(1 << log2_size)
    if transpose:
        m = m.T
    return np.ascontiguousarray(m).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _mat(log2_size: int, dst: bool, transpose: bool,
         device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_mat_np(log2_size, dst, transpose),
                           dtype=torch.float64, device=device)


def exact_i32_matmul(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t @ x (t [K, N], x [..., N, M] int32) computed exactly in float64
    for |t| <= 255 and |x| < 2^23; returns int32."""
    return torch.matmul(t.to(torch.float64), x.to(torch.float64)).to(
        torch.int32)


def _round_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def forward_transform(res: torch.Tensor, log2_size: int, *,
                      bit_depth: int = 8, dst: bool = False) -> torch.Tensor:
    """Forward 2-D transform of residual blocks [..., N, N] -> coefficients
    (horizontal stage then vertical, shifts log2+bd-9 and log2+6)."""
    t = _mat(log2_size, dst, False, res.device)
    s1 = rom.fwd_shift_1st(log2_size, bit_depth)
    s2 = rom.fwd_shift_2nd(log2_size)
    tmp = _round_shift(exact_i32_matmul(t, res.transpose(-1, -2)), s1)
    return _round_shift(exact_i32_matmul(t, tmp.transpose(-1, -2)), s2)


def inverse_transform(coef: torch.Tensor, log2_size: int, *,
                      bit_depth: int = 8, dst: bool = False) -> torch.Tensor:
    """Normative inverse 2-D transform (H.265 8.6.4): vertical stage, shift
    7 with 16-bit clip, then horizontal stage, shift 20-bitDepth."""
    tt = _mat(log2_size, dst, True, coef.device)
    s2 = rom.inv_shift_2nd(bit_depth)
    tmp = _round_shift(exact_i32_matmul(tt, coef), rom.INV_SHIFT_1ST)
    tmp = torch.clamp(tmp, -32768, 32767)
    out = _round_shift(exact_i32_matmul(tt, tmp.transpose(-1, -2)), s2)
    return out.transpose(-1, -2).contiguous()
