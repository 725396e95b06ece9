"""Distortion metrics: SSE and Hadamard SATD (port of hevctpu/ops/cost.py).

The 8x8 (4x4) Hadamard butterflies are two small exact matmuls batched
over (blocks x modes), as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hevctpu_torch.ops.transforms import exact_i32_matmul


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@functools.lru_cache(maxsize=None)
def _hadamard(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_hadamard_np(n), device=device)


def sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of squared differences over the trailing two axes (int32)."""
    d = (a - b).to(torch.int32)
    return (d * d).sum(dim=(-2, -1)).to(torch.int32)


def _hadamard_abs_sum(diff: torch.Tensor, n: int) -> torch.Tensor:
    h = _hadamard(n, diff.device)
    t = exact_i32_matmul(h, diff)
    t = exact_i32_matmul(h, t.transpose(-1, -2))
    return t.abs().sum(dim=(-2, -1)).to(torch.int32)


def satd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hadamard SATD over trailing [N, N] axes, N in {4, 8, 16, 32, 64}:
    4x4 -> (sum+1)>>1; sizes >= 8 use 8x8 Hadamards per subblock with
    (sum+2)>>2, summed."""
    n = a.shape[-1]
    d = (a - b).to(torch.int32)
    if n == 4:
        return (_hadamard_abs_sum(d, 4) + 1) >> 1
    if n > 8:
        k = n // 8
        d = d.reshape(*d.shape[:-2], k, 8, k, 8).transpose(-3, -2)
        s = (_hadamard_abs_sum(d, 8) + 2) >> 2
        return s.sum(dim=(-2, -1)).to(torch.int32)
    return (_hadamard_abs_sum(d, 8) + 2) >> 2
