"""hevctpu_torch — the PyTorch/CUDA port of the hevctpu HEVC All-Intra
encoder (CNN-pruned CU search, dense SATD/RD mode decision, wavefront
reconstruction, deblock, SAO, host CABAC) for an NVIDIA H100.

The JAX package ``hevctpu`` is the reference; this package imports neither
``jax`` nor ``hevctpu``. Its one hand-written CUDA kernel (the fused SATD
mode search, ops/satd_fused.py + csrc/satd_fused.cu) replaces the JAX
package's Pallas kernel. Entry points run on the card unless the caller
names the CPU (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# TF32 keeps 10 mantissa bits: it would move ConvNet2's argmaxes away from
# the fp32 reference and break every integer-exact float product.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def get_device(device=None) -> torch.device:
    """The device the port runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is wanted but absent (no silent CPU
    fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hevctpu_torch: CUDA is not available; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
