"""ConvNet2 training on torch autograd (port of hevctpu/models/train.py):
the offline step that turns full-RD-search depth labels into a checkpoint
(the reference shipped only its trained weights; its training consumed
DEBUG_CTU_DEPTH partition dumps, TEncCu.cpp:258-275, paired with the
crops use_model.py:89-99 feeds at inference).

Loss: 4 independent 4-way cross-entropies over the 16 logits (one depth
class per 16x16 block of a quadrant), the per-group argmax the predictor
applies (use_model.py:100-101). The trainer works on the same BN-folded
parametrization inference uses, starting from the JAX package's initial
weights (convnet2.init_params) or a checkpoint, and returns JAX-layout
params that checkpoint.save writes and both packages load.

The convolutions and products run as cuDNN and cuBLAS under autograd on
the card (the JAX package leaves them to XLA; it has no Pallas kernel
here), in full float32: the package turns TF32 off on import. Adam is
torch's single-tensor form on every device, so the card and the CPU take
the same update formula; it rounds differently from optax's (optax
divides m and v by their bias corrections, torch folds them into the
step size and the denominator). In float64 the port, the JAX trainer and
the card agree to rounding. In float32 each step's gradients carry
rounding gaps that Adam's division by sqrt(v) enlarges where v is tiny,
so runs on two devices or in two packages agree in loss, accuracy and
the weights as a whole, not tensor by tensor.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from hevctpu_torch import get_device
from hevctpu_torch.models import convnet2

ACC_SAMPLES = 2048     # accuracy is measured on the first samples only


def loss_fn(model: convnet2.ConvNet2, x32: torch.Tensor, x64: torch.Tensor,
            digits: torch.Tensor) -> torch.Tensor:
    """Mean grouped cross-entropy over B x 4 groups; digits [B, 4] in
    {0..3}, any integer type."""
    logits = model(x32, x64).reshape(-1, 4)
    return F.cross_entropy(logits, digits.reshape(-1).long())


@torch.no_grad()
def accuracy(model: convnet2.ConvNet2, x32: torch.Tensor, x64: torch.Tensor,
             digits: torch.Tensor) -> float:
    """Share of the B x 4 depth digits the per-group argmax gets right,
    rounded as jnp.mean rounds it: the float32 count times the float32
    reciprocal of the number of digits."""
    pred = model(x32, x64).reshape(-1, 4, 4).argmax(dim=-1)
    hits = int((pred == digits).sum())
    return float(np.float32(hits) * np.float32(1.0 / pred.numel()))


def train_step(model: convnet2.ConvNet2, opt: torch.optim.Optimizer,
               x32: torch.Tensor, x64: torch.Tensor,
               digits: torch.Tensor) -> torch.Tensor:
    """One Adam step on one batch; returns the batch loss (on the device,
    detached, not synchronised)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, x32, x64, digits)
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(model: convnet2.ConvNet2, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root), single-tensor form on every device."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, foreach=False)


def train(x32, x64, digits, *, params=None, epochs: int = 5,
          batch: int = 256, lr: float = 1e-3, seed: int = 0, log=print,
          device=None):
    """Train (or fine-tune, when params are given) ConvNet2 on `device`
    (the card unless the caller names another).

    x32 [N,32,32,3], x64 [N,64,64,3] float in [0,1]; digits [N,4] int
    (numpy arrays or tensors). It computes in float32, or in float64 when
    x32 is float64 (as the JAX trainer does under x64). Each epoch
    shuffles with
    np.random.default_rng(seed) as the JAX trainer does, drops the last
    partial batch, and runs one batch of all N samples when N < batch;
    accuracy is taken on the first 2048 samples after each epoch.
    Returns (JAX-layout numpy params, history [{"epoch", "loss", "acc"}])."""
    dev = get_device(device)
    x32, x64 = (torch.as_tensor(a, device=dev) for a in (x32, x64))
    dtype = torch.float64 if x32.dtype == torch.float64 else torch.float32
    x32, x64 = x32.to(dtype), x64.to(dtype)
    digits = torch.as_tensor(digits, device=dev).to(torch.int64)
    n = x32.shape[0]
    model = convnet2.load_model(
        convnet2.init_params(seed) if params is None else params,
        dev).to(dtype).train()
    opt = make_optimizer(model, lr)
    rng = np.random.default_rng(seed)
    history = []
    with deterministic_convolutions():
        for ep in range(epochs):
            order = torch.as_tensor(rng.permutation(n), device=dev)
            losses = []
            for i in range(0, n - batch + 1, batch) or [0]:
                idx = order[i: i + batch]
                losses.append(train_step(model, opt, x32[idx], x64[idx],
                                         digits[idx]))
            # one host sync an epoch; a Python float sum in step order
            tot = sum(torch.stack(losses).tolist())
            acc = accuracy(model, x32[:ACC_SAMPLES], x64[:ACC_SAMPLES],
                           digits[:ACC_SAMPLES])
            history.append({"epoch": ep, "loss": tot / len(losses),
                            "acc": acc})
            if log:
                log(f"epoch {ep}: loss {tot / len(losses):.4f} "
                    f"acc {acc:.3f}")
    return convnet2.params_to_jax(model), history


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN takes deterministic convolution algorithms inside the block
    (the same run gives the same weights) and the flag is restored after:
    inference's flags stay as they were found."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
