"""Float32 accuracy of ConvNet2's training step on the card, per cuDNN
setting, against the same step in float64 on the CPU.

The batch is the first 256 samples of make_dataset on one 1920x1080 frame
of clips.clip_sine (seed 0), labelled by CKPT_DOMAIN.npz; the weights are
init_params(0). For each setting it prints the relative L2 gap of the
logits, the loss and every parameter gradient against the float64 CPU
step, the CPU's own float32 gaps beside them, and the precision flags the
installed torch reports.

  python tools/train_precision.py        (needs a CUDA card; repo root)
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hevctpu_torch.models import checkpoint, convnet2, train  # noqa: E402
from hevctpu_torch.pipeline import clips, labels  # noqa: E402


def step(x32, x64, digits, device, dtype):
    """Logits, loss and gradients of one step from init_params(0)."""
    model = convnet2.load_model(convnet2.init_params(0), device).to(dtype)
    logits = model(x32.to(device, dtype), x64.to(device, dtype))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 4), digits.to(device).reshape(-1))
    loss.backward()
    grads = {k: p.grad.detach().cpu().double()
             for k, p in model.named_parameters()}
    return logits.detach().cpu().double(), float(loss.detach()), grads


def run(ds, device, dtype, epochs=2, batch=256):
    """train.train's loop (same shuffle and batches) under the caller's
    cuDNN flags; returns the weights as float64 tensors."""
    x32, x64, digits = (a.to(device) for a in ds)
    x32, x64 = x32.to(dtype), x64.to(dtype)
    model = convnet2.load_model(convnet2.init_params(0), device).to(dtype)
    opt = train.make_optimizer(model, 1e-3)
    rng = np.random.default_rng(0)
    n = x32.shape[0]
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        for i in range(0, n - batch + 1, batch):
            idx = order[i: i + batch]
            train.train_step(model, opt, x32[idx], x64[idx], digits[idx])
    return {k: p.detach().cpu().double() for k, p in model.named_parameters()}


def rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-300))


def flags() -> dict:
    out = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision()}
    for name, mod in (("cudnn.conv", getattr(torch.backends.cudnn, "conv",
                                             None)),
                      ("cuda.matmul", torch.backends.cuda.matmul)):
        if mod is not None and hasattr(mod, "fp32_precision"):
            out[f"{name}.fp32_precision"] = mod.fp32_precision
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_precision: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cnn = convnet2.load_model(checkpoint.load(
        os.path.join(root, "CKPT_DOMAIN.npz")), "cpu")
    y, u, v = clips.clip_sine(1, 1080, 1920, seed=0)
    lab = convnet2.predict_frame_labels(
        cnn, *(torch.as_tensor(p.astype(np.int32)) for p in (y, u, v)),
        1080, 1920)
    ds = labels.make_dataset(y, u, v, lab, device="cpu")
    x32, x64, digits = (a[:256] for a in ds)
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}")
    print(f"flags: {flags()}")
    ref = step(x32, x64, digits, "cpu", torch.float64)
    ref_w = run(ds, "cpu", torch.float64)

    def report(name, got, weights):
        grads = {k: rel(got[2][k], ref[2][k]) for k in ref[2]}
        worst = max(grads, key=grads.get)
        w = {k: rel(weights[k], ref_w[k]) for k in ref_w}
        w_worst = max(w, key=w.get)
        print(f"{name}: one step: logits {rel(got[0], ref[0]):.3g}, loss "
              f"{abs(got[1] - ref[1]) / ref[1]:.3g}, worst gradient "
              f"{worst} {grads[worst]:.3g} ("
              + ", ".join(f"{k} {g:.2g}" for k, g in grads.items())
              + f"); after 14 steps: worst weights {w_worst} "
              f"{w[w_worst]:.3g}", flush=True)

    report("CPU float32", step(x32, x64, digits, "cpu", torch.float32),
           run(ds, "cpu", torch.float32))
    cudnn = torch.backends.cudnn
    for name, enabled, deterministic, benchmark, dtype in (
            ("card, cuDNN deterministic (the trainer's)", True, True, False,
             torch.float32),
            ("card, cuDNN default", True, False, False, torch.float32),
            ("card, cuDNN benchmark", True, False, True, torch.float32),
            ("card, cuDNN off (native convolutions)", False, False, False,
             torch.float32),
            ("card, float64, cuDNN deterministic", True, True, False,
             torch.float64)):
        saved = cudnn.enabled, cudnn.deterministic, cudnn.benchmark
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = \
            enabled, deterministic, benchmark
        try:
            report(name, step(x32, x64, digits, "cuda", dtype),
                   run(ds, "cuda", dtype))
        finally:
            cudnn.enabled, cudnn.deterministic, cudnn.benchmark = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
