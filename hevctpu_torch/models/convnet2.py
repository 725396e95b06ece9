"""ConvNet2 CU-depth predictor as a torch nn.Module (port of
hevctpu/models/convnet2.py).

A two-branch CNN maps a 32x32 RGB crop plus its containing 64x64 CTU crop
to 4 depth labels (one per 16x16 quarter); batch-norm is already folded
into the convolutions in the parameter files. The public functions keep
the JAX package's layouts (NHWC crops, [..., 16] logits); the module
converts to NCHW inside. Weights come across from the JAX params layout
with params_from_jax and go back to it with params_to_jax; the
reference's torch checkpoint (a state dict with batch-norm layers) comes
to that layout with load_torch_params, and init_params draws the JAX
package's initial weights for training from scratch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


_BN_EPS = 1e-5


def load_torch_params(pt_path: str) -> dict:
    """Load the reference checkpoint (a torch state dict) and fold its
    batch norms into the conv weights. Returns the JAX-layout params dict
    of numpy arrays that params_from_jax and load_model take: conv
    kernels HWIO, linear weights [in, out], fc1's input reordered from
    torch's CHW flatten to HWC."""
    sd = torch.load(pt_path, map_location="cpu")
    sd = {k: v.numpy() for k, v in sd.items()}
    params = {}

    def fold_conv(prefix):
        w = sd[f"{prefix}.0.weight"]            # OIHW
        b = sd[f"{prefix}.0.bias"]
        gamma = sd[f"{prefix}.1.weight"]
        beta = sd[f"{prefix}.1.bias"]
        mean = sd[f"{prefix}.1.running_mean"]
        var = sd[f"{prefix}.1.running_var"]
        scale = gamma / np.sqrt(var + _BN_EPS)
        w = w * scale[:, None, None, None]
        b = (b - mean) * scale + beta
        params[prefix] = {
            "w": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),  # HWIO
            "b": b.astype(np.float32),
        }

    for p in ("conv1", "conv64", "conv2", "conv3"):
        fold_conv(p)

    def linear(prefix, torch_key):
        w = sd[f"{torch_key}.weight"]  # [out, in]
        b = sd[f"{torch_key}.bias"]
        params[prefix] = {"w": w.T.astype(np.float32),
                          "b": b.astype(np.float32)}

    linear("fc1", "fc1.0")
    linear("fc2", "fc2.0")
    linear("fc3", "fc3")

    # fc1's input from torch's CHW (128, 4, 4) flatten to the HWC one
    w = params["fc1"]["w"]  # [2048, 256] indexed by c*16 + h*4 + w
    idx = np.arange(2048)
    c, rem = idx // 16, idx % 16
    h, wcol = rem // 4, rem % 4
    w_new = np.zeros_like(w)
    w_new[h * (4 * 128) + wcol * 128 + c] = w
    params["fc1"]["w"] = w_new
    return params


def init_params(seed: int = 0) -> dict:
    """Random JAX-layout params with the checkpoint's shapes (He-scaled
    normal weights, zero biases), drawn in the JAX package's order from
    np.random.default_rng(seed): bit-identical to its init_params."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, ci, co):
        std = float(np.sqrt(2.0 / (kh * kw * ci)))
        return {"w": rng.normal(0, std, (kh, kw, ci, co)).astype(np.float32),
                "b": np.zeros(co, np.float32)}

    def lin(ci, co):
        std = float(np.sqrt(2.0 / ci))
        return {"w": rng.normal(0, std, (ci, co)).astype(np.float32),
                "b": np.zeros(co, np.float32)}

    return {"conv1": conv(5, 5, 3, 16), "conv64": conv(5, 5, 3, 16),
            "conv2": conv(3, 3, 32, 64), "conv3": conv(3, 3, 64, 128),
            "fc1": lin(2048, 256), "fc2": lin(256, 64), "fc3": lin(64, 16)}


class ConvNet2(nn.Module):
    """x32 [B,32,32,3], x64 [B,64,64,3] in [0,1] -> logits [B, 16]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 5, padding=2)
        self.conv64 = nn.Conv2d(3, 16, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.conv3 = nn.Conv2d(64, 128, 3, padding=1)
        self.fc1 = nn.Linear(2048, 256)
        self.fc2 = nn.Linear(256, 64)
        self.fc3 = nn.Linear(64, 16)

    def forward(self, x32: torch.Tensor, x64: torch.Tensor) -> torch.Tensor:
        x32 = x32.permute(0, 3, 1, 2)
        x64 = x64.permute(0, 3, 1, 2)
        a = F.max_pool2d(F.relu(self.conv1(x32)), 2)          # [B,16,16,16]
        b = F.max_pool2d(F.relu(self.conv64(x64)), 4)         # [B,16,16,16]
        out = torch.cat([a, b], dim=1)                        # [B,32,16,16]
        out = F.max_pool2d(F.relu(self.conv2(out)), 2)        # [B,64,8,8]
        out = F.max_pool2d(F.relu(self.conv3(out)), 2)        # [B,128,4,4]
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)  # HWC
        out = F.relu(self.fc1(out))
        out = F.relu(self.fc2(out))
        return self.fc3(out)


def params_from_jax(params: dict) -> dict:
    """JAX-layout params (HWIO conv kernels, [in, out] linear weights with
    fc1's input in HWC order) -> a ConvNet2 state_dict. The HWC order is
    kept by flattening NHWC in forward()."""
    sd = {}
    for name in ("conv1", "conv64", "conv2", "conv3"):
        w = np.asarray(params[name]["w"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))     # OIHW
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params[name]["b"], np.float32).copy())
    for name in ("fc1", "fc2", "fc3"):
        w = np.asarray(params[name]["w"], np.float32)
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params[name]["b"], np.float32).copy())
    return sd


def params_to_jax(model: ConvNet2) -> dict:
    """The inverse of params_from_jax: a ConvNet2's weights as JAX-layout
    numpy params in the model's float type (HWIO conv kernels, [in, out]
    linear weights, fc1's input kept in HWC order), the layout
    checkpoint.save writes."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    params = {}
    for name in ("conv1", "conv64", "conv2", "conv3"):
        params[name] = {
            "w": np.ascontiguousarray(
                sd[f"{name}.weight"].transpose(2, 3, 1, 0)),    # HWIO
            "b": sd[f"{name}.bias"].copy()}
    for name in ("fc1", "fc2", "fc3"):
        params[name] = {"w": np.ascontiguousarray(sd[f"{name}.weight"].T),
                        "b": sd[f"{name}.bias"].copy()}
    return params


def load_model(params: dict, device) -> ConvNet2:
    """ConvNet2 in eval mode on `device` from JAX-layout params."""
    model = ConvNet2()
    model.load_state_dict(params_from_jax(params))
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# Legality post-processing (use_model.py:101-119)
# ---------------------------------------------------------------------------


def postprocess_quadrant(digits: torch.Tensor) -> torch.Tensor:
    """Per-quadrant upgrade rules on [..., 4] depth digits in {0..3}: any 0
    mixed with non-0 -> 0s become 1; then any 1 mixed with non-1 -> 1s
    become 2."""
    has0 = (digits == 0).any(dim=-1, keepdim=True)
    all0 = (digits == 0).all(dim=-1, keepdim=True)
    digits = torch.where(has0 & ~all0 & (digits == 0), 1, digits)
    has1 = (digits == 1).any(dim=-1, keepdim=True)
    all1 = (digits == 1).all(dim=-1, keepdim=True)
    return torch.where(has1 & ~all1 & (digits == 1), 2, digits)


def assemble_ctu_labels(quad_digits: torch.Tensor) -> torch.Tensor:
    """[..., 4 quadrants, 4 digits] -> [..., 16] labels in 16x16 raster
    order, with the cross-quadrant chain: quadrant q>0 stays all-zero only
    if quadrant q-1 does."""
    q = postprocess_quadrant(quad_digits)
    z = (q == 0).all(dim=-1)                       # [..., 4]
    keep = torch.cumprod(z.to(torch.int32), dim=-1).to(torch.bool)
    q = torch.where((z & ~keep)[..., None], 1, q)
    out = q.reshape(*q.shape[:-2], 2, 2, 2, 2)     # [qy, qx, dy, dx]
    out = out.permute(*range(out.dim() - 4), -4, -2, -3, -1)
    return out.reshape(*q.shape[:-2], 16)


def logits_to_labels(logits: torch.Tensor) -> torch.Tensor:
    """[..., 16] logits -> [..., 4] depth digits via per-group argmax."""
    return logits.reshape(*logits.shape[:-1], 4, 4).argmax(dim=-1)


# ---------------------------------------------------------------------------
# Frame -> CTU crops
# ---------------------------------------------------------------------------


def yuv_to_rgb01(y: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Limited-range BT.601 YUV420 planes [..., H, W] -> RGB in [0,1]
    [..., H, W, 3]; chroma upsampled 2x nearest."""
    u2 = u.repeat_interleave(2, -2).repeat_interleave(2, -1).to(torch.float32)
    v2 = v.repeat_interleave(2, -2).repeat_interleave(2, -1).to(torch.float32)
    yf = y.to(torch.float32)
    c = 1.164 * (yf - 16.0)
    d = u2 - 128.0
    e = v2 - 128.0
    r = c + 1.596 * e
    g = c - 0.392 * d - 0.813 * e
    b = c + 2.017 * d
    rgb = torch.stack([r, g, b], dim=-1)
    # divide by a tensor on the device: CUDA turns division by a CPU
    # scalar into a product with its reciprocal, which can round the last
    # bit otherwise than the CPU's (and the JAX package's) division
    return torch.clamp(torch.round(rgb), 0, 255) / torch.tensor(
        255.0, device=rgb.device)


def frame_to_crops(rgb: torch.Tensor, h: int, w: int):
    """RGB [..., H, W, 3] -> (x32 [..., nCTU*4, 32, 32, 3], x64 [...,
    nCTU, 64, 64, 3]), out-of-frame area zero-padded; CTUs row-major,
    quadrants row-major within each CTU."""
    lead = rgb.shape[:-3]
    ry, rx = -(-h // 64), -(-w // 64)
    rgb = F.pad(rgb, (0, 0, 0, rx * 64 - w, 0, ry * 64 - h))
    x64 = rgb.reshape(*lead, ry, 64, rx, 64, 3).transpose(-4, -3)
    x64 = x64.reshape(*lead, ry * rx, 64, 64, 3)
    x32 = x64.reshape(*lead, ry * rx, 2, 32, 2, 32, 3).transpose(-4, -3)
    return x32.reshape(*lead, ry * rx * 4, 32, 32, 3), x64


@torch.no_grad()
def predict_frame_labels(model: ConvNet2, y, u, v, h: int,
                         w: int) -> torch.Tensor:
    """YUV planes [..., H, W] (chroma [..., H/2, W/2]) -> [..., nCTU, 16]
    legal depth labels (int64); leading axes batch frames into one
    forward pass."""
    x32, x64 = frame_to_crops(yuv_to_rgb01(y, u, v), h, w)
    lead = x64.shape[:-4]
    n_ctu = x64.shape[-4]
    x64_rep = x64.repeat_interleave(4, dim=-4)
    logits = model(x32.reshape(-1, 32, 32, 3), x64_rep.reshape(-1, 64, 64, 3))
    digits = logits_to_labels(logits)                       # [*, 4]
    return assemble_ctu_labels(digits.reshape(*lead, n_ctu, 4, 4))
