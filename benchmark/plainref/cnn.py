"""ConvNet2's CU-depth labels, the plain reference.

The network follows the checkpoint's own layout (JAX layout: conv
kernels HWIO with batch norm folded in, linear weights [in, out], fc1's
input flattened in HWC order): a 5x5 conv on each 32x32 RGB quadrant
crop and on its 64x64 CTU crop, max pools, two 3x3 convs, three linears,
16 logits a quadrant read as 4 groups of 4 depth classes. The input is
limited-range BT.601 RGB rounded to integers in float32, as the model is
defined; the network itself runs in float64 here by default, with TF32
off, so that its logits stand above the float32 program's rounding.

Labels follow the reference pipeline's legality rules: per-quadrant
digits upgraded (a 0 beside non-0 digits becomes 1, then a 1 beside
non-1 digits becomes 2), and a quadrant stays all-zero only if every
quadrant before it does. served_gap() reads, for labels the program
served, the widest gap by which a digit that yields them lies below the
reference's best logit of its group, minimised over all digits that
yield them.
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch
import torch.nn.functional as F

# A gap for labels that no choice of digits yields (they break the
# legality rules): larger than any gap between finite logits.
IMPOSSIBLE = 1e9


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for CUDA matmuls and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def load_params(path: str) -> dict:
    """The checkpoint's arrays by layer: {layer: {"w": ..., "b": ...}}."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            layer, field = key.split("/")
            out.setdefault(layer, {})[field] = np.array(f[key])
    return out


def rgb01(y, u, v, device) -> torch.Tensor:
    """uint8 planes [F, H, W], [F, H/2, W/2] -> RGB [F, H, W, 3] in [0, 1],
    float32: chroma upsampled 2x nearest, BT.601 limited range, rounded and
    clamped to 0..255, divided by 255."""
    yf = torch.as_tensor(np.asarray(y, np.float32), device=device)
    u2 = torch.as_tensor(np.asarray(u, np.float32), device=device)
    v2 = torch.as_tensor(np.asarray(v, np.float32), device=device)
    u2 = u2.repeat_interleave(2, -2).repeat_interleave(2, -1)
    v2 = v2.repeat_interleave(2, -2).repeat_interleave(2, -1)
    c = 1.164 * (yf - 16.0)
    d = u2 - 128.0
    e = v2 - 128.0
    rgb = torch.stack([c + 1.596 * e, c - 0.392 * d - 0.813 * e,
                       c + 2.017 * d], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255) / torch.tensor(
        255.0, device=device)


def ctu_crops(rgb: torch.Tensor, h: int, w: int):
    """RGB [F, H, W, 3] -> (x32 [F*nCTU, 4, 3, 32, 32] quadrants row-major,
    x64 [F*nCTU, 3, 64, 64]); CTUs row-major, the area past the picture
    zero."""
    f = rgb.shape[0]
    ry, rx = -(-h // 64), -(-w // 64)
    pad = torch.zeros((f, ry * 64, rx * 64, 3), dtype=rgb.dtype,
                      device=rgb.device)
    pad[:, :h, :w] = rgb
    x64 = pad.reshape(f, ry, 64, rx, 64, 3).permute(0, 1, 3, 5, 2, 4)
    x64 = x64.reshape(f * ry * rx, 3, 64, 64)
    x32 = x64.reshape(-1, 3, 2, 32, 2, 32).permute(0, 2, 4, 1, 3, 5)
    return x32.reshape(-1, 4, 3, 32, 32), x64


def _conv(x, layer, dtype):
    w = torch.as_tensor(layer["w"], device=x.device).to(dtype)
    b = torch.as_tensor(layer["b"], device=x.device).to(dtype)
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)


def _linear(x, layer, dtype):
    w = torch.as_tensor(layer["w"], device=x.device).to(dtype)
    b = torch.as_tensor(layer["b"], device=x.device).to(dtype)
    return x @ w + b


def logits(params: dict, x32: torch.Tensor, x64: torch.Tensor,
           dtype=torch.float64) -> torch.Tensor:
    """[N, 4, 3, 32, 32] quadrant crops and their [N, 3, 64, 64] CTU crops
    -> logits [N, 4, 16] in dtype."""
    n = x64.shape[0]
    b = F.max_pool2d(F.relu(_conv(x64.to(dtype), params["conv64"], dtype)),
                     4)                                       # [N,16,16,16]
    a = F.max_pool2d(F.relu(_conv(x32.reshape(-1, 3, 32, 32).to(dtype),
                                  params["conv1"], dtype)), 2)
    b = b[:, None].expand(n, 4, 16, 16, 16).reshape(-1, 16, 16, 16)
    x = torch.cat([a, b], dim=1)
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"], dtype)), 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv3"], dtype)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)        # HWC order
    x = F.relu(_linear(x, params["fc1"], dtype))
    x = F.relu(_linear(x, params["fc2"], dtype))
    return _linear(x, params["fc3"], dtype).reshape(n, 4, 16)


def frame_logits(params: dict, y, u, v, device, *, dtype=torch.float64,
                 frames_per_block: int = 8) -> np.ndarray:
    """Logits [F, nCTU, 4, 16] (float64 numpy) of every quadrant of every
    CTU of the frames, computed frames_per_block frames at a time."""
    h, w = np.shape(y)[-2:]
    out = []
    with torch.no_grad():
        for i in range(0, len(y), frames_per_block):
            sl = slice(i, i + frames_per_block)
            x32, x64 = ctu_crops(rgb01(y[sl], u[sl], v[sl], device), h, w)
            lg = logits(params, x32, x64, dtype)
            out.append(lg.to(torch.float64).cpu().numpy().reshape(
                len(y[sl]), -1, 4, 16))
    return np.concatenate(out)


def _upgrade(d: np.ndarray) -> np.ndarray:
    """Per-quadrant legality upgrade of digits [..., 4]."""
    has0 = (d == 0).any(-1, keepdims=True)
    all0 = (d == 0).all(-1, keepdims=True)
    d = np.where(has0 & ~all0 & (d == 0), 1, d)
    has1 = (d == 1).any(-1, keepdims=True)
    all1 = (d == 1).all(-1, keepdims=True)
    return np.where(has1 & ~all1 & (d == 1), 2, d)


def digits_to_labels(digits: np.ndarray) -> np.ndarray:
    """Digits [..., 4 quadrants, 4] -> legal labels [..., 16] in the 16x16
    blocks' raster order of the CTU."""
    q = _upgrade(digits)
    z = (q == 0).all(-1)
    keep = np.cumprod(z, axis=-1).astype(bool)
    q = np.where((z & ~keep)[..., None], 1, q)
    lead = q.shape[:-2]
    q = q.reshape(lead + (2, 2, 2, 2))                # qy, qx, dy, dx
    q = np.moveaxis(q, -3, -2)                        # qy, dy, qx, dx
    return q.reshape(lead + (16,))


def labels_from_logits(lg: np.ndarray) -> np.ndarray:
    """Logits [..., 4, 16] -> legal labels [..., 16] (per-group argmax)."""
    return digits_to_labels(lg.reshape(lg.shape[:-1] + (4, 4)).argmax(-1))


def _quadrant_labels(labels: np.ndarray) -> np.ndarray:
    """Labels [..., 16] -> per quadrant [..., 4, 4] (the inverse of the
    raster layout of digits_to_labels)."""
    lead = labels.shape[:-1]
    q = labels.reshape(lead + (2, 2, 2, 2))           # qy, dy, qx, dx
    return np.moveaxis(q, -3, -2).reshape(lead + (4, 4))


_COMBOS = np.array(list(itertools.product(range(4), repeat=4)))   # [256, 4]
_UPGRADED = _upgrade(_COMBOS)
_ZERO = (_UPGRADED == 0).all(-1)


def _ctu_gap(lg: np.ndarray, want: np.ndarray) -> float:
    """Least widest gap of one CTU: lg [4, 16] reference logits, want
    [4, 4] served labels per quadrant. Dynamic programme over the
    quadrants; the state is whether every quadrant so far is all-zero."""
    best = {True: 0.0}
    for qi in range(4):
        g = lg[qi].reshape(4, 4)
        gaps = g.max(-1, keepdims=True) - g                    # [group, class]
        cost = gaps[np.arange(4), _COMBOS].max(-1)             # [256]
        nxt: dict = {}
        for keep, c0 in best.items():
            final = np.where((_ZERO & (not keep))[:, None], 1, _UPGRADED)
            ok = (final == want[qi]).all(-1)
            for z in (True, False):
                sel = ok & (_ZERO == z)
                if sel.any():
                    k2 = keep and z
                    c = max(c0, float(cost[sel].min()))
                    nxt[k2] = min(nxt.get(k2, np.inf), c)
        best = nxt
        if not best:
            return IMPOSSIBLE
    return min(best.values())


def served_gap(ref_logits: np.ndarray, served: np.ndarray) -> tuple:
    """(widest gap, CTUs whose served labels differ from the reference's)
    of served labels [F, nCTU, 16] against reference logits
    [F, nCTU, 4, 16]: 0 where the labels are the reference's own."""
    own = labels_from_logits(ref_logits)
    diff = np.argwhere((own != served).any(-1))
    gap = 0.0
    want = _quadrant_labels(np.asarray(served))
    for f, c in diff:
        gap = max(gap, _ctu_gap(ref_logits[f, c], want[f, c]))
    return gap, len(diff)
