"""Source pre-analysis: TM5-step-3 adaptive-QP activity (port of
hevctpu/pipeline/preanalysis.py; HM's TEncPreanalyzer::xPreanalyze, off
by default in the shipped config).

Per coding block, the minimum variance of its 8×8 sub-blocks is the
"activity"; activities are normalized against the picture mean and mapped
to a per-block QP offset dqp = 6·log2(normAct) clipped to ±max_dqp. The
whole picture is one batched reduction in float32, as in the JAX package;
its short float sums add left to right (seqsum), so every device rounds
them alike.

The luma plane's height and width must be multiples of the block size
(64 by default): 1920×1080 and 416×240 are not. The JAX package fails
there with a reshape error; the port raises a ValueError that says so and
does not pad.
"""

from __future__ import annotations

import numpy as np
import torch

from hevctpu_torch import get_device
from hevctpu_torch.ops.quant import seqsum


def adaptive_qp_map(y: torch.Tensor, *, block: int = 64,
                    max_dqp: int = 6) -> torch.Tensor:
    """Per-block QP offsets for a luma plane [..., H, W] (H, W multiples
    of `block`). Returns int32 [..., H/block, W/block] in
    [-max_dqp, max_dqp]."""
    h, w = y.shape[-2:]
    if h % block or w % block or block % 8:
        raise ValueError(
            f"adaptive QP needs a luma plane whose height and width are "
            f"multiples of the {block}-pel block, got {h}x{w}")
    f = y.to(torch.float32)
    lead = f.shape[:-2]
    # variance of every 8×8 sub-block
    sub = f.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    mean = seqsum(sub, (-2, -1)) / 64.0
    var = seqsum(sub * sub, (-2, -1)) / 64.0 - mean * mean
    # activity of each block = 1 + min sub-block variance (TM5 step 3)
    k = block // 8
    v = var.reshape(*lead, h // block, k, w // block, k)
    act = 1.0 + v.amin(dim=(-3, -1))
    avg = (seqsum(act, (-2, -1)) / float(act.shape[-2] * act.shape[-1]))
    avg = avg[..., None, None]
    norm = (2.0 * act + avg) / (act + 2.0 * avg)
    dqp = 6.0 * torch.log2(norm)
    return torch.clamp(torch.round(dqp), -max_dqp, max_dqp).to(torch.int32)


def frame_qp_offset(y, *, max_dqp: int = 3, device=None) -> int:
    """Whole-frame QP offset from mean activity — the frame-level use of
    the preanalysis when per-CU delta-QP signaling is not enabled (the
    default operating point, like the reference's). The luma plane [H, W]
    goes to `device` (the card unless the caller names another)."""
    y = torch.as_tensor(np.asarray(y, np.int32)).to(get_device(device))
    dqp = adaptive_qp_map(y, max_dqp=max_dqp)
    return int(torch.round(seqsum(dqp.to(torch.float32), (-2, -1))
                           / float(dqp.shape[-2] * dqp.shape[-1])))
