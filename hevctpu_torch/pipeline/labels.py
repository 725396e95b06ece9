"""CU-depth training-label generation, the DEBUG_CTU_DEPTH equivalent
(port of hevctpu/pipeline/labels.py).

The reference produced its CNN training labels by running the unmodified
HM search with DEBUG_CTU_DEPTH on, appending each CTU's chosen per-part
depths to PartitionInfo.txt (TEncCu.cpp:48,258-275). Here the ground truth
comes from the encoder's own full-RD quadtree search
(FrameEncoder(search="rd")) and is emitted both as the same
16-digit-per-CTU text format and as (crops, digits) tensors ready for
models/train.py (make_dataset).
"""

from __future__ import annotations

import numpy as np
import torch


def depth8_to_ctu_labels(depth8: np.ndarray, rc: int, cc: int) -> np.ndarray:
    """Per-8×8-slot depth map [B, rc*8, cc*8] -> [B, rc*cc, 16] labels in the
    CNN's 16×16-raster order (a 16×16 block's depth is uniform: a depth-3
    decision splits the whole block to 8×8)."""
    d16 = depth8[:, ::2, ::2]                      # [B, rc*4, cc*4]
    b = d16.shape[0]
    lab = d16.reshape(b, rc, 4, cc, 4).transpose(0, 1, 3, 2, 4)
    return np.minimum(lab.reshape(b, rc * cc, 16), 3).astype(np.int32)


def rd_ground_truth(y, u, v, qp: int, *, batch: int = 4, device=None):
    """Run the full-RD search over a clip on `device` (the card unless the
    caller names another) and return [B, nCTU, 16] labels — the training
    ground truth (what HM's exhaustive search would pick)."""
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    h, w = y.shape[-2:]
    enc = FrameEncoder(h, w, qp, search="rd", deblock=False, sao=False,
                       device=device)
    rc, cc = enc.geom.rc, enc.geom.cc
    out = []
    for i in range(0, y.shape[0], batch):
        j = min(i + batch, y.shape[0])
        fr = enc.encode(y[i:j], u[i:j], v[i:j])
        out.append(depth8_to_ctu_labels(fr["depth8"], rc, cc))
    return np.concatenate(out, axis=0)


def write_partition_info(path: str, labels: np.ndarray, append: bool = True):
    """Write labels [B, nCTU, 16] in the reference's PartitionInfo.txt
    format: one line of 16 digits per CTU (TEncCu.cpp:259-275)."""
    with open(path, "a" if append else "w") as f:
        for fr in labels:
            for ctu in fr:
                f.write("".join(str(int(d)) for d in ctu) + "\n")


def make_dataset(y, u, v, labels, device=None):
    """Build CNN training tensors from YUV frames [B, H, W] (chroma [B,
    H/2, W/2]) and per-CTU labels [B, nCTU, 16], on `device` (the card
    unless the caller names another).

    Returns (x32 [N,32,32,3], x64 [N,64,64,3] float32 in [0,1], digits
    [N,4] int64) with N = B*nCTU*4: one sample per (frame, CTU, quadrant),
    the crop layout of models/convnet2.frame_to_crops and of the
    reference's PIL crops (use_model.py:89-99); each CTU's x64 repeats
    for its 4 quadrants. All frames are cropped in one pass."""
    from hevctpu_torch import get_device
    from hevctpu_torch.models import convnet2

    dev = get_device(device)

    def on_dev(a):
        # a tensor on any device, or a numpy array (copied: a clip read
        # from a file may be read-only)
        return torch.as_tensor(
            a if torch.is_tensor(a) else np.array(a), device=dev)

    h, w = y.shape[-2:]
    rgb = convnet2.yuv_to_rgb01(on_dev(y), on_dev(u), on_dev(v))
    x32, x64 = convnet2.frame_to_crops(rgb, h, w)
    x64 = x64.repeat_interleave(4, dim=1)
    # labels [B, nCTU, 16] raster -> per-quadrant digits: (qy, dy, qx, dx)
    # -> (qy, qx, dy, dx)
    lab = on_dev(labels).to(torch.int64)
    digits = lab.reshape(-1, 2, 2, 2, 2).permute(0, 1, 3, 2, 4)
    return (x32.reshape(-1, 32, 32, 3), x64.reshape(-1, 64, 64, 3),
            digits.reshape(-1, 4))
