#!/usr/bin/env python3
"""Per-stage wall time and roofline of the port's encode on one device
(PyTorch port; the same flags, defaults and stage keys as
tools/profile_stages.py, plus --device): ConvNet2, stage-1 luma and
chroma, the TU tree, all of stage 1, the stage-2 wavefront, the whole
device encode, the filters (derived), host CABAC and encode_fused,
against the H100's data-sheet peaks. Writes PROFILE_TORCH.md and
PROFILE_TORCH.json.

Usage: python tools/profile_stages_torch.py [--frames 8] [--qp 32]
           [--out PROFILE_TORCH] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import config, get_device  # noqa: E402
from hevctpu_torch.pipeline import evaluate, profile  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(ROOT, "PROFILE_TORCH"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    doc = profile.profile_stages(
        evaluate.load_params(config.DEFAULT_MODEL), frames=args.frames,
        qp=args.qp, device=get_device(args.device))
    # the labels, and so the partition stage 2 reconstructs, follow the
    # weights: random ones split otherwise than a trained checkpoint
    doc["cnn_params"] = (config.DEFAULT_MODEL
                         if os.path.exists(config.DEFAULT_MODEL)
                         else "init_params(0)")
    with open(args.out + ".json", "w") as f:
        json.dump(doc, f, indent=1, default=float)
    md = profile.profile_markdown(doc)
    with open(args.out + ".md", "w") as f:
        f.write(md)
    print(md, end="")
    print("wrote", args.out + ".md", args.out + ".json")


if __name__ == "__main__":
    main()
