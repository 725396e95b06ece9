#!/usr/bin/env python3
"""The port's RD curve on bench.py's sine clip and its BD-rate/BD-PSNR
against the HM anchor (PyTorch port; the same flags, defaults and report
as tools/measure_rd.py, plus --device).

Encodes clips.clip_sine(seed=0) at 416x240 at the CTC QP sweep
{22,27,32,37} in each search mode with the clip's ConvNet2 labels,
reports per-QP kbps at 30 fps and Y/U/V PSNR and, where
BASELINE_MEASURED.json / PRUNED_HM_MEASURED.json hold the anchor
curves, the Bjontegaard deltas.

Usage: python tools/measure_rd_torch.py [--frames 8] [--modes cnn,rd]
           [--model CKPT_DOMAIN.npz] [--out RD_MEASURED_TORCH.json]
           [--device cuda|cpu]
"""

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import config, get_device  # noqa: E402
from hevctpu_torch.pipeline import clips, evaluate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--modes", default="cnn,rd")
    ap.add_argument("--model", default=None,
                    help="CNN checkpoint (.pt or .npz) for the cnn mode; "
                    "defaults to the reference torch checkpoint")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "RD_MEASURED_TORCH.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    h, w = evaluate.H, evaluate.W
    y, u, v = clips.clip_sine(args.frames, h, w, seed=0)
    params = evaluate.load_params(args.model or config.DEFAULT_MODEL)

    anchors = {}
    for tag, path, key in (
            ("hm_anchor", "BASELINE_MEASURED.json", "rd_anchor"),
            ("pruned_hm", "PRUNED_HM_MEASURED.json", "rd_pruned_hm")):
        mpath = os.path.join(ROOT, path)
        if os.path.exists(mpath):
            with open(mpath) as f:
                anchors[tag] = json.load(f)[key]

    result = {"clip": {"w": w, "h": h, "frames": args.frames,
                       "generator": "clips.clip_sine(seed=0)"},
              "device": evaluate.device_label(dev)}
    result.update(evaluate.rd_sweep(
        y, u, v, args.modes.split(","), params, anchors, device=dev,
        log=functools.partial(print, flush=True)))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
