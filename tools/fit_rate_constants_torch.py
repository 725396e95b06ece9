#!/usr/bin/env python3
"""Regression-fit the global rate model's per-QP bin weights against the
exact CABAC coder, with the PyTorch port (hevctpu_torch; the same flags,
defaults and report as tools/fit_rate_constants.py, plus --device).

  1. encodes corpus frames (240x416) at each CTC QP with the full-RD
     search and takes every coded luma TU of frame 0,
  2. counts each TU's exact fresh-context CABAC bits (CabacCounter),
  3. takes the estimator's per-bin-type counts (rate.tu_bit_features),
  4. fits the weights per QP (ridge toward the hand-set weights) and
     writes a rate_weights module.

Usage: python tools/fit_rate_constants_torch.py [--frames 2]
           [--clips pink,scene,detail] [--max-tus 1200] [--out ...]
           [--device cuda|cpu]
"""

import argparse
import functools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch.pipeline import calibrate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--clips", default="pink,scene,detail")
    ap.add_argument("--max-tus", type=int, default=1200)
    # A scratch path: the committed ops/rate_weights.py holds the
    # holdout-validated per-QP scale, which a refit must not replace
    # silently. Pass --out hevctpu_torch/ops/rate_weights.py to adopt one.
    ap.add_argument("--out", default=os.path.join(
        ROOT, "rate_weights_refit_torch.py"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args()

    fitted, report = calibrate.fit_rate_constants(
        args.clips.split(","), args.frames, args.max_tus,
        device=args.device, log=functools.partial(print, flush=True))
    with open(args.out, "w") as f:
        f.write(calibrate.rate_weights_source(
            fitted, report, "tools/fit_rate_constants_torch.py"))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
