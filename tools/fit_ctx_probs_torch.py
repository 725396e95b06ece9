#!/usr/bin/env python3
"""Calibrate the per-context bin counts of the ctx rate estimator with
the PyTorch port (hevctpu_torch; the same flags, defaults and report as
tools/fit_ctx_probs.py, plus --device).

Runs the golden slice coder (codec/syntax.py, the exact bin stream of the
final bitstream) over full-RD corpus encodes (240x416) at each QP and
writes hevctpu_torch/ops/ctx_probs.py with the raw (zeros, ones) counts
per (context name, index); rate_ctx blends them with the init-state
prior.

Usage: python tools/fit_ctx_probs_torch.py [--clips pink,pan,detail]
           [--frames 4] [--qps 22,27,32,37] [--out ...] [--device cuda|cpu]
(scene is left out by default as the BD holdout clip.)
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
    ap.add_argument("--clips", default="pink,pan,detail")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "hevctpu_torch", "ops", "ctx_probs.py"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args()

    table = calibrate.ctx_count_table(
        [int(q) for q in args.qps.split(",")], args.clips.split(","),
        args.frames, device=args.device,
        log=functools.partial(print, flush=True))
    with open(args.out, "w") as f:
        f.write(calibrate.ctx_probs_source(table,
                                           "tools/fit_ctx_probs_torch.py"))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
