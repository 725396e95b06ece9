#!/usr/bin/env python3
"""Per-syntax-element bit statistics of a port encode (the
TComCodingStatistics role; PyTorch port, the same flags, defaults and
report as tools/bit_stats.py, plus --device).

Encodes a corpus clip with the full-RD search, runs the golden slice
coder over each frame with a counting CABAC that attributes each bin's
fractional cost to its context name (evaluate.frame_bit_stats), and
prints a per-element table (bits, share) and the counted total against
the real stream's size.

Usage: python tools/bit_stats_torch.py [--clip pink] [--frames 2]
           [--qp 32] [--w 416] [--h 240] [--device cuda|cpu]

Library use:
  from hevctpu_torch.pipeline.evaluate import frame_bit_stats
  stats = frame_bit_stats(cfg, frame_dict, i)   # {name: bits}
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import get_device  # noqa: E402
from hevctpu_torch.pipeline import evaluate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clip", default="pink")
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--w", type=int, default=416)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    total, real_bits = evaluate.clip_bit_stats(
        args.clip, args.frames, args.qp, args.h, args.w,
        device=get_device(args.device))
    print(evaluate.bit_stats_table(total, real_bits))


if __name__ == "__main__":
    main()
