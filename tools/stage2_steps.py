#!/usr/bin/env python3
"""Count the TU steps the port's stage 2 plans for each reconstruction of
one two-pass batch (hevctpu_torch, CNN labels from CKPT_DOMAIN.npz, QP 32,
clips.clip_sine seed 0). A diagonal runs the union of its CTUs' steps, so
stage 2's time follows this count.

  python tools/stage2_steps.py [--height 240] [--width 416] [--frames 4]
                               [--device cuda|cpu]

Prints, per reconstruction, the planned steps (all, with a luma TU, with
a chroma TU) and the encoder's stage ms.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch.models import checkpoint, convnet2  # noqa: E402
from hevctpu_torch.pipeline import clips  # noqa: E402
from hevctpu_torch.pipeline import encoder as E  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args()

    counts = []
    plan_fn = E._stage2_plan

    def counting_plan(*a, **k):
        plan = plan_fn(*a, **k)
        steps = [st for _, diag in plan for st in diag]
        counts.append(dict(all=len(steps),
                           luma=sum(1 for st in steps if st[3]),
                           chroma=sum(1 for st in steps if st[4])))
        return plan

    E._stage2_plan = counting_plan
    y, u, v = clips.clip_sine(args.frames, args.height, args.width, seed=0)
    cnn = convnet2.load_model(
        checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz")), args.device)
    enc = E.FrameEncoder(args.height, args.width, 32, device=args.device,
                         two_pass=True)
    enc.collect(enc.encode_fused_dispatch(cnn, y, u, v))
    for i, c in enumerate(counts, 1):
        print(f"reconstruction {i}: {c['all']} steps planned "
              f"({c['luma']} luma, {c['chroma']} chroma)")
    print("stage ms:", {k: round(ms, 3) for k, ms in enc.stage_ms().items()})


if __name__ == "__main__":
    main()
