#!/usr/bin/env python3
"""Fine-tune ConvNet2 on-domain with the PyTorch port (hevctpu_torch; the
same flags, defaults and report as tools/train_cnn_domain.py, plus
--device): full-RD depth labels on the corpus clip families (240x416),
make_dataset, train, and an npz checkpoint for the CNN-pruned encoder.

The default --out is a file of its own (CKPT_DOMAIN_TORCH.npz, not
tracked): the repository's CKPT_DOMAIN.npz is never overwritten. --init
is the reference's torch checkpoint, skipped when the file is missing.

Usage: python tools/train_cnn_domain_torch.py [--seeds 2] [--frames 8]
       [--qps 27,32,37] [--families pink,scene,pan,detail,sine]
       [--epochs 12] [--lr 5e-4] [--init ...] [--out ...]
       [--device cuda|cpu]
"""

import argparse
import functools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import config  # noqa: E402
from hevctpu_torch.models import checkpoint, convnet2, train  # noqa: E402
from hevctpu_torch.pipeline import calibrate  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=2,
                    help="clip seeds per corpus family (training uses "
                    "seeds >= 100 so the seed-0 evaluation clips stay "
                    "held out)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--qps", default="27,32,37")
    ap.add_argument("--families", default="pink,scene,pan,detail,sine")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--init", default=config.DEFAULT_MODEL)
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "CKPT_DOMAIN_TORCH.npz"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args()

    log = functools.partial(print, flush=True)
    x32, x64, digits = calibrate.domain_dataset(
        args.families.split(","), args.seeds, args.frames,
        [int(q) for q in args.qps.split(",")], device=args.device, log=log)
    print(f"dataset: {digits.shape[0]} samples")

    init = None
    if args.init and os.path.exists(args.init):
        init = convnet2.load_torch_params(args.init)
    params, hist = train.train(x32, x64, digits, params=init,
                               epochs=args.epochs, lr=args.lr, log=log,
                               device=args.device)
    checkpoint.save(args.out, params)
    print(f"trained {len(hist)} epochs, final acc {hist[-1]['acc']:.3f} "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
