#!/usr/bin/env python3
"""Multi-sequence RD measurement with the PyTorch port (hevctpu_torch;
the same flags, defaults and report as tools/measure_corpus.py, plus
--device): HM anchor vs pruned HM vs the port's encoder, per clip of
the natural-statistics corpus and averaged.

  * hm anchor  - unmodified HM 16.20 (tools/build_hm_oracle.sh build)
  * pruned HM  - the reference pipeline: HM gated by ConvNet2 labels
                 (HM_USE_PRED=1), labels from the default checkpoint
  * ours cnn   - the port's fused CNN-pruned path
                 (FrameEncoder.encode_fused)
  * ours rd    - the port's full-RD quadtree search

HM points are cached in CORPUS_HM.json (keyed by clip/frames/qps); the
cache is written only when HM has just filled a missing entry, never
under --skip-hm.

Usage: python tools/measure_corpus_torch.py [--frames 8]
           [--clips pink,scene,pan,detail] [--modes cnn,rd]
           [--model CKPT_DOMAIN.npz] [--skip-hm]
           [--out RD_MEASURED_TORCH.json] [--device cuda|cpu]
"""

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import config, get_device  # noqa: E402
from hevctpu_torch.pipeline import evaluate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--clips", default="pink,scene,pan,detail")
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--modes", default="cnn,rd")
    ap.add_argument("--model", default=None,
                    help="checkpoint for OUR cnn mode (.npz or .pt); "
                    "default = the reference torch checkpoint")
    # tools/build_hm_oracle.sh's default build directory
    ap.add_argument("--hm", default="/tmp/hm/bin/TAppEncoderStatic")
    ap.add_argument("--skip-hm", action="store_true",
                    help="reuse cached CORPUS_HM.json without running HM")
    ap.add_argument("--hm-cache",
                    default=os.path.join(ROOT, "CORPUS_HM.json"))
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "RD_MEASURED_TORCH.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    log = functools.partial(print, flush=True)
    qps = [int(q) for q in args.qps.split(",")]
    names = args.clips.split(",")
    modes = [m for m in args.modes.split(",") if m and m != "none"]
    model_path = args.model or config.DEFAULT_MODEL
    our_params = evaluate.load_params(model_path)

    cache = {}
    if os.path.exists(args.hm_cache):
        with open(args.hm_cache) as f:
            cache = json.load(f)

    def save_cache():
        with open(args.hm_cache, "w") as f:
            json.dump(cache, f, indent=1)

    result = {"protocol": {
        "w": evaluate.W, "h": evaluate.H, "frames": args.frames, "qps": qps,
        "corpus": names, "generator": "hevctpu_torch/pipeline/clips.py",
        "cnn_checkpoint": os.path.basename(model_path),
        "device": evaluate.device_label(dev)}}
    result.update(evaluate.corpus_rd(
        names, modes, qps, args.frames, our_params, cache, device=dev,
        hm=args.hm, skip_hm=args.skip_hm,
        ref_params=evaluate.load_params(config.DEFAULT_MODEL),
        save_cache=save_cache, log=log))

    print("\n== corpus average ==")
    for k, val in result["average"].items():
        print(f"  {k}: {val:+.3f}" if val is not None else f"  {k}: n/a")
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
