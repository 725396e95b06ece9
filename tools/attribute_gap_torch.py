#!/usr/bin/env python3
"""Attribute the port's RD gap against the HM anchor to its
approximations (PyTorch port; the same flags, defaults and report as
tools/attribute_gap.py, plus --device): BD-rate/BD-PSNR of matched
encoder variants against matched HM variants on the corpus.

  base    ours(rd)                  vs HM(full)  - the headline gap
  2pass   ours(rd, two_pass)        vs HM(full)  - recon-feedback decisions
  nolf    ours(rd, sao=deblock=off) vs HM(LoopFilterDisable=1, SAO=0)
  hdq     ours(rd, rdoq=off)        vs HM(RDOQ=0, RDOQTS=0, SignHide=0)

Writes GAP_ATTRIBUTION_TORCH.json after every variant. HM runs are cached
in CORPUS_HM_VARIANTS.json, written only when HM has just filled a
missing entry.

Usage: python tools/attribute_gap_torch.py [--clips pink,scene]
           [--frames 8] [--skip-hm] [--device cuda|cpu]
"""

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import get_device  # noqa: E402
from hevctpu_torch.pipeline import evaluate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--clips", default="pink,scene")
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--variants", default="base,2pass,nolf,hdq")
    # tools/build_hm_oracle.sh's default build directory
    ap.add_argument("--hm", default="/tmp/hm/bin/TAppEncoderStatic")
    ap.add_argument("--skip-hm", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "GAP_ATTRIBUTION_TORCH.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without CUDA; "
                         "cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    cache_path = os.path.join(ROOT, "CORPUS_HM_VARIANTS.json")
    cache = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)

    def save_cache():
        with open(cache_path, "w") as f:
            json.dump(cache, f, indent=1)

    label = evaluate.device_label(dev)

    def save(result):
        result["protocol"]["device"] = label
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)

    result = evaluate.attribute_gap(
        args.clips.split(","), args.variants.split(","),
        [int(q) for q in args.qps.split(",")], args.frames, cache,
        device=dev, hm=args.hm, skip_hm=args.skip_hm, save_cache=save_cache,
        save=save, log=functools.partial(print, flush=True))
    save(result)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
