#!/usr/bin/env python3
"""Measure the reference pipeline's RD: HM 16.20 with CNN depth pruning,
the labels from the PyTorch port's ConvNet2 (the same flags, defaults
and report as tools/measure_pruned_hm.py, plus --device).

HM's recursive search gated by ConvNet2's per-16x16 depth labels
(TEncCu.cpp:496-520): the oracle build (tools/build_hm_oracle.sh) with
HM_USE_PRED=1 reads them from ./pred/<frame>/ctu<i>.txt
(use_model.py:121-125). The clip is bench.py's, clips.clip_sine(seed=0)
at 416x240.

Output: PRUNED_HM_MEASURED_TORCH.json
Usage:  python tools/measure_pruned_hm_torch.py [--frames 8]
            [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hevctpu_torch import config, get_device  # noqa: E402
from hevctpu_torch.pipeline import clips, evaluate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    # tools/build_hm_oracle.sh's default build directory
    ap.add_argument("--hm", default="/tmp/hm/bin/TAppEncoderStatic")
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "PRUNED_HM_MEASURED_TORCH.json"))
    ap.add_argument("--device", default="cuda",
                    help="torch device for ConvNet2 (default cuda; raises "
                         "without CUDA; cpu runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = get_device(args.device)
    h, w = evaluate.H, evaluate.W
    y, u, v = clips.clip_sine(args.frames, h, w, seed=0)
    labels = evaluate.clip_labels(evaluate.load_params(config.DEFAULT_MODEL),
                                  y, u, v, dev)

    with tempfile.TemporaryDirectory() as td:
        yuv = os.path.join(td, "in.yuv")
        clips.write_yuv(yuv, y, u, v)
        evaluate.write_pred_files(td, labels)
        points = []
        for qp in [int(q) for q in args.qps.split(",")]:
            p = evaluate.run_hm(args.hm, yuv, w, h, args.frames, qp, td,
                                use_pred=True)
            print(json.dumps(p))
            points.append(p)

    doc = {"clip": {"w": w, "h": h, "frames": args.frames,
                    "generator": "clips.clip_sine(seed=0)"},
           "rd_pruned_hm": [{k: p[k] for k in
                             ("qp", "bitrate_kbps", "psnr_y", "psnr_u",
                              "psnr_v", "time_s", "fps")} for p in points],
           "encoder": "HM 16.20 + ConvNet2 depth pruning (reference "
                      "pipeline, HM_USE_PRED=1), single thread",
           "labels_device": evaluate.device_label(dev)}

    mpath = os.path.join(os.path.dirname(args.out), "BASELINE_MEASURED.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            anchor = json.load(f)["rd_anchor"]
        bdr, bdp = evaluate.bd(anchor, points)
        doc["bd_rate_pct_vs_hm_anchor"] = bdr
        doc["bd_psnr_db_vs_hm_anchor"] = bdp
        doc["time_saving_pct"] = evaluate.time_saving(anchor, points)
        print(f"pruned HM vs anchor: BD-rate {bdr:+.2f}%"
              f"  BD-PSNR {bdp:+.3f} dB"
              f"  time saving {doc['time_saving_pct']:.1f}%")

    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
