#!/usr/bin/env python3
"""Measure the HM 16.20 anchor encoder on bench_torch.py's clip (the same
flags, defaults, printed lines and report as tools/measure_anchor.py).

Runs the unmodified-search HM build (tools/build_hm_oracle.sh) on the
synthetic 416x240 clip bench_torch.py encodes (bench_torch.synth_clip,
clips.clip_sine with seed 0, the clip bench.py uses), at the CTC QP sweep
{22,27,32,37} (calc_BDBR/README.md:12 protocol), single CPU thread, and
records:

  * hm_ai_416x240_fps       — anchor frames/s at QP 32 (the baseline
                              bench_torch.py and bench.py divide by)
  * rd_anchor               — per-QP (bitrate kbps, Y-PSNR) points for the
                              Bjontegaard BD-rate flow (pipeline/evaluate.py)

Nothing here touches a device: HM is a host process and the clip is
numpy, so there is no --device flag. A real run needs an HM build
(tools/build_hm_oracle.sh); --hm names its TAppEncoderStatic.

Output: BASELINE_MEASURED_TORCH.json (never BASELINE_MEASURED.json, the
        JAX tool's record)
Usage:  python tools/measure_anchor_torch.py [--frames 8]
            [--hm /tmp/hm/bin/TAppEncoderStatic] [--qps 22,27,32,37]
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from hevctpu_torch.pipeline import clips, evaluate  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    # tools/build_hm_oracle.sh's default build directory
    ap.add_argument("--hm", default="/tmp/hm/bin/TAppEncoderStatic")
    ap.add_argument("--qps", default="22,27,32,37")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "BASELINE_MEASURED_TORCH.json"))
    args = ap.parse_args(argv)

    h, w = bench_torch.H, bench_torch.W
    y, u, v = bench_torch.synth_clip(args.frames, h, w)

    with tempfile.TemporaryDirectory() as td:
        yuv = os.path.join(td, "in.yuv")
        clips.write_yuv(yuv, y, u, v)
        points = []
        for qp in [int(q) for q in args.qps.split(",")]:
            p = evaluate.run_hm(args.hm, yuv, w, h, args.frames, qp, td)
            print(json.dumps(p))
            points.append(p)

    fps32 = next((p["fps"] for p in points if p["qp"] == 32),
                 points[len(points) // 2]["fps"])
    doc = {
        "hm_ai_416x240_fps": round(fps32, 4),
        "clip": {"w": w, "h": h, "frames": args.frames,
                 "generator": "bench_torch.synth_clip(seed=0)"},
        "rd_anchor": [{k: p[k] for k in
                       ("qp", "bitrate_kbps", "psnr_y", "psnr_u", "psnr_v",
                        "time_s", "fps")} for p in points],
        "encoder": "HM 16.20 anchor (tools/build_hm_oracle.sh, pred=99 "
                   "full search), single thread",
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print("wrote", args.out)
    return doc


if __name__ == "__main__":
    main()
