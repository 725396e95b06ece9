#!/usr/bin/env python3
"""The control of the correctness check: the plain reference ConvNet2 put
in the program's place and computed one step below the configuration's
precision (float32 with TF32 off -> TF32 on), judged by the same check as
a run (cellbench.check.judge) at the cell's own size. It has to come out
not correct: its readings are the upper ones the limits sit below.

For each seed: the cell's traffic for `--batches` batches (as many as a
run's window holds); ConvNet2's labels of every frame from the plain
network in float32 with TF32 on; the sampled frames encoded by the
program with those labels (FrameEncoder.encode) and their streams written
by the program's host coder; then the check. Prints one JSON line a seed
with the numbers compared; needs a card.

    python3 benchmark/control.py --workload classD_qp32_b32_corpus --batches 8 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cellbench import check, spec, traffic  # noqa: E402


def control_batches(cell, mix, pool, seed: int, batches: int,
                    device: str) -> list:
    """The control's served batches, in the layout check.judge reads: every
    frame's labels; out and stream hold the program's encode of the
    sampled frames with the control's labels (other frames repeat a
    sampled one, and are never compared)."""
    from hevctpu_torch.codec import decoder as streamlib
    from plainref import cnn

    from cellbench import window

    cfg = cell.config
    params = cnn.load_params(os.path.join(spec.ROOT, cfg["weights"]))
    fams = [mix.family(k) for k in range(batches)]
    labels = {}
    with cnn.tf32(True):
        for fam in dict.fromkeys(fams):
            lg = cnn.frame_logits(params, *pool[fam], device,
                                  dtype=torch.float32)
            labels[fam] = cnn.labels_from_logits(lg)
    picks = check.sample(fams, mix.check_frames, mix.batch, seed)
    frames = tuple(np.stack([pool[fams[k]][c][i] for k, i in picks])
                   for c in range(3))
    lab = np.stack([labels[fams[k]][i] for k, i in picks])
    s = window.build(cfg, dataclasses.replace(mix, batch=len(picks)), seed,
                     os.path.join(spec.ROOT, cfg["weights"]), device)
    out = s.enc.encode(*frames, lab)
    out = {k: v for k, v in out.items() if not k.startswith("recon_")}
    served = []
    for k, fam in enumerate(fams):
        mine = [j for j, (kk, _) in enumerate(picks) if kk == k] or [0]
        rows = np.zeros(mix.batch, np.int64) + mine[0]
        for j in mine:
            rows[picks[j][1]] = j
        bout = {key: (np.asarray(v)[rows] if np.ndim(v) > 0 else v)
                for key, v in out.items()}
        bout["labels"] = labels[fam]
        served.append(dict(family=fam, frames=mix.batch, labels=labels[fam],
                           out=bout,
                           stream=streamlib.encode_stream(s.stream_cfg,
                                                          [bout])))
    return served


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    mix = traffic.Mix.from_dict(cell.traffic)
    weights = os.path.join(spec.ROOT, cell.config["weights"])
    for seed in args.seeds:
        pool = traffic.make_pool(mix, cell.config["height"],
                                 cell.config["width"], seed)
        served = control_batches(cell, mix, pool, seed, args.batches, "cuda")
        judged = check.judge(cell.config, mix, weights, pool, served, seed,
                             "cuda")
        correct, rows = check.verdict(judged["numbers"], cell.limits)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              correct=correct, checks=rows,
                              seconds=judged.get("seconds"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
