#!/usr/bin/env python3
"""Count the TU steps of the port's stage 2 for each reconstruction of
one two-pass batch (hevctpu_torch, CNN labels from CKPT_DOMAIN.npz, QP 32,
clips.clip_sine seed 0), and on the card time its two forms.

  python tools/stage2_steps.py [--height 240] [--width 416] [--frames 4]
                               [--device cuda|cpu]

Prints, per reconstruction, the steps the host-planned form (stage 2's
plain version) runs (all, with a luma TU, with a chroma TU: a diagonal
runs the union of its CTUs' steps) beside the traced form's fixed count
(D diagonals x 424 masked TU calls), and the encoder's stage ms. On the
card it then runs each reconstruction again in both forms (time_forms,
which chip_smoke.py's phase 19 calls too): the planned form, and the
traced form with its CUDA graphs captured anew, under
torch.cuda.set_sync_debug_mode("error"), its 13 planes held equal to the
planned form's. It prints the capture ms, the graphs' nodes, the
replays, the ms of a call that captures and of one that only replays
(CUDA events), and the peak memory.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from hevctpu_torch.models import checkpoint, convnet2  # noqa: E402
from hevctpu_torch.pipeline import clips  # noqa: E402
from hevctpu_torch.pipeline import encoder as E  # noqa: E402

# masked _tu_step_dyn calls of one diagonal: 84 luma steps (sizes 32,
# 16, 8) each with its chroma step, and 256 luma TU4 steps
STEPS_PER_DIAGONAL = 2 * 84 + 256


def planned_steps(enc, args) -> dict:
    """The host plan's step counts for one reconstruction's arguments."""
    g = enc.geom
    tz, c8 = args[5].cpu().numpy(), args[6].cpu().numpy()
    plan = E._stage2_plan(g, g.wavefront, tz, c8, E._Upload())
    steps = [st for _, diag in plan for st in diag]
    return dict(all=len(steps), luma=sum(1 for st in steps if st[3]),
                chroma=sum(1 for st in steps if st[4]))


def cuda_ms(fn, sync_debug=0):
    """(ms, fn()) on CUDA events; fn runs under the sync debug mode."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda.set_sync_debug_mode(sync_debug)
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def time_forms(enc, args, replay: bool = True) -> dict:
    """Stage 2's two forms on one reconstruction's arguments, on the card:
    the planned form's ms, then the traced form's with its graphs
    captured anew, under torch.cuda.set_sync_debug_mode("error") (nothing
    read back to the host): the ms of the call that captures and, with
    replay, of a call that only replays. Each traced call's 13 planes
    must equal the planned form's (ValueError naming the planes that
    differ). Also the capture ms, the graphs' nodes, the replays, the
    diagonals and the peak memory of the traced calls."""
    row = {}
    row["planned_ms"], want = cuda_ms(lambda: enc._reconstruct_planned(
        *args))
    enc._stage2.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for call in ("capture_call_ms", "replay_call_ms")[: 1 + replay]:
        row[call], got = cuda_ms(lambda: enc._reconstruct_traced(*args),
                                 "error")
        bad = sorted(k for k in want.keys() | got.keys()
                     if k not in want or k not in got
                     or not torch.equal(want[k], got[k]))
        if len(want) != 13 or bad:
            raise ValueError("the traced stage 2 differs from the planned "
                             f"one in {bad or sorted(want)}")
    wf, = enc._stage2.values()
    row.update(capture_ms=wf.capture_ms, nodes=wf.nodes,
               replays=wf.replays, diagonals=wf.diagonals,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args()

    calls = []
    real = E.FrameEncoder._reconstruct

    def recording(self, *a, **k):
        calls.append(a + tuple(k.values()))
        return real(self, *a, **k)

    E.FrameEncoder._reconstruct = recording
    y, u, v = clips.clip_sine(args.frames, args.height, args.width, seed=0)
    cnn = convnet2.load_model(
        checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz")), args.device)
    enc = E.FrameEncoder(args.height, args.width, 32, device=args.device,
                         two_pass=True)
    enc.collect(enc.encode_fused_dispatch(cnn, y, u, v))
    E.FrameEncoder._reconstruct = real
    traced = enc.geom.wavefront[0].shape[0] * STEPS_PER_DIAGONAL
    for i, a in enumerate(calls, 1):
        c = planned_steps(enc, a[:8])
        print(f"reconstruction {i}: {c['all']} steps planned "
              f"({c['luma']} luma, {c['chroma']} chroma: "
              f"{c['luma'] + c['chroma']} TU calls); traced form {traced} "
              f"TU calls")
    print("stage ms:", {k: round(ms, 3) for k, ms in enc.stage_ms().items()})
    if enc.device.type != "cuda":
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    for i, a in enumerate(calls, 1):
        print(f"reconstruction {i} on the card:",
              json.dumps(time_forms(enc, a)))


if __name__ == "__main__":
    main()
