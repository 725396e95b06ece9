#!/usr/bin/env python3
"""Count the TU steps of the port's stage 2 for each reconstruction of
one two-pass batch (hevctpu_torch, CNN labels from CKPT_DOMAIN.npz, QP 32,
clips.clip_sine seed 0), and on the card time its two forms.

  python tools/stage2_steps.py [--height 240] [--width 416] [--frames 4]
                               [--one-pass] [--device cuda|cpu]

--one-pass encodes the batch in one pass, as bench.py and the benchmark
do: one reconstruction.

Prints, per reconstruction, the steps the host-planned form runs (all,
with a luma TU, with a chroma TU: a diagonal runs the union of its CTUs'
steps) beside the eager traced form's fixed count (D diagonals x 424
masked TU calls, stage 2's plain version on the CPU), and the encoder's
stage ms. On the card it then runs each reconstruction again in both
forms (time_forms, which chip_smoke.py's phase 19 calls too): the
planned form, and the kernel form (the traced form's gather and scatter
as CUDA graphs captured anew, the stage-2 kernel between them, each CTU
and plane coding only its own TUs) under
torch.cuda.set_sync_debug_mode("error"), its 13 planes held equal to the
planned form's. It prints the capture ms, the graphs' nodes, the
replays, the kernel launches, the ms of a call that captures and of one
that only replays and of the kernel's launches alone (CUDA events), the
peak memory, and stage 2's bound (bound: the coded TUs' transform
multiply-adds at the card's INT32 rate, or the planes' bytes at HBM's).
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
from hevctpu_torch.ops import stage2_ctu  # noqa: E402
from hevctpu_torch.pipeline import clips  # noqa: E402
from hevctpu_torch.pipeline import encoder as E  # noqa: E402
from hevctpu_torch.pipeline import trace  # noqa: E402

# masked _tu_step_dyn calls of one diagonal in the eager traced form (the
# CPU's): 84 luma steps (sizes 32, 16, 8) each with its chroma step, and
# 256 luma TU4 steps. The card's kernel walks the same 340-step schedule
# a CTU and plane, but codes only the steps that fire there.
STEPS_PER_DIAGONAL = 2 * 84 + 256

# H100 SXM: 132 SMs x 64 INT32 lanes (Hopper white paper), at the SM
# clock; HBM3 at 3.35 TB/s (NVIDIA data sheet)
INT32_LANES = 132 * 64
HBM_BYTES_PER_S = 3.35e12


def planned_steps(enc, args) -> dict:
    """The host plan's step counts for one reconstruction's arguments."""
    g = enc.geom
    tz, c8 = args[5].cpu().numpy(), args[6].cpu().numpy()
    plan = E._stage2_plan(g, g.wavefront, tz, c8, E._Upload())
    steps = [st for _, diag in plan for st in diag]
    return dict(all=len(steps), luma=sum(1 for st in steps if st[3]),
                chroma=sum(1 for st in steps if st[4]))


def bound(enc, args, int32_per_s: float, bytes_per_s: float) -> dict:
    """Stage 2's least time on one reconstruction's arguments, from the
    TUs its decisions code (the leaf-size map, log2 of the luma TU at
    each 8x8 slot with 2 for four 4x4, and the coded-slot map): 4 n^3
    multiply-adds a coded TU (forward and inverse transform, two passes
    each), chroma on two planes, at int32_per_s; 4 bytes a sample of
    the frames' luma and chroma at bytes_per_s. The larger of the two,
    its ms, which, the operations and the bytes."""
    tz = args[5].cpu().numpy()
    c8 = args[6].cpu().numpy().astype(bool)
    ops = 0
    for lg in (5, 4, 3):
        n = 1 << lg
        tus = int((c8 & (tz == lg)).sum()) // (n // 8) ** 2
        ops += tus * 4 * (n ** 3 + 2 * (n // 2) ** 3)
    slots4 = int((c8 & (tz == 2)).sum())      # four luma 4x4, one chroma
    ops += slots4 * 4 * (4 * 4 ** 3 + 2 * 4 ** 3)
    g = enc.geom
    nbytes = tz.shape[0] * g.h * g.w * 3 // 2 * 4
    ops_ms, bytes_ms = ops / int32_per_s * 1e3, nbytes / bytes_per_s * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops=ops, bytes=nbytes)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0]) * 1e6


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
    the planned form's ms, then the kernel form's with its graphs
    captured anew, under torch.cuda.set_sync_debug_mode("error") (nothing
    read back to the host): the ms of the call that captures and, with
    replay, of a call that only replays, and of the last call's kernel
    launches alone (CUDA events around each). Each kernel-form call's 13
    planes must equal the planned form's (ValueError naming the planes
    that differ). Also the capture ms, the graphs' nodes, the replays and
    kernel launches (from trace.counters()), the diagonals and the peak
    memory of the kernel-form calls."""
    row = {}
    row["planned_ms"], want = cuda_ms(lambda: enc._reconstruct_planned(
        *args))
    enc._stage2.clear()
    counted = trace.counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch = stage2_ctu.launch
    for call in ("capture_call_ms", "replay_call_ms")[: 1 + replay]:
        events = []

        def timed(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            launch(*a)
            ev[1].record()
            events.append(ev)

        stage2_ctu.launch = timed
        try:
            row[call], got = cuda_ms(
                lambda: enc._reconstruct_traced(*args), "error")
        finally:
            stage2_ctu.launch = launch
        row["kernel_ms"] = sum(a.elapsed_time(b) for a, b in events)
        bad = sorted(k for k in want.keys() | got.keys()
                     if k not in want or k not in got
                     or not torch.equal(want[k], got[k]))
        if len(want) != 13 or bad:
            raise ValueError("the kernel form of stage 2 differs from the "
                             f"planned one in {bad or sorted(want)}")
    wf, = enc._stage2.values()
    now = {k: v - counted[k] for k, v in trace.counters().items()}
    row.update(capture_ms=now["stage2.capture_ms"],
               nodes=now["stage2.graph_nodes"],
               replays=now["stage2.replays"],
               kernel_launches=now["stage2.kernel_launches"],
               diagonals=wf.diagonals,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--one-pass", action="store_true",
                    help="encode in one pass (one reconstruction)")
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
                         two_pass=not args.one_pass)
    enc.collect(enc.encode_fused_dispatch(cnn, y, u, v))
    E.FrameEncoder._reconstruct = real
    traced = enc.geom.wavefront[0].shape[0] * STEPS_PER_DIAGONAL
    for i, a in enumerate(calls, 1):
        c = planned_steps(enc, a[:8])
        print(f"reconstruction {i}: {c['all']} steps planned "
              f"({c['luma']} luma, {c['chroma']} chroma: "
              f"{c['luma'] + c['chroma']} TU calls); eager traced form "
              f"{traced} TU calls")
    print("stage ms:", {k: round(ms, 3) for k, ms in enc.stage_ms().items()})
    if enc.device.type != "cuda":
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    int32_per_s = INT32_LANES * sm_clock_hz()
    for i, a in enumerate(calls, 1):
        row = time_forms(enc, a)
        row.update(bound(enc, a, int32_per_s, HBM_BYTES_PER_S))
        print(f"reconstruction {i} on the card:", json.dumps(row))


if __name__ == "__main__":
    main()
