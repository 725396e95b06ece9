"""One run of one cell: set-up, the measured window, the check, and the
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the metrics are the cell's end-to-end ones (fps,
peak_mem_gib, setup_s); with --trace 1 its per-layer ones, each read by
metrics/<name>.py from the run's record, with a torch.profiler slice of
the window (trace.py). Every run checks its outputs (check.py) and prints
each number compared beside its limit as the last lines of stderr and
under "checks", the last key of the result line, the last line of stdout.
Without CUDA, or with fewer cards than the cell asks for, or with a
forbidden module loaded once the window has closed, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cellbench import check, roofline, spec, traffic

# Top-level module names that may not be loaded in a run: JAX and the
# JAX package the port was made from (compared whole: hevctpu_torch is
# the system under test).
FORBIDDEN = ("jax", "jaxlib", "flax", "hevctpu")
# Host threads of torch's CPU ops during set-up and the window (the
# program's host work is its worker's launches, collect and the native
# coder); the check afterwards takes every core.
WINDOW_THREADS = 2
# Build and kernel caches, at fixed paths inside the checkout, for a
# program that compiles through torch's extension loader or Triton (later
# changes may; this one does not). K1's nvcc build and the native coder's
# g++ build already live at fixed paths inside the program's package.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}
GIB = float(1 << 30)


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def chips_present(need: int) -> str | None:
    """None when `need` CUDA cards are visible, else why not."""
    import torch
    if not torch.cuda.is_available():
        return "CUDA is not available"
    if torch.cuda.device_count() < need:
        return (f"the cell needs {need} cards, {torch.cuda.device_count()} "
                "visible")
    return None


def record(cell, mix, res, trace, peaks) -> dict:
    """What the per-layer readers read."""
    cfg = cell.config
    return dict(
        height=cfg["height"], width=cfg["width"], batch=mix.batch,
        batches=[dict(frames=b.frames, host_ms=b.host_ms, stage_ms=sm,
                      tusz8=b.out["tusz8"], coded8=b.out["coded8"])
                 for b, sm in zip(res["batches"], res["stage_ms"])],
        trace=trace, peaks=peaks)


def run(argv=None, *, t_start: float, device: str = "cuda",
        chip_check=chips_present, root: str | None = None) -> int:
    args = _args(argv)
    cell = spec.cell(args.workload, root=root)
    why_not = chip_check(cell.chips)
    if why_not:
        print(f"benchmark: {why_not}; no result", file=sys.stderr)
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(spec.HERE, "_cache", sub)

    import torch

    torch.set_num_threads(WINDOW_THREADS)
    mix = traffic.Mix.from_dict(cell.traffic)
    weights = os.path.join(root or spec.ROOT, cell.config["weights"])

    from cellbench import trace as tracing
    from cellbench import window

    s = window.build(cell.config, mix, args.seed, weights, device)
    window.warm_up(s)
    res = window.run(s, args.seconds)
    setup_s = res["t0"] - t_start
    warmup_s = s.warmup_s
    on_card = s.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(s.device) if on_card else 0
    # each dispatch's stage clock (CUDA events), read after the window
    res["stage_ms"] = [b.clock.ms() for b in res["batches"]]
    reduced, trace_s = None, {}
    if args.trace:
        tracer = tracing.Tracer()
        window.traced_batch(s, len(res["batches"]), tracer)
        reduced = tracer.reduce()
        trace_s = tracer.seconds
    kind = torch.cuda.get_device_name(s.device) if on_card else "cpu"
    rec = record(cell, mix, res, reduced, roofline.PEAKS.get(kind))

    served = [dict(family=b.family, frames=b.frames, labels=b.out["labels"],
                   out=b.out, stream=b.stream) for b in res["batches"]]
    pool = s.pool
    del s
    check.free_device()
    torch.set_num_threads(os.cpu_count() or 1)
    t_check = time.perf_counter()
    judged = check.judge(cell.config, mix, weights, pool, served, args.seed,
                         device)
    t_done = time.perf_counter()
    correct, rows = check.verdict(judged["numbers"], cell.limits)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m.name)(rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        e2e = dict(fps=res["frames"] / res["window_s"], peak_mem_gib=peak / GIB,
                   setup_s=setup_s)
        metrics = {m.name: {"value": e2e[m.name], "unit": m.unit}
                   for m in cell.end_to_end}
    dev = dict(platform="gpu" if on_card else "cpu", kind=kind,
               count=cell.chips, memory_peak_bytes=peak)
    if reduced is not None:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    line = dict(correct=bool(correct), attempted=res["frames"],
                failed=judged["wrong"], metrics=metrics, device=dev)
    if reduced is not None:
        line["breakdown"] = dict(
            device_ops=[[n, t] for n, t in reduced["top_kernels"]],
            idle_gaps=[[n, t] for n, t in reduced["gaps"]])
    line["checks"] = rows

    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    print(f"benchmark: {args.workload} seed {args.seed}: {res['frames']} "
          f"frames in {res['window_s']:.3f} s, {len(res['batches'])} "
          f"batches, set-up {setup_s:.3f} s (warm-up batch "
          f"{warmup_s:.3f} s), sampled frames checked {judged['checked']}, "
          f"check seconds {judged['seconds']}; after the window: trace "
          f"{trace_s}, to the check {t_check - res['t0'] - res['window_s']:.3f}"
          f" s, check {t_done - t_check:.3f} s, run {t_done - t_start:.3f} s",
          file=sys.stderr)
    print("benchmark: batches (s to the stream, host ms, stage ms): "
          + json.dumps([[round(b.done_s, 3), round(b.host_ms, 1),
                         {k: round(v, 1) for k, v in sm.items()}]
                        for b, sm in zip(res["batches"], res["stage_ms"])]),
          file=sys.stderr)
    for err in judged.get("decode_errors", []):
        print(f"benchmark: decode error: {err}", file=sys.stderr)
    for k, r in rows.items():
        print(f"check {k} {r['value']!r} limit {r['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
