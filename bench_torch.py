"""Benchmark of the PyTorch/CUDA port: All-Intra encode throughput
(frames/s) on one card.

The port of bench.py: the same operating points (416x240 x 64 frames in
batches of 32, and 1088x1920 x 16 in batches of 8, QP 32, the legacy
clip_sine clip with seed 0, CKPT_DOMAIN.npz), the same call per batch
(encode_fused_dispatch and collect with lite=True, then host CABAC with
the checksum hash SEI), the same warm-up pass, median of reps on the host
clock, and the same metric lines against the HM 16.20 anchor's
single-thread fps (BASELINE_MEASURED.json / BASELINE_1080P.json). Those
anchor figures were taken on another host, so vs_baseline sets the
card's fps against HM seconds measured elsewhere.

bench.py's double-buffering is kept: every batch's dispatch first,
then per batch collect and encode_stream. encode_fused_dispatch returns
once the batch is uploaded (the encode runs on the encoder's worker
thread, batches in dispatch order), so batch k's collect and host CABAC
overlap the encode of the batches after it, as in bench.py. They share
the host with the worker's stage-2 loop: the CABAC coder (ctypes)
releases the GIL, the stream headers and the lite unpacking (Python and
numpy) contend for it. The detail file gives each batch's dispatch ms
(to the dispatch's return) and stream ms (encode_stream) of the last
pass.

Prints the 1080p line as the last line of stdout and the 416x240 line on
stderr (with --points naming one point, that point's line is the last
line of stdout). Every point goes to the detail file (--out, default
BENCH_DETAIL_TORCH.json; never BENCH_DETAIL.json, the JAX package's
record) with the card's name and power limit, frames, batch, reps and
warm-up as run, each cut from bench.py's defaults, each rep's fps, the
stage ms of one warm-up batch, the dispatch and stream ms of each batch
of the last pass and the peak device memory.

Flags cut a run (every default is bench.py's): --points, --frames,
--batch, --reps, --warmup batch (one batch of the point's shape; the
port builds K1 once and compiles nothing per shape), --out.

    python3 bench_torch.py                       # bench.py's points, on the card
    python3 bench_torch.py --points 416x240 --batch 8 --out BENCH_DETAIL_TORCH_B8.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

H, W, QP = 240, 416, 32
FRAMES = 64
BATCH = 32
REPS = 3

H2, W2 = 1088, 1920
FRAMES2 = 16
BATCH2 = 8
REPS2 = 3

# HM 16.20 TAppEncoder, All-Intra main, single CPU thread fallbacks
# (bench.py's; the baseline files replace them).
DEFAULT_ANCHOR_FPS = 1.3
DEFAULT_ANCHOR_1080P_FPS = 0.1

ROOT = os.path.dirname(os.path.abspath(__file__))
DETAIL = "BENCH_DETAIL_TORCH.json"
WARMUP = "full"

# bench.py's two points: geometry, defaults, metric and anchor.
POINTS = {
    "416x240": dict(h=H, w=W, frames=FRAMES, batch=BATCH, reps=REPS,
                    metric="ai_encode_fps_416x240_qp32",
                    baseline=("BASELINE_MEASURED.json", "hm_ai_416x240_fps",
                              DEFAULT_ANCHOR_FPS)),
    "1080p": dict(h=H2, w=W2, frames=FRAMES2, batch=BATCH2, reps=REPS2,
                  metric="ai_encode_fps_1080p_qp32",
                  baseline=("BASELINE_1080P.json", "hm_ai_1080p_fps",
                            DEFAULT_ANCHOR_1080P_FPS)),
}


def synth_clip(n, h, w, seed=0):
    """bench.py's legacy clip (hevctpu_torch.pipeline.clips.clip_sine)."""
    from hevctpu_torch.pipeline import clips
    return clips.clip_sine(n, h, w, seed=seed)


def _load_params():
    """ConvNet2 params in bench.py's order: CKPT_DOMAIN.npz, else the
    reference .pt checkpoint, else init_params(0). Returns (params, the
    source's name)."""
    from hevctpu_torch import config
    from hevctpu_torch.models import checkpoint, convnet2
    dom = os.path.join(ROOT, "CKPT_DOMAIN.npz")
    if os.path.exists(dom):
        return checkpoint.load(dom), "CKPT_DOMAIN.npz"
    model_path = os.path.join(ROOT, config.DEFAULT_MODEL)
    if os.path.exists(model_path):
        return convnet2.load_torch_params(model_path), config.DEFAULT_MODEL
    return convnet2.init_params(0), "init_params(0)"


def measure(params, h, w, frames, batch, reps, qp=QP, *, device=None,
            warmup=WARMUP):
    """bench.py's measure on the port: returns the median fps, the sorted
    rep fps and a dict of the run (the last pass's streams, one per
    batch; the warm-up batch's stage ms; each batch's dispatch and
    stream ms in the last pass; peak device memory; K1 launches of one
    timed pass; stage 2's counters over the run, trace.counters()'s
    stage2.* keys: captures, capture ms, graph nodes, replays,
    evictions and kernel launches (all 0 on the CPU); the device's
    label). device is cuda
    unless the caller names the CPU; without CUDA it raises. warmup
    "full" is one untimed pass of every batch (bench.py's), "batch" one
    batch."""
    from hevctpu_torch import get_device
    from hevctpu_torch.codec import decoder as streamlib
    from hevctpu_torch.codec import headers
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline import evaluate, trace
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    if warmup not in ("full", "batch"):
        raise ValueError(f"warmup must be full|batch, got {warmup!r}")
    if reps < 1:
        raise ValueError(f"reps must be at least 1, got {reps}")
    dev = get_device(device)
    counted = trace.counters()
    y, u, v = synth_clip(frames, h, w)
    enc = FrameEncoder(h, w, qp, device=dev)
    cnn = convnet2.load_model(params, dev)
    cfg = headers.StreamConfig(width=w, height=h, qp=qp,
                               hash_type="checksum")
    spans = [(i, min(i + batch, frames)) for i in range(0, frames, batch)]

    def run_all(spans, stage_ms=None, timing=None):
        # bench.py's double-buffering: every batch dispatched (each
        # dispatch returns once its batch is uploaded), then drained: batch
        # k's collect and CABAC overlap the encode of the later batches.
        # stage_ms, when given, takes the first batch's stage times, read
        # right after its dispatch: stage_ms() waits for that batch, so
        # the second batch is dispatched only after it (warm-up only).
        # timing, when given, takes each batch's ms to the dispatch's
        # return and its encode_stream ms.
        pend = []
        for i, j in spans:
            t0 = time.perf_counter()
            pend.append(enc.encode_fused_dispatch(cnn, y[i:j], u[i:j],
                                                  v[i:j], lite=True))
            if timing is not None:
                timing["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
            if stage_ms is not None and len(pend) == 1:
                stage_ms.update(enc.stage_ms())
        streams = []
        for dev_out in pend:
            out = enc.collect(dev_out, lite=True)
            t0 = time.perf_counter()
            streams.append(streamlib.encode_stream(cfg, [out]))
            if timing is not None:
                timing["stream_ms"].append((time.perf_counter() - t0) * 1e3)
        return streams

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    stage_ms = {}
    t0 = time.perf_counter()
    run_all(spans if warmup == "full" else spans[:1], stage_ms)
    warmup_s = time.perf_counter() - t0
    fps, rep_s = [], []
    for _ in range(reps):
        k1_before = satd_fused.LAUNCHES
        timing = dict(dispatch_ms=[], stream_ms=[])
        t0 = time.perf_counter()
        streams = run_all(spans, timing=timing)
        rep_s.append(time.perf_counter() - t0)
        fps.append(frames / rep_s[-1])
    fps.sort()
    run = dict(streams=streams, batches=len(spans),
               device=evaluate.device_label(dev), warmup_s=warmup_s,
               rep_s=rep_s,
               warmup_stage_ms=stage_ms, **timing,
               k1_launches_per_pass=satd_fused.LAUNCHES - k1_before,
               peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
               stage2_counters={k: v - counted[k]
                                for k, v in trace.counters().items()
                                if k.startswith("stage2.")})
    return fps[len(fps) // 2], fps, run


def _baseline(path, key, default):
    p = os.path.join(ROOT, path)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f).get(key, default)
    return default


def cuts(point: str, frames: int, batch: int, reps: int, warmup: str) -> dict:
    """Each setting of a run that differs from bench.py's default, as
    {name: {"default": ..., "run": ...}}."""
    p = POINTS[point]
    want = dict(frames=p["frames"], batch=p["batch"], reps=p["reps"],
                warmup=WARMUP)
    got = dict(frames=frames, batch=batch, reps=reps, warmup=warmup)
    return {k: {"default": want[k], "run": got[k]} for k in want
            if got[k] != want[k]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", choices=("416x240", "1080p", "both"),
                    default="both")
    ap.add_argument("--frames", type=int, help="frames a point (default "
                    "bench.py's: 64 at 416x240, 16 at 1080p)")
    ap.add_argument("--batch", type=int, help="frames a batch (default "
                    "bench.py's: 32 and 8)")
    ap.add_argument("--reps", type=int, help="timed passes (default 3)")
    ap.add_argument("--warmup", choices=("full", "batch"), default=WARMUP)
    ap.add_argument("--out", default=os.path.join(ROOT, DETAIL),
                    help="detail file (default BENCH_DETAIL_TORCH.json)")
    args = ap.parse_args(argv)
    names = list(POINTS) if args.points == "both" else [args.points]

    params, weights = _load_params()
    lines, detail = [], {"points": []}
    for name in names:
        p = POINTS[name]
        frames = args.frames or p["frames"]
        batch = args.batch or p["batch"]
        reps = args.reps or p["reps"]
        fps, reps_fps, run = measure(params, p["h"], p["w"], frames, batch,
                                     reps, warmup=args.warmup)
        anchor = _baseline(*p["baseline"])
        line = {"metric": p["metric"], "value": round(fps, 3),
                "unit": "frames/s", "vs_baseline": round(fps / anchor, 3)}
        lines.append(line)
        if name != names[-1]:
            print(json.dumps(line), file=sys.stderr, flush=True)
        detail["points"].append(dict(
            line, anchor_fps=anchor, anchor_file=p["baseline"][0],
            rep_fps=[round(f, 3) for f in reps_fps], fps=fps,
            rep_fps_unrounded=reps_fps, rep_s=run["rep_s"],
            card=run["device"], h=p["h"], w=p["w"], qp=QP, frames=frames,
            batch=batch, batches=run["batches"], reps=reps,
            warmup=args.warmup, cuts=cuts(name, frames, batch, reps,
                                          args.warmup),
            weights=weights, warmup_s=run["warmup_s"],
            warmup_batch_stage_ms=run["warmup_stage_ms"],
            dispatch_ms=run["dispatch_ms"], stream_ms=run["stream_ms"],
            peak_mem_bytes=run["peak_mem_bytes"],
            stage2_counters=run["stage2_counters"],
            k1_launches_per_pass=run["k1_launches_per_pass"],
            stream_bytes=[len(s) for s in run["streams"]],
            torch=torch.__version__, cuda=torch.version.cuda))
    with open(args.out, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps(lines[-1]))


if __name__ == "__main__":
    main()
