"""Collective bytes of the (frame, tile) mesh, counted as they move, and
the scaling-efficiency model (the logic of tools/scaling_model.py; the
command line is tools/scaling_model_torch.py).

The JAX tool compiles its sharded step on a virtual mesh and sums the
output bytes of every collective in the optimized HLO. The port's step
is no single program to read: run_world encodes a batch on a gloo world
of ranks, and each rank's Mesh tallies the bytes its collectives move
(Mesh.tally). model() is the JAX tool's efficiency model, its formulas
unchanged, fed the H100's figures.
"""

from __future__ import annotations

import datetime
import json
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from hevctpu_torch.pipeline.profile import PEAK_BF16_TFLOPS

QP = 32
NVLINK_GBS = 450.0       # each way, a GPU
HOST_GBS = 50.0          # between hosts, a GPU
CONSTANTS = {
    "bf16_tflops": dict(value=PEAK_BF16_TFLOPS, source=(
        "NVIDIA H100 SXM5 data sheet: 989 TFLOP/s BF16 dense, at 700 W "
        "(hevctpu_torch/pipeline/profile.py PEAK_BF16_TFLOPS)")),
    "ici_gbs": dict(value=NVLINK_GBS, source=(
        "NVIDIA H100 SXM5 data sheet: NVLink 900 GB/s a GPU, both "
        "directions together; 450 GB/s each way")),
    "dcn_gbs": dict(value=HOST_GBS, source=(
        "NVIDIA DGX H100 data sheet: one 400 Gb/s ConnectX-7 port a GPU "
        "between hosts, 50 GB/s")),
}
# the tally's ops under the names the JAX tool reads from HLO
JAX_OPS = {"halo": "collective-permute", "all-gather": "all-gather"}
BITSTREAM_BYTES_PER_FRAME = 0.2e6   # the JAX tool's coded payload a frame


def analytic_flops(frames: int, h: int, w: int) -> int:
    """The JAX tool's analytic count of a batch's search compute: ~35
    modes x 4 sizes x 2*8 MAC/pel SATD, and as much again for the
    candidate RD."""
    return frames * h * w * 35 * 4 * 2 * 8 * 2 * 2


def model(shape: dict, total_coll: float, bf16_tflops: float,
          ici_gbs: float, dcn_gbs: float) -> dict:
    """tools/scaling_model.py's model block from a shape (h, w, batch)
    and the tile axis's collective bytes: compute at the BF16 peak, the
    bytes over the link inside a host, the tile axis's efficiency, and
    the two-host frame-parallel efficiency when each host ships only its
    coded stream (BITSTREAM_BYTES_PER_FRAME a frame) between hosts."""
    b = shape["batch"]
    t_compute_s = analytic_flops(b, shape["h"], shape["w"]) / (
        bf16_tflops * 1e12)
    t_ici_s = total_coll / (ici_gbs * 1e9)
    t_dcn_s = BITSTREAM_BYTES_PER_FRAME * b / (dcn_gbs * 1e9)
    return {
        "t_compute_s_at_peak": t_compute_s,
        "t_ici_s": t_ici_s,
        "tile_axis_efficiency": t_compute_s / (t_compute_s + t_ici_s),
        "two_host_frame_parallel_efficiency":
            t_compute_s / (t_compute_s / 1 + t_dcn_s),
        "ici_gbs": ici_gbs, "dcn_gbs": dcn_gbs, "bf16_tflops": bf16_tflops,
    }


def rank_main(rank: int, job: dict, init: str, results):
    """One rank of the world: make_mesh(tile=job["tile"]), then one
    ShardedEncoder encode (fixed depth 1, QP 32) of batch x frame-axis
    frames of clips.clip_sine seed 0 at h x w; puts (rank, result) or
    (rank, traceback) on results. The ranks share the host's cores: one
    torch thread each."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        from hevctpu_torch.ops import satd_fused
        from hevctpu_torch.parallel import ShardedEncoder, make_mesh
        from hevctpu_torch.pipeline import clips, trace
        dev = job["device"]
        if dev == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=job["world"],
            timeout=datetime.timedelta(seconds=job["deadline_s"]))
        mesh = make_mesh(tile=job["tile"])
        h, w = job["h"], job["w"]
        frames = job["batch"] * mesh.frame
        y, u, v = clips.clip_sine(frames, h, w, seed=0)
        sh = ShardedEncoder(h, w, QP, mesh, fixed_depth=1,
                            device=None if dev == "cuda" else dev)
        mesh.reset_tally()
        satd_fused.LAUNCHES = 0
        before = trace.counters()
        t0 = time.perf_counter()
        out = sh.encode(y, u, v)
        wall = time.perf_counter() - t0
        after = trace.counters()
        s2, s3 = (after[k] - before[k] for k in (
            "stage2.kernel_launches", "stage1.rd_kernel_launches"))
        res = dict(coords=[mesh.frame_index, mesh.tile_index],
                   tally=mesh.tally, wall_s=wall,
                   stage_ms=sh.enc.stage_ms(),
                   k1_launches=satd_fused.LAUNCHES, s2_launches=s2,
                   s3_launches=s3, device=str(sh.enc.device),
                   checksums=out["hash_checksum"].tolist())
        dist.destroy_process_group()
        results.put((rank, res))
    except Exception:                     # reported to the parent
        results.put((rank, traceback.format_exc()))


def run_world(job: dict, target=None) -> tuple[dict, float]:
    """Spawn job["world"] ranks of target(rank, job, init, results)
    (rank_main by default) around a file:// rendezvous init, and return
    ({rank: result}, the world's wall seconds). Each rank puts (rank,
    result) or (rank, traceback text) on results. A failed rank, or a
    world that outlives job["deadline_s"], raises RuntimeError after
    every rank is killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    n = job["world"]
    got, err = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=target or rank_main, daemon=True,
                             args=(r, job, init, results)) for r in range(n)]
        t0 = time.perf_counter()
        deadline = t0 + job["deadline_s"]
        try:
            for p in procs:
                p.start()
            while len(got) < n and err is None:
                try:
                    rank, res = results.get(
                        timeout=max(0.1, deadline - time.perf_counter()))
                except queue.Empty:
                    err = (f"no result from ranks "
                           f"{sorted(set(range(n)) - set(got))} within "
                           f"{job['deadline_s']} s")
                    continue
                if isinstance(res, str):
                    err = f"rank {rank} failed:\n{res}"
                got[rank] = res
            wall = time.perf_counter() - t0
        finally:
            # ranks that reported end on their own; after a failure the
            # others are not waited for
            started = [p for p in procs if p.pid is not None]
            for p in started if err is None else ():
                p.join(timeout=max(0.1, deadline - time.perf_counter()))
            for p in started:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    if err or any(p.is_alive() for p in procs):
        raise RuntimeError(f"world of {n} ranks: {err or 'a rank outlived '
                           'its kill'}")
    return got, wall


def scaling_report(job: dict, ranks: dict, wall_s: float,
                   device: str) -> dict:
    """SCALING_TORCH.json: the JAX tool's keys from the ranks' tallies,
    the tile axis counted on its busiest rank, the frame axis's gather
    on a line of its own, and the run's ranks."""
    checks = {tuple(map(tuple, r["checksums"])) for r in ranks.values()}
    if len(checks) != 1:
        raise RuntimeError("the ranks returned different picture "
                           "checksums for the same batch")
    tile = job["tile"]
    fr = job["world"] // tile
    b = job["batch"] * fr
    shape = {"h": job["h"], "w": job["w"], "batch": b, "tile": tile,
             "frame_axis": fr}
    tile_bytes = {r: {JAX_OPS[op]: axes["tile"]["bytes"]
                      for op, axes in res["tally"].items() if "tile" in axes}
                  for r, res in ranks.items()}
    busiest = max(sorted(ranks), key=lambda r: sum(tile_bytes[r].values()))
    coll = tile_bytes[busiest]
    total = sum(coll.values())
    gather = ranks[busiest]["tally"].get("all-gather", {}).get(
        "frame", dict(calls=0, bytes=0, sent=0, received=0))
    return {
        "shape": shape,
        "collective_bytes": coll,
        "collective_bytes_total": total,
        "collective_bytes_per_frame": total / b,
        "analytic_flops": analytic_flops(b, job["h"], job["w"]),
        "model": model(shape, total, *(CONSTANTS[k]["value"] for k in (
            "bf16_tflops", "ici_gbs", "dcn_gbs"))),
        "frame_axis_gather": dict(
            gather, t_between_hosts_s=gather["bytes"] / (HOST_GBS * 1e9)),
        "rank_counted": busiest,
        "constants": CONSTANTS,
        "run": {"device": device, "world": job["world"], "backend": "gloo",
                "wall_s": wall_s, "qp": QP, "fixed_depth": 1,
                "clip": "clips.clip_sine seed 0"},
        "ranks": [dict(rank=r, **ranks[r]) for r in sorted(ranks)],
    }


def _jax_record(root: str):
    """(shape, total bytes) of the JAX tool's SCALING.json, or None."""
    path = os.path.join(root, "SCALING.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    return rec["shape"], rec["collective_bytes_total"]


def scaling_markdown(doc: dict, root: str) -> str:
    """SCALING_TORCH.md: the tally, the model, how the count differs
    from the JAX tool's, and the run's own seconds."""
    s, m, run = doc["shape"], doc["model"], doc["run"]
    b, total = s["batch"], doc["collective_bytes_total"]
    per_frame_kb = total / b / 1024
    gather = doc["frame_axis_gather"]
    lines = [
        "# SCALING_TORCH — collective bytes of the port's mesh, counted as "
        "they moved, and the efficiency model",
        "",
        f"Encoded {b} frames at {s['h']}x{s['w']} (fixed depth 1, QP "
        f"{run['qp']}, {run['clip']}) with hevctpu_torch.parallel."
        f"ShardedEncoder on mesh (frame={s['frame_axis']}, "
        f"tile={s['tile']}): {run['world']} {run['backend']} ranks on "
        f"{run['device']}. Each rank's Mesh tallied the bytes of its "
        "collectives as they moved; the tile axis of the busiest rank "
        f"(rank {doc['rank_counted']}):",
        "",
        "| collective | bytes/batch |",
        "|---|---|",
    ]
    for k, v in sorted(doc["collective_bytes"].items()):
        lines.append(f"| {k} | {v:,} |")
    lines += [
        f"| **total** | **{total:,}** ({per_frame_kb:.1f} KiB/frame) |",
        "",
        (f"Frame axis: {gather['bytes']:,} bytes a rank in "
         f"{gather['calls']} all-gathers ({gather['received']:,} of them "
         "from other ranks): ShardedEncoder.encode gathers every output "
         "onto every rank of the frame axis, bytes the JAX step, whose "
         "outputs stay sharded, does not move; "
         f"{gather['t_between_hosts_s']:.6f} s at "
         f"{HOST_GBS:.0f} GB/s between hosts." if s["frame_axis"] > 1
         else "Frame axis: one rank a tile; nothing is gathered."),
        "",
        "| rank | (frame, tile) | halo | all-gather tile | all-gather "
        "frame | K1 launches | wall s | stage ms |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in doc["ranks"]:
        t = r["tally"]
        cell = [t.get(op, {}).get(ax, {}).get("bytes", 0)
                for op, ax in (("halo", "tile"), ("all-gather", "tile"),
                               ("all-gather", "frame"))]
        stages = ", ".join(f"{k} {v:.1f}" for k, v in r["stage_ms"].items())
        lines.append(f"| {r['rank']} | ({r['coords'][0]}, {r['coords'][1]})"
                     f" | {cell[0]:,} | {cell[1]:,} | {cell[2]:,} | "
                     f"{r['k1_launches']} | {r['wall_s']:.3f} | {stages} |")
    lines += [
        "",
        "## Model",
        "",
        f"* Tile axis (inside a host, NVLink): {per_frame_kb:.1f} KiB/frame "
        f"of halo and width-gather traffic vs "
        f"~{doc['analytic_flops'] / b / 1e9:.1f} GFLOP/frame of search "
        f"compute -> communication/compute time ratio "
        f"{m['t_ici_s'] / max(m['t_compute_s_at_peak'], 1e-12):.4f}; "
        f"tile-axis efficiency ~{100 * m['tile_axis_efficiency']:.1f}% "
        "(the JAX tool's formula; bounded in practice by the wavefront's "
        "load imbalance and stage 2's per-diagonal steps, not bytes).",
        f"* Frame axis (2 hosts): All-Intra frames are independent; with "
        "only the coded stream (~0.2 MB/frame) between hosts the modeled "
        f"2-host efficiency is "
        f"{100 * m['two_host_frame_parallel_efficiency']:.1f}%. The port's "
        "gather of every output (above) is not in this model.",
        "",
        "Specs used (sources in the JSON's `constants`): H100 SXM5 "
        f"~{m['bf16_tflops']:.0f} BF16 TFLOP/s, NVLink ~{m['ici_gbs']:.0f} "
        f"GB/s each way a GPU, ~{m['dcn_gbs']:.0f} GB/s a GPU between "
        "hosts.",
        "",
        "## What the two tools count",
        "",
        "The bytes above are what moved in one encode, summed where they "
        "moved: the halo exchange after every wavefront diagonal, the "
        "width gather of stage 2's outputs and the frame gather, with "
        "stage 1 and the loop filters replicated across a tile group. "
        "tools/scaling_model.py counts something else: the output shapes "
        "of the collectives in the optimized HLO text of the compiled JAX "
        "step, a static count in which the body of a `lax.scan` (its "
        "halo ppermutes) appears once, and GSPMD's stage-1 all-to-all and "
        "all-gathers appear as well.",
    ]
    jax = _jax_record(root)
    if jax is not None:
        js, jt = jax
        lines.append(
            f"Its SCALING.md holds {jt:,} bytes at {js['h']}x{js['w']}, "
            f"mesh (frame={js['frame_axis']}, tile={js['tile']}), batch "
            f"{js['batch']}. The two totals are not one quantity measured "
            "twice.")
    lines += [
        "",
        "## The run",
        "",
        f"World wall {run['wall_s']:.3f} s on {run['device']}; each "
        "rank's wall seconds and stage ms (one encode, the rank's first, "
        "stage 2 including its exchanges and the width gather) are in the "
        "table above. Ranks that share one card share its time and the "
        "host's cores: these seconds show no speed-up and claim none.",
    ]
    return "\n".join(lines) + "\n"
