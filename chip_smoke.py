#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (hevctpu_torch) runs its main path on
one NVIDIA GPU: the default CNN-pruned All-Intra encode at QP 32.

Phases (each fails the run with a nonzero exit):
  1. the card's name and power limit; build every CUDA kernel from the
     checkout's sources (nvcc, sm_90a);
  2. K1 (fused SATD mode search) against its plain PyTorch version on the
     card, n in {4, 8, 16, 32} x {luma, chroma}, at M = 1, 37, one tile
     + 1 and the M of a 1080p frame: bit-identical; then, at the main
     path's two shapes (1080p and 416x240 x 8), bit-identical again on
     the timed inputs, and kernel and plain-version times beside K1's
     bound (bytes, integer instructions);
  3. ConvNet2 labels on the card equal the CPU port's on a 416x240 frame;
  4. the main path at 416x240, 8 frames: encode_fused_dispatch + collect +
     encode_stream, decoded back with the hash SEI verifying, K1 launched
     4 times per batch; fps, per-stage ms, bytes, PSNR;
  5. the same at 1920x1080, 1 frame;
  6. one 416x240 frame encoded on the card and on the CPU port: the
     streams must be byte-identical.
Then one JSON line of the kernels, and the last line
{"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py
It exits nonzero, printing no result, without CUDA or without the repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
QP = 32
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES = 132 * 64           # H100 SXM: 132 SMs x 64 INT32 lanes
#                                  (Hopper white paper), at the SM clock
M_1080P = {4: 130560, 8: 32640, 16: 8160, 32: 2040}   # 1920x1088 blocks
M_416X240X8 = {4: 57344, 8: 14336, 16: 3584, 32: 896}  # 8 x 256x448


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Device ms per call of fn, warm. A ~10 ms spin kernel goes first so
    the host queues every call before the card reaches the first: the
    events then time the calls back to back, without host gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k1_inputs(rng, m: int, n: int, device):
    import torch
    from hevctpu_torch.ops import intra, intra_mm

    def ext():
        return torch.as_tensor(rng.integers(0, 256, (m, 2 * n + 1)),
                               dtype=torch.int32)

    top_e, left_e = ext(), ext()
    top_f, left_f = intra.smooth_reference(top_e, left_e, n)
    refs = intra_mm.pack_refs(top_e, left_e, top_f, left_f).contiguous()
    orig = torch.as_tensor(rng.integers(0, 256, (m, n * n)),
                           dtype=torch.int32)
    return refs.to(device), orig.to(device)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no SM clock: {out.stdout!r} {out.stderr!r}")


def k1_bound(n: int, m: int, sm_hz: float):
    """(bytes s, operations s, bytes, operations) of one K1 call: refs and
    orig read once, costs written once; one integer instruction (a
    multiply-add) per nonzero entry of P, plus per pixel and mode the
    2-D Hadamard butterfly adds, one magnitude and one sum, over the
    card's INT32 lanes. The count is the algorithm's, whatever unit runs
    it."""
    from hevctpu_torch.ops import intra_mm
    k = 8 * n + 5
    nbytes = m * (k + n * n + 35) * 4
    nnz = int(np.count_nonzero(intra_mm.prediction_tensor(n, True)[0]))
    s = 4 if n == 4 else 8
    ops = m * (nnz + 35 * n * n * (2 * int(np.log2(s)) + 2))
    return nbytes / HBM_BYTES_PER_S, ops / (INT32_LANES * sm_hz), nbytes, ops


def phase_k1(rng, dev, sm_hz):
    import torch
    from hevctpu_torch.ops import satd_fused
    max_err = 0
    for n in (4, 8, 16, 32):
        for is_luma in (True, False):
            for m in (1, 37, satd_fused.tile_rows(n) + 1, M_1080P[n]):
                refs, orig = k1_inputs(rng, m, n, dev)
                got = satd_fused.mode_satd_costs(refs, orig, n,
                                                 is_luma=is_luma)
                want = satd_fused.mode_satd_costs_ref(refs, orig, n,
                                                      is_luma=is_luma)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                log(f"  K1 n={n:2d} {'luma  ' if is_luma else 'chroma'} "
                    f"M={m:6d}: max |kernel - plain| = {err}")
                if err:
                    fail(f"K1 disagrees with its plain version (n={n}, "
                         f"luma={is_luma}, M={m})")
    shapes = {}
    for shape, ms_of in (("1920x1080", M_1080P), ("416x240x8", M_416X240X8)):
        tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                   bound_ms=0.0)
        per_n = {}
        for n in (4, 8, 16, 32):
            m = ms_of[n]
            refs, orig = k1_inputs(rng, m, n, dev)
            err = int((satd_fused.mode_satd_costs(refs, orig, n).long()
                       - satd_fused.mode_satd_costs_ref(refs, orig, n).long())
                      .abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f"K1 disagrees with its plain version on the timed "
                     f"inputs ({shape}, n={n}, M={m}): max |err| {err}")
            t_k = cuda_ms(lambda: satd_fused.mode_satd_costs(refs, orig, n),
                          50)
            t_p = cuda_ms(lambda: satd_fused.mode_satd_costs_ref(refs, orig,
                                                                 n), 5)
            t_b, t_o, nbytes, ops = k1_bound(n, m, sm_hz)
            bound = max(t_b, t_o) * 1e3
            row = dict(M=m, ms=t_k, plain_ms=t_p, bytes_ms=t_b * 1e3,
                       ops_ms=t_o * 1e3, bound_ms=bound,
                       share_of_bound=bound / t_k, bytes=nbytes, ops=ops)
            per_n[n] = row
            for key in tot:
                tot[key] += row[key]
            log(f"  K1 {shape} n={n:2d} M={m:6d}: max |kernel - plain| = "
                f"{err}; kernel {t_k:.4f} ms, plain "
                f"{t_p:.4f} ms, bound: bytes {t_b * 1e3:.4f} ms ({nbytes} B)"
                f", integer ops {t_o * 1e3:.4f} ms ({ops}); kernel at "
                f"{bound / t_k:.3f} of the bound")
        tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
        log(f"  K1 {shape} all n: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms, "
            f"kernel at {tot['share_of_bound']:.3f} of the bound")
        shapes[shape] = dict(total=tot, per_n=per_n)
    hd = shapes["1920x1080"]["total"]
    return dict(max_abs_err=max_err, ms=hd["ms"], plain_ms=hd["plain_ms"],
                bound_ms=hd["bound_ms"],
                bound_by=("operations" if hd["ops_ms"] >= hd["bytes_ms"]
                          else "bytes"), shapes=shapes)


def load_cnn(device):
    from hevctpu_torch.models import checkpoint, convnet2
    params = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    return convnet2.load_model(params, device)


def run_path(h, w, frames, cnn, dev, label):
    """One batch of the main path; returns (stats, output dict, stream)."""
    import torch
    from hevctpu_torch.codec import decoder, headers
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    y, u, v = clips.clip_sine(frames, h, w, seed=0)
    enc = FrameEncoder(h, w, QP, device=dev)
    cfg = headers.StreamConfig(width=w, height=h, qp=QP,
                               hash_type="checksum")
    satd_fused.LAUNCHES = 0
    t0 = time.perf_counter()
    out = enc.collect(enc.encode_fused_dispatch(cnn, y, u, v))
    t1 = time.perf_counter()
    stream = decoder.encode_stream(cfg, [out])
    t2 = time.perf_counter()
    launches = satd_fused.LAUNCHES
    stages = enc.stage_ms()
    if launches != 4:
        fail(f"{label}: K1 launched {launches} times for one batch, not 4")
    dec = decoder.Decoder()
    got = dec.decode(stream)
    if not (dec.hashes_ok and all(dec.hashes_ok) and len(got) == frames):
        fail(f"{label}: decoder hash SEI did not verify")
    for i, (ry, ru, rv) in enumerate(got):
        if not ((ry == out["recon_y"][i]).all()
                and (ru == out["recon_u"][i]).all()
                and (rv == out["recon_v"][i]).all()):
            fail(f"{label}: decoded frame {i} differs from the recon")
    for k in ("recon_y", "levels_y", "sse"):
        if not np.isfinite(out[k].astype(np.float64)).all():
            fail(f"{label}: non-finite {k}")
    mse = out["sse"][:, 0].astype(np.float64) / (h * w)
    psnr = float(np.mean(10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-9))))
    stats = dict(frames=frames, fps=frames / (t2 - t0),
                 encode_s=t1 - t0, cabac_ms=(t2 - t1) * 1e3,
                 stage_ms={k: round(v, 3) for k, v in stages.items()},
                 bytes=len(stream), psnr_y=psnr, k1_launches=launches,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"  {label}: {json.dumps(stats)}")
    return stats, out, stream


def first_difference(a: dict, b: dict):
    for k in sorted(set(a) & set(b)):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or not np.array_equal(x, y):
            idx = (np.argwhere(x != y)[0].tolist() if x.shape == y.shape
                   else "shape")
            return k, idx
    return None


def cost_margin(y, u, v, dev):
    """Largest |card - CPU| stage-1 RD cost of the dense mode decision on
    one frame, per block size: the float disagreement behind a flip."""
    import torch
    from hevctpu_torch.pipeline import encoder as E
    g = E.Geometry(y.shape[-2], y.shape[-1])
    res = {}
    per = []
    for d in (dev, torch.device("cpu")):
        yp = E.pad_plane(torch.as_tensor(y.astype(np.int32)).to(d),
                         g.hp, g.wp)
        per.append(E._dense_mode_decision(yp, g, QP)[1])
    for n in per[0]:
        res[n] = float((per[0][n].cpu() - per[1][n]).abs().max())
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from hevctpu_torch.ops import satd_fused
    except ImportError as e:
        print(f"chip_smoke: the hevctpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    if any(m == "jax" or m.startswith(("jax.", "hevctpu."))
           or m == "hevctpu" for m in sys.modules):
        fail("the port imported jax or hevctpu")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    build_s, ptxas = satd_fused.build()
    log(f"  K1 built in {build_s:.2f} s (nvcc, sm_90a); ptxas -v:")
    for line in ptxas.splitlines():
        log(f"    {line.strip()}")
    sm_hz = sm_clock_hz()
    log(f"  max SM clock {sm_hz / 1e6:.0f} MHz: {INT32_LANES * sm_hz:.4g} "
        f"INT32 instructions/s")

    rng = np.random.default_rng(0)
    log("phase 2: K1 against its plain version on the card "
        "(tolerance 0: bit-identical)")
    k1 = phase_k1(rng, dev, sm_hz)

    log("phase 3: ConvNet2 labels, card vs CPU (416x240)")
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.pipeline import clips
    cnn = load_cnn(dev)
    cnn_cpu = load_cnn("cpu")
    y, u, v = clips.clip_sine(1, 240, 416, seed=0)
    lab = []
    for model, d in ((cnn, dev), (cnn_cpu, torch.device("cpu"))):
        planes = [torch.as_tensor(p.astype(np.int32)).to(d) for p in (y, u, v)]
        lab.append(convnet2.predict_frame_labels(model, *planes, 240,
                                                 416).cpu().numpy())
    if not np.array_equal(lab[0], lab[1]):
        fail(f"ConvNet2 labels differ card vs CPU at "
             f"{np.argwhere(lab[0] != lab[1])[:4].tolist()}")
    log(f"  labels equal ({lab[0].size} labels)")

    log("phase 4: main path, 416x240 x 8 frames")
    launches = 0
    torch.cuda.reset_peak_memory_stats()
    sd, _, _ = run_path(240, 416, 8, cnn, dev, "416x240")
    launches += sd["k1_launches"]

    log("phase 5: main path, 1920x1080 x 1 frame")
    torch.cuda.reset_peak_memory_stats()
    hd, _, _ = run_path(1080, 1920, 1, cnn, dev, "1920x1080")
    launches += hd["k1_launches"]

    log("phase 6: one 416x240 frame, card vs CPU port")
    from hevctpu_torch.codec import decoder, headers
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    cfg = headers.StreamConfig(width=416, height=240, qp=QP,
                               hash_type="checksum")
    outs, streams = [], []
    for model, d in ((cnn, dev), (cnn_cpu, "cpu")):
        enc = FrameEncoder(240, 416, QP, device=d)
        outs.append(enc.encode_fused(model, y, u, v))
        streams.append(decoder.encode_stream(cfg, [outs[-1]]))
    if streams[0] != streams[1]:
        diff = first_difference(outs[0], outs[1])
        margin = cost_margin(y, u, v, dev)
        fail(f"card and CPU streams differ: first field {diff}; max "
             f"|card - CPU| stage-1 RD cost per size {margin}")
    log(f"  streams byte-identical ({len(streams[0])} bytes)")

    kernels = [dict(name="satd_mode_costs", route="cuda",
                    source="hevctpu_torch/csrc/satd_fused.cu",
                    replaces="hevctpu/ops/satd_fused.py:119",
                    launches=launches, max_abs_err=k1["max_abs_err"],
                    ms=k1["ms"], plain_ms=k1["plain_ms"],
                    bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
                    library_ms=None)]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"paths": {"416x240": sd, "1920x1080": hd},
                      "k1_build_s": build_s, "k1": k1["shapes"],
                      "sm_clock_hz": sm_hz}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
