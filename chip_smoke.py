#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (hevctpu_torch) runs its main path on
one NVIDIA GPU: the default CNN-pruned All-Intra encode at QP 32.

Phases (each fails the run with a nonzero exit):
  1. the card's name and power limit; build every CUDA kernel from the
     checkout's sources (nvcc, sm_90a);
  2. K1 (fused SATD mode search) against its plain PyTorch version on the
     card, n in {4, 8, 16, 32} x {luma, chroma}, at M = 1, 37, one tile
     + 1 and every M the paths below launch it at: bit-identical (the
     run records each launch's shape and fails on one not checked
     here); then, at the main
     path's two shapes (1080p and 416x240 x 8), two small grids
     (416x240 x 2, 128x64 x 2) and bench_torch.py's batches (416x240 x
     32, 1088x1920 x 8), bit-identical again on the timed inputs,
     and kernel and plain-version times beside K1's bound (bytes, integer
     instructions); and the gather-form predictor
     intra.predict_all_modes, on the card, as the oracle of the matmul
     form (intra_mm.predict_all_modes_mm) K1's tap table comes from, at
     every n, luma and chroma;
 2b. stage 1's candidate-RD kernel (ops/stage1_rd.py) against its plain
     version (encoder._dense_rd_plain) on the card at the main path's
     shapes (416x240 x 32, 1088x1920 x 8): one stage-1 decision's 25
     calls, bit-identical costs; then the 25 launches timed beside the
     plain version's and the bound (the forward transforms' multiply-adds
     at the INT32 rate);
  3. ConvNet2 labels on the card equal the CPU port's on a 416x240 frame;
  4. the main path at 416x240, 8 frames: encode_fused_dispatch + collect +
     encode_stream, decoded back with the hash SEI verifying, K1 launched
     4 times per batch; fps, per-stage ms, bytes, PSNR;
  5. the same at 1920x1080, 1 frame;
  6. one 416x240 frame encoded on the card and on the CPU port: the
     streams must be byte-identical;
  7. the command line, python -m hevctpu_torch encode --search rd, in
     process on a 416x240 x 2 YUV file with configs/encoder_intra_main.cfg
     (one batch), then decode: the hash SEI verifies, the decoded YUV
     equals --recon byte for byte, K1 launched 4 times; fps, stage ms,
     bytes, PSNR-Y; frame 0 encoded with search="rd" on the card and on
     the CPU port: streams byte-identical, recon equal to the CLI's;
  8. the command line with R-λ rate control and per-CTU QP
     (--target-kbps 1000, LCULevelRateControl : 1, CNN labels) on the
     same file: the hash verifies, more than one CTU QP is coded; the
     per-picture QPs and the achieved kbps;
  9. search="rd" with a random per-CTU QP map at 128x192 x 2 on the card
     and on the CPU port: the streams must be byte-identical;
 10. the serving options at one 416x240 frame (CNN labels, one batch):
     (a) rate_model="ctx" and (b) two_pass=True, each decoded back with
     the hash SEI verifying and the decoded YUV equal to the recon, K1
     launched 4 and 8 times; (c) bench.py's call, encode_fused_dispatch +
     collect with lite=True and the checksum hash, against the same batch
     with lite=False: every shared key equal, the streams byte-identical,
     the device->host bytes of both dicts printed; and stage 1 alone,
     warm, under each rate model (CUDA events);
 11. rate_model="ctx" with search="rd", and two_pass=True with
     search="rd", at 128x192 x 2 on the card and on the CPU port: the
     streams must be byte-identical;
 12. the training path: (a) python -m hevctpu_torch train, in process,
     on phase 7's file (3 epochs from CKPT_DOMAIN.npz): K1 launched 4
     times for the full-RD labels, the checkpoint's shapes, frame 0
     encoded with the trained ConvNet2 and decoded with the hash SEI
     verifying; (b) make_dataset of one 1920x1080 frame (2040 samples,
     CNN labels) card = CPU, one step's float32 gradients against
     float64, and ConvNet2 trained at batch 256 (2 epochs, 14 steps) on
     the card and on the CPU port from the same initial weights, in
     float32 and in float64, within the bounds below, the card run
     twice; (c) the warm step time (CUDA events), samples/s and peak
     memory beside the step's FP32 bound;
 13. the multi-device encoder (hevctpu_torch.parallel.ShardedEncoder), in
     worlds of ranks spawned from this process, each rank computing on
     the one card: (a) two gloo ranks, mesh (frame=2, tile=1), phase 4's
     416x240 x 8 batch, every key equal to phase 4's dict and the stream
     byte-identical; (b) two gloo ranks, mesh (frame=1, tile=2), a
     1920x256 clip_sine frame (1080p's width, 15 CTU columns a tile, 4
     of its 17 CTU rows; stage 2 per tile with halo exchanges), equal to
     the single-process encode likewise; (c) one NCCL rank,
     mesh (1, 1), 128x192 x 2, equal to the single-process encode. Each
     rank launches K1 4 times at shapes phase 2 held; its stage ms and
     the transport are printed. Two ranks share the card, so their times
     are no speedup;
 14. hevctpu_torch.ops.inter (motion compensation, motion search, MV
     bits, weighted prediction, merge candidates) on a 416x240 pair of
     clip_sine frames on the card against the CPU port: integers bit for
     bit, wp_acdc's AC within a relative 1e-6;
 15. the calibration path (pipeline/calibrate.py, behind
     tools/*_torch.py) on the card at the tools' 416x240, one clip, one
     QP: (a) the rate-weight samples of a 1-frame full-RD encode (exact
     CABAC bits, bin features that reproduce estimate_tu_bits on the
     card) and their ridge fit, (b) the context count table of a 1-frame
     encode, (c) the domain dataset of 1 frame of full-RD labels and 1
     epoch of ConvNet2 from CKPT_DOMAIN.npz; K1 launched 4 times each;
     then all three at 64x128 x 1 on the card and on the CPU port:
     integers equal, 1 epoch of training within phase 12b's bounds;
 16. the evaluation path (pipeline/evaluate.py, pipeline/profile.py,
     behind tools/*_torch.py): (a) the corpus protocol on pink at 416x240
     x 8, QPs 22/27/32/37, CKPT_DOMAIN.npz: the port's cnn points (kbps,
     PSNR Y/U/V, seconds), equal to the JAX tool's points in
     RD_PINK_CNN_JAX.json, their BD-rate and BD-PSNR against the HM anchor
     and the pruned HM cached in CORPUS_HM.json and the time saving, K1
     launched 4 times a QP; (b) cnn and rd points, one QP of each
     gap-attribution variant and frame 0's per-syntax-element
     bits at 64x128 x 1 and QP 32, card = CPU port exactly; (c) the per-stage
     profile at 416x240, cut to 1 frame and 1 rep; the phase's seconds;
 17. the scaling path (hevctpu_torch.parallel's byte tally and
     tools/scaling_model_torch.py): (a) four gloo ranks, mesh (frame=1,
     tile=4), at tests/test_sharded_hd.py's width 768 (3 CTU columns a
     tile) and 4 of its 17 CTU rows (256), one clip_sine frame at fixed depth 1: every key equal to the
     single-process encode on the card and the stream byte-identical,
     each rank's tally the closed form of its tile (an edge tile's halos
     from one neighbour, a middle tile's from two); (b) the tool's main
     at 128x512, mesh (2, 4), one frame a rank: the JAX tool's keys,
     every rank's tally the closed form and its checksums the
     single-process encode's, the model block equal to the formulas at
     the H100's figures; the ranks' wall seconds and stage ms;
 18. bench_torch.py's measure (bench.py's throughput path: every batch's
     encode_fused_dispatch with lite=True, then collect and encode_stream
     with the checksum hash), warm-up one batch, 1 rep: (a) at one
     416x240 frame, its stream byte-identical to phase 6's card stream
     (same clip, QP and checkpoint; lite against full); (b) at 416x240 x
     4 in two batches of 2, double-buffered (the second dispatch
     returns while the first batch encodes on the worker thread), each
     stream byte-identical to its batch encoded alone one after another,
     and every dispatch returning in under a tenth of a batch's time
     (the ms to each dispatch's return and each batch's ms are printed);
     K1 launched 4 times a batch at shapes phase 2 held; the fps beside
     each cut from bench.py's defaults and the card's name and power
     limit;
 19. stage 2's two forms on the card, on the arguments phases 4 and 5
     recorded (416x240 x 8, 1920x1080 x 1): the host-planned form and
     the kernel form (the traced form's gather and scatter captured anew
     as CUDA graphs, the stage-2 kernel between them, each CTU and plane
     coding only its own TUs), run under
     torch.cuda.set_sync_debug_mode("error"), so that nothing is read
     back to the host: all 13 planes equal; the ms of both forms and of
     the kernel's launches alone, the capture ms, the graphs' nodes and
     replays, the kernel launches and the peak memory; stage 2's bound
     there (the coded TUs' transform multiply-adds at the INT32 rate,
     or the planes' bytes at HBM's).
Every encode on the card above runs stage 2 in the kernel form; the
card-vs-CPU checks hold it to the CPU's planned form. Each path that
checks K1's launches also checks the stage-2 kernel's: one a wavefront
diagonal of each stage-2 run (an encode runs stage 2 once, twice under
two_pass; a rank's tile walks every diagonal of the picture); and stage
1's RD kernel's: one for each call of encoder._dense_rd_candidates on
the card under the global rate model (25 a stage-1 decision, none under
rate_model="ctx"), never more than 25 for each 4 of K1's launches.
Then one JSON line of the paths, one of the kernels (K1's, the stage-2
kernel's and stage 1's RD kernel's launches summed over the paths 4, 5,
7, 8, 9, 10, 11's card encodes, 12a, 13's ranks, 15, 16, 17 and 18), the
card's name and power limit, and the last line {"ok": true, "device":
{...}}.

Run from the repository root: python3 chip_smoke.py
It exits nonzero, printing no result, without CUDA or without the repo.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
QP = 32
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES = 132 * 64           # H100 SXM: 132 SMs x 64 INT32 lanes
#                                  (Hopper white paper), at the SM clock
FP32_LANES_PER_SM = 128          # Hopper SM: 128 FP32 lanes, one FMA
#                                  (2 FLOP) each per clock
# Card vs CPU training bounds (phase 12b). Float64 holds the algorithm:
# the same weights to rounding. In float32, one step's gradients of
# conv1 and conv64 (sums of 256 x 1024 or 4096 terms that nearly cancel)
# are 1e-4 to 4e-4 off the float64 ones on either device
# (tools/train_precision.py), and Adam turns a near-zero gradient of the
# wrong sign into a full step, so over 14 steps one small tensor can part
# far (conv1's bias by 0.13 relative L2 on the card) while the loss, the
# accuracy and the weights as a whole agree: those are bounded, and the
# per-tensor gaps printed.
TRAIN_F32_GRAD = 1e-3            # one step's gradients vs float64, per tensor
TRAIN_F32_LOSS = 1e-3            # relative, per epoch
TRAIN_F32_MODEL = 1e-2           # relative L2 of all weights together
TRAIN_F64 = 1e-13                # weights per tensor and loss, float64
TRAIN_ACC = 2 / 2048             # absolute, per epoch
INTER_AC_RTOL = 1e-6             # wp_acdc's float32 AC, card vs CPU


def k1_rows(h: int, w: int, frames: int) -> dict:
    """K1's M per n on an encode: one row per n x n block of the frames
    padded to multiples of 64."""
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    return {n: frames * (hp // n) * (wp // n) for n in (4, 8, 16, 32)}


M_1080P = k1_rows(1080, 1920, 1)
M_416X240X8 = k1_rows(240, 416, 8)
# The other grids the paths launch K1 at: phase 13a's ranks (4 frames
# each of phase 4's 8), one picture per encode (phases 6-8, 10, 15, 18a:
# the rate controller encodes one at a time), the QP-map fixture (phase
# 9), the CLI's one batch of 2 frames (phase 7) and phase 18b's batches
# of 2, the card-vs-CPU size of phases 15 and 16b, the tile-2 frame of
# 13b and the tile-4 frame of 17a (12 CTU columns, 3 a tile, 4 rows);
# the scaling tool at a cut size (mesh (2, 4), one frame a rank) and its
# closed form's single-process encode of the two frames. bench_torch.py's
# batches at bench.py's points: 416x240 x 32 and 1088x1920 x 8.
# Depth cuts that keep the script inside half its 1200 s on a slow host
# (each path keeps its widths and its checks):
CLI_FRAMES = 2              # phases 7, 8 and 12a's file, cut from 4
OPTIONS_FRAMES = 1          # phase 10's batch, cut from 4
# 13b: 1080p's width (15 CTU columns a tile), 4 of its 17 CTU rows
TILE2_JOB = dict(h=256, w=1920, frames=1, tile=2, clip="sine")
# 17a: tests/test_sharded_hd.py's width 768, 4 of its 17 CTU rows
TILE4_JOB = dict(h=256, w=768, frames=1, tile=4, clip="sine", fixed_depth=1)
SCALING_ARGV = ["--h", "128", "--w", "512", "--tile", "4", "--world", "8",
                "--batch", "1"]
M_PATHS = [M_1080P, M_416X240X8, k1_rows(240, 416, 4), k1_rows(240, 416, 1),
           k1_rows(128, 192, 2), k1_rows(240, 416, 2), k1_rows(64, 128, 1),
           k1_rows(256, 1920, 1), k1_rows(256, 768, 1),
           k1_rows(128, 512, 1), k1_rows(128, 512, 2),
           k1_rows(240, 416, 32), k1_rows(1088, 1920, 8)]
# (n, M, luma) of every K1 launch after phase 2, to show each was held
# against the plain version there.
K1_LAUNCHED = set()
# The stage-2 kernel's launches on each path checked below, by the path's
# label: one a wavefront diagonal of every stage-2 run there.
S2_LAUNCHED = {}


def diagonals(h: int, w: int) -> int:
    """Wavefront diagonals d = 2r + c over an h x w picture's CTU rows r
    and columns c; every tile of a mesh walks all of them."""
    return 2 * (-(-h // 64) - 1) + -(-w // 64)


def s2_launches() -> int:
    """The stage-2 kernel's launches in this process so far."""
    from hevctpu_torch.pipeline import trace
    return trace.counters()["stage2.kernel_launches"]


def check_s2(label: str, since: int, h: int, w: int, runs: int) -> int:
    """Since the reading `since` (s2_launches()), the stage-2 kernel must
    have launched once a diagonal of each of `runs` stage-2 runs at h x w
    (an encode runs stage 2 once, twice under two_pass; none on the
    CPU). Records the launches under label and returns them."""
    n = s2_launches() - since
    want = runs * diagonals(h, w)
    if n != want:
        fail(f"{label}: the stage-2 kernel launched {n} times, not {want} "
             f"({runs} stage-2 run(s) of {diagonals(h, w)} diagonals)")
    S2_LAUNCHED[label] = S2_LAUNCHED.get(label, 0) + n
    return n


# Calls of encoder._dense_rd_candidates on the card under the global rate
# model, each of which must be one launch of stage 1's RD kernel
# (record_s3_calls counts them), and the kernel's launches on each path
# checked below, by the path's label.
S3_EXPECTED = [0]
S3_LAUNCHED = {}
# the kernel's launches a stage-1 decision: 4 luma sizes, the 64x64 CU's
# 32x32 TUs, 12 TU-tree sizes, 4 chroma sizes x 2 planes; K1 launches 4
S3_PER_DECISION = 25


def s3_mark() -> tuple:
    """(stage 1's RD kernel launches so far, the calls so far that must
    have launched it)."""
    from hevctpu_torch.pipeline import trace
    return trace.counters()["stage1.rd_kernel_launches"], S3_EXPECTED[0]


def check_s3(label: str, since: tuple, k1: int) -> int:
    """Since the mark `since` (s3_mark()), stage 1's RD kernel must have
    launched once for every candidate-RD call on the card under "global"
    (none under "ctx" or on the CPU), at most 25 for each 4 of K1's k1
    launches (a decision). Records the launches under label and returns
    them."""
    got, want = (now - then for now, then in zip(s3_mark(), since))
    if got != want or got > S3_PER_DECISION * k1 // 4:
        fail(f"{label}: stage 1's RD kernel launched {got} times for {want} "
             f"candidate-RD calls on the card under the global rate model "
             f"and {k1} K1 launches")
    S3_LAUNCHED[label] = S3_LAUNCHED.get(label, 0) + got
    return got


def record_s3_calls():
    """Wrap encoder._dense_rd_candidates so that every call that must go
    through stage 1's RD kernel is counted in S3_EXPECTED."""
    from hevctpu_torch.pipeline import encoder as E
    calls = E._dense_rd_candidates

    def recording(plane, *a, **k):
        if plane.device.type == "cuda" and k.get("rate_model") == "global":
            S3_EXPECTED[0] += 1
        return calls(plane, *a, **k)

    E._dense_rd_candidates = recording


def record_k1_shapes():
    """Wrap K1's launch so the paths' shapes are recorded; the launch and
    its counter are the wrapper's own."""
    from hevctpu_torch.ops import satd_fused
    launch = satd_fused._mode_satd_costs_cuda

    def recording(refs, orig_flat, n, is_luma):
        K1_LAUNCHED.add((n, int(refs.shape[0]), bool(is_luma)))
        return launch(refs, orig_flat, n, is_luma)

    satd_fused._mode_satd_costs_cuda = recording


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
    checked = set()
    for n in (4, 8, 16, 32):
        for is_luma in (True, False):
            for m in sorted({1, 37, satd_fused.tile_rows(n) + 1}
                            | {ms[n] for ms in M_PATHS}):
                checked.add((n, m, is_luma))
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
    for shape, ms_of in (("1920x1080", M_1080P), ("416x240x8", M_416X240X8),
                         ("416x240x2", k1_rows(240, 416, 2)),
                         ("128x64x2", k1_rows(64, 128, 2)),
                         ("416x240x32", k1_rows(240, 416, 32)),
                         ("1088x1920x8", k1_rows(1088, 1920, 8))):
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
                          else "bytes"), shapes=shapes, checked=checked)


# stage 1's RD kernel at the main path's shapes (bench_torch.py's batches)
S3_JOBS = ((240, 416, 32), (1088, 1920, 8))


def stage1_rd_calls() -> list:
    """(n, luma, K) of the candidate-RD calls of one stage-1 decision
    (FrameEncoder._decide under "global"), in its order: 4 luma sizes (K1's
    top 8 or 3 and the 3 MPMs), the 64x64 CU's four 32x32 TUs, 12 TU-tree
    sizes at the CU's one mode, 4 chroma sizes x 2 planes (the 4 list
    modes and DM)."""
    calls = [(32, True, 6), (16, True, 6), (8, True, 11), (4, True, 11),
             (32, True, 6)]
    for cu_log2 in (6, 5, 4, 3):
        calls += [(1 << s, True, 1)
                  for s in range(max(2, cu_log2 - 3), min(cu_log2, 5) + 1)]
    for n in (64, 32, 16, 8):
        calls += [(n // 2, False, 5)] * 2
    return calls


def phase_stage1_rd(dev, sm_hz) -> dict:
    """Stage 1's RD kernel against its plain version (_dense_rd_plain, on
    the card) at the main path's shapes: one decision's 25 calls on
    clip_sine planes, random candidate modes, QP 32, bit-identical costs;
    then the 25 launches timed (CUDA events) beside the plain version's
    and the bound: the forward transforms' multiply-adds (2 n^3 a
    candidate) at the INT32 rate. Returns {shape: row}."""
    import torch
    from hevctpu_torch import rom
    from hevctpu_torch.ops import rate, stage1_rd
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline import encoder as E
    rng = np.random.default_rng(19)
    qp_c = rom.chroma_qp_from_luma(QP)
    lam = rate.lambda_rd(QP)
    lam_c = lam / rate.chroma_dist_weight(QP, qp_c)
    calls = stage1_rd_calls()
    res = {}
    for h, w, frames in S3_JOBS:
        g = E.Geometry(h, w)
        y, u, v = (torch.as_tensor(p.astype(np.int32), device=dev)
                   for p in clips.clip_sine(frames, h, w, seed=0))
        planes = (E.pad_plane(y, g.hp, g.wp).contiguous(),
                  E.pad_plane(u, g.hp // 2, g.wp // 2).contiguous(),
                  E.pad_plane(v, g.hp // 2, g.wp // 2).contiguous())
        args, macs = [], 0
        for i, (n, luma, k) in enumerate(calls):
            plane = planes[0] if luma else planes[1 + i % 2]
            r, c = plane.shape[1] // n, plane.shape[2] // n
            cand = torch.as_tensor(rng.integers(0, 35, (frames, r, c, k)),
                                   dtype=torch.int32, device=dev)
            kw = dict(is_luma=luma, scale=1 if luma else 2,
                      rate_model="global")
            args.append((plane, g, n, cand, QP if luma else qp_c,
                         lam if luma else lam_c, kw))
            macs += frames * r * c * k * 2 * n ** 3
        before = stage1_rd.LAUNCHES
        for i, (plane, g_, n, cand, qp, lm, kw) in enumerate(args):
            got = E._dense_rd_candidates(plane, g_, n, cand, qp, lm, **kw)
            want = E._dense_rd_plain(plane, g_, n, cand, qp, lm, **kw)
            if not torch.equal(got, want):
                fail(f"stage 1's RD kernel differs from its plain version at "
                     f"{w}x{h} x {frames}, call {i} {calls[i]}: "
                     f"{int((got != want).sum())} of {got.numel()} costs, "
                     f"max {float((got - want).abs().max())}")
        if stage1_rd.LAUNCHES - before != len(calls):
            fail(f"stage 1's RD kernel launched {stage1_rd.LAUNCHES - before} "
                 f"times for {len(calls)} calls")
        t_k = cuda_ms(lambda: [E._dense_rd_candidates(p, g_, n, c, q, lm,
                                                       **kw)
                               for p, g_, n, c, q, lm, kw in args], 5)
        t_p = cuda_ms(lambda: [E._dense_rd_plain(p, g_, n, c, q, lm, **kw)
                               for p, g_, n, c, q, lm, kw in args], 1)
        bound = macs / (INT32_LANES * sm_hz) * 1e3
        shape = f"{w}x{h}x{frames}"
        res[shape] = dict(launches=len(calls), ms=t_k, plain_ms=t_p,
                          bound_ms=bound, share_of_bound=bound / t_k,
                          macs=macs)
        log(f"  stage 1 RD {shape}: {len(calls)} calls bit-identical to the "
            f"plain version; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound "
            f"{bound:.4f} ms ({macs} multiply-adds at the INT32 rate), "
            f"kernel at {bound / t_k:.4f} of the bound")
    return res


def phase_predict_oracle(rng, dev):
    """The gather-form predictor (intra.predict_all_modes) on the card is
    the oracle of the matmul form that K1's tap table comes from
    (intra_mm.predict_all_modes_mm): equal at every n, luma and chroma,
    on random and on flat references, and equal to the CPU's."""
    import torch
    from hevctpu_torch.ops import intra, intra_mm
    for n in (4, 8, 16, 32):
        for is_luma in (True, False):
            for flat in (False, True):
                m = 257
                if flat:   # smooth ramps: the 32x32 strong filter fires
                    base = rng.integers(20, 230, (m, 1))
                    top = base + np.arange(2 * n + 1)[None, :] // 16
                    left = top.copy()
                else:
                    top = rng.integers(0, 256, (m, 2 * n + 1))
                    left = rng.integers(0, 256, (m, 2 * n + 1))
                    left[:, 0] = top[:, 0]
                outs = []
                for d in (dev, torch.device("cpu")):
                    te, le = (torch.as_tensor(a, dtype=torch.int32).to(d)
                              for a in (top, left))
                    tf, lf = intra.smooth_reference(te, le, n)
                    want = intra.predict_all_modes(te, le, tf, lf, n,
                                                   is_luma=is_luma)
                    got = intra_mm.predict_all_modes_mm(te, le, tf, lf, n,
                                                        is_luma=is_luma)
                    if not torch.equal(got, want):
                        bad = (got != want).nonzero()[:4].tolist()
                        fail(f"predict_all_modes_mm differs from "
                             f"predict_all_modes on {d.type} (n={n}, "
                             f"luma={is_luma}, flat={flat}) at {bad}")
                    outs.append(want.cpu())
                if not torch.equal(outs[0], outs[1]):
                    fail(f"predict_all_modes differs card vs CPU (n={n}, "
                         f"luma={is_luma}, flat={flat})")
    log("  predict_all_modes_mm = predict_all_modes (the gather-form "
        "oracle) on the card and on the CPU, n in {4, 8, 16, 32}, luma and "
        "chroma")


def load_cnn(device):
    from hevctpu_torch.models import checkpoint, convnet2
    params = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    return convnet2.load_model(params, device)


def psnr_y(sse: np.ndarray, h: int, w: int) -> float:
    """Mean luma PSNR (dB) over frames from the encoder's per-plane SSE."""
    mse = sse[:, 0].astype(np.float64) / (h * w)
    return float(np.mean(10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-9))))


def run_path(h, w, frames, cnn, dev, label, want_launches=4, **options):
    """One batch of the main path (FrameEncoder options as given);
    returns (stats, output dict, stream)."""
    import torch
    from hevctpu_torch.codec import decoder, headers
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline.encoder import FrameEncoder

    y, u, v = clips.clip_sine(frames, h, w, seed=0)
    enc = FrameEncoder(h, w, QP, device=dev, **options)
    cfg = headers.StreamConfig(width=w, height=h, qp=QP,
                               hash_type="checksum")
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    t0 = time.perf_counter()
    out = enc.collect(enc.encode_fused_dispatch(cnn, y, u, v))
    t1 = time.perf_counter()
    stream = decoder.encode_stream(cfg, [out])
    t2 = time.perf_counter()
    launches = satd_fused.LAUNCHES
    stages = enc.stage_ms()
    if launches != want_launches:
        fail(f"{label}: K1 launched {launches} times for one batch, not "
             f"{want_launches}")
    s2 = check_s2(label, since, h, w, 2 if options.get("two_pass") else 1)
    s3 = check_s3(label, s3, launches)
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
    stats = dict(frames=frames, fps=frames / (t2 - t0),
                 encode_s=t1 - t0, cabac_ms=(t2 - t1) * 1e3,
                 stage_ms={k: round(v, 3) for k, v in stages.items()},
                 bytes=len(stream), psnr_y=psnr_y(out["sse"], h, w),
                 k1_launches=launches, s2_launches=s2, s3_launches=s3,
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


def cost_margin(y, u, v, dev, rate_model="global"):
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
        per.append(E._dense_mode_decision(yp, g, QP,
                                          rate_model=rate_model)[1])
    for n in per[0]:
        res[n] = float((per[0][n].cpu() - per[1][n]).abs().max())
    return res


def run_cli(argv, label):
    """The port's command line in this process (so K1's launch counter is
    readable): (stdout text, wall seconds). Fails on a nonzero exit."""
    from hevctpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    | {line}")
    if rc != 0:
        fail(f"{label}: python -m hevctpu_torch {argv[0]} exited {rc}")
    return text, wall


def parse_encode_log(text: str) -> dict:
    """Bytes, PSNR-Y, kbps, per-picture QPs and stage ms from the CLI's
    encode report."""
    stages = dict((k, float(v)) for k, v in re.findall(
        r"(\w+) ([0-9.]+)", text.split("Stage ms:")[1].splitlines()[0]))
    return dict(
        bytes=int(re.search(r"Bytes written to file: (\d+)", text)[1]),
        psnr_y=float(re.search(r"Y-PSNR +([0-9.]+)", text)[1]),
        kbps=float(re.search(r"Bitrate +([0-9.]+) kbps", text)[1]),
        qps=[int(q) for q in re.findall(r"I-SLICE, QP (\d+)", text)],
        stage_ms=stages)


def check_decode(bs: str, rec: str, out_dir: str, frames: int, label: str):
    """Decode through the CLI and the Decoder: every hash SEI verifies and
    the decoded YUV equals the encoder's recon byte for byte. Returns the
    Decoder (its per-picture CTU QP maps)."""
    from hevctpu_torch.codec import decoder
    dec_path = os.path.join(out_dir, "dec.yuv")
    run_cli(["decode", "-b", bs, "-o", dec_path], label)
    with open(dec_path, "rb") as f, open(rec, "rb") as g:
        if f.read() != g.read():
            fail(f"{label}: the decoded YUV differs from --recon")
    dec = decoder.Decoder()
    with open(bs, "rb") as f:
        got = dec.decode(f.read())
    if len(got) != frames or len(dec.hashes_ok) != frames \
            or not all(dec.hashes_ok):
        fail(f"{label}: the hash SEI did not verify on every picture")
    return dec


def phase_cli(tmp: str, extra, frames: int, label: str, want_launches: int,
              s2_runs: int):
    """One CLI encode of the 416x240 file + decode, K1 launched
    want_launches times and stage 2 run s2_runs times; returns its
    stats."""
    from hevctpu_torch.ops import satd_fused
    bs, rec = (os.path.join(tmp, f"{label}.{e}") for e in ("bin", "yuv"))
    argv = ["encode", "-c", os.path.join(ROOT, "configs",
                                         "encoder_intra_main.cfg"),
            "-i", os.path.join(tmp, "in416.yuv"), "--width", "416",
            "--height", "240", "-f", str(frames), "-b", bs, "--recon", rec,
            *extra]
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    text, wall = run_cli(argv, label)
    launches = satd_fused.LAUNCHES
    if launches != want_launches:
        fail(f"{label}: K1 launched {launches} times, not {want_launches}")
    s2 = check_s2(label, since, 240, 416, s2_runs)
    s3 = check_s3(label, s3, launches)
    dec = check_decode(bs, rec, tmp, frames, label)
    stats = parse_encode_log(text)
    stats.update(frames=frames, fps=frames / wall, wall_s=wall,
                 k1_launches=launches, s2_launches=s2, s3_launches=s3)
    return stats, dec


def rd_card_vs_cpu(dev, label, clip, cfg, want_launches=4, qp_map=None,
                   **options):
    """search="rd" encodes of clip (y, u, v [B, H, W]) on the card and on
    the CPU port with the given FrameEncoder options: the streams must be
    byte-identical, and the card must launch K1 want_launches times and
    the stage-2 kernel once a diagonal of each stage-2 run. Returns (the
    card's output dict, the stream, its K1 launches)."""
    from hevctpu_torch.codec import decoder
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    y, u, v = clip
    h, w = y.shape[-2:]
    outs, streams, launches = [], [], 0
    since, s3 = s2_launches(), s3_mark()
    for d in (dev, "cpu"):
        satd_fused.LAUNCHES = 0
        outs.append(FrameEncoder(h, w, QP, device=d, search="rd",
                                 **options).encode(y, u, v, qp_map=qp_map))
        launches = launches or satd_fused.LAUNCHES
        streams.append(decoder.encode_stream(cfg, [outs[-1]]))
    if launches != want_launches:
        fail(f"{label} card encode: K1 launched {launches} times, not "
             f"{want_launches}")
    check_s2(f"{label} card encode", since, h, w,
             2 if options.get("two_pass") else 1)
    check_s3(f"{label} card encode", s3, launches)
    if streams[0] != streams[1]:
        diff = first_difference(outs[0], outs[1])
        margin = cost_margin(y[:1], u[:1], v[:1], dev,
                             options.get("rate_model", "global"))
        fail(f"{label}: card and CPU streams differ: first field {diff}; "
             f"max |card - CPU| stage-1 RD cost per size {margin}")
    log(f"  {label}: card and CPU streams byte-identical "
        f"({len(streams[0])} bytes)")
    return outs[0], streams[0], launches


def rd_frame_card_vs_cpu(tmp: str, dev) -> int:
    """Frame 0 of the 416x240 file, search="rd", on the card and on the
    CPU port: the streams must be byte-identical, and the card's recon
    must equal frame 0 of the CLI's --recon. Returns the stream bytes."""
    from hevctpu_torch.codec import headers
    from hevctpu_torch.pipeline import yuv
    clip = [p.astype(np.int32) for p in yuv.read_yuv420(
        os.path.join(tmp, "in416.yuv"), 416, 240, 1)]
    cfg = headers.StreamConfig(width=416, height=240, qp=QP,
                               hash_type="checksum")
    out, stream, _ = rd_card_vs_cpu(dev, "frame 0, search=rd", clip, cfg)
    cli_rec = yuv.read_yuv420(os.path.join(tmp, "cli_rd.yuv"), 416, 240, 1)
    for k, plane in zip(("recon_y", "recon_u", "recon_v"), cli_rec):
        if not np.array_equal(out[k][0], plane[0]):
            fail(f"search=rd: the card's {k} differs from frame 0 of the "
                 f"CLI's --recon")
    log("  frame 0, search=rd: recon equal to the CLI's")
    return len(stream)


def cuqp_clip(h=128, w=192):
    """The 128x192 x 2 fixture of tests/test_cuqp.py."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([(128 + 70 * np.sin(yy / 6) * np.cos(xx / 9)
                   + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.int32)
                  for _ in range(2)])
    u = np.stack([(128 + 40 * np.cos(yy[::2, ::2] / 9)).astype(np.int32)] * 2)
    v = rng.integers(60, 200, (2, h // 2, w // 2)).astype(np.int32)
    return y, u, v


def phase_cuqp_card_vs_cpu(dev):
    """search="rd" with a random per-CTU QP map, card vs CPU port (the
    128x192 x 2 fixture of tests/test_cuqp.py)."""
    from hevctpu_torch.codec import headers
    qmap = np.random.default_rng(11).integers(QP - 3, QP + 4, (2, 2, 3))
    cfg = headers.StreamConfig(width=192, height=128, qp=QP,
                               cu_qp_delta=True)
    out, stream, launches = rd_card_vs_cpu(dev, "cu_qp_delta", cuqp_clip(),
                                           cfg, qp_map=qmap)
    qps = sorted(set(np.asarray(out["qp_ctu"]).ravel().tolist()))
    log(f"  coded CTU QPs {qps}")
    return dict(bytes=len(stream), ctu_qps=qps, k1_launches=launches)


def dict_bytes(d: dict) -> int:
    """Bytes of a dict of device tensors: what collect() moves to the
    host."""
    return sum(t.numel() * t.element_size() for t in d.values())


def phase_lite(cnn, dev):
    """bench.py's path at 416x240 x OPTIONS_FRAMES: encode_fused_dispatch +
    collect with lite=True, checksum hash SEI, against the same batch with
    lite=False. Returns (stats, K1 launches of both runs)."""
    import torch
    from hevctpu_torch.codec import decoder, headers
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    h, w, frames = 240, 416, OPTIONS_FRAMES
    y, u, v = clips.clip_sine(frames, h, w, seed=0)
    enc = FrameEncoder(h, w, QP, device=dev)
    cfg = headers.StreamConfig(width=w, height=h, qp=QP,
                               hash_type="checksum")
    res, launches = {}, 0
    for lite in (True, False):
        satd_fused.LAUNCHES = 0
        since, s3 = s2_launches(), s3_mark()
        t0 = time.perf_counter()
        dev_out = enc.encode_fused_dispatch(cnn, y, u, v, lite=lite)
        dev_out.result()              # the encode, on the worker thread
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nbytes = dict_bytes(dev_out)
        out = enc.collect(dev_out, lite=lite)
        t2 = time.perf_counter()
        stream = decoder.encode_stream(cfg, [out])
        t3 = time.perf_counter()
        if satd_fused.LAUNCHES != 4:
            fail(f"lite={lite}: K1 launched {satd_fused.LAUNCHES} times for "
                 f"one batch, not 4")
        check_s2(f"lite={lite}", since, h, w, 1)
        check_s3(f"lite={lite}", s3, satd_fused.LAUNCHES)
        launches += satd_fused.LAUNCHES
        res[lite] = (out, stream, dict(
            fps=frames / (t3 - t0), collect_ms=(t2 - t1) * 1e3,
            d2h_bytes=nbytes, bytes=len(stream),
            stage_ms={k: round(x, 3) for k, x in enc.stage_ms().items()}))
    (lite_out, lite_s, lite_st), (full_out, full_s, full_st) = res[True], \
        res[False]
    if "recon_y" in lite_out:
        fail("lite: the collected dict carries recon planes")
    if set(lite_out) != set(full_out) - {"recon_y", "recon_u", "recon_v"}:
        fail(f"lite: keys {sorted(set(lite_out) ^ set(full_out))} differ")
    for k in lite_out:
        a, b = np.asarray(lite_out[k]), np.asarray(full_out[k])
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"lite: {k} differs from the full path's")
    if lite_s != full_s:
        fail("lite and full streams differ")
    dec = decoder.Decoder()
    got = dec.decode(lite_s)
    if len(got) != frames or not all(dec.hashes_ok):
        fail("lite: the checksum hash SEI did not verify")
    for i, (ry, _, _) in enumerate(got):
        if not np.array_equal(ry, full_out["recon_y"][i]):
            fail(f"lite: decoded frame {i} differs from the full recon")
    stats = dict(frames=frames, bytes=len(lite_s),
                 psnr_y=psnr_y(lite_out["sse"], h, w), lite=lite_st,
                 full=full_st,
                 d2h_ratio=full_st["d2h_bytes"] / lite_st["d2h_bytes"],
                 k1_launches=launches)
    log(f"  lite: {json.dumps(stats)}")
    return stats, launches


def stage1_warm_ms(cnn, dev) -> dict:
    """Warm device ms of stage 1 (_decide) alone on the 416x240 batch
    with CNN labels, under each rate model: the mean of 3 calls after one
    warm-up call. Its K1 launches are not a path's."""
    import torch
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline import encoder as E
    h, w = 240, 416
    y, u, v = (torch.as_tensor(p.astype(np.int32)).to(dev)
               for p in clips.clip_sine(OPTIONS_FRAMES, h, w, seed=0))
    labels = convnet2.predict_frame_labels(cnn, y, u, v, h, w).to(
        torch.int32)
    res = {}
    for rate_model in ("global", "ctx"):
        enc = E.FrameEncoder(h, w, QP, device=dev, rate_model=rate_model)
        g = enc.geom
        planes = (E.pad_plane(y, g.hp, g.wp),
                  E.pad_plane(u, g.hp // 2, g.wp // 2),
                  E.pad_plane(v, g.hp // 2, g.wp // 2))
        res[rate_model] = cuda_ms(lambda: enc._decide(*planes, labels), 3)
    log(f"  stage 1 alone, warm, 416x240 x {OPTIONS_FRAMES}: global "
        f"{res['global']:.3f} "
        f"ms, ctx {res['ctx']:.3f} ms")
    return res


def phase_options_card_vs_cpu(dev):
    """rate_model="ctx" and two_pass=True, each with search="rd", on the
    128x192 x 2 fixture: card and CPU port streams byte-identical."""
    from hevctpu_torch.codec import headers
    cfg = headers.StreamConfig(width=192, height=128, qp=QP)
    stats = dict(k1_launches=0)
    for name, want, opts in (("ctx_rd", 4, dict(rate_model="ctx")),
                             ("two_pass_rd", 8, dict(two_pass=True))):
        _, stream, n = rd_card_vs_cpu(dev, name, cuqp_clip(), cfg, want,
                                      **opts)
        stats[name] = len(stream)
        stats["k1_launches"] += n
    return stats, stats["k1_launches"]


def phase_train_cli(tmp: str, dev):
    """python -m hevctpu_torch train on the 416x240 x CLI_FRAMES file, 3
    epochs from
    CKPT_DOMAIN.npz: K1 launched 4 times for the full-RD labels, the
    written checkpoint has init_params()'s shapes, and frame 0 encoded with
    the trained ConvNet2 decodes with the hash SEI verifying. Returns
    (stats, K1 launches)."""
    from hevctpu_torch.codec import decoder, headers
    from hevctpu_torch.models import checkpoint, convnet2
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline import yuv
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    src, ckpt = os.path.join(tmp, "in416.yuv"), os.path.join(tmp,
                                                              "trained.npz")
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    text, wall = run_cli(["train", "-i", src, "--width", "416", "--height",
                          "240", "-f", str(CLI_FRAMES), "-q", str(QP), "--epochs", "3",
                          "--init", os.path.join(ROOT, "CKPT_DOMAIN.npz"),
                          "-o", ckpt], "cli_train")
    launches = satd_fused.LAUNCHES
    if launches != 4:
        fail(f"cli_train: K1 launched {launches} times, not 4")
    # the full-RD labels encode the file in batches of 4 frames
    check_s2("cli_train labels", since, 240, 416, -(-CLI_FRAMES // 4))
    check_s3("cli_train labels", s3, launches)
    hist = [dict(epoch=int(e), loss=float(lo), acc=float(a)) for e, lo, a
            in re.findall(r"epoch (\d+): loss ([0-9.]+) acc ([0-9.]+)", text)]
    times = re.search(r"Train time: labels ([0-9.]+) s \| dataset ([0-9.]+) "
                      r"ms \| train ([0-9.]+) s \((\d+) samples\)", text)
    closing = re.search(r"trained 3 epochs, final acc [0-9.]+ -> .*", text)
    if len(hist) != 3 or times is None or closing is None:
        fail("cli_train: the report lacks the epochs, times or closing line")
    if int(times[4]) != CLI_FRAMES * 28 * 4:
        fail(f"cli_train: {times[4]} samples, not {CLI_FRAMES * 28 * 4}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"cli_train: non-finite loss in {hist}")
    params, want = checkpoint.load(ckpt), convnet2.init_params()
    for layer in want:
        for k in want[layer]:
            got = params[layer][k]
            if got.shape != want[layer][k].shape or got.dtype != np.float32 \
                    or not np.isfinite(got).all():
                fail(f"cli_train: {layer}/{k} is {got.dtype} {got.shape}")
    y, u, v = (p.astype(np.int32) for p in yuv.read_yuv420(src, 416, 240, 1))
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    out = FrameEncoder(240, 416, QP, device=dev).encode_fused(
        convnet2.load_model(params, dev), y, u, v)
    if satd_fused.LAUNCHES != 4:
        fail(f"cli_train: the trained model's encode launched K1 "
             f"{satd_fused.LAUNCHES} times, not 4")
    check_s2("cli_train frame 0", since, 240, 416, 1)
    check_s3("cli_train frame 0", s3, satd_fused.LAUNCHES)
    launches += satd_fused.LAUNCHES
    stream = decoder.encode_stream(
        headers.StreamConfig(width=416, height=240, qp=QP), [out])
    dec = decoder.Decoder()
    got = dec.decode(stream)
    if len(got) != 1 or not dec.hashes_ok or not all(dec.hashes_ok):
        fail("cli_train: the trained model's stream did not verify")
    for plane, k in zip(got[0], ("recon_y", "recon_u", "recon_v")):
        if not np.array_equal(plane, out[k][0]):
            fail(f"cli_train: decoded {k} differs from the recon")
    stats = dict(history=hist, samples=int(times[4]),
                 labels_s=float(times[1]), dataset_ms=float(times[2]),
                 train_s=float(times[3]), wall_s=wall, k1_launches=launches,
                 frame0_bytes=len(stream),
                 frame0_psnr_y=psnr_y(out["sse"], 240, 416))
    log(f"  {closing[0]}")
    log(f"  cli_train: {json.dumps(stats)}")
    return stats, launches


def weight_gap(a: dict, b: dict):
    """(largest per-tensor ||a - b||_2 / ||b||_2, its tensor) of two
    JAX-layout params dicts."""
    return max((float(np.linalg.norm(a[lay][k].astype(np.float64)
                                     - b[lay][k].astype(np.float64))
                      / max(np.linalg.norm(b[lay][k].astype(np.float64)),
                            1e-30)), f"{lay}.{k}")
               for lay in b for k in b[lay])


def model_gap(a: dict, b: dict) -> float:
    """||a - b||_2 / ||b||_2 over every weight of two params dicts."""
    d2 = p2 = 0.0
    for lay in b:
        for k in b[lay]:
            y = b[lay][k].astype(np.float64)
            d2 += float(np.sum((a[lay][k].astype(np.float64) - y) ** 2))
            p2 += float(np.sum(y ** 2))
    return (d2 / p2) ** 0.5


def step_grads(data, device, dtype) -> dict:
    """One step's gradients from init_params(0) on the first 256 samples,
    as JAX-layout arrays (rounded to float32: 6e-8, far below the
    bound)."""
    import torch
    from hevctpu_torch.models import convnet2, train
    model = convnet2.load_model(convnet2.init_params(0), device).to(dtype)
    with train.deterministic_convolutions():
        train.loss_fn(model, data[0][:256].to(dtype), data[1][:256].to(dtype),
                      data[2][:256]).backward()
    g = convnet2.ConvNet2()
    g.load_state_dict({k: p.grad.cpu().float()
                       for k, p in model.named_parameters()})
    del model
    torch.cuda.synchronize()
    return convnet2.params_to_jax(g)


def history_gaps(a: list, b: list):
    """(largest relative epoch-loss gap, largest absolute accuracy gap)."""
    return (max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                for x, y in zip(a, b)),
            max(abs(x["acc"] - y["acc"]) for x, y in zip(a, b)))


def train_flops() -> tuple:
    """(forward, training-step) FLOP per sample of ConvNet2: 2 per
    multiply-add. A step is the forward, every layer's weight gradient
    (as many as its forward) and every input gradient but conv1's and
    conv64's, whose inputs are the crops."""
    convs = {"conv1": (32, 32, 16, 5 * 5 * 3),
             "conv64": (64, 64, 16, 5 * 5 * 3),
             "conv2": (16, 16, 64, 3 * 3 * 32),
             "conv3": (8, 8, 128, 3 * 3 * 64)}
    per = {k: 2 * h * w * co * taps for k, (h, w, co, taps) in convs.items()}
    per.update(fc1=2 * 2048 * 256, fc2=2 * 256 * 64, fc3=2 * 64 * 16)
    fwd = sum(per.values())
    return fwd, 3 * fwd - per["conv1"] - per["conv64"]


def phase_train_step(cnn, dev, sm_hz: float):
    """ConvNet2 trained at batch 256 on make_dataset of one 1920x1080 frame
    of clips.clip_sine (seed 0; labels from CKPT_DOMAIN.npz), 2 epochs:
    card against CPU port in float32 and in float64, the card twice; then
    the warm step time beside the FP32 bound."""
    import torch
    from hevctpu_torch.models import convnet2, train
    from hevctpu_torch.pipeline import clips, labels
    h, w, batch = 1080, 1920, 256
    y, u, v = clips.clip_sine(1, h, w, seed=0)
    lab = convnet2.predict_frame_labels(
        cnn, *(torch.as_tensor(p.astype(np.int32)).to(dev) for p in (y, u, v)),
        h, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = labels.make_dataset(y, u, v, lab, device=dev)
    torch.cuda.synchronize()
    dataset_ms = (time.perf_counter() - t0) * 1e3
    ds_cpu = labels.make_dataset(y, u, v, lab.cpu(), device="cpu")
    for name, a, b in zip(("x32", "x64", "digits"), ds, ds_cpu):
        if not torch.equal(a.cpu(), b):
            diff = (a.cpu().double() - b.double()).abs()
            fail(f"make_dataset's {name} differs card vs CPU: "
                 f"{int((diff > 0).sum())} elements, max {float(diff.max())}")
    n = ds[0].shape[0]
    steps = 2 * len(range(0, n - batch + 1, batch))
    grads = {name: step_grads(data, d, dtype) for name, data, d, dtype in (
        ("card", ds, dev, torch.float32), ("cpu", ds_cpu, "cpu",
                                           torch.float32),
        ("cpu64", ds_cpu, "cpu", torch.float64))}
    grad_gaps = {}
    for name in ("card", "cpu"):
        grad_gaps[name] = weight_gap(grads[name], grads["cpu64"])
        log(f"  one step's float32 gradients, {name} vs CPU float64: "
            f"largest relative L2 {grad_gaps[name][0]:.3g} "
            f"({grad_gaps[name][1]})")
    if grad_gaps["card"][0] > TRAIN_F32_GRAD:
        fail(f"the card's float32 gradients beyond {TRAIN_F32_GRAD} of the "
             f"float64 ones: {grad_gaps['card']}")
    runs, secs = {}, {}
    for name, data, d, dtype in (
            ("card", ds, dev, torch.float32),
            ("card_again", ds, dev, torch.float32),
            ("cpu", ds_cpu, "cpu", torch.float32),
            ("card64", ds, dev, torch.float64),
            ("cpu64", ds_cpu, "cpu", torch.float64)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = train.train(data[0].to(dtype), data[1].to(dtype),
                                 data[2], epochs=2, batch=batch, seed=0,
                                 log=None, device=d)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    gaps = {}
    for a, b in (("card", "cpu"), ("card64", "cpu64"), ("card", "cpu64"),
                 ("cpu", "cpu64")):
        wg, where = weight_gap(runs[a][0], runs[b][0])
        mg = model_gap(runs[a][0], runs[b][0])
        lg, ag = history_gaps(runs[a][1], runs[b][1])
        gaps[f"{a}_vs_{b}"] = dict(weights=wg, tensor=where, model=mg,
                                   loss=lg, acc=ag)
        log(f"  {a} vs {b}: largest weight relative L2 {wg:.3g} ({where}), "
            f"all weights {mg:.3g}, loss {lg:.3g} relative, accuracy "
            f"{ag:.6f}")
    f32, f64 = gaps["card_vs_cpu"], gaps["card64_vs_cpu64"]
    if f32["model"] > TRAIN_F32_MODEL or f32["loss"] > TRAIN_F32_LOSS \
            or f32["acc"] > TRAIN_ACC:
        fail(f"float32 training card vs CPU beyond the bounds "
             f"({TRAIN_F32_MODEL}, {TRAIN_F32_LOSS}, {TRAIN_ACC}): {f32}")
    if f64["weights"] > TRAIN_F64 or f64["loss"] > TRAIN_F64 \
            or f64["acc"] > TRAIN_ACC:
        fail(f"float64 training card vs CPU beyond {TRAIN_F64}: {f64}")
    first, again = runs["card"][0], runs["card_again"][0]
    same = all(np.array_equal(first[k][p], again[k][p])
               for k in first for p in first[k])
    repeat_gap = 0.0 if same else weight_gap(again, first)[0]
    log(f"  the card's two float32 runs: "
        f"{'bit-identical' if same else f'differ, {repeat_gap:.3g}'}")
    log(f"  card history {runs['card'][1]}; CPU history {runs['cpu'][1]}")

    model = convnet2.load_model(convnet2.init_params(0), dev).train()
    opt = train.make_optimizer(model, 1e-3)
    order = torch.as_tensor(np.random.default_rng(0).permutation(n),
                            device=dev)
    batches = [order[i: i + batch] for i in range(0, n - batch + 1, batch)]
    events = []
    torch.cuda.reset_peak_memory_stats()
    with train.deterministic_convolutions():
        for k in range(3 + 20):
            idx = batches[k % len(batches)]
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            train.train_step(model, opt, ds[0][idx], ds[1][idx], ds[2][idx])
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
    step_ms = float(np.median([a.elapsed_time(b) for a, b in events[3:]]))
    fwd, step = train_flops()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fp32_flops = sms * FP32_LANES_PER_SM * 2 * sm_hz
    n_params = sum(p.numel() for p in model.parameters())
    # crops and digits read once; Adam reads params, m, v, writes all three
    nbytes = batch * (32 * 32 * 3 + 64 * 64 * 3) * 4 + batch * 4 * 8 \
        + 6 * n_params * 4
    ops_ms = batch * step / fp32_flops * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    stats = dict(
        samples=n, batch=batch, steps=steps, dataset_ms=dataset_ms,
        train_s=secs, gaps=gaps, grad_gaps=grad_gaps,
        card_repeat_bit_identical=same,
        card_repeat_gap=repeat_gap, step_ms=step_ms,
        samples_per_s=batch / step_ms * 1e3,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        fwd_mflop_per_sample=fwd / 1e6, step_mflop_per_sample=step / 1e6,
        step_gflop=batch * step / 1e9, fp32_tflops=fp32_flops / 1e12,
        bound_ms=bound_ms, bound_by="operations" if ops_ms >= bytes_ms
        else "bytes", share_of_bound=bound_ms / step_ms,
        history_card=runs["card"][1], history_cpu=runs["cpu"][1])
    log(f"  train step, batch {batch}, warm: {step_ms:.4f} ms (median of "
        f"20), {stats['samples_per_s']:.1f} samples/s, peak "
        f"{stats['peak_mem_gib']:.3f} GiB; {step / 1e6:.2f} MFLOP a sample "
        f"({stats['step_gflop']:.2f} GFLOP a step), bound {bound_ms:.4f} ms "
        f"at {fp32_flops / 1e12:.2f} FP32 TFLOP/s ({sms} SMs), step at "
        f"{stats['share_of_bound']:.3f} of the bound")
    return stats


def _rank_main(rank, job, init, results):
    """One rank of a phase-13 or 17a world (spawned): the ShardedEncoder
    encode of job's clip on the card, CNN labels from CKPT_DOMAIN.npz or
    job["fixed_depth"], and the mesh's byte tally of it; puts (rank,
    result) or (rank, traceback) on results."""
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        from hevctpu_torch.models import checkpoint
        from hevctpu_torch.ops import satd_fused
        from hevctpu_torch.parallel import ShardedEncoder, make_mesh
        from hevctpu_torch.pipeline import clips
        record_k1_shapes()
        record_s3_calls()
        dist.init_process_group(job["backend"], init_method=init,
                                rank=rank, world_size=job["world"],
                                timeout=datetime.timedelta(seconds=300))
        mesh = make_mesh(tile=job["tile"])
        h, w, frames = job["h"], job["w"], job["frames"]
        y, u, v = (cuqp_clip(h, w) if job["clip"] == "cuqp"
                   else clips.clip_sine(frames, h, w, seed=0))
        src = (dict(fixed_depth=job["fixed_depth"]) if "fixed_depth" in job
               else dict(cnn_params=checkpoint.load(
                   os.path.join(ROOT, "CKPT_DOMAIN.npz"))))
        sh = ShardedEncoder(h, w, QP, mesh, **src)
        mesh.reset_tally()
        satd_fused.LAUNCHES = 0
        since, s3 = s2_launches(), s3_mark()
        t0 = time.perf_counter()
        out = sh.encode(y, u, v)
        wall = time.perf_counter() - t0
        launches = satd_fused.LAUNCHES
        res = dict(out=out, wall_s=wall, k1_launches=launches,
                   s2_launches=s2_launches() - since,
                   s3=[now - then for now, then in zip(s3_mark(), s3)],
                   k1_shapes=sorted(K1_LAUNCHED), mesh=mesh.shape,
                   coords=(mesh.frame_index, mesh.tile_index),
                   backend=dist.get_backend(),
                   device=str(sh.enc.device), tally=mesh.tally,
                   stage_ms={k: round(x, 3)
                             for k, x in sh.enc.stage_ms().items()})
        dist.destroy_process_group()
        results.put((rank, res))
    except Exception:                     # reported to the parent
        results.put((rank, traceback.format_exc()))


def phase_sharded(label, world, backend, job, want, want_stream, cfg,
                  timeout_s, want_tally=None):
    """One phase-13 or 17a world: every rank's dict must equal want key
    for key and encode to want_stream; each rank launches K1 4 times and
    the stage-2 kernel once a diagonal of the whole picture (a tile walks
    every diagonal);
    with want_tally (the rank's (frame, tile) -> the tally it must hold),
    each rank's mesh tallied those bytes. Returns (stats, the ranks' K1
    launches)."""
    from hevctpu_torch.codec import decoder
    from hevctpu_torch.parallel.scaling import run_world
    try:
        ranks, wall = run_world(dict(job, world=world, backend=backend,
                                     deadline_s=timeout_s), _rank_main)
    except RuntimeError as e:
        fail(f"{label}: {e}")
    launches = 0
    per_rank = {}
    for rank, res in sorted(ranks.items()):
        out = res.pop("out")
        if set(out) != set(want):
            fail(f"{label} rank {rank}: keys {sorted(set(out) ^ set(want))} "
                 f"differ")
        for k in want:
            a, b = np.asarray(out[k]), np.asarray(want[k])
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"{label} rank {rank}: {k} differs from the "
                     f"single-process encode "
                     f"({first_difference({k: a}, {k: b})})")
        stream = decoder.encode_stream(cfg, [out])
        if stream != want_stream:
            fail(f"{label} rank {rank}: the stream differs")
        if res["k1_launches"] != 4:
            fail(f"{label} rank {rank}: K1 launched {res['k1_launches']} "
                 f"times, not 4")
        if res["s2_launches"] != diagonals(job["h"], job["w"]):
            fail(f"{label} rank {rank}: the stage-2 kernel launched "
                 f"{res['s2_launches']} times, not "
                 f"{diagonals(job['h'], job['w'])}")
        S2_LAUNCHED[f"{label} rank {rank}"] = res["s2_launches"]
        s3, s3_calls = res.pop("s3")
        if s3 != s3_calls or s3 > S3_PER_DECISION:
            fail(f"{label} rank {rank}: stage 1's RD kernel launched {s3} "
                 f"times for {s3_calls} candidate-RD calls on the card")
        S3_LAUNCHED[f"{label} rank {rank}"] = s3
        if want_tally and res["tally"] != want_tally(res["coords"]):
            fail(f"{label} rank {rank}: tally {res['tally']}, not the "
                 f"closed form {want_tally(res['coords'])}")
        launches += res["k1_launches"]
        K1_LAUNCHED.update(tuple(x) for x in res.pop("k1_shapes"))
        per_rank[rank] = res
    backends = {r["backend"] for r in per_rank.values()}
    stats = dict(world=world, transport=sorted(backends), frames=job["frames"],
                 size=f"{job['w']}x{job['h']}", mesh=per_rank[0]["mesh"],
                 bytes=len(want_stream), world_wall_s=wall,
                 k1_launches=launches, ranks=per_rank)
    log(f"  {label}: transport {'/'.join(sorted(backends))}, {world} "
        f"rank(s) on one card, mesh {per_rank[0]['mesh']}: every key equal "
        f"and the stream byte-identical ({len(want_stream)} bytes) on every "
        f"rank; {json.dumps(stats)}")
    return stats, launches


def phase_inter(dev):
    """hevctpu_torch.ops.inter on the card against the CPU port, on a
    416x240 pair of clip_sine frames (frame 1 predicted from frame 0)."""
    import torch
    from hevctpu_torch.ops import inter
    from hevctpu_torch.pipeline import clips
    y, u, _ = clips.clip_sine(2, 240, 416, seed=0)
    rng = np.random.default_rng(0)
    mv8 = rng.integers(-24, 25, (1, 30, 52, 2)).astype(np.int32)
    mv4 = rng.integers(-24, 25, (1, 30, 52, 2)).astype(np.int32)
    cur, ref = y[1:], y[:1]
    p14 = (ref << 6) - (1 << 13)
    mvf = rng.integers(-2, 3, (1, 30, 52, 2)).astype(np.int32) * 4
    fade = np.clip((ref * 0.7).astype(np.int32) + 10, 0, 255)
    wts = inter.wp_estimate(*inter.wp_acdc(torch.as_tensor(fade)),
                            *inter.wp_acdc(torch.as_tensor(ref)))
    cases = {
        "mc_luma_grid": (inter.mc_luma_grid, (ref, mv8, 8)),
        "mc_chroma_grid": (inter.mc_chroma_grid, (u[:1], mv4, 4)),
        "bi_average": (inter.bi_average, (p14, (cur << 6) - (1 << 13))),
        "sad_full_search": (inter.sad_full_search, (cur, ref, 8, 4)),
        "sad_full_search_flat": (inter.sad_full_search,
                                 (np.full_like(cur, 90), np.full_like(ref, 90),
                                  8, 2)),
        "frac_refine": (inter.frac_refine, (cur, ref, mv8 & ~3, 8)),
        "amvp_candidates": (inter.amvp_candidates, (mvf,)),
        "mvd_bits": (inter.mvd_bits, (mv8 * 37,)),
        "wp_apply": (inter.wp_apply, (p14, 80, -3)),
        "wp_apply_bi": (inter.wp_apply_bi, (p14, p14[:, ::-1].copy(), 70, 2,
                                            58, -1)),
        "wp_select": (inter.wp_select, (fade, ref, int(wts[0][0]),
                                        int(wts[1][0]))),
        "merge_candidates": (inter.merge_candidates, (mvf,)),
        "wp_acdc": (inter.wp_acdc, (np.concatenate([cur, ref]),)),
    }
    res = {}
    for name, (fn, args) in cases.items():
        outs = []
        for d in (dev, torch.device("cpu")):
            got = fn(*(torch.as_tensor(a).to(d) if isinstance(a, np.ndarray)
                       else a for a in args))
            outs.append([_np_of(t) for t in
                         (got if isinstance(got, tuple) else (got,))])
        card, cpu = outs
        for i, (a, b) in enumerate(zip(card, cpu)):
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"inter {name}[{i}]: {a.dtype} {a.shape} on the card, "
                     f"{b.dtype} {b.shape} on the CPU")
            if name == "wp_acdc" and i == 1:
                rel = float(np.max(np.abs(a.astype(np.float64) - b)
                                   / np.maximum(np.abs(b), 1)))
                if rel > INTER_AC_RTOL:
                    fail(f"inter wp_acdc AC card vs CPU {rel} > "
                         f"{INTER_AC_RTOL}")
            elif not np.array_equal(a, b):
                fail(f"inter {name}[{i}] differs card vs CPU at "
                     f"{np.argwhere(a != b)[:4].tolist()}")
        res[name] = [list(a.shape) for a in card]
    log(f"  inter: {len(cases)} functions' outputs card = CPU "
        f"(integers bit for bit, wp_acdc AC within {INTER_AC_RTOL}); "
        f"wp_estimate on the moments: weights {wts[0].tolist()}, offsets "
        f"{wts[1].tolist()}")
    return res


CAL_CLIP, CAL_QP, CAL_DOMAIN_QP = "pink", 32, 27
CAL_RATE_FRAMES = 1         # 15a: cut from 2
CAL_CTX_FRAMES = 1          # 15b: cut from the tool's 4
CAL_DOMAIN_FRAMES = 1       # 15c: one encode of 1 (the tool's 8: two of 4)
CAL_SMALL_FRAMES = 1        # 15's card vs CPU at 64x128: cut from 2
CAL_SMALL_CLIP = "scene"         # the card-vs-CPU clip at 64x128


def _timed(fn):
    """(fn's result, host seconds) around work that ends in a sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _count_launches(label, fn, want, s2):
    """fn's result with K1's launch count around it, which must be want,
    the stage-2 kernel's, which must be one a diagonal of each of the
    stage-2 runs s2 = (runs, h, w), and stage 1's RD kernel's, one a
    candidate-RD call on the card under the global rate model."""
    from hevctpu_torch.ops import satd_fused
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    out = fn()
    if satd_fused.LAUNCHES != want:
        fail(f"{label}: K1 launched {satd_fused.LAUNCHES} times, not {want}")
    runs, h, w = s2
    check_s2(label, since, h, w, runs)
    check_s3(label, s3, want)
    return out


@contextlib.contextmanager
def capture_encodes():
    """Record each FrameEncoder.encode's output dict and seconds (host
    clock, synchronized) inside the block; the list of (dict, s)."""
    import torch
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    encode = FrameEncoder.encode
    calls = []

    def capturing(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(self, *a, **k)
        torch.cuda.synchronize()
        calls.append((out, time.perf_counter() - t0))
        return out

    FrameEncoder.encode = capturing
    try:
        yield calls
    finally:
        FrameEncoder.encode = encode


def run_calibration(label, fn, want_launches):
    """One calibration path on the card at 416x240, K1 launched
    want_launches times and stage 2 run want_launches / 4 times (one
    encode each): (fn's result, seconds in all, seconds in its full-RD
    encodes, the encodes' (dict, seconds))."""
    with capture_encodes() as calls:
        out, secs = _timed(lambda: _count_launches(
            label, fn, want_launches, (want_launches // 4, 240, 416)))
    return out, secs, sum(t for _, t in calls), calls


def phase_calibrate(dev):
    """The calibration path (pipeline/calibrate.py, the functions behind
    tools/*_torch.py) on the card at the tools' 416x240, cut to one clip
    (pink), one QP and 1 epoch: (a) the rate-weight samples and fit
    (CAL_RATE_FRAMES frames), (b) the context count table (CAL_CTX_FRAMES frames), (c) the
    domain dataset (CAL_DOMAIN_FRAMES frames, full-RD labels) and ConvNet2
    trained 1 epoch from CKPT_DOMAIN.npz. Each is held against the CPU
    port at 64x128 x CAL_SMALL_FRAMES on the scene clip (its decisions vary more at that
    size): integers exact, training as in phase 12b. Returns (stats, K1
    launches)."""
    import torch
    from hevctpu_torch.models import checkpoint, train
    from hevctpu_torch.ops import rate
    from hevctpu_torch.pipeline import calibrate
    init = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    stats, launches = {}, 0

    # (a) rate weights: full-RD encode, exact bits, features, ridge fit
    (feats, trues), secs, enc_s, calls = run_calibration(
        "calibrate rate", lambda: calibrate.rate_samples(
            CAL_QP, [CAL_CLIP], CAL_RATE_FRAMES, device=dev), 4)
    launches += 4
    (fitted, line), fit_s = _timed(
        lambda: calibrate.fit_rate_weights(feats, trues))
    w = np.array([rate._W_DEFAULT[k] for k in rate._W_FIELDS]
                 + [rate.BITS_ONE], np.float64)
    if len(feats) < 20 or not np.isfinite(trues).all() \
            or (trues <= 0).any() or len(fitted) != len(rate._W_FIELDS):
        fail(f"calibrate rate: {len(feats)} TUs, fit {fitted}")
    # the features reproduce the estimator on the card for the same TUs
    by_size = {}
    for (blk, s), f in zip(calibrate.frame_tus(calls[0][0]), feats):
        by_size.setdefault(s, []).append((blk, f))
    for s, items in by_size.items():
        est = rate.estimate_tu_bits(torch.as_tensor(
            np.stack([b for b, _ in items])).to(dev), s).cpu().numpy()
        if not np.array_equal(np.stack([f for _, f in items]) @ w, est):
            fail(f"calibrate rate: features . weights != estimate_tu_bits "
                 f"on the card (log2 {s})")
    stats[f"rate_416x240x{CAL_RATE_FRAMES}"] = dict(
        tus=len(feats), s=secs, encode_s=enc_s, host_s=secs - enc_s,
        fit_s=fit_s, fitted=list(fitted), report=f"qp {CAL_QP}: {line}",
        k1_launches=4)
    log(f"  (a) rate weights, {CAL_CLIP} 416x240 x {CAL_RATE_FRAMES}, QP "
        f"{CAL_QP}: "
        f"{len(feats)} TUs in {secs:.2f} s (full-RD encode {enc_s:.2f} s, "
        f"exact bits and features on the host {secs - enc_s:.2f} s), fit "
        f"{fit_s * 1e3:.1f} ms; qp {CAL_QP}: {line}")

    # (b) context counts: full-RD encode, golden-coder bin counts
    table, secs, enc_s, _ = run_calibration(
        "calibrate ctx", lambda: calibrate.ctx_count_table(
            [CAL_QP], [CAL_CLIP], CAL_CTX_FRAMES, device=dev, log=None), 4)
    launches += 4
    bins = sum(c0 + c1 for d in table[CAL_QP].values()
               for c0, c1 in d.values())
    if bins < 10000:
        fail(f"calibrate ctx: {bins} bins")
    contexts = sum(len(d) for d in table[CAL_QP].values())
    stats[f"ctx_416x240x{CAL_CTX_FRAMES}"] = dict(
        bins=bins, contexts=contexts, s=secs, encode_s=enc_s,
        host_s=secs - enc_s, k1_launches=4)
    log(f"  (b) context counts, {CAL_CLIP} 416x240 x {CAL_CTX_FRAMES}, QP "
        f"{CAL_QP}: {bins} bins over {contexts} contexts "
        f"in {secs:.2f} s (full-RD encode {enc_s:.2f} s, the golden "
        f"coder's bin walk on the host {secs - enc_s:.2f} s)")

    # (c) domain CNN: full-RD labels, dataset, 1 epoch from CKPT_DOMAIN
    (x32, x64, digits), secs, enc_s, _ = run_calibration(
        "calibrate domain", lambda: calibrate.domain_dataset(
            [CAL_CLIP], 1, CAL_DOMAIN_FRAMES, [CAL_DOMAIN_QP], device=dev,
            log=None), 4)
    launches += 4
    (params, hist), train_s = _timed(lambda: train.train(
        x32, x64, digits, params=init, epochs=1, lr=5e-4, log=None,
        device=dev))
    if digits.shape[0] != CAL_DOMAIN_FRAMES * 28 * 4 \
            or x32.device.type != "cuda" \
            or not all(np.isfinite(params[k][p]).all()
                       for k in params for p in params[k]):
        fail(f"calibrate domain: {digits.shape[0]} samples on "
             f"{x32.device}, history {hist}")
    stats[f"domain_416x240x{CAL_DOMAIN_FRAMES}"] = dict(
        samples=int(digits.shape[0]), dataset_s=secs, labels_s=enc_s,
        train_s=train_s, history=hist, k1_launches=4)
    log(f"  (c) domain dataset, {CAL_CLIP} seed 100 416x240 x "
        f"{CAL_DOMAIN_FRAMES}, QP {CAL_DOMAIN_QP}: {digits.shape[0]} samples"
        f" in {secs:.2f} s (full-RD labels, {enc_s:.2f} s); 1 epoch from "
        f"CKPT_DOMAIN.npz in {train_s:.2f} s, {hist}")

    # card against the CPU port at 64x128 x CAL_SMALL_FRAMES
    small, n = dict(h=64, w=128), CAL_SMALL_FRAMES
    card, cpu = {}, {}
    for d, res in ((dev, card), (torch.device("cpu"), cpu)):
        want = 4 if d.type == "cuda" else 0
        s2 = (want // 4, small["h"], small["w"])
        res["rate"] = _count_launches(f"rate 64x128 on {d.type}",
                                      lambda: calibrate.rate_samples(
                                          CAL_QP, [CAL_SMALL_CLIP], n,
                                          device=d, **small), want, s2)
        res["ctx"] = _count_launches(f"ctx 64x128 on {d.type}",
                                     lambda: calibrate.ctx_count_table(
                                         [CAL_QP], [CAL_SMALL_CLIP], n,
                                         device=d, log=None, **small),
                                     want, s2)
        res["domain"] = _count_launches(f"domain 64x128 on {d.type}",
                                        lambda: calibrate.domain_dataset(
                                            [CAL_SMALL_CLIP], 1, n,
                                            [CAL_DOMAIN_QP], device=d,
                                            log=None, **small), want, s2)
        launches += want * 3
    for i, name in enumerate(("features", "exact bits")):
        if not np.array_equal(card["rate"][i], cpu["rate"][i]):
            fail(f"calibrate 64x128: the {name} differ card vs CPU")
    if calibrate.fit_rate_weights(*card["rate"]) \
            != calibrate.fit_rate_weights(*cpu["rate"]):
        fail("calibrate 64x128: the fitted weights differ card vs CPU")
    if card["ctx"] != cpu["ctx"]:
        fail("calibrate 64x128: the context count tables differ card vs CPU")
    for name, a, b in zip(("x32", "x64", "digits"), card["domain"],
                          cpu["domain"]):
        if not torch.equal(a.cpu(), b):
            fail(f"calibrate 64x128: the domain dataset's {name} differs "
                 f"card vs CPU")
    runs = {}
    for name, d, dtype in (("card", dev, torch.float32),
                           ("cpu", "cpu", torch.float32),
                           ("card64", dev, torch.float64),
                           ("cpu64", "cpu", torch.float64)):
        data = card["domain"] if name.startswith("card") else cpu["domain"]
        runs[name] = train.train(data[0].to(dtype), data[1].to(dtype),
                                 data[2], params=init, epochs=1, lr=5e-4,
                                 log=None, device=d)
    gaps = {}
    for a, b in (("card", "cpu"), ("card64", "cpu64")):
        wg, where = weight_gap(runs[a][0], runs[b][0])
        lg, ag = history_gaps(runs[a][1], runs[b][1])
        gaps[f"{a}_vs_{b}"] = dict(weights=wg, tensor=where,
                                   model=model_gap(runs[a][0], runs[b][0]),
                                   loss=lg, acc=ag)
    f32, f64 = gaps["card_vs_cpu"], gaps["card64_vs_cpu64"]
    if f32["model"] > TRAIN_F32_MODEL or f32["loss"] > TRAIN_F32_LOSS \
            or f32["acc"] > TRAIN_ACC:
        fail(f"calibrate 64x128: float32 training card vs CPU beyond the "
             f"bounds ({TRAIN_F32_MODEL}, {TRAIN_F32_LOSS}, {TRAIN_ACC}): "
             f"{f32}")
    if f64["weights"] > TRAIN_F64 or f64["loss"] > TRAIN_F64 \
            or f64["acc"] > TRAIN_ACC:
        fail(f"calibrate 64x128: float64 training card vs CPU beyond "
             f"{TRAIN_F64}: {f64}")
    stats[f"card_vs_cpu_64x128x{n}"] = dict(
        tus=len(card["rate"][0]), fitted=list(calibrate.fit_rate_weights(
            *card["rate"])[0]), samples=int(card["domain"][2].shape[0]),
        train_gaps=gaps)
    log(f"  {CAL_SMALL_CLIP} 64x128 x {n} card = CPU: {len(card['rate'][0])} "
        f"TUs' features and "
        f"bits, the fit, the context table, the domain dataset "
        f"({card['domain'][2].shape[0]} samples); 1 epoch float32 "
        f"{json.dumps(f32)}, float64 {json.dumps(f64)}")
    return stats, launches


EVAL_CLIP, EVAL_FRAMES = "pink", 8      # phase 16a: the corpus protocol
# the JAX tool's points for 16a: tools/measure_corpus.py --skip-hm --model
# CKPT_DOMAIN.npz --clips pink --modes cnn --out RD_PINK_CNN_JAX.json, run
# on the CPU at the commit that added this phase
EVAL_JAX_RECORD = "RD_PINK_CNN_JAX.json"
EVAL_SMALL_CLIP, EVAL_SMALL_QP = "scene", 32   # 16b: card vs CPU, 64x128
EVAL_SMALL_FRAMES = 1                          # 16b: cut from 2
EVAL_SMALL_QPS = [EVAL_SMALL_QP]               # 16b: cut from the four
PROFILE_FRAMES, PROFILE_REPS = 1, 1     # 16c: cut from the tool's 8 and 5/3


def _no_time(pts):
    return [{k: p for k, p in pt.items() if k != "time_s"} for pt in pts]


def phase_evaluate(dev):
    """The evaluation path (pipeline/evaluate.py and pipeline/profile.py,
    behind tools/*_torch.py): (a) the corpus protocol on one clip, the
    port's cnn points at 416x240 x 8 and the four QPs against the cached
    HM anchor and pruned HM, the points equal to the JAX tool's;
    (b) cnn and rd points at EVAL_SMALL_QPS, one QP of each
    gap-attribution variant and one frame's syntax-element bits at 64x128
    x EVAL_SMALL_FRAMES on the card and on the CPU port, exactly equal; (c) the stage profile at
    416x240, cut to PROFILE_FRAMES and PROFILE_REPS. Returns (stats, K1
    launches)."""
    import torch
    from hevctpu_torch.models import checkpoint
    from hevctpu_torch.pipeline import clips, evaluate, profile
    t_phase = time.perf_counter()
    params = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    qps = list(evaluate.QPS)
    stats, launches = {}, 0

    # (a) the corpus protocol, pink 416x240 x 8 at QPs 22/27/32/37
    with open(os.path.join(ROOT, "CORPUS_HM.json")) as f:
        entry = json.load(f)[evaluate.hm_cache_key(EVAL_CLIP, EVAL_FRAMES,
                                                    qps)]
    with open(os.path.join(ROOT, EVAL_JAX_RECORD)) as f:
        want = _no_time(json.load(f)["per_clip"][EVAL_CLIP]["ours_cnn"])
    y, u, v = clips.make_clip(EVAL_CLIP, EVAL_FRAMES, 240, 416)
    pts = _count_launches(
        "evaluate cnn 416x240x8", lambda: evaluate.ours_points(
            y, u, v, qps, "cnn", params, device=dev, log=log), 4 * len(qps),
        (len(qps), 240, 416))
    launches += 4 * len(qps)
    for p in pts:
        vals = [p[k] for k in ("bitrate_kbps", "psnr_y", "psnr_u", "psnr_v",
                               "time_s")]
        if not (np.isfinite(vals).all() and min(vals) > 0):
            fail(f"evaluate: point {p}")
    if _no_time(pts) != want:
        fail(f"evaluate: the card's {EVAL_CLIP} cnn points {_no_time(pts)} "
             f"differ from the JAX tool's ({EVAL_JAX_RECORD}) {want}")
    cdoc = evaluate.hm_summary(entry)
    cdoc.update(evaluate.mode_summary(entry, "cnn", pts))
    for p in pts:
        log(f"  (a) QP {p['qp']}: {p['bitrate_kbps']} kbps, PSNR Y/U/V "
            f"{p['psnr_y']} / {p['psnr_u']} / {p['psnr_v']} dB, "
            f"{p['time_s']} s")
    log(f"  (a) {EVAL_CLIP} 416x240 x {EVAL_FRAMES}, cnn: BD-rate "
        f"{cdoc['bd_rate_pct_cnn']:+.3f}% BD-PSNR "
        f"{cdoc['bd_psnr_db_cnn']:+.4f} dB vs the HM anchor, "
        f"{cdoc['bd_rate_pct_cnn_vs_pruned_hm']:+.3f}% "
        f"{cdoc['bd_psnr_db_cnn_vs_pruned_hm']:+.4f} dB vs the pruned HM; "
        f"time saving {cdoc['time_saving_pct_cnn']:+.2f}% "
        f"({sum(p['time_s'] for p in pts):.3f} s against the anchor's "
        f"{sum(p['time_s'] for p in entry['anchor']):.3f} s, CORPUS_HM.json)"
        f"; points equal to the JAX tool's ({EVAL_JAX_RECORD})")
    stats["corpus_pink_416x240x8"] = cdoc

    # (b) card against the CPU port at 64x128 x EVAL_SMALL_FRAMES
    from hevctpu_torch.codec import headers
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    ys, us, vs = clips.make_clip(EVAL_SMALL_CLIP, EVAL_SMALL_FRAMES, 64,
                                 128)
    cfg = headers.StreamConfig(width=128, height=64, qp=EVAL_SMALL_QP)
    res = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        want_k1 = 4 if d.type == "cuda" else 0

        def run(label, fn, n):
            # n stage-1 runs on the card, each followed by a stage-2 run
            return _count_launches(f"evaluate {label} 64x128 on {d.type}",
                                   fn, want_k1 * n,
                                   (want_k1 // 4 * n, 64, 128))

        r = res[side] = {}
        for mode in ("cnn", "rd"):
            r[mode] = _no_time(run(mode, lambda: evaluate.ours_points(
                ys, us, vs, EVAL_SMALL_QPS, mode, params, device=d,
                log=lambda *a: None), len(EVAL_SMALL_QPS)))
        for vname in evaluate.VARIANTS:
            r[vname] = run(vname, lambda: evaluate.variant_points(
                ys, us, vs, [EVAL_SMALL_QP], vname, device=d,
                log=lambda *a: None), 2 if vname == "2pass" else 1)
        out = run("bit stats", lambda: FrameEncoder(
            64, 128, EVAL_SMALL_QP, search="rd", device=d).encode(
                ys, us, vs), 1)
        r["bits"] = evaluate.frame_bit_stats(cfg, out, 0)
        launches += want_k1 * (2 * len(EVAL_SMALL_QPS)
                               + len(evaluate.VARIANTS) + 2)
    for key in res["cpu"]:
        if res["card"][key] != res["cpu"][key]:
            fail(f"evaluate 64x128: {key} differs card vs CPU: "
                 f"{res['card'][key]} against {res['cpu'][key]}")
    stats[f"card_vs_cpu_64x128x{EVAL_SMALL_FRAMES}"] = res["card"]
    log(f"  (b) {EVAL_SMALL_CLIP} 64x128 x {EVAL_SMALL_FRAMES} card = CPU: "
        f"cnn and rd points "
        f"at QPs {EVAL_SMALL_QPS}, the variants {list(evaluate.VARIANTS)} at QP "
        f"{EVAL_SMALL_QP}, frame 0's {len(res['card']['bits'])} syntax "
        f"elements' bits ({sum(res['card']['bits'].values()):.1f} in all)")

    # (c) the stage profile, 416x240 cut to PROFILE_FRAMES and PROFILE_REPS
    n_k1 = 4 * (2 * (1 + PROFILE_REPS) + 2 + 2 * (1 + PROFILE_REPS) + 1)
    # stage 2 alone, the device encode and encode_fused, each warm and
    # timed; the one encode for the stream
    n_s2 = 3 * (1 + PROFILE_REPS) + 1
    prof, secs = _timed(lambda: _count_launches(
        "profile 416x240", lambda: profile.profile_stages(
            params, frames=PROFILE_FRAMES, device=dev, reps=PROFILE_REPS,
            full_reps=PROFILE_REPS), n_k1, (n_s2, 240, 416)))
    launches += n_k1
    ms = prof["stage_ms"]
    if not all(np.isfinite(t) and t >= 0 for t in ms.values()):
        fail(f"profile: stage ms {ms}")
    prof["cut"] = (f"{PROFILE_FRAMES} frames and {PROFILE_REPS} reps, from "
                   f"the tool's 8 frames, 5 reps (3 for device_full, "
                   f"entropy_host, fused_total)")
    prof["s"] = secs
    stats[f"profile_416x240x{PROFILE_FRAMES}"] = prof
    log(f"  (c) profile 416x240 x {PROFILE_FRAMES}, QP 32, pink (cut: "
        f"{prof['cut']}), {prof['device']}, {secs:.1f} s: stage ms "
        f"{json.dumps(ms)}; SATD {prof['roofline']['satd_stage']}")
    stats["s"] = time.perf_counter() - t_phase
    log(f"  phase 16: {stats['s']:.1f} s")
    return stats, launches


def _scaling_model_formulas(doc: dict) -> dict:
    """tools/scaling_model.py's model block, written out, at the H100
    figures the port's report must hold (989 BF16 TFLOP/s, 450 GB/s
    NVLink each way, 50 GB/s between hosts)."""
    s = doc["shape"]
    flops = s["batch"] * s["h"] * s["w"] * 35 * 4 * 2 * 8 * 2 * 2
    t_c = flops / 989e12
    t_i = doc["collective_bytes_total"] / 450e9
    t_d = 0.2e6 * s["batch"] / 50e9
    return {"t_compute_s_at_peak": t_c, "t_ici_s": t_i,
            "tile_axis_efficiency": t_c / (t_c + t_i),
            "two_host_frame_parallel_efficiency": t_c / (t_c / 1 + t_d),
            "ici_gbs": 450.0, "dcn_gbs": 50.0, "bf16_tflops": 989.0}


def _fixed_depth_dispatch(h, w, frames, dev):
    """The single-process encode of clip_sine seed 0 at fixed depth 1 on
    the card: (the on-device dict, the host dict with the labels, its K1
    launches)."""
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline import clips
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    enc = FrameEncoder(h, w, QP, device=dev)
    g = enc.geom
    labels = np.ones((frames, g.rc * g.cc, 16), np.int8)
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    dispatched = enc.encode_dispatch(*clips.clip_sine(frames, h, w, seed=0),
                                     labels)
    out = enc.collect(dispatched)
    out["labels"] = labels
    if satd_fused.LAUNCHES != 4:
        fail(f"{w}x{h} x {frames}: K1 launched {satd_fused.LAUNCHES} times, "
             f"not 4")
    check_s2(f"{w}x{h} x {frames} fixed depth", since, h, w, 1)
    check_s3(f"{w}x{h} x {frames} fixed depth", s3, satd_fused.LAUNCHES)
    return dispatched, out, satd_fused.LAUNCHES


def phase_scaling(dev):
    """Phase 17, the scaling path: (a) a gloo world of 4 ranks, mesh
    (1, 4), at TILE4_JOB, equal to the single-process encode key for key
    and in the stream, each rank's tally the closed form of its tile
    (edge or middle); (b) tools/scaling_model_torch.py's main at
    SCALING_ARGV: the JAX tool's keys, every rank's tally the closed
    form, the checksums the single-process encode's, the model the
    formulas. The tool's ranks are its own processes: their K1 and
    stage-2 kernel launches come from its report (4 a rank, at
    k1_rows(128, 512, 1), a grid of M_PATHS; one a diagonal). Returns
    (stats, K1 launches)."""
    from hevctpu_torch.codec import headers, decoder
    from hevctpu_torch.parallel.sharded import tally_closed_form
    t_phase = time.perf_counter()
    job = TILE4_JOB
    h, w, frames = job["h"], job["w"], job["frames"]
    dispatched, want, launches = _fixed_depth_dispatch(h, w, frames, dev)
    cfg = headers.StreamConfig(width=w, height=h, qp=QP,
                               hash_type="checksum")
    t_a = time.perf_counter()
    tile4, n = phase_sharded(
        f"17a_{w}x{h}_tile4", 4, "gloo", job, want,
        decoder.encode_stream(cfg, [want]), cfg, 300,
        want_tally=lambda c: tally_closed_form(h, w, (1, 4), c[1], frames,
                                               dispatched))
    launches += n
    tile4["s"] = time.perf_counter() - t_a
    log(f"  17a: {tile4['s']:.1f} s, every rank's tally the closed form")

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scaling_model_torch
    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = io.StringIO()
        with contextlib.redirect_stdout(report):
            doc = scaling_model_torch.main(SCALING_ARGV + [
                "--deadline", "200", "--out",
                os.path.join(tmp, "SCALING_TORCH")])
        with open(os.path.join(tmp, "SCALING_TORCH.json")) as f:
            if json.load(f) != json.loads(json.dumps(doc, default=float)):
                fail("17b: SCALING_TORCH.json is not the tool's report")
    secs_b = time.perf_counter() - t_b
    keys = {"shape", "collective_bytes", "collective_bytes_total",
            "collective_bytes_per_frame", "analytic_flops", "model"}
    if not keys <= set(doc):
        fail(f"17b: the report lacks {sorted(keys - set(doc))}")
    s = doc["shape"]
    fr, tile, b = s["frame_axis"], s["tile"], s["batch"]
    if (fr, tile) != (2, 4):
        fail(f"17b: mesh {(fr, tile)}, not (2, 4)")
    disp_b, want_b, n = _fixed_depth_dispatch(s["h"], s["w"], b, dev)
    launches += n
    for r in doc["ranks"]:
        closed = tally_closed_form(s["h"], s["w"], (fr, tile),
                                   r["coords"][1], b, disp_b)
        if r["tally"] != closed:
            fail(f"17b rank {r['rank']}: tally {r['tally']}, not the closed "
                 f"form {closed}")
        if r["checksums"] != want_b["hash_checksum"].tolist():
            fail(f"17b rank {r['rank']}: picture checksums differ from the "
                 f"single-process encode")
        if r["k1_launches"] != 4:
            fail(f"17b rank {r['rank']}: K1 launched {r['k1_launches']} "
                 f"times, not 4")
        if r["s2_launches"] != diagonals(s["h"], s["w"]):
            fail(f"17b rank {r['rank']}: the stage-2 kernel launched "
                 f"{r['s2_launches']} times, not "
                 f"{diagonals(s['h'], s['w'])}")
        S2_LAUNCHED[f"17b rank {r['rank']}"] = r["s2_launches"]
        if r["s3_launches"] != S3_PER_DECISION:
            fail(f"17b rank {r['rank']}: stage 1's RD kernel launched "
                 f"{r['s3_launches']} times, not {S3_PER_DECISION}")
        S3_LAUNCHED[f"17b rank {r['rank']}"] = r["s3_launches"]
        launches += r["k1_launches"]
    want_model = _scaling_model_formulas(doc)
    for k, v in want_model.items():
        if abs(doc["model"][k] - v) > 1e-12 * abs(v):
            fail(f"17b: model {k} = {doc['model'][k]}, the formula gives {v}")
    if any(t in report.getvalue() for t in ("v5e", "TPU")):
        fail("17b: the report names a TPU figure")
    tool = dict(s=secs_b, world_wall_s=doc["run"]["wall_s"], shape=s,
                collective_bytes=doc["collective_bytes"],
                collective_bytes_total=doc["collective_bytes_total"],
                frame_axis_gather=doc["frame_axis_gather"],
                model=doc["model"],
                ranks={r["rank"]: dict(wall_s=r["wall_s"],
                                       stage_ms=r["stage_ms"],
                                       tally=r["tally"])
                       for r in doc["ranks"]})
    log(f"  17b: tools/scaling_model_torch.py {' '.join(SCALING_ARGV)}: "
        f"{secs_b:.1f} s; every rank's tally the closed form, checksums "
        f"equal, model = formulas; {json.dumps(tool)}")
    stats = {f"tile4_{w}x{h}": tile4, "tool_128x512": tool,
             "s": time.perf_counter() - t_phase, "k1_launches": launches}
    log(f"  phase 17: {stats['s']:.1f} s, K1 {launches} launches")
    return stats, launches


# one frame, held to phase 6's card stream (cut from 8, phase 4's)
BENCH_JOB = dict(point="416x240", h=240, w=416, frames=1, batch=1, reps=1,
                 warmup="batch")
# two batches, so that run_all's second dispatch returns while the first
# batch encodes on the worker (cut from 16 frames in batches of 8)
BENCH2_JOB = dict(BENCH_JOB, frames=4, batch=2)
# a dispatch returns in under this share of its batch's time
DISPATCH_SHARE = 0.1


def phase_bench(dev, stream_one):
    """Phase 18, bench.py's throughput path through bench_torch.measure:
    (a) at BENCH_JOB, the stream equal to phase 6's card stream
    (stream_one); (b) at BENCH2_JOB,
    run_all's two double-buffered batches, each stream equal to its batch
    encoded alone (dispatch, collect, encode_stream) one after another,
    every dispatch returning in under DISPATCH_SHARE of a batch's ms. K1
    4 launches a batch. Returns (stats, K1 launches)."""
    import bench_torch
    from hevctpu_torch.codec import decoder, headers
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.ops import satd_fused
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    t_phase = time.perf_counter()
    params, weights = bench_torch._load_params()
    runs, cuts, launches = {}, {}, 0
    for key, job in (("a", BENCH_JOB), ("b", BENCH2_JOB)):
        cuts[key] = bench_torch.cuts(job["point"], job["frames"],
                                     job["batch"], job["reps"],
                                     job["warmup"])
        satd_fused.LAUNCHES = 0
        since, s3 = s2_launches(), s3_mark()
        fps, rep_fps, run = bench_torch.measure(
            params, job["h"], job["w"], job["frames"], job["batch"],
            job["reps"], device=dev, warmup=job["warmup"])
        batches = run["batches"]
        want = 4 * (1 + job["reps"] * batches)  # warm-up batch + the reps
        if run["k1_launches_per_pass"] != 4 * batches or \
                satd_fused.LAUNCHES != want:
            fail(f"18{key}: K1 launched {satd_fused.LAUNCHES} times "
                 f"({run['k1_launches_per_pass']} a pass of {batches} "
                 f"batches), not {want}")
        check_s2(f"18{key}", since, job["h"], job["w"],
                 1 + job["reps"] * batches)
        check_s3(f"18{key}", s3, satd_fused.LAUNCHES)
        launches += satd_fused.LAUNCHES
        runs[key] = (fps, rep_fps, run)
    fps, rep_fps, run = runs["a"]
    if run["streams"] != [stream_one]:
        fail(f"18a: bench_torch's stream ({[len(s) for s in run['streams']]}"
             f" bytes) differs from phase 6's ({len(stream_one)} bytes)")

    job = BENCH2_JOB
    h, w, b = job["h"], job["w"], job["batch"]
    y, u, v = bench_torch.synth_clip(job["frames"], h, w)
    enc = FrameEncoder(h, w, QP, device=dev)
    cnn = convnet2.load_model(params, dev)
    cfg = headers.StreamConfig(width=w, height=h, qp=QP,
                               hash_type="checksum")
    seq, seq_ms = [], []
    satd_fused.LAUNCHES = 0
    since, s3 = s2_launches(), s3_mark()
    for i in range(0, job["frames"], b):
        t0 = time.perf_counter()
        handle = enc.encode_fused_dispatch(cnn, y[i:i + b], u[i:i + b],
                                           v[i:i + b], lite=True)
        t1 = time.perf_counter()
        out = enc.collect(handle, lite=True)
        t2 = time.perf_counter()
        seq.append(decoder.encode_stream(cfg, [out]))
        seq_ms.append(dict(dispatch_ms=(t1 - t0) * 1e3,
                           batch_ms=(t2 - t0) * 1e3))
    if satd_fused.LAUNCHES != 4 * len(seq):
        fail(f"18b: the batches alone launched K1 {satd_fused.LAUNCHES} "
             f"times, not {4 * len(seq)}")
    check_s2("18b batches alone", since, h, w, len(seq))
    check_s3("18b batches alone", s3, satd_fused.LAUNCHES)
    launches += satd_fused.LAUNCHES
    _, rep_fps2, run2 = runs["b"]
    if run2["streams"] != seq:
        fail(f"18b: run_all's streams ({[len(s) for s in run2['streams']]} "
             f"bytes) differ from the batches encoded one after another "
             f"({[len(s) for s in seq]} bytes)")
    batch_ms = min(m["batch_ms"] for m in seq_ms)
    slow = [t for t in run2["dispatch_ms"] + [m["dispatch_ms"]
                                               for m in seq_ms]
            if t > DISPATCH_SHARE * batch_ms]
    if slow:
        fail(f"18b: a dispatch took {max(slow):.1f} ms to return, over "
             f"{DISPATCH_SHARE} of a batch's {batch_ms:.1f} ms")
    stats = dict(fps=fps, rep_fps=rep_fps, rep_s=run["rep_s"],
                 warmup_s=run["warmup_s"],
                 warmup_batch_stage_ms=run["warmup_stage_ms"],
                 dispatch_ms=run["dispatch_ms"], stream_ms=run["stream_ms"],
                 peak_mem_gib=run["peak_mem_bytes"] / 2 ** 30,
                 bytes=len(stream_one), cuts=cuts["a"],
                 two_batches=dict(
                     fps=runs["b"][0], rep_s=run2["rep_s"],
                     dispatch_ms=run2["dispatch_ms"],
                     stream_ms=run2["stream_ms"],
                     bytes=[len(s) for s in seq],
                     one_after_another=seq_ms, cuts=cuts["b"]),
                 k1_launches=launches, card=run["device"], weights=weights,
                 s=time.perf_counter() - t_phase)
    log(f"  18a: stream byte-identical to phase 6's ({len(stream_one)} "
        f"bytes), {fps:.4f} fps; 18b: two batches double-buffered equal to "
        f"the batches one after another ({[len(s) for s in seq]} bytes), "
        f"dispatches returned in {run2['dispatch_ms']} ms against a batch's "
        f"{batch_ms:.1f} ms; {json.dumps(stats)}")
    return stats, launches


@contextlib.contextmanager
def record_stage2(store: dict, label: str):
    """Inside: FrameEncoder._reconstruct stores (encoder, arguments) of
    its call under store[label], for phase 19."""
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    real = FrameEncoder._reconstruct

    def recording(self, *args):
        store[label] = (self, args)
        return real(self, *args)

    FrameEncoder._reconstruct = recording
    try:
        yield
    finally:
        FrameEncoder._reconstruct = real


def phase_stage2(recorded: dict, sm_hz: float) -> dict:
    """Phase 19, stage 2's two forms on the card, on the arguments phases
    4 and 5 recorded (tools/stage2_steps.time_forms): the host-planned
    form and the kernel form, its graphs captured anew, under
    torch.cuda.set_sync_debug_mode("error") (nothing read back to the
    host), all 13 planes equal. Per geometry: the planned ms, the ms of
    the kernel-form call that captures and (416x240 only) of one that
    only replays and of its kernel launches alone, the capture ms, the
    graphs' nodes, the replays, the kernel launches and the peak
    memory; and stage 2's bound on those arguments (stage2_steps.bound:
    the coded TUs' transform multiply-adds at the card's INT32 rate, or
    the planes' bytes at HBM's)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import stage2_steps
    res = {}
    for label, (enc, args) in recorded.items():
        try:
            row = stage2_steps.time_forms(enc, args,
                                          replay=label.startswith("416"))
        except ValueError as e:
            fail(f"19 {label}: {e}")
        row.update(stage2_steps.bound(enc, args, INT32_LANES * sm_hz,
                                      HBM_BYTES_PER_S))
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        log(f"  19 {label}: 13 planes equal, no host sync; "
            f"{json.dumps(row)}")
        res[label] = row
    return res


def _np_of(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


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

    def log_phase(msg):
        # the seconds since the start, to budget the script's clock
        log(f"{msg} [{time.perf_counter() - t_start:.1f} s]")

    log_phase("phase 1: card and build")
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
    from hevctpu_torch.ops import stage2_ctu
    s2_build_s, ptxas = stage2_ctu.build()
    log(f"  stage-2 kernel built in {s2_build_s:.2f} s (nvcc, sm_90a, "
        f"--fmad=false); ptxas -v:")
    for line in ptxas.splitlines():
        log(f"    {line.strip()}")
    from hevctpu_torch.ops import stage1_rd
    s3_build_s, ptxas = stage1_rd.build()
    log(f"  stage 1's RD kernel built in {s3_build_s:.2f} s (nvcc, sm_90a, "
        f"--fmad=false); ptxas -v:")
    for line in ptxas.splitlines():
        log(f"    {line.strip()}")
    sm_hz = sm_clock_hz()
    log(f"  max SM clock {sm_hz / 1e6:.0f} MHz: {INT32_LANES * sm_hz:.4g} "
        f"INT32 instructions/s")

    rng = np.random.default_rng(0)
    log_phase("phase 2: K1 against its plain version on the card (tolerance "
              "0: bit-identical)")
    k1 = phase_k1(rng, dev, sm_hz)
    phase_predict_oracle(rng, dev)
    record_k1_shapes()

    log_phase("phase 2b: stage 1's RD kernel against its plain version on "
              "the card (416x240 x 32, 1088x1920 x 8; bit-identical)")
    s3 = phase_stage1_rd(dev, sm_hz)
    record_s3_calls()

    log_phase("phase 3: ConvNet2 labels, card vs CPU (416x240)")
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

    log_phase("phase 4: main path, 416x240 x 8 frames")
    launches = 0
    stage2_args = {}
    torch.cuda.reset_peak_memory_stats()
    with record_stage2(stage2_args, "416x240x8"):
        sd, out_sd, stream_sd = run_path(240, 416, 8, cnn, dev, "416x240")
    launches += sd["k1_launches"]

    log_phase("phase 5: main path, 1920x1080 x 1 frame")
    torch.cuda.reset_peak_memory_stats()
    with record_stage2(stage2_args, "1920x1080x1"):
        hd, _, _ = run_path(1080, 1920, 1, cnn, dev, "1920x1080")
    launches += hd["k1_launches"]

    log_phase("phase 6: one 416x240 frame, card vs CPU port")
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

    with tempfile.TemporaryDirectory() as tmp:
        from hevctpu_torch.pipeline import yuv
        yuv.write_yuv420(os.path.join(tmp, "in416.yuv"),
                         *clips.clip_sine(CLI_FRAMES, 240, 416, seed=0))
        log_phase(f"phase 7: CLI encode --search rd, 416x240 x {CLI_FRAMES} "
                  "frames (one batch), then decode")
        cli_rd, _ = phase_cli(tmp, ["--search", "rd"], CLI_FRAMES, "cli_rd",
                              4, 1)
        launches += cli_rd["k1_launches"]
        log(f"  cli_rd: {json.dumps(cli_rd)}")
        cli_rd["frame0_card_vs_cpu_bytes"] = rd_frame_card_vs_cpu(tmp, dev)

        log_phase("phase 8: CLI encode, R-λ rate control with per-CTU QP "
                  "(--target-kbps 1000, LCULevelRateControl), 416x240 x "
                  f"{CLI_FRAMES}")
        lcu_cfg = os.path.join(tmp, "lcu_rc.cfg")
        with open(lcu_cfg, "w") as f:
            f.write("LCULevelRateControl : 1\n")
        cli_rc, dec = phase_cli(
            tmp, ["-c", lcu_cfg, "--target-kbps", "1000", "--search", "cnn",
                  "--model", os.path.join(ROOT, "CKPT_DOMAIN.npz")],
            CLI_FRAMES, "cli_rc", 4 * CLI_FRAMES, CLI_FRAMES)
        launches += cli_rc["k1_launches"]
        ctu_qps = sorted(set(np.concatenate(
            [m.ravel() for m in dec.qp_maps]).tolist()))
        if len(ctu_qps) < 2:
            fail(f"cli_rc: the stream codes one CTU QP only ({ctu_qps})")
        cli_rc["ctu_qps"] = ctu_qps
        log(f"  cli_rc: per-picture QPs {cli_rc['qps']}, coded CTU QPs "
            f"{ctu_qps}, achieved {cli_rc['kbps']} kbps (target 1000)")

        log_phase("phase 9: search=rd with a random per-CTU QP map, 128x192 "
                  "x 2, card vs CPU port")
        cuqp = phase_cuqp_card_vs_cpu(dev)
        launches += cuqp["k1_launches"]

        log_phase(f"phase 10: serving options, 416x240 x {OPTIONS_FRAMES} "
                  "frames, CNN labels")
        torch.cuda.reset_peak_memory_stats()
        ctx, _, _ = run_path(240, 416, OPTIONS_FRAMES, cnn, dev,
                             f"ctx_416x240x{OPTIONS_FRAMES}",
                             rate_model="ctx")
        launches += ctx["k1_launches"]
        torch.cuda.reset_peak_memory_stats()
        two, _, _ = run_path(240, 416, OPTIONS_FRAMES, cnn, dev,
                             f"two_pass_416x240x{OPTIONS_FRAMES}",
                             want_launches=8, two_pass=True)
        launches += two["k1_launches"]
        lite, n = phase_lite(cnn, dev)
        launches += n
        stage1 = stage1_warm_ms(cnn, dev)

        log_phase("phase 11: ctx and two_pass with search=rd, 128x192 x 2, "
                  "card vs CPU port")
        opts, n = phase_options_card_vs_cpu(dev)
        launches += n

        log_phase("phase 12: training; (a) CLI train on the 416x240 x "
                  f"{CLI_FRAMES} file")
        train_cli, n = phase_train_cli(tmp, dev)
        launches += n
        log("  (b, c) ConvNet2 at batch 256 on one 1920x1080 frame, card vs "
            "CPU port, and the warm step")
        train_step = phase_train_step(cnn, dev, sm_hz)

    log_phase("phase 13: the multi-device encoder, ranks spawned on the one "
              "card")
    sharded = {}
    cfg_t2 = headers.StreamConfig(width=TILE2_JOB["w"], height=TILE2_JOB["h"],
                                  qp=QP, hash_type="checksum")
    out_t2 = FrameEncoder(TILE2_JOB["h"], TILE2_JOB["w"], QP,
                          device=dev).encode_fused(
        cnn, *clips.clip_sine(1, TILE2_JOB["h"], TILE2_JOB["w"], seed=0))
    stream_t2 = decoder.encode_stream(cfg_t2, [out_t2])
    for key, world, backend, job, want, stream, timeout_s in (
            ("13a_416x240x8_frame2", 2, "gloo",
             dict(h=240, w=416, frames=8, tile=1, clip="sine"), out_sd,
             stream_sd, 400),
            (f"13b_{TILE2_JOB['w']}x{TILE2_JOB['h']}_tile2", 2, "gloo",
             TILE2_JOB, out_t2, stream_t2, 300)):
        sharded[key], n = phase_sharded(
            key, world, backend, job, want, stream,
            headers.StreamConfig(width=job["w"], height=job["h"], qp=QP,
                                 hash_type="checksum"), timeout_s)
        launches += n
    cfg_c = headers.StreamConfig(width=192, height=128, qp=QP)
    want_c = FrameEncoder(128, 192, QP, device=dev).encode_fused(
        cnn, *cuqp_clip())
    sharded["13c_128x192x2_nccl"], n = phase_sharded(
        "13c_128x192x2_nccl", 1, "nccl",
        dict(h=128, w=192, frames=2, tile=None, clip="cuqp"), want_c,
        decoder.encode_stream(cfg_c, [want_c]), cfg_c, 200)
    launches += n

    log_phase("phase 14: ops/inter.py on the card against the CPU port "
              "(416x240)")
    inter_res = phase_inter(dev)

    log_phase("phase 15: the calibration path on the card (rate weights, "
              "context counts, domain CNN), 416x240, then card vs CPU at "
              "64x128")
    calib, n = phase_calibrate(dev)
    launches += n

    log_phase("phase 16: the evaluation path on the card (corpus RD against "
              "the cached HM, card vs CPU at 64x128, the stage profile)")
    evaluation, n = phase_evaluate(dev)
    launches += n

    log_phase("phase 17: the scaling path (tile-4 mesh, byte tally, "
              "tools/scaling_model_torch.py)")
    scaling, n = phase_scaling(dev)
    launches += n

    log_phase("phase 18: bench.py's throughput path (bench_torch.measure), "
              "one 416x240 frame against phase 6, and x 4 in two batches")
    bench_sd, n = phase_bench(dev, streams[0])
    launches += n

    log_phase("phase 19: stage 2 on the card, the kernel form (no host "
              "sync) against the planned form, at phase 4's and phase 5's "
              "arguments")
    stage2 = phase_stage2(stage2_args, sm_hz)

    unchecked = sorted(K1_LAUNCHED - k1["checked"])
    if unchecked:
        fail(f"K1 launched at (n, M, luma) {unchecked}, never held against "
             f"its plain version in phase 2")
    log(f"  K1 launched at {len(K1_LAUNCHED)} (n, M, luma) shapes, each "
        f"bit-identical to the plain version in phase 2")

    kernels = [dict(name="satd_mode_costs", route="cuda",
                    source="hevctpu_torch/csrc/satd_fused.cu",
                    replaces="hevctpu/ops/satd_fused.py:119",
                    launches=launches, max_abs_err=k1["max_abs_err"],
                    ms=k1["ms"], plain_ms=k1["plain_ms"],
                    bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
                    library_ms=None),
               dict(name="stage2_ctu", route="cuda",
                    source="hevctpu_torch/csrc/stage2_ctu.cu",
                    replaces=None, build_s=s2_build_s,
                    launches=sum(S2_LAUNCHED.values()),
                    launches_by_path=S2_LAUNCHED,
                    phase19_launches={k: r["kernel_launches"]
                                      for k, r in stage2.items()},
                    ms={k: r["kernel_ms"] for k, r in stage2.items()},
                    plain_ms={k: r["planned_ms"]
                              for k, r in stage2.items()},
                    bound_ms={k: r["bound_ms"] for k, r in stage2.items()},
                    bound_by={k: r["bound_by"] for k, r in stage2.items()},
                    library_ms=None),
               dict(name="stage1_rd", route="cuda",
                    source="hevctpu_torch/csrc/stage1_rd.cu",
                    replaces=None, build_s=s3_build_s,
                    launches=sum(S3_LAUNCHED.values()),
                    launches_by_path=S3_LAUNCHED,
                    ms={k: r["ms"] for k, r in s3.items()},
                    plain_ms={k: r["plain_ms"] for k, r in s3.items()},
                    bound_ms={k: r["bound_ms"] for k, r in s3.items()},
                    bound_by="int32", library_ms=None)]
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"paths": {"416x240": sd, "1920x1080": hd,
                                f"cli_rd_416x240x{CLI_FRAMES}": cli_rd,
                                f"cli_rc_416x240x{CLI_FRAMES}": cli_rc,
                                "cuqp_128x192x2": cuqp,
                                "ctx_416x240": ctx,
                                "two_pass_416x240": two,
                                "lite_416x240": lite,
                                "stage1_warm_416x240": stage1,
                                "options_128x192x2": opts,
                                f"train_416x240x{CLI_FRAMES}": train_cli,
                                "train_step_1080p": train_step,
                                "sharded": sharded,
                                "inter_416x240": inter_res,
                                "calibrate": calib,
                                "evaluate": evaluation,
                                "scaling": scaling,
                                "bench_416x240": bench_sd,
                                "stage2_forms": stage2},
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
