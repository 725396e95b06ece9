"""bench_torch.py, the port of bench.py, against bench.py itself on the
CPU: the same points, clip and checkpoint; at 64x128 x 4 frames in
batches of 2, its streams are byte-identical to those of bench.py's own
measure (caught at hevctpu.codec.decoder.encode_stream, which bench.py
calls; one JAX compile, the lite encode of tests/test_torch_lite.py) and
decode with the checksum SEI verifying; main writes bench.py's metric
lines and its own detail file with every cut; without CUDA, measure
raises unless the caller names the CPU."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import bench
import bench_torch
from hevctpu.codec import decoder as jdecoder
from hevctpu_torch.codec import decoder


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FRAMES, BATCH, REPS = 64, 128, 4, 2, 1
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module")
def runs():
    """(the port's measure result, bench.py's streams of its last pass)."""
    port = bench_torch.measure(bench_torch._load_params()[0], H, W, FRAMES,
                               BATCH, REPS, device="cpu")
    caught = []
    real = jdecoder.encode_stream

    def catching(cfg, outs):
        caught.append(real(cfg, outs))
        return caught[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdecoder, "encode_stream", catching)
        bench.measure(bench._load_params(), H, W, FRAMES, BATCH, REPS)
    batches = -(-FRAMES // BATCH)
    assert len(caught) == batches * (1 + REPS)
    return port, caught[-batches:]


@pytest.mark.parametrize("name", ["H", "W", "QP", "FRAMES", "BATCH", "REPS",
                                  "H2", "W2", "FRAMES2", "BATCH2", "REPS2",
                                  "DEFAULT_ANCHOR_FPS",
                                  "DEFAULT_ANCHOR_1080P_FPS"])
def test_points_and_defaults_are_bench_pys(name):
    assert getattr(bench_torch, name) == getattr(bench, name)


def test_synth_clip_and_params_are_bench_pys():
    for a, b in zip(bench_torch.synth_clip(3, 32, 48),
                    bench.synth_clip(3, 32, 48)):
        np.testing.assert_array_equal(a, b)
    params, source = bench_torch._load_params()
    assert source == "CKPT_DOMAIN.npz"
    ref = bench._load_params()
    assert set(params) == set(ref)
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(params[layer][k],
                                          np.asarray(ref[layer][k]))


def test_streams_equal_bench_pys(runs):
    (fps, rep_fps, run), ref = runs
    assert run["batches"] == len(ref) == 2
    assert len(run["streams"]) == len(ref)
    for got, want in zip(run["streams"], ref):
        assert got == want
    assert len(rep_fps) == REPS and fps == rep_fps[0] > 0
    assert run["device"] == "cpu" and run["peak_mem_bytes"] is None
    assert run["k1_launches_per_pass"] == 0     # the CPU runs K1's plain form
    assert {"cnn", "stage1", "stage2", "filters"} <= set(
        run["warmup_stage_ms"])


def test_streams_decode_with_checksum_verifying(runs):
    (_, _, run), _ = runs
    for stream in run["streams"]:
        dec = decoder.Decoder()
        frames = dec.decode(stream)
        assert len(frames) == BATCH
        assert len(dec.hashes_ok) == BATCH and all(dec.hashes_ok)
        assert all(f[0].shape == (H, W) for f in frames)


def test_main_lines_and_detail(tmp_path, monkeypatch):
    # bench.py's widths are too slow for the CPU port: both points run at
    # 64x128, the flags cut frames, batch, reps and warm-up.
    for name in bench_torch.POINTS:
        monkeypatch.setitem(bench_torch.POINTS, name,
                            dict(bench_torch.POINTS[name], h=H, w=W))
    real = bench_torch.measure
    monkeypatch.setattr(bench_torch, "measure",
                        lambda *a, **k: real(*a, device="cpu", **k))
    guarded = [os.path.join(ROOT, f) for f in ("BENCH_DETAIL.json",
                                                bench_torch.DETAIL)]
    before = [open(p, "rb").read() if os.path.exists(p) else None
              for p in guarded]
    out = tmp_path / "detail.json"
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        bench_torch.main(["--frames", "2", "--batch", "2", "--reps", "1",
                          "--warmup", "batch", "--out", str(out)])
    line_hd = json.loads(stdout.getvalue().splitlines()[-1])
    line_sd = json.loads(stderr.getvalue().splitlines()[-1])
    assert set(line_hd) == set(line_sd) == LINE_KEYS
    assert line_sd["metric"] == "ai_encode_fps_416x240_qp32"
    assert line_hd["metric"] == "ai_encode_fps_1080p_qp32"
    assert line_sd["unit"] == line_hd["unit"] == "frames/s"

    detail = json.load(open(out))
    assert [p["metric"] for p in detail["points"]] == [line_sd["metric"],
                                                       line_hd["metric"]]
    for p, line, (path, key) in zip(
            detail["points"], (line_sd, line_hd),
            (("BASELINE_MEASURED.json", "hm_ai_416x240_fps"),
             ("BASELINE_1080P.json", "hm_ai_1080p_fps"))):
        anchor = json.load(open(os.path.join(ROOT, path)))[key]
        assert p["anchor_fps"] == anchor and p["anchor_file"] == path
        assert {k: p[k] for k in LINE_KEYS} == line
        assert line["value"] == round(p["fps"], 3)
        assert line["vs_baseline"] == round(p["fps"] / anchor, 3)
        assert p["rep_fps"] == [round(f, 3) for f in p["rep_fps_unrounded"]]
        default = bench_torch.POINTS[
            "416x240" if line is line_sd else "1080p"]
        assert p["cuts"] == {
            "frames": {"default": default["frames"], "run": 2},
            "batch": {"default": default["batch"], "run": 2},
            "reps": {"default": 3, "run": 1},
            "warmup": {"default": "full", "run": "batch"}}
        assert (p["frames"], p["batch"], p["reps"], p["warmup"]) == (
            2, 2, 1, "batch")
        assert p["card"] == "cpu" and p["peak_mem_bytes"] is None
        assert "stage2" in p["warmup_batch_stage_ms"]
    after = [open(p, "rb").read() if os.path.exists(p) else None
             for p in guarded]
    assert after == before


def test_cuts_empty_at_bench_pys_defaults():
    for name, p in bench_torch.POINTS.items():
        assert bench_torch.cuts(name, p["frames"], p["batch"], p["reps"],
                                "full") == {}


def test_measure_needs_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: measure would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.measure(bench_torch._load_params()[0], H, W, 2, 2, 1)
    with pytest.raises(ValueError, match="warmup"):
        bench_torch.measure({}, H, W, 2, 2, 1, device="cpu", warmup="none")
