"""Whole runs of the harness at a tiny size on the CPU (the look for a
card skipped, the program's plain CPU path underneath): the result line's
keys, a sound run judged correct, and runs with the timed path broken
judged not correct, once for each fault a one-card encoder cell can have
(the exchange between cards has no part in it)."""

import json
import os
import time

import numpy as np
import pytest

import _setup
from cellbench import main, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_root(tmp_path):
    """A checkout root with one cell: 64x128, batches of 2, two families."""
    bench = spec.load_benchmark()
    cfg = json.load(open(os.path.join(
        spec.ROOT, bench["configs"][0]["file"])))
    cfg.update(name="tiny", width=128, height=64,
               weights=os.path.join(spec.ROOT, cfg["weights"]))
    d = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir(parents=True)
    (d / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (d / "traffic" / "tiny_mix.json").write_text(json.dumps(dict(
        qp=32, batch=2, in_flight=2, families=["pink", "detail"],
        check_frames=2)))
    limits = json.load(open(os.path.join(
        _setup.BENCH, "limits", bench["workloads"][0]["name"] + ".json")))
    (d / "limits" / "tiny_cell.json").write_text(json.dumps(limits))
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="benchmark/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name="tiny_cell",
                               config="tiny", traffic="tiny_mix")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def run_tiny(root, capsys, trace=0, seconds=2.0):
    rc = main.run(["--workload", "tiny_cell", "--seed", str(2**31 + 9),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  t_start=time.perf_counter(), device="cpu",
                  chip_check=lambda n: None, root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    return line, out.err


def test_sound_run(tmp_path, capsys):
    line, err = run_tiny(tiny_root(tmp_path), capsys)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2 and line["attempted"] % 2 == 0
    assert set(line["metrics"]) == {"fps", "peak_mem_gib", "setup_s"}
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    lines = err.strip().splitlines()
    n = len(line["checks"])
    assert [x.split()[1] for x in lines[-n:]] == list(line["checks"])


def test_traced_run_keys(tmp_path, capsys):
    line, _ = run_tiny(tiny_root(tmp_path), capsys, trace=1, seconds=3.0)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"host_stream_ms_per_frame", "stage2_ms_per_diag"} <= set(
        line["metrics"])


def _stale(monkeypatch, enc_cls):
    first = {}
    collect = enc_cls.collect

    def stale(self, dev_out, *, lite=False):
        out = collect(self, dev_out, lite=lite)
        return first.setdefault("out", out)
    monkeypatch.setattr(enc_cls, "collect", stale)


def _half(monkeypatch, enc_cls):
    dispatch = enc_cls.encode_fused_dispatch

    def half(self, cnn, y, u, v, *, lite=False):
        n = max(1, len(y) // 2)
        return dispatch(self, cnn, y[:n], u[:n], v[:n], lite=lite)
    monkeypatch.setattr(enc_cls, "encode_fused_dispatch", half)


def _level(monkeypatch, enc_cls):
    collect = enc_cls.collect

    def altered(self, dev_out, *, lite=False):
        out = collect(self, dev_out, lite=lite)
        out["levels_y"] = out["levels_y"].copy()
        out["levels_y"][:, 0, 0] += 1
        return out
    monkeypatch.setattr(enc_cls, "collect", altered)


def _level_at_source(monkeypatch, enc_cls):
    """Stage 2's quantiser returns its levels with the sign turned: the
    reconstruction, the stream and the served levels agree with each
    other, and only a reference of the levels can tell."""
    from hevctpu_torch.ops import quant
    rdoq = quant.quantize_rdoq

    def turned(*args, **kwargs):
        return -rdoq(*args, **kwargs)
    monkeypatch.setattr(quant, "quantize_rdoq", turned)


def _label(monkeypatch, enc_cls):
    collect = enc_cls.collect

    def altered(self, dev_out, *, lite=False):
        out = collect(self, dev_out, lite=lite)
        out["labels"] = out["labels"].copy()
        out["labels"][:, 0, :] = np.where(out["labels"][:, 0, :] == 3, 2, 3)
        return out
    monkeypatch.setattr(enc_cls, "collect", altered)


@pytest.mark.parametrize("fault, trips", [
    (_stale, "cnn_gap"), (_half, "frames_missing"),
    (_level, "filters_mismatch"), (_level_at_source, "levels_outside"),
    (_label, "stage1_mismatch")],
    ids=["state_unchanged", "half_batch", "level_altered",
         "level_altered_at_source", "labels_altered"])
def test_broken_path_is_not_correct(tmp_path, capsys, monkeypatch, fault,
                                    trips):
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    fault(monkeypatch, FrameEncoder)
    line, err = run_tiny(tiny_root(tmp_path), capsys)
    assert line["correct"] is False, err[-2000:]
    assert line["failed"] > 0
    row = line["checks"][trips]
    assert row["value"] > row["limit"], line["checks"]


def test_no_card_no_result(tmp_path, capsys):
    rc = main.run(["--workload", "tiny_cell", "--seed", "1", "--seconds",
                   "1"], t_start=time.perf_counter(),
                  chip_check=lambda n: "CUDA is not available",
                  root=tiny_root(tmp_path))
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_chip_check_counts_cards(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main.chips_present(1) is None
    assert main.chips_present(4) is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main.chips_present(1) is not None
