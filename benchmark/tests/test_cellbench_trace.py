"""The trace reduction on hand-made intervals, and the readers on a
hand-made record."""

import numpy as np
import pytest

import _setup  # noqa: F401
from cellbench import roofline, spec, trace


def test_busy_gaps_and_k1():
    dev = [(10, 20, "a"), (15, 30, "void satd_mode_costs_kernel<8>(int*)"),
           (50, 60, "b"), (95, 120, "c"), (200, 210, "outside")]
    host = [(55, 80, "collect")]
    r = trace.reduce_intervals((0, 100), list(zip(*dev)), host)
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["busy_s"] == pytest.approx(35e-9)
    assert [n for n, _ in r["gaps"]] == ["collect", "worker", "worker"]
    assert [t for _, t in r["gaps"]] == pytest.approx([35e-9, 20e-9, 10e-9])
    assert r["k1"] == [(8, pytest.approx(15e-9))]
    assert r["kernels"]["c"] == pytest.approx(5e-9)
    assert "outside" not in r["kernels"]


def test_a_clipped_k1_launch_is_not_counted():
    r = trace.reduce_intervals((0, 100), ([90], [110],
                                ["satd_mode_costs_kernel<4>"]), [])
    assert r["k1"] == []


def test_no_device_event_is_all_idle():
    r = trace.reduce_intervals((0, 100), ([], [], []), [(0, 100, "wait")])
    assert r["busy_s"] == 0 and r["gaps"] == [("wait", pytest.approx(1e-7))]


def test_long_names_are_cut():
    assert len(trace.short("void " + "x" * 1000)) == trace.NAME_CHARS
    assert trace.short("void f<1>()") == "f<1>()"


def _record():
    tz = np.full((2, 8, 8), 3)
    cd = np.ones_like(tz, bool)
    stage = dict(cnn=2.0, stage1=4.0, stage2=1300.0, filters=1.0)
    b = dict(frames=2, host_ms=30.0, stage_ms=stage,
             tusz8=tz, coded8=cd)
    tr = dict(window_s=2.0, busy_s=1.5, k1=[(8, 1e-3), (4, 2e-3)],
              kernels={}, top_kernels=[], gaps=[])
    return dict(height=64, width=64, batch=2, batches=[b, b],
                trace=tr,
                peaks=roofline.PEAKS["NVIDIA H100 80GB HBM3"])


def test_readers_on_a_record():
    rec = _record()
    read = {m: spec.reader(m)(rec) for m in (
        "host_stream_ms_per_frame", "cnn_ms_per_frame", "stage1_ms_per_frame",
        "filters_ms_per_frame", "stage2_ms_per_diag",
        "k1_roofline_pct", "stage2_roofline_pct", "step_mfu")}
    assert read["host_stream_ms_per_frame"] == pytest.approx(15.0)
    assert read["cnn_ms_per_frame"] == pytest.approx(1.0)
    assert read["stage1_ms_per_frame"] == pytest.approx(2.0)
    assert read["filters_ms_per_frame"] == pytest.approx(0.5)
    assert read["stage2_ms_per_diag"] == pytest.approx(1300.0)   # D = 1
    p = rec["peaks"]
    k1 = (roofline.k1_bound(8, 2 * 64, p)[0]
          + roofline.k1_bound(4, 2 * 256, p)[0])
    assert read["k1_roofline_pct"] == pytest.approx(100 * k1 / 3e-3)
    s2 = 2 * roofline.stage2_bound(rec["batches"][0]["tusz8"],
                                   rec["batches"][0]["coded8"], 64, 64, p)
    assert read["stage2_roofline_pct"] == pytest.approx(100 * s2 / 2.6)
    assert 0 < read["step_mfu"] < 100


def test_readers_without_a_trace_or_peaks_read_nothing():
    rec = dict(_record(), trace=None, peaks=None)
    for m in ("k1_roofline_pct", "stage2_roofline_pct",
              "step_mfu"):
        assert spec.reader(m)(rec) is None
