"""The readers of the program's counters (stage2_capture_s,
cabac_ms_per_frame) on hand-made counters, and on a program that keeps
none."""

import sys

import pytest

import _setup  # noqa: F401
from cellbench import spec

COUNTS = {"stage2.captures": 1, "stage2.capture_ms": 2345.5,
          "stage2.graph_nodes": 16204, "stage2.replays": 3432,
          "stage2.evictions": 0, "cabac.calls": 384, "cabac.ms": 3840.0}


@pytest.fixture
def counters(monkeypatch):
    from hevctpu_torch.pipeline import trace
    counts = dict(COUNTS)
    monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return counts


def test_capture_s(counters, capsys):
    assert spec.reader("stage2_capture_s")({}) == pytest.approx(2.3455)
    err = capsys.readouterr().err
    assert "captures 1, evictions 0" in err and "captured again" not in err


def test_an_eviction_is_told(counters, capsys):
    counters.update({"stage2.captures": 2, "stage2.evictions": 1})
    spec.reader("stage2_capture_s")({})
    assert "captured again" in capsys.readouterr().err


def test_cabac_ms_per_frame(counters):
    assert spec.reader("cabac_ms_per_frame")({}) == pytest.approx(10.0)
    counters.update({"cabac.calls": 0, "cabac.ms": 0.0})
    assert spec.reader("cabac_ms_per_frame")({}) is None


@pytest.mark.parametrize("name", ["stage2_capture_s", "cabac_ms_per_frame"])
def test_a_program_without_counters_gives_nothing(name, monkeypatch):
    from hevctpu_torch import pipeline
    monkeypatch.setitem(sys.modules, "hevctpu_torch.pipeline.trace", None)
    monkeypatch.delattr(pipeline, "trace", raising=False)
    assert spec.reader(name)({}) is None
