"""Cells, mixes, configurations, limits and metric readers are found by
the names BENCHMARK.json gives, and the file keeps to the benchmark's
contract."""

import json
import os
import re

import pytest

import _setup  # noqa: F401
from cellbench import spec, traffic, window

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"fps", "peak_mem_gib", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] == 0.25


def test_per_layer_metrics_have_readers_and_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_cell_lookup(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    window.check_config(cell.config)
    mix = traffic.Mix.from_dict(cell.traffic)
    assert mix.in_flight == 2 and mix.check_frames >= 1
    assert {m.name for m in cell.end_to_end} == {"fps", "peak_mem_gib",
                                                "setup_s"}
    assert {m.name for m in cell.per_layer} == {
        m["name"] for m in BENCH["per_layer"]}
    assert set(cell.limits) >= {"cnn_gap", "stage1_mismatch",
                                "stage2_mismatch", "filters_mismatch",
                                "stream_mismatch", "frames_missing"}


def test_configs_state_what_they_run():
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and c["reduced"] == []
        assert cfg["search"] == "cnn" and cfg["rate_model"] == "global"
        assert os.path.exists(os.path.join(spec.ROOT, cfg["weights"]))
        rc, cc = -(-cfg["height"] // 64), -(-cfg["width"] // 64)
        assert cfg["ctu_grid"] == [rc, cc]
        assert cfg["diagonals"] == 2 * rc + cc - 2


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such_cell")


def test_a_metric_limited_to_cells():
    m = spec.Metric("x", "ms", "lower", "host_clock", "per_layer", "fps",
                    ("a",))
    assert m.applies("a", {"fps"}) and not m.applies("b", {"fps"})
    m = spec.Metric("y", "ms", "lower", "host_clock", "per_layer", "fps",
                    None)
    assert m.applies("b", {"fps"}) and not m.applies("b", {"other"})
