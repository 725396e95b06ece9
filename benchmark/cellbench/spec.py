"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root names the cells (workloads), configurations and metrics; a
configuration is the file its entry names, a traffic mix
benchmark/traffic/<name>.json, a cell's correctness limits
benchmark/limits/<cell>.json and a per-layer metric's reader
benchmark/metrics/<name>.py.
Adding a cell, a mix or a metric adds files and entries; no code here
names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str                  # "end_to_end" or "per_layer"
    moves: str | None
    workloads: tuple | None    # None: every cell that reports `moves`

    def applies(self, cell: str, reported: set) -> bool:
        """Whether the metric is reported in `cell`, whose end-to-end
        metrics are `reported`."""
        if self.workloads is not None:
            return cell in self.workloads
        return self.kind == "end_to_end" or self.moves in reported


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: tuple
    per_layer: tuple


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str | None = None) -> dict:
    return _read_json(os.path.join(root or ROOT, "BENCHMARK.json"))


def metrics(bench: dict) -> list:
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            wl = m.get("workloads")
            out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                              kind, m.get("moves"),
                              tuple(wl) if wl is not None else None))
    return out


def cell(name: str, bench: dict | None = None,
         root: str | None = None) -> Cell:
    """The cell `name` with its configuration, traffic mix and limits read
    from their files under root (default: the checkout's); raises KeyError
    for a name BENCHMARK.json lacks."""
    root = root or ROOT
    bench = load_benchmark(root) if bench is None else bench
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(wl))})")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, cfgs[w["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    traffic = _read_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(here, "limits", f"{name}.json"))
    ms = metrics(bench)
    e2e = tuple(m for m in ms if m.kind == "end_to_end"
                and m.applies(name, set()))
    reported = {m.name for m in e2e}
    per_layer = tuple(m for m in ms if m.kind == "per_layer"
                      and m.applies(name, reported))
    return Cell(name, config, traffic, limits, int(w["chips"]), e2e,
                per_layer)


def reader(metric: str):
    """metrics/<metric>.py's read(record) -> value or None."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"cellbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
