"""The traced run's device trace: torch.profiler (CUPTI) over a bounded
slice of the window, reduced in memory to what the per-layer metrics and
the breakdown read. No trace file is written.

The slice covers a batch encoded after the window (window.traced_batch):
from before its dispatch to the end of its device work.
Its length is the span of the harness's "harness.trace" range on the host;
the device is busy where some kernel, copy or set runs, merged over
overlaps; an idle gap is named by the harness's host ranges
(harness.dispatch, .wait, .collect, .encode_stream) that overlap it, else
"worker": the main thread only polls then, and the encoder's worker
thread, which issues the device work, is not traced on the host.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

_K1 = re.compile(r"satd_mode_costs_kernel<(\d+)>")
TOP = 10
NAME_CHARS = 160


def short(name: str) -> str:
    """A kernel's name for the breakdown: without "void " and cut to
    NAME_CHARS characters (templated names run to thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


class Tracer:
    def __init__(self):
        self._prof = None
        self._range = None
        self.events = None
        self.seconds = {}

    def start(self):
        t0 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._range = torch.profiler.record_function("harness.trace")
        self._range.__enter__()
        self.t_start = time.perf_counter()
        self.seconds = {"start": self.t_start - t0}

    def wait_then_stop(self, handle):
        """Poll until handle's device work has ended, then stop. The stop
        waits for the whole batch: stopping the profiler while the
        encoder's worker thread still launches stage 2's graph replays
        deadlocks the two threads (the worker in CUDAGraph.replay, the
        caller in the profiler's exit)."""
        if self._prof is None:
            return
        while True:
            if handle.done():
                clock = handle.clock
                if clock.device.type != "cuda" or clock.marks[-1][1].query():
                    break
            time.sleep(0.002)
        self._range.__exit__(None, None, None)
        t0 = time.perf_counter()
        self._prof.stop()
        t1 = time.perf_counter()
        self.events = self._prof.profiler.kineto_results.events()
        self._prof = None
        self.seconds.update(traced=t0 - self.t_start, stop=t1 - t0,
                            events=time.perf_counter() - t1)

    def reduce(self) -> dict | None:
        """{window_s, busy_s, kernels: {name: s}, k1: [(n, s)], gaps:
        [(name, s)] longest first} or None when nothing was traced."""
        if self.events is None:
            return None
        t0 = time.perf_counter()
        cpu = torch.autograd.DeviceType.CPU
        host, starts, durs, names = [], [], [], []
        span = None
        for e in self.events:
            if e.device_type() == cpu:
                name = e.name()
                if name.startswith("harness."):
                    a = e.start_ns()
                    if name == "harness.trace":
                        span = (a, a + e.duration_ns())
                    else:
                        host.append((a, a + e.duration_ns(), name[8:]))
            else:
                starts.append(e.start_ns())
                durs.append(e.duration_ns())
                names.append(e.name())
        if span is None:
            return None
        a = np.array(starts, np.int64)
        out = reduce_intervals(span, (a, a + np.array(durs, np.int64), names),
                               host)
        self.seconds.update(reduce=time.perf_counter() - t0,
                            count=len(self.events))
        return out


def reduce_intervals(span, dev, host) -> dict:
    """Tracer.reduce on plain intervals: span (t0, t1) ns, dev (starts,
    ends, kernel names) of the device events, host [(t0, t1, range
    name)]."""
    s0, s1 = span
    a0, b0, names = np.asarray(dev[0], np.int64), np.asarray(dev[1],
                                                             np.int64), dev[2]
    a, b = np.clip(a0, s0, s1), np.clip(b0, s0, s1)
    ids: dict = {}
    nid = np.fromiter((ids.setdefault(n, len(ids)) for n in names), np.int64,
                      len(names))
    keep = b > a
    tot = np.bincount(nid[keep], (b - a)[keep], len(ids)) * 1e-9
    kernels = {n: float(tot[i]) for n, i in ids.items() if tot[i] > 0}
    k1 = []
    for n, i in ids.items():
        m = _K1.search(n)
        if m:
            whole = (nid == i) & (a == a0) & (b == b0) & keep   # unclipped
            k1 += [(int(m.group(1)), float(t))
                   for t in (b[whole] - a[whole]) * 1e-9]
    order = np.argsort(a[keep], kind="stable")
    a, b = a[keep][order], b[keep][order]
    reach = np.maximum.accumulate(b) if len(b) else b
    prev = np.concatenate([[s0], reach[:-1]])[: len(a)]
    end = reach[-1] if len(b) else s0
    gp = np.concatenate([prev, [end]])          # each gap's start and end
    gq = np.concatenate([a, [s1]])
    open_ = gq > gp
    gp, gq = gp[open_], gq[open_]
    idle = int((gq - gp).sum())
    longest = np.argsort(gp - gq, kind="stable")[:TOP]
    named = []
    for p, q in zip(gp[longest].tolist(), gq[longest].tolist()):
        over = sorted({n for h0, h1, n in host if h0 < q and h1 > p})
        named.append(("+".join(over) if over else "worker", (q - p) * 1e-9))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    top = [(short(n), float(t)) for n, t in top]
    return dict(window_s=(s1 - s0) * 1e-9, busy_s=(s1 - s0 - idle) * 1e-9,
                kernels=kernels, top_kernels=top, k1=k1, gaps=named)
