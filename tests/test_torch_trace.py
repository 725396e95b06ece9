"""Each dispatch's record (pipeline/trace.py, Dispatch.trace) and the
process's counters, at 64x128 on the CPU (D = 2 stage-2 diagonals):

- the spans of one dispatch nest, each inside its parent and on the
  parent its thread gives it, under the dispatch's one number;
- stage2.diag comes D times a stage-2 run (twice D under two_pass);
- a span's self time is its duration less its children's;
- stage_ms() keeps its keys;
- an encoder keeps no record but its newest dispatch's, and the worker
  thread none once an encode has returned;
- the native coder counts a call a picture, and its ms;
- a span read inside a torch.profiler range lies inside that range on
  the profiler's clock, within 50 us, after Record.unix_ns;
- the memory counters: present from import and 0 on the CPU, count_max
  safe across threads, and the peak's rises and mem.working_bytes on a
  faked sequence of allocator readings.

On the card (marker gpu): stage 2's counters, each stage2.diag span
begins before the first kernel of its diagonal's graph replays in the
profiler's events, and one encode's peak rises add up to the process
peak less the bytes held as its first stage began:
python -m pytest tests/test_torch_trace.py -m gpu
"""

import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.models import convnet2
from hevctpu_torch.pipeline import clips, trace
from hevctpu_torch.pipeline import encoder as tenc

# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

H, W, QP, FRAMES = 64, 128, 32, 2
D = 2                       # 2 rc + cc - 2 diagonals at 1 x 2 CTUs


@pytest.fixture(scope="module")
def clip():
    return tuple(np.asarray(p, np.uint8)
                 for p in clips.clip_sine(FRAMES, H, W, seed=0))


def _labels():
    return np.ones((FRAMES, 2, 16), np.int8)


@pytest.fixture(scope="module")
def records(clip):
    """{kind: (Dispatch, stage_ms, collected output)} of one dispatch
    each: the fused lite one, a labelled one, and a labelled two_pass
    one."""
    y, u, v = clip
    cnn = convnet2.load_model(convnet2.init_params(0), "cpu")
    res = {}
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    h = enc.encode_fused_dispatch(cnn, y, u, v, lite=True)
    res["fused"] = h, enc.stage_ms(), enc.collect(h, lite=True)
    h = enc.encode_dispatch(y, u, v, _labels())
    res["labelled"] = h, enc.stage_ms(), enc.collect(h)
    enc = tenc.FrameEncoder(H, W, QP, device="cpu", two_pass=True)
    h = enc.encode_dispatch(y, u, v, _labels())
    res["two_pass"] = h, enc.stage_ms(), enc.collect(h)
    return res


STAGES = {"fused": ["cnn", "stage1", "stage2", "filters", "pack"],
          "labelled": ["stage1", "stage2", "filters"],
          "two_pass": ["stage1", "pass1_stage2", "pass2_stage1", "stage2",
                       "filters"]}


@pytest.mark.parametrize("kind", list(STAGES))
def test_spans_nest_under_their_parents(records, kind):
    handle = records[kind][0]
    rec = handle.trace
    rows = rec.rows()
    assert {r["seq"] for r in rows} == {rec.seq}
    roots = [r["name"] for r in rows if r["parent"] is None]
    assert sorted(roots) == ["collect", "dispatch", "worker"]
    worker = next(i for i, r in enumerate(rows) if r["name"] == "worker")
    under = [r["name"] for r in rows if r["parent"] == worker]
    assert under == STAGES[kind]
    for r in rows:
        assert r["end_ns"] >= r["start_ns"]
        if r["parent"] is not None:
            p = rows[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
        if r["name"] == "stage2.diag":
            assert rows[r["parent"]]["name"] in ("stage2", "pass1_stage2")
    by = {r["name"]: r for r in rows}
    # the worker takes the encode up after its upload; collect waits for it
    assert by["dispatch"]["end_ns"] <= by["worker"]["start_ns"]
    assert by["collect"]["end_ns"] >= by["worker"]["end_ns"]


def test_dispatches_have_distinct_numbers(records):
    seqs = [r[0].trace.seq for r in records.values()]
    assert len(set(seqs)) == len(seqs)


@pytest.mark.parametrize("kind,runs", [("fused", 1), ("labelled", 1),
                                       ("two_pass", 2)])
def test_a_diagonal_span_each_diagonal(records, kind, runs):
    rec = records[kind][0].trace
    diags = [s for s in rec.spans if s.name == "stage2.diag"]
    assert len(diags) == runs * D
    parents = [s.parent.name for s in diags]
    assert parents == (["pass1_stage2"] * D if runs == 2 else []) \
        + ["stage2"] * D
    host = rec.diagonals()
    assert [h for h, _ in host] == pytest.approx([s.ns * 1e-6
                                                  for s in diags])
    assert all(dev is None for _, dev in host)      # no events on the CPU


def test_self_time_is_duration_less_children(records):
    rec = records["fused"][0].trace
    for s in rec.spans:
        kids = [c for c in rec.spans if c.parent is s]
        assert rec.self_ns(s) == s.ns - sum(c.ns for c in kids)
        assert rec.self_ns(s) >= 0
    worker = next(s for s in rec.spans if s.name == "worker")
    assert rec.self_ns(worker) < worker.ns


def test_self_time_on_hand_made_spans():
    rec = trace.Record(torch.device("cpu"))
    a = trace.Span("a", 0, None)
    b, c = trace.Span("b", 10, a), trace.Span("c", 40, a)
    a.end_ns, b.end_ns, c.end_ns = 100, 30, 70
    rec.spans += [a, b, c]
    assert [rec.self_ns(s) for s in (a, b, c)] == [50, 20, 30]
    assert rec.children(a) == [b, c]


@pytest.mark.parametrize("kind,keys", [
    ("fused", ["upload", "cnn", "stage1", "stage2", "filters"]),
    ("labelled", ["upload", "stage1", "stage2", "filters"]),
    ("two_pass", ["upload", "stage1", "pass1_stage2", "pass2_stage1",
                  "stage2", "filters"])])
def test_stage_ms_keeps_its_keys(records, kind, keys):
    handle, ms, _ = records[kind]
    assert list(ms) == keys
    assert list(handle.trace.stage_ms()) == keys
    assert handle.clock is handle.trace.clock
    # every stage but the upload is a worker span of its own name
    assert set(keys[1:]) <= {s.name for s in handle.trace.spans}


def test_records_are_freed_with_their_dispatch(clip, monkeypatch):
    """Many dispatches: the encoder keeps its newest handle's record
    alone, and the worker thread holds no record between encodes."""
    y, u, v = clip

    def quick(self, y, u, v, labels, qp_map=None):
        with trace.stage("stage1"):
            return {"y": y}

    monkeypatch.setattr(tenc.FrameEncoder, "_encode_impl", quick)
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    refs = []
    for _ in range(50):
        h = enc.encode_dispatch(y, u, v, _labels())
        h.result()
        refs.append(weakref.ref(h.trace))
        del h
    gc.collect()
    alive = [r() for r in refs if r() is not None]
    assert alive == [enc._last.trace]
    held = enc._worker.submit(lambda: (trace.current(), trace._stack()))
    assert held.result(timeout=30) == (None, [])
    assert trace.current() is None and trace._stack() == []


def test_native_coder_counts_its_calls(records):
    from hevctpu_torch import native
    if not native.available():
        pytest.skip("the native coder needs g++")
    out = records["labelled"][2]
    before = trace.counters()
    decoder.encode_stream(headers.StreamConfig(width=W, height=H, qp=QP),
                          [out])
    after = trace.counters()
    assert after["cabac.calls"] - before["cabac.calls"] == FRAMES
    assert after["cabac.ms"] > before["cabac.ms"]
    assert {k for k in after if after[k] != before[k]} == {"cabac.calls",
                                                           "cabac.ms"}


def test_counters_are_a_snapshot():
    snap = trace.counters()
    snap["stage2.replays"] += 10 ** 6
    assert trace.counters()["stage2.replays"] < snap["stage2.replays"]
    with pytest.raises(KeyError):
        trace.count("stage2.replay")


MEM_KEYS = [f"mem.rise_bytes.{s}" for s in trace.STAGES] + [
    "mem.working_bytes"]


def test_memory_counters_are_zero_on_the_cpu(records):
    """Every memory counter is there from import, and a CPU encode reads
    no allocator: the counters stay 0 and the records keep no memory."""
    c = trace.counters()
    assert set(MEM_KEYS) <= set(c)
    assert [c[k] for k in MEM_KEYS] == [0] * len(MEM_KEYS)
    assert all(r[0].trace.memory == [] for r in records.values())
    assert trace.allocator(torch.device("cpu")) is None


@pytest.fixture
def own_counts(monkeypatch):
    """The counters of a test alone (the process's are left as they
    were)."""
    counts = dict.fromkeys(trace._COUNTS, 0)
    monkeypatch.setattr(trace, "_COUNTS", counts)
    return counts


def test_count_max_is_safe_across_threads(own_counts):
    """Threads, more than cores, raise one counter and add to another at
    once with a short switch interval: the maximum and the sum come out
    whole."""
    threads, steps = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for j in range(steps):
            trace.count_max("mem.working_bytes", i * steps + j)
            trace.count("mem.rise_bytes.stage1")

    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    c = trace.counters()
    assert c["mem.working_bytes"] == threads * steps - 1
    assert c["mem.rise_bytes.stage1"] == threads * steps
    trace.count_max("mem.working_bytes", 5)
    assert trace.counters()["mem.working_bytes"] == threads * steps - 1
    with pytest.raises(KeyError):
        trace.count_max("mem.working", 1)


# (stage, allocator reading (allocated, peak) at its start, at its end)
# for four dispatches in turn
FAKED = [
    [("cnn", (100, 100), (150, 180)),      # peak +80
     ("stage1", (150, 180), (120, 400)),   # +220: 400 over the 100 held
     ("stage2", (120, 400), (130, 400)),
     ("filters", (130, 400), (110, 400))],
    [("cnn", (50, 400), (60, 400)),        # the peak does not rise: its
     ("stage1", (60, 400), (70, 400))],    # 350 over 50 is not this one's
    [("cnn", (200, 400), (210, 400)),
     ("stage1", (210, 400), (250, 450))],  # +50: 250 over 200
    [("stage1", (10, 450), (20, 460)),     # +10
     ("pass1_stage2", (20, 460), (20, 460)),
     ("pass2_stage1", (20, 460), (30, 470)),   # +10
     ("stage2", (30, 470), (40, 500))],    # +30: 490 over 10
]


def test_working_bytes_on_faked_readings(own_counts, monkeypatch):
    readings = iter([r for d in FAKED for _, a, b in d for r in (a, b)])
    monkeypatch.setattr(trace, "allocator", lambda device: next(readings))
    recs, working = [], []
    for d in FAKED:
        rec = trace.Record(torch.device("cpu"))
        with trace.active(rec):
            for name, _, _ in d:
                with trace.stage(name):
                    pass
        recs.append(rec)
        working.append(own_counts["mem.working_bytes"])
    assert next(readings, None) is None
    assert working == [300, 300, 300, 490]
    for rec, d in zip(recs, FAKED):
        assert rec.memory == [(n, a[0], b[0], b[1] - a[1]) for n, a, b in d]
    c = trace.counters()
    assert {k: c[k] for k in MEM_KEYS} == {
        "mem.rise_bytes.cnn": 80, "mem.rise_bytes.stage1": 220 + 50 + 10,
        "mem.rise_bytes.pass1_stage2": 0, "mem.rise_bytes.pass2_stage1": 10,
        "mem.rise_bytes.stage2": 30, "mem.rise_bytes.filters": 0,
        "mem.working_bytes": 490}


def test_a_stage_that_raises_keeps_no_memory(own_counts, monkeypatch):
    readings = iter([(0, 0), (5, 7)])
    monkeypatch.setattr(trace, "allocator", lambda device: next(readings))
    rec = trace.Record(torch.device("cpu"))
    with trace.active(rec), pytest.raises(ValueError):
        with trace.stage("stage1"):
            raise ValueError
    assert rec.memory == [] and next(readings) == (5, 7)
    assert own_counts["mem.rise_bytes.stage1"] == 0


def test_span_on_the_profilers_clock():
    """A span read on the main thread inside a record_function range lies
    inside that range's interval in the profiler's events, within 50 us,
    once mapped by Record.unix_ns."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = trace.Record(torch.device("cpu"))
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with record_function("outer"):
            with rec.span("inner") as inner:
                torch.ones(4096).cumsum(0)
    finally:
        prof.stop()
    outer, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "outer"]
    a, b = outer.start_ns(), outer.start_ns() + outer.duration_ns()
    slack = 50_000
    assert a - slack <= rec.unix_ns(inner.start_ns)
    assert rec.unix_ns(inner.end_ns) <= b + slack
    assert rec.unix_ns(inner.start_ns) <= rec.unix_ns(inner.end_ns)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: stage 2's graphs and CUDA events "
                    "have no CPU mode")


@pytest.mark.gpu
def test_card_counters_and_diagonal_events(clip):
    """On the card: the first dispatch captures (one capture, its ms and
    nodes), every dispatch replays 2 graphs and launches the stage-2
    kernel once a diagonal, and each diagonal has device ms beside its
    host ms."""
    _card()
    y, u, v = clip
    cnn = convnet2.load_model(convnet2.init_params(0), "cuda")
    enc = tenc.FrameEncoder(H, W, QP, device="cuda")
    before = trace.counters()
    for _ in range(3):
        h = enc.encode_fused_dispatch(cnn, y, u, v, lite=True)
        enc.collect(h, lite=True)
    after = {k: n - before[k] for k, n in trace.counters().items()}
    assert after["stage2.captures"] == 1
    assert after["stage2.capture_ms"] > 0
    assert after["stage2.graph_nodes"] > 0
    assert after["stage2.replays"] == 3 * D * 2
    assert after["stage2.kernel_launches"] == 3 * D
    assert after["stage2.evictions"] == 0
    diags = h.trace.diagonals()
    assert len(diags) == D and len(h.trace.diag_events) == D
    assert all(host > 0 and dev > 0 for host, dev in diags)
    assert not [s for s in h.trace.spans if s.name == "stage2.capture"]


@pytest.mark.gpu
def test_card_diagonal_span_precedes_its_kernels(clip):
    """In a profiled dispatch, each stage2.diag span holds its diagonal's
    2 cudaGraphLaunch calls (on the profiler's clock, within 50 us) and
    begins before the first kernel they launch; the diagonals ran D
    stage-2 kernels."""
    from torch.profiler import ProfilerActivity, profile

    _card()
    y, u, v = clip
    cnn = convnet2.load_model(convnet2.init_params(0), "cuda")
    enc = tenc.FrameEncoder(H, W, QP, device="cuda")
    enc.collect(enc.encode_fused_dispatch(cnn, y, u, v, lite=True),
                lite=True)                          # captures the graphs
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        h = enc.encode_fused_dispatch(cnn, y, u, v, lite=True)
        h.result()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    launches = [e for e in events if e.device_type() == cpu
                and e.name().startswith("cudaGraphLaunch")]
    kernels = [e for e in events if e.device_type() != cpu]
    assert len(launches) == D * 2
    assert len([e for e in kernels if "stage2_ctu_kernel" in e.name()]) == D
    rec = h.trace
    slack = 50_000
    # diagonals follow each other within tens of us: the i-th span holds
    # the i-th pair of launches in time
    launches.sort(key=lambda e: e.start_ns())
    spans = [s for s in rec.spans if s.name == "stage2.diag"]
    assert len(spans) == D
    for i, s in enumerate(spans):
        a, b = rec.unix_ns(s.start_ns), rec.unix_ns(s.end_ns)
        mine = launches[2 * i: 2 * i + 2]
        assert all(a - slack <= e.start_ns() <= b + slack for e in mine)
        # a device event carries its launch's CUPTI correlation id; its
        # linked id is the enclosing op's, another count that can collide
        ids = {e.correlation_id() for e in mine}
        first = min(e.start_ns() for e in kernels
                    if e.correlation_id() in ids)
        assert a <= first


@pytest.mark.gpu
def test_card_memory_rises_add_up(clip):
    """One encode on the card with the process peak set to the bytes held
    before it: its stages' rises add up to the process peak less the
    bytes allocated as its first stage began (those hold the upload), and
    the counters rise by as much."""
    _card()
    y, u, v = clip
    cnn = convnet2.load_model(convnet2.init_params(0), "cuda")
    enc = tenc.FrameEncoder(H, W, QP, device="cuda")
    enc.collect(enc.encode_fused_dispatch(cnn, y, u, v))
    enc._last = None        # its output freed now, not during the next
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = trace.counters()
    h = enc.encode_fused_dispatch(cnn, y, u, v)
    enc.collect(h)
    peak = torch.cuda.max_memory_allocated()
    after = trace.counters()
    mem = h.trace.memory
    assert [m[0] for m in mem] == ["cnn", "stage1", "stage2", "filters"]
    assert mem[0][1] >= held + sum(p.size for p in (y, u, v))
    rises = sum(m[3] for m in mem)
    assert rises > 0 and rises == peak - mem[0][1]
    assert all(m[3] >= 0 for m in mem)
    assert sum(after[f"mem.rise_bytes.{s}"] - before[f"mem.rise_bytes.{s}"]
               for s in trace.STAGES) == rises
    assert after["mem.working_bytes"] >= rises
