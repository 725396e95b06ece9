"""What one dispatched encode did, and the encoder's counters.

A Record belongs to one encode_dispatch or encode_fused_dispatch call
(Dispatch.trace) and lives as long as its Dispatch. It holds the
dispatch's stage clock (CUDA events at the stage boundaries, the host
clock on the CPU), its host spans, and on the card a CUDA event after
each stage-2 diagonal. The spans, each with a name, a start, an end and
a parent (the span open around it on the same thread), are:

  caller thread  dispatch   argument check and upload
                 collect    the wait for the encode, the device->host
                            copies, the lite unpack
  worker thread  worker     from the worker taking the encode up to its
                            return (queue wait: the gap after dispatch)
                   cnn, stage1, [pass1_stage2, pass2_stage1,] stage2,
                   filters    the stage clock's stages, host side
                   pack       the lite packing
                 under each stage-2 run:
                   stage2.capture  the CUDA-graph capture, when it runs
                   stage2.diag     one a diagonal: the host's launch of
                                   its two graph replays and its kernel
                                   (on the CPU, its steps)

Durations come from time.perf_counter_ns. Record.unix_ns maps such a
reading onto the Unix-epoch nanoseconds that torch.profiler's events
carry, through an anchor sampled when the record is made. A span's end is
None while it is open.

On the card each stage also reads the caching allocator's host-side
counts as it opens and as it closes (the bytes allocated, and the
process's peak of them, as torch.cuda.memory_allocated and
max_memory_allocated give them; no synchronisation, and the peak is
never reset): Record.memory keeps, a stage, the bytes allocated at its
start and at its end and how far the process peak rose during it.

counters() is a snapshot of the process's counts since import: stage 2's
captures, capture ms, graph nodes, graph replays, graph-cache evictions
(each one a capture again later) and kernel launches (one a diagonal on
the card), stage 1's candidate-RD kernel launches (one a call of
encoder._dense_rd_candidates on the card under rate_model="global", 25
an encode call), the native CABAC coder's calls and host ms, and on the
card:

  mem.rise_bytes.<stage>  the process peak's rises during that stage,
                          summed over dispatches
  mem.working_bytes       over the dispatches during which the peak
                          rose, the most by which it stood above the
                          bytes allocated as the dispatch's first stage
                          began (the part of the peak an encode adds to
                          what is held between encodes)
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_SEQ = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()

# The stages that read the allocator (every trace.stage name).
STAGES = ("cnn", "stage1", "pass1_stage2", "pass2_stage1", "stage2",
          "filters")
_COUNTS = {"stage2.captures": 0, "stage2.capture_ms": 0.0,
           "stage2.graph_nodes": 0, "stage2.replays": 0,
           "stage2.evictions": 0, "stage2.kernel_launches": 0,
           "stage1.rd_kernel_launches": 0,
           "cabac.calls": 0, "cabac.ms": 0.0,
           **{f"mem.rise_bytes.{s}": 0 for s in STAGES},
           "mem.working_bytes": 0}
_COUNTS_LOCK = threading.Lock()


def count(name: str, n=1):
    """Add n to the counter `name` (one of counters()'s keys)."""
    with _COUNTS_LOCK:
        _COUNTS[name] += n


def count_max(name: str, n):
    """Raise the counter `name` (one of counters()'s keys) to n if it is
    below."""
    with _COUNTS_LOCK:
        if n > _COUNTS[name]:
            _COUNTS[name] = n


def counters() -> dict:
    """{name: cumulative value since import}."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


class StageClock:
    """Stage boundary marks of one encode: CUDA events on the card (device
    time between marks, recorded on the marking thread's current
    stream), the host clock on the CPU. A mark named None starts the next
    stage without closing one: the worker's start, so that a stage does
    not count the time its encode waited behind an earlier one."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks = []

    def mark(self, name: str | None):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict:
        pairs = [(a, n, b) for (_, a), (n, b)
                 in zip(self.marks, self.marks[1:]) if n is not None]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return {n: a.elapsed_time(b) for a, n, b in pairs}
        return {n: (b - a) * 1e3 for a, n, b in pairs}


def allocator(device: torch.device) -> tuple | None:
    """(bytes allocated, the process's peak of them) in the caching
    allocator of a card, read on the host; None off the card."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    b = stats["allocated_bytes"]["all"]
    return b["current"], b["peak"]


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent")

    def __init__(self, name: str, start_ns: int, parent: Span | None):
        self.name, self.start_ns, self.parent = name, start_ns, parent
        self.end_ns = None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _stack() -> list:
    """This thread's open spans, innermost last, as (record, span)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """A span of `rec` on the calling thread, for a with statement."""
    __slots__ = ("rec", "name", "span")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> Span:
        stack = _stack()
        parent = stack[-1][1] if stack and stack[-1][0] is self.rec else None
        self.span = Span(self.name, time.perf_counter_ns(), parent)
        self.rec.spans.append(self.span)
        stack.append((self.rec, self.span))
        return self.span

    def __exit__(self, typ, value, tb):
        self.span.end_ns = time.perf_counter_ns()
        _stack().pop()


class _Stage(_Open):
    """A span that marks the stage clock under its own name as it closes
    (not when it raises), and on the card reads the allocator as it opens
    and closes (Record.memory)."""
    __slots__ = ("mem",)

    def __enter__(self) -> Span:
        self.mem = allocator(self.rec.clock.device)
        return super().__enter__()

    def __exit__(self, typ, value, tb):
        if typ is None:
            self.rec.clock.mark(self.name)
            if self.mem is not None:
                self.rec.stage_memory(self.name, self.mem,
                                      allocator(self.rec.clock.device))
        super().__exit__(typ, value, tb)


class _Diagonal(_Open):
    """A stage2.diag span; on the card also a CUDA event after the
    diagonal's work, and one before the first diagonal of a stage-2 run
    (a diagonal after it starts at its predecessor's event)."""
    __slots__ = ("start",)

    def __init__(self, rec: Record):
        super().__init__(rec, "stage2.diag")

    def __enter__(self) -> Span:
        span = super().__enter__()
        self.start = None
        if self.rec.clock.device.type == "cuda":
            events = self.rec.diag_events
            if events and events[-1][0].parent is span.parent:
                self.start = events[-1][2]
            else:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
        return span

    def __exit__(self, typ, value, tb):
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.rec.diag_events.append((self.span, self.start, end))
        super().__exit__(typ, value, tb)


class Record:
    """One dispatch's record: seq (a number unique in the process, shared
    by all its spans), clock (its StageClock), spans (in the order they
    opened), diag_events ((stage2.diag span, CUDA event before, after),
    card only), memory ((stage, bytes allocated at its start, at its end,
    the process peak's rise during it), card only) and anchor
    ((perf_counter_ns, time_ns) read together)."""

    def __init__(self, device: torch.device):
        self.seq = next(_SEQ)
        self.clock = StageClock(device)
        self.spans = []
        self.diag_events = []
        self.memory = []
        p0 = time.perf_counter_ns()
        t = time.time_ns()
        self.anchor = ((p0 + time.perf_counter_ns()) // 2, t)

    def span(self, name: str) -> _Open:
        """with record.span(name): a span on the calling thread."""
        return _Open(self, name)

    def stage_memory(self, name: str, start: tuple, end: tuple):
        """Keep stage `name`'s allocator readings (allocated, peak) at its
        start and end, and count the peak's rise."""
        (a0, p0), (a1, p1) = start, end
        self.memory.append((name, a0, a1, p1 - p0))
        if p1 > p0:
            count(f"mem.rise_bytes.{name}", p1 - p0)
            count_max("mem.working_bytes", p1 - self.memory[0][1])

    def stage_ms(self) -> dict:
        """The stage clock's ms a stage (waits for the device)."""
        return self.clock.ms()

    def unix_ns(self, perf_ns: int) -> int:
        """A perf_counter_ns reading on the Unix-epoch clock of
        torch.profiler's events."""
        return perf_ns - self.anchor[0] + self.anchor[1]

    def rows(self) -> list:
        """The spans as dicts {seq, name, start_ns, end_ns, parent}: times
        on the profiler's clock (unix_ns), parent the index of the
        parent's row or None."""
        index = {id(s): i for i, s in enumerate(self.spans)}
        return [dict(seq=self.seq, name=s.name,
                     start_ns=self.unix_ns(s.start_ns),
                     end_ns=None if s.end_ns is None
                     else self.unix_ns(s.end_ns),
                     parent=None if s.parent is None
                     else index[id(s.parent)])
                for s in self.spans]

    def children(self, span: Span) -> list:
        return [s for s in self.spans if s.parent is span]

    def self_ns(self, span: Span) -> int:
        """span's duration less its children's (they run one after
        another on its thread)."""
        return span.ns - sum(c.ns for c in self.children(span))

    def diagonals(self) -> list:
        """[(host ms, device ms)] of each stage2.diag span in order: its
        duration, and on the card the device time between its events
        (waits for them); None on the CPU."""
        dev = {id(s): (a, b) for s, a, b in self.diag_events}
        out = []
        for s in self.spans:
            if s.name != "stage2.diag":
                continue
            ev = dev.get(id(s))
            if ev is not None:
                ev[1].synchronize()
            out.append((s.ns * 1e-6,
                        None if ev is None else ev[0].elapsed_time(ev[1])))
        return out


def current() -> Record | None:
    """The record of the encode this thread runs, if any."""
    return getattr(_local, "record", None)


@contextlib.contextmanager
def active(rec: Record):
    """Inside: current() is rec on this thread."""
    prev = current()
    _local.record = rec
    try:
        yield rec
    finally:
        _local.record = prev


def span(name: str):
    """A span of the current record; nothing outside a dispatched encode."""
    rec = current()
    return _NULL if rec is None else _Open(rec, name)


def stage(name: str):
    """A stage of the current record: a span that marks the stage clock
    under its name as it closes; nothing outside a dispatched encode."""
    rec = current()
    return _NULL if rec is None else _Stage(rec, name)


def diagonal():
    """One stage-2 diagonal of the current record; nothing outside a
    dispatched encode."""
    rec = current()
    return _NULL if rec is None else _Diagonal(rec)
