"""The port's dispatch (FrameEncoder.encode_dispatch and
encode_fused_dispatch) returns without blocking, as the JAX package's
encode_fused_dispatch does: the caller's thread checks the arguments and
uploads copies of the inputs, and the encode runs on the encoder's one
worker thread, in dispatch order. At 64x128 on the CPU, with fixed-depth
labels or ConvNet2 at init_params(0); nothing here compiles a JAX
encoder.

- A dispatch returns while its stage 2 is held, and the held stage 2 runs
  on the worker, not on the caller's thread.
- What the worker raises reaches the caller, with its traceback, at
  collect, at a key of the handle and at stage_ms; the next dispatch on
  the same encoder still encodes.
- Writing to the caller's arrays right after the dispatch changes nothing.
- Two dispatches collected in either order equal two sequential encodes,
  key for key and stream for stream, and their stage 2 never overlap.
- The worker runs with the caller's torch thread count and without grad.
- stage_ms after a dispatch waits for it and gives the stage keys.
- bench_torch's double-buffered passes equal sequential encodes.
- K1's launch count and its one library load hold under threads (more
  threads than cores, a short switch interval).
"""

import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.models import convnet2
from hevctpu_torch.ops import satd_fused
from hevctpu_torch.pipeline import clips
from hevctpu_torch.pipeline import encoder as tenc

# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

H, W, QP = 64, 128, 32
HOLD_S = 30          # a held stage 2 gives up after this long
CFG = headers.StreamConfig(width=W, height=H, qp=QP, hash_type="checksum")
KINDS = ["encode_dispatch", "encode_fused_dispatch"]


@pytest.fixture(scope="module")
def cnn():
    return convnet2.load_model(convnet2.init_params(0), "cpu")


@pytest.fixture(scope="module")
def clip():
    """Two frames of clip_sine, as uint8 planes."""
    return tuple(np.asarray(p, np.uint8)
                 for p in clips.clip_sine(2, H, W, seed=0))


def _labels(b):
    return np.ones((b, 2, 16), np.int8)        # 64x128: 1 x 2 CTUs


def _dispatch(kind, enc, cnn, y, u, v, labels):
    if kind == "encode_dispatch":
        return enc.encode_dispatch(y, u, v, labels)
    return enc.encode_fused_dispatch(cnn, y, u, v, lite=True)


def _collect(kind, enc, handle):
    return enc.collect(handle, lite=kind == "encode_fused_dispatch")


@pytest.fixture(scope="module")
def sequential(cnn, clip):
    """{kind: [frame 0's output, frame 1's output]}, each encoded alone by
    a fresh encoder, collected before the next dispatch."""
    y, u, v = clip
    res = {}
    for kind in KINDS:
        enc = tenc.FrameEncoder(H, W, QP, device="cpu")
        res[kind] = [_collect(kind, enc, _dispatch(
            kind, enc, cnn, y[i:i + 1], u[i:i + 1], v[i:i + 1], _labels(1)))
            for i in range(2)]
    return res


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert decoder.encode_stream(CFG, [got]) == decoder.encode_stream(
        CFG, [want])


class Hold:
    """FrameEncoder._reconstruct, held until release(): records the thread
    each call ran on and how many ran at once."""

    def __init__(self, monkeypatch):
        self.real = tenc.FrameEncoder._reconstruct
        self.entered = threading.Event()
        self.go = threading.Event()
        self.threads, self.active, self.most = [], 0, 0
        self.lock = threading.Lock()
        hold = self

        def held(enc, *a, **k):
            with hold.lock:
                hold.threads.append(threading.current_thread())
                hold.active += 1
                hold.most = max(hold.most, hold.active)
            hold.entered.set()
            try:
                if not hold.go.wait(HOLD_S):
                    raise TimeoutError("stage 2 was held too long")
                return hold.real(enc, *a, **k)
            finally:
                with hold.lock:
                    hold.active -= 1

        monkeypatch.setattr(tenc.FrameEncoder, "_reconstruct", held)

    def release(self):
        self.go.set()


@pytest.fixture
def hold(monkeypatch):
    h = Hold(monkeypatch)
    yield h
    h.release()


@pytest.mark.parametrize("kind", KINDS)
def test_dispatch_returns_while_stage2_is_held(kind, hold, cnn, clip,
                                               sequential):
    y, u, v = (p[:1] for p in clip)
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    handle = _dispatch(kind, enc, cnn, y, u, v, _labels(1))
    assert isinstance(handle, tenc.Dispatch)
    assert hold.entered.wait(HOLD_S), "stage 2 never started"
    assert not handle.done()
    hold.release()
    _assert_same(_collect(kind, enc, handle), sequential[kind][0])
    assert hold.threads and all(t is not threading.main_thread()
                                for t in hold.threads)


def test_worker_exception_reraises_and_next_dispatch_runs(
        monkeypatch, clip, sequential):
    y, u, v = (p[:1] for p in clip)
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")

    def broken(*a, **k):
        raise RuntimeError("stage 2 failed on purpose")

    monkeypatch.setattr(tenc.FrameEncoder, "_reconstruct", broken)
    handle = enc.encode_dispatch(y, u, v, _labels(1))
    for read in (lambda: enc.collect(handle), lambda: handle["recon_y"],
                 enc.stage_ms):
        with pytest.raises(RuntimeError, match="failed on purpose") as e:
            read()
        assert any(tb.name == "broken" for tb in e.traceback)
    monkeypatch.undo()
    _assert_same(enc.encode(y, u, v, _labels(1)),
                 sequential["encode_dispatch"][0])


@pytest.mark.parametrize("kind", KINDS)
def test_caller_arrays_may_change_after_dispatch(kind, hold, cnn, clip,
                                                 sequential):
    """A first dispatch holds the worker, so the second one's inputs are
    read only after the caller has overwritten its arrays."""
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    first = _dispatch(kind, enc, cnn, *(p[1:] for p in clip), _labels(1))
    assert hold.entered.wait(HOLD_S)
    y, u, v = (p[:1].copy() for p in clip)
    labels = _labels(1)
    second = _dispatch(kind, enc, cnn, y, u, v, labels)
    for a in (y, u, v):
        a[...] = 7
    labels[...] = 0
    hold.release()
    _assert_same(_collect(kind, enc, second), sequential[kind][0])
    _assert_same(_collect(kind, enc, first), sequential[kind][1])


@pytest.mark.parametrize("order", ["dispatch_order", "reversed"])
def test_two_dispatches_in_either_order_equal_sequential(
        order, hold, cnn, clip, sequential):
    hold.release()                              # counts, does not hold
    y, u, v = clip
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    kind = "encode_fused_dispatch"
    handles = [_dispatch(kind, enc, cnn, y[i:i + 1], u[i:i + 1], v[i:i + 1],
                         None) for i in range(2)]
    idx = [0, 1] if order == "dispatch_order" else [1, 0]
    outs = {i: _collect(kind, enc, handles[i]) for i in idx}
    for i in range(2):
        _assert_same(outs[i], sequential[kind][i])
    assert len(hold.threads) == 2 and hold.most == 1
    assert hold.threads[0] is hold.threads[1]      # one worker an encoder


def test_worker_takes_callers_thread_count_and_no_grad(monkeypatch, clip):
    seen = []
    real = tenc.FrameEncoder._decide

    def spy(*a, **k):
        seen.append((torch.get_num_threads(), torch.is_grad_enabled()))
        return real(*a, **k)

    monkeypatch.setattr(tenc.FrameEncoder, "_decide", spy)
    y, u, v = (p[:1] for p in clip)
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    before = torch.get_num_threads()
    try:
        for n in (2, 1):
            torch.set_num_threads(n)
            out = enc.encode_dispatch(y, u, v, _labels(1))
            assert not any(t.requires_grad for t in out.values())
            assert seen[-1] == (n, False)
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("kind", KINDS)
def test_stage_ms_after_dispatch_returns_the_stage_keys(kind, cnn, clip):
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    assert enc.stage_ms() == {}
    handle = _dispatch(kind, enc, cnn, *(p[:1] for p in clip), _labels(1))
    ms = enc.stage_ms()
    assert handle.done()
    want = ["upload", "stage1", "stage2", "filters"]
    if kind == "encode_fused_dispatch":
        want.insert(1, "cnn")
    assert list(ms) == want
    assert all(t >= 0 for t in ms.values())


def test_bench_double_buffering_equals_sequential_encodes(sequential):
    """bench_torch.measure's run_all dispatches both batches before it
    collects the first: its streams equal the batches encoded one after
    another, and it times each dispatch's return and encode_stream."""
    import bench_torch
    _, _, run = bench_torch.measure(convnet2.init_params(0), H, W, 2, 1, 1,
                                    device="cpu", warmup="batch")
    for a, b in zip(bench_torch.synth_clip(2, H, W), clips.clip_sine(
            2, H, W, seed=0)):
        np.testing.assert_array_equal(a, b)         # the fixture's clip
    assert run["streams"] == [decoder.encode_stream(CFG, [out]) for out
                              in sequential["encode_fused_dispatch"]]
    assert len(run["dispatch_ms"]) == len(run["stream_ms"]) == 2
    assert all(t >= 0 for t in run["dispatch_ms"] + run["stream_ms"])


def _stress(fn, threads=16):
    """fn() from `threads` threads at once, the interpreter switching
    threads every microsecond; each thread joined within HOLD_S."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=fn) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(HOLD_S)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)


def test_k1_launch_count_loses_no_update_under_threads(monkeypatch):
    monkeypatch.setattr(satd_fused, "LAUNCHES", 0)

    def launches():
        for _ in range(2000):
            satd_fused._count_launch()

    _stress(launches)
    assert satd_fused.LAUNCHES == 16 * 2000


def test_k1_library_loads_once_under_threads(monkeypatch):
    loads = []

    @functools.lru_cache(maxsize=None)
    def slow_load():
        loads.append(threading.current_thread())
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(satd_fused, "_load_lib", slow_load)
    got = []
    _stress(lambda: got.append(satd_fused._lib()))
    assert len(loads) == 1 and len(got) == 16
    assert all(lib is got[0] for lib in got)
