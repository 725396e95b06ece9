"""The system under test, driven as its users drive it: hevctpu_torch's
FrameEncoder with ConvNet2 on the card, one batch at a time through
encode_fused_dispatch(lite=True) -> collect(lite=True) ->
codec.decoder.encode_stream with the checksum hash SEI, `in_flight`
batches dispatched ahead, so that batch k's collect and host CABAC
overlap the encode of the batches after it.

The window is made of whole batches. It starts at the first timed
dispatch and ends when the last batch's stream is on the host. A batch is
dispatched only while it is expected to end no later than half a batch
past `seconds`; the expected time of a batch is the warm-up batch's at
first, then the time between the last two streams. A traced run profiles
one more batch after the window (traced_batch), so that the window and
its stage clocks run as in an untraced run.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch

from cellbench import traffic

# The configuration keys the encoder fixes by design: a file that states
# another value describes a different encoder.
FIXED = dict(bit_depth=8, chroma_format="420", intra_period=1, ctu_size=64,
             max_partition_depth=4, tu_log2_min=2, tu_log2_max=5,
             tu_max_depth_intra=3, strong_intra_smoothing=True)


@dataclasses.dataclass
class Batch:
    index: int
    family: str
    frames: int
    done_s: float = 0.0        # window clock with the stream on the host
    host_ms: float = 0.0       # collect + encode_stream, device finished
    stream: bytes = b""
    out: dict | None = None    # collected (host) output dict
    clock: object = None       # the dispatch's stage clock


@dataclasses.dataclass
class Session:
    """The program's objects for one cell, built in set-up."""
    mix: traffic.Mix
    device: torch.device
    enc: object
    cnn: object
    stream_cfg: object
    pool: dict
    warmup_s: float = 0.0


def check_config(config: dict):
    bad = {k: config.get(k) for k, v in FIXED.items() if config.get(k) != v}
    if bad:
        raise ValueError(f"configuration {config.get('name')} sets "
                         f"{bad}; this encoder fixes {FIXED}")


def build(config: dict, mix: traffic.Mix, seed: int, weights: str,
          device: str) -> Session:
    """Set-up: ConvNet2 and the FrameEncoder on the device, the stream
    configuration, and the traffic's content from the seed."""
    from hevctpu_torch.codec import headers
    from hevctpu_torch.models import convnet2
    from hevctpu_torch.pipeline.encoder import FrameEncoder
    from plainref.cnn import load_params

    check_config(config)
    h, w = config["height"], config["width"]
    dev = torch.device(device)
    cnn = convnet2.load_model(load_params(weights), dev)
    enc = FrameEncoder(h, w, mix.qp, device=dev, search=config["search"],
                       rate_model=config["rate_model"], rdoq=config["rdoq"],
                       sbh=config["sign_data_hiding"],
                       ts=config["transform_skip"],
                       deblock=config["deblock"], sao=config["sao"],
                       nxn=config["nxn"], tu_split=config["tu_split"],
                       two_pass=config["two_pass"])
    cfg = headers.StreamConfig(
        width=w, height=h, qp=mix.qp,
        strong_intra_smoothing=config["strong_intra_smoothing"],
        sign_data_hiding=config["sign_data_hiding"],
        max_tu_depth_intra=config["tu_max_depth_intra"],
        transform_skip=config["transform_skip"], deblock=config["deblock"],
        sao=config["sao"], hash_type=config["hash_type"])
    pool = traffic.make_pool(mix, h, w, seed)
    return Session(mix, dev, enc, cnn, cfg, pool)


def _wait_device(clock):
    """Wait for a collected dispatch's last stage on the device (its final
    CUDA event); on the CPU its stages are done once it returns."""
    if clock.device.type == "cuda":
        clock.marks[-1][1].synchronize()


def encode_batch(s: Session, k: int) -> tuple:
    """Dispatch batch k. Returns (Batch, handle)."""
    fam = s.mix.family(k)
    y, u, v = s.pool[fam]
    with torch.profiler.record_function("harness.dispatch"):
        handle = s.enc.encode_fused_dispatch(s.cnn, y, u, v, lite=True)
    return Batch(k, fam, len(y)), handle


def finish_batch(s: Session, b: Batch, handle, t0: float):
    """Wait for batch b, then collect it and write its stream."""
    from hevctpu_torch.codec import decoder as streamlib

    with torch.profiler.record_function("harness.wait"):
        handle.result()
        _wait_device(handle.clock)
    tc = time.perf_counter()
    with torch.profiler.record_function("harness.collect"):
        out = s.enc.collect(handle, lite=True)
    with torch.profiler.record_function("harness.encode_stream"):
        b.stream = streamlib.encode_stream(s.stream_cfg, [out])
    t1 = time.perf_counter()
    b.host_ms = (t1 - tc) * 1e3
    b.done_s = t1 - t0
    b.out = out
    b.clock = handle.clock


def warm_up(s: Session):
    """One batch of the cell's shape, untimed: K1's and the native coder's
    builds (first run in a checkout), cuDNN's first call, stage 2's graph
    capture for this batch size."""
    t0 = time.perf_counter()
    b, handle = encode_batch(s, 0)
    finish_batch(s, b, handle, t0)
    s.warmup_s = time.perf_counter() - t0


def run(s: Session, seconds: float) -> dict:
    """The measured window."""
    mix = s.mix
    pending = collections.deque()
    done = []
    t_est = s.warmup_s
    t0 = time.perf_counter()
    k = 0

    def fits(now):
        return now + (len(pending) + 1) * t_est <= seconds + t_est / 2

    def dispatch():
        nonlocal k
        pending.append(encode_batch(s, k))
        k += 1

    dispatch()
    while len(pending) < mix.in_flight and fits(time.perf_counter() - t0):
        dispatch()
    last_done = 0.0
    while pending:
        b, handle = pending.popleft()
        finish_batch(s, b, handle, t0)
        done.append(b)
        t_est = b.done_s - last_done
        last_done = b.done_s
        while len(pending) < mix.in_flight and fits(b.done_s):
            dispatch()
    return dict(batches=done, window_s=done[-1].done_s, t0=t0,
                frames=sum(b.frames for b in done))


def traced_batch(s: Session, k: int, tracer):
    """One more batch after the window, under the profiler: started before
    its dispatch, stopped when its device work has ended; then the batch
    is finished untimed."""
    t0 = time.perf_counter()
    tracer.start()
    b, handle = encode_batch(s, k)
    tracer.wait_then_stop(handle)
    finish_batch(s, b, handle, t0)
