"""Native CABAC, ms a frame: the program's counters cabac.ms over
cabac.calls (hevctpu_torch.pipeline.trace.counters(); one call codes one
picture's slice data), over every picture the run coded (the warm-up
batch, the window's batches, the traced batch), read once the run's
encodes are done. It is the native coder's part of
host_stream_ms_per_frame; the rest is the lite unpack, the headers, the
checksum SEI and Python. None where the program keeps no such counter or
coded nothing natively."""


def read(rec):
    try:
        from hevctpu_torch.pipeline import trace
    except ImportError:
        return None
    c = trace.counters()
    if not c["cabac.calls"]:
        return None
    return c["cabac.ms"] / c["cabac.calls"]
