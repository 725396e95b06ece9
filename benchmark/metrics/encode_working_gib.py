"""The part of the peak that an encode adds, GiB: the program's counter
mem.working_bytes (hevctpu_torch.pipeline.trace.counters(), over the
process's dispatches during which the card's peak of allocated bytes
rose, the most by which that peak stood above the bytes allocated as the
dispatch's first stage began), over 2^30, read once the run's encodes
are done. It is what an encode's stages hold on top of what the encoder
and the batches in flight hold between them: what a larger batch
multiplies. The peak's rises by stage (mem.rise_bytes.<stage>) go to
stderr. None where the program keeps no such counter or it reads 0 (off
the card)."""

import sys

GIB = float(1 << 30)


def read(rec):
    try:
        from hevctpu_torch.pipeline import trace
    except ImportError:
        return None
    c = trace.counters()
    rises = {k[len("mem.rise_bytes."):]: v for k, v in c.items()
             if k.startswith("mem.rise_bytes.")}
    if rises:
        print("benchmark: peak rises by stage, GiB: " + ", ".join(
            f"{k} {v / GIB:.4f}" for k, v in rises.items()), file=sys.stderr)
    working = c.get("mem.working_bytes")
    return working / GIB if working else None
