"""Stage 2's CUDA-graph capture, s: the program's counter
stage2.capture_ms (hevctpu_torch.pipeline.trace.counters(), cumulative in
the process), read once the run's encodes are done. A cell of one batch
size and QP captures once, in the warm-up batch, so this is the part of
setup_s that the capture takes. The run's captures and graph-cache
evictions go to stderr: an eviction means a capture again later, in the
window. None where the program keeps no such counter."""

import sys


def read(rec):
    try:
        from hevctpu_torch.pipeline import trace
    except ImportError:
        return None
    c = trace.counters()
    print(f"benchmark: stage 2 graph captures {c['stage2.captures']}, "
          f"evictions {c['stage2.evictions']}, capture ms "
          f"{c['stage2.capture_ms']!r}", file=sys.stderr)
    if c["stage2.evictions"]:
        print("benchmark: stage 2's graph cache evicted a capture: the "
              "window captured again", file=sys.stderr)
    return c["stage2.capture_ms"] * 1e-3
