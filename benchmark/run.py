#!/usr/bin/env python3
"""Runs one cell of the benchmark of hevctpu_torch once, on the card it is
started on, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are named in BENCHMARK.json; see
cellbench/main.py for what a run does and prints.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from cellbench import main  # noqa: E402

if __name__ == "__main__":
    # A run that has not ended by then prints every thread's stack and
    # exits non-zero: a run must end within 360 s.
    import faulthandler  # noqa: E402
    faulthandler.dump_traceback_later(350, exit=True)
    sys.exit(main.run(t_start=T_START))
