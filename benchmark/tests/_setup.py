"""Puts the benchmark's directory and the checkout's root on sys.path for
the benchmark's tests (they run from the checkout's root:
python -m pytest benchmark/tests)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
