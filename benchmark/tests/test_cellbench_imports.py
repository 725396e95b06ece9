"""The import check, each side in a fresh process: a whole run of the
harness loads no module whose top-level name is jax, jaxlib, flax or
hevctpu (hevctpu_torch, the system under test, is not one of them:
names are compared whole), and the references (the plain ConvNet2 and
the spec decoder), run alone, load none of those nor hevctpu_torch."""

import json
import os
import subprocess
import sys

import _setup

HARNESS = """
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
import pytest
from test_cellbench_run import tiny_root
from cellbench import main
if __name__ == "__main__":
    import pathlib, tempfile
    with tempfile.TemporaryDirectory() as d:
        rc = main.run(["--workload", "tiny_cell", "--seed", "3", "--seconds",
                       "1"], t_start=time.perf_counter(), device="cpu",
                      chip_check=lambda n: None,
                      root=tiny_root(pathlib.Path(d)))
    sys.stdout.flush()
    print(json.dumps(dict(rc=rc, tops=sorted({{m.split(".")[0]
                                             for m in sys.modules}}))))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{bench!r}]
import numpy as np
import torch
import specdec
from plainref import cnn
from cellbench import corpus
y, u, v = (a.astype(np.uint8) for a in corpus.make_clip("scene", 1, 64, 64))
lg = cnn.frame_logits(cnn.load_params({weights!r}), y, u, v, "cpu")
cnn.labels_from_logits(lg)
try:
    specdec.decode(b"\\x00\\x00\\x01\\x40\\x01\\x0c")
except specdec.StreamError:
    pass
print(json.dumps(dict(rc=0, tops=sorted({{m.split(".")[0]
                                         for m in sys.modules}}))))
"""


def fresh(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=_setup.ROOT, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0, p.stderr[-3000:]
    return set(res["tops"])


def test_harness_run_loads_no_jax():
    tops = fresh(HARNESS.format(bench=_setup.BENCH, root=_setup.ROOT,
                                tests=os.path.dirname(__file__)))
    assert "hevctpu_torch" in tops and "cellbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hevctpu"}


def test_reference_loads_neither_jax_nor_the_program():
    tops = fresh(REFERENCE.format(
        bench=_setup.BENCH,
        weights=os.path.join(_setup.BENCH, "weights", "convnet2_domain.npz")))
    assert "plainref" in tops and "specdec" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hevctpu", "hevctpu_torch"}
