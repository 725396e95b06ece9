"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points run on the card unless the caller names the CPU."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from hevctpu_torch import get_device
from hevctpu_torch.pipeline.encoder import FrameEncoder


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The port's command-line tools (tools/*_torch.py) stand alone too.
PORT_TOOLS = ["fit_rate_constants_torch", "fit_ctx_probs_torch",
              "train_cnn_domain_torch", "measure_corpus_torch",
              "measure_rd_torch", "attribute_gap_torch", "bit_stats_torch",
              "profile_stages_torch", "measure_pruned_hm_torch",
              "scaling_model_torch", "stage2_steps", "train_precision"]


def test_port_imports_without_jax_or_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import hevctpu_torch
        for m in pkgutil.walk_packages(hevctpu_torch.__path__,
                                       "hevctpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        import bench_torch
        sys.path.insert(0, "tools")
        for tool in %r:
            importlib.import_module(tool)
        bad = [k for k in sys.modules
               if k == "hevctpu" or k.startswith("hevctpu.")]
        assert not bad, bad
        print("isolated")
    """ % (PORT_TOOLS,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def test_no_import_lines_of_jax_or_reference():
    pat = re.compile(r"^\s*(import|from) (jax|hevctpu)(\.|\s|$)")
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                             "bench_torch.py")] + [
        os.path.join(ROOT, "tools", f"{t}.py") for t in PORT_TOOLS]
    for d, _, names in os.walk(os.path.join(ROOT, "hevctpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [(f, i + 1) for f in files
            for i, line in enumerate(open(f, encoding="utf-8"))
            if pat.match(line)]
    assert not hits, hits


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert FrameEncoder(64, 128, 32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FrameEncoder(64, 128, 32)
    assert get_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("option", [{"rate_model": "ctx"},
                                    {"rate_model": "global"},
                                    {"two_pass": True},
                                    {"rate_model": "ctx", "two_pass": True}])
def test_options_accepted(option):
    enc = FrameEncoder(64, 128, 32, device="cpu", **option)
    assert enc.rate_model == option.get("rate_model", "global")
    assert enc.two_pass == option.get("two_pass", False)


@pytest.mark.parametrize("option", [{"lite": True}, {"sharded": True}])
def test_unknown_option_raises(option):
    with pytest.raises(TypeError):
        FrameEncoder(64, 128, 32, device="cpu", **option)


def test_bad_rate_model_raises():
    with pytest.raises(ValueError, match="rate_model"):
        FrameEncoder(64, 128, 32, device="cpu", rate_model="cabac")


def test_encode_without_labels_raises():
    enc = FrameEncoder(64, 128, 32, device="cpu")
    y = np.zeros((1, 64, 128), np.uint8)
    c = np.zeros((1, 32, 64), np.uint8)
    with pytest.raises(ValueError):
        enc.encode(y, c, c)
