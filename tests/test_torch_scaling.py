"""The multi-device scaling path of the port: a (1, 4) tile mesh held bit
for bit to the single-process encode, the byte tally of parallel/
sharded.py against the closed form of the geometry, and
tools/scaling_model_torch.py against tools/scaling_model.py.

The model's formulas are held to the JAX tool's own record
(SCALING.json) without a JAX compile; the flags and defaults to the JAX
tool's parser, which returns before the JAX tool imports JAX. One gloo
world of 4 CPU ranks (tests/test_torch_sharded.py's machinery) encodes
64x256 x 2, one CTU column a tile, and the tool's own world encodes
another clip at that size. The `slow` test compiles the JAX
ShardedEncoder on the virtual 8-device mesh.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from hevctpu_torch.parallel import scaling
from test_torch_sharded import COMPARED, _assert_same, _clip, \
    spawn_and_encode

# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE4 = dict(world=4, tile=4, h=64, w=256, b=2, qp=32, seed=7, cnn=False)
# 64x256: rc 1, cc 4, so 2(rc - 1) + cc - 1 = 3 exchanges of a [2, 1, 128]
# int32 payload (1024 bytes) from each neighbour; the 13 stage-2 outputs
# of 2 frames x 4 CTUs at 49,984 bytes a CTU, 3/4 of them from the others
HALO_CALLS = 3
HALO_BYTES = {0: 3 * 1024, 1: 6 * 1024, 2: 6 * 1024, 3: 3 * 1024}
WIDTH_BYTES = 2 * 4 * 49984


@pytest.fixture(scope="module")
def tile4_world():
    return spawn_and_encode(TILE4)


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    """tools/scaling_model_torch.py's main on 4 CPU ranks at TILE4's
    size: (its JSON report, the .md)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scaling_model_torch
    out = str(tmp_path_factory.mktemp("tool") / "SCALING_TORCH")
    doc = scaling_model_torch.main(
        ["--device", "cpu", "--world", "4", "--tile", "4", "--h", "64",
         "--w", "256", "--batch", "2", "--deadline", "200", "--out", out])
    with open(out + ".json") as f:
        assert json.load(f) == json.loads(json.dumps(doc, default=float))
    with open(out + ".md") as f:
        return doc, f.read()


def test_model_reproduces_the_jax_record():
    """SCALING.json's shape, collective bytes and v5e constants through
    the port's model: the JAX tool's model block to 1e-12 relative."""
    with open(os.path.join(ROOT, "SCALING.json")) as f:
        rec = json.load(f)
    m = rec["model"]
    got = scaling.model(rec["shape"], rec["collective_bytes_total"],
                        m["bf16_tflops"], m["ici_gbs"], m["dcn_gbs"])
    assert set(got) == set(m)
    for k, want in m.items():
        assert got[k] == pytest.approx(want, rel=1e-12, abs=0), k
    s = rec["shape"]
    assert scaling.analytic_flops(s["batch"], s["h"], s["w"]) \
        == rec["analytic_flops"]


def _parsed_defaults(tool: str) -> dict:
    """The argparse defaults of a tool's main, read in a subprocess that
    stops at parse_args (before the JAX tool imports JAX)."""
    code = textwrap.dedent("""
        import argparse, json, runpy, sys
        parse = argparse.ArgumentParser.parse_args
        def grab(self, args=None, namespace=None):
            print(json.dumps(vars(parse(self, [], namespace))))
            sys.exit(0)
        argparse.ArgumentParser.parse_args = grab
        sys.argv = [%r]
        runpy.run_path(%r, run_name="__main__")
    """ % (tool, os.path.join("tools", tool)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_flags_and_defaults_are_the_jax_tools():
    """Every flag of tools/scaling_model.py with its default (--out
    names SCALING_TORCH, never SCALING), plus --world, --device and
    --deadline; both tools' --help list the flags."""
    jax_tool = _parsed_defaults("scaling_model.py")
    port = _parsed_defaults("scaling_model_torch.py")
    assert set(port) == set(jax_tool) | {"world", "device", "deadline"}
    for k, v in jax_tool.items():
        if k == "out":
            assert v == os.path.join(ROOT, "SCALING")
            assert port[k] == os.path.join(ROOT, "SCALING_TORCH")
        else:
            assert port[k] == v, k
    assert (port["world"], port["device"]) == (8, "cuda")
    helps = [subprocess.run([sys.executable, os.path.join("tools", t),
                             "--help"], cwd=ROOT, capture_output=True,
                            text=True, timeout=120).stdout
             for t in ("scaling_model.py", "scaling_model_torch.py")]
    for flag in ("--h", "--w", "--tile", "--batch", "--out"):
        assert flag in helps[0] and flag in helps[1], flag
    for flag in ("--world", "--device", "--deadline"):
        assert flag in helps[1], flag


@pytest.mark.parametrize("key", COMPARED)
def test_tile4_sharded_matches_single_process(tile4_world, key):
    """Mesh (1, 4), 64x256 x 2, fixed depth 1, QP 32: the edge and the
    two middle tiles each return the whole batch, equal key by key."""
    ranks, single = tile4_world
    assert sorted(ranks) == [0, 1, 2, 3]
    for rank, res in ranks.items():
        assert res["shape"] == {"frame": 1, "tile": 4}
        assert res["coords"] == (0, rank)
        _assert_same(res["out"], single, [key], f"rank {rank}")


def test_tile4_dict_is_the_single_process_dict(tile4_world):
    ranks, single = tile4_world
    for rank, res in ranks.items():
        assert set(res["out"]) == set(single) | {"sbh"}
        _assert_same(res["out"], single, sorted(single), f"rank {rank}")


def test_tile4_tally_equals_closed_form(tile4_world):
    """Each rank's tally: D - 1 exchanges, the halo from one neighbour
    at an edge tile and from two in the middle, the width gather of the
    13 outputs as 4 pieces, no frame gather (a frame group of one)."""
    ranks, _ = tile4_world
    for rank, res in ranks.items():
        got = res["tally"]
        assert got == res["closed_form"], f"rank {rank}"
        halo = HALO_BYTES[rank]
        assert got == {
            "all-gather": {"tile": dict(
                calls=13, bytes=WIDTH_BYTES, sent=WIDTH_BYTES * 3 // 4,
                received=WIDTH_BYTES * 3 // 4)},
            "halo": {"tile": dict(calls=HALO_CALLS, bytes=halo, sent=halo,
                                  received=halo)}}


def test_tool_tally_is_the_pixels_free_closed_form(tool_run, tile4_world):
    """The tool's world encodes clip_sine seed 0, other pixels than the
    test world's clip: every rank's tally is the same closed form."""
    doc, _ = tool_run
    ranks, _ = tile4_world
    assert not np.array_equal(_clip(2, 64, 256, seed=0)[0],
                              _clip(2, 64, 256, seed=7)[0])
    assert [r["rank"] for r in doc["ranks"]] == [0, 1, 2, 3]
    for r in doc["ranks"]:
        assert r["tally"] == ranks[r["rank"]]["closed_form"]
        assert r["coords"] == [0, r["rank"]]
        assert r["k1_launches"] == 0         # the CPU runs K1's plain form
        assert r["s2_launches"] == 0         # and stage 2's planned form
        assert r["s3_launches"] == 0         # and stage 1's plain RD


def test_tool_report_keys_and_model(tool_run):
    """The JAX tool's keys; the tile axis counted on a middle tile;
    the model block equal to the formulas at the H100's constants; no
    TPU figure in either file."""
    doc, md = tool_run
    for k in ("shape", "collective_bytes", "collective_bytes_total",
              "collective_bytes_per_frame", "analytic_flops", "model"):
        assert k in doc, k
    assert doc["shape"] == {"h": 64, "w": 256, "batch": 2, "tile": 4,
                            "frame_axis": 1}
    assert doc["rank_counted"] == 1
    assert doc["collective_bytes"] == {"collective-permute": 6 * 1024,
                                       "all-gather": WIDTH_BYTES}
    total = 6 * 1024 + WIDTH_BYTES
    assert doc["collective_bytes_total"] == total
    assert doc["collective_bytes_per_frame"] == total / 2
    assert doc["frame_axis_gather"]["bytes"] == 0
    want = scaling.model(doc["shape"], total, 989.0, 450.0, 50.0)
    assert doc["model"] == want
    assert {k: c["value"] for k, c in doc["constants"].items()} == {
        "bf16_tflops": 989.0, "ici_gbs": 450.0, "dcn_gbs": 50.0}
    assert doc["run"]["device"] == "cpu"
    text = md + json.dumps(doc)
    for tpu in ("v5e", "TPU"):
        assert tpu not in text, tpu
    # the v5e's figures as numbers of their own (197, 197.0), not digits
    # inside a measured time such as 1692350006197 or 186.4 ms
    for tpu in ("197", "186"):
        assert not re.search(rf"(?<![\d.]){tpu}(\.0+)?(?![\d.])", text), tpu


def test_tool_refuses_what_does_not_tile():
    """The JAX tool's defaults (30 CTU columns, 4 tiles) stop in both
    tools before any rank starts; a world that does not form the tiles
    too."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import scaling_model_torch
    for argv in ([], ["--world", "6"]):
        with pytest.raises(SystemExit) as e:
            scaling_model_torch.main(["--device", "cpu"] + argv)
        assert e.value.code == 2


def _stuck_or_failing_rank(rank, job, init, results):
    """Rank 0 never reports; rank 1 reports a failure when job says so."""
    if rank == 1 and job["fail"]:
        results.put((rank, "Traceback: rank 1 raised"))
    time.sleep(120)


@pytest.mark.parametrize("fail,said", [(True, "rank 1 failed"),
                                       (False, "no result from ranks")])
def test_world_fails_and_kills_its_ranks(fail, said):
    """scaling.run_world (every world of the port's tools, tests and
    chip_smoke.py) raises at a failed rank or at its deadline, long
    before a stuck rank would end, with every rank killed."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=said):
        scaling.run_world(dict(world=2, deadline_s=8, fail=fail),
                          _stuck_or_failing_rank)
    assert time.monotonic() - t0 < (8 if fail else 30)


@pytest.mark.slow
def test_tile4_port_equals_jax_sharded_encoder(tile4_world):
    """The JAX ShardedEncoder on mesh (frame=2, tile=4) of the virtual
    8-device mesh, at the same geometry and clip: the port's tile-4
    ranks' dict key by key."""
    import jax
    from hevctpu.parallel import ShardedEncoder, make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(jax.devices()[:8], tile=4)
    y, u, v = _clip(TILE4["b"], TILE4["h"], TILE4["w"], TILE4["seed"])
    want = ShardedEncoder(TILE4["h"], TILE4["w"], qp=TILE4["qp"], mesh=mesh,
                          fixed_depth=1).encode(y, u, v)
    ranks, _ = tile4_world
    for rank, res in ranks.items():
        for k in COMPARED + ["labels"]:
            np.testing.assert_array_equal(
                np.asarray(res["out"][k]), np.asarray(want[k]),
                err_msg=f"rank {rank}: {k}")
