"""The cell's own path at the class-B boundary, on the CPU: window.build ->
window.run -> check.judge at 120x128 x 2 frames, a 2 x 2 CTU grid whose
bottom CTU row holds 56 luma lines as at 1080 (1080 = 16 * 64 + 56), so
that a CU crossing the bottom edge splits down to 8x8 (4x4 chroma TUs).
Two content families, and ConvNet2 with the trained weights and with
seeded random ones: every number of the check reads 0, and the served
maps hold the 8x8 CUs the edge forces. And every configuration's CTU
grid and diagonals agree with its width and height, as the program
counts them."""

import json
import os

import numpy as np
import pytest

import _setup  # noqa: F401
from cellbench import check, spec, traffic, window

H, W = 120, 128
CELL = "classB_qp32_b8_corpus"
SEED = 2**33 + 18
BENCH = spec.load_benchmark()


@pytest.fixture(scope="module", params=["trained", "random"])
def judged(request, tmp_path_factory):
    """One warm-up batch and a window of at least two batches (one a
    family) of the class-B cell's configuration cut to 120x128, judged."""
    cell = spec.cell(CELL)
    config = dict(cell.config, height=H, width=W)
    if request.param == "trained":
        weights = os.path.join(spec.ROOT, config["weights"])
    else:
        from hevctpu_torch.models import checkpoint, convnet2
        weights = str(tmp_path_factory.mktemp("cnn") / "random.npz")
        checkpoint.save(weights, convnet2.init_params(5))
    mix = traffic.Mix.from_dict(dict(cell.traffic, batch=2,
                                     families=["scene", "detail"],
                                     check_frames=2))
    s = window.build(config, mix, SEED, weights, "cpu")
    window.warm_up(s)
    # two batches dispatched at once; none after them unless a batch
    # takes under ~0.64 of the warm-up's time
    res = window.run(s, 1.6 * s.warmup_s)
    served = [dict(family=b.family, frames=b.frames, labels=b.out["labels"],
                   out=b.out, stream=b.stream) for b in res["batches"]]
    out = check.judge(config, mix, weights, s.pool, served, SEED, "cpu")
    return cell, served, out


def test_every_number_of_the_check_is_0(judged):
    cell, served, out = judged
    assert {b["family"] for b in served} == {"scene", "detail"}
    assert out["checked"] == 2 and out["wrong"] == 0
    assert out["decode_errors"] == []
    assert out["numbers"] == dict.fromkeys(check.NUMBERS, 0)
    correct, _ = check.verdict(out["numbers"], cell.limits)
    assert correct


def test_the_bottom_edge_forces_8x8_cus(judged):
    """Rows 112-119 of the picture are the last 8 lines of the 56-line CTU
    row: every CU there is 8x8 (depth 3), whatever the labels say, and
    the 8x8 row below them lies outside the picture."""
    _, served, _ = judged
    for b in served:
        depth8 = np.asarray(b["out"]["depth8"])     # on the CTU grid
        coded8 = np.asarray(b["out"]["coded8"])
        assert depth8.shape[1:] == coded8.shape[1:] == (128 // 8, W // 8)
        assert coded8[:, :15].all() and not coded8[:, 15:].any()
        assert (depth8[:, 14, :] == 3).all()
        assert (depth8[:, 12:14, :] >= 2).all()
        lab = check.label_depths(np.asarray(b["labels"])[0], H, W)
        assert (lab[14] == 3).all()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_ctu_grid_and_diagonals_agree_with_the_size(name):
    from hevctpu_torch.pipeline.encoder import Geometry

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    g = Geometry(cfg["height"], cfg["width"])
    assert cfg["ctu_grid"] == [-(-cfg["height"] // 64),
                               -(-cfg["width"] // 64)] == [g.rc, g.cc]
    act_r, _, _ = g.wavefront_tiled(1)
    assert cfg["diagonals"] == 2 * (g.rc - 1) + g.cc == act_r.shape[1]
