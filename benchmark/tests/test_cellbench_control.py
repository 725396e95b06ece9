"""The control: the plain reference in the program's place one step
below the configuration's precision (TF32 on) must be judged not correct
at the cell's own size. TF32 exists only on the card, so the test of the
reading needs one (marker gpu; it skips without a card). On the CPU the
control's path runs through the check at a tiny size."""

import pytest

import _setup  # noqa: F401
import control
from cellbench import check, spec, traffic


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [7101, 7102, 7103])
def test_control_is_not_correct(card, seed):
    cell = spec.cell("classD_qp32_b32_corpus")
    mix = traffic.Mix.from_dict(cell.traffic)
    pool = traffic.make_pool(mix, cell.config["height"],
                             cell.config["width"], seed)
    served = control.control_batches(cell, mix, pool, seed, 8, card)
    judged = check.judge(cell.config, mix,
                         f"{spec.ROOT}/{cell.config['weights']}", pool,
                         served, seed, card)
    correct, rows = check.verdict(judged["numbers"], cell.limits)
    assert not correct, rows


def test_control_path_on_the_cpu(tmp_path):
    from test_cellbench_run import tiny_root
    root = tiny_root(tmp_path)
    cell = spec.cell("tiny_cell", root=root)
    mix = traffic.Mix.from_dict(cell.traffic)
    pool = traffic.make_pool(mix, 64, 128, 11)
    served = control.control_batches(cell, mix, pool, 11, 3, "cpu")
    assert [b["family"] for b in served] == ["pink", "detail", "pink"]
    judged = check.judge(cell.config, mix, cell.config["weights"], pool,
                         served, 11, "cpu")
    assert judged["checked"] == 2 and judged["numbers"]["frames_missing"] == 0
