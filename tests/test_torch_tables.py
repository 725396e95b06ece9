"""The port's copied and rebuilt static tables equal the JAX package's."""

import numpy as np
import pytest
import torch

from hevctpu import rom as jrom
from hevctpu.ops import intra as jintra
from hevctpu.ops import intra_mm as jintra_mm
from hevctpu.ops import quant as jquant
from hevctpu.ops import rate as jrate
from hevctpu.ops import rate_weights as jrate_weights
from hevctpu.ops import satd_fused as jsatd
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch import rom
from hevctpu_torch.ops import intra, intra_mm, quant, rate, rate_weights
from hevctpu_torch.ops import satd_fused
from hevctpu_torch.pipeline import encoder as tenc


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_rom_copy_constants():
    names = [n for n in dir(jrom) if not n.startswith("_")
             and not callable(getattr(jrom, n))
             and not isinstance(getattr(jrom, n), type(np))]
    assert names
    for n in names:
        assert _equal(getattr(jrom, n), getattr(rom, n)), n


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rom_copy_functions(n):
    log2 = int(np.log2(n))
    assert _equal(jrom.dct_matrix(n), rom.dct_matrix(n))
    for s in range(3):
        m = min(n, 8)
        assert _equal(jrom.scan_order(s, m), rom.scan_order(s, m))
        assert _equal(jrom.tb_scan(s, log2), rom.tb_scan(s, log2))
    for qp in range(0, 52, 3):
        assert jrom.chroma_qp_from_luma(qp) == rom.chroma_qp_from_luma(qp)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_prediction_tensor(n, is_luma):
    assert _equal(jintra_mm.prediction_tensor(n, is_luma),
                  intra_mm.prediction_tensor(n, is_luma))
    assert _equal(jintra_mm._pred_matrix_bf16(n, is_luma),
                  intra_mm._pred_matrix_bf16(n, is_luma))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_intra_tables(n):
    assert _equal(jintra._angular_tables(n), intra._angular_tables(n))
    assert _equal(jintra._filter_flags(n, True), intra._filter_flags(n))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_scan_and_rate_tables(log2):
    n = 1 << log2
    assert _equal(jquant._tb_scan_tables(log2), quant._tb_scan_tables(log2))
    assert _equal(jquant._last_bits_scan(log2, 200),
                  quant._last_bits_scan(log2, 200))
    assert _equal(jrate._last_pos_bits(n, 171), rate._last_pos_bits(n, 171))
    assert _equal(jrate._scan_pos(n), rate._scan_pos(n))
    assert _equal(jquant._pos_in_cg(), quant._pos_in_cg())


def test_rate_weights():
    assert _equal(jrate_weights.FITTED, rate_weights.FITTED)
    for qp in (None, 20, 22, 27, 30, 32, 37, 45):
        assert _equal(jrate.bin_weights(qp), rate.bin_weights(qp))
        if qp:
            assert jrate.lambda_rd(qp) == rate.lambda_rd(qp)
            assert (jrate.chroma_dist_weight(qp, qp - 2)
                    == rate.chroma_dist_weight(qp, qp - 2))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_satd_fused_tables(n):
    assert _equal(jsatd._kron_hadamard(n), satd_fused._kron_hadamard(n))
    assert _equal(jsatd._subblock_group(n), satd_fused._subblock_group(n))


def test_block16_schedule_and_zorder():
    assert _equal(jenc._block16_schedule(), tenc._block16_schedule())
    for oy, ox, n, span in ((0, 0, 32, 64), (16, 48, 16, 64), (4, 12, 4, 32),
                            (24, 8, 8, 32), (60, 60, 4, 64)):
        assert _equal(jenc._zorder_avail_np(oy, ox, n, span),
                      tenc._zorder_avail_np(oy, ox, n, span))


@pytest.mark.parametrize("hw", [(64, 128), (240, 416), (1080, 1920),
                                (120, 176)])
def test_geometry_tables(hw):
    jg, tg = jenc.Geometry(*hw), tenc.Geometry(*hw)
    assert _equal(jg.wavefront, tg.wavefront)
    assert _equal(jg.bh_bw, tg.bh_bw)
    if hw[0] <= 240:
        for n, scale in ((4, 1), (8, 1), (32, 1), (4, 2), (16, 2)):
            assert _equal(jenc._grid_avail(jg, n, scale),
                          tenc._grid_avail(tg, n, scale))
