"""K1, the fused SATD mode search: its plain PyTorch version against the JAX
package (predict_all_modes_mm + cost.satd, and the Pallas kernel in
interpret mode), exact; the tap table the CUDA kernel reads against the
dense operator P it is derived from; and the CUDA kernel against the plain
version, which needs a card (marker `gpu`) and skips without one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import cost as jcost
from hevctpu.ops import intra as jintra
from hevctpu.ops import intra_mm as jintra_mm
from hevctpu.ops import satd_fused as jsatd
from hevctpu_torch import rom
from hevctpu_torch.ops import intra_mm, satd_fused


def _inputs(rng, m, n):
    ext = lambda: rng.integers(0, 256, (m, 2 * n + 1)).astype(np.int32)
    top_e, left_e = ext(), ext()
    top_f, left_f = (np.asarray(x) for x in jintra.smooth_reference(
        jnp.asarray(top_e), jnp.asarray(left_e), n))
    blocks = rng.integers(0, 256, (m, n, n)).astype(np.int32)
    return top_e, left_e, top_f, left_f, blocks


def _t(xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_plain_k1_matches_jax_unfused(n, is_luma):
    rng = np.random.default_rng(n)
    inp = _inputs(rng, 37, n)              # M = 37: not a tile multiple
    want = np.asarray(jax.jit(lambda te, le, tf, lf, b: jcost.satd(
        jintra_mm.predict_all_modes_mm(te, le, tf, lf, n, is_luma=is_luma),
        b[:, None]))(*(jnp.asarray(x) for x in inp)))
    launches = satd_fused.LAUNCHES
    got = satd_fused.dense_mode_costs(*_t(inp), n, is_luma=is_luma).numpy()
    np.testing.assert_array_equal(got, want)
    assert satd_fused.LAUNCHES == launches     # CPU tensors: plain version


def test_plain_k1_matches_pallas_interpret():
    rng = np.random.default_rng(8)
    n = 8
    inp = _inputs(rng, 37, n)
    want = np.asarray(jsatd.dense_mode_costs(
        *(jnp.asarray(x) for x in inp), n, interpret=True))
    got = satd_fused.dense_mode_costs(*_t(inp), n).numpy()
    np.testing.assert_array_equal(got, want)
    # the unpatched kernel function itself
    refs = intra_mm.pack_refs(*_t(inp[:4]))
    want = np.asarray(jsatd.mode_satd_costs(
        jnp.asarray(refs.numpy()), jnp.asarray(inp[4].reshape(37, 64)), n,
        interpret=True))
    got = satd_fused.mode_satd_costs(refs, torch.as_tensor(
        inp[4].reshape(37, 64)), n).numpy()
    np.testing.assert_array_equal(got, want)


def test_leading_axes():
    rng = np.random.default_rng(7)
    n, shape = 8, (2, 3, 5)
    m = int(np.prod(shape))
    inp = _t(_inputs(rng, m, n))
    got = satd_fused.dense_mode_costs(
        *(x.reshape(shape + x.shape[1:]) for x in inp), n)
    assert got.shape == shape + (35,)
    want = satd_fused.dense_mode_costs(*inp, n)
    np.testing.assert_array_equal(got.reshape(m, 35).numpy(), want.numpy())


def _tap_rows(mode, second):
    """Table rows the kernel reads for `mode` (none for DC)."""
    if mode == rom.PLANAR_IDX:
        return range(satd_fused.PLANAR_SLOTS)
    if mode == rom.DC_IDX:
        return range(0)
    row = satd_fused.PLANAR_SLOTS + (mode - 2) * satd_fused.ANGULAR_SLOTS
    return range(row, row + (2 if second[mode] else 1))


def _split_table(n, is_luma):
    table = satd_fused.tap_table(n, is_luma, torch.device("cpu")).numpy()
    nn, rows = n * n, satd_fused.TAP_ROWS
    words = table[: rows * nn].reshape(rows, nn).astype(np.int64)
    const = table[rows * nn: rows * nn + 35]
    second = table[rows * nn + 35: rows * nn + 70]
    assert table.size == rows * nn + 71
    return words, const, second, int(table[-1])


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_tap_table_rebuilds_p(n, is_luma):
    """Decoding the table as the kernel does gives P back exactly."""
    p, _ = intra_mm.prediction_tensor(n, is_luma)
    k, nn = p.shape[0], n * n
    words, const, second, dc_w = _split_table(n, is_luma)
    dense = np.zeros((k, 35, nn), dtype=np.int64)
    px = np.arange(nn)
    for mode in range(35):
        for row in _tap_rows(mode, second):
            w = words[row]
            np.add.at(dense[:, mode], (w >> 16, px), w & 255)
            np.add.at(dense[:, mode], ((w >> 16) + 1, px), (w >> 8) & 255)
        dense[k - 1, mode] = const[mode]
    ln = 2 * n + 1
    dense[np.r_[1: n + 1, ln + 1: ln + n + 1], rom.DC_IDX] += dc_w
    np.testing.assert_array_equal(dense.reshape(p.shape), p)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_tap_table_fits_kernel(n, is_luma):
    """No (mode, pixel) has more taps than the kernel reads, and every
    field fits the type the kernel reads it as."""
    p, _ = intra_mm.prediction_tensor(n, is_luma)
    k = p.shape[0]
    words, const, second, dc_w = _split_table(n, is_luma)
    cols = p.reshape(k, 35, n * n)
    for mode in range(35):
        if mode == rom.DC_IDX:
            continue
        slots = (satd_fused.PLANAR_SLOTS if mode == rom.PLANAR_IDX
                 else satd_fused.ANGULAR_SLOTS)
        for px in range(n * n):
            assert len(satd_fused._pair_words(cols[: k - 1, mode, px])) \
                <= slots
        if mode != rom.PLANAR_IDX:
            row = _tap_rows(mode, [1] * 35)[1]
            assert second[mode] == int(words[row].any())
            if not second[mode]:            # rows the kernel skips are 0
                assert not words[row].any()
    assert words.min() >= 0 and words.max() < 2 ** 31
    assert (words >> 16).max() + 1 <= k - 1  # idx and idx+1 are refs
    assert const.min() >= 0 and 0 < dc_w <= 255
    assert satd_fused.tap_table(n, is_luma, torch.device("cpu")).nbytes \
        < 300_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 37, "tile+1"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, n, is_luma, m):
    if m == "tile+1":                     # one full tile and a ragged one
        m = satd_fused.tile_rows(n) + 1
    rng = np.random.default_rng(n)
    inp = _inputs(rng, m, n)
    refs = intra_mm.pack_refs(*_t(inp[:4])).to(cuda_device).contiguous()
    orig = torch.as_tensor(inp[4].reshape(m, n * n)).to(cuda_device)
    launches = satd_fused.LAUNCHES
    got = satd_fused.mode_satd_costs(refs, orig, n, is_luma=is_luma)
    torch.cuda.synchronize()
    assert satd_fused.LAUNCHES == launches + 1
    want = satd_fused.mode_satd_costs_ref(refs, orig, n, is_luma=is_luma)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_cuda_kernel_any_constant_column(cuda_device, n, is_luma):
    """The kernel computes refs @ P for any last column of refs, not only
    the 1 that pack_refs writes."""
    rng = np.random.default_rng(n + 1)
    m = 37
    inp = _inputs(rng, m, n)
    refs = intra_mm.pack_refs(*_t(inp[:4]))
    refs[:, -1] = torch.as_tensor(rng.integers(0, 256, m), dtype=torch.int32)
    refs = refs.to(cuda_device).contiguous()
    orig = torch.as_tensor(inp[4].reshape(m, n * n)).to(cuda_device)
    got = satd_fused.mode_satd_costs(refs, orig, n, is_luma=is_luma)
    want = satd_fused.mode_satd_costs_ref(refs, orig, n, is_luma=is_luma)
    assert torch.equal(got, want)
