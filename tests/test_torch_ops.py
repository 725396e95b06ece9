"""Transforms, cost, quantization (RDOQ, SBH, Rice bound), rate and RD of
the port against the JAX functions on the same numpy inputs.

Integer outputs must be exact; float RD costs agree to rtol 1e-5 (the port
sums integer distortions exactly, the JAX package in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import cost as jcost
from hevctpu.ops import quant as jquant
from hevctpu.ops import rate as jrate
from hevctpu.ops import rd as jrd
from hevctpu.ops import transforms as jtr
from hevctpu_torch.ops import cost, quant, rate, rd, transforms


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax(fn, *args):
    """Run a JAX reference function jitted (one compile instead of one
    per eager op); static arguments are closed over by `fn`."""
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a) for a in args)))


def _coefs(rng, log2, m, dst=False):
    """Realistic coefficient blocks: forward transforms of residuals."""
    n = 1 << log2
    res = rng.integers(-80, 81, (m, n, n)).astype(np.int32)
    res[: m // 3] //= 8                           # some near-flat blocks
    return _jax(lambda r: jtr.forward_transform(r, log2, dst=dst), res)


@pytest.mark.parametrize("log2,dst", [(2, False), (2, True), (3, False),
                                      (4, False), (5, False)])
def test_transforms(log2, dst):
    rng = np.random.default_rng(log2)
    n = 1 << log2
    res = rng.integers(-255, 256, (40, n, n)).astype(np.int32)
    want = np.asarray(jtr.forward_transform(jnp.asarray(res), log2, dst=dst))
    got = transforms.forward_transform(_t(res), log2, dst=dst).numpy()
    np.testing.assert_array_equal(got, want)
    coef = rng.integers(-32768, 32768, (40, n, n)).astype(np.int32)
    want = np.asarray(jtr.inverse_transform(jnp.asarray(coef), log2, dst=dst))
    got = transforms.inverse_transform(_t(coef), log2, dst=dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_satd_and_sse(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 256, (6, 3, n, n)).astype(np.int32)
    b = rng.integers(0, 256, (6, 1, n, n)).astype(np.int32)
    np.testing.assert_array_equal(
        cost.satd(_t(a), _t(b)).numpy(),
        np.asarray(jcost.satd(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        cost.sse(_t(a), _t(b)).numpy(),
        np.asarray(jcost.sse(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("qp", [22, 32, 37])
def test_quantize_dequantize(log2, qp):
    rng = np.random.default_rng(log2 + qp)
    coef = _coefs(rng, log2, 60)
    lvl = np.asarray(jquant.quantize(jnp.asarray(coef), log2, qp))
    np.testing.assert_array_equal(
        quant.quantize(_t(coef), log2, qp).numpy(), lvl)
    np.testing.assert_array_equal(
        quant.dequantize(_t(lvl), log2, qp).numpy(),
        np.asarray(jquant.dequantize(jnp.asarray(lvl), log2, qp)))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq(log2):
    rng = np.random.default_rng(10 + log2)
    qp = 32
    coef = _coefs(rng, log2, 120, dst=(log2 == 2))
    lam = jrate.lambda_rd(qp)
    scan = (rng.integers(0, 3, 120).astype(np.int32) if log2 <= 3
            else np.zeros(120, np.int32))
    want = _jax(lambda c, s: jquant.quantize_rdoq(c, log2, qp, lam, scan=s),
                coef, scan)
    got = quant.quantize_rdoq(_t(coef), log2, qp, lam, scan=_t(scan)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != 0).any()


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_sign_bit_hide(log2):
    rng = np.random.default_rng(20 + log2)
    qp = 27
    coef = _coefs(rng, log2, 120)
    lvl = np.asarray(jquant.quantize(jnp.asarray(coef), log2, qp))
    scan = rng.integers(0, 3, 120).astype(np.int32)
    want = _jax(lambda l, c, s: jquant.sign_bit_hide(l, c, log2, qp, s),
                lvl, coef, scan)
    got = quant.sign_bit_hide(_t(lvl), _t(coef), log2, qp, _t(scan)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != lvl).any()          # some groups were adjusted


def test_scan_sel():
    modes = np.arange(35, dtype=np.int32)
    for log2 in (2, 3, 4, 5):
        for luma in (True, False):
            np.testing.assert_array_equal(
                quant.scan_sel(_t(modes), log2, luma).numpy(),
                np.asarray(jquant.scan_sel(jnp.asarray(modes), log2, luma)))


def test_rice_bound_integer_form():
    """floor(log2(1 + s/8)) in float32 == bit_length(8 + s) - 4 (clipped),
    over 0..512 (the steps are at 8, 24, 56 and 120)."""
    s = np.arange(513, dtype=np.int32)
    want = np.clip(np.floor(np.log2(1.0 + s.astype(np.float32) / 8.0)),
                   0, 4).astype(np.int32)
    want_j = np.asarray(jnp.clip(jnp.int32(jnp.floor(jnp.log2(
        1.0 + jnp.asarray(s).astype(jnp.float32) / 8.0))), 0, 4))
    got = rate.rice_param(_t(s)).numpy()
    np.testing.assert_array_equal(want, want_j)
    np.testing.assert_array_equal(got, want_j)
    assert [int(np.argmax(got >= k)) for k in (1, 2, 3, 4)] == [8, 24, 56, 120]


def test_golomb_rice_bits():
    v = np.repeat(np.arange(0, 33000, 7, dtype=np.int32), 5)
    k = np.tile(np.arange(5, dtype=np.int32), len(v) // 5)
    np.testing.assert_array_equal(
        rate.golomb_rice_bits(_t(v), _t(k)).numpy(),
        np.asarray(jrate.golomb_rice_bits(jnp.asarray(v), jnp.asarray(k))))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_estimate_tu_bits_and_level_bits(log2):
    rng = np.random.default_rng(30 + log2)
    n = 1 << log2
    lvl = rng.integers(-3, 4, (80, n, n)) * (rng.random((80, n, n)) < 0.2)
    lvl[:5] = 0
    lvl[5:10] *= 40
    lvl = lvl.astype(np.int32)
    for qp in (None, 32):
        np.testing.assert_array_equal(
            rate.estimate_tu_bits(_t(lvl), log2, qp).numpy(),
            _jax(lambda x: jrate.estimate_tu_bits(x, log2, qp), lvl))
    absl = np.abs(lvl)
    kk = rng.integers(0, 5, absl.shape).astype(np.int32)
    np.testing.assert_array_equal(
        rate.level_bits(_t(absl), _t(kk)).numpy(),
        _jax(jrate.level_bits, absl, kk))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_mode_rd_costs(log2):
    rng = np.random.default_rng(40 + log2)
    n = 1 << log2
    orig = rng.integers(0, 256, (7, n, n)).astype(np.int32)
    preds = np.clip(orig[:, None] + rng.integers(-30, 31, (7, 5, n, n)),
                    0, 255).astype(np.int32)
    lam = jrate.lambda_rd(32)
    want = jax.jit(lambda p, o: jrd.mode_rd_costs(
        p, o, log2, 32, lam=lam, dst=(log2 == 2), rate_model="global"))(
            jnp.asarray(preds), jnp.asarray(orig))
    got = rd.mode_rd_costs(_t(preds), _t(orig), log2, 32, lam=lam,
                           dst=(log2 == 2), rate_model="global")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5)


def test_estimate_mode_bits():
    rng = np.random.default_rng(5)
    is_mpm = rng.random(50) < 0.5
    idx = rng.integers(0, 3, 50).astype(np.int32)
    np.testing.assert_array_equal(
        rate.estimate_mode_bits(_t(is_mpm), _t(idx)).numpy(),
        _jax(jrate.estimate_mode_bits, is_mpm, idx))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_tu_bit_features(log2):
    """Per-bin-type counts and bypass bits equal the JAX package's, exact
    (zero TUs, sparse small levels, large levels with Rice remainders),
    and reproduce estimate_tu_bits for the default weights."""
    rng = np.random.default_rng(60 + log2)
    n = 1 << log2
    lvl = rng.integers(-3, 4, (16, n, n)) * (rng.random((16, n, n)) < 0.25)
    lvl[:3] = 0
    lvl[3:9] *= rng.integers(5, 200, (6, 1, 1))
    lvl = lvl.astype(np.int32)
    w = np.array([rate._W_DEFAULT[k] for k in rate._W_FIELDS]
                 + [rate.BITS_ONE])
    est = rate.estimate_tu_bits(_t(lvl), log2).numpy()
    for i, blk in enumerate(lvl):
        got = rate.tu_bit_features(blk, log2)
        want = jrate.tu_bit_features(blk, log2)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        assert got @ w == est[i]


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_last_pos_counts(n):
    np.testing.assert_array_equal(rate._last_pos_counts(n),
                                  jrate._last_pos_counts(n))


def test_lambda_per_unit():
    for qp in range(0, 52):
        assert rate.lambda_per_unit(qp) == jrate.lambda_per_unit(qp)
