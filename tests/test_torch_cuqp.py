"""Per-CTU QP maps (cu_qp_delta) in the port against the JAX package.

The full encode: search="rd" with a random qp_map at 128x192, 2 frames
(the fixture of tests/test_cuqp.py, one JAX compile): the effective map
qp_ctu, levels, recon and the stream are bit-identical. The vector-QP
quantizers and the per-slot-QP deblocker equal the JAX functions on random
integer inputs (exact: all of it is integer arithmetic, or float costs of
the same integers with the same per-TU λ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.ops import deblock as jdeblock
from hevctpu.ops import quant as jquant
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.ops import deblock, quant, rate
from hevctpu_torch.pipeline import encoder as tenc

H, W, QP = 128, 192, 32
KEYS = ["qp_ctu", "recon_y", "recon_u", "recon_v", "levels_y", "levels_u",
        "levels_v", "cbf_y", "cbf_u", "cbf_v", "cbf4_y", "ts4_y", "ts8_u",
        "ts8_v", "depth8", "mode8", "mode4", "tusz8", "sao_type",
        "sao_off", "hash_checksum"]


def _clip(b, h, w, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([(128 + 70 * np.sin(yy / 6) * np.cos(xx / 9)
                   + rng.normal(0, 8, (h, w))).clip(0, 255).astype(np.int32)
                  for _ in range(b)])
    u = np.stack([(128 + 40 * np.cos(yy[::2, ::2] / 9)).astype(np.int32)] * b)
    v = rng.integers(60, 200, (b, h // 2, w // 2)).astype(np.int32)
    return y, u, v


@pytest.fixture(scope="module")
def encoded():
    clip = _clip(2, H, W)
    rng = np.random.default_rng(11)
    qmap = rng.integers(QP - 3, QP + 4, (2, 2, 3)).astype(np.int32)
    ref = jenc.FrameEncoder(H, W, QP, search="rd").encode(*clip, qp_map=qmap)
    port = tenc.FrameEncoder(H, W, QP, device="cpu", search="rd").encode(
        *clip, qp_map=qmap)
    return ref, port


@pytest.mark.parametrize("key", KEYS)
def test_qp_map_outputs_equal(encoded, key):
    ref, port = encoded
    assert np.asarray(port[key]).dtype == np.asarray(ref[key]).dtype
    np.testing.assert_array_equal(port[key], ref[key])


def test_qp_map_stream_equals_reference(encoded):
    ref, port = encoded
    got = decoder.encode_stream(headers.StreamConfig(
        width=W, height=H, qp=QP, cu_qp_delta=True), [port])
    want = jdecoder.encode_stream(jheaders.StreamConfig(
        width=W, height=H, qp=QP, cu_qp_delta=True), [ref])
    assert got == want


def test_qp_map_roundtrip(encoded):
    port = encoded[1]
    stream = decoder.encode_stream(headers.StreamConfig(
        width=W, height=H, qp=QP, cu_qp_delta=True), [port])
    dec = decoder.Decoder()
    frames = dec.decode(stream)
    assert len(frames) == 2 and all(dec.hashes_ok)
    for i, (ry, ru, rv) in enumerate(frames):
        np.testing.assert_array_equal(ry, port["recon_y"][i])
        np.testing.assert_array_equal(ru, port["recon_u"][i])
        np.testing.assert_array_equal(rv, port["recon_v"][i])
    assert len(np.unique(port["qp_ctu"])) > 1
    for got, want in zip(dec.qp_maps, port["qp_ctu"]):
        np.testing.assert_array_equal(got, want)


def test_constant_map_matches_scalar_path():
    """A map filled with the slice QP reproduces the encode without a map
    bit for bit (port only)."""
    h, w, qp = 64, 128, 27
    clip = _clip(1, h, w, seed=3)
    enc = tenc.FrameEncoder(h, w, qp, device="cpu", search="rd")
    base = enc.encode(*clip)
    mapped = enc.encode(*clip, qp_map=np.full((1, 1, 2), qp, np.int32))
    for k in base:
        np.testing.assert_array_equal(np.asarray(base[k]),
                                      np.asarray(mapped[k]), err_msg=k)
    assert (mapped["qp_ctu"] == qp).all()


def _quant_inputs(log2, seed, t=12):
    rng = np.random.default_rng(seed)
    n = 1 << log2
    coef = (rng.laplace(0, 300, (t, n, n))
            * (rng.random((t, n, n)) < 0.6)).astype(np.int32)
    lvl = (rng.laplace(0, 6, (t, n, n)) * (rng.random((t, n, n)) < 0.5)
           ).astype(np.int32)
    qp = rng.integers(22, 43, t).astype(np.int32)
    scan = rng.integers(0, 3, t).astype(np.int32)
    lam = (rate.lambda_rd(QP) * np.exp2((qp - QP).astype(np.float32) / 3.0)
           ).astype(np.float32)
    return coef, lvl, qp, scan, lam


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _vector_quant_port(fn, log2, coef, lvl, qp, scan, lam, dev="cpu"):
    c, lv, q, s, la = (_t(x).to(dev) for x in (coef, lvl, qp, scan, lam))
    if fn == "quantize":
        return quant.quantize(c, log2, q)
    if fn == "dequantize":
        return quant.dequantize(lv, log2, q)
    if fn == "quantize_rdoq":
        return quant.quantize_rdoq(c, log2, q, la, scan=s, rate_qp=QP)
    return quant.sign_bit_hide(quant.quantize(c, log2, q), c, log2, q, s)


def _vector_quant_jax(fn, log2, coef, lvl, qp, scan, lam):
    c, lv, q, s, la = (jnp.asarray(x) for x in (coef, lvl, qp, scan, lam))
    if fn == "quantize":
        return jquant.quantize(c, log2, q)
    if fn == "dequantize":
        return jquant.dequantize(lv, log2, q)
    if fn == "quantize_rdoq":
        return jquant.quantize_rdoq(c, log2, q, la, scan=s, rate_qp=QP)
    return jquant.sign_bit_hide(jquant.quantize(c, log2, q), c, log2, q, s)


QUANT_FNS = ["quantize", "dequantize", "quantize_rdoq", "sign_bit_hide"]


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("fn", QUANT_FNS)
def test_vector_qp_quant_matches_reference(fn, log2):
    inp = _quant_inputs(log2, seed=10 * log2 + QUANT_FNS.index(fn))
    got = _vector_quant_port(fn, log2, *inp).numpy()
    want = np.asarray(jax.jit(lambda *a: _vector_quant_jax(fn, log2, *a))(
        *inp))
    np.testing.assert_array_equal(got, want)
    if fn != "sign_bit_hide":
        assert (got != 0).any()


def test_vector_qp_equals_static_qp():
    """A per-TU QP tensor filled with one QP gives the static-QP result."""
    coef, lvl, _, scan, _ = _quant_inputs(3, seed=5)
    q = torch.full((coef.shape[0],), 30, dtype=torch.int32)
    lam = torch.full((coef.shape[0],), float(np.float32(rate.lambda_rd(30))))
    c = _t(coef)
    pairs = [(quant.quantize(c, 3, q), quant.quantize(c, 3, 30)),
             (quant.dequantize(_t(lvl), 3, q),
              quant.dequantize(_t(lvl), 3, 30)),
             (quant.quantize_rdoq(c, 3, q, lam, scan=_t(scan), rate_qp=30),
              quant.quantize_rdoq(c, 3, 30, rate.lambda_rd(30),
                                  scan=_t(scan)))]
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), b.numpy())


DELTAS = np.arange(-51, 52, dtype=np.int32)   # every qp - sliceQP


def _jax_lambda_scale():
    """The JAX encoder's per-CTU λ scale (encoder.py, qp_map branch)."""
    return np.asarray(jax.jit(lambda d: jnp.exp2(
        d.astype(jnp.float32) / 3.0))(jnp.asarray(DELTAS)))


def test_lambda_scale_matches_reference():
    """Bit-identical to XLA's for |Δ| ≤ 34 (every map of the rate
    controller and the fixtures); never more than 1 ULP off beyond."""
    got = tenc.lambda_scale(torch.as_tensor(DELTAS)).numpy()
    want = _jax_lambda_scale()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    print("deltas off by 1 ULP:", DELTAS[ulp != 0].tolist())
    assert (ulp[np.abs(DELTAS) <= 34] == 0).all()
    assert ulp.max() <= 1


def test_lambda_scale_ulp_moves_no_rdoq_level():
    """The cost margin of the deltas where the port's λ scale is 1 ULP
    off XLA's: RDOQ with either λ chooses the same levels on random
    blocks of every size at that delta's QP."""
    got = tenc.lambda_scale(torch.as_tensor(DELTAS)).numpy()
    want = _jax_lambda_scale()
    off = DELTAS[got != want]
    for d in off:
        slice_qp = 51 if d < 0 else 0
        i = int(np.flatnonzero(DELTAS == d)[0])
        for log2 in (2, 3, 4, 5):
            coef, _, _, scan, _ = _quant_inputs(log2, seed=int(d) + 60, t=64)
            q = torch.full((coef.shape[0],), slice_qp + int(d),
                           dtype=torch.int32)
            lv = [quant.quantize_rdoq(
                _t(coef), log2, q,
                torch.full((coef.shape[0],), float(rate.lambda_rd(slice_qp)
                                                   * s)).float(),
                scan=_t(scan), rate_qp=slice_qp).numpy()
                for s in (got[i], want[i])]
            np.testing.assert_array_equal(lv[0], lv[1])


def _planes(rng, b, h, w):
    """Blocky 'reconstructions': 8x8 steps plus noise."""
    def one(hh, ww):
        base = rng.integers(40, 200, (b, hh // 8, ww // 8))
        rec = np.repeat(np.repeat(base, 8, 1), 8, 2) + rng.integers(
            -3, 4, (b, hh, ww))
        return np.clip(rec, 0, 255).astype(np.int32)
    return one(h, w), one(h // 2, w // 2), one(h // 2, w // 2)


def _deblock_inputs(hw, per_ctu, seed):
    h, w = hw
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    rng = np.random.default_rng(seed)
    y, u, v = _planes(rng, 2, hp, wp)
    tusz = rng.integers(2, 6, (2, hp // 8, wp // 8)).astype(np.int32)
    if per_ctu:
        qmap = np.repeat(np.repeat(rng.integers(
            20, 45, (2, hp // 64, wp // 64)), 8, 1), 8, 2).astype(np.int32)
    else:
        qmap = rng.integers(15, 52, (2, hp // 8, wp // 8)).astype(np.int32)
    return (y, u, v, tusz, qmap), h, w


@pytest.mark.parametrize("per_ctu", [True, False])
@pytest.mark.parametrize("hw", [(64, 128), (120, 176)])
def test_per_slot_qp_deblock_matches_reference(hw, per_ctu):
    (y, u, v, tusz, qmap), h, w = _deblock_inputs(hw, per_ctu,
                                                  seed=hw[0] + hw[1])
    want = jax.jit(lambda *a: jdeblock.deblock_frame(*a, h, w))(
        *(jnp.asarray(a) for a in (y, u, v, tusz, qmap)))
    got = deblock.deblock_frame(_t(y), _t(u), _t(v), _t(tusz), _t(qmap), h, w)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert (np.asarray(want[0]) != y).any()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
@pytest.mark.parametrize("fn", QUANT_FNS)
def test_vector_qp_quant_card_equals_cpu(cuda_device, fn, log2):
    inp = _quant_inputs(log2, seed=log2)
    got = _vector_quant_port(fn, log2, *inp, dev=cuda_device).cpu().numpy()
    want = _vector_quant_port(fn, log2, *inp).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("per_ctu", [True, False])
def test_per_slot_qp_deblock_card_equals_cpu(cuda_device, per_ctu):
    (y, u, v, tusz, qmap), h, w = _deblock_inputs((120, 176), per_ctu, 3)
    args = [_t(a) for a in (y, u, v, tusz)]
    want = deblock.deblock_frame(*args, _t(qmap), h, w)
    got = deblock.deblock_frame(*(a.to(cuda_device) for a in args),
                                _t(qmap).to(cuda_device), h, w)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), wnt.numpy())
