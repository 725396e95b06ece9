"""The whole slice: the port's FrameEncoder against the JAX FrameEncoder at
the 64x128 geometry, 2 frames, QP 32, with the same ConvNet2 labels.

Every integer output is exact; the float SSE agrees to rtol 1e-6 (the port
sums integer squares exactly, the JAX package in float32). The stream the
port's host coder writes equals the JAX package's byte for byte, and the
port's decoder reproduces the recon with the hash SEI verifying."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.models import convnet2 as jconv
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.pipeline import clips
from hevctpu_torch.pipeline import encoder as tenc


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP, FRAMES = 64, 128, 32, 2

INT_KEYS = ["recon_y", "recon_u", "recon_v", "levels_y", "levels_u",
            "levels_v", "cbf_y", "cbf_u", "cbf_v", "cbf4_y", "ts4_y",
            "ts8_u", "ts8_v", "depth8", "coded8", "mode8", "csel8", "nxn8",
            "mode4", "tusz8", "sao_type", "sao_eo", "sao_bp", "sao_off",
            "sao_merge", "hash_checksum"]


@pytest.fixture(scope="module")
def clip():
    return clips.clip_sine(FRAMES, H, W, seed=0)


@pytest.fixture(scope="module")
def params():
    return checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))


@pytest.fixture(scope="module")
def labels(clip, params):
    return np.asarray(jconv.predict_batch_labels(
        params, *(jnp.asarray(p) for p in clip), H, W)).astype(np.int32)


@pytest.fixture(scope="module")
def ref(clip, labels):
    return jenc.FrameEncoder(H, W, QP).encode(*clip, labels)


@pytest.fixture(scope="module")
def port(clip, labels):
    return tenc.FrameEncoder(H, W, QP, device="cpu").encode(*clip, labels)


def test_output_keys_and_dtypes(ref, port):
    assert set(port) == set(ref)
    for k in ref:
        assert np.asarray(port[k]).dtype == np.asarray(ref[k]).dtype, k
        assert np.shape(port[k]) == np.shape(ref[k]), k


@pytest.mark.parametrize("key", INT_KEYS)
def test_integer_output_equal(ref, port, key):
    np.testing.assert_array_equal(port[key], ref[key])


def test_sse(ref, port):
    np.testing.assert_allclose(port["sse"], ref["sse"], rtol=1e-6)


def test_encode_fused_labels(clip, params, labels, port):
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    out = enc.encode_fused(convnet2.load_model(params, "cpu"), *clip)
    np.testing.assert_array_equal(out["labels"], labels.astype(np.int8))
    for k in INT_KEYS:
        np.testing.assert_array_equal(out[k], port[k])
    assert set(enc.stage_ms()) == {"upload", "cnn", "stage1", "stage2",
                                   "filters"}


@pytest.mark.parametrize("hash_type", ["md5", "checksum"])
def test_stream_equals_reference(ref, port, hash_type):
    got = decoder.encode_stream(headers.StreamConfig(
        width=W, height=H, qp=QP, hash_type=hash_type), [port])
    want = jdecoder.encode_stream(jheaders.StreamConfig(
        width=W, height=H, qp=QP, hash_type=hash_type), [ref])
    assert got == want


def test_python_coder_equals_native(port):
    cfg = headers.StreamConfig(width=W, height=H, qp=QP)
    assert (decoder.encode_stream(cfg, [port], use_native=False)
            == decoder.encode_stream(cfg, [port], use_native=True))


def test_decoder_reproduces_recon(port):
    stream = decoder.encode_stream(
        headers.StreamConfig(width=W, height=H, qp=QP), [port])
    dec = decoder.Decoder()
    frames = dec.decode(stream)
    assert len(frames) == FRAMES and dec.hashes_ok and all(dec.hashes_ok)
    for i, (y, u, v) in enumerate(frames):
        np.testing.assert_array_equal(y, port["recon_y"][i])
        np.testing.assert_array_equal(u, port["recon_u"][i])
        np.testing.assert_array_equal(v, port["recon_v"][i])


def test_pass1_candidates_break_ties_like_top_k():
    """Integer SATD plus three mode-bit classes ties often: the port's
    stable sort must keep lax.top_k's lower-index-first order."""
    import torch
    rng = np.random.default_rng(0)
    satd = rng.integers(0, 6, (2, 5, 7, 35)).astype(np.int32) * 16
    lam = 57.0
    for n in (4, 16, 64):
        want = jax.jit(lambda s: jenc._pass1_candidates(s, lam, n))(
            jnp.asarray(satd))
        got = tenc._pass1_candidates(torch.as_tensor(satd), lam, n)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
