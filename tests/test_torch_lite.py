"""The lite transfer (encode_fused_dispatch / collect with lite=True) in
the port against the JAX package: no recon planes (the hash SEI comes
from the device checksum), levels as int8 plus an escape sidecar, bool
planes bitpacked. The pack functions equal the JAX package's and round
trip with escapes (the cases of tests/test_hash_lite.py); the lite encode
at 64x128 x 2 frames, QP 32, with ConvNet2 labels keeps every key of the
full encode but the recon planes, and its stream equals the port's full
stream and the JAX lite stream (one JAX compile)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.models import checkpoint as jcheckpoint
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.pipeline import encoder as tenc
from test_torch_options import busy_clip


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "CKPT_DOMAIN.npz")
H, W, QP, FRAMES = 64, 128, 32, 2
RECON = ("recon_y", "recon_u", "recon_v")


def _escape_levels():
    rng = np.random.default_rng(9)
    lvl = rng.integers(-40, 41, (2, 16, 16), dtype=np.int32)
    lvl[0, 3, 4] = 900
    lvl[0, 0, 0] = -301
    lvl[1, 15, 15] = -128
    return lvl


@pytest.mark.parametrize("shape", [(3, 7, 11), (2, 8, 16), (1, 1, 1)])
def test_pack_bits_equals_reference_and_roundtrips(shape):
    x = np.random.default_rng(5).random(shape) < 0.4
    got = tenc._pack_bits_device(torch.as_tensor(x)).numpy()
    want = np.asarray(jenc._pack_bits_device(jnp.asarray(x)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tenc._unpack_bits_host(got, shape[1:]), x)


def test_pack_levels_equals_reference_and_roundtrips():
    lvl = _escape_levels()
    got = [t.numpy() for t in tenc._pack_levels_device(torch.as_tensor(lvl))]
    want = [np.asarray(a) for a in jenc._pack_levels_device(jnp.asarray(lvl))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    out = tenc._unpack_levels_host(*got, np.int16)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, lvl)
    assert got[3].tolist() == [2, 1]


def test_pack_levels_overflow_raises():
    lvl = np.zeros((2, 64, 128), np.int32)
    lvl[1].reshape(-1)[: tenc._ESC_MAX + 5] = 200
    packed = [t.numpy() for t in tenc._pack_levels_device(
        torch.as_tensor(lvl))]
    assert packed[3].tolist() == [0, tenc._ESC_MAX + 5]
    np.testing.assert_array_equal(packed[1][1], np.arange(tenc._ESC_MAX))
    with pytest.raises(ValueError, match="re-encode without lite transfer"):
        tenc._unpack_levels_host(*packed, np.int16)


@pytest.fixture(scope="module")
def encodes():
    clip = busy_clip()
    cnn = convnet2.load_model(checkpoint.load(CKPT), "cpu")
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    dev_full = enc.encode_fused_dispatch(cnn, *clip)
    dev_lite = enc.encode_fused_dispatch(cnn, *clip, lite=True)
    nbytes = [sum(t.numel() * t.element_size() for t in d.values())
              for d in (dev_full, dev_lite)]
    full = enc.collect(dev_full)
    lite = enc.collect(dev_lite, lite=True)
    ref = jenc.FrameEncoder(H, W, QP).encode_fused(jcheckpoint.load(CKPT),
                                                   *clip, lite=True)
    return full, lite, ref, dev_lite, nbytes


def test_lite_keys_and_dtypes(encodes):
    full, lite, ref = encodes[:3]
    assert set(lite) == set(full) - set(RECON)
    assert set(lite) == set(ref)
    for k in lite:
        assert np.asarray(lite[k]).dtype == np.asarray(ref[k]).dtype, k
        assert np.shape(lite[k]) == np.shape(ref[k]), k
        assert np.asarray(lite[k]).dtype == np.asarray(full[k]).dtype, k
    assert lite["levels_y"].dtype == np.int16
    assert lite["cbf4_y"].dtype == bool


def test_lite_equals_full_and_reference(encodes):
    full, lite, ref = encodes[:3]
    for k in lite:
        np.testing.assert_array_equal(lite[k], full[k], err_msg=k)
        if k != "sse":
            np.testing.assert_array_equal(lite[k], ref[k], err_msg=k)
    np.testing.assert_allclose(lite["sse"], ref["sse"], rtol=1e-6)


def test_lite_stream_equals_full_and_reference(encodes):
    full, lite, ref = encodes[:3]
    cfg = headers.StreamConfig(width=W, height=H, qp=QP,
                               hash_type="checksum")
    s_lite = decoder.encode_stream(cfg, [lite])
    assert s_lite == decoder.encode_stream(cfg, [full])
    assert s_lite == jdecoder.encode_stream(jheaders.StreamConfig(
        width=W, height=H, qp=QP, hash_type="checksum"), [ref])
    dec = decoder.Decoder()
    frames = dec.decode(s_lite)
    assert len(frames) == FRAMES and dec.hashes_ok and all(dec.hashes_ok)
    for i, (y, _, _) in enumerate(frames):
        np.testing.assert_array_equal(y, full["recon_y"][i])


def test_lite_packed_layout(encodes):
    """What crosses the link: no recon, one byte per level plus the
    fixed escape sidecar, one bit per flag. At this small size the
    sidecar (2 x 4096 int32 per plane and frame) outweighs the saving;
    it pays from about 416x240 up."""
    full, lite, ref, dev_lite, nbytes = encodes
    print(f"device->host bytes: full {nbytes[0]}, lite {nbytes[1]}")
    assert not set(RECON) & set(dev_lite)
    for comp in ("y", "u", "v"):
        assert dev_lite[f"levels_{comp}"].dtype == torch.int8
        assert dev_lite[f"levels_{comp}"].shape == full[f"levels_{comp}"].shape
        for k in ("esc_pos", "esc_val"):
            assert dev_lite[f"{k}_{comp}"].shape == (FRAMES, tenc._ESC_MAX)
    for k in tenc._LITE_BOOL_KEYS:
        assert dev_lite[k].dtype == torch.uint8
        assert dev_lite[k].shape == (FRAMES, -(-full[k][0].size // 8))
    sidecar = sum(dev_lite[f"{k}_{c}"].numel() * 4 for k in ("esc_pos",
                                                              "esc_val")
                  for c in "yuv")
    assert nbytes[1] - sidecar < nbytes[0] / 2


@pytest.mark.gpu
def test_pack_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lvl = torch.as_tensor(_escape_levels())
    for g, w in zip(tenc._pack_levels_device(lvl.cuda()),
                    tenc._pack_levels_device(lvl)):
        assert torch.equal(g.cpu(), w)
    x = torch.as_tensor(np.random.default_rng(5).random((3, 7, 11)) < 0.4)
    assert torch.equal(tenc._pack_bits_device(x.cuda()).cpu(),
                       tenc._pack_bits_device(x))
