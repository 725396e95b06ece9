"""Recon-feedback decisions (two_pass=True) in the port against the JAX
package: stage 1 runs again with neighbor boundaries read from the first
pass's pre-filter reconstruction, then stage 2 reconstructs with the
second decisions. At 64x128 x 2 frames, QP 32, with ConvNet2 labels (one
JAX compile), every integer output and the stream are bit-identical; SSE
agrees to rtol 1e-6 (the port sums integer squares exactly, the JAX
package in float32)."""

import os

import numpy as np
import pytest
import torch

from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.pipeline import encoder as tenc
from test_torch_options import KEYS_RD, busy_clip, port_dtype


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP, FRAMES = 64, 128, 32, 2


@pytest.fixture(scope="module")
def clip():
    return busy_clip()


@pytest.fixture(scope="module")
def labels(clip):
    model = convnet2.load_model(
        checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz")), "cpu")
    planes = [torch.as_tensor(p.astype(np.int32)) for p in clip]
    return convnet2.predict_frame_labels(model, *planes, H,
                                         W).numpy().astype(np.int32)


@pytest.fixture(scope="module")
def pair_two(clip, labels):
    ref = jenc.FrameEncoder(H, W, QP, two_pass=True).encode(*clip, labels)
    enc = tenc.FrameEncoder(H, W, QP, device="cpu", two_pass=True)
    port = enc.encode(*clip, labels)
    return ref, port, enc.stage_ms()


def test_two_pass_keys_and_dtypes(pair_two):
    ref, port, _ = pair_two
    assert set(port) == set(ref)
    for k in ref:
        assert np.asarray(port[k]).dtype == port_dtype(ref, k), k
        assert np.shape(port[k]) == np.shape(ref[k]), k


@pytest.mark.parametrize("key", KEYS_RD)
def test_two_pass_equal(pair_two, key):
    np.testing.assert_array_equal(pair_two[1][key], pair_two[0][key])


def test_two_pass_sse(pair_two):
    np.testing.assert_allclose(pair_two[1]["sse"], pair_two[0]["sse"],
                               rtol=1e-6)


def test_two_pass_stream_equals_reference_and_decodes(pair_two):
    ref, port, _ = pair_two
    got = decoder.encode_stream(headers.StreamConfig(
        width=W, height=H, qp=QP), [port])
    want = jdecoder.encode_stream(jheaders.StreamConfig(
        width=W, height=H, qp=QP), [ref])
    assert got == want
    dec = decoder.Decoder()
    frames = dec.decode(got)
    assert len(frames) == FRAMES and dec.hashes_ok and all(dec.hashes_ok)
    for i, (y, u, v) in enumerate(frames):
        np.testing.assert_array_equal(y, port["recon_y"][i])
        np.testing.assert_array_equal(u, port["recon_u"][i])
        np.testing.assert_array_equal(v, port["recon_v"][i])


def test_two_pass_stage_ms(pair_two):
    """stage_ms keeps its keys and adds the first pass's stage 2 and the
    second pass's stage 1."""
    assert set(pair_two[2]) == {"upload", "stage1", "pass1_stage2",
                                "pass2_stage1", "stage2", "filters"}


def test_two_pass_moves_decisions(clip, labels, pair_two):
    """The second pass reads other boundaries: on this clip some decision
    differs from the one-pass encode."""
    one = tenc.FrameEncoder(H, W, QP, device="cpu").encode(*clip, labels)
    port = pair_two[1]
    assert any(not np.array_equal(port[k], one[k])
               for k in ("mode8", "mode4", "csel8", "tusz8", "nxn8"))


@pytest.mark.gpu
def test_two_pass_on_card_launches_k1_twice_and_matches_cpu(clip, labels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    from hevctpu_torch.ops import satd_fused
    outs = []
    for dev in ("cuda", "cpu"):
        satd_fused.LAUNCHES = 0
        outs.append(tenc.FrameEncoder(H, W, QP, device=dev,
                                      two_pass=True).encode(*clip, labels))
        assert satd_fused.LAUNCHES == (8 if dev == "cuda" else 0)
    cfg = headers.StreamConfig(width=W, height=H, qp=QP)
    assert (decoder.encode_stream(cfg, [outs[0]])
            == decoder.encode_stream(cfg, [outs[1]]))
