"""The encoder's off-default options against the JAX package at 64x128, 2
frames, QP 32: every coding-tool switch off at once (one JAX compile), and
the full-RD quadtree search search="rd" (one JAX compile). Every integer
output and the stream are bit-identical; SSE agrees to rtol 1e-6 (the port
sums integer squares exactly, the JAX package in float32). Then each
switch alone on the port (CPU): encode, decode with the port's Decoder,
hash SEI verifying, recon equal; and genlabels against the JAX package's
label layout of its own RD search."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.pipeline import encoder as jenc
from hevctpu.pipeline import labels as jlabels
from hevctpu_torch import cli, config
from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.ops import satd_fused
from hevctpu_torch.pipeline import yuv
from hevctpu_torch.pipeline import encoder as tenc


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP, FRAMES = 64, 128, 32, 2
OFF = dict(rdoq=False, sbh=False, ts=False, nxn=False, tu_split=False,
           deblock=False, sao=False)

KEYS_OFF = ["recon_y", "recon_u", "recon_v", "levels_y", "levels_u",
            "levels_v", "cbf_y", "cbf_u", "cbf_v", "cbf4_y", "depth8",
            "coded8", "mode8", "csel8", "nxn8", "mode4", "hash_checksum"]
KEYS_RD = KEYS_OFF + ["ts4_y", "ts8_u", "ts8_v", "tusz8", "sao_type",
                      "sao_eo", "sao_bp", "sao_off", "sao_merge"]


def _stream_cfg(mod, **tools):
    """The StreamConfig the JAX package pairs with these encoder options."""
    return mod.StreamConfig(
        width=W, height=H, qp=QP,
        sign_data_hiding=tools.get("sbh", True),
        transform_skip=tools.get("ts", True),
        max_tu_depth_intra=3 if tools.get("tu_split", True) else 0,
        deblock=tools.get("deblock", True), sao=tools.get("sao", True))


def port_dtype(ref: dict, key: str):
    """The dtype of the port's output `key` where the reference's is
    ref[key]'s: the same, but for the SSE, which the port keeps exact in
    int64 and the reference sums in float32."""
    return np.dtype(np.int64) if key == "sse" else np.asarray(ref[key]).dtype


def busy_clip(seed=0, b=FRAMES, h=H, w=W):
    """Regions that make every decision work: blocky steps, fine stripes,
    binary texture and a smooth gradient (the RD search then takes CU
    depths 0, 1 and 3, NxN, TU splits and chroma transform skip at QP 32;
    clips.clip_sine at this size is all 64x64 CUs)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    ys = []
    for i in range(b):
        y = 128 + 60 * np.sin(yy / 5 + xx / 7 + i)
        blk = rng.integers(30, 220, (h // 8, w // 8)).repeat(8, 0).repeat(
            8, 1)
        y = np.where(xx < w // 4, blk, y)
        y = np.where((xx >= w // 4) & (xx < w // 2) & (yy < h // 2),
                     128 + 100 * ((xx // 2 + yy // 3) % 2), y)
        tex = rng.integers(0, 2, (h // 4, w // 4)).repeat(4, 0).repeat(
            4, 1) * 160 + 40
        y = np.where((xx >= w // 2) & (xx < 3 * w // 4) & (yy >= h // 2),
                     tex, y)
        ys.append(np.clip(y + rng.normal(0, 2, (h, w)), 0, 255))
    u = np.clip(128 + 50 * np.cos(yy[::2, ::2] / 4 + xx[::2, ::2] / 9)[None]
                + rng.integers(-20, 20, (b, h // 2, w // 2)), 0, 255)
    v = rng.integers(60, 200, (b, h // 2, w // 2))
    v[:, :, w // 4:] = 120
    return (np.stack(ys).astype(np.uint8), u.astype(np.uint8),
            v.astype(np.uint8))


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
def pair_off(clip):
    labels = np.random.default_rng(1).integers(0, 4, (FRAMES, 2, 16))
    ref = jenc.FrameEncoder(H, W, QP, **OFF).encode(*clip, labels)
    port = tenc.FrameEncoder(H, W, QP, device="cpu", **OFF).encode(*clip,
                                                                   labels)
    return ref, port


@pytest.fixture(scope="module")
def pair_rd(clip):
    ref = jenc.FrameEncoder(H, W, QP, search="rd").encode(*clip)
    port = tenc.FrameEncoder(H, W, QP, device="cpu", search="rd").encode(*clip)
    return ref, port


@pytest.mark.parametrize("which", ["off", "rd"])
def test_output_keys_and_dtypes(which, pair_off, pair_rd):
    ref, port = pair_off if which == "off" else pair_rd
    assert set(port) == set(ref)
    for k in ref:
        assert np.asarray(port[k]).dtype == port_dtype(ref, k), k
        assert np.shape(port[k]) == np.shape(ref[k]), k
    assert (which == "off") == ("sao_type" not in port)


@pytest.mark.parametrize("key", KEYS_OFF)
def test_switches_off_equal(pair_off, key):
    np.testing.assert_array_equal(pair_off[1][key], pair_off[0][key])


@pytest.mark.parametrize("key", KEYS_RD)
def test_rd_search_equal(pair_rd, key):
    np.testing.assert_array_equal(pair_rd[1][key], pair_rd[0][key])


@pytest.mark.parametrize("which", ["off", "rd"])
def test_sse(which, pair_off, pair_rd):
    ref, port = pair_off if which == "off" else pair_rd
    np.testing.assert_allclose(port["sse"], ref["sse"], rtol=1e-6)


@pytest.mark.parametrize("which", ["off", "rd"])
def test_stream_equals_reference(which, pair_off, pair_rd):
    ref, port = pair_off if which == "off" else pair_rd
    tools = OFF if which == "off" else {}
    got = decoder.encode_stream(_stream_cfg(headers, **tools), [port])
    want = jdecoder.encode_stream(_stream_cfg(jheaders, **tools), [ref])
    assert got == want


def test_rd_search_ignores_labels_and_splits(clip, pair_rd):
    """search="rd" decides the partition itself: labels are ignored, and
    the decision is not one uniform depth on this clip."""
    port = pair_rd[1]
    enc = tenc.FrameEncoder(H, W, QP, device="cpu", search="rd")
    other = enc.encode(*clip, labels=np.full((FRAMES, 2, 16), 3, np.int32))
    np.testing.assert_array_equal(other["depth8"], port["depth8"])
    assert len(np.unique(port["depth8"][port["coded8"]])) > 1
    assert port["nxn8"].any() and port["ts8_u"].any()


def test_genlabels_matches_reference(clip, pair_rd, tmp_path):
    """The port's genlabels writes the JAX package's PartitionInfo lines of
    the same RD search (stage 1, which the loop filters do not touch)."""
    path = str(tmp_path / "in.yuv")
    yuv.write_yuv420(path, *clip)
    got = str(tmp_path / "port.txt")
    assert cli.main(["genlabels", "-i", path, "--width", str(W), "--height",
                     str(H), "-q", str(QP), "-o", got,
                     "--device", "cpu"]) == 0
    want = str(tmp_path / "ref.txt")
    jlabels.write_partition_info(
        want, jlabels.depth8_to_ctu_labels(pair_rd[0]["depth8"], 1, 2),
        append=False)
    assert open(got).read() == open(want).read()
    assert len(open(got).read().splitlines()) == FRAMES * 2


SWITCHES = {"rdoq": dict(rdoq=False), "sbh": dict(sign_data_hiding=False),
            "ts": dict(transform_skip=False), "nxn": dict(nxn=False),
            "tu_split": dict(max_tu_depth_intra=0),
            "deblock": dict(deblock=False), "sao": dict(sao=False),
            "rd": dict(search="rd")}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_roundtrips(clip, labels, switch):
    """One switch through the config fan-out, on the port (CPU): encode,
    then the port's decoder reproduces the recon with the hash verifying."""
    ec = dataclasses.replace(config.EncoderConfig(
        source_width=W, source_height=H, qp=QP, hash_type="checksum"),
        **SWITCHES[switch])
    out = ec.make_encoder(device="cpu").encode(*clip, labels)
    dec = decoder.Decoder()
    frames = dec.decode(decoder.encode_stream(ec.to_stream_config(), [out]))
    assert len(frames) == FRAMES and dec.hashes_ok and all(dec.hashes_ok)
    for i, (y, u, v) in enumerate(frames):
        np.testing.assert_array_equal(y, out["recon_y"][i])
        np.testing.assert_array_equal(u, out["recon_u"][i])
        np.testing.assert_array_equal(v, out["recon_v"][i])


@pytest.mark.gpu
def test_rd_search_on_card_launches_k1_and_matches_cpu(clip):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
    enc = tenc.FrameEncoder(H, W, QP, device="cuda", search="rd")
    satd_fused.LAUNCHES = 0
    out = enc.encode(*clip)
    assert satd_fused.LAUNCHES == 4
    cpu = tenc.FrameEncoder(H, W, QP, device="cpu", search="rd").encode(*clip)
    cfg = _stream_cfg(headers)
    assert (decoder.encode_stream(cfg, [out])
            == decoder.encode_stream(cfg, [cpu]))
