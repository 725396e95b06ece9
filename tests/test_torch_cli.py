"""The port's command line, `python -m hevctpu_torch`, with --device cpu on
a 64x64 x 2 clip: encode -> decode round trips (full-RD search, fixed
depth with the shipped codec cfg, rate control, adaptive QP), genlabels,
bytecount, bdrate, the layered config, one byte-identity check of a
--search rd stream against the JAX package's CLI, and train against the
JAX CLI's on a 64x128 x 2 clip (two JAX encoder compiles in all)."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from hevctpu import cli as jcli
from hevctpu import config as jconfig
from hevctpu.models import checkpoint as jckpt
from hevctpu_torch import cli, config
from hevctpu_torch.codec import decoder
from hevctpu_torch.models import checkpoint
from hevctpu_torch.pipeline import yuv


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC_CFG = os.path.join(ROOT, "configs", "encoder_intra_main.cfg")
H = W = 64


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(7)
    n = 2
    yy, xx = np.mgrid[0:H, 0:W]
    y = np.stack([(128 + 60 * np.sin(yy / 6 + i) * np.cos(xx / 9)
                   + rng.normal(0, 4, (H, W))).clip(0, 255)
                  for i in range(n)]).astype(np.uint8)
    u = np.full((n, H // 2, W // 2), 120, np.uint8)
    v = rng.integers(100, 160, (n, H // 2, W // 2)).astype(np.uint8)
    p = tmp_path_factory.mktemp("clip") / "in.yuv"
    yuv.write_yuv420(str(p), y, u, v)
    return str(p), (y, u, v)


def _encode(clip, tmp_path, *flags, name="out"):
    path, _ = clip
    bs = str(tmp_path / f"{name}.bin")
    rec = str(tmp_path / f"{name}_rec.yuv")
    rc = cli.main(["encode", "-i", path, "--width", str(W), "--height",
                   str(H), "-b", bs, "--recon", rec, "--device", "cpu",
                   *flags])
    assert rc == 0
    return bs, rec


def _decode_matches_recon(bs, rec, tmp_path, frames=2):
    dec = str(tmp_path / "dec.yuv")
    assert cli.main(["decode", "-b", bs, "-o", dec]) == 0
    ry, ru, rv = yuv.read_yuv420(rec, W, H, frames)
    dy, du, dv = yuv.read_yuv420(dec, W, H, frames)
    for a, b in ((ry, dy), (ru, du), (rv, dv)):
        np.testing.assert_array_equal(a, b)
    return ry


def test_encode_rd_decode_roundtrip(clip, tmp_path, capsys):
    _, (y, _, _) = clip
    bs, rec = _encode(clip, tmp_path, "-q", "32", "--search", "rd")
    out = capsys.readouterr().out
    assert "SUMMARY" in out and "Bytes written" in out and "Stage ms" in out
    ry = _decode_matches_recon(bs, rec, tmp_path)
    assert float(np.square(ry.astype(float) - y.astype(float)).mean()) < 200


def test_fixed_depth_with_codec_cfg(clip, tmp_path, capsys):
    bs, rec = _encode(clip, tmp_path, "--fixed-depth", "1", "-c", CODEC_CFG,
                      "--hash", "crc")
    assert "QP 32" in capsys.readouterr().out
    _decode_matches_recon(bs, rec, tmp_path)
    dec = decoder.Decoder()
    dec.decode(open(bs, "rb").read())
    assert len(dec.hashes_ok) == 2 and all(dec.hashes_ok)


def test_cnn_model_path(clip, tmp_path):
    bs, rec = _encode(clip, tmp_path, "--model",
                      os.path.join(ROOT, "CKPT_DOMAIN.npz"), "--no-sao")
    _decode_matches_recon(bs, rec, tmp_path)


def test_rate_control_with_lcu_map(clip, tmp_path, capsys):
    """--target-kbps with LCULevelRateControl: one picture per encode, the
    stream signals cu_qp_delta and decodes to the recon."""
    seq = tmp_path / "rc.cfg"
    seq.write_text("LCULevelRateControl : 1\n")
    bs, rec = _encode(clip, tmp_path, "--target-kbps", "200", "--search",
                      "rd", "-c", str(seq))
    out = capsys.readouterr().out
    assert out.count("I-SLICE") == 2
    _decode_matches_recon(bs, rec, tmp_path)
    dec = decoder.Decoder()
    dec.decode(open(bs, "rb").read())
    assert dec.pps["cu_qp_delta"] and len(dec.qp_maps) == 2


def test_adaptive_qp(clip, tmp_path, capsys):
    bs, rec = _encode(clip, tmp_path, "--adaptive-qp", "--fixed-depth", "2",
                      "--no-rdoq", "--no-deblock")
    assert "QP" in capsys.readouterr().out
    _decode_matches_recon(bs, rec, tmp_path)


def test_genlabels(clip, tmp_path):
    path, _ = clip
    out = str(tmp_path / "PartitionInfo.txt")
    assert cli.main(["genlabels", "-i", path, "--width", str(W), "--height",
                     str(H), "-q", "32", "-o", out, "--device", "cpu"]) == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 2  # 1 CTU x 2 frames
    assert all(len(ln) == 16 and set(ln) <= set("0123") for ln in lines)


def test_bytecount(clip, tmp_path, capsys):
    bs, _ = _encode(clip, tmp_path, "--fixed-depth", "0")
    capsys.readouterr()
    assert cli.main(["bytecount", bs]) == 0
    out = capsys.readouterr().out
    assert "NAL units" in out and "SPS" in out
    assert jcli.main(["bytecount", bs]) == 0
    assert capsys.readouterr().out == out


def test_bdrate_prints_the_reference_numbers(tmp_path, capsys):
    a, t = tmp_path / "a.csv", tmp_path / "t.csv"
    a.write_text("# kbps,psnr\n1000,32.1\n1800,34.6\n3200,37.0\n6000,39.4\n")
    t.write_text("950,32.3\n1700,34.7\n3100,37.2\n5600,39.5\n")
    assert cli.main(["bdrate", str(a), str(t)]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["bdrate", str(a), str(t)]) == 0
    assert got == capsys.readouterr().out and "BD-rate" in got


def test_config_layering_matches_reference(tmp_path):
    a = tmp_path / "a.cfg"
    a.write_text("QP : 32\nSAO : 1\nWaveFrontSynchro : 1\n"
                 "QuadtreeTUMaxDepthIntra : 0\nSignHideFlag : 0\n")
    b = tmp_path / "b.cfg"
    b.write_text("QP : 27\nLoopFilterDisable : 1\nTargetKbps : 500\n"
                 "LCULevelRateControl : 1\n")
    files = [CODEC_CFG, str(a), str(b)]
    ec = config.load(files, qp=22, search="rd")
    ref = jconfig.load(files, qp=22, search="rd")
    assert ec.qp == 22 and ec.wpp and not ec.deblock and ec.lcu_rc
    got, want = dataclasses.asdict(ec), dataclasses.asdict(ref)
    got.pop("model"), want.pop("model")
    assert got == want
    assert ec.encoder_kwargs() == ref.encoder_kwargs()
    assert (dataclasses.asdict(ec.to_stream_config(30))
            == dataclasses.asdict(ref.to_stream_config(30)))
    with pytest.raises(config.ConfigError, match="unknown option"):
        config.load([str(tmp_path / "a.cfg"), _bad(tmp_path)])


def _bad(tmp_path):
    p = tmp_path / "bad.cfg"
    p.write_text("NoSuchOption : 1\n")
    return str(p)


def test_device_rule_covers_train(clip, tmp_path):
    path, _ = clip
    argv = ["encode", "-i", path, "--width", str(W), "--height", str(H),
            "-b", str(tmp_path / "x.bin"), "--fixed-depth", "0"]
    train = ["train", "-i", path, "--width", str(W), "--height", str(H),
             "-o", str(tmp_path / "x.npz")]
    if not torch.cuda.is_available():
        for a in (argv, train):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main(a)
    assert not (tmp_path / "x.npz").exists()
    assert cli.main(train + ["--device", "cpu", "--init",
                             str(tmp_path)]) == 2


@pytest.fixture(scope="module")
def wide_clip(tmp_path_factory):
    """64x128 x 2 frames: 16 training samples, fewer than a batch."""
    rng = np.random.default_rng(8)
    n, h, w = 2, 64, 128
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([(128 + 60 * np.sin(yy / 5 + i) * np.cos(xx / 13)
                   + rng.normal(0, 6, (h, w))).clip(0, 255)
                  for i in range(n)]).astype(np.uint8)
    u = rng.integers(90, 170, (n, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(100, 160, (n, h // 2, w // 2)).astype(np.uint8)
    p = tmp_path_factory.mktemp("wide") / "wide.yuv"
    yuv.write_yuv420(str(p), y, u, v)
    return str(p)


def test_train_matches_reference_cli(wide_clip, tmp_path, capsys):
    """train --epochs 2 on the port (CPU) and on the JAX CLI: the written
    npz files agree tensor by tensor (relative L2 1e-4: two Adam steps on
    one batch keep float32 drift at rounding level), whichever package
    loads them, and the printed final accuracy is the same."""
    args = ["train", "-i", wide_clip, "--width", "128", "--height", "64",
            "--epochs", "2"]
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    assert cli.main(args + ["-o", got, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Train time: labels" in out and "(16 samples)" in out
    assert jcli.main(args + ["-o", want]) == 0
    ref_out = capsys.readouterr().out

    def acc(text):
        return re.search(r"trained 2 epochs, final acc ([0-9.]+) -> ",
                         text)[1]

    assert acc(out) == acc(ref_out)
    ref = jckpt.load(want)
    for loaded in (checkpoint.load(got), jckpt.load(got)):
        assert set(loaded) == set(ref)
        for layer in ref:
            for k in ref[layer]:
                a = np.asarray(loaded[layer][k], np.float64)
                b = np.asarray(ref[layer][k], np.float64)
                assert a.shape == b.shape
                assert (np.linalg.norm(a - b)
                        <= 1e-4 * np.linalg.norm(b)), (layer, k)


def test_rd_stream_equals_reference_cli(clip, tmp_path):
    path, _ = clip
    args = ["encode", "-i", path, "--width", str(W), "--height", str(H),
            "-q", "32", "--search", "rd"]
    got, want = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    assert cli.main(args + ["-b", got, "--device", "cpu"]) == 0
    assert jcli.main(args + ["-b", want]) == 0
    assert open(got, "rb").read() == open(want, "rb").read()
