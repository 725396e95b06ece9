"""The evaluation path (hevctpu_torch/pipeline/evaluate.py, profile.py and
tools/*_torch.py) against the JAX tools (tools/measure_corpus.py,
measure_anchor.py, attribute_gap.py, measure_rd.py, bit_stats.py,
profile_stages.py, measure_pruned_hm.py).

- parse_mode, bd, the HM runners, the pred files and the per-clip and
  corpus summaries are held to the JAX tools exactly. The HM runs go to
  a stand-in HM binary (a small script: it keeps a copy of its cfg, the
  pred tree and HM_USE_PRED, writes a bitstream and prints a canned
  SUMMARY and Total Time); the tools' reports run on stand-in encoders,
  the same on both sides, so the comparison is of the tools' own
  arithmetic and output.
- frame_bit_stats and the bit_stats report equal the JAX tool's on the
  same CPU port encode.
- One cnn point equals the kbps and PSNR of the JAX FrameEncoder at
  tests/test_torch_encoder.py's configuration (its compile is shared).
- profile_stages runs at 64x128 x 1 on the CPU with the JAX tool's stage
  keys and operation counts.
"""

import argparse
import filecmp
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.models import convnet2 as jconv
from hevctpu.pipeline import encoder as jenc
from hevctpu.pipeline import metrics as jmetrics
from hevctpu_torch.codec import headers
from hevctpu_torch.models import checkpoint
from hevctpu_torch.pipeline import clips, evaluate, profile
from hevctpu_torch.pipeline import encoder as tenc

# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import attribute_gap as jgap  # noqa: E402
import attribute_gap_torch as tgap  # noqa: E402
import bit_stats as jbits  # noqa: E402
import bit_stats_torch as tbits  # noqa: E402
import measure_anchor as janchor  # noqa: E402
import measure_anchor_torch as tanchor  # noqa: E402
import measure_corpus as jcorpus  # noqa: E402
import measure_corpus_torch as tcorpus  # noqa: E402
import measure_pruned_hm as jpruned  # noqa: E402
import measure_pruned_hm_torch as tpruned  # noqa: E402
import measure_rd as jrd  # noqa: E402
import measure_rd_torch as trd  # noqa: E402
import profile_stages as jprofile  # noqa: E402
import profile_stages_torch as tprofile  # noqa: E402

STANDIN_HM = """#!{python}
# Stand-in for TAppEncoderStatic -c <cfg>: keeps what HM was given, writes
# a bitstream, prints a SUMMARY and a Total Time that follow QP, SAO, RDOQ.
import os, shutil, sys
cfg = sys.argv[2]
kv = {{}}
for line in open(cfg):
    if ":" in line:
        k, v = line.split(":", 1)
        kv[k.strip()] = v.strip()
qp, n = int(kv["QP"]), int(kv["FramesToBeEncoded"])
aside = os.environ["STANDIN_ASIDE"]
os.makedirs(aside, exist_ok=True)
shutil.copy(cfg, os.path.join(aside, os.path.basename(cfg)))
if os.path.isdir("pred"):
    shutil.copytree("pred", os.path.join(aside, "pred"), dirs_exist_ok=True)
with open(os.path.join(aside, "env%d" % qp), "w") as f:
    f.write(os.environ.get("HM_USE_PRED", "-"))
with open(kv["BitstreamFile"], "wb") as f:
    f.write(bytes(100 * (52 - qp) + n))
kbps = 1000.0 * 2 ** ((51 - qp) / 6) + 13.0 * int(kv["SAO"]) \\
    + 7.0 * int(kv["RDOQ"]) + 3.0 * int(kv["LoopFilterDisable"])
y = 60.0 - qp + 0.1 * int(kv["SAO"])
print("")
print("SUMMARY --------------------------------------------------------")
print("\\tTotal Frames |   Bitrate     Y-PSNR    U-PSNR    V-PSNR    YUV-PSNR")
print("\\t      %d    a   %10.4f   %7.4f   %7.4f   %7.4f   %7.4f"
      % (n, kbps, y, y + 1, y + 2, y + 0.5))
print("")
print(" Total Time:      %.3f sec." % (0.5 + qp / 10))
"""


@pytest.fixture
def standin(tmp_path, monkeypatch):
    """The stand-in HM binary; its copies go to tmp_path/aside."""
    path = tmp_path / "TAppEncoderStatic"
    path.write_text(STANDIN_HM.format(python=sys.executable))
    path.chmod(0o755)
    monkeypatch.setenv("STANDIN_ASIDE", str(tmp_path / "aside"))
    yield str(path)
    os.environ.pop("HM_USE_PRED", None)   # the JAX tools set it


def _tree(d) -> dict:
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            p = os.path.join(base, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def _side(tmp_path, fn):
    """fn(workdir) in a fresh tmp_path/work (the same path for both
    packages, so the cfg text can be compared); (result, what the
    stand-in kept)."""
    work = tmp_path / "work"
    aside = tmp_path / "aside"
    for d in (work, aside):
        shutil.rmtree(d, ignore_errors=True)
    work.mkdir()
    (work / "in.yuv").write_bytes(b"")
    res = fn(str(work))
    os.environ.pop("HM_USE_PRED", None)
    return res, _tree(aside)


# ---------------------------------------------------------------------------
# The protocol's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cnn", "rd", "cnn-2p", "rd-global",
                                  "cnn-global-2p", "rd-2p-global"])
def test_parse_mode_matches_jax_tool(mode):
    assert evaluate.parse_mode(mode) == jcorpus.parse_mode(mode)


@pytest.mark.parametrize("mode", ["rd-fast", "dct", "cnn-"])
def test_parse_mode_rejects_unknown(mode):
    with pytest.raises(ValueError):
        evaluate.parse_mode(mode)
    with pytest.raises((ValueError, AssertionError)):
        jcorpus.parse_mode(mode)


def test_bd_matches_jax_tool():
    with open(os.path.join(ROOT, "CORPUS_HM.json")) as f:
        cache = json.load(f)
    rng = np.random.default_rng(0)
    for entry in cache.values():
        test = [dict(p, bitrate_kbps=p["bitrate_kbps"] * rng.uniform(0.9, 1.2),
                     psnr_y=p["psnr_y"] + rng.uniform(-0.5, 0.3))
                for p in entry["pruned"]]
        for a, t in ((entry["anchor"], entry["pruned"]),
                     (entry["anchor"], test), (entry["pruned"], test)):
            assert evaluate.bd(a, t) == jcorpus.bd(jmetrics, a, t)


def test_cfg_template_and_variants_match_jax_tools():
    assert evaluate.CFG_TEMPLATE == janchor.CFG_TEMPLATE
    assert evaluate.VARIANTS == jgap.VARIANTS


@pytest.mark.parametrize("labelled", [False, True])
def test_hm_points_and_pred_files_match_jax_tool(standin, tmp_path,
                                                 labelled):
    labels = (np.random.default_rng(1).integers(0, 4, (2, 2, 16))
              if labelled else None)
    qps = [22, 32]
    jax_pts, jax_kept = _side(tmp_path, lambda wd: jcorpus.hm_points(
        standin, os.path.join(wd, "in.yuv"), 128, 64, 2, qps, wd, labels))
    pts, kept = _side(tmp_path, lambda wd: evaluate.hm_points(
        standin, os.path.join(wd, "in.yuv"), 128, 64, 2, qps, wd, labels,
        log=lambda *a: None))
    assert pts == jax_pts
    assert kept == jax_kept
    assert kept[f"env{qps[0]}"] == (b"1" if labelled else b"-")
    assert ("pred/1/ctu1.txt" in kept) == labelled
    if labelled:
        assert kept["pred/1/ctu1.txt"].decode() == " ".join(
            str(x) for x in labels[1, 1])


def test_run_hm_matches_jax_tool(standin, tmp_path):
    jax_p, jax_kept = _side(tmp_path, lambda wd: janchor.run_hm(
        standin, os.path.join(wd, "in.yuv"), 416, 240, 8, 27, wd))
    p, kept = _side(tmp_path, lambda wd: evaluate.run_hm(
        standin, os.path.join(wd, "in.yuv"), 416, 240, 8, 27, wd))
    assert p == jax_p and kept == jax_kept
    assert p["bytes"] == 100 * (52 - 27) + 8 and p["frames"] == 8


@pytest.mark.parametrize("vname", list(jgap.VARIANTS))
def test_run_hm_variant_matches_jax_tool(standin, tmp_path, vname):
    over = jgap.VARIANTS[vname][1]
    jax_p, jax_kept = _side(tmp_path, lambda wd: jgap.run_hm_variant(
        standin, os.path.join(wd, "in.yuv"), 416, 240, 8, 32, wd, over))
    p, kept = _side(tmp_path, lambda wd: evaluate.run_hm_variant(
        standin, os.path.join(wd, "in.yuv"), 416, 240, 8, 32, wd, over))
    assert p == jax_p and kept == jax_kept
    # an override replaces its key's line of the template; a key the
    # template lacks (hdq's SignHideFlag) changes nothing, in both tools
    cfg = kept["q32v.cfg"].decode()
    for key, val in over.items():
        assert (f"{key} : {val}\n" in cfg) == (f"\n{key} " in
                                                evaluate.CFG_TEMPLATE)


def test_run_hm_raises_on_hm_failure(tmp_path):
    bad = tmp_path / "hm"
    bad.write_text("#!/bin/sh\necho broken; exit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="exited 3"):
        evaluate.run_hm(str(bad), "in.yuv", 128, 64, 1, 32, str(tmp_path))


# ---------------------------------------------------------------------------
# The tools' reports, on stand-in encoders
# ---------------------------------------------------------------------------


def fake_points(y, u, v, qps, mode, *a, **k):
    """ours_points' stand-in: a curve that follows QP, clip and mode."""
    off = float(np.mean(y)) / 1000 + len(mode) / 100
    return [dict(qp=qp,
                 bitrate_kbps=round(1000 * 2 ** ((51 - qp) / 6) * (1 + off),
                                    2),
                 psnr_y=round(60 - qp - off, 4), psnr_u=round(61.0 - qp, 4),
                 psnr_v=round(62.0 - qp, 4), time_s=round(1 + qp / 10 + off,
                                                          3))
            for qp in qps]


class FakeEncoder:
    """Either package's FrameEncoder, stood in: the recon is the input plus
    an error that grows with QP and the options."""

    def __init__(self, h, w, qp, **kw):
        kw.pop("device", None)
        self.qp, self.amp = qp, qp // 4 + len(kw)

    def encode(self, y, u, v, labels=None):
        rng = np.random.default_rng(self.qp)

        def noisy(p):
            return np.clip(p + rng.integers(-self.amp, self.amp + 1, p.shape),
                           0, 255).astype(np.uint8)

        return {"recon_y": noisy(y), "recon_u": noisy(u),
                "recon_v": noisy(v)}


def fake_stream(cfg, outs, **kw):
    n = sum(o["recon_y"].shape[0] for o in outs)
    return bytes(int(n * 400 * 2 ** ((51 - cfg.qp) / 6)) + 3 * int(cfg.sao)
                 + 5 * int(cfg.sign_data_hiding))


def _run_jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    module.main()


def _same_doc(port: dict, ref: dict, *paths):
    """port equals ref once the port's device label and the keys at paths
    (its generator names) are set to ref's."""
    port = json.loads(json.dumps(port))
    for path in paths:
        *head, last = path
        dst, src = port, ref
        for k in head:
            dst, src = dst[k], src[k]
        dst[last] = src[last]
    return port == ref


def test_corpus_report_matches_jax_tool_and_keeps_the_cache(
        tmp_path, monkeypatch):
    """--skip-hm over two clips and three modes: the per-clip tables, the
    averages and the headline keys equal the JAX tool's; the port leaves
    the HM cache file as it was."""
    monkeypatch.setattr(jcorpus, "ours_points", fake_points)
    monkeypatch.setattr(evaluate, "ours_points", fake_points)
    argv = ["--skip-hm", "--clips", "pink,scene", "--modes", "cnn,rd,cnn-2p",
            "--model", os.path.join(ROOT, "CKPT_DOMAIN.npz")]
    for side in ("jax", "port"):
        shutil.copy(os.path.join(ROOT, "CORPUS_HM.json"),
                    tmp_path / f"{side}_hm.json")
    before = os.stat(tmp_path / "port_hm.json").st_mtime_ns
    _run_jax_main(monkeypatch, jcorpus, argv + [
        "--hm-cache", str(tmp_path / "jax_hm.json"),
        "--out", str(tmp_path / "jax.json")])
    tcorpus.main(argv + ["--hm-cache", str(tmp_path / "port_hm.json"),
                         "--out", str(tmp_path / "port.json"),
                         "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port["protocol"].pop("device") == "cpu"
    assert _same_doc(port, ref, ("protocol", "generator"))
    assert port["average"]["bd_rate_pct_cnn-2p"] is not None
    assert filecmp.cmp(tmp_path / "port_hm.json",
                       os.path.join(ROOT, "CORPUS_HM.json"), shallow=False)
    assert os.stat(tmp_path / "port_hm.json").st_mtime_ns == before


def test_corpus_runs_hm_for_a_missing_entry_like_jax_tool(
        standin, tmp_path, monkeypatch):
    """Without a cached entry both tools run HM (anchor, then pruned with
    the same labels through the pred files) and write the same cache."""
    monkeypatch.setattr(jcorpus, "ours_points", fake_points)
    monkeypatch.setattr(evaluate, "ours_points", fake_points)
    labels = np.random.default_rng(2).integers(0, 4, (2, 28, 16))
    monkeypatch.setattr(jconv, "predict_batch_labels",
                        lambda *a, **k: labels)
    monkeypatch.setattr(evaluate, "clip_labels", lambda *a, **k: labels)
    argv = ["--clips", "pink", "--modes", "rd", "--frames", "2",
            "--hm", standin]
    docs, kept = {}, {}
    for side, main in (("jax", lambda a: _run_jax_main(monkeypatch, jcorpus,
                                                       a)),
                       ("port", lambda a: tcorpus.main(a + ["--device",
                                                            "cpu"]))):
        monkeypatch.setenv("STANDIN_ASIDE", str(tmp_path / f"aside_{side}"))
        main(argv + ["--hm-cache", str(tmp_path / f"{side}_hm.json"),
                     "--out", str(tmp_path / f"{side}.json")])
        os.environ.pop("HM_USE_PRED", None)
        docs[side] = json.loads((tmp_path / f"{side}.json").read_text())
        kept[side] = _tree(tmp_path / f"aside_{side}")
    assert (json.loads((tmp_path / "port_hm.json").read_text())
            == json.loads((tmp_path / "jax_hm.json").read_text()))
    docs["port"]["protocol"].pop("device")
    assert _same_doc(docs["port"], docs["jax"], ("protocol", "generator"),
                     ("protocol", "cnn_checkpoint"))
    # the cfgs name each run's own temporary directory; the pred trees and
    # the gate's environment are the same
    for side in kept:
        kept[side] = {k: v for k, v in kept[side].items()
                      if not k.endswith(".cfg")}
    assert kept["port"] == kept["jax"]
    assert kept["port"]["env27"] == b"1"
    assert kept["port"]["pred/1/ctu27.txt"].decode() == " ".join(
        str(x) for x in labels[1, 27])


def test_gap_attribution_report_matches_jax_tool(tmp_path, monkeypatch):
    import hevctpu.codec.decoder
    import hevctpu.pipeline.encoder
    import hevctpu_torch.codec.decoder
    import hevctpu_torch.pipeline.encoder
    for mod in (hevctpu.pipeline.encoder, hevctpu_torch.pipeline.encoder):
        monkeypatch.setattr(mod, "FrameEncoder", FakeEncoder)
    for mod in (hevctpu.codec.decoder, hevctpu_torch.codec.decoder):
        monkeypatch.setattr(mod, "encode_stream", fake_stream)
    cache = os.path.join(ROOT, "CORPUS_HM_VARIANTS.json")
    before = os.stat(cache).st_mtime_ns
    argv = ["--skip-hm", "--clips", "pink"]
    _run_jax_main(monkeypatch, jgap, argv + ["--out",
                                             str(tmp_path / "jax.json")])
    tgap.main(argv + ["--out", str(tmp_path / "port.json"),
                      "--device", "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port["protocol"].pop("device") == "cpu"
    assert port == ref
    assert set(port["pink"]) == set(jgap.VARIANTS)
    assert os.stat(cache).st_mtime_ns == before


def test_rd_report_matches_jax_tool(tmp_path, monkeypatch):
    import hevctpu.codec.decoder
    import hevctpu.pipeline.encoder
    import hevctpu_torch.codec.decoder
    import hevctpu_torch.pipeline.encoder
    for mod in (hevctpu.pipeline.encoder, hevctpu_torch.pipeline.encoder):
        monkeypatch.setattr(mod, "FrameEncoder", FakeEncoder)
    for mod in (hevctpu.codec.decoder, hevctpu_torch.codec.decoder):
        monkeypatch.setattr(mod, "encode_stream", fake_stream)
    labels = np.zeros((2, 28, 16), np.int32)
    monkeypatch.setattr(jconv, "predict_batch_labels",
                        lambda *a, **k: labels)
    monkeypatch.setattr(evaluate, "clip_labels", lambda *a, **k: labels)
    argv = ["--frames", "2"]
    _run_jax_main(monkeypatch, jrd, argv + ["--out",
                                            str(tmp_path / "jax.json")])
    trd.main(argv + ["--out", str(tmp_path / "port.json"), "--device",
                     "cpu"])
    ref = json.loads((tmp_path / "jax.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    assert port.pop("device") == "cpu"
    assert _same_doc(port, ref, ("clip", "generator"))
    assert "bd_rate_pct_rd_vs_pruned_hm" in port


def test_anchor_tool_matches_jax_tool(standin, tmp_path, monkeypatch,
                                     capsys):
    """tools/measure_anchor_torch.py against tools/measure_anchor.py on the
    stand-in HM: the same printed lines (one JSON line a QP, then the
    path written), the same HM inputs and the same document but the
    clip's generator; neither writes BASELINE_MEASURED.json."""
    anchor = os.path.join(ROOT, "BASELINE_MEASURED.json")
    before = open(anchor, "rb").read(), os.stat(anchor).st_mtime_ns
    out = str(tmp_path / "anchor.json")
    argv = ["--frames", "2", "--hm", standin, "--qps", "22,37", "--out", out]
    docs, printed, kept = {}, {}, {}
    for side, main in (("jax", lambda a: _run_jax_main(monkeypatch, janchor,
                                                       a)),
                       ("port", tanchor.main)):
        monkeypatch.setenv("STANDIN_ASIDE", str(tmp_path / f"aside_{side}"))
        capsys.readouterr()
        main(argv)
        printed[side] = capsys.readouterr().out.splitlines()
        docs[side] = json.loads(open(out).read())
        kept[side] = {k: v for k, v in _tree(tmp_path / f"aside_{side}")
                      .items() if not k.endswith(".cfg")}
    assert printed["port"] == printed["jax"]
    assert len(printed["port"]) == 3 and printed["port"][-1] == f"wrote {out}"
    assert docs["jax"]["clip"]["generator"] == "bench.synth_clip(seed=0)"
    assert docs["port"]["clip"]["generator"] == \
        "bench_torch.synth_clip(seed=0)"
    assert _same_doc(docs["port"], docs["jax"], ("clip", "generator"))
    assert kept["port"] == kept["jax"]
    assert (open(anchor, "rb").read(), os.stat(anchor).st_mtime_ns) == before


class _Parsed(Exception):
    """Stops a tool's main once its flags are known."""


def test_anchor_tool_defaults_match_jax_tool(monkeypatch):
    """The JAX tool's flags and defaults, but the output file."""
    seen = []

    def defaults(parser, args=None, namespace=None):
        seen.append({a.dest: a.default for a in parser._actions
                     if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", defaults)
    for main in (janchor.main, tanchor.main):
        with pytest.raises(_Parsed):
            main()
    jax, port = seen
    assert jax.pop("out") == os.path.join(ROOT, "BASELINE_MEASURED.json")
    assert port.pop("out") == os.path.join(ROOT,
                                           "BASELINE_MEASURED_TORCH.json")
    assert port == jax == {"frames": 8, "hm": "/tmp/hm/bin/TAppEncoderStatic",
                           "qps": "22,27,32,37"}


def test_pruned_hm_tool_matches_jax_tool(standin, tmp_path, monkeypatch):
    """labels -> pred files -> HM with HM_USE_PRED=1 at each QP: the same
    points, pred tree and gate as the JAX tool, given the same labels."""
    labels = np.random.default_rng(3).integers(0, 4, (1, 28, 16))
    monkeypatch.setattr(jconv, "predict_batch_labels",
                        lambda *a, **k: labels)
    monkeypatch.setattr(evaluate, "clip_labels", lambda *a, **k: labels)
    shutil.copy(os.path.join(ROOT, "BASELINE_MEASURED.json"), tmp_path)
    argv = ["--frames", "1", "--hm", standin]
    docs, kept = {}, {}
    for side, main in (("jax", lambda a: _run_jax_main(monkeypatch, jpruned,
                                                       a)),
                       ("port", lambda a: tpruned.main(a + ["--device",
                                                            "cpu"]))):
        monkeypatch.setenv("STANDIN_ASIDE", str(tmp_path / f"aside_{side}"))
        main(argv + ["--out", str(tmp_path / f"{side}.json")])
        os.environ.pop("HM_USE_PRED", None)
        docs[side] = json.loads((tmp_path / f"{side}.json").read_text())
        kept[side] = {k: v for k, v in _tree(tmp_path / f"aside_{side}")
                      .items() if not k.endswith(".cfg")}
    assert docs["port"].pop("labels_device") == "cpu"
    assert _same_doc(docs["port"], docs["jax"], ("clip", "generator"))
    assert "bd_rate_pct_vs_hm_anchor" in docs["port"]
    assert kept["port"] == kept["jax"] and kept["port"]["env32"] == b"1"


# ---------------------------------------------------------------------------
# Per-syntax-element bits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rd_frame():
    """A CPU port encode, pink 64x128 x 1, search="rd", QP 32."""
    y, u, v = clips.make_clip("pink", 1, 64, 128)
    return (y, u, v), tenc.FrameEncoder(64, 128, 32, search="rd",
                                        device="cpu").encode(y, u, v)


def test_frame_bit_stats_matches_jax_tool(rd_frame):
    _, out = rd_frame
    got = evaluate.frame_bit_stats(
        headers.StreamConfig(width=128, height=64, qp=32), out, 0)
    want = jbits.frame_bit_stats(
        jheaders.StreamConfig(width=128, height=64, qp=32), out, 0)
    assert got == want
    assert got["slice_header"] > 0 and len(got) > 10


def test_bit_stats_report_matches_jax_tool(rd_frame, monkeypatch, capsys):
    """The JAX tool's report on the port's encode (its FrameEncoder stood
    in by one that returns it) equals the port tool's."""
    import hevctpu.pipeline.encoder
    _, out = rd_frame

    class PortEncode:
        def __init__(self, *a, **k):
            pass

        def encode(self, *a):
            return out

    monkeypatch.setattr(hevctpu.pipeline.encoder, "FrameEncoder", PortEncode)
    argv = ["--frames", "1", "--w", "128", "--h", "64"]
    _run_jax_main(monkeypatch, jbits, argv)
    ref = capsys.readouterr().out
    tbits.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == ref
    assert "TOTAL (counted)" in ref


# ---------------------------------------------------------------------------
# The port's encoder on the protocol
# ---------------------------------------------------------------------------


def test_cnn_point_matches_jax_encoder():
    """ours_points in mode cnn (encode_fused on the CPU) at
    tests/test_torch_encoder.py's configuration: the kbps and PSNRs the
    JAX FrameEncoder gives with the same ConvNet2's labels."""
    h, w, qp = 64, 128, 32
    y, u, v = clips.clip_sine(2, h, w, seed=0)
    params = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    pts = evaluate.ours_points(y, u, v, [qp], "cnn", params, device="cpu",
                               log=lambda *a: None)
    labels = np.asarray(jconv.predict_batch_labels(
        params, *(jnp.asarray(p) for p in (y, u, v)), h, w)).astype(np.int32)
    out = jenc.FrameEncoder(h, w, qp).encode(y, u, v, labels)
    stream = jdecoder.encode_stream(
        jheaders.StreamConfig(width=w, height=h, qp=qp), [out])
    want = dict(qp=qp, bitrate_kbps=round(len(stream) * 8 * 30.0 / 2 / 1e3,
                                          2),
                psnr_y=round(jmetrics.psnr(y, out["recon_y"]), 4),
                psnr_u=round(jmetrics.psnr(u, out["recon_u"]), 4),
                psnr_v=round(jmetrics.psnr(v, out["recon_v"]), 4))
    assert pts[0].pop("time_s") > 0
    assert pts == [want]


def test_encoder_memo_keys_geometry_qp_options_device():
    memo = {}
    a = evaluate.get_encoder(memo, 64, 128, 32, {"search": "rd"}, "cpu")
    assert evaluate.get_encoder(memo, 64, 128, 32, {"search": "rd"},
                                "cpu") is a
    b = evaluate.get_encoder(memo, 64, 128, 32,
                             {"search": "rd", "two_pass": True}, "cpu")
    c = evaluate.get_encoder(memo, 64, 128, 27, {"search": "rd"}, "cpu")
    assert len({id(a), id(b), id(c)}) == 3 and b.two_pass and c.qp == 27


def test_tools_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (tcorpus.main, trd.main, tgap.main, tbits.main,
                 tpruned.main, tprofile.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])


# ---------------------------------------------------------------------------
# The stage profile
# ---------------------------------------------------------------------------

# The stage keys of tools/profile_stages.py's report.
JAX_STAGES = ["cnn", "stage1_luma", "stage1_chroma", "tu_tree", "decide_all",
              "stage2_wavefront", "device_full", "filters_derived",
              "entropy_host", "fused_total"]


@pytest.mark.parametrize("hw", [(64, 128), (240, 416), (1088, 1920)])
def test_operation_counts_match_jax_tool(hw):
    assert profile.transform_flops(*hw) == jprofile.transform_flops(*hw)
    assert profile.satd_flops(*hw) == jprofile.satd_flops(*hw)


def test_profile_stages_small_on_cpu():
    params = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    doc = profile.profile_stages(params, frames=1, device="cpu", reps=1,
                                 full_reps=1, h=64, w=128)
    assert list(doc["stage_ms"]) == JAX_STAGES
    assert all(t >= 0 for t in doc["stage_ms"].values())
    assert doc["device"] == "cpu" and doc["backend"] == "cpu"
    sa = doc["roofline"]["satd_stage"]
    assert sa["flops"] == 2 * jprofile.satd_flops(64, 128)
    # no device metric from a CPU run
    assert sa["achieved_tflops"] is None and sa["mfu_pct_bf16"] is None
    md = profile.profile_markdown(doc)
    assert "not measured" in md and "H100" in md
    assert "TPU" not in md and "v5e" not in md


# ---------------------------------------------------------------------------
# The corpus sweep, both encoders (slow: four JAX encoder compiles)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_ours_points_match_jax_tool_four_qps():
    y, u, v = clips.make_clip("pink", 2, 64, 128)
    params = checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz"))
    qps = list(evaluate.QPS)
    want = jcorpus.ours_points(y, u, v, qps, "cnn", params, jmetrics)
    got = evaluate.ours_points(y, u, v, qps, "cnn", params, device="cpu",
                               log=lambda *a: None)
    for p in want + got:
        p.pop("time_s")
    assert got == want
