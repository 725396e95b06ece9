"""The calibration path of the port (pipeline/calibrate.py and the three
tools/*_torch.py) against the JAX package's calibration tools
(tools/fit_rate_constants.py and tools/fit_ctx_probs.py, loaded as
modules from their paths, and the corpus loop of
tools/train_cnn_domain.py) at 64x128, 2 frames, on the CPU.

The rate tool's encode (search="rd", SBH and TS off) at QPs 22 and 37:
at 22 the JAX package encodes too (one compile) and the port's encode
equals it; at either QP the TU lists, exact CABAC bits, bin features and
context counts the port computes equal what the JAX tools' functions
compute on the same encode. The domain dataset (full-RD labels, then
make_dataset; QP 32, whose rd_ground_truth compile the CLI train test
shares through the JAX package's compile cache) equals the JAX tool's
loop. All of it is exact. The ridge fit is held on JAX-computed
features against the port's and on a problem whose solution is known;
the whole rate tools (240x416) run in the slow tier."""

import collections
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hevctpu.codec import headers as jheaders
from hevctpu.ops import rate as jrate
from hevctpu.pipeline import clips as jclips
from hevctpu.pipeline import encoder as jenc
from hevctpu.pipeline import labels as jlabels
from hevctpu_torch.codec import headers
from hevctpu_torch.ops import ctx_probs, rate
from hevctpu_torch.pipeline import calibrate
from hevctpu_torch.pipeline import encoder as tenc


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FRAMES = 64, 128, 2
QPS = (22, 37)
JAX_QP = 22          # the QP whose rate-tool encode JAX runs too
DOMAIN_QP = 32       # rd_ground_truth's compile is the CLI train test's
RATE_OPTS = dict(search="rd", sbh=False, ts=False)
KEYS = ["levels_y", "cbf_y", "cbf4_y", "tusz8", "coded8", "depth8",
        "mode8", "mode4", "nxn8", "levels_u", "levels_v", "cbf_u", "cbf_v",
        "csel8", "sao_type", "sao_eo", "sao_bp", "sao_off", "sao_merge"]


def _tool(name):
    """A JAX calibration tool, imported from its path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfit_rate = _tool("fit_rate_constants")
jfit_ctx = _tool("fit_ctx_probs")


def _spy_encodes(monkeypatch):
    """Record every dict the port's FrameEncoder.encode returns."""
    outs = []
    encode = tenc.FrameEncoder.encode

    def spy(self, *a, **k):
        outs.append(encode(self, *a, **k))
        return outs[-1]

    monkeypatch.setattr(tenc.FrameEncoder, "encode", spy)
    return outs


@pytest.fixture(scope="module")
def rate_pairs():
    """Per QP: the port's encode inside calibrate.rate_samples (the rate
    tool's clips.make_clip("pink") encode) and its samples; the JAX
    package's encode of the same at JAX_QP (one compile), which the JAX
    tools' functions then read (at the other QP they read the port's);
    and what the JAX tools' functions compute on it."""
    pairs = {}
    with pytest.MonkeyPatch.context() as mp:
        outs = _spy_encodes(mp)
        for qp in QPS:
            feats, trues = calibrate.rate_samples(qp, ["pink"], FRAMES, H,
                                                  W, device="cpu")
            p = dict(port=outs[-1], feats=feats, trues=trues,
                     ref=outs[-1])
            if qp == JAX_QP:
                p["ref"] = jenc.FrameEncoder(H, W, qp, **RATE_OPTS).encode(
                    *jclips.make_clip("pink", FRAMES, H, W))
            p["jtus"] = jfit_rate.frame_tus(p["ref"])
            p["jtrues"] = np.asarray([jfit_rate.true_residual_bits(b, s, qp)
                                      for b, s in p["jtus"]])
            p["jfeats"] = np.stack([jrate.tu_bit_features(b, s)
                                    for b, s in p["jtus"]])
            pairs[qp] = p
    return pairs


def test_rate_encode_equals_reference(rate_pairs):
    ref, port = rate_pairs[JAX_QP]["ref"], rate_pairs[JAX_QP]["port"]
    assert ref is not port
    for k in KEYS:
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("qp", QPS)
def test_frame_tus_equal(rate_pairs, qp):
    """The TU lists are the JAX tool's, in order."""
    want = rate_pairs[qp]["jtus"]
    got = calibrate.frame_tus(rate_pairs[qp]["port"])
    assert len(got) == len(want) > 10
    assert len({s for _, s in got}) > 1
    for (gb, gs), (wb, ws) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gb, np.asarray(wb))


@pytest.mark.parametrize("qp", QPS)
def test_bits_and_features_equal(rate_pairs, qp):
    """rate_samples' exact CABAC bits and bin features equal the JAX
    tool's true_residual_bits and the JAX tu_bit_features, TU by TU."""
    p = rate_pairs[qp]
    np.testing.assert_array_equal(p["trues"], p["jtrues"])
    np.testing.assert_array_equal(p["feats"], p["jfeats"])
    blk, s = p["jtus"][0]
    assert calibrate.true_residual_bits(blk, s, qp) == p["jtrues"][0]


@pytest.mark.parametrize("qp", QPS)
def test_record_counts_equal(rate_pairs, qp):
    """The golden coder's per-context bin counts equal the JAX tool's."""
    p = rate_pairs[qp]
    cfg = dict(width=W, height=H, qp=qp, sign_data_hiding=False,
               transform_skip=False)
    want = collections.defaultdict(lambda: [0, 0])
    got = collections.defaultdict(lambda: [0, 0])
    jfit_ctx.record_counts(p["ref"], jheaders.StreamConfig(**cfg), want)
    calibrate.record_counts(p["port"], headers.StreamConfig(**cfg), got)
    assert dict(got) == dict(want)
    assert sum(map(sum, got.values())) > 1000


def test_ctx_count_table(monkeypatch):
    """ctx_count_table's encode (the ctx tool's full-RD search) and its
    table equal the JAX tool's record_counts and tabulation on the same
    encode; the writer reproduces the committed ctx_probs module."""
    outs = _spy_encodes(monkeypatch)
    table = calibrate.ctx_count_table([QPS[1]], ["pink"], FRAMES, h=H, w=W,
                                      device="cpu", log=None)
    assert len(outs) == 1
    counts = collections.defaultdict(lambda: [0, 0])
    jfit_ctx.record_counts(outs[0], jheaders.StreamConfig(
        width=W, height=H, qp=QPS[1]), counts)
    per_name = {}
    for (name, idx), (c0, c1) in sorted(counts.items()):
        per_name.setdefault(name, {})[idx] = (c0, c1)
    assert table == {QPS[1]: per_name}

    src = calibrate.ctx_probs_source(table, "tools/fit_ctx_probs_torch.py")
    ns = {}
    exec(compile(src, "ctx_probs", "exec"), ns)
    assert ns["COUNTS"] == table
    with open(os.path.join(ROOT, "hevctpu_torch", "ops",
                           "ctx_probs.py")) as f:
        committed = f.read()
    assert calibrate.ctx_probs_source(
        ctx_probs.COUNTS, "tools/fit_ctx_probs.py") == committed


def _jax_fit(feats, trues, max_tus=1200):
    """The JAX tool's per-QP fit (the body of its main's QP loop), on
    given features."""
    F = np.asarray(feats)
    t = np.asarray(trues) * jrate.BITS_ONE
    i_cbf1 = jrate._W_FIELDS.index("cbf1")
    i_cbf0 = jrate._W_FIELDS.index("cbf0")
    free = [i for i in range(len(jrate._W_FIELDS))
            if i not in (i_cbf1, i_cbf0)]
    rhs = t - F[:, -1] * jrate.BITS_ONE
    A = F[:, free]
    if len(F) > max_tus:
        idx = np.random.default_rng(0).choice(len(F), max_tus,
                                              replace=False)
        A, rhs = A[idx], rhs[idx]
    w_old = np.array([jrate._W_DEFAULT[jrate._W_FIELDS[i]] for i in free])
    perm = np.random.default_rng(1).permutation(len(A))
    n_tr = len(A) * 3 // 4
    tr, va = perm[:n_tr], perm[n_tr:]

    def ridge(alpha):
        aug_a = np.vstack([A[tr], np.sqrt(alpha) * np.eye(len(free))])
        aug_b = np.concatenate([rhs[tr], np.sqrt(alpha) * w_old])
        w, *_ = np.linalg.lstsq(aug_a, aug_b, rcond=None)
        return np.clip(w, 0.02 * jrate.BITS_ONE, 2.0 * jrate.BITS_ONE)

    best = None
    for alpha in (1e1, 1e2, 1e3, 1e4, 1e5):
        w_try = ridge(alpha)
        err = np.abs(A[va] @ w_try - rhs[va]).mean()
        if best is None or err < best[0]:
            best = (err, alpha, w_try)
    w_full = np.array([jrate._W_DEFAULT[k] for k in jrate._W_FIELDS],
                      np.float64)
    w_full[free] = best[2]
    return tuple(int(round(x)) for x in w_full)


@pytest.mark.parametrize("max_tus", [1200, 12])
def test_fit_on_reference_features(rate_pairs, max_tus):
    """The port's fit on the JAX-computed features and bits equals the
    fit on the port's own and the JAX tool's fit, with and without the
    TU cap's subsample."""
    tuples = []
    for qp in QPS:
        p = rate_pairs[qp]
        tus, jf, jt = p["jtus"], p["jfeats"], p["jtrues"]
        assert len(tus) > max_tus or max_tus == 1200
        got, line = calibrate.fit_rate_weights(jf, jt, max_tus)
        assert calibrate.fit_rate_weights(p["feats"], p["trues"],
                                          max_tus)[0] == got
        assert got == _jax_fit(jf, jt, max_tus)
        assert line.startswith(f"{min(len(tus), max_tus)} TUs; scale ")
        tuples.append(got)
    assert tuples[0] != tuples[1]


def test_fit_recovers_known_weights():
    """Bits that are exactly counts . w_true + bypass: the ridge fit
    returns w_true (the data outweigh the prior at every alpha tried),
    with cbf1/cbf0 pinned at the defaults."""
    rng = np.random.default_rng(3)
    nf = len(rate._W_FIELDS)
    feats = np.zeros((3000, nf + 1))
    feats[:, :nf] = rng.integers(0, 60, (3000, nf))
    feats[:, -1] = rng.integers(0, 40, 3000)
    w_true = rng.integers(20, 480, nf)
    for k in calibrate.PINNED:
        w_true[rate._W_FIELDS.index(k)] = rate._W_DEFAULT[k]
    free = [i for i, k in enumerate(rate._W_FIELDS)
            if k not in calibrate.PINNED]
    trues = (feats[:, free] @ w_true[free]) / rate.BITS_ONE + feats[:, -1]
    got, _ = calibrate.fit_rate_weights(feats, trues, max_tus=2000)
    assert got == tuple(int(x) for x in w_true)


def test_rate_weights_source_round_trips():
    fitted = {22: tuple(range(10)), 37: tuple(range(10, 20))}
    src = calibrate.rate_weights_source(fitted, ["qp 22: a", "qp 37: b"],
                                        "tools/fit_rate_constants_torch.py")
    ns = {}
    exec(compile(src, "rate_weights", "exec"), ns)
    assert ns["FITTED"] == fitted and "qp 37: b" in ns["__doc__"]


@pytest.fixture(scope="module")
def domain():
    """The JAX tool's corpus loop (labels.rd_ground_truth, then
    labels.make_dataset per clip, concatenated) and the port's
    domain_dataset on the same corpus: one family (scene: its labels take
    three depths at this size), one seed, one QP."""
    fams = ["scene"]
    xs32, xs64, ds = [], [], []
    for fam in fams:
        y, u, v = jclips.make_clip(fam, FRAMES, H, W, seed=100)
        lab = jlabels.rd_ground_truth(y, u, v, DOMAIN_QP)
        x32, x64, d = jlabels.make_dataset(
            y.astype(np.int32), u.astype(np.int32), v.astype(np.int32),
            np.asarray(lab))
        xs32.append(x32)
        xs64.append(x64)
        ds.append(d)
    ref = [np.concatenate(a) for a in (xs32, xs64, ds)]
    port = calibrate.domain_dataset(fams, 1, FRAMES, [DOMAIN_QP], h=H, w=W,
                                    device="cpu", log=None)
    return ref, port


@pytest.mark.parametrize("i,name", [(0, "x32"), (1, "x64"), (2, "digits")])
def test_domain_dataset_equals_reference(domain, i, name):
    ref, port = domain
    assert port[i].device.type == "cpu"
    got = port[i].numpy()
    assert got.shape == ref[i].shape == (
        {0: (16, 32, 32, 3), 1: (16, 64, 64, 3), 2: (16, 4)}[i])
    np.testing.assert_array_equal(got, ref[i])
    if name == "digits":
        assert len(np.unique(got)) > 2


def test_entry_points_default_to_cuda():
    """Without CUDA the functions raise before encoding, as the tools do
    when --device is left at cuda."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.rate_samples(22, ["pink"], 1, H, W)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.domain_dataset(["pink"], 1, 1, [22], h=H, w=W, log=None)
    for tool in ("fit_rate_constants_torch", "fit_ctx_probs_torch",
                 "train_cnn_domain_torch"):
        r = subprocess.run([sys.executable, os.path.join("tools",
                                                         f"{tool}.py"),
                            "--out", os.devnull], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr


def _fitted(path):
    ns = {}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), ns)
    return ns["FITTED"]


@pytest.mark.slow
def test_rate_tools_fit_the_same_weights(tmp_path):
    """Both rate tools at their 240x416, one frame of one clip, every QP:
    the same FITTED tuples."""
    outs = []
    for tool, extra in (("fit_rate_constants.py", []),
                        ("fit_rate_constants_torch.py", ["--device", "cpu"])):
        out = str(tmp_path / f"{tool}.out.py")
        r = subprocess.run([sys.executable, os.path.join("tools", tool),
                            "--frames", "1", "--clips", "pink", "--out", out]
                           + extra, cwd=ROOT, capture_output=True, text=True,
                           timeout=3000,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(_fitted(out))
    assert outs[0] == outs[1] and sorted(outs[1]) == [22, 27, 32, 37]
