"""The context rate model (rate_model="ctx") in the port against the JAX
package.

The host tables (calibration counts, per-context costs, last-position
costs, scan and context maps) are the same numpy code and must be equal.
estimate_tu_bits_ctx sums its float32 costs exactly in float64 and rounds
once, the JAX package in float32, so its bits agree to rtol 1e-5 (the
largest relative gap is printed; run with -s). The Golomb-Rice length is
integer arithmetic on both sides and exact. The whole encode,
FrameEncoder(rate_model="ctx", search="rd") at 64x128 x 2 frames, QP 32,
gives every integer output and the stream bit-identical (one JAX compile).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hevctpu.codec import decoder as jdecoder
from hevctpu.codec import headers as jheaders
from hevctpu.ops import ctx_probs as jctx_probs
from hevctpu.ops import quant as jquant
from hevctpu.ops import rate as jrate
from hevctpu.ops import rate_ctx as jrate_ctx
from hevctpu.ops import rd as jrd
from hevctpu.ops import transforms as jtransforms
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch import cli, rom
from hevctpu_torch.codec import decoder, headers
from hevctpu_torch.ops import ctx_probs, quant, rate_ctx, rd, transforms
from hevctpu_torch.pipeline import encoder as tenc
from hevctpu_torch.pipeline import yuv
from test_torch_options import KEYS_RD, busy_clip, port_dtype


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

H, W, QP, FRAMES = 64, 128, 32, 2
TABLE_FIELDS = ("perm", "posy", "posx", "sigctx", "right_nb", "below_nb",
                "last_cost", "sig_cost", "csbf_cost", "g1_cost", "g2_cost",
                "cbf_cost")


def test_ctx_probs_counts_equal():
    assert ctx_probs.COUNTS == jctx_probs.COUNTS


@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_host_tables_equal(log2, qp, calibrated):
    for is_luma in (True, False):
        for scan in (rom.SCAN_DIAG, rom.SCAN_HOR, rom.SCAN_VER):
            got = rate_ctx._tables(log2, scan, is_luma, qp, calibrated)
            want = jrate_ctx._tables(log2, scan, is_luma, qp, calibrated)
            for f in TABLE_FIELDS:
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    for name in sorted(rom.CTX_INIT):
        np.testing.assert_array_equal(
            rate_ctx.ctx_cost(name, qp, calibrated),
            jrate_ctx.ctx_cost(name, qp, calibrated), err_msg=name)


@pytest.mark.parametrize("qp", [22, 32, 37])
def test_scalar_helpers_equal(qp):
    assert rate_ctx.mode_signal_bits(qp) == jrate_ctx.mode_signal_bits(qp)
    assert rate_ctx.chroma_sel_bits(qp) == jrate_ctx.chroma_sel_bits(qp)
    assert rate_ctx.part_mode_bits(qp) == jrate_ctx.part_mode_bits(qp)
    for ctx in range(3):
        assert (rate_ctx.split_cu_bits(qp, ctx)
                == jrate_ctx.split_cu_bits(qp, ctx))
    for log2 in (3, 4, 5):
        assert (rate_ctx.split_tu_bits(qp, log2)
                == jrate_ctx.split_tu_bits(qp, log2))


def _levels(log2, seed, count=48):
    """Random TUs: sparse small levels, dense mid levels, a few huge ones
    (escapes of the Golomb-Rice ladder), and all-zero TUs."""
    rng = np.random.default_rng(seed)
    n = 1 << log2
    lv = (rng.laplace(0, 3, (count, n, n))
          * (rng.random((count, n, n)) < 0.3)).astype(np.int32)
    lv[count // 2:] = (rng.integers(-40, 41, (count - count // 2, n, n))
                       * (rng.random((count - count // 2, n, n)) < 0.6))
    lv[:3] = 0
    lv[3, 0, 0] = 700
    lv[4] = rng.integers(-300, 301, (n, n))
    return lv


def _compare(lv, log2, qp, **kw):
    want = np.asarray(jrate_ctx.estimate_tu_bits_ctx(jnp.asarray(lv), log2,
                                                     qp, **kw))
    got = rate_ctx.estimate_tu_bits_ctx(torch.as_tensor(lv), log2, qp,
                                        **kw).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)
    gap = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want),
                                                             1e-30)
    return float(gap.max())


@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_estimate_tu_bits_ctx(log2, is_luma, qp):
    lv = _levels(log2, 10 * log2 + qp + is_luma)
    gap = 0.0
    for scan in (rom.SCAN_DIAG, rom.SCAN_HOR, rom.SCAN_VER):
        for calibrated in (True, False):
            gap = max(gap, _compare(lv, log2, qp, is_luma=is_luma,
                                    scan_idx=scan, calibrated=calibrated))
    print(f"log2 {log2} luma {is_luma} QP {qp}: largest relative gap "
          f"{gap:.3e}")


@pytest.mark.parametrize("cbf_ctx", [0, 1, 2])
@pytest.mark.parametrize("include_cbf", [True, False])
@pytest.mark.parametrize("sbh", [True, False])
def test_estimate_tu_bits_ctx_flags(sbh, include_cbf, cbf_ctx):
    gap = 0.0
    for log2, is_luma in ((2, True), (3, False), (4, True)):
        if cbf_ctx == 2 and is_luma:
            continue                  # cbf_luma has two contexts
        lv = _levels(log2, 7 + log2)
        gap = max(gap, _compare(lv, log2, 32, is_luma=is_luma, sbh=sbh,
                                include_cbf=include_cbf, cbf_ctx=cbf_ctx))
    print(f"sbh {sbh} include_cbf {include_cbf} cbf_ctx {cbf_ctx}: "
          f"largest relative gap {gap:.3e}")


def test_zero_tu_costs_the_cbf_bin():
    z = torch.zeros((2, 8, 8), dtype=torch.int32)
    got = rate_ctx.estimate_tu_bits_ctx(z, 3, 32, cbf_ctx=1)
    cost = rate_ctx.ctx_cost("cbf_luma", 32)[1, 0]
    np.testing.assert_array_equal(got.numpy(),
                                  np.float32(cost) * np.float32(256))
    assert (rate_ctx.estimate_tu_bits_ctx(z, 3, 32, include_cbf=False)
            == 0).all()


@pytest.mark.parametrize("c", [0, 1, 2, 3, 4])
def test_rem_len_exact(c):
    """Every w = max(val - 2^(c+1), 1) in [1, 2^16]: the integer
    bit_length form equals the JAX package's float32 floor(log2)."""
    val = np.arange(0, (1 << 16) + (2 << c) + 1, dtype=np.int32)
    cc = np.full_like(val, c)
    want = np.asarray(jrate_ctx._rem_len(jnp.asarray(val), jnp.asarray(cc)))
    got = rate_ctx._rem_len(torch.as_tensor(val), torch.as_tensor(cc))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_mode_rd_costs_ctx(log2):
    rng = np.random.default_rng(60 + log2)
    n = 1 << log2
    orig = rng.integers(0, 256, (7, n, n)).astype(np.int32)
    preds = np.clip(orig[:, None] + rng.integers(-30, 31, (7, 5, n, n)),
                    0, 255).astype(np.int32)
    lam = jrate.lambda_rd(QP)
    dst = log2 == 2
    for is_luma, cbf_ctx in ((True, None), (True, 0), (False, 0)):
        kw = dict(lam=lam, dst=dst, is_luma=is_luma, rate_model="ctx",
                  cbf_ctx=cbf_ctx)
        want = jax.jit(lambda p, o: jrd.mode_rd_costs(p, o, log2, QP, **kw))(
            jnp.asarray(preds), jnp.asarray(orig))
        got = rd.mode_rd_costs(torch.as_tensor(preds), torch.as_tensor(orig),
                               log2, QP, **kw)
        assert got[1].dtype == torch.float32
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5)
    # the levels the bits are priced on are the same integers
    res = orig[:, None] - preds
    coef = jtransforms.forward_transform(jnp.asarray(res), log2, dst=dst)
    want_lvl = np.asarray(jquant.quantize(coef, log2, QP))
    got_lvl = quant.quantize(transforms.forward_transform(
        torch.as_tensor(res), log2, dst=dst), log2, QP)
    np.testing.assert_array_equal(got_lvl.numpy(), want_lvl)


@pytest.fixture(scope="module")
def pair_ctx():
    clip = busy_clip()
    kw = dict(rate_model="ctx", search="rd")
    ref = jenc.FrameEncoder(H, W, QP, **kw).encode(*clip)
    port = tenc.FrameEncoder(H, W, QP, device="cpu", **kw).encode(*clip)
    return ref, port


def test_ctx_output_keys_and_dtypes(pair_ctx):
    ref, port = pair_ctx
    assert set(port) == set(ref)
    for k in ref:
        assert np.asarray(port[k]).dtype == port_dtype(ref, k), k
        assert np.shape(port[k]) == np.shape(ref[k]), k


@pytest.mark.parametrize("key", KEYS_RD)
def test_ctx_rd_encode_equal(pair_ctx, key):
    np.testing.assert_array_equal(pair_ctx[1][key], pair_ctx[0][key])


def test_ctx_stream_equals_reference_and_decodes(pair_ctx):
    ref, port = pair_ctx
    got = decoder.encode_stream(headers.StreamConfig(
        width=W, height=H, qp=QP), [port])
    want = jdecoder.encode_stream(jheaders.StreamConfig(
        width=W, height=H, qp=QP), [ref])
    assert got == want
    np.testing.assert_allclose(port["sse"], ref["sse"], rtol=1e-6)
    dec = decoder.Decoder()
    frames = dec.decode(got)
    assert len(frames) == FRAMES and dec.hashes_ok and all(dec.hashes_ok)
    for i, (y, u, v) in enumerate(frames):
        np.testing.assert_array_equal(y, port["recon_y"][i])
        np.testing.assert_array_equal(u, port["recon_u"][i])
        np.testing.assert_array_equal(v, port["recon_v"][i])


def test_ctx_moves_decisions(pair_ctx):
    """The context model is not the global one under another name: on
    this clip the RD search decides differently."""
    port = pair_ctx[1]
    glob = tenc.FrameEncoder(H, W, QP, device="cpu", search="rd").encode(
        *busy_clip())
    assert any(not np.array_equal(port[k], glob[k])
               for k in ("depth8", "mode8", "mode4", "csel8", "tusz8"))


def test_cli_rate_model_ctx(pair_ctx, tmp_path):
    """`RateModel : ctx` in a -c file runs through the command line: the
    decoded YUV equals --recon, which equals frame 0 of the encode above
    (All-Intra: a frame's coding does not depend on its batch)."""
    y, u, v = busy_clip()
    src, bs, rec, dec = (str(tmp_path / n) for n in
                         ("in.yuv", "out.bin", "rec.yuv", "dec.yuv"))
    yuv.write_yuv420(src, y[:1], u[:1], v[:1])
    cfg = tmp_path / "ctx.cfg"
    cfg.write_text("RateModel : ctx\n")
    assert cli.main(["encode", "-c", str(cfg), "-i", src, "--width", str(W),
                     "--height", str(H), "-f", "1", "-q", str(QP), "-b", bs,
                     "--recon", rec, "--search", "rd", "--device",
                     "cpu"]) == 0
    assert cli.main(["decode", "-b", bs, "-o", dec]) == 0
    assert open(dec, "rb").read() == open(rec, "rb").read()
    port = pair_ctx[1]
    for k, plane in zip(("recon_y", "recon_u", "recon_v"),
                        yuv.read_yuv420(rec, W, H, 1)):
        np.testing.assert_array_equal(plane[0], port[k][0])


@pytest.mark.gpu
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_estimate_on_card_equals_cpu(log2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lv = torch.as_tensor(_levels(log2, log2, count=512))
    for is_luma in (True, False):
        for scan in (rom.SCAN_DIAG, rom.SCAN_HOR, rom.SCAN_VER):
            kw = dict(is_luma=is_luma, scan_idx=scan)
            cpu = rate_ctx.estimate_tu_bits_ctx(lv, log2, QP, **kw)
            card = rate_ctx.estimate_tu_bits_ctx(lv.cuda(), log2, QP, **kw)
            assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
def test_ctx_encode_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hevctpu_torch.ops import satd_fused
    outs = []
    for dev in ("cuda", "cpu"):
        satd_fused.LAUNCHES = 0
        outs.append(tenc.FrameEncoder(H, W, QP, device=dev, rate_model="ctx",
                                      search="rd").encode(*busy_clip()))
        assert satd_fused.LAUNCHES == (4 if dev == "cuda" else 0)
    cfg = headers.StreamConfig(width=W, height=H, qp=QP)
    assert (decoder.encode_stream(cfg, [outs[0]])
            == decoder.encode_stream(cfg, [outs[1]]))
