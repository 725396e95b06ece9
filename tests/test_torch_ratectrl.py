"""Rate control, adaptive-QP preanalysis, the torch checkpoint loader and
the numpy helpers of the port against the JAX package (no encoder compile).

The R-λ controllers, fed the same bit counts over 8 pictures, give the
same QP traces, λs, model states and LCU QP maps; the port's SATD
complexity is an exact integer sum and the JAX package's a float32 one,
which agree to 1e-6 relative. Preanalysis is float32 in both and equal
on the fixtures; both refuse a plane whose sides are not multiples of the
64-pel block."""

import numpy as np
import pytest
import torch

from hevctpu import utils as jutils
from hevctpu.models import convnet2 as jconv
from hevctpu.pipeline import metrics as jmetrics
from hevctpu.pipeline import preanalysis as jpre
from hevctpu.pipeline import ratectrl as jrc
from hevctpu_torch import utils
from hevctpu_torch.models import convnet2
from hevctpu_torch.pipeline import clips, metrics, preanalysis, ratectrl


@pytest.mark.parametrize("hw,kbps,n", [((240, 416), 1000.0, 8),
                                       ((128, 256), 300.0, 8),
                                       ((64, 64), 50.0, 8),
                                       ((1080, 1920), 8000.0, 2)])
def test_rate_controller_trace_equals_reference(hw, kbps, n):
    h, w = hw
    y = clips.clip_sine(n, h, w, seed=2)[0]
    ref = jrc.RateController(kbps * 1000, 30.0, w, h, n)
    port = ratectrl.RateController(kbps * 1000, 30.0, w, h, n, device="cpu")
    rng = np.random.default_rng(h)
    maps, gap = [], 0.0
    for i in range(n):
        c_ref, c_port = ref.complexity(y[i]), port.complexity(y[i])
        gap = max(gap, abs(c_port - c_ref) / c_port)
        assert gap <= 1e-6
        assert port.start_picture(c_ref) == ref.start_picture(c_ref)
        m_ref, m_port = ref.lcu_qp_map(y[i]), port.lcu_qp_map(y[i])
        assert m_port.dtype == m_ref.dtype
        np.testing.assert_array_equal(m_port, m_ref)
        maps.append(m_port)
        bits = int(rng.uniform(0.5, 1.5) * kbps * 1000 / 30)
        ref.update(bits)
        port.update(bits)
        assert (port.alpha, port.beta, port.buffer_debt) == (
            ref.alpha, ref.beta, ref.buffer_debt)
    assert [p.qp for p in port.pics] == [p.qp for p in ref.pics]
    assert port.achieved_bps() == ref.achieved_bps()
    if 64 < h < 1080:
        assert len(np.unique(np.stack(maps))) > 1
    print(f"{h}x{w}: largest relative complexity gap {gap:.3g}")


def test_complexity_from_own_trace_equals_reference():
    """The port fed its own complexity (not the reference's) reaches the
    same QPs: the float32 gap never moves a rounding."""
    y = clips.clip_sine(4, 240, 416, seed=5)[0]
    ref = jrc.RateController(800e3, 30.0, 416, 240, 4)
    port = ratectrl.RateController(800e3, 30.0, 416, 240, 4, device="cpu")
    for i in range(4):
        assert (port.start_picture(port.complexity(y[i]))
                == ref.start_picture(ref.complexity(y[i])))
        ref.update(25000)
        port.update(25000)


def test_satd8_ctu_equals_reference():
    import jax.numpy as jnp
    y = np.random.default_rng(0).integers(0, 256, (200, 328))
    want = np.asarray(jrc._satd8_ctu(jnp.asarray(y, jnp.int32), 4, 6))
    got = ratectrl._satd8_ctu(torch.as_tensor(y), 4, 6)
    np.testing.assert_array_equal(got, want)


def test_lcu_map_follows_complexity():
    """Flat CTUs get the high-QP end, busy CTUs the low end."""
    h, w = 128, 256
    y = np.full((h, w), 128, np.int32)
    y[:, w // 2:] = np.random.default_rng(5).integers(0, 256, (h, w // 2))
    rc = ratectrl.RateController(800e3, 30.0, w, h, device="cpu")
    qp, _ = rc.start_picture(rc.complexity(y))
    qmap = rc.lcu_qp_map(y)
    assert qmap.shape == (2, 4)
    assert (qmap >= qp - 2).all() and (qmap <= qp + 2).all()
    assert qmap[:, 2:].mean() < qmap[:, :2].mean()


def _activity_clip(h, w, seed):
    """Flat, textured and noisy regions, so the offsets are not all 0."""
    rng = np.random.default_rng(seed)
    y = clips.clip_sine(1, h, w, seed=seed)[0][0].astype(np.int32)
    y[: h // 2, : w // 3] = 100 + rng.integers(0, 3, (h // 2, w // 3))
    y[h // 2:, 2 * w // 3:] = rng.integers(0, 256, (h - h // 2,
                                                    w - 2 * w // 3))
    return y


@pytest.mark.parametrize("block", [64, 32, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_qp_map_equals_reference(block, seed):
    import jax.numpy as jnp
    y = _activity_clip(256, 448, seed)
    want = np.asarray(jpre.adaptive_qp_map(jnp.asarray(y), block=block))
    got = preanalysis.adaptive_qp_map(torch.as_tensor(y), block=block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_qp_offset_equals_reference(seed):
    y = _activity_clip(256, 448, seed)
    assert (preanalysis.frame_qp_offset(y, device="cpu")
            == jpre.frame_qp_offset(y))


def test_adaptive_qp_needs_multiples_of_the_block():
    y = np.zeros((240, 416), np.uint8)
    with pytest.raises(ValueError, match="multiples of the 64-pel block"):
        preanalysis.frame_qp_offset(y, device="cpu")
    with pytest.raises(TypeError):           # the JAX package's reshape
        jpre.frame_qp_offset(y)


def test_load_torch_params_equals_reference(tmp_path):
    """A synthetic checkpoint with the reference's state-dict keys: both
    loaders fold the batch norms alike, and the folded params drive the
    port's ConvNet2."""
    rng = np.random.default_rng(0)
    sd = {}
    for name, (o, i, k) in {"conv1": (16, 3, 5), "conv64": (16, 3, 5),
                            "conv2": (64, 32, 3), "conv3": (128, 64, 3)}.items():
        sd[f"{name}.0.weight"] = rng.normal(0, 0.1, (o, i, k, k))
        sd[f"{name}.0.bias"] = rng.normal(0, 0.1, o)
        sd[f"{name}.1.weight"] = rng.uniform(0.5, 1.5, o)
        sd[f"{name}.1.bias"] = rng.normal(0, 0.1, o)
        sd[f"{name}.1.running_mean"] = rng.normal(0, 0.1, o)
        sd[f"{name}.1.running_var"] = rng.uniform(0.5, 2.0, o)
    for key, (o, i) in {"fc1.0": (256, 2048), "fc2.0": (64, 256),
                        "fc3": (16, 64)}.items():
        sd[f"{key}.weight"] = rng.normal(0, 0.05, (o, i))
        sd[f"{key}.bias"] = rng.normal(0, 0.05, o)
    path = str(tmp_path / "model.pt")
    torch.save({k: torch.as_tensor(v, dtype=torch.float32)
                for k, v in sd.items()}, path)
    want = jconv.load_torch_params(path)
    got = convnet2.load_torch_params(path)
    assert got.keys() == want.keys()
    for layer in want:
        for k in ("w", "b"):
            assert got[layer][k].dtype == np.float32
            np.testing.assert_array_equal(got[layer][k], want[layer][k])
    model = convnet2.load_model(got, "cpu")
    logits = model(torch.zeros(1, 32, 32, 3), torch.zeros(1, 64, 64, 3))
    assert logits.shape == (1, 16) and torch.isfinite(logits).all()


def test_bd_metrics_equal_reference():
    ra, pa = [1000, 1800, 3200, 6000], [32.1, 34.6, 37.0, 39.4]
    rt, pt = [950, 1700, 3100, 5600], [32.3, 34.7, 37.2, 39.5]
    assert metrics.bd_rate(ra, pa, rt, pt) == jmetrics.bd_rate(ra, pa, rt, pt)
    assert metrics.bd_psnr(ra, pa, rt, pt) == jmetrics.bd_psnr(ra, pa, rt, pt)
    assert metrics.summary_line(4, 123456, 30.0, 35.0, 40.0, 41.0) == \
        jmetrics.summary_line(4, 123456, 30.0, 35.0, 40.0, 41.0)


def test_stream_utils_equal_reference():
    rng = np.random.default_rng(1)
    parts = []
    for t in (32, 33, 34, 19, 40, 19, 40):
        parts.append(bytes([0] * int(rng.integers(0, 2))) + b"\x00\x00\x01"
                     + bytes([t << 1, 1])
                     + rng.integers(1, 256, int(rng.integers(1, 40)),
                                    dtype=np.uint8).tobytes())
    stream = b"".join(parts)
    assert utils.annexb_bytecount(stream) == jutils.annexb_bytecount(stream)
    assert len(utils.annexb_bytecount(stream)) == 7
    planes = rng.integers(0, 1024, (2, 8, 8))
    np.testing.assert_array_equal(utils.convert_bitdepth(planes, 10, 8),
                                  jutils.convert_bitdepth(planes, 10, 8))
    pts = [(22, 4000.0), (27, 2100.0), (32, 1000.0), (37, 480.0)]
    assert (utils.bitrate_targeting(pts, 1500.0)
            == jutils.bitrate_targeting(pts, 1500.0))
