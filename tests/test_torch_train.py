"""The training slice against the JAX package on the CPU.

Bit for bit: ConvNet2's initial weights, the params layout round trip and
make_dataset. With stated tolerances: the grouped loss (rtol 1e-6) and
each gradient tensor (relative L2 1e-5), where float32 convolutions sum
in another order; whole training runs (history loss rtol 1e-5, each
weight tensor relative L2 1e-4, accuracy equal), where optax and torch
round Adam's bias corrections differently, so a rounding-level gradient
gap grows where v is tiny: weights are compared as whole tensors, never
element by element. Run with -s to print the measured gaps. No JAX
encoder compile."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.models import convnet2 as jconv
from hevctpu.models import train as jtrain
from hevctpu.pipeline import labels as jlabels
from hevctpu_torch.models import checkpoint, convnet2, train
from hevctpu_torch.pipeline import labels


# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "CKPT_DOMAIN.npz")
LAYERS = ("conv1", "conv64", "conv2", "conv3", "fc1", "fc2", "fc3")


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _worst_rel_l2(got: dict, want: dict):
    """(largest per-tensor relative L2 gap, its layer/key)."""
    return max((_rel_l2(got[l][k], want[l][k]), f"{l}.{k}")
               for l in LAYERS for k in ("w", "b"))


def _clip(frames, h, w, seed):
    """uint8 YUV420 planes and random labels [frames, nCTU, 16]."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (frames, h, w)).astype(np.uint8)
    u = rng.integers(0, 256, (frames, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (frames, h // 2, w // 2)).astype(np.uint8)
    n_ctu = -(-h // 64) * -(-w // 64)
    lab = rng.integers(0, 4, (frames, n_ctu, 16)).astype(np.int32)
    return y, u, v, lab


def _jax_dataset(y, u, v, lab):
    return jlabels.make_dataset(y.astype(np.int32), u.astype(np.int32),
                                v.astype(np.int32), lab)


@pytest.fixture(scope="module")
def data48():
    """48 samples: 2 frames of 128x192 (6 CTUs each)."""
    return _jax_dataset(*_clip(2, 128, 192, seed=5))


@pytest.mark.parametrize("seed", [0, 1])
def test_init_params_bit_identical(seed):
    got, want = convnet2.init_params(seed), jconv.init_params(seed)
    assert set(got) == set(want) == set(LAYERS)
    for layer in LAYERS:
        for k in ("w", "b"):
            assert got[layer][k].dtype == want[layer][k].dtype
            np.testing.assert_array_equal(got[layer][k], want[layer][k])


@pytest.mark.parametrize("source", ["checkpoint", "init"])
def test_params_to_jax_round_trip(source):
    p = checkpoint.load(CKPT) if source == "checkpoint" else \
        convnet2.init_params(2)
    back = convnet2.params_to_jax(convnet2.load_model(p, "cpu"))
    for layer in LAYERS:
        for k in ("w", "b"):
            assert back[layer][k].dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], p[layer][k])


def test_params_to_jax_keeps_fc1_hwc_order():
    """The round-tripped weights give the JAX forward's logits: fc1's
    columns stay in the HWC flatten order both forwards use."""
    rng = np.random.default_rng(4)
    x32 = rng.random((4, 32, 32, 3), np.float32)
    x64 = rng.random((4, 64, 64, 3), np.float32)
    p = convnet2.params_to_jax(convnet2.load_model(checkpoint.load(CKPT),
                                                   "cpu"))
    want = np.asarray(jconv.forward(p, x32, x64))
    with torch.no_grad():
        got = convnet2.load_model(p, "cpu")(torch.as_tensor(x32),
                                            torch.as_tensor(x64)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(2, 128, 192), (1, 120, 176)])
def test_make_dataset_bit_identical(shape):
    """120x176 has padded CTUs on the right and bottom edges."""
    y, u, v, lab = _clip(*shape, seed=3)
    want = _jax_dataset(y, u, v, lab)
    got = labels.make_dataset(y, u, v, lab, device="cpu")
    n = shape[0] * lab.shape[1] * 4
    for g, wnt, tail in zip(got, want, ((32, 32, 3), (64, 64, 3), (4,))):
        assert tuple(g.shape) == (n, *tail) == wnt.shape
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), wnt)
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.int64


def _grads_to_jax(model: convnet2.ConvNet2) -> dict:
    g = convnet2.ConvNet2()
    g.load_state_dict({k: p.grad for k, p in model.named_parameters()})
    return convnet2.params_to_jax(g)


@pytest.mark.parametrize("source", ["init", "checkpoint"])
def test_loss_and_gradients_match(data48, source):
    x32, x64, digits = (a[:16] for a in data48)
    p = convnet2.init_params(0) if source == "init" else checkpoint.load(CKPT)
    want_loss, want_g = jax.value_and_grad(jtrain.loss_fn)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x32), jnp.asarray(x64),
        jnp.asarray(digits))
    model = convnet2.load_model(p, "cpu")
    loss = train.loss_fn(model, torch.as_tensor(x32), torch.as_tensor(x64),
                         torch.as_tensor(digits))
    loss.backward()
    loss = loss.detach()
    got_g = _grads_to_jax(model)
    gap, where = _worst_rel_l2(got_g, jax.tree.map(np.asarray, want_g))
    print(f"\n{source}: loss {float(loss):.7f} vs {float(want_loss):.7f}; "
          f"largest gradient relative L2 gap {gap:.3g} ({where})")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert gap <= 1e-5, (gap, where)
    assert train.accuracy(model, torch.as_tensor(x32), torch.as_tensor(x64),
                          torch.as_tensor(digits)) == jtrain.accuracy(
        p, jnp.asarray(x32), jnp.asarray(x64), jnp.asarray(digits))


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _jax_train_f64(x32, x64, digits, **kw):
    """The JAX trainer in float64: params and crops cast up, under x64."""
    with jax.enable_x64(True):
        return jtrain.train(*_f64((x32, x64)), digits,
                            params=_f64(jconv.init_params(0)), **kw)


def _gaps(got, want):
    """(largest weight relative L2 gap, its tensor, largest history loss
    relative gap)."""
    gap, where = _worst_rel_l2(got[0], want[0])
    loss_gap = max(abs(g["loss"] - w["loss"]) / w["loss"]
                   for g, w in zip(got[1], want[1]))
    return gap, where, loss_gap


# 48 samples in batches of 16 (3 steps an epoch), and 12 samples against a
# batch of 16, which trains one batch of all 12 a step.
CASES = [(48, 16, 3), (12, 16, 3)]


@pytest.mark.parametrize("n,batch,epochs", CASES)
def test_train_float64_equals_reference(data48, n, batch, epochs):
    """Both trainers in float64 from the same initial weights: the same
    batches, loss, Adam update and accuracy, so the trajectories agree to
    float64 rounding (measured 1e-14 relative L2)."""
    x32, x64, digits = (a[:n] for a in data48)
    kw = dict(epochs=epochs, batch=batch, lr=1e-3, seed=0, log=None)
    want = _jax_train_f64(x32, x64, digits, **kw)
    got = train.train(*_f64((x32, x64)), digits, device="cpu", **kw)
    gap, where, loss_gap = _gaps(got, want)
    print(f"\nfloat64 n={n}: largest weight relative L2 gap {gap:.3g} "
          f"({where}); largest loss relative gap {loss_gap:.3g}")
    assert gap <= 1e-11, (gap, where)
    assert loss_gap <= 1e-12
    assert [h["acc"] for h in got[1]] == [h["acc"] for h in want[1]]


@pytest.mark.parametrize("n,batch,epochs", CASES)
def test_train_matches_reference(data48, n, batch, epochs):
    """The float32 path (what make_dataset feeds) against the JAX trainer
    in float32 and in float64. Float32 rounding in the gradients grows
    over the steps wherever Adam's v is tiny (biases that start at zero
    most): either trainer's float32 weights drift from the float64
    trajectory by up to 5.3e-3 relative L2 on such 48-sample fixtures
    (my CPU runs), so weights are held to 1e-2 per tensor and the history
    loss to 1e-4; the float64 test above holds the algorithm itself."""
    x32, x64, digits = (a[:n] for a in data48)
    kw = dict(epochs=epochs, batch=batch, lr=1e-3, seed=0)
    logged = []
    got = train.train(x32, x64, digits, log=logged.append, device="cpu",
                      **kw)
    assert len(logged) == epochs and logged[0].startswith("epoch 0: loss ")
    assert [h["epoch"] for h in got[1]] == list(range(epochs))
    for layer in LAYERS:
        for k in ("w", "b"):
            assert got[0][layer][k].dtype == np.float32
    for name, want in (
            ("float32", jtrain.train(x32, x64, digits, log=None, **kw)),
            ("float64", _jax_train_f64(x32, x64, digits, log=None, **kw))):
        gap, where, loss_gap = _gaps(got, want)
        print(f"\nn={n}, port float32 vs JAX {name}: largest weight "
              f"relative L2 gap {gap:.3g} ({where}); largest loss relative "
              f"gap {loss_gap:.3g}")
        assert gap <= 1e-2, (name, gap, where)
        assert loss_gap <= 1e-4, (name, loss_gap)
        assert [h["acc"] for h in got[1]] == [h["acc"] for h in want[1]]


def test_train_leaves_cudnn_flags(data48):
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    train.train(*(a[:4] for a in data48), epochs=1, batch=4, log=None,
                device="cpu")
    assert flags == (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.enabled,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)


def test_train_defaults_to_cuda(data48):
    if torch.cuda.is_available():
        pytest.skip("the rule under test is the one without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(*(a[:4] for a in data48), epochs=1, log=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        labels.make_dataset(*_clip(1, 64, 64, seed=0))


@pytest.mark.gpu
def test_make_dataset_on_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    clip = _clip(2, 120, 176, seed=9)
    for got, want in zip(labels.make_dataset(*clip, device="cuda"),
                         labels.make_dataset(*clip, device="cpu")):
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_train_on_card_matches_cpu(data48, dtype):
    """3 steps (48 samples, batch 16) on the card and on the CPU port: in
    float32 the loss to rtol 1e-3 as in chip_smoke.py's phase 12, and each
    weight tensor to relative L2 1e-2 (phase 12 bounds the weights as a
    whole: 14 steps leave one small tensor room to part); in float64 both
    to 1e-12; accuracy within 2 digits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x32, x64, digits = data48
    runs = [train.train(x32.astype(dtype), x64.astype(dtype), digits,
                        epochs=1, batch=16, log=None, device=d)
            for d in ("cuda", "cpu")]
    gap, where, loss_gap = _gaps(*runs)
    assert gap <= (1e-2 if dtype == np.float32 else 1e-12), (gap, where)
    assert loss_gap <= (1e-3 if dtype == np.float32 else 1e-12)
    assert abs(runs[0][1][0]["acc"] - runs[1][1][0]["acc"]) * 48 * 4 <= 2
