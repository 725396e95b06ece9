"""ConvNet2 in torch against the JAX model on the checkpoint in the repo:
logits to atol 1e-4 (float32 convolutions sum in another order), labels
exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.models import checkpoint as jckpt
from hevctpu.models import convnet2 as jconv
from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.pipeline import clips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "CKPT_DOMAIN.npz")


@pytest.fixture(scope="module")
def params():
    return checkpoint.load(CKPT)


@pytest.fixture(scope="module")
def model(params):
    return convnet2.load_model(params, "cpu")


def test_checkpoint_copy_loads_the_same(params):
    ref = jckpt.load(CKPT)
    for layer in ref:
        for k in ref[layer]:
            np.testing.assert_array_equal(params[layer][k], ref[layer][k])


@pytest.mark.parametrize("hw", [(64, 128), (240, 416)])
def test_logits_and_labels(params, model, hw):
    h, w = hw
    y, u, v = clips.clip_sine(2, h, w, seed=3)
    x32, x64 = jconv.frame_to_crops(
        jconv.yuv_to_rgb01(jnp.asarray(y[0]), jnp.asarray(u[0]),
                           jnp.asarray(v[0])), h, w)
    want = np.asarray(jconv.forward(params, x32, jnp.repeat(x64, 4, axis=0)))
    t32, t64 = convnet2.frame_to_crops(
        convnet2.yuv_to_rgb01(*(torch.as_tensor(p[0]) for p in (y, u, v))),
        h, w)
    np.testing.assert_array_equal(t32.numpy(), np.asarray(x32))
    np.testing.assert_array_equal(t64.numpy(), np.asarray(x64))
    with torch.no_grad():
        got = model(t32, t64.repeat_interleave(4, dim=0)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    want_lab = np.asarray(jconv.predict_batch_labels(
        params, jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), h, w))
    got_lab = convnet2.predict_frame_labels(
        model, *(torch.as_tensor(p) for p in (y, u, v)), h, w).numpy()
    np.testing.assert_array_equal(got_lab, want_lab)


def test_label_postprocessing():
    rng = np.random.default_rng(0)
    digits = rng.integers(0, 4, (500, 4, 4))
    digits[:50] = 0
    digits[50:100, 1:] = 0
    np.testing.assert_array_equal(
        convnet2.assemble_ctu_labels(torch.as_tensor(digits)).numpy(),
        np.asarray(jconv.assemble_ctu_labels(jnp.asarray(digits))))
    logits = rng.standard_normal((40, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        convnet2.logits_to_labels(torch.as_tensor(logits)).numpy(),
        np.asarray(jconv.logits_to_labels(jnp.asarray(logits))))
