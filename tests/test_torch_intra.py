"""Intra reference fill/smoothing and matmul prediction of the port against
the JAX functions (integer outputs, exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import intra as jintra
from hevctpu.ops import intra_mm as jintra_mm
from hevctpu_torch.ops import intra, intra_mm


def _jax(fn, *args):
    out = jax.jit(fn)(*(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(x):
    return torch.as_tensor(np.array(x))


def _refs(rng, m, n, flat=False):
    top = rng.integers(0, 256, (m, 2 * n + 1)).astype(np.int32)
    left = rng.integers(0, 256, (m, 2 * n + 1)).astype(np.int32)
    if flat:   # smooth ramps: triggers the 32x32 strong filter
        base = rng.integers(20, 230, (m, 1))
        ramp = np.arange(2 * n + 1)[None, :] // 16
        top = (base + ramp).astype(np.int32)
        left = (base + ramp).astype(np.int32)
        left[:, 0] = top[:, 0]
    return top, left


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_fill_split_smooth(n):
    rng = np.random.default_rng(n)
    m = 50
    bnd = rng.integers(0, 256, (m, 4 * n + 1)).astype(np.int32)
    av = rng.random((m, 4 * n + 1)) < 0.6
    av[:5] = False                         # nothing available: mid-grey
    av[5:10, : 2 * n] = False              # leading run unavailable
    want = _jax(jintra.fill_reference, bnd, av)
    got = intra.fill_reference(_t(bnd), _t(av)).numpy()
    np.testing.assert_array_equal(got, want)

    want = _jax(lambda b: jintra.split_boundary(b, n), bnd)
    got = intra.split_boundary(_t(bnd), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)

    for flat in (False, True):
        top, left = _refs(rng, m, n, flat)
        want = _jax(lambda a, b: jintra.smooth_reference(a, b, n), top, left)
        got = intra.smooth_reference(_t(top), _t(left), n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("is_luma", [True, False])
def test_predict_all_and_selected(n, is_luma):
    rng = np.random.default_rng(100 + n)
    m = 24
    top, left = _refs(rng, m, n)
    tf, lf = (np.asarray(x) for x in
              _jax(lambda a, b: jintra.smooth_reference(a, b, n), top, left))
    want = _jax(lambda *r: jintra_mm.predict_all_modes_mm(
        *r, n, is_luma=is_luma), top, left, tf, lf)
    got = intra_mm.predict_all_modes_mm(_t(top), _t(left), _t(tf), _t(lf), n,
                                        is_luma=is_luma).numpy()
    np.testing.assert_array_equal(got, want)

    mode = rng.integers(0, 35, m).astype(np.int32)
    want = _jax(lambda *r: jintra_mm.predict_selected_mode_mm(
        *r, n, is_luma=is_luma), top, left, tf, lf, mode)
    got = intra_mm.predict_selected_mode_mm(
        _t(top), _t(left), _t(tf), _t(lf), _t(mode), n,
        is_luma=is_luma).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_grid_boundaries(n):
    rng = np.random.default_rng(200 + n)
    plane = rng.integers(0, 256, (2, 64, 128)).astype(np.int32)
    want = _jax(lambda p: jintra_mm.grid_boundaries(p, n), plane)
    got = intra_mm.grid_boundaries(_t(plane), n).numpy()
    np.testing.assert_array_equal(got, want)
