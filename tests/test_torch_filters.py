"""Deblocking, SAO statistics / decision / application and the CU
partition derivation of the port against the JAX functions (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import ctu as jctu
from hevctpu.ops import deblock as jdeblock
from hevctpu.ops import sao as jsao
from hevctpu_torch import rom
from hevctpu_torch.ops import ctu, deblock, sao


def _jax(fn, *args):
    out = jax.jit(fn)(*(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(x):
    return torch.as_tensor(np.array(x))


def _planes(rng, b, h, w):
    """Blocky 'reconstructions' (8x8 steps plus noise) and originals."""
    def one(hh, ww):
        base = rng.integers(40, 200, (b, hh // 8, ww // 8))
        rec = np.repeat(np.repeat(base, 8, 1), 8, 2) + rng.integers(
            -3, 4, (b, hh, ww))
        org = rec + rng.integers(-2, 7, (b, hh, ww))   # biased: SAO pays
        return (np.clip(rec, 0, 255).astype(np.int32),
                np.clip(org, 0, 255).astype(np.int32))
    return one(h, w), one(h // 2, w // 2), one(h // 2, w // 2)


@pytest.mark.parametrize("qp", [22, 32, 37])
@pytest.mark.parametrize("hw", [(64, 128), (120, 176)])
def test_deblock_frame(qp, hw):
    h, w = hw
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    rng = np.random.default_rng(qp)
    (y, _), (u, _), (v, _) = _planes(rng, 2, hp, wp)
    tusz = rng.integers(2, 6, (2, hp // 8, wp // 8)).astype(np.int32)
    want = _jax(lambda a, b, c, t: jdeblock.deblock_frame(
        a, b, c, t, qp, h, w), y, u, v, tusz)
    got = deblock.deblock_frame(_t(y), _t(u), _t(v), _t(tusz), qp, h, w)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
    assert (want[0] != y).any()


@pytest.mark.parametrize("hw", [(64, 128), (120, 176)])
def test_sao_stats_decision_apply(hw):
    h, w = hw
    hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
    qp = 32
    qp_c = rom.chroma_qp_from_luma(qp)
    rng = np.random.default_rng(h)
    (ry, oy), (ru, ou), (rv, ov) = _planes(rng, 2, hp, wp)
    specs = ((oy, ry, h, w, 64), (ou, ru, h // 2, w // 2, 32),
             (ov, rv, h // 2, w // 2, 32))
    stats_j, stats_t = [], []
    for org, rec, hh, ww, span in specs:
        sj = _jax(lambda o, r: jsao.ctu_stats(o, r, hh, ww, span), org, rec)
        st = sao.ctu_stats(_t(org), _t(rec), hh, ww, span)
        for a, b in zip(st, sj):
            np.testing.assert_array_equal(a.numpy(), b)
        stats_j.append(tuple(jnp.asarray(x) for x in sj))
        stats_t.append(st)
    pj = [np.asarray(x) for x in jax.jit(
        lambda *s: jsao.decide_params(*s, qp, qp_c))(*stats_j)]
    pt = sao.decide_params(*stats_t, qp, qp_c)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (pj[0] != 0).any() and (pj[4] != 0).any()  # SAO on, merges used
    for comp, (_, rec, hh, ww, span) in enumerate(specs):
        want = _jax(lambda r, *p: jsao.apply_sao(r, *p, comp, hh, ww, span),
                    rec, *pj[:4])
        got = sao.apply_sao(_t(rec), *pt[:4], comp, hh, ww, span)
        np.testing.assert_array_equal(got.numpy(), want)


def test_derive_slot_depths():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, (3, 4, 5, 16)).astype(np.int32)
    bh = np.array([64, 64, 64, 56], np.int32)[None, :, None]
    bw = np.array([64, 64, 64, 64, 16], np.int32)[None, None, :]
    want = _jax(jctu.derive_slot_depths, labels, bh, bw)
    got = ctu.derive_slot_depths(_t(labels), _t(bh), _t(bw))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), wnt)
