"""hevctpu_torch.ops.inter against hevctpu.ops.inter on the same numpy
inputs: the fixtures of tests/test_inter.py plus random and tie cases.

Integer outputs (predictions, motion vectors, SADs, bits, weights,
offsets, decisions, merge candidates) must match bit for bit. wp_acdc's
AC is a float32 sum of integers: the port sums exactly and rounds once,
the JAX package sums in float32 in XLA's order, so AC is held to a
relative 1e-6 (equal wherever the sums stay below 2^24, as here); DC is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import inter as jinter
from hevctpu_torch.ops import inter as tinter

AC_RTOL = 1e-6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _mc_case(name):
    """(plane, mv, n, luma) of the MC fixtures."""
    if name in ("luma_seed0", "luma_seed1"):
        rng = np.random.default_rng(int(name[-1]))
        plane = rng.integers(0, 256, (1, 32, 48), dtype=np.int32)
        return plane, rng.integers(-12, 13, (1, 4, 6, 2), dtype=np.int32), \
            8, True
    if name == "luma_all_fracs":
        rng = np.random.default_rng(7)
        plane = rng.integers(0, 256, (1, 32, 32), dtype=np.int32)
        mv = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"),
                      -1).astype(np.int32)[None]          # block (r, c): (r, c)
        return plane, mv, 8, True
    if name == "luma_far_out":
        rng = np.random.default_rng(4)
        plane = rng.integers(0, 256, (2, 16, 24), dtype=np.int32)
        return plane, rng.integers(-200, 201, (2, 4, 6, 2), dtype=np.int32), \
            4, True
    if name == "chroma_seed3":
        rng = np.random.default_rng(3)
        plane = rng.integers(0, 256, (1, 16, 24), dtype=np.int32)
        return plane, rng.integers(-17, 18, (1, 4, 6, 2), dtype=np.int32), \
            4, False
    rng = np.random.default_rng(6)                        # chroma_far_out
    plane = rng.integers(0, 256, (2, 16, 16), dtype=np.int32)
    return plane, rng.integers(-99, 100, (2, 2, 2, 2), dtype=np.int32), 8, \
        False


MC_CASES = ["luma_seed0", "luma_seed1", "luma_all_fracs", "luma_far_out",
            "chroma_seed3", "chroma_far_out"]


@pytest.mark.parametrize("case", MC_CASES)
def test_mc_grid_matches_reference(case):
    plane, mv, n, luma = _mc_case(case)
    name = "mc_luma_grid" if luma else "mc_chroma_grid"
    want = getattr(jinter, name)(jnp.asarray(plane), jnp.asarray(mv), n)
    _same(getattr(tinter, name)(_t(plane), _t(mv), n), want)


def test_filter_tables_match_reference():
    np.testing.assert_array_equal(tinter.LUMA_FILTERS, jinter.LUMA_FILTERS)
    np.testing.assert_array_equal(tinter.CHROMA_FILTERS,
                                  jinter.CHROMA_FILTERS)
    np.testing.assert_array_equal(tinter._eg1_len_table(),
                                  jinter._eg1_len_table())


@pytest.mark.parametrize("taps,extra", [(8, 0), (4, 0), (8, 2)])
def test_pad_ref_matches_reference(taps, extra):
    plane = np.random.default_rng(taps + extra).integers(
        0, 256, (2, 6, 9), dtype=np.int32)
    _same(tinter._pad_ref(_t(plane), taps, extra),
          jinter._pad_ref(jnp.asarray(plane), taps, extra))


def test_filter_pass_matches_reference():
    rng = np.random.default_rng(12)
    win = rng.integers(-9000, 9000, (2, 3, 15, 8), dtype=np.int32)
    coeff = jinter.LUMA_FILTERS[rng.integers(0, 4, (2, 3))]
    _same(tinter._filter_pass(_t(win), _t(coeff), -2, 8, 8),
          jinter._filter_pass(jnp.asarray(win), jnp.asarray(coeff), -2, 8, 8))


def test_bi_average_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.integers(-8192, 24576, (2, 8, 8)).astype(np.int32)
    b = rng.integers(-8192, 24576, (2, 8, 8)).astype(np.int32)
    _same(tinter.bi_average(_t(a), _t(b)),
          jinter.bi_average(jnp.asarray(a), jnp.asarray(b)))


def _search_case(name):
    """(cur, ref, n, srange) of the motion-search fixtures."""
    if name == "planted_shift":
        rng = np.random.default_rng(5)
        ref = rng.integers(0, 256, (1, 32, 32), dtype=np.int32)
        cur = np.roll(np.roll(ref, -2, axis=1), 3, axis=2)
        return cur, ref, 8, 4
    if name == "random":
        rng = np.random.default_rng(8)
        ref = rng.integers(0, 256, (2, 16, 24), dtype=np.int32)
        cur = np.clip(ref + rng.integers(-9, 10, ref.shape), 0, 255)
        return cur.astype(np.int32), ref, 4, 3
    # flat: every candidate of the window ties; the first one wins
    ref = np.full((1, 16, 16), 77, np.int32)
    return ref.copy(), ref, 8, 2


@pytest.mark.parametrize("case", ["planted_shift", "random", "flat_ties"])
def test_sad_full_search_matches_reference(case):
    cur, ref, n, sr = _search_case(case)
    want_mv, want_sad = jinter.sad_full_search(jnp.asarray(cur),
                                               jnp.asarray(ref), n, sr)
    mv, sad = tinter.sad_full_search(_t(cur), _t(ref), n, sr)
    _same(mv, want_mv)
    _same(sad, want_sad)
    if case == "flat_ties":
        assert (_np(mv) == -4 * sr).all()       # the window's first (dy, dx)


def _refine_case(name):
    if name == "half_pel":
        rng = np.random.default_rng(9)
        ref = rng.integers(0, 256, (1, 40, 40), dtype=np.int32)[:, :32, :32]
        mvh = np.full((1, 4, 4, 2), 2, np.int32)
        cur = np.asarray(jinter.mc_luma_grid(jnp.asarray(ref),
                                             jnp.asarray(mvh), 8))
        cur = cur.swapaxes(2, 3).reshape(1, 32, 32)
        return cur, ref, np.zeros((1, 4, 4, 2), np.int32), 8
    rng = np.random.default_rng(10)
    ref = rng.integers(0, 256, (2, 16, 16), dtype=np.int32)
    cur = np.clip(np.roll(ref, 1, axis=2) + rng.integers(-5, 6, ref.shape),
                  0, 255).astype(np.int32)
    return cur, ref, rng.integers(-8, 9, (2, 4, 4, 2), dtype=np.int32), 4


@pytest.mark.parametrize("case", ["half_pel", "random"])
def test_frac_refine_matches_reference(case):
    cur, ref, mv0, n = _refine_case(case)
    want_mv, want_sad = jinter.frac_refine(jnp.asarray(cur),
                                           jnp.asarray(ref),
                                           jnp.asarray(mv0), n)
    mv, sad = tinter.frac_refine(_t(cur), _t(ref), _t(mv0), n)
    _same(mv, want_mv)
    _same(sad, want_sad)


def test_amvp_and_mvd_bits_match_reference():
    f = np.arange(2 * 3 * 4 * 2, dtype=np.int32).reshape(2, 3, 4, 2)
    for got, want in zip(tinter.amvp_candidates(_t(f)),
                         jinter.amvp_candidates(jnp.asarray(f))):
        _same(got, want)
    vals = np.array([[0, 0], [1, -1], [2, 5], [-37, 300], [32769, -70000]],
                    np.int32)
    _same(tinter.mvd_bits(_t(vals)), jinter.mvd_bits(jnp.asarray(vals)))


def _fade():
    rng = np.random.default_rng(2)
    ref = rng.integers(40, 200, (1, 32, 32)).astype(np.int32)
    cur = np.clip((ref * 0.7).astype(np.int32) + 10, 0, 255)
    return cur, ref


@pytest.mark.parametrize("case", ["fade", "random_batch", "flat"])
def test_wp_acdc_matches_reference(case):
    if case == "fade":
        planes = np.concatenate(_fade())
    elif case == "random_batch":
        planes = np.random.default_rng(13).integers(
            0, 256, (3, 240, 416)).astype(np.int32)
    else:
        planes = np.full((1, 8, 8), 200, np.int32)
    want_dc, want_ac = jinter.wp_acdc(jnp.asarray(planes))
    dc, ac = tinter.wp_acdc(_t(planes))
    _same(dc, want_dc)
    assert _np(ac).dtype == np.float32
    np.testing.assert_allclose(_np(ac), np.asarray(want_ac), rtol=AC_RTOL,
                               atol=0)


@pytest.mark.parametrize("case", [
    dict(args=(1000.0, 500.0, 1000.0, 500.0)),
    dict(args=(133.0, 12.5 * 4096, 128.0, 10.0 * 4096)),
    dict(args=(133.0, 12.5 * 4096, 128.0, 10.0 * 4096), chroma=True),
    dict(args=(90.0, 0.0, 30.0, 0.0), log2_denom=0),
    dict(args=(20.0, 3000.0, 240.0, 10.0), chroma=True),
])
def test_wp_estimate_matches_reference(case):
    kw = {k: v for k, v in case.items() if k != "args"}
    for got, want in zip(tinter.wp_estimate(*case["args"], **kw),
                         jinter.wp_estimate(*case["args"], **kw)):
        _same(got, want)


@pytest.mark.parametrize("w,o", [(64, 0), (80, -3), (40, 12), (300, 100)])
def test_wp_apply_matches_reference(w, o):
    pel = np.random.default_rng(0).integers(0, 256, (2, 8, 8)).astype(
        np.int32)
    p14 = (pel << 6) - (1 << 13)
    _same(tinter.wp_apply(_t(p14), w, o), jinter.wp_apply(jnp.asarray(p14),
                                                          w, o))


def test_wp_apply_bi_matches_reference():
    rng = np.random.default_rng(1)
    p0 = (rng.integers(0, 256, (1, 8, 8)).astype(np.int32) << 6) - (1 << 13)
    p1 = (rng.integers(0, 256, (1, 8, 8)).astype(np.int32) << 6) - (1 << 13)
    for w0, o0, w1, o1 in ((70, 2, 58, -1), (64, 0, 64, 0), (12, -90, 130, 7)):
        _same(tinter.wp_apply_bi(_t(p0), _t(p1), w0, o0, w1, o1),
              jinter.wp_apply_bi(jnp.asarray(p0), jnp.asarray(p1), w0, o0,
                                 w1, o1))


@pytest.mark.parametrize("case", ["fade", "identical", "random_batch"])
def test_wp_select_matches_reference(case):
    if case == "fade":
        cur, ref = _fade()
    elif case == "identical":
        cur = ref = _fade()[1]
    else:
        rng = np.random.default_rng(14)
        ref = rng.integers(0, 256, (3, 16, 16)).astype(np.int32)
        cur = np.clip(ref * np.array([0.5, 1.0, 1.3])[:, None, None] + 5,
                      0, 255).astype(np.int32)
    w, o, _ = jinter.wp_estimate(*(np.asarray(v) for v in (
        *jinter.wp_acdc(jnp.asarray(cur)), *jinter.wp_acdc(jnp.asarray(ref)))))
    w, o = w[:, None, None], o[:, None, None]
    want = jinter.wp_select(jnp.asarray(cur), jnp.asarray(ref),
                            jnp.asarray(w), jnp.asarray(o))
    _same(tinter.wp_select(_t(cur), _t(ref), w, o), want)
    if case != "random_batch":
        assert bool(np.asarray(want).all()) == (case == "fade")


def _merge_field(name):
    if name == "pruning":
        mvf = np.zeros((1, 3, 3, 2), np.int32)
        mvf[0, 0, 1] = (4, 0)
        mvf[0, 1, 0] = (4, 0)
        mvf[0, 0, 2] = (8, 8)
        mvf[0, 2, 0] = (4, 0)
        mvf[0, 0, 0] = (1, 2)
        return mvf
    rng = np.random.default_rng(15)                      # few values: ties
    return rng.integers(-1, 2, (1, 5, 6, 2), dtype=np.int32) * 4


@pytest.mark.parametrize("case", ["pruning", "random"])
def test_merge_candidates_match_reference(case):
    mvf = _merge_field(case)
    for got, want in zip(tinter.merge_candidates(_t(mvf)),
                         jinter.merge_candidates(jnp.asarray(mvf))):
        _same(got, want)


@pytest.mark.gpu
def test_inter_card_matches_cpu():
    """Every function on the card against the CPU port: integers bit for
    bit, wp_acdc's AC within AC_RTOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")

    def both(fn, *args):
        cpu = fn(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
        card = fn(*(_t(a).to(dev) if isinstance(a, np.ndarray) else a
                    for a in args))
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        card = card if isinstance(card, tuple) else (card,)
        return [(_np(a), _np(b)) for a, b in zip(card, cpu)]

    checks = []
    for case in MC_CASES:
        plane, mv, n, luma = _mc_case(case)
        checks += both(tinter.mc_luma_grid if luma else tinter.mc_chroma_grid,
                       plane, mv, n)
    for case in ("planted_shift", "random", "flat_ties"):
        checks += both(tinter.sad_full_search, *_search_case(case))
    cur, ref, mv0, n = _refine_case("random")
    checks += both(tinter.frac_refine, cur, ref, mv0, n)
    checks += both(tinter.merge_candidates, _merge_field("random"))
    checks += both(tinter.mvd_bits, np.array([[3, -70000]], np.int32))
    cur, ref = _fade()
    checks += both(tinter.wp_select, cur, ref, 80, -3)
    for card, cpu in checks:
        np.testing.assert_array_equal(card, cpu)
    planes = np.random.default_rng(13).integers(0, 256, (3, 240, 416))
    (dc_card, dc_cpu), (ac_card, ac_cpu) = both(tinter.wp_acdc,
                                                planes.astype(np.int32))
    np.testing.assert_array_equal(dc_card, dc_cpu)
    np.testing.assert_allclose(ac_card, ac_cpu, rtol=AC_RTOL, atol=0)
