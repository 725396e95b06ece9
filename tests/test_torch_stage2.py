"""Stage 2 in the reference's traced form (hevctpu/pipeline/encoder.py
_reconstruct: the static TU schedule, fire masks taken on the device, TU
origins held in tensors) against the JAX package and against the port's
host-planned form, its plain version, on the CPU.

The schedule tables, the traced availability and one masked TU step
(_tu_step_dyn, at a few origins of each size, default options, the TS
trial at 4x4 and a per-row QP vector) equal the JAX functions bit for
bit. The whole traced reconstruction, run eagerly, equals the planned
one on all 13 planes at 64x128 x 2 with CNN labels, and with a random
per-CTU QP map under two_pass (its second pass's decisions). The planned
form equals the JAX encoder through tests/test_torch_encoder.py and its
siblings, so no JAX encoder is compiled here. The card's graph form is
held to the planned form in tests/test_torch_stage2_card.py."""

import concurrent.futures
import functools
import gc
import os
import sys
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevctpu.ops import ctu as jctu
from hevctpu.ops import rate as jrate
from hevctpu.pipeline import encoder as jenc
from hevctpu_torch import rom
from hevctpu_torch.models import checkpoint, convnet2
from hevctpu_torch.ops import ctu
from hevctpu_torch.pipeline import clips
from hevctpu_torch.pipeline import encoder as tenc

# One torch thread a test process: the suite runs in several processes
# at once, and a thread per core in each makes them contend.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, QP, FRAMES = 64, 128, 32, 2
LAM = jrate.lambda_rd(QP)
QP_C = rom.chroma_qp_from_luma(QP)


# (size, luma, TS trial, per-row QP): the main path's TU kinds, and the
# QP-map form at one luma and one chroma size
STEP_CASES = [(32, True, False, False), (16, True, False, False),
              (8, True, False, False), (4, True, True, False),
              (16, False, False, False), (4, False, True, False),
              (8, True, False, True), (4, False, True, True)]
STEP_ROWS = 3


def _compile_step(n: int, luma: bool, ts: bool):
    """JAX's _tu_step_dyn compiled at one TU kind. Under jit its QP and
    λs are traced either way, so every case of a kind passes them as
    [rows] vectors (uniform where the port's QP is static) and the kind
    compiles once for both of its origins and both QP forms."""
    span, r, i32 = 64 if luma else 32, STEP_ROWS, jnp.int32

    def arg(shape, dtype=i32):
        return jax.ShapeDtypeStruct(shape, dtype)

    step = jax.jit(functools.partial(
        jenc._tu_step_dyn, n=n, is_luma=luma,
        frame_hw=(240 * span // 64, 416 * span // 64), span=span, sbh=True,
        dst=luma and n == 4, rate_qp=QP if luma else QP_C))
    lam = arg((r,), jnp.float32)
    return step.lower(
        arg((r, span + 1 + span // 2, 2 * span + 2)), arg((r, span, span)),
        arg((r, span, span)), arg((r,)), arg((r,), jnp.bool_), arg(()),
        arg(()), qp=arg((r,)), av_z=arg((4 * n + 1,), jnp.bool_),
        ctu_yx=(arg((r,)), arg((r,))), rdoq_lam=lam,
        ts_lam=lam if ts else 0.0).compile()


# the compiles, by (n, luma, ts); started in the background by the
# module's first test so that they overlap the traced reconstructions,
# which is why the step tests come last in this file
_STEPS = {}


@pytest.fixture(scope="module", autouse=True)
def _compile_steps():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for n, luma, ts, _ in STEP_CASES:
            if (n, luma, ts) not in _STEPS:
                _STEPS[n, luma, ts] = pool.submit(_compile_step, n, luma, ts)
        yield
    _STEPS.clear()


def test_tu_schedule_equal():
    assert ctu.tu_schedule() == [tuple(s) for s in jctu.tu_schedule()]
    assert len(ctu.tu_schedule()) == 84


def test_tu_size_for_slot_equal():
    depth = np.random.default_rng(0).integers(0, 4, (3, 8, 8)).astype(
        np.int32)
    depth[0, 0, :4] = np.arange(4)                  # every depth present
    want = np.asarray(jctu.tu_size_for_slot(jnp.asarray(depth)))
    got = ctu.tu_size_for_slot(torch.as_tensor(depth)).numpy()
    np.testing.assert_array_equal(got, want)


# CTU picture origins of a 240x416 frame (4 x 7 CTUs, the last row 48
# rows tall, the last column 32 wide): corners, edges and the interior
CTU_YX = np.array([[0, 0], [0, 384], [192, 0], [192, 384], [64, 192],
                   [128, 320]], np.int32)


@pytest.mark.parametrize("scale", [1, 2], ids=["luma", "chroma"])
def test_boundary_available_traced_equal(scale):
    """At every origin of the schedule (with the TU4 origins), sizes 4-32
    of the component, luma and chroma, interior and edge CTUs."""
    h, w = 240 // scale, 416 // scale
    cy, cx = CTU_YX[:, 0] // scale, CTU_YX[:, 1] // scale
    jfn = {}
    for size, oy, ox in tenc._tu_order():
        n = size // scale
        if n < 4:
            continue
        if n not in jfn:
            jfn[n] = jax.jit(functools.partial(
                jctu.boundary_available_traced, n=n, h=h, w=w, scale=scale))
        want = np.asarray(jfn[n](jnp.int32(oy // scale),
                                 jnp.int32(ox // scale),
                                 ctu_y=jnp.asarray(cy), ctu_x=jnp.asarray(cx)))
        got = ctu.boundary_available_traced(
            torch.tensor(oy // scale), torch.tensor(ox // scale), n,
            torch.as_tensor(cy), torch.as_tensor(cx), h, w, scale).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{n} {oy} {ox}")


@pytest.fixture(scope="module")
def recorded():
    """A two_pass encode at 64x128 x 2 (CNN labels, a random per-CTU QP
    map) on the CPU: its encoder and the arguments of both of its
    reconstructions."""
    y, u, v = clips.clip_sine(FRAMES, H, W, seed=0)
    cnn = convnet2.load_model(
        checkpoint.load(os.path.join(ROOT, "CKPT_DOMAIN.npz")), "cpu")
    labels = convnet2.predict_frame_labels(
        cnn, *(torch.as_tensor(p.astype(np.int32)) for p in (y, u, v)), H,
        W).numpy()
    enc = tenc.FrameEncoder(H, W, QP, device="cpu", two_pass=True)
    qp_map = np.random.default_rng(3).integers(
        22, 43, (FRAMES, enc.geom.rc, enc.geom.cc))
    calls = []
    real = enc._reconstruct

    def recording(*a):
        calls.append(a)
        return real(*a)

    enc._reconstruct = recording
    enc.encode(y, u, v, labels, qp_map)
    assert len(calls) == 2 and calls[1][8] is not None
    return enc, calls


@pytest.mark.parametrize("case", ["cnn_labels", "qp_map_two_pass"])
def test_traced_equals_planned(recorded, case):
    """cnn_labels: the first pass's decisions (the main path's: CNN
    labels, one pass) without a QP map; qp_map_two_pass: the second
    pass's, with the map."""
    enc, calls = recorded
    args = calls[0][:8] + (None, None) if case == "cnn_labels" else calls[1]
    want = enc._reconstruct_planned(*args)
    got = enc._reconstruct_traced(*args)
    assert len(want) == 13 and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert want["levels_y"].any() and want["cbf_u"].any()


def test_wavefront_freed_with_its_encoder():
    """An encoder's cached wavefronts (on the card, their CUDA graphs) go
    with it by reference counting, not at a later garbage collection,
    which could fall inside another encoder's capture and invalidate
    it."""
    enc = tenc.FrameEncoder(H, W, QP, device="cpu")
    wf = tenc._Wavefront(enc, 1, torch.device("cpu"))
    enc._stage2["key"] = wf
    ref = weakref.ref(wf)
    del wf
    collecting = gc.isenabled()
    gc.disable()
    try:
        del enc
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


class _TileAxis:
    """An in-process tile axis: one thread a tile, each with a rank whose
    exchange() swaps halos through a barrier as parallel.Mesh.exchange
    does (zeros where there is no neighbour)."""

    def __init__(self, tiles: int):
        self.tiles = tiles
        self.barrier = threading.Barrier(tiles)
        self.box = [None] * tiles

    def rank(self, ti: int):
        axis = self

        class Rank:
            tile, tile_index = axis.tiles, ti

            def exchange(self, right, bottom):
                axis.box[ti] = (right.clone(), bottom.clone())
                axis.barrier.wait()
                got = (axis.box[ti - 1][0] if ti > 0
                       else torch.zeros_like(right),
                       axis.box[ti + 1][1] if ti + 1 < axis.tiles
                       else torch.zeros_like(bottom))
                axis.barrier.wait()
                return got

        return Rank()


@pytest.mark.slow
def test_traced_tiles_equal_planned(recorded):
    """The traced form on a tile axis of 2 (one CTU column a tile, the
    second tile's left neighbour from the first's halo), its tiles joined
    along the width: equal to the planned single-device reconstruction.
    Slow tier (~18 s: two tiles of 2 x 424 steps in contending threads);
    chip_smoke.py phases 13b and 17 hold the card's tile path to the
    single-process encode."""
    enc, calls = recorded
    args = calls[0][:8]
    axis = _TileAxis(2)
    outs, errors = [None, None], []

    def run(ti):
        try:
            torch.set_num_threads(1)
            outs[ti] = enc._reconstruct_traced(*args, None, axis.rank(ti))
        except BaseException as e:     # reported below, not lost
            errors.append(e)
            axis.barrier.abort()

    threads = [threading.Thread(target=run, args=(ti,)) for ti in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)     # the tiles hand over at the barrier
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    want = enc._reconstruct_planned(*args)
    for k in want:
        got = torch.cat([outs[0][k], outs[1][k]], dim=-1)
        assert torch.equal(got, want[k]), k


@pytest.mark.parametrize(
    "n,luma,ts,qp_vec", STEP_CASES,
    ids=[f"{'y' if c[1] else 'c'}{c[0]}{'_ts' if c[2] else ''}"
         f"{'_qpvec' if c[3] else ''}" for c in STEP_CASES])
def test_tu_step_dyn_equal(n, luma, ts, qp_vec):
    """One masked TU at the first and the last origin of its size in the
    CTU, three rows (one not firing) at edge and interior CTUs: recon,
    levels, cbf and transform-skip flags bit for bit."""
    rng = np.random.default_rng(n * 4 + 2 * luma + qp_vec)
    span = 64 if luma else 32
    rows = STEP_ROWS
    qp0 = QP if luma else QP_C
    lam0 = LAM if luma else LAM / jrate.chroma_dist_weight(QP, QP_C)
    if qp_vec:
        qp_rows = np.array([qp0 - 5, qp0, qp0 + 4], np.int32)
        dqp = torch.as_tensor(qp_rows - qp0)
        lam_rows = (lam0 * tenc.lambda_scale(dqp)).numpy()  # float32 [rows]
    else:
        qp_rows = np.full(rows, qp0, np.int32)
        lam_rows = np.full(rows, lam0, np.float32)
    ctu_y = CTU_YX[[0, 3, 4], 0] // (64 // span)
    ctu_x = CTU_YX[[0, 3, 4], 1] // (64 // span)
    hw = (240 * span // 64, 416 * span // 64)
    jstep = _STEPS[n, luma, ts].result()

    def tt(a):
        return torch.tensor(np.asarray(a))

    # the port's arguments: static QP and λs, or the per-row vectors
    qp, lam = (tt(qp_rows), tt(lam_rows)) if qp_vec else (qp0, lam0)
    ts_lam = lam if ts else 0.0
    for oy, ox in ((0, 0), (span - n, span - n)):
        ext = rng.integers(0, 256, (rows, span + 1 + span // 2,
                                    2 * span + 2)).astype(np.int32)
        levels = rng.integers(-3, 4, (rows, span, span)).astype(np.int32)
        orig = rng.integers(0, 256, (rows, span, span)).astype(np.int32)
        mode = rng.integers(0, 35, rows).astype(np.int32)
        fire = np.array([True, False, True])
        av_z = jenc._zorder_avail_np(oy, ox, n, span)
        j_ext, j_lev, j_cbf, j_ts = jstep(
            jnp.asarray(ext), jnp.asarray(levels), jnp.asarray(orig),
            jnp.asarray(mode), jnp.asarray(fire), jnp.int32(oy),
            jnp.int32(ox), qp=jnp.asarray(qp_rows), av_z=jnp.asarray(av_z),
            ctu_yx=(jnp.asarray(ctu_y), jnp.asarray(ctu_x)),
            rdoq_lam=jnp.asarray(lam_rows),
            ts_lam=jnp.asarray(lam_rows) if ts else 0.0)
        t_ext, t_lev = tt(ext), tt(levels)
        cbf, tsf = tenc._tu_step_dyn(
            t_ext, t_lev, tt(orig), tt(mode), tt(fire), torch.tensor([oy]),
            torch.tensor([ox]), n, qp, tt(av_z), is_luma=luma,
            ctu_yx=(tt(ctu_y).long(), tt(ctu_x).long()), frame_hw=hw,
            rdoq_lam=lam, sbh=True, dst=luma and n == 4, ts_lam=ts_lam,
            rate_qp=qp0)
        for name, got, want in (("ext", t_ext, j_ext),
                                ("levels", t_lev, j_lev),
                                ("cbf", cbf, j_cbf), ("ts", tsf, j_ts)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{name} at {oy},{ox}")
        assert (t_lev.numpy() != levels).any()     # the step wrote
