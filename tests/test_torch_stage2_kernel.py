"""Stage 2's kernel (csrc/stage2_ctu.cu, ops/stage2_ctu.py) on the CPU.

The schedule table the wrapper uploads walks _block16_schedule in the
wavefront's z-order with its decoded-before masks, and its fire rules,
joined to the in-picture check as the kernel does, give the planned
form's firing masks and availability (_stage2_plan) on random maps:
plain numpy, no JAX.

The kernel's source itself, built for the host with g++ (its warp run as
32 fibers, tests/cuda_host/warp.h) and launched between the eager
_Wavefront's _open and _close on the CPU, gives the planned form's 13
planes bit for bit: every slot a TU4 leaf (the TS trial on every luma
TU), random leaf sizes under a random per-CTU QP map, and RDOQ, SBH and
TS switched off. The card runs the same source built by nvcc
(tests/test_torch_stage2_card.py)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hevctpu_torch.ops import ctu, stage2_ctu
from hevctpu_torch.pipeline import encoder as tenc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kernel_schedule_walks_the_wavefront():
    """One entry a step of _tu_order; each entry's masks are
    _block16_schedule's for its quadrant, 16-block, 8-slot and 4x4."""
    steps, masks = tenc._kernel_schedule()
    assert steps.shape == (340, stage2_ctu.STEP_WORDS)
    assert [tuple(s[:3]) for s in steps] == list(tenc._tu_order())
    _, _, _, *av = tenc._block16_schedule()
    av32, av32c, av16, av16c, av8, av8c, av4 = av
    i = 0
    for q in range(4):
        assert (steps[i][3:5] == (5, 1)).all()
        lum, chro = steps[i][5], steps[i][6]
        np.testing.assert_array_equal(masks[lum: lum + 129], av32[4 * q])
        np.testing.assert_array_equal(masks[chro: chro + 65], av32c[4 * q])
        i += 1
        for t in range(4 * q, 4 * q + 4):
            assert (steps[i][3:5] == (4, 1)).all()
            np.testing.assert_array_equal(
                masks[steps[i][5]: steps[i][5] + 65], av16[t])
            np.testing.assert_array_equal(
                masks[steps[i][6]: steps[i][6] + 33], av16c[t])
            i += 1
            for e in range(4):
                assert (steps[i][3:5] == (3, 2)).all()
                np.testing.assert_array_equal(
                    masks[steps[i][5]: steps[i][5] + 33], av8[t, e])
                np.testing.assert_array_equal(
                    masks[steps[i][6]: steps[i][6] + 17], av8c[t, e])
                i += 1
                for k in range(4):
                    assert (steps[i][3:5] == (2, 0)).all()
                    np.testing.assert_array_equal(
                        masks[steps[i][5]: steps[i][5] + 17], av4[t, e, k])
                    i += 1
    tabs = stage2_ctu.tables_np(steps, masks, (32, 31))
    np.testing.assert_array_equal(tabs["steps"], steps.reshape(-1))
    np.testing.assert_array_equal(tabs["avail"], masks)


def _kernel_rules(steps, masks, tz, c8, r, c, geom):
    """What the kernel decides for rows (tz, c8 [R, 8, 8], CTU rows and
    columns r, c [R]): {(n, oy, ox): (luma fire, luma availability,
    chroma fire [2R], chroma availability [2R])}, steps without a firing
    row left out."""
    out = {}
    for n, oy, ox, leaf_l, rule, off_l, off_c, _ in steps:
        sy, sx = oy // 8, ox // 8
        leaf, coded = tz[:, sy, sx], c8[:, sy, sx]
        lum = coded & (leaf == leaf_l)
        lg = int(n).bit_length() - 1
        chro = coded & ((leaf == lg) if rule == 1 else (leaf <= 3)
                        if rule == 2 else np.zeros_like(coded))

        def avail(oy, ox, n, off, cy, cx, h, w):
            dy, dx = ctu.boundary_offsets(n)
            fy = cy[:, None] + oy + dy
            fx = cx[:, None] + ox + dx
            inside = (fy >= 0) & (fx >= 0) & (fy < h) & (fx < w)
            return inside & (masks[off: off + 4 * n + 1] != 0)

        la = avail(oy, ox, n, off_l, r * 64, c * 64, geom.h, geom.w)
        ca = (avail(oy // 2, ox // 2, n // 2, off_c, np.tile(r * 32, 2),
                    np.tile(c * 32, 2), geom.h // 2, geom.w // 2)
              if rule else None)
        if lum.any() or chro.any():
            out[int(n), int(oy), int(ox)] = (lum, la, np.tile(chro, 2), ca)
    return out


def test_kernel_fire_rules_equal_the_plan():
    """At 240x416 x 2 (class D: edge CTUs 48 rows tall and 32 wide) on
    random leaf-size and coded-slot maps: per diagonal and step, the
    table's luma and chroma firing rows and their availability equal the
    planned form's (_stage2_plan)."""
    geom = tenc.Geometry(240, 416)
    rng = np.random.default_rng(0)
    shape = (2, geom.rc, geom.cc, 8, 8)
    tz = rng.choice([2, 3, 4, 5], shape).astype(np.int32)
    c8 = rng.random(shape) < 0.9
    steps, masks = tenc._kernel_schedule()
    upload = tenc._Upload()
    plan = tenc._stage2_plan(geom, geom.wavefront, tz, c8, upload)
    upload.upload(torch.device("cpu"))
    checked = 0
    for idx, planned in plan:
        bi, r, c = (a.numpy() for a in upload.get(idx))
        mine = _kernel_rules(steps, masks, tz[bi, r, c], c8[bi, r, c], r, c,
                             geom)
        assert list(mine) == [(n, oy, ox) for n, oy, ox, *_ in planned]
        for n, oy, ox, lstep, cstep in planned:
            lum, la, chro, ca = mine[n, oy, ox]
            if lstep:
                fire, av = (upload.get(h).numpy() for h in lstep)
                np.testing.assert_array_equal(lum, fire)
                np.testing.assert_array_equal(la, av)
                checked += 1
            else:
                assert not lum.any()
            if cstep:
                fire, av = (upload.get(h).numpy() for h in cstep)
                np.testing.assert_array_equal(chro, fire)
                np.testing.assert_array_equal(ca, av)
                checked += 1
            elif n > 4:
                assert not chro.any()
    assert checked > 1000


# ---------------------------------------------------------------------------
# The kernel's source on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/stage2_ctu.cu built for the host (g++, no fused multiply-add)
    with tests/cuda_host/warp.h: stage2_ctu_host(args) runs every block of
    a launch in turn."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("stage2_host")
    (d / "cuda_runtime.h").write_text(
        f'#include "{ROOT}/tests/cuda_host/warp.h"\n')
    (d / "main.cpp").write_text(
        '#include "cuda_runtime.h"\n'
        f'#include "{stage2_ctu._SOURCE}"\n'
        'extern "C" int stage2_ctu_args_size() {\n'
        '  return (int)sizeof(Stage2Args); }\n'
        'extern "C" void stage2_ctu_host(const Stage2Args* a) {\n'
        '  host_launch(3 * a->rows, [a] { stage2_ctu_kernel(*a); }); }\n')
    so = d / "stage2_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{d}", "-o", str(so), str(d / "main.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.stage2_ctu_host.argtypes = [ctypes.POINTER(stage2_ctu.Args)]
    assert lib.stage2_ctu_args_size() == ctypes.sizeof(stage2_ctu.Args)
    return lib


def _kernel_stage2(lib, enc, args):
    """Stage 2 of the reconstruction arguments `args` with the kernel
    between the eager _open and _close, as the card runs it: the 13
    planes."""
    yp, up, vp, msl, cm8, tz, c8, mm4, qp_map = args
    inputs = dict(y=tenc.to_blocked(yp, 64), u=tenc.to_blocked(up, 32),
                  v=tenc.to_blocked(vp, 32), tz=tz, c8=c8, msl=msl, cm8=cm8,
                  mm4=mm4)
    if qp_map is not None:
        inputs["qp_map"] = qp_map
    wf = tenc._Wavefront(enc, yp.shape[0], torch.device("cpu"))
    for k, v in inputs.items():
        wf._put("in_" + k, v)
    kargs = None
    for _ in range(wf.diagonals):
        wf._open()
        if kargs is None:
            kargs = stage2_ctu.make_args(
                wf.buf, wf.qps, rows=wf.b * wf.a,
                hw=(enc.geom.h, enc.geom.w), rate_qps=(enc.qp, enc.qp_c),
                sbh=enc.sbh, tu4=enc.nxn or enc.tu_split,
                schedule=tenc._kernel_schedule)
        lib.stage2_ctu_host(ctypes.byref(kargs))
        wf._close()
    return {k: tenc.from_blocked(t[:, : wf.rc]) for k, t in wf.state.items()}


def _random_args(enc, rng, leaves, qp_map: bool):
    """Random source planes (smooth rows: a random walk, where RDOQ's
    and SBH's decisions are close), leaf-size map (values from
    `leaves`), modes and coded slots (inside the picture, a few left out)
    for one frame; with qp_map a random per-CTU map over QPs 0-51."""
    g = enc.geom

    def ints(lo, hi, shape):
        return torch.as_tensor(rng.integers(lo, hi, shape), dtype=torch.int32)

    def plane(h, w):
        walk = np.cumsum(rng.integers(-4, 5, (1, h, w)), axis=-1) + 128
        return torch.as_tensor(np.clip(walk, 0, 255), dtype=torch.int32)

    bh, bw = (torch.as_tensor(x) for x in g.bh_bw)
    _, inside = ctu.derive_slot_depths(
        torch.zeros((1, g.rc, g.cc, 16), dtype=torch.int32),
        bh[None, :, None], bw[None, None, :])
    slots = (1, g.rc, g.cc, 8, 8)
    return (plane(g.hp, g.wp), plane(g.hp // 2, g.wp // 2),
            plane(g.hp // 2, g.wp // 2),
            ints(0, 35, slots), ints(0, 35, slots),
            torch.as_tensor(rng.choice(leaves, slots), dtype=torch.int32),
            inside & torch.as_tensor(rng.random(slots) < 0.95),
            ints(0, 35, (1, g.rc, g.cc, 16, 16)),
            ints(0, 52, (1, g.rc, g.cc)) if qp_map else None)


KERNEL_CASES = {
    "tu4_leaves": (dict(), [2], False),
    "mixed_qp_map": (dict(), [2, 3, 4, 5], True),
    "rdoq_off": (dict(rdoq=False), [2, 3, 4, 5], False),
    "sbh_ts_off": (dict(sbh=False, ts=False), [2, 3, 4, 5], False),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_source_equals_planned(host_kernel, case):
    """72x136 x 1 (partial CTUs on both edges), QP 30."""
    switches, leaves, qp_map = KERNEL_CASES[case]
    enc = tenc.FrameEncoder(72, 136, 30, device="cpu", **switches)
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(case))
    args = _random_args(enc, rng, leaves, qp_map)
    want = enc._reconstruct_planned(*args)
    got = _kernel_stage2(host_kernel, enc, args)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert want["levels_y"].any() and want["cbf_u"].any()
    if case == "tu4_leaves":
        assert want["ts4_y"].any() and want["ts8_u"].any()
