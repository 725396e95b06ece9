"""Stage 1's candidate-RD kernel (csrc/stage1_rd.cu, ops/stage1_rd.py) on
the CPU.

The wrapper's tables are the plain version's functions (transform
matrices, angular tables and filter flags, the rate estimate's scans,
weights and last-position bits, the quantiser scales, the grid's
availability), laid out where the struct points. The library's name
hashes the headers its source includes. CPU tensors and the context rate
model take the plain path (_dense_rd_plain) and launch nothing; the
wrapper refuses what the kernel does not take.

The kernel's source itself, built for the host with g++ (its warp run as
32 fibers, tests/cuda_host/warp.h), gives _dense_rd_plain's costs bit for
bit: every size, luma and chroma, K of 1, 5, 6 and 11 (two candidates a
warp at 4x4, the last one alone where K is odd), QPs 22 to 51, boundaries
read from another plane, and a picture whose bottom CTU row is cut (the
grid's availability at the edge). The card runs the same source built by
nvcc (tests/test_torch_stage1_card.py)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hevctpu_torch import rom
from hevctpu_torch.ops import _nvcc, intra, rate, stage1_rd, transforms
from hevctpu_torch.pipeline import encoder as tenc
from hevctpu_torch.pipeline import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Tables and the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_luma", [True, False])
@pytest.mark.parametrize("n", stage1_rd.SIZES)
def test_tables_are_the_plain_functions(n, is_luma):
    """Each table equals the function the plain version calls, and the
    struct _tables fills points at it inside the uploaded buffer."""
    lg = n.bit_length() - 1
    for qp in (0, 22, 32, 37, 51):
        t = stage1_rd.tables_np(n, is_luma, qp)
        assert list(t) == list(stage1_rd.TABLES)
        w = rate.bin_weights(qp)
        np.testing.assert_array_equal(
            t["mat"].reshape(n, n),
            transforms._mat_np(lg, is_luma and n == 4, False))
        np.testing.assert_array_equal(
            t["weights"], [w[k] for k in rate._W_FIELDS])
        np.testing.assert_array_equal(t["last_bits"],
                                      rate._last_pos_bits(n, w["last"]))
        np.testing.assert_array_equal(t["quant_scale"], rom.QUANT_SCALES)
        np.testing.assert_array_equal(t["inv_scale"], rom.INV_QUANT_SCALES)
    pos = rate._scan_pos(n).reshape(-1)
    np.testing.assert_array_equal(t["diag_pos"], pos)
    np.testing.assert_array_equal(t["diag_idx"][pos], np.arange(n * n))
    if n > 4:
        np.testing.assert_array_equal(t["cg_pos"],
                                      rate._scan_pos(n // 4).reshape(-1))
    for k, a in zip(("ang_src", "ang_idx", "ang_didx", "ang_fact"),
                    intra._angular_tables(n)):
        np.testing.assert_array_equal(t[k], a.reshape(-1))
    np.testing.assert_array_equal(
        t["filter"], intra._filter_flags(n) if is_luma else np.zeros(35))
    # the struct's pointers, read back from the buffer they point into
    buf, tab = stage1_rd._tables(torch.device("cpu"), n, is_luma, 51)
    for k in stage1_rd.TABLES:
        a = t[k]
        got = np.ctypeslib.as_array(
            (ctypes.c_int32 * a.size).from_address(getattr(tab, k)))
        np.testing.assert_array_equal(got, a)
        assert buf.data_ptr() <= getattr(tab, k) < buf.data_ptr() + \
            4 * buf.numel()


def test_library_is_keyed_on_the_headers(tmp_path):
    """A library's name hashes its source and the headers it includes in
    quotes, so that an edited header builds anew; the two kernels that
    share intra_tu.cuh both list it."""
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    src = tmp_path / "k.cu"
    assert _nvcc.sources(src) == [src, tmp_path / "a.cuh", tmp_path / "b.cuh"]
    flags = stage1_rd._NVCC_FLAGS
    before = _nvcc.library_path(src, flags)
    (tmp_path / "b.cuh").write_text("// two\n")
    assert _nvcc.library_path(src, flags) != before
    assert before.name.startswith("k_")
    for kernel in (stage1_rd._SOURCE, _nvcc.CSRC / "stage2_ctu.cu"):
        assert _nvcc.sources(kernel)[1:] == [_nvcc.CSRC / "intra_tu.cuh"]
    assert _nvcc.sources(_nvcc.CSRC / "satd_fused.cu") == [
        _nvcc.CSRC / "satd_fused.cu"]


@pytest.mark.parametrize("n,scale", [(4, 1), (16, 1), (8, 2), (32, 2)])
def test_availability_is_the_grids(n, scale):
    """The availability the kernel reads is _grid_avail's, byte for
    byte, in its [R, C, 4n+1] layout, for a 56-line bottom CTU row."""
    geom = tenc.Geometry(120, 192)
    av = tenc._grid_avail_t(geom, n, scale, torch.device("cpu"))
    want = tenc._grid_avail(geom, n, scale)
    assert av.dtype == torch.bool and av.is_contiguous()
    assert tuple(av.shape) == (geom.hp // scale // n, geom.wp // scale // n,
                               4 * n + 1)
    np.testing.assert_array_equal(av.numpy(), want)


def _inputs(rng, geom, n, k, scale=1, batch=2):
    """(plane, bsrc, cand): smooth random planes with noise (a random walk
    along the rows), another plane for the boundaries, and K random modes a
    position (chroma: the list modes and 34)."""
    hp, wp = geom.hp // scale, geom.wp // scale

    def plane():
        walk = np.cumsum(rng.integers(-6, 7, (batch, hp, wp)), axis=-1)
        noise = rng.integers(-20, 21, (batch, hp, wp))
        return torch.as_tensor(np.clip(128 + walk + noise, 0, 255),
                               dtype=torch.int32)

    modes = rng.integers(0, 35, (batch, hp // n, wp // n, k))
    return plane(), plane(), torch.as_tensor(modes, dtype=torch.int32)


def test_cpu_and_ctx_take_the_plain_path():
    """On CPU tensors _dense_rd_candidates is _dense_rd_plain under either
    rate model, and launches nothing; the kernel's entry refuses them."""
    geom = tenc.Geometry(64, 64)
    plane, bsrc, cand = _inputs(np.random.default_rng(0), geom, 8, 3)
    before, launches = trace.counters(), stage1_rd.LAUNCHES
    for rm in ("global", "ctx"):
        got = tenc._dense_rd_candidates(plane, geom, 8, cand, 32, 30.0,
                                        bsrc=bsrc, rate_model=rm)
        want = tenc._dense_rd_plain(plane, geom, 8, cand, 32, 30.0,
                                    bsrc=bsrc, rate_model=rm)
        assert torch.equal(got, want)
    assert trace.counters()["stage1.rd_kernel_launches"] == \
        before["stage1.rd_kernel_launches"]
    assert stage1_rd.LAUNCHES == launches
    avail = tenc._grid_avail_t(geom, 8, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="runs on cuda"):
        stage1_rd.rd_costs(plane, bsrc, avail, cand, 8, 32, 30.0,
                           is_luma=True)


def test_make_args_refuses_what_the_kernel_does_not_take():
    geom = tenc.Geometry(64, 128)
    plane, bsrc, cand = _inputs(np.random.default_rng(1), geom, 8, 3)
    avail = tenc._grid_avail_t(geom, 8, 1, torch.device("cpu"))
    out = torch.empty(cand.shape, dtype=torch.float32)
    ok = dict(plane=plane, bsrc=bsrc, avail=avail, cand=cand, out=out)
    stage1_rd.make_args(*ok.values(), 8, 32, 30.0, is_luma=True)
    bad = [dict(plane=plane.to(torch.int64)),
           dict(bsrc=bsrc[:1]),
           dict(avail=avail[:, :, :-1]),
           dict(cand=cand.transpose(1, 2).contiguous()),
           dict(cand=cand.movedim(-1, 1).contiguous().movedim(1, -1)),
           dict(out=out.to(torch.float64))]
    for change in bad:
        with pytest.raises(ValueError):
            stage1_rd.make_args(*{**ok, **change}.values(), 8, 32, 30.0,
                                is_luma=True)
    with pytest.raises(ValueError):
        stage1_rd.make_args(*ok.values(), 64, 32, 30.0, is_luma=True)
    with pytest.raises(ValueError):
        stage1_rd.make_args(*ok.values(), 8, torch.tensor(32), 30.0,
                            is_luma=True)


# ---------------------------------------------------------------------------
# The kernel's source on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/stage1_rd.cu built for the host (g++, no fused multiply-add)
    with tests/cuda_host/warp.h: stage1_rd_host(args) runs every block of
    a launch in turn, a warp a block."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("stage1_host")
    (d / "cuda_runtime.h").write_text(
        f'#include "{ROOT}/tests/cuda_host/warp.h"\n')
    (d / "main.cpp").write_text(
        '#include "cuda_runtime.h"\n'
        f'#include "{stage1_rd._SOURCE}"\n'
        'extern "C" int stage1_rd_args_size() {\n'
        '  return (int)sizeof(Stage1Args); }\n'
        'template <int N> void run(const Stage1Args& b) {\n'
        '  host_launch(b.batch * (b.hp / N) * (b.wp / N),\n'
        '              [&b] { stage1_rd_kernel<N>(b); }); }\n'
        'extern "C" void stage1_rd_host(const Stage1Args* a) {\n'
        '  Stage1Args b = *a;\n'
        '  b.warps = 1;\n'
        '  if (b.n == 4) run<4>(b);\n'
        '  if (b.n == 8) run<8>(b);\n'
        '  if (b.n == 16) run<16>(b);\n'
        '  if (b.n == 32) run<32>(b); }\n')
    so = d / "stage1_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{d}", "-o", str(so), str(d / "main.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.stage1_rd_host.argtypes = [ctypes.POINTER(stage1_rd.Args)]
    assert lib.stage1_rd_args_size() == ctypes.sizeof(stage1_rd.Args)
    return lib


def _host_rd(lib, plane, bsrc, geom, n, cand, qp, lam, *, is_luma, scale):
    avail = tenc._grid_avail_t(geom, n, scale, torch.device("cpu"))
    out = torch.full(cand.shape, float("nan"), dtype=torch.float32)
    args = stage1_rd.make_args(plane, bsrc, avail, cand, out, n, qp, lam,
                               is_luma=is_luma)
    lib.stage1_rd_host(ctypes.byref(args))
    return out


# (n, luma, K, QP, picture): two sizes a case, one frame or two
KERNEL_CASES = {
    "luma4_k11": (4, True, 11, 32, (64, 64)),
    "luma4_k1_qp22": (4, True, 1, 22, (64, 64)),
    "luma8_k11_qp37": (8, True, 11, 37, (120, 128)),
    "luma16_k6_qp27": (16, True, 6, 27, (64, 128)),
    "luma32_k6_qp51": (32, True, 6, 51, (120, 128)),
    "luma32_k1_qp22": (32, True, 1, 22, (64, 64)),
    "chroma4_k5_qp37": (4, False, 5, 37, (120, 128)),
    "chroma8_k5_qp22": (8, False, 5, 22, (64, 128)),
    "chroma16_k5_qp32": (16, False, 5, 32, (64, 64)),
    "chroma32_k5_qp27": (32, False, 5, 27, (128, 128)),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernel_source_equals_plain(host_kernel, case):
    n, is_luma, k, qp, (h, w) = KERNEL_CASES[case]
    geom = tenc.Geometry(h, w)
    scale = 1 if is_luma else 2
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(case))
    plane, bsrc, cand = _inputs(rng, geom, n, k, scale)
    lam = rate.lambda_rd(qp)
    for src in (bsrc, plane):
        want = tenc._dense_rd_plain(plane, geom, n, cand, qp, lam,
                                    is_luma=is_luma, scale=scale, bsrc=src,
                                    rate_model="global")
        got = _host_rd(host_kernel, plane, src, geom, n, cand, qp, lam,
                       is_luma=is_luma, scale=scale)
        assert torch.equal(got, want), (got - want).abs().max()
    assert (want > 0).all()
