"""Stage 1's candidate RD kernel: one launch a call of
pipeline/encoder.py's _dense_rd_candidates under rate_model="global", a
warp a position coding each of its candidate modes in shared memory
(csrc/stage1_rd.cu; its header says what bounds it and how it is laid
out).

It replaces no TPU kernel (the JAX package's candidate RD is XLA code);
it takes the place of encoder._dense_rd_plain, the aten path that runs on
the CPU and under rate_model="ctx": the references of every position, all
35 modes predicted by one matmul and the candidates gathered, then
rd.mode_rd_costs, in row chunks. Built with nvcc into a shared library at
first use (ops/_nvcc.py), as K1 and the stage-2 kernel are, and called
through ctypes on PyTorch's current stream: no host sync; the output is
the one allocation.

_dense_rd_plain is its plain version; a CUDA tensor under "global"
launches the kernel or raises, with no fallback. Every table it reads
comes from the Python functions that plain version uses (tables_np),
uploaded once per device, size, plane kind and QP.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from hevctpu_torch import device_table, rom
from hevctpu_torch.ops import _nvcc, intra, rate, transforms
from hevctpu_torch.pipeline import trace

# Kernel launches since import: the proof that a run went through the
# kernel. Encoders launch it from their dispatch worker threads, so the
# count and the first build are taken under locks.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()

_SOURCE = _nvcc.CSRC / "stage1_rd.cu"
# --fmad=false: torch rounds a product before it adds, so must the kernel
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")

SIZES = (4, 8, 16, 32)
MAX_CANDIDATES = 35

_P = ctypes.c_void_p
TABLES = ("mat", "ang_src", "ang_idx", "ang_didx", "ang_fact", "filter",
          "diag_pos", "diag_idx", "cg_pos", "last_bits", "weights",
          "quant_scale", "inv_scale")


class Tables(ctypes.Structure):
    """csrc/stage1_rd.cu's Stage1Tables: device pointers into the
    uploaded tables, in TABLES' order."""
    _fields_ = [(k, _P) for k in TABLES]


class Args(ctypes.Structure):
    """csrc/stage1_rd.cu's Stage1Args."""
    _fields_ = [("plane", _P), ("bsrc", _P), ("avail", _P), ("cand", _P),
                ("out", _P), ("batch", ctypes.c_int), ("hp", ctypes.c_int),
                ("wp", ctypes.c_int), ("n", ctypes.c_int),
                ("k", ctypes.c_int), ("qp", ctypes.c_int),
                ("luma", ctypes.c_int), ("warps", ctypes.c_int),
                ("lam_u", ctypes.c_float), ("tab", Tables)]


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def tables_np(n: int, is_luma: bool, qp: int) -> dict:
    """Every table the kernel reads at size n for a luma or chroma plane
    and a static QP, as named int32 arrays in TABLES' order, from the
    functions of the plain version: the forward matrix
    (transforms.forward_transform's: the DST at luma 4x4), the angular
    tables and filter flags (intra; no filtering for chroma), the diagonal
    scan of rate.estimate_tu_bits and its inverse, the groups' scan, the
    QP's weights (rate.bin_weights) and last-position bits, and the
    quantiser scales."""
    if n not in SIZES:
        raise ValueError(f"the stage 1 kernel takes n in {SIZES}, got {n}")
    lg = n.bit_length() - 1
    src, idx, didx, fact = intra._angular_tables(n)
    dpos = rate._scan_pos(n)
    order = np.zeros(n * n, np.int64)
    order[dpos.reshape(-1)] = np.arange(n * n)
    w = rate.bin_weights(qp)
    t = {"mat": transforms._mat_np(lg, is_luma and n == 4, False),
         "ang_src": src, "ang_idx": idx, "ang_didx": didx,
         "ang_fact": fact,
         "filter": (intra._filter_flags(n) if is_luma
                    else np.zeros(35, bool)),
         "diag_pos": dpos, "diag_idx": order,
         "cg_pos": rate._scan_pos(n // 4) if n > 4 else np.zeros(1),
         "last_bits": rate._last_pos_bits(n, w["last"]),
         "weights": np.array([w[k] for k in rate._W_FIELDS]),
         "quant_scale": rom.QUANT_SCALES,
         "inv_scale": rom.INV_QUANT_SCALES}
    out = {}
    for k in TABLES:
        a = np.asarray(t[k])
        if a.size and (a.min() < -2 ** 31 or a.max() >= 2 ** 31):
            raise ValueError(f"table {k} does not fit int32")
        out[k] = np.ascontiguousarray(a, dtype=np.int32).reshape(-1)
    return out


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, n: int, is_luma: bool, qp: int):
    """(buffer, Tables) on device: tables_np packed into one int32 tensor
    (kept alive with the struct that points into it)."""
    arrays = tables_np(n, is_luma, qp)
    buf = device_table(np.concatenate(list(arrays.values())), device,
                       torch.int32)
    tab, off = Tables(), 0
    for k, a in arrays.items():
        setattr(tab, k, buf.data_ptr() + 4 * off)
        off += a.size
    return buf, tab


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def build() -> tuple[float, str]:
    """Compile csrc/stage1_rd.cu into csrc/_build/ unless the library for
    this source, its headers and these flags exists: the seconds spent and
    what ptxas reported (_nvcc.build)."""
    return _nvcc.build(_SOURCE, _NVCC_FLAGS)


def _lib() -> ctypes.CDLL:
    with _LIB_LOCK:
        return _load_lib()


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(_nvcc.library_path(_SOURCE, _NVCC_FLAGS)))
    lib.stage1_rd_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    lib.stage1_rd_launch.restype = ctypes.c_int
    lib.stage1_rd_error_string.argtypes = [ctypes.c_int]
    lib.stage1_rd_error_string.restype = ctypes.c_char_p
    if lib.stage1_rd_args_size() != ctypes.sizeof(Args):
        raise RuntimeError("csrc/stage1_rd.cu's Stage1Args is laid out "
                           "unlike ops/stage1_rd.Args")
    return lib


def _count_launch():
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1
    trace.count("stage1.rd_kernel_launches")


# ---------------------------------------------------------------------------
# Arguments and launch
# ---------------------------------------------------------------------------


def make_args(plane: torch.Tensor, bsrc: torch.Tensor, avail: torch.Tensor,
              cand: torch.Tensor, out: torch.Tensor, n: int, qp: int,
              lam: float, *, is_luma: bool) -> Args:
    """The kernel's arguments: planes and boundary planes [B, hp, wp]
    int32, the grid's availability [hp/n, wp/n, 4n+1] bool, candidates
    [B, hp/n, wp/n, K] int32 and the output of that shape, float32, all
    contiguous on one device; a static QP and λ (a Python float). Raises
    on anything else."""
    if n not in SIZES:
        raise ValueError(f"the stage 1 kernel takes n in {SIZES}, got {n}")
    b, hp, wp = plane.shape
    r, c, k = hp // n, wp // n, cand.shape[-1]
    want = {"plane": (plane, torch.int32, (b, hp, wp)),
            "bsrc": (bsrc, torch.int32, (b, hp, wp)),
            "avail": (avail, torch.bool, (r, c, 4 * n + 1)),
            "cand": (cand, torch.int32, (b, r, c, k)),
            "out": (out, torch.float32, (b, r, c, k))}
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != plane.device or not t.is_contiguous()):
            raise ValueError(f"stage 1 kernel: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, not {dtype} "
                             f"{shape} on {plane.device}")
    if hp % n or wp % n or not 1 <= k <= MAX_CANDIDATES:
        raise ValueError(f"stage 1 kernel: {hp}x{wp} planes at n={n} with "
                         f"{k} candidates")
    if not isinstance(qp, (int, np.integer)) or not 0 <= qp <= 51:
        raise ValueError(f"stage 1 kernel: QP {qp!r} is not a static QP")
    args = Args(plane=plane.data_ptr(), bsrc=bsrc.data_ptr(),
                avail=avail.data_ptr(), cand=cand.data_ptr(),
                out=out.data_ptr(), batch=b, hp=hp, wp=wp, n=n, k=k,
                qp=int(qp), luma=int(is_luma),
                lam_u=np.float32(lam / rate.BITS_ONE))
    # the tables' buffer lives in _tables' cache, as long as the process
    args.tab = _tables(plane.device, n, bool(is_luma), int(qp))[1]
    return args


def rd_costs(plane: torch.Tensor, bsrc: torch.Tensor, avail: torch.Tensor,
             cand: torch.Tensor, n: int, qp: int, lam: float, *,
             is_luma: bool) -> torch.Tensor:
    """Residual RD cost [B, R, C, K] float32 of the candidate modes cand at
    every aligned n x n position of plane, boundaries read from bsrc with
    the availability avail (make_args's types), on the card's current
    stream: _dense_rd_candidates's result under "global". Raises if the
    tensors are not on a card or the launch fails. Counts
    stage1.rd_kernel_launches."""
    if plane.device.type != "cuda":
        raise ValueError(f"the stage 1 kernel runs on cuda, not "
                         f"{plane.device}")
    out = torch.empty(cand.shape, dtype=torch.float32, device=plane.device)
    args = make_args(plane, bsrc, avail, cand, out, n, qp, lam,
                     is_luma=is_luma)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = lib.stage1_rd_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError("stage 1 kernel launch failed: "
                           + lib.stage1_rd_error_string(rc).decode())
    _count_launch()
    return out
