"""Stage 2's kernel: one launch a wavefront diagonal, a block a CTU and
plane coding only its own TUs (csrc/stage2_ctu.cu; its header says what
bounds it and how it is laid out).

It replaces no TPU kernel (the JAX package's stage 2 is XLA code); it
takes the place of the masked TU schedule that pipeline/encoder.py's
_Wavefront replays as CUDA graphs of aten kernels (_quad, _block),
between the diagonal's gather and scatter graphs (_open, _close), whose
static buffers it reads and writes in place. Built with nvcc into a
shared library at first use (ops/_nvcc.py), as K1 is, and called
through ctypes on PyTorch's current stream: no host sync, no
allocation.

Its plain version is the eager _Wavefront on the CPU; on the card a
diagonal launches the kernel or raises, with no fallback. Every table it
reads comes from the Python functions that plain version uses (tables_np),
uploaded once per device and rate QPs.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from hevctpu_torch import device_table, rom
from hevctpu_torch.ops import _nvcc, intra, quant, rate, transforms
from hevctpu_torch.pipeline import trace

_SOURCE = _nvcc.CSRC / "stage2_ctu.cu"
# --fmad=false: torch rounds a product before it adds, so must the kernel
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")
_LIB_LOCK = threading.Lock()

SIZES = (4, 8, 16, 32)
STEP_WORDS = 8                 # csrc/stage2_ctu.cu kStepWords

_P = ctypes.c_void_p
_I2 = ctypes.c_int * 2
_F2 = ctypes.c_float * 2


class Tables(ctypes.Structure):
    """csrc/stage2_ctu.cu's Stage2Tables: device pointers into the
    uploaded tables."""
    _fields_ = [("dct", _P * 4), ("dst4", _P), ("scan_idx", _P * 4),
                ("scan_pos", _P * 4), ("diag_pos", _P * 4),
                ("diag_idx", _P * 4), ("cg_pos", _P * 4),
                ("last_bits", (_P * 4) * 2), ("weights", _P * 2),
                ("pos_in_cg", _P), ("quant_scale", _P), ("inv_scale", _P),
                ("ang_src", _P * 4), ("ang_idx", _P * 4),
                ("ang_didx", _P * 4), ("ang_fact", _P * 4),
                ("filter", _P * 4), ("steps", _P), ("avail", _P),
                ("n_steps", ctypes.c_int)]


# csrc/stage2_ctu.cu's Stage2Args: the buffers in order, then the rest
BUFFERS = ("ext_y", "ext_c", "oyl", "ouv", "tz", "c8", "msl", "cm8", "mm4",
           "mk", "ctu_y", "ctu_x", "ctu_yc", "ctu_xc", "vy", "vc", "cy8",
           "cc8", "tc8", "cy4", "ty4")


class Args(ctypes.Structure):
    _fields_ = [(k, _P) for k in BUFFERS] + [
        ("qp_rows", _P * 2), ("rdoq_rows", _P * 2), ("ts_rows", _P * 2),
        ("qp", _I2), ("rdoq_lam_u", _F2), ("rdoq_csbf", _F2),
        ("rdoq_cbf0", _F2), ("ts_lam_u", _F2), ("rdoq_on", _I2),
        ("ts_on", _I2), ("rows", ctypes.c_int), ("h", ctypes.c_int),
        ("w", ctypes.c_int), ("sbh", ctypes.c_int), ("tu4", ctypes.c_int),
        ("tab", Tables)]


# dtype and shape after the row axis of each buffer (R rows, 2R chroma)
_LAYOUT = {"ext_y": (torch.int32, 1, (97, 130)),
           "ext_c": (torch.int32, 2, (49, 66)),
           "oyl": (torch.int32, 1, (64, 64)),
           "ouv": (torch.int32, 2, (32, 32)),
           "tz": (torch.int32, 1, (8, 8)), "c8": (torch.bool, 1, (8, 8)),
           "msl": (torch.int32, 1, (8, 8)), "cm8": (torch.int32, 1, (8, 8)),
           "mm4": (torch.int32, 1, (16, 16)), "mk": (torch.bool, 1, ()),
           "ctu_y": (torch.int64, 1, ()), "ctu_x": (torch.int64, 1, ()),
           "ctu_yc": (torch.int64, 2, ()), "ctu_xc": (torch.int64, 2, ()),
           "vy": (torch.int32, 1, (64, 64)), "vc": (torch.int32, 2, (32, 32)),
           "cy8": (torch.bool, 1, (8, 8)), "cc8": (torch.bool, 2, (8, 8)),
           "tc8": (torch.bool, 2, (8, 8)), "cy4": (torch.bool, 1, (16, 16)),
           "ty4": (torch.bool, 1, (16, 16))}


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


def tables_np(steps: np.ndarray, avail: np.ndarray,
              rate_qps: tuple[int, int]) -> dict:
    """Every table the kernel reads, as named int32 arrays, from the
    functions of the plain version: steps [S, STEP_WORDS] and avail, the
    schedule and its decoded-before masks (pipeline/encoder.py,
    _kernel_schedule); rate_qps the luma and chroma rate QPs (the static
    slice QPs that rate.bin_weights reads)."""
    t = {}
    for n in SIZES:
        lg = n.bit_length() - 1
        t[f"dct{n}"] = transforms._mat_np(lg, False, False)
        pos, idx = quant._tb_scan_tables(lg)
        t[f"scan_idx{n}"], t[f"scan_pos{n}"] = idx, pos
        dpos = rate._scan_pos(n)
        t[f"diag_pos{n}"] = dpos
        order = np.zeros(n * n, np.int64)
        order[dpos.reshape(-1)] = np.arange(n * n)
        t[f"diag_idx{n}"] = order
        t[f"cg_pos{n}"] = rate._scan_pos(n // 4) if n > 4 else np.zeros(1)
        src, aidx, didx, fact = intra._angular_tables(n)
        t[f"ang_src{n}"], t[f"ang_idx{n}"] = src, aidx
        t[f"ang_didx{n}"], t[f"ang_fact{n}"] = didx, fact
        t[f"filter{n}"] = intra._filter_flags(n)
    t["dst4"] = transforms._mat_np(2, True, False)
    for p, qp in enumerate(rate_qps):
        w = rate.bin_weights(qp)
        t[f"weights{p}"] = np.array([w[k] for k in rate._W_FIELDS])
        for n in SIZES:
            t[f"last_bits{p}_{n}"] = rate._last_pos_bits(n, w["last"])
    t["pos_in_cg"] = quant._pos_in_cg()
    t["quant_scale"] = rom.QUANT_SCALES
    t["inv_scale"] = rom.INV_QUANT_SCALES
    t["steps"], t["avail"] = steps, avail
    out = {}
    for k, a in t.items():
        a = np.asarray(a)
        if a.size and (a.min() < -2 ** 31 or a.max() >= 2 ** 31):
            raise ValueError(f"table {k} does not fit int32")
        out[k] = np.ascontiguousarray(a, dtype=np.int32).reshape(-1)
    if out["steps"].size % STEP_WORDS:
        raise ValueError("a schedule entry has STEP_WORDS words")
    return out


def _struct(arrays: dict, base: int) -> Tables:
    """Tables pointing into one buffer at `base` that holds `arrays`
    one after another, in order."""
    off, at = 0, {}
    for k, a in arrays.items():
        at[k] = base + 4 * off
        off += a.size
    tab = Tables()
    for n_i, n in enumerate(SIZES):
        for f in ("dct", "scan_idx", "scan_pos", "diag_pos", "diag_idx",
                  "cg_pos", "ang_src", "ang_idx", "ang_didx", "ang_fact",
                  "filter"):
            getattr(tab, f)[n_i] = at[f"{f}{n}"]
        for p in range(2):
            tab.last_bits[p][n_i] = at[f"last_bits{p}_{n}"]
    for p in range(2):
        tab.weights[p] = at[f"weights{p}"]
    for f in ("dst4", "pos_in_cg", "quant_scale", "inv_scale", "steps",
              "avail"):
        setattr(tab, f, at[f])
    tab.n_steps = arrays["steps"].size // STEP_WORDS
    return tab


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, rate_qps: tuple[int, int], schedule):
    """(buffer, Tables) on device: tables_np packed into one int32
    tensor (kept alive with the struct that points into it)."""
    arrays = tables_np(*schedule(), rate_qps)
    buf = device_table(np.concatenate(list(arrays.values())), device,
                       torch.int32)
    return buf, _struct(arrays, buf.data_ptr())


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def build() -> tuple[float, str]:
    """Compile csrc/stage2_ctu.cu into csrc/_build/ unless the library for
    this source and these flags exists: the seconds spent and what ptxas
    reported (_nvcc.build)."""
    return _nvcc.build(_SOURCE, _NVCC_FLAGS)


def _lib() -> ctypes.CDLL:
    with _LIB_LOCK:
        return _load_lib()


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(_nvcc.library_path(_SOURCE, _NVCC_FLAGS)))
    lib.stage2_ctu_launch.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]
    lib.stage2_ctu_launch.restype = ctypes.c_int
    lib.stage2_ctu_error_string.argtypes = [ctypes.c_int]
    lib.stage2_ctu_error_string.restype = ctypes.c_char_p
    if lib.stage2_ctu_args_size() != ctypes.sizeof(Args):
        raise RuntimeError("csrc/stage2_ctu.cu's Stage2Args is laid out "
                           "unlike ops/stage2_ctu.Args")
    return lib


# ---------------------------------------------------------------------------
# Arguments and launch
# ---------------------------------------------------------------------------


def make_args(buf: dict, qps: tuple, *, rows: int, hw: tuple[int, int],
              rate_qps: tuple[int, int], sbh: bool, tu4: bool,
              schedule) -> Args:
    """The kernel's arguments for a _Wavefront's static buffers `buf`
    (R = rows CTU rows) and quantiser settings qps = (luma QP, chroma QP,
    RDOQ λ luma, chroma, TS λ luma, chroma), each a static scalar or a
    per-row tensor (FrameEncoder._ctu_qps's order); hw the luma picture
    size; schedule the function giving (steps, avail). Raises on a buffer
    of another dtype, shape or device, or not contiguous."""
    dev = buf["ext_y"].device
    args = Args()
    for k in BUFFERS:
        dtype, mult, shape = _LAYOUT[k]
        t = buf[k]
        if (t.dtype != dtype or tuple(t.shape) != (mult * rows,) + shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"stage 2 kernel: buffer {k} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, not {dtype} "
                             f"{(mult * rows,) + shape} on {dev}")
        setattr(args, k, t.data_ptr())
    qp_l, qp_c, rl_y, rl_c, tl_y, tl_c = qps
    for p, (qp, rl, tl) in enumerate(((qp_l, rl_y, tl_y),
                                      (qp_c, rl_c, tl_c))):
        want = (p + 1) * rows
        for name, v, dtype in (("qp", qp, torch.int32),
                               ("rdoq", rl, torch.float32),
                               ("ts", tl, torch.float32)):
            if isinstance(v, torch.Tensor) and (
                    v.dtype != dtype or tuple(v.shape) != (want,)
                    or v.device != dev or not v.is_contiguous()):
                raise ValueError(f"stage 2 kernel: per-row {name} is "
                                 f"{v.dtype} {tuple(v.shape)}")
        w = rate.bin_weights(rate_qps[p])
        if isinstance(qp, torch.Tensor):
            args.qp_rows[p] = qp.data_ptr()
        else:
            args.qp[p] = int(qp)
        if isinstance(rl, torch.Tensor):
            args.rdoq_rows[p] = rl.data_ptr()
        else:
            lam_u = rl / rate.BITS_ONE
            args.rdoq_lam_u[p] = np.float32(lam_u)
            args.rdoq_csbf[p] = np.float32(lam_u * w["csbf"])
            args.rdoq_cbf0[p] = np.float32(lam_u * float(w["cbf0"]))
        if isinstance(tl, torch.Tensor):
            args.ts_rows[p] = tl.data_ptr()
        else:
            args.ts_lam_u[p] = np.float32(tl / rate.BITS_ONE)
        args.rdoq_on[p] = quant.lam_on(rl)
        args.ts_on[p] = quant.lam_on(tl)
    args.rows = rows
    args.h, args.w = hw
    args.sbh, args.tu4 = int(sbh), int(tu4)
    # the tables' buffer lives in _tables' cache, as long as the process
    args.tab = _tables(dev, tuple(rate_qps), schedule)[1]
    return args


def launch(args: Args, device: torch.device):
    """One diagonal on `device`'s current stream (make_args's buffers
    must be on it); raises if the launch fails. Counts
    stage2.kernel_launches."""
    if device.type != "cuda":
        raise ValueError(f"the stage 2 kernel runs on cuda, not {device}")
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.stage2_ctu_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError("stage 2 kernel launch failed: "
                           + lib.stage2_ctu_error_string(rc).decode())
    trace.count("stage2.kernel_launches")
