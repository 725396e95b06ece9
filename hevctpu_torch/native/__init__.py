"""Native (C++) runtime components, built on demand with g++ + ctypes.

The serial CABAC finalization pass is the one stage of the pipeline that
cannot batch onto the TPU (bin-by-bin context feedback — the reference's
TEncBinCoderCABAC.cpp:187 engine driven from TEncSlice::encodeSlice,
TEncSlice.cpp:985). hevctpu_torch/codec/{cabac,syntax}.py is the golden Python
implementation; entropy.cpp mirrors it bit-for-bit and runs ~100x faster,
keeping the host stage off the critical path of the device pipeline.

The context-initialization tables are generated into ctx_init.inc from
hevctpu_torch/rom.py (single source of truth) at build time; the build is cached
in _build/ keyed on a hash of the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

from hevctpu_torch import rom
from hevctpu_torch.pipeline import trace

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")
_lib = None
_lib_err = None


def _generate_ctx_inc() -> str:
    """kCtxInit[] (I-slice initType-0 rows, H.265 tables 9-5..9-32) plus a
    CTX_<NAME> base offset per syntax element, mirroring codec/cabac.py's
    ContextSet layout."""
    lines = ["// Generated from hevctpu_torch/rom.py CTX_INIT — do not edit.", ""]
    offsets = []
    values = []
    for name, rows in rom.CTX_INIT.items():
        offsets.append((name, len(values)))
        values.extend(rows[0])  # I-slice row
    for name, off in offsets:
        lines.append(f"const int CTX_{name.upper()} = {off};")
    lines.append("")
    lines.append(f"const int kNumCtx = {len(values)};")
    vals = ", ".join(str(v) for v in values)
    lines.append(f"const unsigned char kCtxInit[kNumCtx] = {{{vals}}};")
    lines.append("")
    return "\n".join(lines)


def _build_lib() -> str:
    src = os.path.join(_DIR, "entropy.cpp")
    with open(src) as f:
        cpp = f.read()
    inc = _generate_ctx_inc()
    key = hashlib.sha256((cpp + inc).encode()).hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, f"entropy_{key}.so")
    if os.path.exists(so):
        return so
    inc_path = os.path.join(_BUILD, "ctx_init.inc")
    with open(inc_path, "w") as f:
        f.write(inc)
    tmp = so + ".tmp"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
         f"-I{_BUILD}", src, "-o", tmp],
        check=True, capture_output=True)
    os.replace(tmp, so)  # atomic publish (concurrent builders race benignly)
    return so


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build_lib())
    except (OSError, subprocess.CalledProcessError) as e:  # no g++ etc.
        _lib_err = e
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.encode_slice_data.restype = ctypes.c_int
    lib.encode_slice_data.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, u8p, u8p, u8p, u8p, u8p, i32p, i32p, i32p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def encode_slice_data(width: int, height: int, qp: int,
                      frame: dict, i: int, sbh: bool = True,
                      max_tu_depth: int = 0,
                      transform_skip: bool = False) -> bytes:
    """Serialize frame i's decision arrays to slice-data bytes.

    Byte-identical to codec/syntax.py SliceEncoder minus the slice header
    (tests/test_native_entropy.py asserts equality on every stream).
    Counts the call and its host ms, the library's load apart
    (trace.counters(): cabac.calls, cabac.ms).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native entropy unavailable: {_lib_err}")
    t0 = time.perf_counter_ns()
    d8 = np.ascontiguousarray(frame["depth8"][i], np.int32)
    m8 = frame["mode8"][i]
    if "mode4" in frame:
        m4 = np.ascontiguousarray(frame["mode4"][i], np.int32)
        nx8 = np.ascontiguousarray(frame["nxn8"][i], np.uint8)
        cbf4 = np.ascontiguousarray(frame["cbf4_y"][i], np.uint8)
    else:  # legacy frame dict: 2Nx2N only
        m4 = np.ascontiguousarray(np.repeat(np.repeat(m8, 2, 0), 2, 1),
                                  np.int32)
        nx8 = np.zeros(d8.shape, np.uint8)
        cbf4 = np.zeros((d8.shape[0] * 2, d8.shape[1] * 2), np.uint8)
    cs8 = (np.ascontiguousarray(frame["csel8"][i], np.int32)
           if "csel8" in frame else np.full_like(d8, 4))
    cbf = [np.ascontiguousarray(frame[k][i], np.uint8)
           for k in ("cbf_y", "cbf_u", "cbf_v")]
    lv = [np.ascontiguousarray(frame[k][i], np.int32)
          for k in ("levels_y", "levels_u", "levels_v")]
    if "sao_type" in frame:
        keys = ["type", "eo", "bp", "off"]
        if "sao_merge" in frame:
            keys.append("merge")
        sa = [np.ascontiguousarray(frame["sao_" + k][i], np.int32)
              for k in keys]
        sp = [a.ctypes.data_as(ctypes.c_void_p) for a in sa]
        if len(sp) < 5:
            sp.append(None)
    else:
        sp = [None] * 5
    if "tusz8" in frame:
        tz = np.ascontiguousarray(frame["tusz8"][i], np.int32)
        tzp = tz.ctypes.data_as(ctypes.c_void_p)
    else:
        tzp = None
    tsp = [None] * 3
    if "ts4_y" in frame:
        tsa = [np.ascontiguousarray(frame[k][i], np.uint8)
               for k in ("ts4_y", "ts8_u", "ts8_v")]
        tsp = [a.ctypes.data_as(ctypes.c_void_p) for a in tsa]
    qpp = None
    if "qp_ctu" in frame:  # cu_qp_delta per-CTU QP map
        qpa = np.ascontiguousarray(frame["qp_ctu"][i], np.int32)
        qpp = qpa.ctypes.data_as(ctypes.c_void_p)
    cap = lv[0].size * 8 + 65536
    out = (ctypes.c_uint8 * cap)()
    n = lib.encode_slice_data(width, height, qp, d8, m4, cs8, nx8, cbf4,
                              cbf[0], cbf[1], cbf[2], lv[0], lv[1], lv[2],
                              sp[0], sp[1], sp[2], sp[3], sp[4], int(sbh),
                              tzp, int(max_tu_depth), int(transform_skip),
                              tsp[0], tsp[1], tsp[2], qpp, out, cap)
    if n == -2:
        raise ValueError(
            "native entropy: qp_ctu map not inheritance-consistent "
            "(a CTU with no coded cbf must carry the predicted QP)")
    if n < 0:
        raise RuntimeError("native entropy: output overflow")
    data = ctypes.string_at(out, n)
    trace.count("cabac.calls")
    trace.count("cabac.ms", (time.perf_counter_ns() - t0) * 1e-6)
    return data
