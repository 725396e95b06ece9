"""Fused stage-1 mode search, K1: all-35-mode intra prediction + Hadamard
SATD (port of hevctpu/ops/satd_fused.py).

The JAX package runs this as a Pallas TPU kernel (mode_satd_costs ->
_make_kernel, pallas_call at hevctpu/ops/satd_fused.py:119). Here the
kernel is CUDA C++ for Hopper, csrc/satd_fused.cu (its header says what
bounds it and how it is laid out), built with nvcc into a shared library
at first use and called through ctypes on PyTorch's current stream. It
reads the prediction operator P not as a dense matrix but as a tap table
(tap_table) derived here from P, which stays the one source of truth.

Dispatch is by device only: a CPU tensor goes through the plain PyTorch
version mode_satd_costs_ref (the same arithmetic written out: one exact
matmul, shift, residual, cost.satd); a CUDA tensor always goes through
the kernel, which raises if it cannot build or launch.

The DC/VER/HOR boundary patches (luma n < 32) are nonlinear in the
references, so those three columns are recomputed in torch and
overwritten (_patch_mode_costs), exactly as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from hevctpu_torch import rom
from hevctpu_torch.ops import _nvcc, cost, intra_mm

# Kernel launches since import (or since the caller last reset it): the
# proof that a run went through the CUDA kernel. Encoders launch K1 from
# their dispatch worker threads, so the count and the first build are
# taken under locks.
LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()
_LIB_LOCK = threading.Lock()

_SOURCE = _nvcc.CSRC / "satd_fused.cu"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The tap table's format, shared with csrc/satd_fused.cu (kPlanarSlots,
# kAngularSlots; _lib checks that the two agree): tap words the kernel
# reads per pixel of the planar mode and of each angular mode; DC reads
# none.
PLANAR_SLOTS = 4
ANGULAR_SLOTS = 2
TAP_ROWS = PLANAR_SLOTS + 33 * ANGULAR_SLOTS


@functools.lru_cache(maxsize=None)
def _kron_hadamard(n: int) -> np.ndarray:
    """(Hbd (x) Hbd) [n^2, n^2]: the JAX kernel's one-matmul form of the
    per-subblock 8x8 (4x4 at n=4) Hadamard; kept for the parity tests,
    the CUDA kernel runs butterflies instead."""
    k = min(n, 8)
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < k:
        h = np.block([[h, h], [h, -h]])
    hbd = np.kron(np.eye(n // k, dtype=np.int64), h)
    return np.kron(hbd, hbd).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _subblock_group(n: int) -> np.ndarray:
    """0/1 matrix [n^2, (n/8)^2] mapping flat pixel -> 8x8 subblock id."""
    k = min(n, 8)
    s = n // k
    g = np.zeros((n * n, s * s), dtype=np.float32)
    for y in range(n):
        for x in range(n):
            g[y * n + x, (y // k) * s + (x // k)] = 1.0
    return g


def build() -> tuple[float, str]:
    """Compile csrc/satd_fused.cu for sm_90a into csrc/_build/ unless the
    library for this source and these flags exists: the seconds spent and
    what ptxas reported (_nvcc.build)."""
    return _nvcc.build(_SOURCE, _NVCC_FLAGS)


def _lib() -> ctypes.CDLL:
    """The built and checked K1 library, loaded once per process."""
    with _LIB_LOCK:
        return _load_lib()


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(str(_nvcc.library_path(_SOURCE, _NVCC_FLAGS)))
    fn = lib.hevc_satd_mode_costs
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hevc_satd_tile_rows.argtypes = [ctypes.c_int]
    lib.hevc_satd_tile_rows.restype = ctypes.c_int
    lib.hevc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hevc_cuda_error_string.restype = ctypes.c_char_p
    for n in (4, 8, 16, 32):
        got = [ctypes.c_int() for _ in range(3)]
        lib.hevc_satd_tap_layout(n, *map(ctypes.byref, got))
        want = [PLANAR_SLOTS, ANGULAR_SLOTS, _tap_table_np(n, True).size]
        if [g.value for g in got] != want:
            raise RuntimeError(f"K1 reads another tap table layout at n={n}"
                               f": {[g.value for g in got]}, not {want}")
    return lib


def tile_rows(n: int) -> int:
    """Rows of refs one block of the kernel stages at size n (builds the
    kernel; the card-only tests size their ragged tiles with it)."""
    return _lib().hevc_satd_tile_rows(n)


def _pair_words(col: np.ndarray) -> list[int]:
    """The nonzero taps of one column of P as kernel tap words
    idx << 16 | w[idx+1] << 8 | w[idx]: taps on neighbouring refs share a
    word."""
    idx = np.flatnonzero(col)
    words, i = [], 0
    while i < len(idx):
        a = int(idx[i])
        pair = i + 1 < len(idx) and idx[i + 1] == a + 1
        wb = int(col[a + 1]) if pair else 0
        words.append(a << 16 | wb << 8 | int(col[a]))
        i += 2 if pair else 1
    return words


@functools.lru_cache(maxsize=None)
def _tap_table_np(n: int, is_luma: bool) -> np.ndarray:
    """P = intra_mm.prediction_tensor(n, is_luma) as the kernel reads it,
    int32: [TAP_ROWS, n*n] tap words (planar in rows 0..3, angular mode m
    in rows 4 + 2(m-2) and the next, zero-padded), the constant term of
    each of the 35 modes, 35 flags (an angular mode uses its second row),
    and DC's one weight on its 2n unfiltered references. Raises if P has
    a shape the kernel cannot read."""
    p, _ = intra_mm.prediction_tensor(n, is_luma)
    k, nn = p.shape[0], n * n
    cols = p.reshape(k, 35, nn).astype(np.int64)
    if cols.min() < 0 or cols[: k - 1].max() > 255 or k - 1 >= 1 << 15:
        raise ValueError("P's weights or size do not fit the tap words")
    const = cols[k - 1]
    if (const != const[:, :1]).any():
        raise ValueError("P's constant term varies within a mode")
    ln = 2 * n + 1
    dc_refs = np.r_[1: n + 1, ln + 1: ln + n + 1]    # top_ext, left_ext 1..n
    dc_w = int(cols[dc_refs[0], rom.DC_IDX, 0])
    dc = np.zeros(k - 1, dtype=np.int64)
    dc[dc_refs] = dc_w
    if (cols[: k - 1, rom.DC_IDX] != dc[:, None]).any():
        raise ValueError("DC is not one weight on its 2n references")
    words = np.zeros((TAP_ROWS, nn), dtype=np.int64)
    second = np.zeros(35, dtype=np.int64)
    for mode in range(35):
        if mode == rom.DC_IDX:
            continue
        row, slots = ((0, PLANAR_SLOTS) if mode == rom.PLANAR_IDX else
                      (PLANAR_SLOTS + (mode - 2) * ANGULAR_SLOTS,
                       ANGULAR_SLOTS))
        for px in range(nn):
            w = _pair_words(cols[: k - 1, mode, px])
            if len(w) > slots:
                raise ValueError(f"mode {mode} pixel {px} needs {len(w)} "
                                 f"tap words, the kernel reads {slots}")
            words[row: row + len(w), px] = w
        if mode != rom.PLANAR_IDX:
            second[mode] = int(words[row + 1].any())
    return np.concatenate([words.ravel(), const[:, 0], second,
                           [dc_w]]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def tap_table(n: int, is_luma: bool, device: torch.device) -> torch.Tensor:
    """_tap_table_np(n, is_luma) as an int32 tensor on `device`."""
    return torch.as_tensor(_tap_table_np(n, is_luma), device=device)


def mode_satd_costs_ref(refs: torch.Tensor, orig_flat: torch.Tensor, n: int,
                        *, is_luma: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K1: refs [M, K] int32 (intra_mm layout),
    orig_flat [M, n*n] int32 -> [M, 35] int32 SATD, DC/VER/HOR unpatched."""
    _, shift = intra_mm._pred_matrix_bf16(n, is_luma)
    p = intra_mm.pred_matrix(n, is_luma, torch.float32, refs.device)
    m = refs.shape[0]
    pred = ((refs.to(torch.float32) @ p).to(torch.int32) >> shift)
    return cost.satd(pred.reshape(m, 35, n, n),
                     orig_flat.reshape(m, 1, n, n))


def _count_launch():
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1


def _mode_satd_costs_cuda(refs, orig_flat, n, is_luma):
    m, k = refs.shape
    if n not in (4, 8, 16, 32):
        raise ValueError(f"K1 takes n in 4/8/16/32, got {n}")
    if k != 8 * n + 5 or orig_flat.shape != (m, n * n):
        raise ValueError(f"K1 shapes: refs {tuple(refs.shape)}, orig "
                         f"{tuple(orig_flat.shape)} for n={n}")
    for name, t in (("refs", refs), ("orig", orig_flat)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"K1 needs contiguous int32 {name}")
        if t.device != refs.device:
            raise ValueError("K1 inputs must share one device")
    _, shift = intra_mm._pred_matrix_bf16(n, is_luma)
    taps = tap_table(n, is_luma, refs.device)
    out = torch.empty((m, 35), dtype=torch.int32, device=refs.device)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(refs.device):
        stream = torch.cuda.current_stream(refs.device).cuda_stream
        rc = lib.hevc_satd_mode_costs(refs.data_ptr(), orig_flat.data_ptr(),
                                      taps.data_ptr(), out.data_ptr(), m, n,
                                      shift, stream)
    if rc != 0:
        raise RuntimeError("K1 launch failed: "
                           + lib.hevc_cuda_error_string(rc).decode())
    _count_launch()
    return out


def mode_satd_costs(refs: torch.Tensor, orig_flat: torch.Tensor, n: int, *,
                    is_luma: bool = True) -> torch.Tensor:
    """SATD of all 35 modes. refs [M, K] int32 (top_ext | left_ext | top_f
    | left_f | 1) of values 0..65535 (the kernel packs two in a word),
    orig_flat [M, n*n] int32 -> [M, 35] int32 (DC/VER/HOR columns
    unpatched for luma n<32). CUDA tensors run K1; CPU tensors run
    mode_satd_costs_ref."""
    if refs.device.type == "cuda":
        return _mode_satd_costs_cuda(refs, orig_flat, n, is_luma)
    if refs.device.type != "cpu":
        raise ValueError(f"K1 runs on cuda or cpu, not {refs.device}")
    return mode_satd_costs_ref(refs, orig_flat, n, is_luma=is_luma)


def _patch_mode_costs(costs, top_ext, left_ext, blocks, n, bit_depth=8):
    """Recompute DC/VER/HOR exactly (with the 8.4.4.2.5/6 boundary
    filters) and overwrite those three cost columns. Inputs [M, ...]."""
    log2 = int(np.log2(n))
    maxv = (1 << bit_depth) - 1
    corner = top_ext[..., 0:1]
    t_u = top_ext[..., 1: n + 1]
    l_u = left_ext[..., 1: n + 1]

    # DC + [1 3]/4 edge filter
    dc = ((t_u.sum(-1) + l_u.sum(-1) + n) >> (log2 + 1)).to(torch.int32)
    pdc = dc[..., None, None].expand(dc.shape + (n, n)).clone()
    pdc[..., 0, :] = (t_u + 3 * dc[..., None] + 2) >> 2
    pdc[..., 1:, 0] = ((l_u + 3 * dc[..., None] + 2) >> 2)[..., 1:]
    pdc[..., 0, 0] = (l_u[..., 0] + 2 * dc + t_u[..., 0] + 2) >> 2

    # VER (26): columns of top, col 0 gradient-corrected
    pver = t_u[..., None, :].expand(t_u.shape[:-1] + (n, n)).clone()
    pver[..., :, 0] = torch.clamp(
        top_ext[..., 1:2] + ((l_u - corner) >> 1), 0, maxv)

    # HOR (10): rows of left, row 0 gradient-corrected
    phor = l_u[..., :, None].expand(l_u.shape[:-1] + (n, n)).clone()
    phor[..., 0, :] = torch.clamp(
        left_ext[..., 1:2] + ((t_u - corner) >> 1), 0, maxv)

    c3 = cost.satd(torch.stack([pdc, phor, pver], dim=-3),
                   blocks[..., None, :, :])                   # [M, 3]
    costs = costs.clone()
    costs[..., rom.DC_IDX] = c3[..., 0]
    costs[..., rom.HOR_IDX] = c3[..., 1]
    costs[..., rom.VER_IDX] = c3[..., 2]
    return costs


def dense_mode_costs(top_ext, left_ext, top_f, left_f, blocks, n: int, *,
                     is_luma: bool = True) -> torch.Tensor:
    """Fused equivalent of predict_all_modes_mm + cost.satd: ext arrays
    [..., 2n+1], blocks [..., n, n] int32 -> [..., 35] int32."""
    lead = blocks.shape[:-2]
    m = int(np.prod(lead)) if lead else 1
    refs = intra_mm.pack_refs(top_ext, left_ext, top_f, left_f)
    costs = mode_satd_costs(
        refs.reshape(m, -1).to(torch.int32).contiguous(),
        blocks.reshape(m, n * n).to(torch.int32).contiguous(),
        n, is_luma=is_luma).reshape(lead + (35,))
    if is_luma and n < 32:
        costs = _patch_mode_costs(costs, top_ext, left_ext,
                                  blocks.to(torch.int32), n)
    return costs
