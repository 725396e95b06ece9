"""The yardstick's arithmetic: the card's peaks, and the least time the
work of a batch needs at them, counted from shapes and from the
decisions an encode made, whatever implements the work.

- K1 (the SATD mode search): a frozen copy of k1_bound in chip_smoke.py at
  commit 6f811bd. Bytes: refs and orig read once and the 35 costs written
  once, int32. Operations: one integer instruction per nonzero tap of the
  prediction operator P (NNZ_P below, counted from
  intra_mm.prediction_tensor at that commit), plus per pixel and mode the
  2-D Hadamard butterfly adds, one magnitude and one sum.
- Stage 2: the forward and the inverse separable transform of every TU the
  decisions code, luma and both chroma planes: two passes each way, N
  multiply-adds a coefficient a pass, one instruction each. Bytes: the
  source planes read once and the recon (8-bit) and levels (int16)
  written once.
- Stage 1's dense RD candidates: the forward transform of every candidate
  the search scores (pass-2 candidates of every size, the 64x64 CU's four
  32x32 TUs, every TU size of the TU-tree decision, the chroma list).
- ConvNet2: its multiply-adds as two floating-point operations each, at
  the FP32 rate outside the tensor cores (the model runs in float32 with
  TF32 off).
A bound is the larger of operations over the rate and bytes over the
bandwidth.
"""

from __future__ import annotations

import numpy as np

# Published peaks by torch.cuda.get_device_name(): NVIDIA's H100 SXM data
# sheet (HBM3 bandwidth, FP32 outside the tensor cores), 132 SMs of 64
# INT32 lanes, and the card's maximum SM clock as nvidia-smi reports it
# (clocks.max.sm).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, sms=132,
                                  int32_lanes_per_sm=64,
                                  max_sm_clock_hz=1.98e9,
                                  fp32_flops_per_s=67e12),
}

# nonzero entries of the luma prediction operator P [K, 35, n, n]
NNZ_P = {4: 1720, 8: 7408, 16: 33632, 32: 166720}
K1_SIZES = (4, 8, 16, 32)

# stage 1's pass-2 candidates a size: HM's fast-mode count + the 3 MPMs
STAGE1_CANDIDATES = {4: 11, 8: 11, 16: 6, 32: 6, 64: 6}
CHROMA_CANDIDATES = 5

# ConvNet2's multiply-adds: per 32x32 quadrant crop, and per CTU for the
# 5x5 conv on the 64x64 crop
_CROP_MACS = (32 * 32 * 16 * 5 * 5 * 3 + 16 * 16 * 64 * 3 * 3 * 32
              + 8 * 8 * 128 * 3 * 3 * 64 + 2048 * 256 + 256 * 64 + 64 * 16)
_CTU_MACS = 4 * _CROP_MACS + 64 * 64 * 16 * 5 * 5 * 3


def int32_rate(peaks: dict) -> float:
    return (peaks["sms"] * peaks["int32_lanes_per_sm"]
            * peaks["max_sm_clock_hz"])


def padded(h: int, w: int) -> tuple:
    return -(-h // 64) * 64, -(-w // 64) * 64


def k1_rows(h: int, w: int, frames: int) -> dict:
    """K1's M a size: one row per n x n block of the padded frames."""
    hp, wp = padded(h, w)
    return {n: frames * (hp // n) * (wp // n) for n in K1_SIZES}


def k1_bound(n: int, m: int, peaks: dict) -> tuple:
    """(least seconds, bytes, operations) of one K1 call of M = m rows."""
    k = 8 * n + 5
    nbytes = m * (k + n * n + 35) * 4
    s = 4 if n == 4 else 8
    ops = m * (NNZ_P[n] + 35 * n * n * (2 * int(np.log2(s)) + 2))
    return (max(nbytes / peaks["hbm_bytes_per_s"], ops / int32_rate(peaks)),
            nbytes, ops)


def tu_counts(tusz8: np.ndarray, coded8: np.ndarray) -> dict:
    """Leaf TUs the decisions code, per frame summed: {("y"|"c", n): count}
    from the leaf-size map tusz8 (log2 of the luma TU at each 8x8 slot,
    2 = four 4x4) and the coded-slot map coded8, [F, H8, W8] each. "c"
    counts one chroma plane."""
    tz = np.asarray(tusz8)
    cd = np.asarray(coded8, bool)
    out = {}
    for lg in (5, 4, 3):
        slots = int(np.count_nonzero(cd & (tz == lg)))
        n = 1 << lg
        tus = slots // (n // 8) ** 2
        out[("y", n)] = tus
        out[("c", n // 2)] = out.get(("c", n // 2), 0) + tus
    s2 = int(np.count_nonzero(cd & (tz == 2)))
    out[("y", 4)] = 4 * s2
    out[("c", 4)] = out.get(("c", 4), 0) + s2
    return out


def stage2_work(tusz8, coded8, h: int, w: int) -> tuple:
    """(operations, bytes) of stage 2 for frames [F, ...]: 4 N^3 multiply-
    adds a TU (forward and inverse, two passes each, N a coefficient a
    pass), chroma on two planes; 4 bytes a sample (source and recon 8-bit,
    levels int16) over the frames' luma and chroma samples."""
    frames = np.shape(tusz8)[0]
    ops = 0
    for (comp, n), cnt in tu_counts(tusz8, coded8).items():
        ops += (2 if comp == "c" else 1) * cnt * 4 * n ** 3
    nbytes = frames * h * w * 3 // 2 * 4
    return ops, nbytes


def stage2_bound(tusz8, coded8, h: int, w: int, peaks: dict) -> float:
    ops, nbytes = stage2_work(tusz8, coded8, h, w)
    return max(ops / int32_rate(peaks), nbytes / peaks["hbm_bytes_per_s"])


def stage1_transform_macs(h: int, w: int, frames: int) -> int:
    """Multiply-adds of the forward transforms stage 1 scores (2 N^3 a
    transform), for frames of the geometry."""
    hp, wp = padded(h, w)

    def pos(n):
        return (hp // n) * (wp // n)

    macs = sum(pos(n) * STAGE1_CANDIDATES[n] * 2 * n ** 3
               for n in (32, 16, 8, 4))
    macs += pos(64) * STAGE1_CANDIDATES[64] * 4 * 2 * 32 ** 3
    for cu_log2 in (6, 5, 4, 3):                      # the TU-tree decision
        for s in range(max(2, cu_log2 - 3), min(cu_log2, 5) + 1):
            macs += pos(1 << s) * 2 * (1 << s) ** 3
    for n in (64, 32, 16, 8):                         # chroma list, U and V
        m = n // 2
        macs += pos(n) * CHROMA_CANDIDATES * 2 * 2 * m ** 3
    return frames * macs


def cnn_flops(h: int, w: int, frames: int) -> int:
    return frames * (-(-h // 64)) * (-(-w // 64)) * _CTU_MACS * 2


def step_bound(h: int, w: int, frames: int, tusz8, coded8,
               peaks: dict) -> float:
    """Least seconds of one encode of `frames` frames: the sum of the
    bounds of ConvNet2, K1, stage 1's transforms and stage 2."""
    rate = int32_rate(peaks)
    t = cnn_flops(h, w, frames) / peaks["fp32_flops_per_s"]
    t += sum(k1_bound(n, m, peaks)[0]
             for n, m in k1_rows(h, w, frames).items())
    t += stage1_transform_macs(h, w, frames) / rate
    return t + stage2_bound(tusz8, coded8, h, w, peaks)
