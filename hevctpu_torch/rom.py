"""Spec-constant tables for the HEVC All-Intra encoder (the PyTorch port's copy).

This is the equivalent of the reference's TComRom / ContextTables /
TComCABACTables (HM 16.20 TLibCommon/TComRom.cpp,
ContextTables.h, TComCABACTables.cpp) — but everything here is either

  * generated from the formulas of ITU-T H.265 (the integer values are
    mandated by the standard and are identical in every conforming codec), or
  * the small hand-tuned integer sets the standard itself tabulates
    (core transform base coefficients, CABAC range/init tables).

Layout conventions used throughout this codebase:
  * images are indexed [y, x] (row-major), sizes are (H, W)
  * transform matrices are [k, n]: row k = basis vector k, so the forward
    transform of a column vector r is T @ r.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Core transform (H.265 sec. 8.6.4): integer DCT-II approximations of sizes
# 4/8/16/32 and the 4x4 DST-VII used for intra luma 4x4 residuals.
#
# The standard's matrices have this structure: row 0 is all 64, even rows of
# T_N are the rows of T_{N/2} extended symmetrically, and odd rows are signed
# permutations of a hand-tuned base set (the "odd cosines" at scale 64*sqrt2).
# Only the base sets are spec-tabulated constants; the rest is generated.
# ---------------------------------------------------------------------------

# Hand-tuned odd-frequency coefficients per transform size (H.265 8.6.4).
_DCT_ODD_BASE = {
    4: (83, 36),
    8: (89, 75, 50, 18),
    16: (90, 87, 80, 70, 57, 43, 25, 9),
    32: (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4),
}


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """The n x n HEVC integer core transform matrix (rows = basis vectors)."""
    if n == 2:
        return np.array([[64, 64], [64, -64]], dtype=np.int32)
    m = np.zeros((n, n), dtype=np.int32)
    half = dct_matrix(n // 2)
    # Even rows: T_n[2k][j] = T_{n/2}[k][j], symmetric in j.
    m[0::2, : n // 2] = half
    m[0::2, n // 2:] = half[:, ::-1]
    # Odd rows: signed lookups into the base set via cosine-angle folding.
    base = _DCT_ODD_BASE[n]
    for k in range(1, n, 2):
        for j in range(n):
            a = ((2 * j + 1) * k) % (4 * n)
            sign = 1
            if a > 2 * n:
                a = 4 * n - a
            if a > n:
                a = 2 * n - a
                sign = -1
            m[k, j] = sign * base[(a - 1) // 2]
    return m


# 4x4 DST-VII for intra luma 4x4 residual (H.265 8.6.4.2).
DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)

MAX_TR_DYNAMIC_RANGE = 15  # 8-bit profile


def fwd_shift_1st(log2_size: int, bit_depth: int = 8) -> int:
    """Shift after the first (horizontal) forward transform stage."""
    return log2_size + bit_depth - 9


def fwd_shift_2nd(log2_size: int) -> int:
    """Shift after the second (vertical) forward transform stage."""
    return log2_size + 6


# Inverse transform shifts are normative (H.265 8.6.4.1): 7 after the first
# stage (with clip to 16 bits), 20 - bitDepth after the second.
INV_SHIFT_1ST = 7


def inv_shift_2nd(bit_depth: int = 8) -> int:
    return 20 - bit_depth


# ---------------------------------------------------------------------------
# Quantization (H.265 8.6.3). Forward scales are the encoder-side inverses
# used by HM; dequant levelScale is normative.
# ---------------------------------------------------------------------------

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
QUANT_SHIFT = 14


def chroma_qp_from_luma(qp_luma: int, chroma_qp_offset: int = 0) -> int:
    """Map luma QP to chroma QP for 4:2:0 (H.265 Table 8-10)."""
    qpi = int(np.clip(qp_luma + chroma_qp_offset, 0, 57))
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    table = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]
    return table[qpi - 30]


# Table 8-10 as a gatherable [58] array (per-CTU QP maps under cu_qp_delta
# index it with traced luma QPs).
CHROMA_QP_TABLE = np.array([chroma_qp_from_luma(q) for q in range(58)],
                           np.int32)


# ---------------------------------------------------------------------------
# Intra prediction (H.265 8.4.4.2).
# ---------------------------------------------------------------------------

# intraPredAngle for modes 2..34 (Table 8-4); index by (mode - 2).
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)


def _inv_angle(angle: int) -> int:
    return int(round(256 * 32 / angle)) if angle else 0


# invAngle for modes 11..25 (Table 8-5); index by (mode - 11).
INTRA_INV_ANGLE = np.array(
    [-_inv_angle(abs(a)) for a in INTRA_PRED_ANGLE[9:24]], dtype=np.int32)

# Reference-sample smoothing-filter decision thresholds, indexed by
# log2(size): minDistVerHor must exceed this for the [1 2 1] filter to apply
# (H.265 8.4.4.2.3; reference behavior: TComPattern.cpp:545).
INTRA_FILTER_THRES = {3: 7, 4: 1, 5: 0, 6: 0}  # 8..32 normative; 64 search-only

# Number of full-RD intra candidates by log2(CU size) when MPMs are added
# separately (reference: TComRom.cpp:545-552, index = log2(size)-1... we key
# directly by log2 size of the PU).
FAST_INTRA_NUM_CAND = {2: 8, 3: 8, 4: 3, 5: 3, 6: 3}

PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 10
VER_IDX = 26
NUM_INTRA_MODE = 35
DM_CHROMA_IDX = 36  # "derived" chroma mode marker


# ---------------------------------------------------------------------------
# Scan orders (H.265 6.5.3 up-right diagonal, plus horizontal / vertical).
# A scan array maps scan position -> (y, x).
# ---------------------------------------------------------------------------

SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


@functools.lru_cache(maxsize=None)
def scan_order(scan_idx: int, size: int) -> np.ndarray:
    """(size*size, 2) int array of (y, x) in scan order."""
    coords = []
    if scan_idx == SCAN_DIAG:
        for d in range(2 * size - 1):
            for y in range(min(d, size - 1), -1, -1):
                x = d - y
                if x < size:
                    coords.append((y, x))
    elif scan_idx == SCAN_HOR:
        for y in range(size):
            for x in range(size):
                coords.append((y, x))
    else:
        for x in range(size):
            for y in range(size):
                coords.append((y, x))
    return np.array(coords, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def tb_scan(scan_idx: int, log2_size: int) -> np.ndarray:
    """Composed transform-block scan: 4x4 coefficient groups traversed in
    the scan order, each group scanned internally the same way (H.265
    6.5.3 / 7.3.8.11). [n*n, 2] of (y, x)."""
    n = 1 << log2_size
    if n == 4:
        return scan_order(scan_idx, 4)
    cgs = scan_order(scan_idx, n // 4)
    sub = scan_order(scan_idx, 4)
    out = (cgs[:, None, :] * 4 + sub[None, :, :]).reshape(-1, 2)
    return np.ascontiguousarray(out)


def coef_scan_idx(intra_mode: int, log2_size: int, is_luma: bool) -> int:
    """Mode-dependent coefficient scan (H.265 7.4.9.11): 4x4/8x8 luma and 4x4
    chroma use horizontal scan for near-vertical modes and vertical scan for
    near-horizontal modes."""
    if log2_size == 2 or (log2_size == 3 and is_luma):
        if 6 <= intra_mode <= 14:
            return SCAN_VER
        if 22 <= intra_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# ---------------------------------------------------------------------------
# CABAC engine tables (H.265 9.3.4.3: rangeTabLPS; 9.3.4.3.2.2: state
# transitions). These are standard-mandated constants.
# ---------------------------------------------------------------------------

LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

# Renormalization shift by (range >> 3); range in [2, 255] after LPS.
RENORM_TABLE = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype=np.int32)

# State transition on LPS, 64-state representation (Table 9-47).
TRANS_LPS = np.array(
    [0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
     13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
     24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
     33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63],
    dtype=np.int32)

TRANS_MPS = np.minimum(np.arange(64, dtype=np.int32) + 1, 62)


def cabac_init_state(init_value: int, qp: int) -> tuple[int, int]:
    """(pStateIdx, valMps) from an 8-bit init value (H.265 9.3.2.2)."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(((slope * min(max(qp, 0), 51)) >> 4) + offset, 1), 126)
    mps = 1 if pre > 63 else 0
    state = (pre - 64) if mps else (63 - pre)
    return state, mps


# Fractional-bit cost of coding one bin in a given state (encoder-side rate
# estimation only, non-normative). Units: 2^-15 bits. Derived from the CABAC
# probability model pLPS(s) = 0.5 * alpha^s with alpha = (0.01875/0.5)^(1/63).
_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)
_P_LPS = 0.5 * _ALPHA ** np.arange(64)
ENTROPY_BITS_MPS = np.round(-np.log2(1.0 - _P_LPS) * (1 << 15)).astype(np.int32)
ENTROPY_BITS_LPS = np.round(-np.log2(_P_LPS) * (1 << 15)).astype(np.int32)
ENTROPY_BITS_EP = 1 << 15  # one bit per bypass bin


# ---------------------------------------------------------------------------
# Context model initialization values (H.265 Tables 9-5..9-32). One row per
# initType {0, 1, 2}; I-slices use initType 0, P->1, B->2 by default.
# (The reference stores these B,P,I — here they are spec-ordered I,P,B.)
# ---------------------------------------------------------------------------

CNU = 154

CTX_INIT = {
    # name: [I-row, P-row, B-row]
    "sao_merge": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
    "split_cu_flag": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass": [[154], [154], [154]],
    "part_mode": [[184, CNU, CNU, CNU], [154, 139, 154, 154], [154, 139, 154, 154]],
    "prev_intra_luma_pred": [[184], [154], [183]],
    "intra_chroma_pred_mode": [[63, 139], [152, 139], [152, 139]],
    "split_transform_flag": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    # TU-prefix bins of cu_qp_delta_abs (HM INIT_DELTA_QP: CNU for all
    # slice types; ctx 0 = first bin, ctx 1 = bins 1..4)
    "cu_qp_delta_abs": [[CNU, CNU], [CNU, CNU], [CNU, CNU]],
    # [luma, chroma] (HM INIT_TRANSFORMSKIP_FLAG)
    "transform_skip": [[139, 139], [139, 139], [139, 139]],
    "cbf_luma": [[111, 141, CNU, CNU, CNU],
                 [153, 111, CNU, CNU, CNU],
                 [153, 111, CNU, CNU, CNU]],
    "cbf_chroma": [[94, 138, 182, 154, 154],
                   [149, 107, 167, 154, 154],
                   [149, 92, 167, 154, 154]],
    # X and Y prefixes use separate context arrays with identical init
    # values (reference: TEncSbac m_cuCtxLastX/m_cuCtxLastY both init'd
    # from INIT_LAST).
    "last_sig_x_luma": [
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79]],
    "last_sig_x_chroma": [
        [108, 123, 63] + [CNU] * 12,
        [108, 123, 108] + [CNU] * 12,
        [108, 123, 93] + [CNU] * 12],
    "coded_sub_block_luma": [[91, 171], [121, 140], [121, 140]],
    "coded_sub_block_chroma": [[134, 141], [61, 154], [61, 154]],
    "sig_coeff_luma": [
        [111, 111, 125, 110, 110, 94, 124, 108, 124,
         107, 125, 141, 179, 153, 125,
         107, 125, 141, 179, 153, 125,
         107, 125, 141, 179, 153, 125, 141],
        [155, 154, 139, 153, 139, 123, 123, 63, 153,
         166, 183, 140, 136, 153, 154,
         166, 183, 140, 136, 153, 154,
         166, 183, 140, 136, 153, 154, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124,
         166, 183, 140, 136, 153, 154,
         166, 183, 140, 136, 153, 154,
         166, 183, 140, 136, 153, 154, 140]],
    "sig_coeff_chroma": [
        [140, 139, 182, 182, 152, 136, 152, 136, 153,
         136, 139, 111, 136, 139, 111, 111],
        [170, 153, 123, 123, 107, 121, 107, 121, 167,
         151, 183, 140, 151, 183, 140, 140],
        [170, 153, 138, 138, 122, 121, 122, 121, 167,
         151, 183, 140, 151, 183, 140, 140]],
    "coeff_abs_gt1_luma": [
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122]],
    "coeff_abs_gt1_chroma": [
        [140, 179, 166, 182, 140, 227, 122, 197],
        [169, 194, 166, 167, 154, 167, 137, 182],
        [169, 208, 166, 167, 154, 152, 167, 182]],
    "coeff_abs_gt2_luma": [[138, 153, 136, 167], [107, 167, 91, 122], [107, 167, 91, 107]],
    "coeff_abs_gt2_chroma": [[152, 152], [107, 167], [107, 167]],
    "transform_skip_luma": [[139], [139], [139]],
    "transform_skip_chroma": [[139], [139], [139]],
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
    "cu_qp_delta_abs": [[154, 154, 154], [154, 154, 154], [154, 154, 154]],
}

CTX_INIT["last_sig_y_luma"] = CTX_INIT["last_sig_x_luma"]
CTX_INIT["last_sig_y_chroma"] = CTX_INIT["last_sig_x_chroma"]

# Significance-map context maps (H.265 9.3.4.2.5). ctxIdxMap for 4x4 blocks,
# indexed by 4*y + x (the spec's Figure/Table for sigCtx of 4x4 TBs).
SIG_CTX_4X4 = np.array(
    [0, 1, 4, 5,
     2, 3, 4, 5,
     6, 6, 8, 8,
     7, 7, 8, 8], dtype=np.int32)


# ---------------------------------------------------------------------------
# Z-scan (Morton) helpers over the 4x4-partition grid of a 64x64 CTU.
# ---------------------------------------------------------------------------


def zscan_to_raster(num_part_side: int = 16) -> np.ndarray:
    """Map z-scan part index -> raster part index within a CTU."""
    n = num_part_side * num_part_side
    out = np.zeros(n, dtype=np.int32)
    for z in range(n):
        x = y = 0
        for b in range(num_part_side.bit_length() - 1):
            x |= ((z >> (2 * b)) & 1) << b
            y |= ((z >> (2 * b + 1)) & 1) << b
        out[z] = y * num_part_side + x
    return out


ZSCAN_TO_RASTER_16 = zscan_to_raster(16)
RASTER_TO_ZSCAN_16 = np.argsort(ZSCAN_TO_RASTER_16).astype(np.int32)
