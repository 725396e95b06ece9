"""The constant tables of ITU-T H.265 (v1, 04/2013) that an 8-bit 4:2:0
intra decoder reads, written out from the Recommendation: CABAC's state
tables (9.3.4.3.2), the context initial values of I slices (9.3.2.2),
the transform matrix (8.6.4.2), the intra angles (8.4.4.2.6), the
deblocking thresholds (8.7.2.5) and the chroma QP mapping (8.6.1)."""

from __future__ import annotations

import functools

import numpy as np

# Table 9-46: rangeTabLps[pStateIdx][qRangeIdx]
RANGE_LPS = (
    (128, 176, 208, 240), (128, 167, 197, 227), (128, 158, 187, 216),
    (123, 150, 178, 205), (116, 142, 169, 195), (111, 135, 160, 185),
    (105, 128, 152, 175), (100, 122, 144, 166), (95, 116, 137, 158),
    (90, 110, 130, 150), (85, 104, 123, 142), (81, 99, 117, 135),
    (77, 94, 111, 128), (73, 89, 105, 122), (69, 85, 100, 116),
    (66, 80, 95, 110), (62, 76, 90, 104), (59, 72, 86, 99),
    (56, 69, 81, 94), (53, 65, 77, 89), (51, 62, 73, 85),
    (48, 59, 69, 80), (46, 56, 66, 76), (43, 53, 63, 72),
    (41, 50, 59, 69), (39, 48, 56, 65), (37, 45, 54, 62),
    (35, 43, 51, 59), (33, 41, 48, 56), (32, 39, 46, 53),
    (30, 37, 43, 50), (29, 35, 41, 48), (27, 33, 39, 45),
    (26, 31, 37, 43), (24, 30, 35, 41), (23, 28, 33, 39),
    (22, 27, 32, 37), (21, 26, 30, 35), (20, 24, 29, 33),
    (19, 23, 27, 31), (18, 22, 26, 30), (17, 21, 25, 28),
    (16, 20, 23, 27), (15, 19, 22, 25), (14, 18, 21, 24),
    (14, 17, 20, 23), (13, 16, 19, 22), (12, 15, 18, 21),
    (12, 14, 17, 20), (11, 14, 16, 19), (11, 13, 15, 18),
    (10, 12, 15, 17), (10, 12, 14, 16), (9, 11, 13, 15),
    (9, 11, 12, 14), (8, 10, 12, 14), (8, 9, 11, 13),
    (7, 9, 11, 12), (7, 9, 10, 12), (7, 8, 10, 11),
    (6, 8, 9, 11), (6, 7, 9, 10), (6, 7, 8, 9), (2, 2, 2, 2))

# Table 9-47: transIdxLps; transIdxMps is min(pStateIdx + 1, 62)
TRANS_LPS = (
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63)

# initValue of each context of an I slice (initType 0), by syntax element
INIT_I = {
    "sao_merge": (153,),
    "sao_type_idx": (200,),
    "split_cu_flag": (139, 141, 157),
    "part_mode": (184,),
    "prev_intra_luma_pred_flag": (184,),
    "intra_chroma_pred_mode": (63,),
    "split_transform_flag": (153, 138, 138),
    "cbf_luma": (111, 141),
    "cbf_chroma": (94, 138, 182, 154),
    "transform_skip_flag": (139, 139),            # luma, chroma
    "last_x_prefix": (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
                      143, 127, 111, 79, 108, 123, 63),
    "last_y_prefix": (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111,
                      143, 127, 111, 79, 108, 123, 63),
    "coded_sub_block_flag": (91, 171, 134, 141),
    "sig_coeff_flag": (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125,
                       141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 107,
                       125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136,
                       152, 136, 153, 136, 139, 111, 136, 139, 111),
    "greater1": (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92,
                 139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197),
    "greater2": (138, 153, 136, 167, 152, 152),
}

# Table 9-41 (ctxIdxMap of 4x4 blocks, raster position yC*4 + xC)
SIG_CTX_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)

# 8.4.4.2.6: intraPredAngle for modes 2..34, invAngle for modes 11..25
INTRA_ANGLE = (32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21,
               -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17,
               21, 26, 32)
INV_ANGLE = {11: -4096, 12: -1638, 13: -910, 14: -630, 15: -482, 16: -390,
             17: -315, 18: -256, 19: -315, 20: -390, 21: -482, 22: -630,
             23: -910, 24: -1638, 25: -4096}
# 8.4.4.2.3: intraHorVerDistThres by nTbS
FILTER_DIST_THRES = {8: 7, 16: 1, 32: 0}

# Table 8-12 (beta') and 8-12 (tc') of the deblocking filter
BETA = (0,) * 16 + (6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22,
                    24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50,
                    52, 54, 56, 58, 60, 62, 64)
TC = (0,) * 18 + (1,) * 9 + (2,) * 4 + (3,) * 4 + (4,) * 3 + (
    5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24)

# 8.6.2 levelScale of the scaling process
LEVEL_SCALE = (40, 45, 51, 57, 64, 72)

# 6.4 of the HM software's quantiser (the forward of LEVEL_SCALE:
# LEVEL_SCALE[k] * QUANT_SCALE[k] ~ 2**20), used to bound an encoder's
# levels, not to decode
QUANT_SCALE = (26214, 23302, 20560, 18396, 16384, 14564)

# Table 8-10: QpC as a function of qPi (ChromaArrayType 1)
_QPC_30_43 = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def qp_chroma(qpi: int) -> int:
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return _QPC_30_43[qpi - 30]


# 8.6.4.2: the 32-point matrix. Row k, column n holds the coefficient of
# angle index j = (2n + 1) k mod 128; its magnitude depends on j folded
# into 0..32 (COS_INT[j'] ~ 64 * sqrt(2) * cos(pi j' / 64), as the
# Recommendation lists it), its sign on the cosine's sign; row 0 is 64.
COS_INT = (64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
           64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """transMatrix of an n-point transform [n, n] (row = frequency)."""
    m = np.zeros((32, 32), np.int64)
    for k in range(32):
        for x in range(32):
            if k == 0:
                m[k, x] = 64
                continue
            j = ((2 * x + 1) * k) % 128
            f = j % 64
            f = f if f <= 32 else 64 - f
            neg = 32 < j < 96
            m[k, x] = -COS_INT[f] if neg else COS_INT[f]
    return m[:: 32 // n, :n].copy()


# 8.6.4.2: the 4x4 DST of intra luma
DST4 = np.array([[29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55],
                 [55, -84, 74, -29]], np.int64)


@functools.lru_cache(maxsize=None)
def scan(scan_idx: int, size: int) -> tuple:
    """6.5.3-6.5.5: ((x, y), ...) of a size x size block in the order of
    scan_idx (0 up-right diagonal, 1 horizontal, 2 vertical)."""
    if scan_idx == 1:
        return tuple((x, y) for y in range(size) for x in range(size))
    if scan_idx == 2:
        return tuple((x, y) for x in range(size) for y in range(size))
    out, x, y = [], 0, 0
    while len(out) < size * size:
        while y >= 0:
            if x < size and y < size:
                out.append((x, y))
            y -= 1
            x += 1
        y, x = x, 0
    return tuple(out)
