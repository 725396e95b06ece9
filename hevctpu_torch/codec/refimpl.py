"""Independent scalar (numpy) reference implementation of the H.265 decode
path: intra prediction (8.4.4.2), dequantization (8.6.3), inverse transform
(8.6.4), written directly from the spec text in the spec's p[x][y]
convention.

Dual role, mirroring the reference's TLibDecoder (TDecCu.cpp:359
xDecompressCU: predict + invT + recon): the golden model the vectorized TPU
kernels are unit-tested against, and the reconstruction engine of the
verification decoder (codec/decoder.py) — deliberately sharing *no* code
with the JAX encoder kernels so an encode/decode reconstruction match is
evidence of correctness on both sides.
"""

import numpy as np

from hevctpu_torch import rom

ANGLES = [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
          -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32]
INV_ANGLES = {11: -4096, 12: -1638, 13: -910, 14: -630, 15: -482, 16: -390,
              17: -315, 18: -256, 19: -315, 20: -390, 21: -482, 22: -630,
              23: -910, 24: -1638, 25: -4096}


class RefSamples:
    """p[x][-1] for x in [-1, 2N) and p[-1][y] for y in [-1, 2N)."""

    def __init__(self, top, left, corner):
        self.top = np.asarray(top, dtype=np.int64)      # length 2N: p[0..2N-1][-1]
        self.left = np.asarray(left, dtype=np.int64)    # length 2N: p[-1][0..2N-1]
        self.corner = int(corner)

    def p(self, x, y):
        if x == -1 and y == -1:
            return self.corner
        if y == -1:
            return int(self.top[x])
        assert x == -1
        return int(self.left[y])


def substitute(top, left, corner, avail_top, avail_left, avail_corner, bd=8):
    """8.4.4.2.2 reference sample substitution. avail_* are bool arrays."""
    n2 = len(top)
    scan_vals = [left[n2 - 1 - i] for i in range(n2)] + [corner] + list(top)
    scan_av = [avail_left[n2 - 1 - i] for i in range(n2)] + [avail_corner] + \
        list(avail_top)
    if not any(scan_av):
        v = 1 << (bd - 1)
        return RefSamples([v] * n2, [v] * n2, v)
    first = next(i for i, a in enumerate(scan_av) if a)
    # leading unavailable take the first available; others take previous
    res = []
    prev = scan_vals[first]
    for i in range(len(scan_vals)):
        if scan_av[i]:
            prev = scan_vals[i]
        res.append(prev)
    left_o = [res[n2 - 1 - y] for y in range(n2)]
    corner_o = res[n2]
    top_o = res[n2 + 1:]
    return RefSamples(top_o, left_o, corner_o)


def filter_refs(r: RefSamples, n, strong=True, bd=8):
    """8.4.4.2.3 [1 2 1] filter / strong bilinear filter."""
    n2 = 2 * n
    use_strong = False
    if strong and n == 32:
        thr = 1 << (bd - 5)
        if (abs(r.corner + r.p(n2 - 1, -1) - 2 * r.p(n - 1, -1)) < thr and
                abs(r.corner + r.p(-1, n2 - 1) - 2 * r.p(-1, n - 1)) < thr):
            use_strong = True
    top = np.zeros(n2, dtype=np.int64)
    left = np.zeros(n2, dtype=np.int64)
    if use_strong:
        corner = r.corner
        for x in range(n2 - 1):
            top[x] = ((63 - x) * r.corner + (x + 1) * r.p(63, -1) + 32) >> 6
        top[n2 - 1] = r.p(n2 - 1, -1)
        for y in range(n2 - 1):
            left[y] = ((63 - y) * r.corner + (y + 1) * r.p(-1, 63) + 32) >> 6
        left[n2 - 1] = r.p(-1, n2 - 1)
    else:
        corner = (r.p(-1, 0) + 2 * r.corner + r.p(0, -1) + 2) >> 2
        for x in range(n2 - 1):
            top[x] = (r.p(x - 1, -1) + 2 * r.p(x, -1) + r.p(x + 1, -1) + 2) >> 2
        top[n2 - 1] = r.p(n2 - 1, -1)
        for y in range(n2 - 1):
            left[y] = (r.p(-1, y - 1) + 2 * r.p(-1, y) + r.p(-1, y + 1) + 2) >> 2
        left[n2 - 1] = r.p(-1, n2 - 1)
    return RefSamples(top, left, corner)


def should_filter(mode, n, is_luma=True):
    """8.4.4.2.3 filterFlag."""
    if not is_luma or mode == 1 or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {8: 7, 16: 1, 32: 0}[n]
    return mode == 0 or min_dist > thresh


def predict(r: RefSamples, mode, n, is_luma=True, bd=8):
    """Returns pred indexed [y][x]."""
    maxv = (1 << bd) - 1
    pred = np.zeros((n, n), dtype=np.int64)
    if mode == 0:  # planar 8.4.4.2.4
        for y in range(n):
            for x in range(n):
                pred[y, x] = ((n - 1 - x) * r.p(-1, y) + (x + 1) * r.p(n, -1)
                              + (n - 1 - y) * r.p(x, -1) + (y + 1) * r.p(-1, n)
                              + n) >> (int(np.log2(n)) + 1)
        return pred
    if mode == 1:  # DC 8.4.4.2.5
        dc = (sum(r.p(x, -1) for x in range(n))
              + sum(r.p(-1, y) for y in range(n)) + n) >> (int(np.log2(n)) + 1)
        pred[:, :] = dc
        if is_luma and n < 32:
            pred[0, 0] = (r.p(-1, 0) + 2 * dc + r.p(0, -1) + 2) >> 2
            for x in range(1, n):
                pred[0, x] = (r.p(x, -1) + 3 * dc + 2) >> 2
            for y in range(1, n):
                pred[y, 0] = (r.p(-1, y) + 3 * dc + 2) >> 2
        return pred
    # angular 8.4.4.2.6
    angle = ANGLES[mode - 2]
    ref = {}
    if mode >= 18:
        for x in range(0, n + 1):
            ref[x] = r.p(-1 + x, -1)
        if angle < 0:
            if (n * angle) >> 5 < -1:
                inv = INV_ANGLES[mode]
                for x in range(-1, ((n * angle) >> 5) - 1, -1):
                    ref[x] = r.p(-1, -1 + ((x * inv + 128) >> 8))
        else:
            for x in range(n + 1, 2 * n + 1):
                ref[x] = r.p(-1 + x, -1)
        for y in range(n):
            i_idx = ((y + 1) * angle) >> 5
            i_fact = ((y + 1) * angle) & 31
            for x in range(n):
                if i_fact:
                    pred[y, x] = ((32 - i_fact) * ref[x + i_idx + 1]
                                  + i_fact * ref[x + i_idx + 2] + 16) >> 5
                else:
                    pred[y, x] = ref[x + i_idx + 1]
        if mode == 26 and is_luma and n < 32:
            for y in range(n):
                pred[y, 0] = np.clip(
                    r.p(0, -1) + ((r.p(-1, y) - r.corner) >> 1), 0, maxv)
    else:
        for x in range(0, n + 1):
            ref[x] = r.p(-1, -1 + x)
        if angle < 0:
            if (n * angle) >> 5 < -1:
                inv = INV_ANGLES[mode]
                for x in range(-1, ((n * angle) >> 5) - 1, -1):
                    ref[x] = r.p(-1 + ((x * inv + 128) >> 8), -1)
        else:
            for x in range(n + 1, 2 * n + 1):
                ref[x] = r.p(-1, -1 + x)
        for x in range(n):
            i_idx = ((x + 1) * angle) >> 5
            i_fact = ((x + 1) * angle) & 31
            for y in range(n):
                if i_fact:
                    pred[y, x] = ((32 - i_fact) * ref[y + i_idx + 1]
                                  + i_fact * ref[y + i_idx + 2] + 16) >> 5
                else:
                    pred[y, x] = ref[y + i_idx + 1]
        if mode == 10 and is_luma and n < 32:
            for x in range(n):
                pred[0, x] = np.clip(
                    r.p(-1, 0) + ((r.p(x, -1) - r.corner) >> 1), 0, maxv)
    return pred

# ---------------------------------------------------------------------------
# Dequant + inverse transform (8.6.3 / 8.6.4), numpy int64 scalar reference
# ---------------------------------------------------------------------------


def dequantize(level, log2_size, qp, bit_depth=8):
    """Normative dequant (8.6.3, flat m=16): levels [N,N] -> coefficients."""
    level = np.asarray(level, dtype=np.int64)
    bd_shift = bit_depth + log2_size - 5
    scale = int(rom.INV_QUANT_SCALES[qp % 6]) * 16
    e = qp // 6 - bd_shift
    if e < 0:
        d = (level * scale + (1 << (-e - 1))) >> (-e)
    else:
        d = (level * scale) << e
    return np.clip(d, -32768, 32767)


def inverse_transform(coef, log2_size, dst=False, bit_depth=8):
    """Two-stage inverse DCT/DST with the spec's intermediate clipping."""
    t = (rom.DST4 if dst else rom.dct_matrix(1 << log2_size)).astype(np.int64)
    coef = np.asarray(coef, dtype=np.int64)
    tmp = (t.T @ coef + 64) >> 7
    tmp = np.clip(tmp, -32768, 32767)
    s2 = 20 - bit_depth
    return (((t.T @ tmp.T + (1 << (s2 - 1))) >> s2).T).astype(np.int64)


# ---------------------------------------------------------------------------
# Boundary availability (numpy) — wavefront/raster decode order
# ---------------------------------------------------------------------------


def _morton(n):
    out = np.zeros((n, n), dtype=np.int64)
    for y in range(n):
        for x in range(n):
            z = 0
            for b in range(int(n).bit_length()):
                z |= ((x >> b) & 1) << (2 * b)
                z |= ((y >> b) & 1) << (2 * b + 1)
            out[y, x] = z
    return out


def boundary_availability(y0, x0, n, h, w, span):
    """(avail_top [2n], avail_left [2n], avail_corner) for a TU at picture
    origin (y0, x0) in a plane of valid size h x w with CTU span `span`,
    decoded in raster CTU order / z-order within the CTU (HM's availability,
    TComPattern.cpp:86-117)."""
    cy, cx = (y0 // span) * span, (x0 // span) * span
    oy, ox = y0 - cy, x0 - cx
    zmap = _morton(span // 4)
    z_tu = zmap[oy // 4, ox // 4]

    def avail(fy, fx):
        if fy < 0 or fx < 0 or fy >= h or fx >= w:
            return False
        ly, lx = fy - cy, fx - cx
        if 0 <= ly < span and 0 <= lx < span:
            return zmap[ly // 4, lx // 4] < z_tu
        return ly < 0 or (lx < 0 and 0 <= ly < span)

    top = np.array([avail(y0 - 1, x0 + i) for i in range(2 * n)])
    left = np.array([avail(y0 + i, x0 - 1) for i in range(2 * n)])
    return top, left, avail(y0 - 1, x0 - 1)


def recon_tu(plane, levels, y0, x0, log2, mode, cbf, qp, is_luma, h, w,
             span, strong_smoothing=True, dst=False, ts=False, bit_depth=8):
    """Reconstruct one TU in place on `plane` (numpy [hp, wp] int) from its
    neighbors + quantized levels: the scalar equivalent of TDecCu's
    xDecompressCU per-TU chain (predict -> dequant -> invT -> clip)."""
    n = 1 << log2
    at, al, ac = boundary_availability(y0, x0, n, h, w, span)
    top = np.array([plane[y0 - 1, min(x0 + i, plane.shape[1] - 1)]
                    if y0 > 0 else 0 for i in range(2 * n)], dtype=np.int64)
    left = np.array([plane[min(y0 + i, plane.shape[0] - 1), x0 - 1]
                     if x0 > 0 else 0 for i in range(2 * n)], dtype=np.int64)
    corner = int(plane[y0 - 1, x0 - 1]) if (y0 > 0 and x0 > 0) else 0
    r = substitute(top, left, corner, at, al, ac, bd=bit_depth)
    if should_filter(mode, n, is_luma):
        r = filter_refs(r, n, strong=strong_smoothing, bd=bit_depth)
    pred = predict(r, mode, n, is_luma=is_luma, bd=bit_depth)
    if cbf:
        lvl = levels[y0: y0 + n, x0: x0 + n]
        deq = dequantize(lvl, log2, qp, bit_depth)
        if ts:
            # transform-skip (8.6.4.2 / TComTrQuant xITransformSkip): the
            # dequantized values ARE the 2^shift-scaled residual.
            shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2
            res = (deq + (1 << (shift - 1))) >> shift
        else:
            res = inverse_transform(deq, log2, dst=dst, bit_depth=bit_depth)
        rec = np.clip(pred + res, 0, (1 << bit_depth) - 1)
    else:
        rec = np.clip(pred, 0, (1 << bit_depth) - 1)
    plane[y0: y0 + n, x0: x0 + n] = rec


# ---------------------------------------------------------------------------
# Deblocking filter (8.7.2) — scalar, per-edge loops, written from the spec.
# All-Intra: every TU/CU boundary on the 8-pel luma grid has bS = 2.
# ---------------------------------------------------------------------------

_DB_BETA = [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20,
                       22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46,
                       48, 50, 52, 54, 56, 58, 60, 62, 64]
_DB_TC = [0] * 18 + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
                     4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
                     22, 24]


def _clip3(lo, hi, x):
    return max(lo, min(hi, x))


def _tu_size8(tusz8, sy, sx):
    # leaf TU size in slots, clipped to the 8x8 deblocking grid
    return 1 << (max(int(tusz8[sy, sx]), 3) - 3)


def _deblock_luma_edges(plane, tusz8, qp, h, w, bd=8):
    """Vertical luma edges of `plane` in place (call transposed for
    horizontal). plane indexed [y, x]. qp: int, or a per-8x8-slot luma QP
    map (cu_qp_delta) — per-edge Q is the side average (8.7.2.5.3)."""
    qmap = None if isinstance(qp, (int, np.integer)) else qp
    if qmap is None:
        beta0 = _DB_BETA[_clip3(0, 51, qp)] << (bd - 8)
        tc0 = _DB_TC[_clip3(0, 53, qp + 2)] << (bd - 8)
        if beta0 == 0 and tc0 == 0:
            return
    maxv = (1 << bd) - 1
    for x in range(8, w, 8):
        for ys in range(0, h, 4):
            if (x // 8) % _tu_size8(tusz8, ys // 8, x // 8):
                continue
            if qmap is None:
                beta, tc = beta0, tc0
            else:
                qe = (int(qmap[ys // 8, x // 8 - 1])
                      + int(qmap[ys // 8, x // 8]) + 1) >> 1
                beta = _DB_BETA[_clip3(0, 51, qe)] << (bd - 8)
                tc = _DB_TC[_clip3(0, 53, qe + 2)] << (bd - 8)
                if beta == 0 and tc == 0:
                    continue
            seg = plane[ys: ys + 4]

            def p(i, k):
                return int(seg[k, x - 1 - i])

            def q(i, k):
                return int(seg[k, x + i])

            dp0 = abs(p(2, 0) - 2 * p(1, 0) + p(0, 0))
            dp3 = abs(p(2, 3) - 2 * p(1, 3) + p(0, 3))
            dq0 = abs(q(2, 0) - 2 * q(1, 0) + q(0, 0))
            dq3 = abs(q(2, 3) - 2 * q(1, 3) + q(0, 3))
            d = dp0 + dq0 + dp3 + dq3
            if d >= beta:
                continue

            def dsam(k):
                return (2 * (dp0 + dq0 if k == 0 else dp3 + dq3) < beta >> 2
                        and abs(p(3, k) - p(0, k)) + abs(q(0, k) - q(3, k))
                        < beta >> 3
                        and abs(p(0, k) - q(0, k)) < (5 * tc + 1) >> 1)

            strong = dsam(0) and dsam(3)
            dep1 = dp0 + dp3 < (beta + (beta >> 1)) >> 3
            deq1 = dq0 + dq3 < (beta + (beta >> 1)) >> 3
            for k in range(4):
                p3, p2, p1, p0 = p(3, k), p(2, k), p(1, k), p(0, k)
                q0, q1, q2, q3 = q(0, k), q(1, k), q(2, k), q(3, k)
                if strong:
                    seg[k, x - 1] = _clip3(p0 - 2 * tc, p0 + 2 * tc,
                                           (p2 + 2 * p1 + 2 * p0 + 2 * q0
                                            + q1 + 4) >> 3)
                    seg[k, x - 2] = _clip3(p1 - 2 * tc, p1 + 2 * tc,
                                           (p2 + p1 + p0 + q0 + 2) >> 2)
                    seg[k, x - 3] = _clip3(p2 - 2 * tc, p2 + 2 * tc,
                                           (2 * p3 + 3 * p2 + p1 + p0 + q0
                                            + 4) >> 3)
                    seg[k, x] = _clip3(q0 - 2 * tc, q0 + 2 * tc,
                                       (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2
                                        + 4) >> 3)
                    seg[k, x + 1] = _clip3(q1 - 2 * tc, q1 + 2 * tc,
                                           (p0 + q0 + q1 + q2 + 2) >> 2)
                    seg[k, x + 2] = _clip3(q2 - 2 * tc, q2 + 2 * tc,
                                           (p0 + q0 + q1 + 3 * q2 + 2 * q3
                                            + 4) >> 3)
                else:
                    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
                    if abs(delta) >= tc * 10:
                        continue
                    delta = _clip3(-tc, tc, delta)
                    seg[k, x - 1] = _clip3(0, maxv, p0 + delta)
                    seg[k, x] = _clip3(0, maxv, q0 - delta)
                    if dep1:
                        dp = _clip3(-(tc >> 1), tc >> 1,
                                    (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)
                        seg[k, x - 2] = _clip3(0, maxv, p1 + dp)
                    if deq1:
                        dq = _clip3(-(tc >> 1), tc >> 1,
                                    (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)
                        seg[k, x + 1] = _clip3(0, maxv, q1 + dq)


def _deblock_chroma_edges(plane, tusz8, qp_c, hc, wc, bd=8):
    """Vertical chroma edges in place. tusz8 is the LUMA leaf-TU map.
    qp_c: int, or the per-slot LUMA QP map (cu_qp_delta) — per-edge
    chroma Q maps the averaged side luma QPs through Table 8-10."""
    qmap = None if isinstance(qp_c, (int, np.integer)) else qp_c
    if qmap is None:
        tc0 = _DB_TC[_clip3(0, 53, qp_c + 2)] << (bd - 8)
        if tc0 == 0:
            return
    maxv = (1 << bd) - 1
    for xc in range(8, wc, 8):
        for yc in range(hc):
            sy, sx = (2 * yc) // 8, (2 * xc) // 8
            if sx % _tu_size8(tusz8, sy, sx):
                continue
            if qmap is None:
                tc = tc0
            else:
                qe = (int(qmap[sy, sx - 1]) + int(qmap[sy, sx]) + 1) >> 1
                qc = rom.chroma_qp_from_luma(qe)
                tc = _DB_TC[_clip3(0, 53, qc + 2)] << (bd - 8)
                if tc == 0:
                    continue
            p1, p0 = int(plane[yc, xc - 2]), int(plane[yc, xc - 1])
            q0, q1 = int(plane[yc, xc]), int(plane[yc, xc + 1])
            delta = _clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3))
            plane[yc, xc - 1] = _clip3(0, maxv, p0 + delta)
            plane[yc, xc] = _clip3(0, maxv, q0 - delta)


def deblock_frame_np(y, u, v, tusz8, qp, h, w, bd=8):
    """Scalar full-frame deblock: all vertical edges, then all horizontal
    edges on the transposed planes (8.7.2 filter order). Arrays are
    modified in place and returned. qp: int, or per-8x8-slot luma QP map
    (cu_qp_delta)."""
    scalar = isinstance(qp, (int, np.integer))
    qp_c = rom.chroma_qp_from_luma(qp) if scalar else qp
    _deblock_luma_edges(y, tusz8, qp, h, w, bd)
    _deblock_chroma_edges(u, tusz8, qp_c, h // 2, w // 2, bd)
    _deblock_chroma_edges(v, tusz8, qp_c, h // 2, w // 2, bd)
    yt, ut, vt = (np.ascontiguousarray(p.T) for p in (y, u, v))
    d8t = np.ascontiguousarray(tusz8.T)
    qpt = qp if scalar else np.ascontiguousarray(qp.T)
    qct = qp_c if scalar else qpt
    _deblock_luma_edges(yt, d8t, qpt, w, h, bd)
    _deblock_chroma_edges(ut, d8t, qct, w // 2, h // 2, bd)
    _deblock_chroma_edges(vt, d8t, qct, w // 2, h // 2, bd)
    return (np.ascontiguousarray(yt.T), np.ascontiguousarray(ut.T),
            np.ascontiguousarray(vt.T))


# ---------------------------------------------------------------------------
# SAO applier (8.7.3) — scalar/numpy, mirrors ops/sao.apply_sao.
# ---------------------------------------------------------------------------

_SAO_EO_NEIGHBORS = ((0, 1), (1, 0), (1, 1), (1, -1))


def _sao_plane_np(plane, sao, comp, h, w, span, bd=8):
    """Apply one component's SAO params in place. plane [H, W] (unpadded,
    exactly h x w); sao = dict of type/eo/bp/off per-CTU arrays."""
    tix = 0 if comp == 0 else 1
    out = plane.copy()
    maxv = (1 << bd) - 1
    rc, cc = sao["type"].shape[:2]
    for r in range(rc):
        for c in range(cc):
            typ = int(sao["type"][r, c, tix])
            if typ == 0:
                continue
            y0, x0 = r * span, c * span
            y1, x1 = min(y0 + span, h), min(x0 + span, w)
            if y0 >= h or x0 >= w:
                continue
            offs = sao["off"][r, c, comp]
            blk = plane[y0: y1, x0: x1].astype(np.int64)
            if typ == 1:  # band offset
                bp = int(sao["bp"][r, c, comp])
                band = blk >> (bd - 5)
                idx = band - bp
                sel = (idx >= 0) & (idx < 4)
                delta = np.where(sel, offs[np.clip(idx, 0, 3)], 0)
            else:  # edge offset
                dy, dx = _SAO_EO_NEIGHBORS[int(sao["eo"][r, c, tix])]
                delta = np.zeros_like(blk)
                for yy in range(blk.shape[0]):
                    for xx in range(blk.shape[1]):
                        py, px = y0 + yy, x0 + xx
                        ay, ax = py - dy, px - dx
                        by, bx = py + dy, px + dx
                        if not (0 <= ay < h and 0 <= ax < w
                                and 0 <= by < h and 0 <= bx < w):
                            continue
                        p = int(plane[py, px])
                        s = (int(np.sign(p - int(plane[ay, ax])))
                             + int(np.sign(p - int(plane[by, bx]))))
                        cat = {-2: 1, -1: 2, 0: 0, 1: 3, 2: 4}[s]
                        if cat:
                            delta[yy, xx] = offs[cat - 1]
            out[y0: y1, x0: x1] = np.clip(blk + delta, 0, maxv)
    plane[:] = out
    return plane


def sao_frame_np(y, u, v, sao, h, w, bd=8):
    """Apply decoded SAO params to a frame (after deblocking), in place."""
    _sao_plane_np(y, sao, 0, h, w, 64, bd)
    _sao_plane_np(u, sao, 1, h // 2, w // 2, 32, bd)
    _sao_plane_np(v, sao, 2, h // 2, w // 2, 32, bd)
    return y, u, v
