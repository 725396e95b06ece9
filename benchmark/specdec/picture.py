"""Slice data of an intra picture (7.3.8, 9.3) and its reconstruction
(8.4, 8.6): the coding quadtree, intra modes, the transform tree,
residual coding, intra sample prediction, scaling and the inverse
transforms. It keeps beside the picture every decision it parsed, so
that an encoder's own record of them can be held against the stream,
and, when given the source picture, it bounds each coded level by the
coefficient the encoder's quantiser started from (see QuantBound)."""

from __future__ import annotations

import numpy as np

from specdec import tables
from specdec.bits import StreamError
from specdec.cabac import Contexts, Decoder

PLANAR, DC, HOR, VER = 0, 1, 10, 26
CHROMA_CANDIDATES = (PLANAR, VER, HOR, DC)   # intra_chroma_pred_mode 0..3


class QuantBound:
    """An encoder's quantiser turns each coefficient c of the residual's
    forward transform into a level near |c| / step. RDOQ keeps, for each
    coefficient, the rounded level m, m - 1 or 0; sign hiding moves one
    level of a coefficient group by 1. So a coded level L is held to
    L == 0, or m - 2 <= |L| <= m + 1 with the sign of c. The forward
    transform is the integer one of the HM reference software, the
    inverse of 8.6.4.2 (first stage shift log2(N) - 1, second log2(N) +
    6; transform skip: the residual << 5 at 8 bits, 4x4)."""

    def __init__(self):
        self.coded = 0
        self.outside = 0

    def check(self, src, pred, levels, log2, qp, dst, ts):
        r = src.astype(np.int64) - pred
        if ts:
            c = r << (15 - 8 - log2)
        else:
            m = tables.DST4 if dst else tables.dct_matrix(1 << log2)
            s1, s2 = log2 - 1, log2 + 6
            t = (m @ r.T + (1 << (s1 - 1))) >> s1
            c = (m @ t.T + (1 << (s2 - 1))) >> s2
        qbits = 14 + qp // 6 + (15 - 8 - log2)
        mx = (np.abs(c) * tables.QUANT_SCALE[qp % 6]
              + (1 << (qbits - 1))) >> qbits
        a = np.abs(levels)
        nz = a != 0
        bad = nz & ((a > mx + 1) | (a < mx - 2)
                    | ((c != 0) & (np.sign(levels) != np.sign(c))))
        self.coded += int(nz.sum())
        self.outside += int(bad.sum())


class PictureDecoder:
    def __init__(self, sps, pps, sh, rbsp: bytes, source=None):
        self.sps, self.pps, self.sh = sps, pps, sh
        self.w, self.h = sps.width, sps.height
        if self.w % 8 or self.h % 8:
            raise StreamError("picture size not a multiple of 8")
        if sps.log2_min_cb != 3 or sps.log2_min_tb != 2:
            raise StreamError("this decoder expects 8x8 CUs and 4x4 TUs at "
                              "the least")
        self.cabac = Decoder(rbsp, sh.data_offset)
        self.ctx = Contexts(sh.qp)
        w, h = self.w, self.h
        self.qp = [sh.qp,
                   tables.qp_chroma(min(sh.qp + pps.cb_qp_offset
                                        + sh.cb_qp_offset, 57)),
                   tables.qp_chroma(min(sh.qp + pps.cr_qp_offset
                                        + sh.cr_qp_offset, 57))]
        self.rec = [np.zeros((h, w), np.int64),
                    np.zeros((h // 2, w // 2), np.int64),
                    np.zeros((h // 2, w // 2), np.int64)]
        self.done = [np.zeros((h, w), bool), np.zeros((h // 2, w // 2), bool),
                     np.zeros((h // 2, w // 2), bool)]
        self.source = source
        self.quant = QuantBound() if source is not None else None
        # what the stream decided
        h8, w8, h4, w4 = h // 8, w // 8, h // 4, w // 4
        self.depth8 = np.full((h8, w8), -1, np.int64)
        self.nxn8 = np.zeros((h8, w8), bool)
        self.csel8 = np.full((h8, w8), -1, np.int64)
        self.tusz8 = np.full((h8, w8), -1, np.int64)
        self.mode4 = np.full((h4, w4), -1, np.int64)
        self.tu4 = np.full((h4, w4), -1, np.int64)   # luma TU of each 4x4
        self.cbf_y = {}         # (x0, y0, log2) of each luma TU -> cbf
        self.cbf_c = {}         # (comp, x0, y0, luma log2) -> cbf
        self.ts = {}            # (comp, x0, y0) of each coded 4x4 -> flag
        self.levels = [np.zeros((h, w), np.int64),
                       np.zeros((h // 2, w // 2), np.int64),
                       np.zeros((h // 2, w // 2), np.int64)]
        rc = -(-h >> sps.log2_ctb)
        cc = -(-w >> sps.log2_ctb)
        self.sao_merge = np.zeros((rc, cc), np.int64)
        self.sao_type = np.zeros((rc, cc, 3), np.int64)
        self.sao_off = np.zeros((rc, cc, 3, 4), np.int64)
        self.sao_bp = np.zeros((rc, cc, 3), np.int64)
        self.sao_eo = np.zeros((rc, cc, 3), np.int64)
        self.sao_coded = np.zeros((rc, cc), bool)

    # -- slice data ---------------------------------------------------------

    def decode(self):
        ctb = self.sps.log2_ctb
        rc, cc = self.sao_merge.shape
        for a in range(rc * cc):
            ry, rx = divmod(a, cc)
            if self.sh.sao_luma or self.sh.sao_chroma:
                self._sao(rx, ry)
            self._quadtree(rx << ctb, ry << ctb, ctb, 0)
            end = self.cabac.terminate()
            if end != (a == rc * cc - 1):
                raise StreamError(f"end_of_slice_segment_flag {end} at CTU "
                                  f"{a} of {rc * cc}")
        self.cabac.finish()
        return self

    def _sao(self, rx, ry):
        d, c = self.cabac, self.ctx
        merge = 0
        if rx > 0 and d.decision(c["sao_merge"][0]):
            merge = 1
        if not merge and ry > 0 and d.decision(c["sao_merge"][0]):
            merge = 2
        self.sao_merge[ry, rx] = merge
        if merge:
            sy, sx = (ry, rx - 1) if merge == 1 else (ry - 1, rx)
            for arr in (self.sao_type, self.sao_off, self.sao_bp,
                        self.sao_eo):
                arr[ry, rx] = arr[sy, sx]
            return
        self.sao_coded[ry, rx] = True
        for cidx in range(3):
            on = self.sh.sao_luma if cidx == 0 else self.sh.sao_chroma
            if not on:
                continue
            if cidx < 2:
                typ = 0
                if d.decision(c["sao_type_idx"][0]):
                    typ = 2 if d.bypass() else 1
            else:
                typ = int(self.sao_type[ry, rx, 1])
            self.sao_type[ry, rx, cidx] = typ
            if typ == 0:
                continue
            mags = []
            for _ in range(4):
                v = 0
                while v < 7 and d.bypass():
                    v += 1
                mags.append(v)
            if typ == 1:
                offs = [-m if m and d.bypass() else m for m in mags]
                self.sao_bp[ry, rx, cidx] = d.bypass_bits(5)
            else:
                offs = [mags[0], mags[1], -mags[2], -mags[3]]
                if cidx < 2:
                    self.sao_eo[ry, rx, cidx] = d.bypass_bits(2)
                else:
                    self.sao_eo[ry, rx, 2] = self.sao_eo[ry, rx, 1]
            self.sao_off[ry, rx, cidx] = offs

    def _quadtree(self, x0, y0, log2, depth):
        size = 1 << log2
        if x0 + size <= self.w and y0 + size <= self.h and log2 > 3:
            inc = 0
            if x0 > 0 and self.depth8[y0 >> 3, (x0 - 1) >> 3] > depth:
                inc += 1
            if y0 > 0 and self.depth8[(y0 - 1) >> 3, x0 >> 3] > depth:
                inc += 1
            split = self.cabac.decision(self.ctx["split_cu_flag"][inc])
        else:
            split = log2 > 3
        if split:
            half = size >> 1
            for dy in (0, half):
                for dx in (0, half):
                    if x0 + dx < self.w and y0 + dy < self.h:
                        self._quadtree(x0 + dx, y0 + dy, log2 - 1, depth + 1)
            return
        s8 = size >> 3
        self.depth8[y0 >> 3: (y0 >> 3) + s8, x0 >> 3: (x0 >> 3) + s8] = depth
        self._coding_unit(x0, y0, log2)

    def _mpm(self, x, y):
        """8.4.2: the three most probable modes of the PU at (x, y)."""
        a = self.mode4[y >> 2, (x - 1) >> 2] if x > 0 else -1
        b = -1
        if y > 0 and (y - 1) >> self.sps.log2_ctb == y >> self.sps.log2_ctb:
            b = self.mode4[(y - 1) >> 2, x >> 2]
        a = DC if a < 0 else int(a)
        b = DC if b < 0 else int(b)
        if a == b:
            if a < 2:
                return [PLANAR, DC, VER]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        if PLANAR not in (a, b):
            c = PLANAR
        elif DC not in (a, b):
            c = DC
        else:
            c = VER
        return [a, b, c]

    def _coding_unit(self, x0, y0, log2):
        d, c = self.cabac, self.ctx
        size = 1 << log2
        nxn = False
        if log2 == self.sps.log2_min_cb:
            nxn = d.decision(c["part_mode"][0]) == 0
        pus = ([(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]
               if nxn else [(x0, y0)])
        pu = size >> 1 if nxn else size
        flags = [d.decision(c["prev_intra_luma_pred_flag"][0]) for _ in pus]
        modes = []
        for (px, py), flag in zip(pus, flags):
            mpm = self._mpm(px, py)
            if flag:
                idx = 0
                if d.bypass():
                    idx = 1 + d.bypass()
                mode = mpm[idx]
            else:
                mode = d.bypass_bits(5)
                for m in sorted(mpm):
                    if mode >= m:
                        mode += 1
            self.mode4[py >> 2: (py + pu) >> 2, px >> 2: (px + pu) >> 2] = mode
            modes.append(mode)
        csel = 4
        if d.decision(c["intra_chroma_pred_mode"][0]):
            csel = d.bypass_bits(2)
        if csel == 4:
            cmode = modes[0]
        else:
            cmode = CHROMA_CANDIDATES[csel]
            if cmode == modes[0]:
                cmode = 34
        s8 = size >> 3
        sl = (slice(y0 >> 3, (y0 >> 3) + s8), slice(x0 >> 3, (x0 >> 3) + s8))
        self.nxn8[sl] = nxn
        self.csel8[sl] = csel
        max_depth = self.sps.max_tu_depth_intra + (1 if nxn else 0)
        self._transform_tree(x0, y0, x0, y0, log2, 0, 0, max_depth, nxn,
                             modes, cmode, (True, True))

    def _transform_tree(self, x0, y0, xb, yb, log2, depth, blk, max_depth,
                        nxn, modes, cmode, parent_cbf):
        d, c = self.cabac, self.ctx
        sps = self.sps
        if (log2 <= sps.log2_max_tb and log2 > sps.log2_min_tb
                and depth < max_depth and not (nxn and depth == 0)):
            split = d.decision(c["split_transform_flag"][5 - log2])
        else:
            split = log2 > sps.log2_max_tb or (nxn and depth == 0)
        cbf_c = list(parent_cbf) if log2 == 2 else [False, False]
        if log2 > 2:
            for k in (0, 1):
                if depth == 0 or parent_cbf[k]:
                    cbf_c[k] = bool(d.decision(c["cbf_chroma"][depth]))
        if split:
            half = 1 << (log2 - 1)
            for k, (dx, dy) in enumerate(((0, 0), (half, 0), (0, half),
                                          (half, half))):
                self._transform_tree(x0 + dx, y0 + dy, x0, y0, log2 - 1,
                                     depth + 1, k, max_depth, nxn, modes,
                                     cmode, tuple(cbf_c))
            return
        cbf_l = bool(d.decision(c["cbf_luma"][1 if depth == 0 else 0]))
        mode = modes[blk] if nxn else modes[0]
        self.cbf_y[(x0, y0, log2)] = cbf_l
        n4 = 1 << (log2 - 2)
        self.tu4[y0 >> 2: (y0 >> 2) + n4, x0 >> 2: (x0 >> 2) + n4] = len(
            self.cbf_y)
        if log2 >= 3:
            s8 = 1 << (log2 - 3)
            self.tusz8[y0 >> 3: (y0 >> 3) + s8,
                       x0 >> 3: (x0 >> 3) + s8] = log2
        else:
            self.tusz8[y0 >> 3, x0 >> 3] = 2
        self._tu(0, x0, y0, log2, mode, cbf_l)
        if log2 > 2:
            for k in (0, 1):
                self.cbf_c[(k + 1, x0, y0, log2)] = cbf_c[k]
                self._tu(k + 1, x0 >> 1, y0 >> 1, log2 - 1, cmode, cbf_c[k])
        elif blk == 3:
            for k in (0, 1):
                self.cbf_c[(k + 1, xb, yb, 3)] = cbf_c[k]
                self._tu(k + 1, xb >> 1, yb >> 1, 2, cmode, cbf_c[k])

    # -- one transform block: residual, prediction, reconstruction ---------

    def _tu(self, comp, x0, y0, log2, mode, cbf):
        n = 1 << log2
        levels = None
        ts = False
        if cbf:
            levels, ts = self._residual(comp, x0, y0, log2, mode)
            self.levels[comp][y0: y0 + n, x0: x0 + n] = levels
        pred = self._predict(comp, x0, y0, log2, mode)
        rec = pred
        if cbf:
            if self.quant is not None and (
                    y0 + n <= self.source[comp].shape[0]
                    and x0 + n <= self.source[comp].shape[1]):
                self.quant.check(
                    self.source[comp][y0: y0 + n, x0: x0 + n], pred, levels,
                    log2, self.qp[comp], comp == 0 and log2 == 2, ts)
            rec = np.clip(pred + self._residual_samples(
                levels, log2, self.qp[comp], comp == 0 and log2 == 2, ts),
                0, 255)
        self.rec[comp][y0: y0 + n, x0: x0 + n] = rec
        self.done[comp][y0: y0 + n, x0: x0 + n] = True

    def _residual(self, comp, x0, y0, log2, mode):
        """residual_coding (7.3.8.11) -> (levels [y, x], transform skip)."""
        d, ctx = self.cabac, self.ctx
        luma = comp == 0
        ts = False
        if self.pps.transform_skip and log2 == 2:
            ts = bool(d.decision(ctx["transform_skip_flag"][0 if luma
                                                          else 1]))
            self.ts[(comp, x0, y0)] = ts
        # 7.4.9.11 scanIdx
        scan_idx = 0
        if log2 == 2 or (log2 == 3 and luma):
            if 6 <= mode <= 14:
                scan_idx = 2
            elif 22 <= mode <= 30:
                scan_idx = 1
        # last significant coefficient
        if luma:
            off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
        else:
            off, shift = 15, log2 - 2
        cmax = (log2 << 1) - 1
        pre = []
        for name in ("last_x_prefix", "last_y_prefix"):
            ctxs = ctx[name]
            v = 0
            while v < cmax and d.decision(ctxs[off + (v >> shift)]):
                v += 1
            pre.append(v)
        last = []
        for v in pre:
            if v > 3:
                nb = (v >> 1) - 1
                v = (1 << nb) * (2 + (v & 1)) + d.bypass_bits(nb)
            last.append(v)
        lx, ly = last
        if scan_idx == 2:
            lx, ly = ly, lx
        n = 1 << log2
        ncg = 1 << (log2 - 2)
        cg_scan = tables.scan(scan_idx, ncg)
        pos_scan = tables.scan(scan_idx, 4)
        last_cg = last_pos = None
        for i, (xs, ys) in enumerate(cg_scan):
            if xs == lx >> 2 and ys == ly >> 2:
                last_cg = i
                last_pos = pos_scan.index((lx & 3, ly & 3))
                break
        if last_cg is None or lx >= n or ly >= n:
            raise StreamError("last significant coefficient outside the "
                              "block")
        out = np.zeros((n, n), np.int64)
        csbf = np.zeros((ncg, ncg), bool)
        sdh = self.pps.sign_data_hiding
        g1_ctx_prev = None        # greater1Ctx at the end of the last CG
        sig_ctxs = ctx["sig_coeff_flag"]
        g1s, g2s = ctx["greater1"], ctx["greater2"]
        for i in range(last_cg, -1, -1):
            xs, ys = cg_scan[i]
            infer_dc = False
            if 0 < i < last_cg:
                inc = 0
                if xs + 1 < ncg:
                    inc += csbf[ys, xs + 1]
                if ys + 1 < ncg:
                    inc += csbf[ys + 1, xs]
                flag = d.decision(ctx["coded_sub_block_flag"][
                    min(inc, 1) + (0 if luma else 2)])
                csbf[ys, xs] = bool(flag)
                infer_dc = True
            else:
                csbf[ys, xs] = True
            prev = 0
            if xs + 1 < ncg and csbf[ys, xs + 1]:
                prev += 1
            if ys + 1 < ncg and csbf[ys + 1, xs]:
                prev += 2
            sig = [False] * 16
            start = 15
            if i == last_cg:
                sig[last_pos] = True
                start = last_pos - 1
            if csbf[ys, xs]:
                for p in range(start, -1, -1):
                    if p == 0 and infer_dc:
                        sig[0] = True
                        break
                    xp, yp = pos_scan[p]
                    xc, yc = (xs << 2) + xp, (ys << 2) + yp
                    if log2 == 2:
                        sc = tables.SIG_CTX_4x4[(yc << 2) + xc]
                    elif xc + yc == 0:
                        sc = 0
                    else:
                        if prev == 0:
                            sc = 2 if xp + yp == 0 else (1 if xp + yp < 3
                                                         else 0)
                        elif prev == 1:
                            sc = 2 if yp == 0 else (1 if yp == 1 else 0)
                        elif prev == 2:
                            sc = 2 if xp == 0 else (1 if xp == 1 else 0)
                        else:
                            sc = 2
                        if luma:
                            if xs > 0 or ys > 0:
                                sc += 3
                            if log2 == 3:
                                sc += 9 if scan_idx == 0 else 15
                            else:
                                sc += 21
                        else:
                            sc += 9 if log2 == 3 else 12
                    if d.decision(sig_ctxs[sc if luma else 27 + sc]):
                        sig[p] = True
                        infer_dc = False
            nzp = [p for p in range(15, -1, -1) if sig[p]]
            if not nzp:
                continue
            # greater1 / greater2 flags
            ctx_set = 0 if (i == 0 or not luma) else 2
            if g1_ctx_prev == 0:
                ctx_set += 1
            g1ctx = 1
            g1 = {}
            first_g1 = None
            for p in nzp[:8]:
                f = d.decision(g1s[ctx_set * 4 + min(g1ctx, 3)
                                   + (0 if luma else 16)])
                g1[p] = f
                if f:
                    g1ctx = 0
                    if first_g1 is None:
                        first_g1 = p
                elif g1ctx > 0:
                    g1ctx += 1
            g1_ctx_prev = g1ctx
            g2 = 0
            if first_g1 is not None:
                g2 = d.decision(g2s[ctx_set + (0 if luma else 4)])
            hidden = (sdh and nzp[0] - nzp[-1] > 3)
            signs = {}
            for p in nzp:
                if hidden and p == nzp[-1]:
                    signs[p] = 0
                else:
                    signs[p] = d.bypass()
            rice = 0
            total = 0
            for k, p in enumerate(nzp):
                base = 1 + g1.get(p, 0) + (g2 if p == first_g1 else 0)
                limit = (3 if p == first_g1 else 2) if k < 8 else 1
                val = base
                if base == limit:
                    val = base + self._remaining(rice)
                    if val > 3 * (1 << rice):
                        rice = min(rice + 1, 4)
                total += val
                lvl = -val if signs[p] else val
                if hidden and p == nzp[-1] and total % 2 == 1:
                    lvl = -lvl
                xp, yp = pos_scan[p]
                out[(ys << 2) + yp, (xs << 2) + xp] = lvl
        return out, ts

    def _remaining(self, rice):
        """coeff_abs_level_remaining (9.3.3.11)."""
        d = self.cabac
        prefix = 0
        while d.bypass():
            prefix += 1
            if prefix > 32:
                raise StreamError("coeff_abs_level_remaining too long")
        if prefix <= 3:
            return (prefix << rice) + d.bypass_bits(rice)
        nb = prefix - 3 + rice
        return (((1 << (prefix - 3)) + 3 - 1) << rice) + d.bypass_bits(nb)

    def _residual_samples(self, levels, log2, qp, dst, ts):
        """Scaling (8.6.3, flat) and the inverse transform (8.6.4.2) of
        one block at 8 bits."""
        bd = log2 + 3
        dq = ((levels * (16 * tables.LEVEL_SCALE[qp % 6]) << (qp // 6))
              + (1 << (bd - 1))) >> bd
        dq = np.clip(dq, -32768, 32767)
        if ts:
            r = dq << 7
        else:
            m = tables.DST4 if dst else tables.dct_matrix(1 << log2)
            e = m.T @ dq
            g = np.clip((e + 64) >> 7, -32768, 32767)
            r = g @ m
        return (r + 2048) >> 12

    def _predict(self, comp, x0, y0, log2, mode):
        """Intra sample prediction (8.4.4.2) of one block."""
        n = 1 << log2
        plane, done = self.rec[comp], self.done[comp]
        ph, pw = plane.shape
        # reference samples in substitution order: left column bottom to
        # top, the corner, the top row left to right (8.4.4.2.2)
        ys = np.arange(y0 + 2 * n - 1, y0 - 2, -1)
        xs = np.arange(x0, x0 + 2 * n)
        lv = np.zeros(2 * n + 1, np.int64)
        la = (ys < ph) & (x0 > 0)
        if x0 > 0:
            yy = np.minimum(ys, ph - 1)
            ok = la & (ys >= 0)
            ok[ok] = done[ys[ok], x0 - 1]
            la = ok
            lv[la] = plane[yy[la], x0 - 1]
        else:
            la = np.zeros(2 * n + 1, bool)
        tv = np.zeros(2 * n, np.int64)
        ta = np.zeros(2 * n, bool)
        if y0 > 0:
            ok = xs < pw
            ok[ok] = done[y0 - 1, xs[ok]]
            ta = ok
            tv[ta] = plane[y0 - 1, xs[ta]]
        ref = np.concatenate([lv, tv])
        avail = np.concatenate([la, ta])
        if not avail.any():
            ref[:] = 128
        else:
            if not avail[0]:
                ref[0] = ref[int(np.argmax(avail))]
            for i in range(1, len(ref)):
                if not avail[i]:
                    ref[i] = ref[i - 1]
        if comp == 0 and mode != DC and n != 4:
            dist = min(abs(mode - 26), abs(mode - 10))
            if dist > tables.FILTER_DIST_THRES[n]:
                ref = self._filter(ref, n)
        left = ref[2 * n - 1:: -1][: 2 * n]   # left[y], y = 0 .. 2n-1
        corner = int(ref[2 * n])
        top = ref[2 * n + 1:]                 # top[x], x = 0 .. 2n-1
        edge = comp == 0 and n < 32
        if mode == PLANAR:
            x = np.arange(n)[None, :]
            y = np.arange(n)[:, None]
            return ((n - 1 - x) * left[:n, None] + (x + 1) * top[n]
                    + (n - 1 - y) * top[None, :n] + (y + 1) * left[n]
                    + n) >> (log2 + 1)
        if mode == DC:
            dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (log2 + 1)
            pred = np.full((n, n), dc, np.int64)
            if edge:
                pred[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
                pred[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
                pred[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
            return pred
        angle = tables.INTRA_ANGLE[mode - 2]
        vertical = mode >= 18
        main, side = (top, left) if vertical else (left, top)
        # ref[k] at index k + n: k = -n .. 2n (+1 spare)
        r = np.zeros(3 * n + 2, np.int64)
        r[n] = corner
        r[n + 1: 3 * n + 1] = main
        if angle < 0 and (n * angle) >> 5 < -1:
            inv = tables.INV_ANGLE[mode]
            for k in range((n * angle) >> 5, 0):
                j = -1 + ((k * inv + 128) >> 8)
                r[n + k] = corner if j < 0 else side[j]
        t = np.arange(1, n + 1) * angle
        idx, fact = t >> 5, t & 31
        p = np.arange(n)
        a = r[n + p[None, :] + idx[:, None] + 1]
        b = r[n + p[None, :] + idx[:, None] + 2]
        pred = ((32 - fact[:, None]) * a + fact[:, None] * b + 16) >> 5
        # pred[j, p]: j along the prediction direction's distance, p across
        if not vertical:
            pred = pred.T
        pred = np.ascontiguousarray(pred)
        if edge and mode == VER:
            pred[:, 0] = np.clip(top[0] + ((left[:n] - corner) >> 1), 0, 255)
        if edge and mode == HOR:
            pred[0, :] = np.clip(left[0] + ((top[:n] - corner) >> 1), 0, 255)
        return pred

    def _filter(self, ref, n):
        """8.4.4.2.3: [1 2 1] smoothing, or the bi-linear strong intra
        smoothing of 32x32 luma blocks."""
        if n == 32 and self.sps.strong_intra_smoothing:
            bl, c, tr = int(ref[0]), int(ref[2 * n]), int(ref[4 * n])
            mid_l, mid_t = int(ref[n]), int(ref[3 * n])
            if abs(c + tr - 2 * mid_t) < 8 and abs(c + bl - 2 * mid_l) < 8:
                out = ref.copy()
                y = np.arange(63)
                left = ((63 - y) * c + (y + 1) * bl + 32) >> 6   # y = 0..62
                top = ((63 - y) * c + (y + 1) * tr + 32) >> 6
                out[1: 2 * n] = left[::-1]
                out[2 * n + 1: 4 * n] = top
                return out
        out = ref.copy()
        out[1:-1] = (ref[:-2] + 2 * ref[1:-1] + ref[2:] + 2) >> 2
        return out
