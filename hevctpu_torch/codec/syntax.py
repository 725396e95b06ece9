"""Slice-data syntax: the CTU/CU/TU CABAC layer, encoder and mirror decoder.

Equivalent of the reference's TEncSbac / TEncEntropy syntax coding
(TEncSbac.cpp:613-1540 — split flags, intra modes w/ MPM, CBFs, last-sig
position, coefficient groups with sig/gt1/gt2/sign/remaining) and the
TDecSbac mirror, written from H.265 7.3.8 / 9.3.3 / 9.3.4. Operates on the
per-slot decision arrays the TPU encoder emits (depth8 / coded8 / mode8 /
cbf planes / level planes).

Operating point (matches codec/headers.py): I-slices only, part 2Nx2N at
depths 0-2 and 2Nx2N/NxN at depth 3 (four 4x4 DST TUs with per-PU modes),
searched chroma mode, sign-data-hiding, intra TU quadtree splits to depth
3 (split_transform_flag), 4x4 transform-skip, SAO with merge-left/up.
"""

from __future__ import annotations

import numpy as np

from hevctpu_torch import rom
from hevctpu_torch.codec import headers
from hevctpu_torch.codec.bitio import BitWriter
from hevctpu_torch.codec.cabac import CabacDecoder, CabacEncoder, ContextSet


CHROMA_MODE_LIST = (rom.PLANAR_IDX, rom.VER_IDX, rom.HOR_IDX, rom.DC_IDX)


def resolve_chroma_mode(csel: int, luma_mode: int) -> int:
    """intra_chroma_pred_mode symbol -> prediction mode (H.265 Table 8-3):
    4 = derived (DM); 0..3 index {planar, ver, hor, dc}, with the entry
    equal to the luma mode substituted by angular 34."""
    if csel == 4:
        return luma_mode
    m = CHROMA_MODE_LIST[csel]
    return 34 if m == luma_mode else m


def derive_mpm(mode4: np.ndarray, x0: int, y0: int) -> list[int]:
    """3-entry most-probable-mode list (H.265 8.4.2). mode4 is the per-4x4
    luma mode map (PU granularity — NxN PUs are 4x4); unavailable or
    above-CTB neighbors count as DC."""
    if x0 == 0:
        cand_a = rom.DC_IDX
    else:
        cand_a = int(mode4[y0 // 4, (x0 - 1) // 4])
    if y0 == 0 or y0 % 64 == 0:
        cand_b = rom.DC_IDX
    else:
        cand_b = int(mode4[(y0 - 1) // 4, x0 // 4])
    if cand_a == cand_b:
        if cand_a < 2:
            return [rom.PLANAR_IDX, rom.DC_IDX, rom.VER_IDX]
        return [cand_a, 2 + ((cand_a + 29) % 32), 2 + ((cand_a - 2 + 1) % 32)]
    lst = [cand_a, cand_b]
    if rom.PLANAR_IDX not in lst:
        lst.append(rom.PLANAR_IDX)
    elif rom.DC_IDX not in lst:
        lst.append(rom.DC_IDX)
    else:
        lst.append(rom.VER_IDX)
    return lst


def _last_ctx(pos: int, log2: int, is_luma: bool):
    """(ctx_idx, uses_ctx_array) pairs for each prefix bin of the last-sig
    position (9.3.4.2.3)."""
    if is_luma:
        offset = 3 * (log2 - 2) + ((log2 - 1) >> 2)
        shift = (log2 + 1) >> 2
    else:
        offset = 0
        shift = log2 - 2
    return offset, shift


def _sig_ctx(x: int, y: int, log2: int, scan_idx: int, is_luma: bool,
             prev_csbf: int) -> int:
    """sig_coeff_flag ctxInc within the component's own context array
    (9.3.4.2.5)."""
    if log2 == 2:
        return int(rom.SIG_CTX_4X4[4 * y + x])
    if x == 0 and y == 0:
        return 0
    xp, yp = x & 3, y & 3
    if prev_csbf == 0:
        s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        s = 2
    if is_luma and (x >= 4 or y >= 4):
        s += 3
    if log2 == 3:
        s += (9 if scan_idx == rom.SCAN_DIAG else 15) if is_luma else 9
    else:
        s += 21 if is_luma else 12
    return s


def _prev_csbf(csbf, cgs, cy, cx, n):
    """right + 2*below coded_sub_block_flag pattern of a CG at (cy, cx)."""
    ncg = max(n // 4, 1)
    right = below = 0
    for k in range(len(cgs)):
        if cx + 1 < ncg and cgs[k, 0] == cy and cgs[k, 1] == cx + 1:
            right = int(csbf[k])
        if cy + 1 < ncg and cgs[k, 0] == cy + 1 and cgs[k, 1] == cx:
            below = int(csbf[k])
    return right + 2 * below


class _Walker:
    """Shared quadtree traversal driving either the encoder or decoder."""

    def __init__(self, cfg: headers.StreamConfig):
        self.cfg = cfg
        self.w = cfg.width
        self.h = cfg.height
        self.rc = -(-cfg.height // 64)
        self.cc = -(-cfg.width // 64)


class SliceEncoder(_Walker):
    """Serializes one frame's decisions into a slice-data RBSP."""

    def __init__(self, cfg, frame: dict, frame_idx: int = 0,
                 nal_type: int = headers.NAL_IDR_W_RADL, poc: int = 0):
        super().__init__(cfg)
        self.f = frame
        self.i = frame_idx
        self.nal_type = nal_type
        self.poc = poc
        self.depth8 = frame["depth8"][frame_idx]
        self.coded8 = frame["coded8"][frame_idx]
        mode8 = frame["mode8"][frame_idx]
        if "mode4" in frame:
            self.mode4 = frame["mode4"][frame_idx]
            self.nxn8 = frame["nxn8"][frame_idx]
            self.cbf4 = frame["cbf4_y"][frame_idx]
        else:  # legacy frame dict: 2Nx2N only
            self.mode4 = np.repeat(np.repeat(mode8, 2, 0), 2, 1)
            self.nxn8 = np.zeros_like(mode8, bool)
            self.cbf4 = None
        self.tusz8 = (frame["tusz8"][frame_idx] if "tusz8" in frame
                      else None)
        self.ts4 = frame["ts4_y"][frame_idx] if "ts4_y" in frame else None
        self.ts_c = {c: frame[k][frame_idx]
                     for c, k in ((1, "ts8_u"), (2, "ts8_v")) if k in frame}
        self.cbf = {0: frame["cbf_y"][frame_idx], 1: frame["cbf_u"][frame_idx],
                    2: frame["cbf_v"][frame_idx]}
        self.levels = {0: frame["levels_y"][frame_idx],
                       1: frame["levels_u"][frame_idx],
                       2: frame["levels_v"][frame_idx]}
        self.csel8 = (frame["csel8"][frame_idx] if "csel8" in frame
                      else np.full_like(self.depth8, 4))
        self.sao = None
        if cfg.sao:
            self.sao = {k: frame["sao_" + k][frame_idx]
                        for k in ("type", "eo", "bp", "off")}
            self.sao["merge"] = (frame["sao_merge"][frame_idx]
                                 if "sao_merge" in frame else None)
        # cu_qp_delta: per-CTU absolute QP map (qp_ctu [rc, cc]); CTUs
        # with no coded cbf inherit the predicted QP (no delta signaled),
        # so the map must already be inheritance-consistent.
        self.qp_ctu = None
        if cfg.cu_qp_delta:
            self.qp_ctu = (np.asarray(frame["qp_ctu"][frame_idx], np.int64)
                           if "qp_ctu" in frame
                           else np.full((self.rc, self.cc), cfg.qp))

    def encode(self) -> bytes:
        if self.cfg.wpp:
            return self._encode_wpp()
        bw = headers.write_slice_header(self.cfg, nal_type=self.nal_type,
                                        poc=self.poc)
        self.ctx = ContextSet(self.cfg.qp, init_type=0)
        self.c = CabacEncoder(bw)
        n_ctu = self.rc * self.cc
        self._qp_pred = self.cfg.qp
        for a in range(n_ctu):
            r, c = divmod(a, self.cc)
            self._code_ctu(r, c)
            self.c.encode_terminate(1 if a == n_ctu - 1 else 0)
        # terminate(1) flushed the engine, and the flush's final written bit
        # is the rbsp_stop_one_bit (9.3.4.3.5 note); only zero-align remains.
        bw.align_zero()
        return bw.data()

    def _code_ctu(self, r, c):
        if self.sao is not None:
            self._sao_params(r, c)
        self._qp_coded = False
        if self.qp_ctu is not None:
            self._qp_target = int(self.qp_ctu[r, c])
        self._quadtree(64 * c, 64 * r, 6)
        if self.qp_ctu is not None:
            if not self._qp_coded and self._qp_target != self._qp_pred:
                raise ValueError(
                    f"CTU ({r},{c}) codes no cbf but qp_ctu "
                    f"{self._qp_target} != predicted {self._qp_pred} — "
                    "the map must inherit where no delta is signaled")
            self._qp_pred = self._qp_target

    def _encode_wpp(self) -> bytes:
        """WPP slice (entropy_coding_sync, 7.3.8.1): one CABAC substream
        per CTU row. Contexts of row r>0 start from the snapshot taken
        after row r-1's SECOND CTU (9.3.1 storage/sync; HM
        m_entropyCodingSyncContextState, TEncSlice.cpp:1118-1141); each
        non-final row ends with end_of_slice_segment_flag=0 +
        end_of_subset_one_bit=1 + byte alignment, and the slice header
        carries the substreams' post-emulation-prevention byte sizes as
        entry points (TEncCavlc::codeTilesWPPEntryPoint)."""
        from hevctpu_torch.codec import bitio

        subs = []
        snap = None
        for r in range(self.rc):
            bw = bitio.BitWriter()
            self.ctx = ContextSet(self.cfg.qp, init_type=0)
            if r > 0 and self.cc > 1 and snap is not None:
                self.ctx.restore(snap)  # top-right CTU available (9.3.1)
            self.c = CabacEncoder(bw)
            # 8.6.1: the first QG of a WPP CTU row predicts from SliceQpY
            self._qp_pred = self.cfg.qp
            for c in range(self.cc):
                self._code_ctu(r, c)
                if c == 1:
                    snap = self.ctx.snapshot()
                last = r == self.rc - 1 and c == self.cc - 1
                self.c.encode_terminate(1 if last else 0)
            if r != self.rc - 1:
                self.c.encode_terminate(1)  # end_of_subset_one_bit
            bw.align_zero()
            subs.append(bw.data())
        # entry points: post-EP sizes of all substreams but the last;
        # substreams end in a nonzero byte (CABAC stop bit), so the
        # emulation-prevention zero-run never crosses a boundary and the
        # per-substream counts compose exactly.
        eps = [len(bitio.rbsp_to_ebsp(s)) for s in subs[:-1]]
        hdr = headers.write_slice_header(self.cfg, eps,
                                         nal_type=self.nal_type,
                                         poc=self.poc)
        return hdr.data() + b"".join(subs)

    def _maybe_code_delta(self):
        """cu_qp_delta_abs/sign at the first cbf-carrying transform_unit
        of the quantization group (7.3.8.10; binarization 9.3.3.10: TR
        cMax 5 with ctx 0 for the first bin and ctx 1 for bins 1..4, EG0
        bypass suffix, bypass sign)."""
        if self.qp_ctu is None or self._qp_coded:
            return
        self._qp_coded = True
        d = self._qp_target - self._qp_pred
        a = abs(d)
        tu = min(a, 5)
        self.c.encode_bin(self.ctx("cu_qp_delta_abs", 0), 1 if tu else 0)
        if not tu:
            return
        for _ in range(tu - 1):
            self.c.encode_bin(self.ctx("cu_qp_delta_abs", 1), 1)
        if tu < 5:
            self.c.encode_bin(self.ctx("cu_qp_delta_abs", 1), 0)
        if a >= 5:
            v, k = a - 5, 0
            while v >= (1 << k):
                self.c.encode_bypass(1)
                v -= 1 << k
                k += 1
            self.c.encode_bypass(0)
            for i in range(k - 1, -1, -1):
                self.c.encode_bypass((v >> i) & 1)
        self.c.encode_bypass(1 if d < 0 else 0)

    # -- SAO (7.3.8.3; binarizations 9.3.3) --------------------------------

    def _sao_params(self, r, c):
        """sao() for one CTU (7.3.8.3): merge-left/up flags (the decision
        of TEncSampleAdaptiveOffset deriveModeMergeRDO/decideBlkParams,
        restated densely in ops/sao.decide_params), then per-component
        type/offsets for non-merged CTUs."""
        m = 0
        if self.sao.get("merge") is not None:
            m = int(self.sao["merge"][r, c])
        if c > 0:
            self.c.encode_bin(self.ctx("sao_merge", 0), 1 if m == 1 else 0)
        if m != 1 and r > 0:
            self.c.encode_bin(self.ctx("sao_merge", 0), 1 if m == 2 else 0)
        if m:
            return
        for cidx in range(3):
            tix = 0 if cidx == 0 else 1
            typ = int(self.sao["type"][r, c, tix])
            if cidx < 2:  # sao_type_idx_luma / _chroma (TR cMax=2)
                self.c.encode_bin(self.ctx("sao_type_idx", 0),
                                  1 if typ else 0)
                if typ:
                    self.c.encode_bypass(typ - 1)  # 0 -> BO, 1 -> EO
            if typ == 0:
                continue
            offs = [int(v) for v in self.sao["off"][r, c, cidx]]
            for o in offs:
                v = abs(o)
                for _ in range(v):
                    self.c.encode_bypass(1)
                if v < 7:
                    self.c.encode_bypass(0)
            if typ == 1:  # BO
                for o in offs:
                    if o != 0:
                        self.c.encode_bypass(1 if o < 0 else 0)
                self.c.encode_bypass_bins(int(self.sao["bp"][r, c, cidx]), 5)
            elif cidx < 2:  # EO class, coded for luma and once for chroma
                self.c.encode_bypass_bins(int(self.sao["eo"][r, c, tix]), 2)

    # -- quadtree ----------------------------------------------------------

    def _quadtree(self, x0, y0, log2):
        if x0 >= self.w or y0 >= self.h:
            return
        size = 1 << log2
        d = 6 - log2
        inside = x0 + size <= self.w and y0 + size <= self.h
        split = self.depth8[y0 // 8, x0 // 8] > d
        if inside and log2 > 3:
            ctx = 0
            if x0 > 0 and self.depth8[y0 // 8, (x0 - 1) // 8] > d:
                ctx += 1
            if y0 > 0 and self.depth8[(y0 - 1) // 8, x0 // 8] > d:
                ctx += 1
            self.c.encode_bin(self.ctx("split_cu_flag", ctx), int(split))
        elif not inside:
            split = log2 > 3  # inferred
        if split:
            h = size // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                self._quadtree(x0 + dx, y0 + dy, log2 - 1)
        else:
            self._coding_unit(x0, y0, log2)

    def _coding_unit(self, x0, y0, log2):
        nxn = False
        if log2 == 3:
            nxn = bool(self.nxn8[y0 // 8, x0 // 8])
            # part_mode (9.3.3.7): 1 -> PART_2Nx2N, 0 -> PART_NxN
            self.c.encode_bin(self.ctx("part_mode", 0), 0 if nxn else 1)
        pus = ([(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]
               if nxn else [(x0, y0)])
        pmodes = [int(self.mode4[py // 4, px // 4]) for px, py in pus]
        mpms = [derive_mpm(self.mode4, px, py) for px, py in pus]
        # 7.3.8.5: all prev_intra_luma_pred_flags first, then per-PU payload
        for mode, mpm in zip(pmodes, mpms):
            self.c.encode_bin(self.ctx("prev_intra_luma_pred", 0),
                              int(mode in mpm))
        for mode, mpm in zip(pmodes, mpms):
            if mode in mpm:
                idx = mpm.index(mode)
                self.c.encode_bypass(min(idx, 1))
                if idx:
                    self.c.encode_bypass(idx - 1)
            else:
                rem = mode - sum(1 for m in sorted(mpm) if m < mode)
                self.c.encode_bypass_bins(rem, 5)
        csel = int(self.csel8[y0 // 8, x0 // 8])
        if csel == 4:  # derived (DM)
            self.c.encode_bin(self.ctx("intra_chroma_pred_mode", 0), 0)
        else:
            self.c.encode_bin(self.ctx("intra_chroma_pred_mode", 0), 1)
            self.c.encode_bypass_bins(csel, 2)
        cmode = resolve_chroma_mode(csel, pmodes[0])
        if nxn:
            self._transform_tree_nxn(x0, y0, pmodes, cmode)
        else:
            self._transform_tree(x0, y0, log2, log2, 0, True, True,
                                 pmodes[0], cmode)

    def _transform_tree_nxn(self, x0, y0, pmodes, cmode):
        """NxN CU: split_transform_flag inferred 1 (IntraSplitFlag, 7.3.8.8);
        four 4x4 DST luma TUs in z-order, chroma coded with the last one."""
        cb = self._node_cbf(1, x0, y0, 3)
        cr = self._node_cbf(2, x0, y0, 3)
        self.c.encode_bin(self.ctx("cbf_chroma", 0), int(cb))
        self.c.encode_bin(self.ctx("cbf_chroma", 0), int(cr))
        for k, (px, py) in enumerate(
                [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]):
            cbf_l = bool(self.cbf4[py // 4, px // 4])
            self.c.encode_bin(self.ctx("cbf_luma", 0), int(cbf_l))  # depth 1
            if cbf_l or (k == 3 and (cb or cr)):
                self._maybe_code_delta()
            if cbf_l:
                self._residual(px, py, 2, 0, pmodes[k])
        if cb:
            self._residual(x0 // 2, y0 // 2, 2, 1, cmode)
        if cr:
            self._residual(x0 // 2, y0 // 2, 2, 2, cmode)

    # -- transform tree ----------------------------------------------------

    def _node_cbf(self, comp, x0, y0, log2):
        s = 1 << (log2 - 3) if log2 >= 3 else 1
        sl = self.cbf[comp][y0 // 8: y0 // 8 + max(s, 1),
                            x0 // 8: x0 // 8 + max(s, 1)]
        return bool(sl.any())

    def _tu_leaf_log2(self, x0, y0):
        """log2 of the leaf TU covering 8x8 slot (x0, y0) (2 = the slot is
        coded as four 4x4 TUs). From the tusz8 plane if present, else the
        CU size (no TU split)."""
        if getattr(self, "tusz8", None) is not None:
            return int(self.tusz8[y0 // 8, x0 // 8])
        return None

    def _transform_tree(self, x0, y0, log2, cu_log2, depth, pcb, pcr, mode,
                        cmode):
        """transform_tree (7.3.8.8): explicit split_transform_flag down to
        max_transform_hierarchy_depth_intra (the reference operating point
        searches TU splits to depth 3, TEncSearch.cpp:1430-1448,
        encoder_intra_main.cfg:26-29)."""
        infer_split = log2 > 5
        tusz = self._tu_leaf_log2(x0, y0)
        present = (2 < log2 <= 5 and depth < self.cfg.max_tu_depth_intra)
        split = infer_split or (present and tusz is not None and tusz < log2)
        if present:
            self.c.encode_bin(self.ctx("split_transform_flag", 5 - log2),
                              int(split))
        code_chroma = log2 > 2
        cb = self._node_cbf(1, x0, y0, log2)
        cr = self._node_cbf(2, x0, y0, log2)
        if code_chroma:
            if pcb:
                self.c.encode_bin(self.ctx("cbf_chroma", depth), int(cb))
            if pcr:
                self.c.encode_bin(self.ctx("cbf_chroma", depth), int(cr))
        if split and log2 > 3:
            h = 1 << (log2 - 1)
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                self._transform_tree(x0 + dx, y0 + dy, log2 - 1, cu_log2,
                                     depth + 1, cb, cr, mode, cmode)
            return
        if split:  # log2 == 3: four 4x4 luma TUs, chroma stays at this node
            for k, (px, py) in enumerate(((x0, y0), (x0 + 4, y0),
                                          (x0, y0 + 4), (x0 + 4, y0 + 4))):
                cbf_l = bool(self.cbf4[py // 4, px // 4])
                self.c.encode_bin(self.ctx("cbf_luma", 0), int(cbf_l))
                if cbf_l or (k == 3 and (cb or cr)):
                    self._maybe_code_delta()
                if cbf_l:
                    self._residual(px, py, 2, 0, mode)
            if cb:
                self._residual(x0 // 2, y0 // 2, 2, 1, cmode)
            if cr:
                self._residual(x0 // 2, y0 // 2, 2, 2, cmode)
            return
        cbf_l = bool(self.cbf[0][y0 // 8, x0 // 8])
        self.c.encode_bin(self.ctx("cbf_luma", 1 if depth == 0 else 0),
                          int(cbf_l))
        if cbf_l or (code_chroma and (cb or cr)):
            self._maybe_code_delta()
        if cbf_l:
            self._residual(x0, y0, log2, 0, mode)
        if code_chroma:
            if cb:
                self._residual(x0 // 2, y0 // 2, log2 - 1, 1, cmode)
            if cr:
                self._residual(x0 // 2, y0 // 2, log2 - 1, 2, cmode)

    # -- residual coding ---------------------------------------------------

    def _residual(self, x0, y0, log2, comp, mode):
        n = 1 << log2
        blk = self.levels[comp][y0: y0 + n, x0: x0 + n]
        is_luma = comp == 0
        if self.cfg.transform_skip and log2 == 2:
            # transform_skip_flag (7.3.8.11, first element of
            # residual_coding; TComTrQuant xTransformSkip semantics)
            ts = False
            tsmap = self.ts4 if is_luma else self.ts_c.get(comp)
            if tsmap is not None:
                ts = bool(tsmap[y0 // 4, x0 // 4])
            self.c.encode_bin(self.ctx("transform_skip", 0 if is_luma else 1),
                              int(ts))
        scan_idx = rom.coef_scan_idx(mode, log2, is_luma)
        scan = rom.tb_scan(scan_idx, log2)
        coeffs = blk[scan[:, 0], scan[:, 1]]
        nz = np.nonzero(coeffs)[0]
        assert len(nz), "residual_coding called with all-zero block"
        last = int(nz[-1])

        lx, ly = int(scan[last, 1]), int(scan[last, 0])
        if scan_idx == rom.SCAN_VER:
            lx, ly = ly, lx
        self._code_last(lx, ly, log2, is_luma)

        num_cg = 1 << (2 * (log2 - 2))
        last_cg = last >> 4
        csbf = np.zeros(num_cg, dtype=bool)
        for cg in range(num_cg):
            csbf[cg] = bool(coeffs[16 * cg: 16 * cg + 16].any())
        cgs = rom.scan_order(scan_idx, max(n // 4, 1))

        name_cs = "coded_sub_block_luma" if is_luma else "coded_sub_block_chroma"
        name_sig = "sig_coeff_luma" if is_luma else "sig_coeff_chroma"
        name_g1 = "coeff_abs_gt1_luma" if is_luma else "coeff_abs_gt1_chroma"
        name_g2 = "coeff_abs_gt2_luma" if is_luma else "coeff_abs_gt2_chroma"
        gt1_carry = 1  # greater1Ctx at end of previous CG

        for cg in range(last_cg, -1, -1):
            cy, cx = int(cgs[cg, 0]), int(cgs[cg, 1])
            prev_csbf = _prev_csbf(csbf, cgs, cy, cx, n)
            csbf_coded = 0 < cg < last_cg
            if csbf_coded:
                self.c.encode_bin(self.ctx(name_cs, min(prev_csbf, 1)),
                                  int(csbf[cg]))
            if csbf_coded and not csbf[cg]:
                continue  # explicitly signaled all-zero group

            lo = 16 * cg
            infer_dc = csbf_coded  # inferSbDcSigCoeffFlag init (7.3.8.11)
            others_nonzero = any(coeffs[j] for j in range(lo + 1, lo + 16))
            start = last - 1 if cg == last_cg else lo + 15
            for i in range(start, lo - 1, -1):
                if i == lo and infer_dc and not others_nonzero:
                    break  # sig inferred 1
                yy, xx = int(scan[i, 0]), int(scan[i, 1])
                ctx = _sig_ctx(xx, yy, log2, scan_idx, is_luma, prev_csbf)
                self.c.encode_bin(self.ctx(name_sig, ctx),
                                  int(bool(coeffs[i])))

            sig_rev = [i for i in range(lo + 15, lo - 1, -1) if coeffs[i]]
            if not sig_rev:
                continue  # inferred-csbf group that is entirely zero
            # greater1 / greater2 / signs / remaining, reverse scan
            ctx_set = 0 if (cg == 0 or not is_luma) else 2
            if gt1_carry == 0:
                ctx_set += 1
            g1ctx = 1
            gt1_flags = {}
            for i in sig_rev[:8]:
                flag = int(abs(int(coeffs[i])) > 1)
                self.c.encode_bin(
                    self.ctx(name_g1, ctx_set * 4 + min(g1ctx, 3)), flag)
                gt1_flags[i] = flag
                if flag:
                    g1ctx = 0
                elif 0 < g1ctx < 3:
                    g1ctx += 1
            gt1_carry = g1ctx
            first_g1 = next((i for i in sig_rev[:8] if gt1_flags[i]), None)
            if first_g1 is not None:
                self.c.encode_bin(self.ctx(name_g2, ctx_set),
                                  int(abs(int(coeffs[first_g1])) > 2))
            # sign-data-hiding: the sign of the first-in-scan coefficient
            # (last of sig_rev) is inferred from the CG's abs-sum parity
            # when the nonzero span exceeds 3 (7.3.8.11; the encoder-side
            # parity fix is ops/quant.sign_bit_hide).
            hidden = (self.cfg.sign_data_hiding
                      and sig_rev[0] - sig_rev[-1] > 3)
            for i in (sig_rev[:-1] if hidden else sig_rev):
                self.c.encode_bypass(1 if coeffs[i] < 0 else 0)
            rice = 0
            for k, i in enumerate(sig_rev):
                v = abs(int(coeffs[i]))
                if k < 8:
                    if not gt1_flags[i]:
                        continue  # v == 1, fully coded by the flags
                    if i == first_g1 and v == 2:
                        continue  # gt2 == 0 closed it
                    base = 3 if i == first_g1 else 2
                else:
                    base = 1
                self._code_remaining(v - base, rice)
                if v > (3 << rice):
                    rice = min(rice + 1, 4)

    def _code_last(self, lx, ly, log2, is_luma):
        suffix_l = "luma" if is_luma else "chroma"
        offset, shift = _last_ctx(0, log2, is_luma)
        gmax = (log2 << 1) - 1
        for axis, val in (("x", lx), ("y", ly)):
            name = f"last_sig_{axis}_{suffix_l}"
            prefix = self._last_prefix(val)
            for b in range(min(prefix, gmax)):
                self.c.encode_bin(self.ctx(name, offset + (b >> shift)), 1)
            if prefix < gmax:
                self.c.encode_bin(self.ctx(name, offset + (prefix >> shift)), 0)
        for val in (lx, ly):
            prefix = self._last_prefix(val)
            if prefix > 3:
                nbits = (prefix >> 1) - 1
                suffix = val - ((2 + (prefix & 1)) << nbits)
                self.c.encode_bypass_bins(suffix, nbits)

    @staticmethod
    def _last_prefix(val):
        """last_sig_coeff prefix (group index) for a coordinate value."""
        if val <= 3:
            return val
        k = val.bit_length() - 1
        return 2 * k + (1 if val >= (3 << (k - 1)) else 0)

    def _code_remaining(self, v, c):
        q = v >> c
        if q < 4:
            self.c.encode_bypass_bins((1 << (q + 1)) - 2, q + 1)  # unary+0
            if c:
                self.c.encode_bypass_bins(v & ((1 << c) - 1), c)
        else:
            v2 = v - (4 << c)
            k = c + 1
            while v2 >= (1 << k):
                v2 -= 1 << k
                k += 1
            self.c.encode_bypass_bins((1 << (4 + k - c)) - 2, 4 + k - c)
            self.c.encode_bypass_bins(v2, k)


class SliceDecoder(_Walker):
    """Parses one slice's CABAC data back into decision arrays.

    Mirror of SliceEncoder — used by the verification decoder to prove the
    bitstream is self-consistent (and by tests against HM-class decoders).
    """

    def __init__(self, cfg, rbsp: bytes, data_offset: int,
                 entry_points: list | None = None):
        super().__init__(cfg)
        self.rbsp = rbsp
        self.offset = data_offset
        self.entry_points = entry_points  # WPP substream post-EP sizes
        h8, w8 = self.rc * 8, self.cc * 8
        self.depth8 = np.zeros((h8, w8), np.int32)
        self.coded8 = np.zeros((h8, w8), bool)
        self.mode4 = np.full((h8 * 2, w8 * 2), -1, np.int32)
        self.nxn8 = np.zeros((h8, w8), bool)
        self.cbf4 = np.zeros((h8 * 2, w8 * 2), bool)
        self.csel8 = np.full((h8, w8), 4, np.int32)
        self.tusz8 = np.zeros((h8, w8), np.int32)  # leaf TU log2 per slot
        self.ts4 = np.zeros((h8 * 2, w8 * 2), bool)    # luma 4x4 TS flags
        self.ts_c = {1: np.zeros((h8, w8), bool),      # chroma 4x4 TS flags
                     2: np.zeros((h8, w8), bool)}
        self.cbf = {0: np.zeros((h8, w8), bool), 1: np.zeros((h8, w8), bool),
                    2: np.zeros((h8, w8), bool)}
        self.levels = {0: np.zeros((self.rc * 64, self.cc * 64), np.int32),
                       1: np.zeros((self.rc * 32, self.cc * 32), np.int32),
                       2: np.zeros((self.rc * 32, self.cc * 32), np.int32)}
        self.tu_list = []  # (x0, y0, log2, comp, mode, cbf) in decode order
        # cu_qp_delta: reconstructed per-CTU QP (QG == CTB); filled during
        # decode, defaults to the slice QP when the feature is off.
        self.qp_ctu = np.full((self.rc, self.cc), cfg.qp, np.int32)
        self.sao = None
        if cfg.sao:
            self.sao = {
                "type": np.zeros((self.rc, self.cc, 2), np.int32),
                "eo": np.zeros((self.rc, self.cc, 2), np.int32),
                "bp": np.zeros((self.rc, self.cc, 3), np.int32),
                "off": np.zeros((self.rc, self.cc, 3, 4), np.int32)}

    def decode(self):
        if self.cfg.wpp:
            return self._decode_wpp()
        self.ctx = ContextSet(self.cfg.qp, init_type=0)
        self.c = CabacDecoder(self.rbsp, self.offset)
        n_ctu = self.rc * self.cc
        self._qp_pred = self.cfg.qp
        for a in range(n_ctu):
            r, c = divmod(a, self.cc)
            self._decode_ctu(r, c)
            end = self.c.decode_terminate()
            assert end == (1 if a == n_ctu - 1 else 0), (a, end)
        return self

    def _decode_ctu(self, r, c):
        if self.sao is not None:
            self._sao_params(r, c)
        self._qp_coded = False
        self._qp_cur = self._qp_pred
        self._quadtree(64 * c, 64 * r, 6)
        if self.cfg.cu_qp_delta:
            self.qp_ctu[r, c] = self._qp_cur
            self._qp_pred = self._qp_cur

    @staticmethod
    def _substream_rbsp_len(rbsp: bytes, start: int, ep_size: int) -> int:
        """Map one substream's entry-point size (post-emulation-prevention
        bytes, 7.4.7.1) back to its de-escaped RBSP length from `start`
        (the TAppDecoder entry-point adjustment role)."""
        zeros = 0
        out = 0
        i = start
        while out < ep_size and i < len(rbsp):
            b = rbsp[i]
            if zeros >= 2 and b <= 3:
                out += 1  # the emulation_prevention_three_byte
                zeros = 0
            out += 1
            zeros = zeros + 1 if b == 0 else 0
            i += 1
        from hevctpu_torch.codec import headers as _h
        if out != ep_size:
            raise _h.DecodeError(
                f"entry point offset {ep_size} overruns the slice data")
        return i - start

    def _decode_wpp(self):
        """Mirror of SliceEncoder._encode_wpp: per-row substreams at the
        entry-point offsets, contexts synced from the row above's second
        CTU (9.3.1)."""
        from hevctpu_torch.codec import headers as _h

        eps = self.entry_points or []
        if self.rc > 1 and len(eps) != self.rc - 1:
            raise _h.DecodeError(
                f"WPP slice has {len(eps)} entry points for "
                f"{self.rc} CTU rows")
        pos = self.offset
        snap = None
        for r in range(self.rc):
            self.ctx = ContextSet(self.cfg.qp, init_type=0)
            if r > 0 and self.cc > 1 and snap is not None:
                self.ctx.restore(snap)
            self.c = CabacDecoder(self.rbsp, pos)
            self._qp_pred = self.cfg.qp
            for c in range(self.cc):
                self._decode_ctu(r, c)
                if c == 1:
                    snap = self.ctx.snapshot()
                last = r == self.rc - 1 and c == self.cc - 1
                end = self.c.decode_terminate()
                if end != (1 if last else 0):
                    raise _h.DecodeError(
                        f"bad end_of_slice_segment_flag at CTU ({r},{c})")
            if r != self.rc - 1:
                if self.c.decode_terminate() != 1:
                    raise _h.DecodeError(
                        f"missing end_of_subset_one_bit after row {r}")
                pos += self._substream_rbsp_len(self.rbsp, pos, eps[r])
        return self

    def _maybe_decode_delta(self):
        """Mirror of SliceEncoder._maybe_code_delta (7.3.8.10/9.3.3.10);
        QpY update per 8.6.1 (8-bit: (pred + delta + 52) % 52)."""
        if not self.cfg.cu_qp_delta or self._qp_coded:
            return
        self._qp_coded = True
        tu = 0
        if self.c.decode_bin(self.ctx("cu_qp_delta_abs", 0)):
            tu = 1
            while tu < 5 and self.c.decode_bin(
                    self.ctx("cu_qp_delta_abs", 1)):
                tu += 1
        a = tu
        if tu == 5:
            base, k = 0, 0
            while self.c.decode_bypass():
                base += 1 << k
                k += 1
            v = 0
            for _ in range(k):
                v = (v << 1) | self.c.decode_bypass()
            a = 5 + base + v
        d = 0
        if a:
            d = -a if self.c.decode_bypass() else a
        self._qp_cur = (self._qp_pred + d + 52) % 52

    def _sao_params(self, r, c):
        m = 0
        if c > 0 and self.c.decode_bin(self.ctx("sao_merge", 0)):
            m = 1
        if m == 0 and r > 0 and self.c.decode_bin(self.ctx("sao_merge", 0)):
            m = 2
        if m:
            sr, sc = (r, c - 1) if m == 1 else (r - 1, c)
            for k in ("type", "eo", "bp", "off"):
                self.sao[k][r, c] = self.sao[k][sr, sc]
            return
        for cidx in range(3):
            tix = 0 if cidx == 0 else 1
            if cidx < 2:
                typ = 0
                if self.c.decode_bin(self.ctx("sao_type_idx", 0)):
                    typ = 1 + self.c.decode_bypass()
                self.sao["type"][r, c, tix] = typ
            typ = int(self.sao["type"][r, c, tix])
            if typ == 0:
                continue
            offs = []
            for _ in range(4):
                v = 0
                while v < 7 and self.c.decode_bypass():
                    v += 1
                offs.append(v)
            if typ == 1:  # BO
                for i in range(4):
                    if offs[i] and self.c.decode_bypass():
                        offs[i] = -offs[i]
                self.sao["bp"][r, c, cidx] = self.c.decode_bypass_bins(5)
            else:  # EO: categories 3,4 negative
                offs[2], offs[3] = -offs[2], -offs[3]
                if cidx < 2:
                    self.sao["eo"][r, c, tix] = self.c.decode_bypass_bins(2)
            self.sao["off"][r, c, cidx] = offs

    def _quadtree(self, x0, y0, log2):
        if x0 >= self.w or y0 >= self.h:
            return
        size = 1 << log2
        d = 6 - log2
        inside = x0 + size <= self.w and y0 + size <= self.h
        if inside and log2 > 3:
            ctx = 0
            if x0 > 0 and self.depth8[y0 // 8, (x0 - 1) // 8] > d:
                ctx += 1
            if y0 > 0 and self.depth8[(y0 - 1) // 8, x0 // 8] > d:
                ctx += 1
            split = bool(self.c.decode_bin(self.ctx("split_cu_flag", ctx)))
        elif not inside:
            split = log2 > 3
        else:
            split = False
        if split:
            h = size // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                self._quadtree(x0 + dx, y0 + dy, log2 - 1)
        else:
            s = size // 8
            self.depth8[y0 // 8: y0 // 8 + s, x0 // 8: x0 // 8 + s] = d
            self.coded8[y0 // 8: y0 // 8 + s, x0 // 8: x0 // 8 + s] = True
            self._coding_unit(x0, y0, log2)

    def _coding_unit(self, x0, y0, log2):
        nxn = False
        if log2 == 3:
            nxn = self.c.decode_bin(self.ctx("part_mode", 0)) == 0
            self.nxn8[y0 // 8, x0 // 8] = nxn
        pus = ([(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]
               if nxn else [(x0, y0)])
        flags = [self.c.decode_bin(self.ctx("prev_intra_luma_pred", 0))
                 for _ in pus]
        pmodes = []
        sp = 1 << (log2 - 2) if not nxn else 1
        for (px, py), flag in zip(pus, flags):
            mpm = derive_mpm(self.mode4, px, py)
            if flag:
                idx = self.c.decode_bypass()
                if idx:
                    idx += self.c.decode_bypass()
                mode = mpm[idx]
            else:
                mode = self.c.decode_bypass_bins(5)
                for m in sorted(mpm):
                    if mode >= m:
                        mode += 1
            pmodes.append(mode)
            self.mode4[py // 4: py // 4 + sp, px // 4: px // 4 + sp] = mode
        if self.c.decode_bin(self.ctx("intra_chroma_pred_mode", 0)):
            csel = self.c.decode_bypass_bins(2)
        else:
            csel = 4
        s = 1 << (log2 - 3)
        self.csel8[y0 // 8: y0 // 8 + s, x0 // 8: x0 // 8 + s] = csel
        cmode = resolve_chroma_mode(csel, pmodes[0])
        if nxn:
            self._transform_tree_nxn(x0, y0, pmodes, cmode)
        else:
            self._transform_tree(x0, y0, log2, log2, 0, True, True,
                                 pmodes[0], cmode)

    def _transform_tree_nxn(self, x0, y0, pmodes, cmode):
        self.tusz8[y0 // 8, x0 // 8] = 2
        cb = bool(self.c.decode_bin(self.ctx("cbf_chroma", 0)))
        cr = bool(self.c.decode_bin(self.ctx("cbf_chroma", 0)))
        for k, (px, py) in enumerate(
                [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)]):
            cbf_l = bool(self.c.decode_bin(self.ctx("cbf_luma", 0)))
            self.cbf4[py // 4, px // 4] = cbf_l
            if cbf_l or (k == 3 and (cb or cr)):
                self._maybe_decode_delta()
            if cbf_l:
                self._residual(px, py, 2, 0, pmodes[k])
            self.tu_list.append((px, py, 2, 0, pmodes[k], cbf_l))
        self.cbf[1][y0 // 8, x0 // 8] = cb
        self.cbf[2][y0 // 8, x0 // 8] = cr
        if cb:
            self._residual(x0 // 2, y0 // 2, 2, 1, cmode)
        self.tu_list.append((x0 // 2, y0 // 2, 2, 1, cmode, cb))
        if cr:
            self._residual(x0 // 2, y0 // 2, 2, 2, cmode)
        self.tu_list.append((x0 // 2, y0 // 2, 2, 2, cmode, cr))

    def _transform_tree(self, x0, y0, log2, cu_log2, depth, pcb, pcr, mode,
                        cmode):
        infer_split = log2 > 5
        present = (2 < log2 <= 5 and depth < self.cfg.max_tu_depth_intra)
        if infer_split:
            split = True
        elif present:
            split = bool(self.c.decode_bin(
                self.ctx("split_transform_flag", 5 - log2)))
        else:
            split = False
        code_chroma = log2 > 2
        cb = cr = False
        if code_chroma:
            if pcb:
                cb = bool(self.c.decode_bin(self.ctx("cbf_chroma", depth)))
            if pcr:
                cr = bool(self.c.decode_bin(self.ctx("cbf_chroma", depth)))
        if split and log2 > 3:
            h = 1 << (log2 - 1)
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                self._transform_tree(x0 + dx, y0 + dy, log2 - 1, cu_log2,
                                     depth + 1, cb, cr, mode, cmode)
            return
        if split:  # log2 == 3: four 4x4 luma TUs + chroma at this node
            self.tusz8[y0 // 8, x0 // 8] = 2
            for k, (px, py) in enumerate(((x0, y0), (x0 + 4, y0),
                                          (x0, y0 + 4), (x0 + 4, y0 + 4))):
                cbf_l = bool(self.c.decode_bin(self.ctx("cbf_luma", 0)))
                self.cbf4[py // 4, px // 4] = cbf_l
                if cbf_l or (k == 3 and (cb or cr)):
                    self._maybe_decode_delta()
                if cbf_l:
                    self._residual(px, py, 2, 0, mode)
                self.tu_list.append((px, py, 2, 0, mode, cbf_l))
            self.cbf[1][y0 // 8, x0 // 8] = cb
            self.cbf[2][y0 // 8, x0 // 8] = cr
            if cb:
                self._residual(x0 // 2, y0 // 2, 2, 1, cmode)
            self.tu_list.append((x0 // 2, y0 // 2, 2, 1, cmode, cb))
            if cr:
                self._residual(x0 // 2, y0 // 2, 2, 2, cmode)
            self.tu_list.append((x0 // 2, y0 // 2, 2, 2, cmode, cr))
            return
        s = 1 << (log2 - 3)
        self.tusz8[y0 // 8: y0 // 8 + s, x0 // 8: x0 // 8 + s] = log2
        cbf_l = bool(self.c.decode_bin(
            self.ctx("cbf_luma", 1 if depth == 0 else 0)))
        self.cbf[0][y0 // 8, x0 // 8] = cbf_l
        self.cbf[1][y0 // 8, x0 // 8] = cb
        self.cbf[2][y0 // 8, x0 // 8] = cr
        if cbf_l or (code_chroma and (cb or cr)):
            self._maybe_decode_delta()
        if cbf_l:
            self._residual(x0, y0, log2, 0, mode)
        self.tu_list.append((x0, y0, log2, 0, mode, cbf_l))
        if code_chroma:
            if cb:
                self._residual(x0 // 2, y0 // 2, log2 - 1, 1, cmode)
            self.tu_list.append((x0 // 2, y0 // 2, log2 - 1, 1, cmode, cb))
            if cr:
                self._residual(x0 // 2, y0 // 2, log2 - 1, 2, cmode)
            self.tu_list.append((x0 // 2, y0 // 2, log2 - 1, 2, cmode, cr))

    def _residual(self, x0, y0, log2, comp, mode):
        n = 1 << log2
        is_luma = comp == 0
        if self.cfg.transform_skip and log2 == 2:
            ts = bool(self.c.decode_bin(
                self.ctx("transform_skip", 0 if is_luma else 1)))
            if is_luma:
                self.ts4[y0 // 4, x0 // 4] = ts
            else:
                self.ts_c[comp][y0 // 4, x0 // 4] = ts
        scan_idx = rom.coef_scan_idx(mode, log2, is_luma)
        scan = rom.tb_scan(scan_idx, log2)
        coeffs = np.zeros(n * n, np.int32)

        lx = self._decode_last(log2, is_luma, "x")
        ly = self._decode_last(log2, is_luma, "y")
        lx = self._last_suffix(lx)
        ly = self._last_suffix(ly)
        if scan_idx == rom.SCAN_VER:
            lx, ly = ly, lx
        # scan position of the last coefficient
        pos_of = {(int(scan[i, 0]), int(scan[i, 1])): i for i in range(n * n)}
        last = pos_of[(ly, lx)]

        num_cg = max(n * n // 16, 1)
        last_cg = last >> 4
        csbf = np.zeros(num_cg, bool)
        csbf[last_cg] = True
        csbf[0] = True
        cgs = rom.scan_order(scan_idx, max(n // 4, 1))
        name_cs = "coded_sub_block_luma" if is_luma else "coded_sub_block_chroma"
        name_sig = "sig_coeff_luma" if is_luma else "sig_coeff_chroma"
        name_g1 = "coeff_abs_gt1_luma" if is_luma else "coeff_abs_gt1_chroma"
        name_g2 = "coeff_abs_gt2_luma" if is_luma else "coeff_abs_gt2_chroma"
        gt1_carry = 1

        for cg in range(last_cg, -1, -1):
            cy, cx = int(cgs[cg, 0]), int(cgs[cg, 1])
            prev_csbf = _prev_csbf(csbf, cgs, cy, cx, n)
            csbf_coded = 0 < cg < last_cg
            if csbf_coded:
                csbf[cg] = bool(self.c.decode_bin(
                    self.ctx(name_cs, min(prev_csbf, 1))))
            if not csbf[cg]:
                continue
            lo = 16 * cg
            infer_dc = csbf_coded  # inferSbDcSigCoeffFlag (7.3.8.11)
            sig = np.zeros(16, bool)
            if cg == last_cg:
                sig[last - lo] = True
                start = last - 1
            else:
                start = lo + 15
            for i in range(start, lo - 1, -1):
                if i == lo and infer_dc and not sig[1:].any():
                    sig[0] = True  # inferred
                    break
                yy, xx = int(scan[i, 0]), int(scan[i, 1])
                ctx = _sig_ctx(xx, yy, log2, scan_idx, is_luma, prev_csbf)
                sig[i - lo] = bool(self.c.decode_bin(self.ctx(name_sig, ctx)))
            sig_rev = [lo + k for k in range(15, -1, -1) if sig[k]]
            if not sig_rev:
                continue
            ctx_set = 0 if (cg == 0 or not is_luma) else 2
            if gt1_carry == 0:
                ctx_set += 1
            g1ctx = 1
            gt1_flags = {}
            for i in sig_rev[:8]:
                flag = self.c.decode_bin(
                    self.ctx(name_g1, ctx_set * 4 + min(g1ctx, 3)))
                gt1_flags[i] = flag
                if flag:
                    g1ctx = 0
                elif 0 < g1ctx < 3:
                    g1ctx += 1
            gt1_carry = g1ctx
            first_g1 = next((i for i in sig_rev[:8] if gt1_flags[i]), None)
            gt2 = 0
            if first_g1 is not None:
                gt2 = self.c.decode_bin(self.ctx(name_g2, ctx_set))
            hidden = (self.cfg.sign_data_hiding
                      and sig_rev[0] - sig_rev[-1] > 3)
            signs = [self.c.decode_bypass()
                     for _ in (sig_rev[:-1] if hidden else sig_rev)]
            rice = 0
            vals = []
            for k, i in enumerate(sig_rev):
                if k < 8 and not gt1_flags[i]:
                    v = 1
                elif k < 8 and i == first_g1 and not gt2:
                    v = 2
                else:
                    base = 1 if k >= 8 else (3 if i == first_g1 else 2)
                    v = base + self._decode_remaining(rice)
                    if v > (3 << rice):
                        rice = min(rice + 1, 4)
                vals.append(v)
            if hidden:
                signs.append(sum(vals) & 1)   # inferred sign (9.3.3.1 note)
            for k, i in enumerate(sig_rev):
                coeffs[i] = -vals[k] if signs[k] else vals[k]
        blk = coeffs  # scan-order vector -> block
        out = self.levels[comp]
        for i in range(n * n):
            out[y0 + int(scan[i, 0]), x0 + int(scan[i, 1])] = blk[i]

    def _decode_last(self, log2, is_luma, axis):
        name = f"last_sig_{axis}_{'luma' if is_luma else 'chroma'}"
        offset, shift = _last_ctx(0, log2, is_luma)
        gmax = (log2 << 1) - 1
        prefix = 0
        while prefix < gmax and self.c.decode_bin(
                self.ctx(name, offset + (prefix >> shift))):
            prefix += 1
        return prefix

    def _last_suffix(self, prefix):
        if prefix <= 3:
            return prefix
        nbits = (prefix >> 1) - 1
        suffix = self.c.decode_bypass_bins(nbits)
        return ((2 + (prefix & 1)) << nbits) + suffix

    def _decode_remaining(self, c):
        prefix = 0
        while prefix < 4 and self.c.decode_bypass():
            prefix += 1
        if prefix < 4:
            v = (prefix << c) + (self.c.decode_bypass_bins(c) if c else 0)
        else:
            k = c + 1
            while self.c.decode_bypass():
                k += 1
            base = 4 << c
            kk = c + 1
            add = 0
            while kk < k:
                add += 1 << kk
                kk += 1
            v = base + add + self.c.decode_bypass_bins(k)
        return v
