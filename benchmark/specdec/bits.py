"""NAL units, RBSP bit reading and the high-level syntax of H.265 (7.3.1 -
7.3.6, D.2.19) as far as an intra picture needs it. Every flag the
decoder does not implement is refused (Unsupported), never ignored."""

from __future__ import annotations

import dataclasses
import re

NAL_IDR_W_RADL, NAL_IDR_N_LP = 19, 20
NAL_VPS, NAL_SPS, NAL_PPS, NAL_SEI_PREFIX, NAL_SEI_SUFFIX = 32, 33, 34, 39, 40
SEI_DECODED_PICTURE_HASH = 132

_START = re.compile(b"\x00\x00\x01")


class Unsupported(Exception):
    """The stream uses a tool this decoder does not implement."""


class StreamError(Exception):
    """The stream breaks the syntax."""


def nal_units(data: bytes) -> list:
    """Annex B byte stream -> [(nal_unit_type, rbsp bytes)]."""
    marks = [m.end() for m in _START.finditer(data)]
    out = []
    for i, s in enumerate(marks):
        end = marks[i + 1] - 3 if i + 1 < len(marks) else len(data)
        nal = data[s:end]
        if i + 1 < len(marks):
            nal = nal.rstrip(b"\x00")          # trailing_zero_8bits
        if len(nal) < 2 or nal[0] & 0x80:
            raise StreamError("bad NAL unit header")
        kind = (nal[0] >> 1) & 0x3F
        out.append((kind, unescape(nal[2:])))
    return out


def unescape(payload: bytes) -> bytes:
    """Removes emulation_prevention_three_byte (7.4.2)."""
    return payload.replace(b"\x00\x00\x03", b"\x00\x00")


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos                      # in bits

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise StreamError("read past the end of the RBSP")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise StreamError("ue(v) too long")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0


def _profile_tier_level(br: BitReader, max_sub_layers_minus1: int):
    br.u(2 + 1 + 5)                 # profile space, tier, profile_idc
    br.u(32)                        # compatibility flags
    br.u(4)                         # progressive .. frame_only flags
    br.u(43)
    br.u(1)
    br.u(8)                         # general_level_idc
    sub = [(br.u(1), br.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            br.u(2)
    for prof, lev in sub:
        if prof:
            br.u(88)
        if lev:
            br.u(8)


@dataclasses.dataclass
class SPS:
    chroma_format_idc: int
    width: int
    height: int
    bit_depth: int
    bit_depth_chroma: int
    log2_min_cb: int
    log2_ctb: int
    log2_min_tb: int
    log2_max_tb: int
    max_tu_depth_intra: int
    sao: bool
    strong_intra_smoothing: bool
    conformance: tuple


def parse_sps(rbsp: bytes) -> SPS:
    br = BitReader(rbsp)
    br.u(4)
    msl = br.u(3)
    br.u(1)
    _profile_tier_level(br, msl)
    br.ue()                                       # sps id
    cf = br.ue()
    if cf != 1:
        raise Unsupported(f"chroma_format_idc {cf}")
    w, h = br.ue(), br.ue()
    conf = (0, 0, 0, 0)
    if br.u(1):
        conf = tuple(br.ue() for _ in range(4))
    bd, bdc = br.ue() + 8, br.ue() + 8
    br.ue()                                       # log2_max_poc_lsb - 4
    ordering = br.u(1)
    for _ in range(0 if ordering else msl, msl + 1):
        br.ue(), br.ue(), br.ue()
    min_cb = br.ue() + 3
    ctb = min_cb + br.ue()
    min_tb = br.ue() + 2
    max_tb = min_tb + br.ue()
    br.ue()                                       # depth inter
    depth_intra = br.ue()
    if br.u(1):
        raise Unsupported("scaling lists")
    br.u(1)                                       # amp
    sao = bool(br.u(1))
    if br.u(1):
        raise Unsupported("PCM")
    if br.ue() != 0:
        raise Unsupported("short-term reference picture sets in the SPS")
    if br.u(1):
        raise Unsupported("long-term reference pictures")
    br.u(1)                                       # temporal MVP
    sis = bool(br.u(1))
    if br.u(1):
        raise Unsupported("VUI")
    if br.u(1):
        raise Unsupported("SPS extensions")
    if bd != 8 or bdc != 8:
        raise Unsupported(f"bit depth {bd}/{bdc}")
    return SPS(cf, w, h, bd, bdc, min_cb, ctb, min_tb, max_tb, depth_intra,
               sao, sis, conf)


@dataclasses.dataclass
class PPS:
    sign_data_hiding: bool
    init_qp: int
    constrained_intra_pred: bool
    transform_skip: bool
    cb_qp_offset: int
    cr_qp_offset: int
    slice_chroma_qp_offsets_present: bool
    transquant_bypass: bool
    loop_filter_across_slices: bool
    deblocking_override_enabled: bool
    deblocking_disabled: bool
    beta_offset_div2: int
    tc_offset_div2: int
    num_extra_slice_header_bits: int
    output_flag_present: bool
    dependent_slices: bool
    slice_header_extension: bool


def parse_pps(rbsp: bytes) -> PPS:
    br = BitReader(rbsp)
    br.ue(), br.ue()                              # pps id, sps id
    dep = bool(br.u(1))
    out_flag = bool(br.u(1))
    extra = br.u(3)
    sdh = bool(br.u(1))
    br.u(1)                                       # cabac_init_present
    br.ue(), br.ue()
    init_qp = 26 + br.se()
    cip = bool(br.u(1))
    ts = bool(br.u(1))
    if br.u(1):
        raise Unsupported("cu_qp_delta")
    cb, cr = br.se(), br.se()
    chroma_offsets = bool(br.u(1))
    br.u(1), br.u(1)                              # weighted prediction
    tqb = bool(br.u(1))
    if br.u(1):
        raise Unsupported("tiles")
    if br.u(1):
        raise Unsupported("entropy coding sync (WPP)")
    across = bool(br.u(1))
    override, disabled, beta, tc = False, False, 0, 0
    if br.u(1):                                   # deblocking control
        override = bool(br.u(1))
        disabled = bool(br.u(1))
        if not disabled:
            beta, tc = br.se(), br.se()
    if br.u(1):
        raise Unsupported("scaling lists in the PPS")
    br.u(1)                                       # lists modification
    br.ue()                                       # parallel merge level
    ext = bool(br.u(1))
    if br.u(1):
        raise Unsupported("PPS extensions")
    if cip or tqb:
        raise Unsupported("constrained intra prediction or lossless CUs")
    return PPS(sdh, init_qp, cip, ts, cb, cr, chroma_offsets, tqb, across,
               override, disabled, beta, tc, extra, out_flag, dep, ext)


@dataclasses.dataclass
class SliceHeader:
    qp: int
    sao_luma: bool
    sao_chroma: bool
    cb_qp_offset: int
    cr_qp_offset: int
    deblocking_disabled: bool
    beta_offset_div2: int
    tc_offset_div2: int
    data_offset: int                  # byte offset of slice_data in the RBSP


def parse_slice_header(rbsp: bytes, kind: int, sps: SPS,
                       pps: PPS) -> SliceHeader:
    if kind not in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
        raise Unsupported(f"NAL unit type {kind}: only IDR pictures")
    br = BitReader(rbsp)
    if not br.u(1):
        raise Unsupported("more than one slice segment a picture")
    br.u(1)                                       # no_output_of_prior_pics
    br.ue()                                       # pps id
    br.u(pps.num_extra_slice_header_bits)
    if br.ue() != 2:
        raise Unsupported("a slice other than I")
    if pps.output_flag_present:
        br.u(1)
    sao_l = sao_c = False
    if sps.sao:
        sao_l, sao_c = bool(br.u(1)), bool(br.u(1))
    qp = pps.init_qp + br.se()
    cbo = cro = 0
    if pps.slice_chroma_qp_offsets_present:
        cbo, cro = br.se(), br.se()
    disabled, beta, tc = (pps.deblocking_disabled, pps.beta_offset_div2,
                          pps.tc_offset_div2)
    if pps.deblocking_override_enabled and br.u(1):
        disabled = bool(br.u(1))
        if not disabled:
            beta, tc = br.se(), br.se()
    if pps.loop_filter_across_slices and (sao_l or sao_c or not disabled):
        br.u(1)
    if pps.slice_header_extension:
        br.u(8 * br.ue())
    if br.u(1) != 1:                              # byte_alignment()
        raise StreamError("slice header alignment bit")
    while not br.byte_aligned():
        if br.u(1):
            raise StreamError("slice header alignment")
    return SliceHeader(qp, sao_l, sao_c, cbo, cro, disabled, beta, tc,
                       br.pos // 8)


def picture_hash(rbsp: bytes):
    """The decoded picture hash SEI messages of a suffix SEI RBSP:
    [(hash_type, [value of each colour component])]."""
    out, i = [], 0
    while i < len(rbsp) and rbsp[i:] != b"\x80":
        ptype = 0
        while rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        size = 0
        while rbsp[i] == 0xFF:
            size += 255
            i += 1
        size += rbsp[i]
        i += 1
        body = rbsp[i:i + size]
        i += size
        if ptype == SEI_DECODED_PICTURE_HASH:
            kind = body[0]
            width = {0: 16, 1: 2, 2: 4}[kind]
            vals = [int.from_bytes(body[1 + c * width: 1 + (c + 1) * width],
                                   "big") for c in range(3)]
            out.append((kind, vals))
    return out
