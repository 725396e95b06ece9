"""Parameter-set and slice-header writers/parsers for the All-Intra
operating point.

Equivalent of the reference's TEncCavlc parameter-set writers
(TEncCavlc.cpp codeVPS/codeSPS/codePPS/codeSliceHeader) but for the fixed
IDR-only configuration this encoder emits: Main profile 4:2:0 8-bit, CTB 64,
CU 8..64 with 2Nx2N/NxN intra partitions, TU 4..32 (intra-split only),
sign-data-hiding, SAO + deblocking, every frame an IDR (the reference's
IntraPeriod=1 / GOPSize=1 cfg, encoder_intra_main.cfg). Syntax follows
H.265 7.3.2-7.3.6.
"""

from __future__ import annotations

import dataclasses
import functools

from hevctpu_torch.codec.bitio import BitReader, BitWriter

NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_SEI_PREFIX = 39
NAL_SEI_SUFFIX = 40

SEI_ACTIVE_PARAMETER_SETS = 129
SEI_DECODED_PICTURE_HASH = 132
SEI_RECOVERY_POINT = 6
SEI_USER_DATA_UNREGISTERED = 5


@dataclasses.dataclass
class StreamConfig:
    width: int
    height: int
    qp: int
    strong_intra_smoothing: bool = True
    sign_data_hiding: bool = True
    max_tu_depth_intra: int = 3
    transform_skip: bool = True
    deblock: bool = True
    sao: bool = True
    # decoded-picture-hash SEI type (D.3.19): "md5" | "crc" | "checksum"
    # | "none". The reference supports all three (TComPicYuvMD5.cpp:
    # 129-227); HM's default is MD5.
    hash_type: str = "md5"
    # cu_qp_delta_enabled_flag (7.4.3.3.2): per-quantization-group QP
    # deltas (LCU-level rate control, TEncRateCtrl.cpp:845). Only
    # diff_cu_qp_delta_depth = 0 is emitted (QG == CTB).
    cu_qp_delta: bool = False
    # entropy_coding_sync_enabled_flag (WPP, 7.4.3.3.2): one CABAC
    # substream per CTU row, contexts synced from the row above's second
    # CTU (9.3.1), entry-point offsets in the slice header (7.3.6.1) —
    # the bitstream form of the encoder's wavefront (TEncSlice.cpp:
    # 1118-1141).
    wpp: bool = False


def _profile_tier_level(bw: BitWriter):
    bw.u(0, 2)            # general_profile_space
    bw.u(0, 1)            # general_tier_flag
    bw.u(1, 5)            # general_profile_idc = Main
    bw.u(1 << 30, 32)     # compatibility flags: profile 1
    bw.u(1, 1)            # general_progressive_source_flag
    bw.u(0, 1)            # general_interlaced_source_flag
    bw.u(0, 1)            # general_non_packed_constraint_flag
    bw.u(0, 1)            # general_frame_only_constraint_flag
    bw.u(0, 32)           # reserved 44 bits
    bw.u(0, 12)
    bw.u(120, 8)          # general_level_idc (4.0)


def _skip_ptl(br: BitReader):
    br.u(2 + 1 + 5)
    br.u(32)
    br.u(4)
    br.u(32)
    br.u(12)
    br.u(8)


def write_vps(cfg: StreamConfig) -> bytes:
    bw = BitWriter()
    bw.u(0, 4)            # vps_video_parameter_set_id
    bw.u(1, 1)            # vps_base_layer_internal_flag
    bw.u(1, 1)            # vps_base_layer_available_flag
    bw.u(0, 6)            # vps_max_layers_minus1
    bw.u(0, 3)            # vps_max_sub_layers_minus1
    bw.u(1, 1)            # vps_temporal_id_nesting_flag
    bw.u(0xFFFF, 16)      # vps_reserved_0xffff_16bits
    _profile_tier_level(bw)
    bw.flag(0)            # vps_sub_layer_ordering_info_present_flag
    bw.ue(1)              # vps_max_dec_pic_buffering_minus1
    bw.ue(0)              # vps_max_num_reorder_pics
    bw.ue(0)              # vps_max_latency_increase_plus1
    bw.u(0, 6)            # vps_max_layer_id
    bw.ue(0)              # vps_num_layer_sets_minus1
    bw.flag(0)            # vps_timing_info_present_flag
    bw.flag(0)            # vps_extension_flag
    bw.byte_align_rbsp()
    return bw.data()


def write_sps(cfg: StreamConfig) -> bytes:
    bw = BitWriter()
    bw.u(0, 4)            # sps_video_parameter_set_id
    bw.u(0, 3)            # sps_max_sub_layers_minus1
    bw.u(1, 1)            # sps_temporal_id_nesting_flag
    _profile_tier_level(bw)
    bw.ue(0)              # sps_seq_parameter_set_id
    bw.ue(1)              # chroma_format_idc = 4:2:0
    bw.ue(cfg.width)
    bw.ue(cfg.height)
    bw.flag(0)            # conformance_window_flag
    bw.ue(0)              # bit_depth_luma_minus8
    bw.ue(0)              # bit_depth_chroma_minus8
    bw.ue(4)              # log2_max_pic_order_cnt_lsb_minus4
    bw.flag(0)            # sps_sub_layer_ordering_info_present_flag
    bw.ue(1)              # sps_max_dec_pic_buffering_minus1
    bw.ue(0)              # sps_max_num_reorder_pics
    bw.ue(0)              # sps_max_latency_increase_plus1
    bw.ue(0)              # log2_min_luma_coding_block_size_minus3 -> 8
    bw.ue(3)              # log2_diff_max_min -> CTB 64
    bw.ue(0)              # log2_min_luma_transform_block_size_minus2 -> 4
    bw.ue(3)              # log2_diff -> max TB 32
    bw.ue(0)              # max_transform_hierarchy_depth_inter
    bw.ue(cfg.max_tu_depth_intra)  # max_transform_hierarchy_depth_intra
    bw.flag(0)            # scaling_list_enabled_flag
    bw.flag(0)            # amp_enabled_flag
    bw.flag(1 if cfg.sao else 0)  # sample_adaptive_offset_enabled_flag
    bw.flag(0)            # pcm_enabled_flag
    bw.ue(0)              # num_short_term_ref_pic_sets
    bw.flag(0)            # long_term_ref_pics_present_flag
    bw.flag(0)            # sps_temporal_mvp_enabled_flag
    bw.flag(cfg.strong_intra_smoothing)
    bw.flag(0)            # vui_parameters_present_flag
    bw.flag(0)            # sps_extension_present_flag
    bw.byte_align_rbsp()
    return bw.data()


def write_pps(cfg: StreamConfig) -> bytes:
    bw = BitWriter()
    bw.ue(0)              # pps_pic_parameter_set_id
    bw.ue(0)              # pps_seq_parameter_set_id
    bw.flag(0)            # dependent_slice_segments_enabled_flag
    bw.flag(0)            # output_flag_present_flag
    bw.u(0, 3)            # num_extra_slice_header_bits
    bw.flag(cfg.sign_data_hiding)
    bw.flag(0)            # cabac_init_present_flag
    bw.ue(0)              # num_ref_idx_l0_default_active_minus1
    bw.ue(0)              # num_ref_idx_l1_default_active_minus1
    bw.se(0)              # init_qp_minus26
    bw.flag(0)            # constrained_intra_pred_flag
    bw.flag(1 if cfg.transform_skip else 0)  # transform_skip_enabled_flag
    bw.flag(1 if cfg.cu_qp_delta else 0)     # cu_qp_delta_enabled_flag
    if cfg.cu_qp_delta:
        bw.ue(0)          # diff_cu_qp_delta_depth (QG == CTB)
    bw.se(0)              # pps_cb_qp_offset
    bw.se(0)              # pps_cr_qp_offset
    bw.flag(0)            # pps_slice_chroma_qp_offsets_present_flag
    bw.flag(0)            # weighted_pred_flag
    bw.flag(0)            # weighted_bipred_flag
    bw.flag(0)            # transquant_bypass_enabled_flag
    bw.flag(0)            # tiles_enabled_flag
    bw.flag(1 if cfg.wpp else 0)  # entropy_coding_sync_enabled_flag
    bw.flag(1)            # pps_loop_filter_across_slices_enabled_flag
    bw.flag(1)            # deblocking_filter_control_present_flag
    bw.flag(0)            # deblocking_filter_override_enabled_flag
    bw.flag(0 if cfg.deblock else 1)  # pps_deblocking_filter_disabled_flag
    if cfg.deblock:
        bw.se(0)          # pps_beta_offset_div2
        bw.se(0)          # pps_tc_offset_div2
    bw.flag(0)            # pps_scaling_list_data_present_flag
    bw.flag(0)            # lists_modification_present_flag
    bw.ue(0)              # log2_parallel_merge_level_minus2
    bw.flag(0)            # slice_segment_header_extension_present_flag
    bw.flag(0)            # pps_extension_present_flag
    bw.byte_align_rbsp()
    return bw.data()


def plane_md5(plane) -> bytes:
    """MD5 of one 8-bit sample plane, row-major (TComPicYuvMD5::calcMD5
    semantics, TComPicYuvMD5.cpp:185 — one byte per sample at bit depth 8,
    over the conformance-window picture, no padding)."""
    import hashlib
    import numpy as np
    return hashlib.md5(
        np.ascontiguousarray(plane).astype(np.uint8).tobytes()).digest()


@functools.lru_cache(maxsize=None)
def _crc_top_table():
    """T[h] = the 16-bit value after shifting 8 zero data bits through the
    CRC register starting from h<<8 (poly 0x1021). Per-byte step of the
    reference's bit-serial loop (TComPicYuvMD5.cpp:95-117): data bits
    enter at the BOTTOM of the register, so one byte advances as
    crc' = (((crc & 0xff) << 8) | byte) ^ T[crc >> 8]."""
    tab = []
    for h in range(256):
        c = h << 8
        for _ in range(8):
            msb = (c >> 15) & 1
            c = ((c << 1) & 0xffff) ^ (msb * 0x1021)
        tab.append(c)
    return tab


def plane_crc(plane) -> bytes:
    """16-bit CRC of one 8-bit sample plane (TComPicYuvMD5::compCRC
    semantics, TComPicYuvMD5.cpp:90-127: init 0xffff, poly 0x1021, data
    bits entering at the register bottom MSB-first, then 16 flush bits).
    Returns 2 bytes big-endian, the SEI digest order."""
    import numpy as np
    tab = _crc_top_table()
    crc = 0xffff
    for byte in np.ascontiguousarray(plane).astype(np.uint8).tobytes():
        crc = (((crc & 0xff) << 8) | byte) ^ tab[crc >> 8]
    # 16 zero flush bits == two zero-byte steps without data.
    crc = ((crc & 0xff) << 8) ^ tab[crc >> 8]
    crc = ((crc & 0xff) << 8) ^ tab[crc >> 8]
    return bytes([(crc >> 8) & 0xff, crc & 0xff])


def plane_checksum(plane) -> bytes:
    """32-bit positional checksum of one 8-bit plane
    (TComPicYuvMD5::compChecksum, TComPicYuvMD5.cpp:141-166:
    sum of pel ^ xor_mask(x, y) mod 2^32). 4 bytes big-endian."""
    import numpy as np
    p = np.asarray(plane)
    h, w = p.shape
    x = np.arange(w, dtype=np.uint32)
    y = np.arange(h, dtype=np.uint32)
    xm = (x & 0xff) ^ (x >> 8)
    ym = (y & 0xff) ^ (y >> 8)
    mask = (ym[:, None] ^ xm[None, :]) & 0xff
    s = ((p.astype(np.uint32) & 0xff) ^ mask).sum(dtype=np.uint64)
    s = int(s) & 0xffffffff
    return bytes([(s >> 24) & 0xff, (s >> 16) & 0xff,
                  (s >> 8) & 0xff, s & 0xff])


# hash_type code points (D.3.19) and per-plane digest lengths.
_HASH_CODE = {"md5": 0, "crc": 1, "checksum": 2}
_HASH_LEN = {"md5": 16, "crc": 2, "checksum": 4}
_HASH_FN = {"md5": plane_md5, "crc": plane_crc, "checksum": plane_checksum}


def write_hash_sei_digests(digests, hash_type: str = "md5") -> bytes:
    """Decoded-picture-hash suffix-SEI RBSP from precomputed per-plane
    digests (D.2.19 syntax; SEIEncoder initDecodedPictureHashSEI role,
    called at TEncGOP.cpp:1948)."""
    n = _HASH_LEN[hash_type]
    assert len(digests) == 3 and all(len(d) == n for d in digests)
    payload = bytes([_HASH_CODE[hash_type]])
    for d in digests:
        payload += bytes(d)
    bw = BitWriter()
    bw.u(SEI_DECODED_PICTURE_HASH, 8)   # payload type (< 255, one byte)
    bw.u(len(payload), 8)               # payload size
    for byte in payload:
        bw.u(byte, 8)
    bw.byte_align_rbsp()                # rbsp_trailing_bits
    return bw.data()


def _sei_rbsp(payload_type: int, payload: bytes) -> bytes:
    """One SEI message in an RBSP (7.3.5: ff-escaped type/size bytes;
    SEIwrite.cpp xWriteSEIpayloadData framing)."""
    bw = BitWriter()
    t = payload_type
    while t >= 255:
        bw.u(255, 8)
        t -= 255
    bw.u(t, 8)
    s = len(payload)
    while s >= 255:
        bw.u(255, 8)
        s -= 255
    bw.u(s, 8)
    for byte in payload:
        bw.u(byte, 8)
    bw.byte_align_rbsp()
    return bw.data()


def write_active_parameter_sets_sei() -> bytes:
    """active_parameter_sets SEI (D.2.21; SEIEncoder::
    initActiveParameterSetsSEI): names the active VPS/SPS ids — both 0
    in this encoder's streams."""
    bw = BitWriter()
    bw.u(0, 4)     # active_video_parameter_set_id
    bw.flag(1)     # self_contained_cvs_flag (every IRAP starts a CVS)
    bw.flag(0)     # no_parameter_set_update_flag
    bw.ue(0)       # num_sps_ids_minus1
    bw.ue(0)       # active_seq_parameter_set_id[0]
    bw.byte_align_rbsp()
    return _sei_rbsp(SEI_ACTIVE_PARAMETER_SETS, bw.data())


def write_recovery_point_sei(recovery_poc_cnt: int = 0,
                             exact_match: bool = True) -> bytes:
    """recovery_point SEI (D.2.8; SEIEncoder::initSEIRecoveryPoint) —
    for All-Intra every picture is its own recovery point."""
    bw = BitWriter()
    bw.se(recovery_poc_cnt)
    bw.flag(exact_match)
    bw.flag(0)     # broken_link_flag
    bw.byte_align_rbsp()
    return _sei_rbsp(SEI_RECOVERY_POINT, bw.data())


def write_user_data_sei(uuid: bytes, data: bytes) -> bytes:
    """user_data_unregistered SEI (D.2.7)."""
    assert len(uuid) == 16
    return _sei_rbsp(SEI_USER_DATA_UNREGISTERED, uuid + data)


def parse_sei_messages(rbsp: bytes):
    """[(payload_type, payload_bytes)] of every message in an SEI RBSP
    (7.3.5 framing; unknown payload types are returned, not rejected —
    the SEIread discard-with-warning discipline)."""
    out = []
    i = 0
    n = len(rbsp)
    while i < n:
        if rbsp[i] == 0x80 and i == n - 1:
            break  # rbsp_trailing_bits
        t = 0
        while i < n and rbsp[i] == 255:
            t += 255
            i += 1
        if i >= n:
            break
        t += rbsp[i]
        i += 1
        s = 0
        while i < n and rbsp[i] == 255:
            s += 255
            i += 1
        if i >= n:
            break
        s += rbsp[i]
        i += 1
        out.append((t, rbsp[i:i + s]))
        i += s
    return out


def write_hash_sei(recon_y, recon_u, recon_v,
                   hash_type: str = "md5") -> bytes:
    """Decoded-picture-hash suffix-SEI RBSP computed from the recon planes
    (MD5 / CRC / checksum per TComPicYuvMD5.cpp:129-227)."""
    fn = _HASH_FN[hash_type]
    return write_hash_sei_digests(
        [fn(p) for p in (recon_y, recon_u, recon_v)], hash_type)


def parse_hash_sei(rbsp: bytes):
    """Parse a decoded-picture-hash SEI; returns (hash_type_name,
    [3 digests]) or None if the SEI is some other payload type."""
    br = BitReader(rbsp)
    ptype = br.u(8)
    psize = br.u(8)
    if ptype != SEI_DECODED_PICTURE_HASH:
        return None
    code = br.u(8)
    names = {v: k for k, v in _HASH_CODE.items()}
    _req(code in names, f"unknown decoded-picture-hash type {code}")
    name = names[code]
    n = _HASH_LEN[name]
    _req(psize == 1 + 3 * n,
         f"bad decoded-picture-hash SEI size {psize} for type {name}")
    return name, [bytes(br.u(8) for _ in range(n)) for _ in range(3)]


def write_slice_header(cfg: StreamConfig,
                       entry_points: list | None = None,
                       nal_type: int = NAL_IDR_W_RADL,
                       poc: int = 0) -> BitWriter:
    """IRAP I-slice header; returns the writer so CABAC data can follow.

    entry_points: post-emulation-prevention byte sizes of all WPP
    substreams except the last (7.3.6.1 num_entry_point_offsets;
    TEncCavlc::codeTilesWPPEntryPoint) — required when cfg.wpp.
    nal_type NAL_CRA (21) writes the non-IDR fields: slice_pic_order_cnt
    _lsb and an empty inline st_ref_pic_set — the DecodingRefreshType=1
    stream shape HM's All-Intra anchor emits (TEncGOP non-IDR IRAP
    path)."""
    bw = BitWriter()
    bw.flag(1)            # first_slice_segment_in_pic_flag
    bw.flag(0)            # no_output_of_prior_pics_flag (IRAP)
    bw.ue(0)              # slice_pic_parameter_set_id
    bw.ue(2)              # slice_type = I
    if nal_type not in (NAL_IDR_W_RADL, 20):
        bw.u(poc & 0xFF, 8)  # slice_pic_order_cnt_lsb (log2 max = 8)
        bw.flag(0)        # short_term_ref_pic_set_sps_flag
        bw.ue(0)          # st_ref_pic_set: num_negative_pics
        bw.ue(0)          #                 num_positive_pics
    if cfg.sao:
        bw.flag(1)        # slice_sao_luma_flag
        bw.flag(1)        # slice_sao_chroma_flag
    bw.se(cfg.qp - 26)    # slice_qp_delta
    # deblocking: override disabled -> slice inherits the PPS setting.
    # slice_loop_filter_across_slices_enabled_flag (7.3.6.1) is present
    # when pps_loop_filter_across_slices_enabled_flag=1 (we always set it)
    # and any in-loop filter is active for this slice.
    if cfg.deblock or cfg.sao:
        bw.flag(1)        # slice_loop_filter_across_slices_enabled_flag
    if cfg.wpp:
        eps = entry_points or []
        bw.ue(len(eps))   # num_entry_point_offsets
        if eps:
            ol = max(1, max(e - 1 for e in eps).bit_length())
            bw.ue(ol - 1)  # offset_len_minus1
            for e in eps:
                bw.u(e - 1, ol)  # entry_point_offset_minus1
    bw.u(1, 1)            # byte_alignment: alignment_bit_equal_to_one
    bw.align_zero()
    return bw


# ---------------------------------------------------------------------------
# Parsers (verification decoder) — they accept general conforming headers for
# the subset of tools this codec emits and raise DecodeError (a typed,
# message-carrying rejection — the TDecConformance role) on anything else,
# so malformed or unsupported streams can never "pass" via assert-stripped
# runs (python -O).
# ---------------------------------------------------------------------------


class DecodeError(ValueError):
    """Malformed or unsupported bitstream syntax."""


def _req(cond, msg: str):
    if not cond:
        raise DecodeError(msg)


def _parse_st_rps(br: BitReader, idx: int, num_sets: int,
                  num_delta_pocs: list) -> int:
    """Parse (and discard) one st_ref_pic_set (7.3.7), returning its
    NumDeltaPocs so later sets/slice headers can inter-predict from it.
    Needed to decode HM's streams: the reference encoder writes RPS
    entries even for All-Intra (TEncCavlc codeShortTermRefPicSet), where
    every picture is an IRAP and the sets are never referenced."""
    pred = br.flag() if idx != 0 else False
    if pred:
        delta_idx = (br.ue() + 1) if idx == num_sets else 1
        _req(delta_idx <= idx, "st_ref_pic_set delta_idx out of range")
        ref_n = num_delta_pocs[idx - delta_idx]
        br.flag()            # delta_rps_sign
        br.ue()              # abs_delta_rps_minus1
        n = 0
        for _ in range(ref_n + 1):
            used = br.flag()                 # used_by_curr_pic_flag
            inc = True
            if not used:
                inc = br.flag()              # use_delta_flag
            if used or inc:
                n += 1
        # NumDeltaPocs of the predicted set is <= n; parsing-exactness of
        # the count is not needed for IRAP-only streams (sets unused),
        # but the bit positions above are.
        return n
    neg = br.ue()
    pos = br.ue()
    for _ in range(neg):
        br.ue()              # delta_poc_s0_minus1
        br.flag()            # used_by_curr_pic_s0_flag
    for _ in range(pos):
        br.ue()
        br.flag()
    return neg + pos


def parse_sps(rbsp: bytes) -> dict:
    br = BitReader(rbsp)
    br.u(4 + 3 + 1)
    _skip_ptl(br)
    sps = {}
    _req(br.ue() == 0, "nonzero sps id unsupported")
    sps["chroma_format_idc"] = br.ue()
    sps["width"] = br.ue()
    sps["height"] = br.ue()
    if br.flag():  # conformance window
        for _ in range(4):
            br.ue()
    sps["bit_depth_luma"] = br.ue() + 8
    sps["bit_depth_chroma"] = br.ue() + 8
    sps["log2_max_poc_lsb"] = br.ue() + 4
    sub_ordering = br.flag()
    for _ in range(1 if not sub_ordering else 1):
        br.ue(), br.ue(), br.ue()
    sps["log2_min_cb"] = br.ue() + 3
    sps["log2_ctb"] = sps["log2_min_cb"] + br.ue()
    sps["log2_min_tb"] = br.ue() + 2
    sps["log2_max_tb"] = sps["log2_min_tb"] + br.ue()
    sps["max_tu_depth_inter"] = br.ue()
    sps["max_tu_depth_intra"] = br.ue()
    _req(not br.flag(), "scaling lists unsupported")
    sps["amp"] = br.flag()
    sps["sao"] = br.flag()
    _req(not br.flag(), "PCM unsupported")
    # short-term RPS list: present in HM streams even for All-Intra
    # (never referenced — every picture is an IRAP). Parse & discard.
    num_rps = br.ue()
    _req(num_rps <= 64, "too many st_ref_pic_sets")
    ndp: list = []
    for i in range(num_rps):
        ndp.append(_parse_st_rps(br, i, num_rps, ndp))
    sps["num_st_rps"] = num_rps
    sps["st_rps_ndp"] = ndp
    _req(not br.flag(), "long-term refs unsupported")
    sps["temporal_mvp"] = br.flag()
    sps["strong_intra_smoothing"] = br.flag()
    return sps


def parse_pps(rbsp: bytes) -> dict:
    br = BitReader(rbsp)
    pps = {}
    _req(br.ue() == 0 and br.ue() == 0, "nonzero pps/sps id unsupported")
    _req(not br.flag(), "dependent slices unsupported")
    pps["output_flag_present"] = br.flag()
    _req(br.u(3) == 0, "extra slice header bits unsupported")
    pps["sign_data_hiding"] = br.flag()
    pps["cabac_init_present"] = br.flag()
    br.ue(), br.ue()
    pps["init_qp"] = br.se() + 26
    pps["constrained_intra_pred"] = br.flag()
    pps["transform_skip"] = br.flag()
    pps["cu_qp_delta"] = br.flag()
    pps["cu_qp_delta_depth"] = br.ue() if pps["cu_qp_delta"] else 0
    pps["cb_qp_offset"] = br.se()
    pps["cr_qp_offset"] = br.se()
    pps["slice_chroma_qp_offsets"] = br.flag()
    br.flag(), br.flag()
    _req(not br.flag(), "transquant bypass unsupported")
    _req(not br.flag(), "tiles unsupported")
    pps["wpp"] = br.flag()
    pps["loop_filter_across_slices"] = br.flag()
    if br.flag():  # deblocking control present
        pps["deblock_override"] = br.flag()
        pps["deblock_disabled"] = br.flag()
        if not pps["deblock_disabled"]:
            _req(br.se() == 0 and br.se() == 0,
                 "nonzero beta/tc offsets unsupported")
    else:
        pps["deblock_override"] = False
        pps["deblock_disabled"] = False
    _req(not br.flag(), "pps scaling list unsupported")
    br.flag()
    br.ue()
    br.flag()
    return pps


def parse_slice_header(rbsp: bytes, sps: dict, pps: dict, nal_type: int):
    br = BitReader(rbsp)
    sh = {}
    _req(br.flag(), "only single-slice pictures supported")
    if 16 <= nal_type <= 23:
        br.flag()  # no_output_of_prior_pics
    _req(br.ue() == 0, "nonzero pps id unsupported")
    sh["slice_type"] = br.ue()
    _req(sh["slice_type"] == 2, "only I slices supported")
    if pps["output_flag_present"]:
        br.flag()
    if nal_type not in (19, 20):  # not IDR: POC + RPS (e.g. HM's CRA)
        _req(nal_type == 21, "only IRAP slices supported (IDR/CRA)")
        sh["poc_lsb"] = br.u(sps["log2_max_poc_lsb"])
        if br.flag():            # short_term_ref_pic_set_sps_flag
            n = sps.get("num_st_rps", 0)
            if n > 1:
                br.u((n - 1).bit_length())   # short_term_ref_pic_set_idx
        else:
            _parse_st_rps(br, sps.get("num_st_rps", 0),
                          sps.get("num_st_rps", 0),
                          list(sps.get("st_rps_ndp", [])))
        if sps.get("temporal_mvp"):
            br.flag()            # slice_temporal_mvp_enabled_flag
    if sps["sao"]:
        sh["sao_luma"] = br.flag()
        sh["sao_chroma"] = br.flag()
    sh["qp"] = pps["init_qp"] + br.se()
    if pps["slice_chroma_qp_offsets"]:
        br.se(), br.se()
    if pps["deblock_override"]:
        raise DecodeError("slice-level deblocking override unsupported")
    # slice_loop_filter_across_slices_enabled_flag (7.3.6.1): present when
    # the PPS allows cross-slice filtering and any in-loop filter is active.
    if pps["loop_filter_across_slices"] and (
            sh.get("sao_luma") or sh.get("sao_chroma")
            or not pps["deblock_disabled"]):
        sh["loop_filter_across_slices"] = br.flag()
    if pps.get("wpp"):
        n_ep = br.ue()
        eps = []
        if n_ep:
            ol = br.ue() + 1
            eps = [br.u(ol) + 1 for _ in range(n_ep)]
        sh["entry_points"] = eps
    # byte alignment
    _req(br.u(1) == 1, "bad slice-header byte alignment")
    while not br.byte_aligned():
        _req(br.u(1) == 0, "bad slice-header byte alignment")
    sh["data_offset"] = br.byte_pos
    return sh
