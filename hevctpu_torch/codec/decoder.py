"""Verification decoder: Annex-B stream -> parsed syntax -> reconstruction.

Equivalent in role to the reference's TLibDecoder/TAppDecoder
(TDecTop.cpp:804, TDecCu.cpp:142-359): proves the encoder's bitstreams are
self-consistent by independently parsing the CABAC slice data and
reconstructing every TU in decode order, then comparing against the
encoder-side reconstruction (the decoded-picture-hash discipline,
TEncGOP.cpp:1948). Reconstruction uses the pure-numpy scalar spec
implementation (codec/refimpl.py) — a fully independent path from the JAX
encoder kernels, and free of per-TU device dispatch.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading

import numpy as np

from hevctpu_torch import rom
from hevctpu_torch.codec import bitio, headers, refimpl
from hevctpu_torch.codec.syntax import SliceDecoder


class Decoder:
    """Decode a full Annex-B stream produced by this codec."""

    def __init__(self):
        self.sps = None
        self.pps = None
        self.frames = []  # (recon_y, recon_u, recon_v)
        self.hashes_ok = []  # one bool per decoded-picture-hash SEI
        self.prefix_seis = []  # (payload_type, payload) of prefix SEIs
        self.qp_maps = []  # per picture: the [rc, cc] CTU QPs it codes

    def decode(self, stream: bytes):
        """Decode; raises headers.DecodeError (with a message naming the
        offending syntax) on malformed/unsupported input rather than
        asserting — the TDecConformance reject-with-message role."""
        try:
            for nal_type, _tid, rbsp in bitio.split_annexb(stream):
                if nal_type == headers.NAL_SPS:
                    self.sps = headers.parse_sps(rbsp)
                elif nal_type == headers.NAL_PPS:
                    self.pps = headers.parse_pps(rbsp)
                elif nal_type == headers.NAL_VPS:
                    continue
                elif nal_type in (headers.NAL_IDR_W_RADL, 20, 21):
                    # IDR_W_RADL / IDR_N_LP / CRA — all-intra IRAPs (HM's
                    # DecodingRefreshType=1 emits CRA after the first IDR)
                    if self.sps is None or self.pps is None:
                        raise headers.DecodeError(
                            "slice before SPS/PPS activation")
                    self._decode_slice(rbsp, nal_type)
                elif nal_type == headers.NAL_SEI_PREFIX:
                    # prefix SEIs (active_parameter_sets, recovery_point,
                    # user data, ...): recorded, unknown types discarded
                    # with the SEIread warn-and-skip discipline
                    self.prefix_seis.extend(headers.parse_sei_messages(rbsp))
                elif nal_type == headers.NAL_SEI_SUFFIX:
                    parsed = headers.parse_hash_sei(rbsp)
                    if parsed is not None:
                        htype, digests = parsed
                        if not self.frames:
                            raise headers.DecodeError(
                                "decoded-picture-hash SEI before any slice")
                        fn = headers._HASH_FN[htype]
                        got = [fn(p) for p in self.frames[-1]]
                        ok = got == digests
                        self.hashes_ok.append(ok)
                        if not ok:
                            raise headers.DecodeError(
                                f"decoded-picture-hash SEI mismatch "
                                f"({htype})")
                else:
                    raise headers.DecodeError(
                        f"unsupported NAL unit type {nal_type}")
        except headers.DecodeError:
            raise
        except bitio.ReadOverrun as e:
            # Only the typed bounds failure from BitReader maps to
            # "truncated" — a bare IndexError elsewhere in reconstruction
            # is an internal bug and must surface as itself.
            raise headers.DecodeError(
                f"truncated NAL unit ({e})") from e
        return self.frames

    def _decode_slice(self, rbsp: bytes, nal_type: int):
        sh = headers.parse_slice_header(rbsp, self.sps, self.pps, nal_type)
        w, h = self.sps["width"], self.sps["height"]
        if self.pps.get("cu_qp_delta") and \
                self.pps.get("cu_qp_delta_depth", 0) != 0:
            raise headers.DecodeError(
                "diff_cu_qp_delta_depth > 0 unsupported (QG == CTB only)")
        cfg = headers.StreamConfig(
            width=w, height=h, qp=sh["qp"],
            strong_intra_smoothing=self.sps["strong_intra_smoothing"],
            sign_data_hiding=self.pps["sign_data_hiding"],
            max_tu_depth_intra=self.sps["max_tu_depth_intra"],
            transform_skip=self.pps["transform_skip"],
            sao=self.sps["sao"],
            cu_qp_delta=bool(self.pps.get("cu_qp_delta")),
            wpp=bool(self.pps.get("wpp")))
        sd = SliceDecoder(cfg, rbsp, sh["data_offset"],
                          entry_points=sh.get("entry_points")).decode()

        self.qp_maps.append(np.array(sd.qp_ctu))
        hp, wp = sd.rc * 64, sd.cc * 64
        planes = {0: np.zeros((hp, wp), np.int32),
                  1: np.zeros((hp // 2, wp // 2), np.int32),
                  2: np.zeros((hp // 2, wp // 2), np.int32)}
        for (x0, y0, log2, comp, mode, cbf) in sd.tu_list:
            is_luma = comp == 0
            ts = False
            if log2 == 2 and cbf:
                ts = bool(sd.ts4[y0 // 4, x0 // 4] if is_luma
                          else sd.ts_c[comp][y0 // 4, x0 // 4])
            # per-CTU QP under cu_qp_delta (sd.qp_ctu defaults to slice QP)
            ctu_span = 64 if is_luma else 32
            qp_y = int(sd.qp_ctu[y0 // ctu_span, x0 // ctu_span])
            refimpl.recon_tu(
                planes[comp], sd.levels[comp], y0, x0, log2, mode, cbf,
                qp_y if is_luma else rom.chroma_qp_from_luma(qp_y), is_luma,
                h if is_luma else h // 2, w if is_luma else w // 2,
                span=64 if is_luma else 32,
                strong_smoothing=cfg.strong_intra_smoothing,
                dst=is_luma and log2 == 2,  # 4x4 intra luma is DST-VII
                ts=ts)
        ry, ru, rv = (planes[0][:h, :w], planes[1][:h // 2, :w // 2],
                      planes[2][:h // 2, :w // 2])
        if not self.pps.get("deblock_disabled", True):
            db_qp = sh["qp"]
            if cfg.cu_qp_delta:
                db_qp = np.repeat(np.repeat(sd.qp_ctu, 8, 0), 8, 1)[
                    : h // 8, : w // 8]
            ry, ru, rv = refimpl.deblock_frame_np(
                ry, ru, rv, sd.tusz8[: h // 8, : w // 8], db_qp, h, w)
        if sd.sao is not None:
            ry, ru, rv = refimpl.sao_frame_np(ry, ru, rv, sd.sao, h, w)
        self.frames.append((ry, ru, rv))


def parameter_set_nals(cfg: headers.StreamConfig) -> bytes:
    """VPS + SPS + PPS as Annex-B NAL units."""
    out = bytearray()
    out += bitio.nal_unit(headers.NAL_VPS, headers.write_vps(cfg))
    out += bitio.nal_unit(headers.NAL_SPS, headers.write_sps(cfg))
    out += bitio.nal_unit(headers.NAL_PPS, headers.write_pps(cfg))
    return bytes(out)


NAL_CRA = 21


_POOL = None
_POOL_LOCK = threading.Lock()


def _picture_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The threads that code a batch's pictures: the process's cores but
    two, left to the caller and the encoder's dispatch worker; at most 8."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            n = max(1, min(8, len(os.sched_getaffinity(0)) - 2))
            _POOL = concurrent.futures.ThreadPoolExecutor(
                n, thread_name_prefix="slice")
        return _POOL


def encode_frame_nals(cfg: headers.StreamConfig, fr: dict,
                      use_native: bool | None = None,
                      nal_type: int = headers.NAL_IDR_W_RADL,
                      poc0: int = 0) -> bytes:
    """Slice (+hash-SEI) NAL units for one frame dict (all batch
    entries). nal_type NAL_CRA emits CRA pictures with POCs poc0,
    poc0+1, ... (the batch's picture order)."""
    from hevctpu_torch import native
    from hevctpu_torch.codec.syntax import SliceEncoder

    if use_native is None:
        use_native = native.available() and not cfg.wpp
    # Config/frame consistency guards raise ValueError (not assert): a
    # mismatch here produces a stream that decodes silently wrong, so the
    # check must survive `python -O`.
    if cfg.sao != ("sao_type" in fr):
        raise ValueError("cfg.sao must match the encoder's sao setting")
    if "sbh" in fr and cfg.sign_data_hiding != bool(fr["sbh"]):
        raise ValueError(
            "cfg.sign_data_hiding must match the encoder's sbh setting "
            "(hidden signs would decode silently wrong)")
    if cfg.max_tu_depth_intra > 0 and "tusz8" not in fr:
        raise ValueError(
            "cfg.max_tu_depth_intra > 0 but the frame has no TU-split map "
            "(encode with tu_split=True or use a max_tu_depth_intra=0 "
            "StreamConfig)")
    if cfg.max_tu_depth_intra == 0 and "tusz8" in fr:
        raise ValueError(
            "frame carries a TU-split map but cfg.max_tu_depth_intra == 0 "
            "— no split flags would be coded and the reconstruction would "
            "not match the hash SEI")
    # (a ts-less frame under a transform_skip cfg is fine — all flags code
    # as 0 — but TS decisions require the PPS flag to be signaled)
    if not cfg.transform_skip and "ts4_y" in fr:
        raise ValueError(
            "frame carries transform-skip decisions but cfg.transform_skip "
            "is off — the flags would not be coded and the levels would "
            "dequantize through the wrong inverse")
    # rate control / adaptive QP: a batch may carry its own slice QP.
    if cfg.cu_qp_delta:
        if "qp_ctu" not in fr:
            raise ValueError(
                "cfg.cu_qp_delta is on but the frame carries no qp_ctu "
                "map — encode with a per-CTU QP map or use a "
                "cu_qp_delta=False StreamConfig")
    elif "qp_ctu" in fr:
        raise ValueError(
            "frame carries a per-CTU QP map but cfg.cu_qp_delta is off — "
            "no deltas would be coded and dequantization would use the "
            "wrong scales")
    fcfg = cfg
    if "qp" in fr and int(fr["qp"]) != cfg.qp:
        fcfg = dataclasses.replace(cfg, qp=int(fr["qp"]))
    htype = fcfg.hash_type

    def picture(i: int) -> bytes:
        """Picture i's slice NAL and its hash SEI."""
        poc = poc0 + i
        if use_native:
            # native coder emits slice data only; prepend the header
            rbsp = headers.write_slice_header(
                fcfg, nal_type=nal_type, poc=poc).data()
            rbsp += native.encode_slice_data(
                fcfg.width, fcfg.height, fcfg.qp, fr, i,
                sbh=fcfg.sign_data_hiding,
                max_tu_depth=fcfg.max_tu_depth_intra,
                transform_skip=fcfg.transform_skip)
        else:
            rbsp = SliceEncoder(fcfg, fr, i,
                                nal_type=nal_type, poc=poc).encode()
        out = bitio.nal_unit(nal_type, rbsp)
        if htype == "none":
            return out
        if "recon_y" in fr:
            sei = headers.write_hash_sei(
                fr["recon_y"][i], fr["recon_u"][i], fr["recon_v"][i],
                htype)
        elif "hash_checksum" in fr:
            # device-computed digests (encoder lite path: the recon
            # planes never cross the host link); only checksum is a
            # parallel reduction, so that is the type carried.
            assert htype == "checksum", (
                f"hash_type={htype} needs recon planes; the lite "
                "encode carries only the device checksum")
            dig = [int(fr["hash_checksum"][i][c]) & 0xffffffff
                   for c in range(3)]
            sei = headers.write_hash_sei_digests(
                [bytes([(d >> 24) & 0xff, (d >> 16) & 0xff,
                        (d >> 8) & 0xff, d & 0xff]) for d in dig],
                "checksum")
        else:
            return out
        return out + bitio.nal_unit(headers.NAL_SEI_SUFFIX, sei,
                                    temporal_id=0)

    b = fr["depth8"].shape[0]
    # All-Intra pictures are independent slices: the native coder, called
    # through ctypes without the GIL, codes a batch's pictures on the
    # pool's threads side by side, and the NALs join in picture order.
    if use_native and b > 1:
        return b"".join(_picture_pool().map(picture, range(b)))
    return b"".join(map(picture, range(b)))


def encode_stream(cfg: headers.StreamConfig, frames: list[dict],
                  use_native: bool | None = None,
                  prefix_seis: bool = False,
                  cra_refresh: bool = False) -> bytes:
    """Assemble a full Annex-B stream: VPS/SPS/PPS + one IDR per frame.

    The slice-data CABAC pass runs in the native C++ coder when available
    (hevctpu_torch/native — byte-identical to codec/syntax.py, ~100x faster);
    pass use_native=False to force the Python golden path.
    prefix_seis=True additionally emits active_parameter_sets and
    recovery_point prefix SEIs (SEIEncoder initActiveParameterSetsSEI /
    initSEIRecoveryPoint roles, gated like HM's SEIActiveParameterSets /
    RecoveryPointSEI options). cra_refresh=True emits picture 0 as IDR
    and later pictures as CRA with POC — HM's DecodingRefreshType=1
    stream shape (TEncGOP POC/IRAP plumbing for the AI operating
    point).
    """
    out = bytearray(parameter_set_nals(cfg))
    if prefix_seis:
        out += bitio.nal_unit(headers.NAL_SEI_PREFIX,
                              headers.write_active_parameter_sets_sei())
    poc = 0
    for fr in frames:
        if prefix_seis:
            out += bitio.nal_unit(headers.NAL_SEI_PREFIX,
                                  headers.write_recovery_point_sei())
        b = fr["depth8"].shape[0]
        if cra_refresh and poc > 0:
            out += encode_frame_nals(cfg, fr, use_native,
                                     nal_type=NAL_CRA, poc0=poc)
        elif cra_refresh and b > 1:
            # first batch: IDR for picture 0, CRA for the rest
            import numpy as _np
            fr0 = {k: (v[:1] if isinstance(v, _np.ndarray) and
                       v.ndim > 0 and v.shape[0] == b else v)
                   for k, v in fr.items()}
            frr = {k: (v[1:] if isinstance(v, _np.ndarray) and
                       v.ndim > 0 and v.shape[0] == b else v)
                   for k, v in fr.items()}
            out += encode_frame_nals(cfg, fr0, use_native)
            out += encode_frame_nals(cfg, frr, use_native,
                                     nal_type=NAL_CRA, poc0=1)
        else:
            out += encode_frame_nals(cfg, fr, use_native)
        poc += b
    return bytes(out)
