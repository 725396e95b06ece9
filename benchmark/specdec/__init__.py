"""A decoder of HEVC Main intra pictures (8-bit 4:2:0, one slice, IDR),
written from ITU-T H.265 (04/2013) with its own tables. It shares no
code with the system under test, which writes the streams it reads.

    from specdec import decode
    pic = decode(annex_b_bytes, source=(y, u, v))   # source: optional

decode() returns a Decoded: the pictures' planes after deblocking and
SAO, the checksum the stream's hash SEI carries beside the one of the
decoded planes, every decision the slice data coded, and, given the
source planes, how many coded levels lie outside the bounds of a
quantiser of that source (picture.QuantBound)."""

from __future__ import annotations

import dataclasses

import numpy as np

from specdec import bits, filters
from specdec.bits import StreamError, Unsupported
from specdec.picture import PictureDecoder

__all__ = ["decode", "Decoded", "StreamError", "Unsupported"]


@dataclasses.dataclass
class Decoded:
    planes: tuple                   # (y, u, v) uint8, cropped
    checksum: list                  # of the decoded planes
    sei_checksum: list | None       # what the hash SEI carries
    syntax: PictureDecoder          # the parsed decisions
    levels_coded: int = 0
    levels_outside: int = 0


def decode(data: bytes, source=None) -> Decoded:
    """One IDR picture (with its parameter sets, slice and suffix SEI as
    Annex B bytes) -> Decoded. Raises StreamError or Unsupported."""
    sps = pps = None
    pic = None
    sei = None
    for kind, rbsp in bits.nal_units(data):
        if kind == bits.NAL_SPS:
            sps = bits.parse_sps(rbsp)
        elif kind == bits.NAL_PPS:
            pps = bits.parse_pps(rbsp)
        elif kind in (bits.NAL_IDR_W_RADL, bits.NAL_IDR_N_LP):
            if pic is not None:
                raise Unsupported("more than one picture")
            if sps is None or pps is None:
                raise StreamError("slice before its parameter sets")
            sh = bits.parse_slice_header(rbsp, kind, sps, pps)
            src = None
            if source is not None:
                src = [np.asarray(p, np.int64) for p in source]
            pic = PictureDecoder(sps, pps, sh, rbsp, src).decode()
        elif kind == bits.NAL_SEI_SUFFIX and pic is not None:
            for htype, vals in bits.picture_hash(rbsp):
                if htype != 2:
                    raise Unsupported(f"picture hash type {htype}")
                sei = vals
        elif kind in (bits.NAL_VPS, bits.NAL_SEI_PREFIX):
            continue
        else:
            raise Unsupported(f"NAL unit type {kind}")
    if pic is None:
        raise StreamError("no picture")
    sh = pic.sh
    planes = pic.rec
    if not sh.deblocking_disabled:
        planes = filters.deblock(planes, pic.tu4, sh.qp,
                                 (pps.cb_qp_offset, pps.cr_qp_offset),
                                 sh.beta_offset_div2, sh.tc_offset_div2)
    if sh.sao_luma or sh.sao_chroma:
        planes = filters.sao(planes, sps.log2_ctb, pic.sao_type, pic.sao_off,
                             pic.sao_bp, pic.sao_eo)
    sums = [filters.checksum(np.asarray(p, np.uint8)) for p in planes]
    cl, cr, ct, cb = sps.conformance
    planes = (planes[0][2 * ct: sps.height - 2 * cb,
                        2 * cl: sps.width - 2 * cr],
              planes[1][ct: sps.height // 2 - cb, cl: sps.width // 2 - cr],
              planes[2][ct: sps.height // 2 - cb, cl: sps.width // 2 - cr])
    planes = tuple(np.asarray(p, np.uint8) for p in planes)
    out = Decoded(planes, sums, sei, pic)
    if pic.quant is not None:
        out.levels_coded = pic.quant.coded
        out.levels_outside = pic.quant.outside
    return out
