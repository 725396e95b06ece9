"""Bit-level writer/reader, NAL encapsulation and Annex-B muxing.

Equivalent of the reference's TComBitStream + NALwrite/AnnexBwrite
(TComBitStream.cpp, NALwrite.cpp, AnnexBwrite.h), written from the H.265
byte-stream spec (Annex B, 7.3.1.1): RBSP trailing bits, emulation
prevention (00 00 0x -> 00 00 03 0x), start codes.
"""

from __future__ import annotations

import re


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def u(self, value: int, bits: int):
        assert 0 <= value < (1 << bits), (value, bits)
        self._acc = (self._acc << bits) | value
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def flag(self, value):
        self.u(1 if value else 0, 1)

    def ue(self, value: int):
        """Exp-Golomb unsigned (9.2)."""
        assert value >= 0
        v = value + 1
        n = v.bit_length()
        self.u(0, n - 1)
        self.u(v, n)

    def se(self, value: int):
        """Exp-Golomb signed (9.2.2): k>0 -> 2k-1, k<=0 -> -2k."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align_rbsp(self):
        """rbsp_trailing_bits: stop bit then zeros."""
        self.u(1, 1)
        if self._nbits:
            self.u(0, 8 - self._nbits)

    def align_zero(self):
        if self._nbits:
            self.u(0, 8 - self._nbits)

    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def data(self) -> bytes:
        assert self._nbits == 0, "unaligned"
        return bytes(self._bytes)


class ReadOverrun(IndexError):
    """Bit reader ran past the end of the payload (truncated NAL unit).

    A subclass of IndexError so legacy callers that caught IndexError keep
    working, but typed so the decoder can distinguish a short bitstream
    from an internal indexing bug during reconstruction."""


class BitReader:
    def __init__(self, data: bytes):
        self._d = data
        self._pos = 0  # bit position

    def u(self, bits: int) -> int:
        if self._pos + bits > len(self._d) * 8:
            raise ReadOverrun(
                f"read of {bits} bits at bit {self._pos} overruns "
                f"{len(self._d)}-byte payload")
        v = 0
        for _ in range(bits):
            byte = self._d[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
        v = 1 << zeros
        if zeros:
            v |= self.u(zeros)
        return v - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_aligned(self) -> bool:
        return self._pos % 8 == 0

    @property
    def byte_pos(self) -> int:
        return self._pos >> 3


# Two zero bytes before a byte <= 3: the place of an emulation-prevention
# byte. The match ends before that byte, so a search resumes at it, as
# the count of zeros restarts after an inserted 0x03.
_EPB_AT = re.compile(rb"\x00\x00(?=[\x00-\x03])")


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (7.4.2)."""
    return _EPB_AT.sub(b"\x00\x00\x03", bytes(rbsp))


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(ebsp):
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < len(ebsp) and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def nal_unit(nal_type: int, rbsp: bytes, *, layer_id: int = 0,
             temporal_id: int = 0) -> bytes:
    """NAL header (7.3.1.2) + EBSP payload with a 4-byte start code."""
    hdr = bytes([(nal_type << 1) | (layer_id >> 5),
                 ((layer_id & 31) << 3) | (temporal_id + 1)])
    return b"\x00\x00\x00\x01" + hdr + rbsp_to_ebsp(rbsp)


def split_annexb(stream: bytes):
    """Yield (nal_type, temporal_id, rbsp) for each NAL in an Annex-B stream."""
    marks = []  # (start_of_startcode, start_of_payload)
    i = 0
    while i + 2 < len(stream):
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            sc = i
            while sc > 0 and stream[sc - 1] == 0:
                sc -= 1
            marks.append((sc, i + 3))
            i += 3
        else:
            i += 1
    for k, (_, s) in enumerate(marks):
        end = marks[k + 1][0] if k + 1 < len(marks) else len(stream)
        nal = stream[s:end]
        yield nal[0] >> 1, (nal[1] & 7) - 1, ebsp_to_rbsp(nal[2:])
