"""The CABAC parsing process of H.265 (9.3): context initialisation
(9.3.2.2) and the arithmetic decoding engine (9.3.4.3)."""

from __future__ import annotations

from specdec.bits import StreamError
from specdec.tables import INIT_I, RANGE_LPS, TRANS_LPS


class Contexts:
    """Every context variable of an I slice at slice QP qp: for each
    syntax element a list of [pStateIdx, valMps] pairs."""

    def __init__(self, qp: int):
        qp = min(max(qp, 0), 51)
        self.ctx = {}
        for name, inits in INIT_I.items():
            states = []
            for init in inits:
                m = (init >> 4) * 5 - 45
                n = ((init & 15) << 3) - 16
                pre = min(max(((m * qp) >> 4) + n, 1), 126)
                mps = 1 if pre > 63 else 0
                states.append([pre - 64 if mps else 63 - pre, mps])
            self.ctx[name] = states

    def __getitem__(self, name):
        return self.ctx[name]


class Decoder:
    """The arithmetic decoding engine over slice data starting at byte
    `start` of an RBSP."""

    def __init__(self, rbsp: bytes, start: int):
        self.data = rbsp
        self.byte = start
        self.bit = 0
        self.range = 510
        self.offset = self._bits(9)

    def _read_bit(self) -> int:
        if self.byte >= len(self.data):
            raise StreamError("slice data ends inside the arithmetic code")
        b = (self.data[self.byte] >> (7 - self.bit)) & 1
        self.bit += 1
        if self.bit == 8:
            self.bit = 0
            self.byte += 1
        return b

    def _bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self._read_bit()
        return v

    def decision(self, ctx: list) -> int:
        """DecodeDecision (9.3.4.3.2) with context variable ctx =
        [pStateIdx, valMps], updated in place."""
        state, mps = ctx
        lps = RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            bin_ = 1 - mps
            self.offset -= self.range
            self.range = lps
            if state == 0:
                ctx[1] = 1 - mps
            ctx[0] = TRANS_LPS[state]
        else:
            bin_ = mps
            if state < 62:
                ctx[0] = state + 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bin_

    def bypass(self) -> int:
        """DecodeBypass (9.3.4.3.4)."""
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_bits(self, n: int) -> int:
        """n bypass bins, most significant first (FL binarization)."""
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        """DecodeTerminate (9.3.4.3.5)."""
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    def finish(self):
        """After end_of_slice_segment_flag = 1 (9.3.4.3.5): the last bit
        the engine read is rbsp_stop_one_bit; only alignment zeros may
        follow it."""
        last = (self.data[self.byte - (0 if self.bit else 1)]
                >> ((8 - self.bit) % 8)) & 1
        if last != 1:
            raise StreamError("no rbsp_stop_one_bit after the slice data")
        while self.bit:
            if self._read_bit():
                raise StreamError("nonzero alignment bits")
        if any(self.data[self.byte:]):
            raise StreamError("data after the end of the slice segment")
