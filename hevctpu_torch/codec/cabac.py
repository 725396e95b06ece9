"""CABAC binary arithmetic codec (H.265 9.3), encoder and decoder engines.

Equivalent of the reference's TEncBinCABAC / TDecBinCABAC + ContextModel
(TEncBinCoderCABAC.cpp:187-447, ContextModel.cpp) — implemented from the
spec's flowcharts (EncodeDecision/RenormE/PutBit, 9.3.4.3) so encoder and
decoder are exact mirrors. This is the Python reference engine; the native
C++ path mirrors it bit-for-bit (hevctpu_torch/native).
"""

from __future__ import annotations

import numpy as np

from hevctpu_torch import rom


class ContextModel:
    __slots__ = ("state", "mps")

    def __init__(self, init_value: int, qp: int):
        self.state, self.mps = rom.cabac_init_state(init_value, qp)


class ContextSet:
    """All context models for one slice, keyed by (name, idx)."""

    def __init__(self, qp: int, init_type: int = 0):
        self._ctx = {}
        for name, rows in rom.CTX_INIT.items():
            row = rows[init_type]
            self._ctx[name] = [ContextModel(v, qp) for v in row]

    def __call__(self, name: str, idx: int = 0) -> ContextModel:
        return self._ctx[name][idx]

    def snapshot(self) -> dict:
        """Copy of all (state, mps) pairs — the WPP context storage
        process (9.3.2.3, HM m_entropyCodingSyncContextState)."""
        return {name: [(m.state, m.mps) for m in models]
                for name, models in self._ctx.items()}

    def restore(self, snap: dict):
        """Load a snapshot (9.3.2.2 sync from the row above's 2nd CTU)."""
        for name, models in self._ctx.items():
            for m, (s, mps) in zip(models, snap[name]):
                m.state, m.mps = s, mps


class CabacEncoder:
    """Spec 9.3.4.3 arithmetic encoder writing into a BitWriter."""

    def __init__(self, bitwriter):
        self.bw = bitwriter
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    # -- internals ---------------------------------------------------------

    def _put_bit(self, b: int):
        if self.first_bit:
            self.first_bit = False
        else:
            self.bw.u(b, 1)
        while self.bits_outstanding > 0:
            self.bw.u(1 - b, 1)
            self.bits_outstanding -= 1

    def _renorm(self):
        # H.265 9.3.4.3.3 RenormE: low lives in [0, 512) here; the bypass
        # path uses the doubled thresholds instead.
        while self.range < 256:
            if self.low < 256:
                self._put_bit(0)
            elif self.low >= 512:
                self.low -= 512
                self._put_bit(1)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.low <<= 1
            self.range <<= 1

    # -- bin coding --------------------------------------------------------

    def encode_bin(self, ctx: ContextModel, b: int):
        lps = int(rom.LPS_TABLE[ctx.state][(self.range >> 6) & 3])
        self.range -= lps
        if b != ctx.mps:
            self.low += self.range
            self.range = lps
            if ctx.state == 0:
                ctx.mps ^= 1
            ctx.state = int(rom.TRANS_LPS[ctx.state])
        else:
            ctx.state = int(rom.TRANS_MPS[ctx.state])
        self._renorm()

    def encode_bypass(self, b: int):
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.bits_outstanding += 1
            self.low -= 512

    def encode_bypass_bins(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, b: int):
        self.range -= 2
        if b:
            self.low += self.range
            self._flush()
        else:
            self._renorm()

    def _flush(self):
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        self.bw.u(((self.low >> 7) & 3) | 1, 2)


class CabacCounter:
    """Fractional-bit counting engine with the CabacEncoder interface.

    Equivalent of the reference's TEncBinCABACCounter
    (TEncBinCoderCABACCounter.cpp:63, selected by FAST_BIT_EST for all RD
    trials, TEncTop.h:101-103): context states advance exactly like the
    real engine, but instead of arithmetic coding it accumulates the
    information content -log2(P(bin)) of each bin, in 2^-15-bit units.
    The probability model is the CABAC state line p(s) = 0.5·α^s with
    α = (0.01875/0.5)^(1/63) (9.3.4.3.2.2), the same curve HM's
    sm_entropyBits table is generated from.
    """

    _ENT = None  # [128]: bits (x 2^15) of coding bin b in state (s, mps)

    def __init__(self):
        self.frac = 0  # 2^-15 bit units
        if CabacCounter._ENT is None:
            alpha = (0.01875 / 0.5) ** (1.0 / 63.0)
            ent = np.zeros(128, dtype=np.int64)
            for s in range(64):
                p_lps = 0.5 * alpha ** s
                ent[2 * s] = int(round(-np.log2(1.0 - p_lps) * (1 << 15)))
                ent[2 * s + 1] = int(round(-np.log2(p_lps) * (1 << 15)))
            CabacCounter._ENT = ent

    @property
    def bits(self) -> float:
        return self.frac / float(1 << 15)

    def encode_bin(self, ctx: ContextModel, b: int):
        is_lps = int(b != ctx.mps)
        self.frac += int(CabacCounter._ENT[2 * ctx.state + is_lps])
        if is_lps:
            if ctx.state == 0:
                ctx.mps ^= 1
            ctx.state = int(rom.TRANS_LPS[ctx.state])
        else:
            ctx.state = int(rom.TRANS_MPS[ctx.state])

    def encode_bypass(self, b: int):
        self.frac += 1 << 15

    def encode_bypass_bins(self, value: int, n: int):
        self.frac += n << 15

    def encode_terminate(self, b: int):
        # ~ -log2(P) with P(terminate) modeled at its fixed 2/256 share.
        self.frac += int(round((7.0 if b else 0.01) * (1 << 15)))


class CabacDecoder:
    """Spec 9.3.4.3.2 mirror decoder reading from a byte buffer."""

    def __init__(self, data: bytes, pos: int = 0):
        self._d = data
        self._bitpos = pos * 8
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._d[self._bitpos >> 3] if (self._bitpos >> 3) < len(self._d) else 0
            v = (v << 1) | ((byte >> (7 - (self._bitpos & 7))) & 1)
            self._bitpos += 1
        return v

    def decode_bin(self, ctx: ContextModel) -> int:
        lps = int(rom.LPS_TABLE[ctx.state][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - ctx.mps
            self.offset -= self.range
            self.range = lps
            if ctx.state == 0:
                ctx.mps ^= 1
            ctx.state = int(rom.TRANS_LPS[ctx.state])
        else:
            b = ctx.mps
            ctx.state = int(rom.TRANS_MPS[ctx.state])
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return b

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bits(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return 0
