"""Stream / source utilities.

Equivalents of the reference's App/utils tools (HM's source/App/utils):
annexBbytecount (NAL size audit), convert_NtoMbit_YCbCr (bit-depth
conversion), and BitrateTargeting (QP/λ-modifier guessing to hit target
bitrates). A copy of hevctpu/utils/__init__.py.
"""

from __future__ import annotations

import numpy as np


def annexb_bytecount(stream: bytes):
    """Audit an Annex-B byte stream: list of (nal_type, payload_bytes,
    total_bytes_incl_startcode) per NAL unit plus the stream total —
    the role of App/utils/annexBbytecount.
    """
    out = []
    i = 0
    n = len(stream)
    # find successive start codes (3- or 4-byte)
    starts = []
    while i + 3 <= n:
        if stream[i:i + 3] == b"\x00\x00\x01":
            sc = 3
            if i >= 1 and stream[i - 1] == 0:
                i -= 1
                sc = 4
            starts.append((i, sc))
            i += sc + 1
        else:
            i += 1
    for k, (pos, sc) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else n
        payload = stream[pos + sc:end]
        nal_type = (payload[0] >> 1) & 0x3F if payload else -1
        out.append((nal_type, len(payload), end - pos))
    return out


def convert_bitdepth(planes, in_bits: int, out_bits: int):
    """Convert YCbCr planes between bit depths with the reference tool's
    rounding (convert_NtoMbit_YCbCr: down = (x + (1 << (d-1))) >> d,
    up = x << d). planes: array or sequence of arrays."""
    def conv(p):
        p = np.asarray(p, np.int64)
        if out_bits >= in_bits:
            q = p << (out_bits - in_bits)
        else:
            d = in_bits - out_bits
            q = (p + (1 << (d - 1))) >> d
        return np.clip(q, 0, (1 << out_bits) - 1).astype(
            np.uint8 if out_bits <= 8 else np.uint16)

    if isinstance(planes, np.ndarray):
        return conv(planes)
    return [conv(p) for p in planes]


def bitrate_targeting(rate_points, target_kbps: float):
    """Given measured (qp, bitrate_kbps) pairs, pick the QP (and fractional
    λ-modifier exponent) expected to hit a target bitrate — the role of
    App/utils/BitrateTargeting's λ-modifier guesser. Fits log(rate) as
    linear in QP (rate halves roughly every 6 QP) and solves for target.

    Returns (qp_float, qp_int) — encode at qp_int; the fractional part is
    the residual a λ-modifier (or dQP dithering across frames) absorbs.
    """
    pts = sorted(rate_points)
    assert len(pts) >= 2, "need at least two (qp, rate) points"
    qps = np.array([p[0] for p in pts], np.float64)
    lr = np.log(np.array([p[1] for p in pts], np.float64))
    a, b = np.polyfit(qps, lr, 1)
    if abs(a) < 1e-9:
        return float(qps[0]), int(qps[0])
    q = (np.log(target_kbps) - b) / a
    q = float(np.clip(q, 0, 51))
    return q, int(round(q))
