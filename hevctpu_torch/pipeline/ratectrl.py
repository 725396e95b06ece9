"""λ-domain rate control (R-λ model) for All-Intra encoding (port of
hevctpu/pipeline/ratectrl.py).

The reference's TEncRateCtrl (TEncRCSeq/TEncRCGOP/TEncRCPic bit
allocation, the α/β update of estimatePicLambda/updateAfterPicture),
restated for the frame-batch pipeline:

  * sequence level: equal-per-picture budget T = bitrate/fps with a
    smoothed-buffer feedback term (undershoot/overshoot of previous frames
    redistributed over a sliding window), HM's GOP allocation for
    IntraPeriod 1.
  * picture level: λ = α · bpp^β (bpp = T / (W·H)); for intra pictures the
    target is refined by the picture's SATD complexity the way HM's
    getRefineBitsForIntra scales bits with pow(cost, β_intra).
  * QP from λ: QP = 4.2005·ln λ + 13.7122 (HM's xEstPicQP), clipped to ±2
    between consecutive pictures and to [0, 51].
  * model update: after each picture, compare the λ the model would have
    produced for the actual bpp with the λ used, and nudge (α, β) along
    the log-residual (HM's updateAlphaBetaIntra).

The SATD complexity (8×8 Hadamard of the source luma) runs in torch on the
controller's device. Every Hadamard term is an exact int32 (|t| ≤ 16320)
and the block and frame sums are exact integer sums, so the complexity is
the same on every device; the JAX package adds the same terms in float32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from hevctpu_torch import get_device

# HM's intra R-λ initial model parameters (ALPHA/BETA for intra scale the
# SATD-based complexity; the per-bpp λ model starts at α=3.2003,
# β=-1.367 like HM's initAlpha/initBeta).
ALPHA_INTRA = 6.7542
BETA_INTRA = 1.7860
INIT_ALPHA = 3.2003
INIT_BETA = -1.367
ALPHA_RANGE = (0.05, 500.0)
BETA_RANGE = (-3.0, -0.1)
LAMBDA_RANGE = (0.1, 10000.0)


def _fwht8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Natural-order 8-point Walsh-Hadamard transform (H8 = [[H4, H4],
    [H4, -H4]]) along `dim`, as three add/subtract butterfly stages."""
    x = x.movedim(dim, -1)
    lead = x.shape[:-1]
    for half in (4, 2, 1):
        p = x.reshape(*lead, 8 // (2 * half), 2, half)
        a, b = p[..., 0, :], p[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*lead, 8)
    return x.movedim(-1, dim)


def _satd8_blocks(y: torch.Tensor) -> torch.Tensor:
    """[H, W] luma (multiples of 8) -> [H/8, W/8] int64: the sum of the
    8×8 Hadamard magnitudes H·X·H of each block without its DC term (8×
    HM's calCostSliceI block cost), in exact int32 butterflies."""
    h, w = y.shape[-2:]
    blk = y.to(torch.int32).reshape(h // 8, 8, w // 8, 8).transpose(1, 2)
    t = _fwht8(_fwht8(blk, -2), -1)
    mag = t.abs().to(torch.int64).sum(dim=(-2, -1))
    return mag - t[..., 0, 0].abs().to(torch.int64)


def _satd8_frame(y: torch.Tensor) -> float:
    """Sum of 8×8 Hadamard-transform magnitudes over the frame [H, W]
    (H, W multiples of 8), DC excluded, / 8: HM's intra complexity."""
    return int(_satd8_blocks(y).sum()) / 8.0


def _satd8_ctu(y: torch.Tensor, rcn: int, ccn: int) -> np.ndarray:
    """[H, W] luma -> [rcn, ccn] float32 per-CTU SATD complexity (the
    block magnitudes of _satd8_frame pooled per 64×64 CTU; edge CTUs
    zero-pad, as HM's calCostSliceI accumulates per LCU)."""
    h, w = y.shape[-2:]
    yp = torch.nn.functional.pad(y.to(torch.int32),
                                 (0, ccn * 64 - w, 0, rcn * 64 - h))
    mag = _satd8_blocks(yp).reshape(rcn, 8, ccn, 8).sum(dim=(1, 3))
    return (mag.cpu().numpy() / 8.0).astype(np.float32)


@dataclasses.dataclass
class PicStats:
    """Per-picture record kept for reporting (HM's rate-control log)."""
    target_bits: int
    actual_bits: int
    qp: int
    lam: float


class RateController:
    """Sequence + picture level R-λ rate control for All-Intra.

    Usage per picture:
        qp, lam = rc.start_picture(complexity=rc.complexity(y))
        ... encode at qp ...
        rc.update(actual_bits)

    The complexity passes run on `device` (the card unless the caller
    names another).
    """

    def __init__(self, target_bps: float, fps: float, width: int, height: int,
                 total_frames: int = 0, *, window: int = 16, device=None):
        self.target_bps = float(target_bps)
        self.fps = float(fps)
        self.pixels = width * height
        self.total_frames = total_frames
        self.window = window
        self.avg_bits = self.target_bps / self.fps
        self.alpha = INIT_ALPHA
        self.beta = INIT_BETA
        self.buffer_debt = 0.0  # bits over (+) / under (-) target so far
        self.last_qp: int | None = None
        self.pics: list[PicStats] = []
        self._pending: tuple[int, float, float] | None = None
        self.device = get_device(device)

    def _luma(self, y) -> torch.Tensor:
        return torch.as_tensor(np.asarray(y)).to(self.device)

    # -- complexity ---------------------------------------------------------

    def complexity(self, y) -> float:
        """SATD complexity of the picture's luma [H, W]."""
        return _satd8_frame(self._luma(y))

    # -- picture level ------------------------------------------------------

    def target_bits(self, complexity: float | None = None) -> float:
        """Per-picture budget: equal share + buffer feedback (HM's GOP-level
        smoothing), refined by intra complexity when provided."""
        t = self.avg_bits - self.buffer_debt / self.window
        if complexity is not None and complexity > 0:
            # HM getRefineBitsForIntra: bits ∝ α·(SATD/pixels)^β — blend the
            # complexity-implied bits with the budget share.
            implied = (ALPHA_INTRA
                       * (complexity / self.pixels) ** BETA_INTRA
                       * self.pixels / 8.0)
            t = 0.5 * t + 0.5 * min(implied, 2.0 * t)
        return max(t, 0.01 * self.avg_bits)

    def start_picture(self, complexity: float | None = None):
        t = self.target_bits(complexity)
        bpp = t / self.pixels
        lam = self.alpha * bpp ** self.beta
        lam = min(max(lam, LAMBDA_RANGE[0]), LAMBDA_RANGE[1])
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        if self.last_qp is not None:
            qp = min(max(qp, self.last_qp - 2), self.last_qp + 2)
        qp = min(max(qp, 0), 51)
        self._pending = (qp, lam, t)
        return qp, lam

    def lcu_qp_map(self, y) -> np.ndarray:
        """Per-CTU QP allocation for the pending picture — HM's LCU-level
        R-λ (TEncRCPic::getLCUTargetBpp intra bit share by SATD cost,
        getLCUEstLambda/getLCUEstQP) as one dense map: bits_i =
        T·satd_i/Σsatd, λ_i = α·bpp_i^β clipped around the picture λ,
        QP_i = 4.2005·lnλ + 13.7122 clipped to picture QP ± 2. Call
        between start_picture and update; encode with
        FrameEncoder.encode(..., qp_map=map[None]) under a cu_qp_delta
        StreamConfig."""
        assert self._pending is not None, "start_picture not called"
        pic_qp, pic_lam, t = self._pending
        y = self._luma(y)
        h, w = y.shape[-2:]
        rcn, ccn = -(-h // 64), -(-w // 64)
        satd = _satd8_ctu(y, rcn, ccn)
        ys = np.minimum(np.arange(rcn) * 64 + 64, h) - np.arange(rcn) * 64
        xs = np.minimum(np.arange(ccn) * 64 + 64, w) - np.arange(ccn) * 64
        pix = ys[:, None] * xs[None, :]
        share = satd / max(float(satd.sum()), 1e-9)
        bpp = np.maximum(t * share / pix, 1e-8)
        lam = self.alpha * bpp ** self.beta
        # HM bounds the LCU λ within ~2x of the picture λ and the QP to ±2
        lam = np.clip(lam, pic_lam / 4.0, pic_lam * 4.0)
        qp = np.rint(4.2005 * np.log(lam) + 13.7122)
        qp = np.clip(qp, pic_qp - 2, pic_qp + 2)
        return np.clip(qp, 0, 51).astype(np.int32)

    def update(self, actual_bits: int):
        assert self._pending is not None, "start_picture not called"
        qp, lam, t = self._pending
        self._pending = None
        self.buffer_debt += actual_bits - self.avg_bits
        bpp_real = max(actual_bits / self.pixels, 1e-6)
        lam_comp = self.alpha * bpp_real ** self.beta
        resid = math.log(lam) - math.log(max(lam_comp, 1e-9))
        self.alpha += 0.10 * resid * self.alpha
        self.beta += 0.05 * resid * math.log(bpp_real)
        self.alpha = min(max(self.alpha, *ALPHA_RANGE[:1]), ALPHA_RANGE[1])
        self.beta = min(max(self.beta, BETA_RANGE[0]), BETA_RANGE[1])
        self.last_qp = qp
        self.pics.append(PicStats(int(t), int(actual_bits), qp, lam))

    # -- reporting ----------------------------------------------------------

    def achieved_bps(self) -> float:
        if not self.pics:
            return 0.0
        return (sum(p.actual_bits for p in self.pics)
                / len(self.pics) * self.fps)
