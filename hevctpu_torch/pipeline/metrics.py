"""PSNR accounting and Bjontegaard BD-rate/BD-PSNR.

Equivalent of the reference's TEncAnalyze summary (TEncAnalyze.h:198-320,
xCalculateAddPSNR TEncGOP.cpp:2268) and the calc_BDBR tooling
(BjontegaardMetric_Python3 semantics: cubic polyfit of PSNR vs log-rate,
integrate over the overlapping interval). A copy of
hevctpu/pipeline/metrics.py."""

from __future__ import annotations

import numpy as np


def psnr(orig: np.ndarray, recon: np.ndarray, peak: int = 255) -> float:
    mse = ((orig.astype(np.float64) - recon.astype(np.float64)) ** 2).mean()
    if mse == 0:
        return 999.99
    return 10.0 * np.log10(peak * peak / mse)


def frame_psnrs(y, u, v, ry, ru, rv):
    return psnr(y, ry), psnr(u, ru), psnr(v, rv)


def summary_line(num_frames, total_bits, fps, psnr_y, psnr_u, psnr_v):
    """The reference's 'SUMMARY — I Slices' quantities (TEncAnalyze.h:233):
    bitrate in kbps at the sequence frame rate, average PSNRs."""
    kbps = total_bits * fps / max(num_frames, 1) / 1000.0
    yuv = (6 * psnr_y + psnr_u + psnr_v) / 8.0
    return (f"SUMMARY: Frames {num_frames} | Bitrate {kbps:10.4f} kbps | "
            f"Y-PSNR {psnr_y:8.4f} | U-PSNR {psnr_u:8.4f} | "
            f"V-PSNR {psnr_v:8.4f} | YUV-PSNR {yuv:8.4f}")


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """BD-rate in % (positive = test costs more bits at equal quality)."""
    lr_a = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lr_t = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)
    p_a = np.polyfit(pa, lr_a, 3)
    p_t = np.polyfit(pt, lr_t, 3)
    lo = max(pa.min(), pt.min())
    hi = min(pa.max(), pt.max())
    ia = np.polyint(p_a)
    it = np.polyint(p_t)
    int_a = np.polyval(ia, hi) - np.polyval(ia, lo)
    int_t = np.polyval(it, hi) - np.polyval(it, lo)
    avg_diff = (int_t - int_a) / (hi - lo)
    return float((np.exp(avg_diff) - 1) * 100)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test) -> float:
    """BD-PSNR in dB (positive = test is better at equal rate)."""
    lr_a = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lr_t = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)
    p_a = np.polyfit(lr_a, pa, 3)
    p_t = np.polyfit(lr_t, pt, 3)
    lo = max(lr_a.min(), lr_t.min())
    hi = min(lr_a.max(), lr_t.max())
    ia = np.polyint(p_a)
    it = np.polyint(p_t)
    int_a = np.polyval(ia, hi) - np.polyval(ia, lo)
    int_t = np.polyval(it, hi) - np.polyval(it, lo)
    return float((int_t - int_a) / (hi - lo))
