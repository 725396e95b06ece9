# Frozen copy of hevctpu_torch/pipeline/clips.py at commit 6f811bd: the
# benchmark's content generator (numpy only). Only this header differs from
# the source.

"""Synthetic RD-evaluation corpus with natural-image statistics.

The reference's evaluation protocol runs the encoder sweep on real YCbCr
sequences (calc_BDBR/README.md:12; bitstream.cfg:1-9 ships Flowervase
416x240).  No real footage ships in this environment, so the corpus here
is synthetic — but built to have the *statistics* that make Bjontegaard
metrics well-behaved, which the original bench clip (pure sin/cos plus
white noise) does not:

  * ``pink``    — 1/f^alpha filtered noise.  Natural images have power
                  spectra close to 1/f^2 (Field 1987); this is the
                  canonical stand-in for photographic texture.  Slow
                  per-frame phase drift models camera shake.
  * ``scene``   — composited graphics scene: smooth illumination
                  gradient, several textured regions (windowed pink
                  noise), and hard-edged high-contrast rectangles.
                  Exercises the CU-split decision (flat areas want depth
                  0-1, edges want depth 2-3).
  * ``pan``     — a single large pink-noise "landscape" viewed through a
                  panning crop window: pure global motion, the classic
                  easy-inter / hard-intra content.
  * ``detail``  — dense fine structure: text-like strokes over a mid
                  gray plus high-frequency texture; the rate-hungry end
                  of the corpus.
  * ``sine``    — the legacy bench.py clip (kept for continuity with
                  rounds 1-3 measurements; its flat PSNR/log-rate slope
                  makes BD-rate % on it unstable, which is exactly why
                  the corpus exists).

Chroma planes are derived from independently filtered low-frequency
fields so 4:2:0 subsampling is honest (no white-noise chroma).

All generators are deterministic in (name, n, h, w, seed).
"""

from __future__ import annotations

import numpy as np

# The four corpus families RD claims are measured on; "sine" is legacy.
CORPUS = ("pink", "scene", "pan", "detail")


def _pink_field(rng, h, w, alpha=1.9, lo_cut=1.0):
    """One 1/f^alpha random field in [-1, 1]-ish range, unit std."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    amp = 1.0 / np.maximum(f, lo_cut / max(h, w)) ** (alpha / 2.0)
    phase = rng.uniform(0, 2 * np.pi, amp.shape)
    spec = amp * np.exp(1j * phase)
    x = np.fft.irfft2(spec, s=(h, w))
    return (x - x.mean()) / (x.std() + 1e-9)


def _to_u8(x, mean=128.0, span=55.0):
    return np.clip(mean + span * x, 0, 255).astype(np.int32)


def _chroma_from(rng, h, w, scale=30.0):
    """Low-frequency chroma pair at 4:2:0 resolution."""
    cu = _pink_field(rng, h // 2, w // 2, alpha=2.6)
    cv = _pink_field(rng, h // 2, w // 2, alpha=2.6)
    u = np.clip(128 + scale * cu, 0, 255).astype(np.int32)
    v = np.clip(128 + scale * cv, 0, 255).astype(np.int32)
    return u, v


def _drift(x, dy, dx):
    return np.roll(np.roll(x, dy, axis=0), dx, axis=1)


def clip_pink(n, h, w, seed=0):
    rng = np.random.default_rng(1000 + seed)
    base = _pink_field(rng, h, w)
    fine = 0.25 * _pink_field(rng, h, w, alpha=1.2)
    y = np.stack([
        _to_u8(_drift(base, i, 2 * i) + _drift(fine, -i, i))
        for i in range(n)])
    u, v = _chroma_from(rng, h, w)
    return y, np.repeat(u[None], n, 0), np.repeat(v[None], n, 0)


def clip_scene(n, h, w, seed=0):
    rng = np.random.default_rng(2000 + seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    grad = 0.8 * (yy / h - 0.5) + 0.4 * (xx / w - 0.5)
    tex = _pink_field(rng, h, w, alpha=1.5)
    frame0 = 0.35 * grad.copy()
    # textured regions
    for _ in range(6):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        bh, bw = rng.integers(h // 6, h // 2), rng.integers(w // 6, w // 2)
        frame0[y0:y0 + bh, x0:x0 + bw] += 0.5 * tex[y0:y0 + bh, x0:x0 + bw]
    # hard-edged high-contrast rectangles
    flat = np.zeros((h, w))
    for _ in range(8):
        y0, x0 = rng.integers(0, h - 16), rng.integers(0, w - 16)
        bh, bw = rng.integers(8, h // 3), rng.integers(8, w // 3)
        flat[y0:y0 + bh, x0:x0 + bw] = rng.uniform(-1, 1)
    frame0 += 0.7 * flat
    y = np.stack([_to_u8(_drift(frame0, 0, i), span=70.0) for i in range(n)])
    u, v = _chroma_from(rng, h, w, scale=40.0)
    return y, np.repeat(u[None], n, 0), np.repeat(v[None], n, 0)


def clip_pan(n, h, w, seed=0):
    rng = np.random.default_rng(3000 + seed)
    big = _pink_field(rng, h + 8 * n, w + 8 * n, alpha=2.0)
    y = np.stack([
        _to_u8(big[4 * i:4 * i + h, 8 * i:8 * i + w], span=60.0)
        for i in range(n)])
    ub = np.clip(128 + 35 * _pink_field(
        rng, (h + 8 * n) // 2, (w + 8 * n) // 2, alpha=2.6), 0, 255)
    vb = np.clip(128 + 35 * _pink_field(
        rng, (h + 8 * n) // 2, (w + 8 * n) // 2, alpha=2.6), 0, 255)
    u = np.stack([ub[2 * i:2 * i + h // 2, 4 * i:4 * i + w // 2]
                  for i in range(n)]).astype(np.int32)
    v = np.stack([vb[2 * i:2 * i + h // 2, 4 * i:4 * i + w // 2]
                  for i in range(n)]).astype(np.int32)
    return y, u, v


def clip_detail(n, h, w, seed=0):
    rng = np.random.default_rng(4000 + seed)
    tex = 0.35 * _pink_field(rng, h, w, alpha=1.0)
    strokes = np.zeros((h, w))
    # text-like strokes: short dark horizontal/vertical runs on a grid
    for _ in range(h * w // 220):
        y0, x0 = rng.integers(2, h - 3), rng.integers(2, w - 10)
        ln = rng.integers(3, 9)
        if rng.random() < 0.8:
            strokes[y0, x0:x0 + ln] = -1.2
        else:
            strokes[y0:y0 + min(ln, h - 1 - y0), x0] = -1.2
    base = tex + strokes
    y = np.stack([_to_u8(_drift(base, 0, i % 3), span=60.0)
                  for i in range(n)])
    u, v = _chroma_from(rng, h, w, scale=20.0)
    return y, np.repeat(u[None], n, 0), np.repeat(v[None], n, 0)


def clip_sine(n, h, w, seed=0):
    """The legacy bench.py clip (rounds 1-3 continuity)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([
        (128 + 70 * np.sin(yy / (7 + i)) * np.cos(xx / (11 + 2 * i))
         + rng.normal(0, 6, (h, w))).clip(0, 255).astype(np.int32)
        for i in range(n)])
    u = np.stack([(128 + 40 * np.cos(yy[::2, ::2] / (9 + i))).astype(np.int32)
                  for i in range(n)])
    v = rng.integers(60, 200, (n, h // 2, w // 2)).astype(np.int32)
    return y, u, v


_GEN = {"pink": clip_pink, "scene": clip_scene, "pan": clip_pan,
        "detail": clip_detail, "sine": clip_sine}


def make_clip(name, n, h, w, seed=0):
    """Return (y [n,h,w], u, v [n,h/2,w/2]) int32 planes for a corpus clip."""
    return _GEN[name](n, h, w, seed=seed)


def write_yuv(path, y, u, v):
    """Serialize a clip as raw 8-bit YUV420 (HM InputFile format)."""
    with open(path, "wb") as f:
        for k in range(y.shape[0]):
            f.write(y[k].astype(np.uint8).tobytes())
            f.write(u[k].astype(np.uint8).tobytes())
            f.write(v[k].astype(np.uint8).tobytes())
