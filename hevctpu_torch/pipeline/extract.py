"""Frame extraction from containerized video (the gen_frames.py role;
a copy of hevctpu/pipeline/extract.py with its imports rewritten).

The reference shells out to ffmpeg to decompress the input to per-frame
JPEGs for the CNN (gen_frames.py:1-27 of the reference pipeline, driven
by the line-number-indexed bitstream.cfg), because its predictor runs in a
separate process on RGB images. This pipeline feeds the CNN straight from the YUV
planes on device (models/convnet2.yuv_to_rgb01) — no disk roundtrip, no
JPEG recompression mismatch — so extraction is only needed to ingest
non-YUV sources. ffmpeg is optional and gated; raw .yuv input never
touches it.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np

from hevctpu_torch.pipeline import yuv


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_clip(path: str, width: int, height: int, frames: int = 0,
              fps: float = 30.0):
    """Load a clip as YUV420 planes (y [N,H,W], u, v [N,H/2,W/2] uint8).

    Raw .yuv is read directly (TVideoIOYuv::read role); any other container
    is decoded through ffmpeg to yuv420p when available."""
    if path.endswith((".yuv", ".YUV")):
        return yuv.read_yuv420(path, width, height, frames)
    if not ffmpeg_available():
        raise RuntimeError(
            f"{path}: non-YUV input needs ffmpeg (not found on PATH)")
    cmd = ["ffmpeg", "-v", "error", "-i", path, "-pix_fmt", "yuv420p",
           "-f", "rawvideo", "-"]
    if frames:
        cmd[-3:-3] = ["-frames:v", str(frames)]
    raw = subprocess.run(cmd, check=True, capture_output=True).stdout
    fsz = width * height * 3 // 2
    n = len(raw) // fsz
    buf = np.frombuffer(raw[: n * fsz], np.uint8).reshape(n, fsz)
    ys = buf[:, : width * height].reshape(n, height, width)
    us = buf[:, width * height: width * height * 5 // 4].reshape(
        n, height // 2, width // 2)
    vs = buf[:, width * height * 5 // 4:].reshape(n, height // 2, width // 2)
    return ys, us, vs


def extract_frames(cfg_path: str, out_dir: str):
    """Reference-parity helper: parse the sequence cfg and dump numbered
    frames (1.npy, 2.npy, ...) + recreate an empty pred/ directory — the
    observable behavior of gen_frames.py:17-27, minus the lossy JPEG hop
    (frames are stored as lossless YUV arrays)."""
    seq = yuv.sequence_from_cfg(cfg_path)
    y, u, v = load_clip(seq.path, seq.width, seq.height, seq.frames)
    os.makedirs(out_dir, exist_ok=True)
    pred = os.path.join(os.path.dirname(out_dir) or ".", "pred")
    shutil.rmtree(pred, ignore_errors=True)
    os.makedirs(pred, exist_ok=True)
    for i in range(y.shape[0]):
        np.save(os.path.join(out_dir, f"{i + 1}.npy"),
                np.stack([y[i], np.repeat(np.repeat(u[i], 2, 0), 2, 1),
                          np.repeat(np.repeat(v[i], 2, 0), 2, 1)]))
    return y.shape[0]
