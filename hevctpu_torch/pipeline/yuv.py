"""YUV420 8-bit planar file I/O.

Equivalent of the reference's TVideoIOYuv (TVideoIOYuv.cpp:120-755) for the
4:2:0 8-bit case, plus the HM-style sequence-config reader that replaces the
reference's fragile parse-by-line-number contract (gen_frames.py:4-16,
use_model.py:65-71 both re-parse bitstream.cfg independently)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Sequence:
    path: str
    width: int
    height: int
    fps: float = 30.0
    frames: int = 0


def read_yuv420(path: str, width: int, height: int, num_frames: int = 0,
                skip: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (y [N,H,W], u [N,H/2,W/2], v [N,H/2,W/2]) uint8."""
    fsz = width * height * 3 // 2
    data = np.fromfile(path, dtype=np.uint8)
    total = len(data) // fsz
    n = total - skip if num_frames == 0 else min(num_frames, total - skip)
    ys, us, vs = [], [], []
    cw, ch = width // 2, height // 2
    for i in range(skip, skip + n):
        f = data[i * fsz:(i + 1) * fsz]
        ys.append(f[: width * height].reshape(height, width))
        us.append(f[width * height: width * height + cw * ch].reshape(ch, cw))
        vs.append(f[width * height + cw * ch:].reshape(ch, cw))
    return np.stack(ys), np.stack(us), np.stack(vs)


def write_yuv420(path: str, y: np.ndarray, u: np.ndarray, v: np.ndarray):
    with open(path, "wb") as f:
        for i in range(y.shape[0]):
            f.write(y[i].astype(np.uint8).tobytes())
            f.write(u[i].astype(np.uint8).tobytes())
            f.write(v[i].astype(np.uint8).tobytes())


def parse_hm_cfg(path: str) -> dict:
    """Parse an HM-style config file ('Key : Value # comment' lines), the
    grammar of program_options_lite.cpp:453."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or ":" not in line:
                continue
            key, _, val = line.partition(":")
            out[key.strip()] = val.strip()
    return out


def sequence_from_cfg(path: str) -> Sequence:
    cfg = parse_hm_cfg(path)
    return Sequence(
        path=cfg["InputFile"].replace("\\", "/"),
        width=int(cfg["SourceWidth"]),
        height=int(cfg["SourceHeight"]),
        fps=float(cfg.get("FrameRate", 30)),
        frames=int(cfg.get("FramesToBeEncoded", 0)),
    )
