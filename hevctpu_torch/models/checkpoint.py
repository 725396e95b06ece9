"""Parameter checkpoint save/restore for the ConvNet2 weights, as plain
npz files of the JAX package's params layout (nested dict flattened with
"/" keys; conv kernels HWIO, linear weights [in, out]). The JAX package
also reads orbax directories; the port reads npz only."""

from __future__ import annotations

import numpy as np


def _flatten(params: dict, prefix: str = ""):
    for k, v in params.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, np.asarray(v)


def save(path: str, params: dict):
    """Save a params dict to an .npz file."""
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path must end in .npz: {path}")
    np.savez(path, **dict(_flatten(params)))


def load(path: str) -> dict:
    """Load an .npz params file into the nested params dict."""
    if not path.endswith(".npz"):
        raise ValueError(f"checkpoint path must end in .npz: {path}")
    flat = np.load(path)
    out: dict = {}
    for key in flat.files:
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = flat[key]
    return out
