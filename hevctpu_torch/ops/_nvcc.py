"""nvcc builds of the port's hand-written CUDA kernels (csrc/*.cu): each
source compiled into a shared library under csrc/_build/ at first use,
for its wrapper (ops/satd_fused.py, ops/stage2_ctu.py) to load through
ctypes."""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources(source: Path) -> list[Path]:
    """`source` and every file it includes in quotes, found beside the file
    that includes it, and theirs in turn."""
    found = [source.resolve()]
    for path in found:
        for name in _INCLUDE.findall(path.read_bytes()):
            inc = (path.parent / name.decode()).resolve()
            if inc.exists() and inc not in found:
                found.append(inc)
    return found


def library_path(source: Path, flags) -> Path:
    """The library of `source` built with `flags`: its name is keyed on
    both and on the headers the source includes, so an edited source or
    header never loads a stale build."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources(source):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, flags) -> tuple[float, str]:
    """Compile `source` with nvcc and `flags` into library_path(source,
    flags) unless it exists. Returns the seconds spent and what ptxas
    reported (registers, shared memory, spills), kept beside the
    library."""
    so = library_path(source, flags)
    log = so.with_suffix(".ptxas.txt")
    if so.exists():
        return 0.0, log.read_text() if log.exists() else ""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0, proc.stderr
