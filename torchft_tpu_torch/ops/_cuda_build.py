"""Builds the port's hand-written CUDA kernels with ``nvcc`` at first use.

Each source under ``ops/csrc/`` becomes one shared library with a plain C
interface, loaded with ``ctypes``. The library is built from the checkout's
own sources into ``torchft_tpu_torch/_build/`` (ignored by git), named by a
hash of the source and the flags, so a changed source is rebuilt and an
unchanged one is built once per checkout. Concurrent processes (two replica
groups starting together) serialize on a file lock; the loser finds the
library already built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 if it was found
# already built).
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "torchft_tpu_torch are built from source on the machine with the card"
    )


def library_path(source: str) -> Path:
    src = _CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> Path:
    """Compiles ``csrc/<source>`` unless its library is current; returns the
    library's path. ptxas' register and shared-memory report is kept beside
    it as ``<stem>.ptxas.txt``."""
    out = library_path(source)
    if out.exists():
        build_seconds.setdefault(source, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if out.exists():
                build_seconds.setdefault(source, 0.0)
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.monotonic()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / source)],
                capture_output=True,
                text=True,
            )
            build_seconds[source] = time.monotonic() - t0
            (BUILD_DIR / f"{Path(source).stem}.ptxas.txt").write_text(
                proc.stdout + proc.stderr
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source}:\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
