"""Build a hand-written CUDA source into a shared library and load it.

The port's kernels are CUDA C++ files under ``csrc/`` with a plain C
interface.  Each is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into ``build/torch_kernels/`` at the repository root and
loaded with ``ctypes``; the library's file name carries a hash of the
source and flags, so an edited source rebuilds and a stale library is
never loaded.  A missing ``nvcc`` or a failed compile raises: there is no
fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards _locks
_locks: Dict[str, threading.Lock] = {}  # one per source: builds run in parallel
_built: Dict[str, Tuple[Path, float, str]] = {}  # source -> (lib, s, ptxas)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location.  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine with the card")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to (hash of source text + flags)."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless its library already exists.
    Returns ``(library path, build seconds, ptxas report)``; seconds is 0
    and the report empty when an existing library was reused.  Builds of
    different sources may run at the same time from different threads."""
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _built:
            return _built[source]
        out = library_path(source)
        seconds, report = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / source)]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.monotonic() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for {source} (exit {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}")
            report = proc.stderr
            os.replace(tmp, out)
        _built[source] = (out, seconds, report)
        return _built[source]


def load(source: str) -> ctypes.CDLL:
    """Build if needed, then ``ctypes``-load the library."""
    return ctypes.CDLL(str(build(source)[0]))
