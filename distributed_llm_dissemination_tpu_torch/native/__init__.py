"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime is a compiled binary (Go, ``go.mod:1``); this
package keeps the performance-critical scheduler core native too.  The
library is built from source on first use with the system ``g++`` into
``build/flow_solver/`` at the repository root (ignored by git; the JAX
package caches its build next to its source), so no build step is required
at install time and every environment with a C++ toolchain gets the fast
path.  Environments without one transparently fall back to the pure-Python
implementations — behavior is identical, only slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from ..utils.logging import log

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "flow_solver.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "flow_solver")
_LIB = os.path.join(BUILD_DIR, "libflowsolver.so")
_HASH = _LIB + ".srchash"  # content hash of the source the .so was built from

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> None:
    # Compile to a per-process temp name, then rename into place: rename is
    # atomic on POSIX, so concurrent node processes on one host never load
    # a partially written library.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    htmp = f"{_HASH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
        with open(htmp, "w") as f:
            f.write(_src_hash())
        os.replace(htmp, _HASH)
    finally:
        for leftover in (tmp, htmp):
            if os.path.exists(leftover):
                os.unlink(leftover)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.flow_max_flow_at.restype = ctypes.c_int64
    lib.flow_max_flow_at.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i64p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, i64p,
    ]
    lib.flow_min_time_schedule.restype = ctypes.c_int64
    lib.flow_min_time_schedule.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i64p, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p,
    ]
    return lib


def load_flow_solver() -> Optional[ctypes.CDLL]:
    """The native solver library, building it on first use; None if this
    environment can't build or load it (callers then use the Python path)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        # Use a pre-existing library only when its recorded source hash
        # matches the current source (mtimes don't survive git checkout, so
        # content hashing is the staleness check).  On missing/mismatched
        # hash, rebuild — via atomic os.replace, never by deleting first,
        # so a host without g++ keeps whatever library it has.
        hash_known = False
        if os.path.exists(_LIB):
            try:
                with open(_HASH) as f:
                    recorded = f.read().strip()
                # Only a comparison that actually executed makes the
                # provenance "known" — an unreadable source (deployment
                # shipping just the .so + sidecar) must leave the library
                # eligible for the unknown-provenance fallback below.
                matches = recorded == _src_hash()
                hash_known = True
                if matches:
                    try:
                        _lib = _bind(ctypes.CDLL(_LIB))
                        return _lib
                    except OSError:
                        pass  # wrong arch/corrupt: rebuild below
            except OSError:
                pass  # no hash sidecar: provenance unknown, rebuild below
        try:
            _build()
            _lib = _bind(ctypes.CDLL(_LIB))
            return _lib
        except (OSError, subprocess.CalledProcessError) as e:
            # Build impossible here (no g++?).  A library of unknown
            # provenance is still better than the slow Python path —
            # but a KNOWN-stale one (hash mismatch) is wrong code: skip it.
            if os.path.exists(_LIB) and not hash_known:
                try:
                    _lib = _bind(ctypes.CDLL(_LIB))
                    log.warn("using pre-built flow solver of unknown "
                             "provenance (no g++ to rebuild)")
                    return _lib
                except OSError:
                    pass
            _load_failed = True
            stderr = getattr(e, "stderr", b"")
            log.warn("native flow solver unavailable, using Python path",
                     err=repr(e),
                     compiler_stderr=stderr.decode(errors="replace") if stderr else "")
            return None
