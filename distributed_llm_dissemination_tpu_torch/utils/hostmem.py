"""Aligned host buffers and zero-copy adoption as CPU tensors.

Copy of the JAX package's ``utils/hostmem.py``.  ``aligned_empty``,
``copy_into`` and ``is_adoptable`` are unchanged; adoption
(``adopt_as_device_array``) becomes ``torch.from_numpy`` — a CPU tensor
aliasing the buffer with no copy.  A CUDA destination is not an adoption:
bytes reach the card through ``parallel.mover``'s pinned staging.

Safety contract for adoption: the tensor aliases the numpy buffer, so the
caller must never write to the buffer afterwards.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

ALIGN = 64

# Below this, numpy's sliced assignment is fine; above it ctypes.memmove
# (a real memcpy with the GIL released) is several times faster.
_MEMMOVE_MIN = 64 * 1024


def copy_into(dst, dst_off: int, src) -> None:
    """``dst[dst_off : dst_off+len(src)] = src`` at memmove speed.

    ``dst`` is a writable byte buffer (uint8 ndarray or bytearray);
    ``src`` any byte buffer."""
    sv = np.frombuffer(src, dtype=np.uint8)
    dv = (dst if isinstance(dst, np.ndarray)
          else np.frombuffer(dst, dtype=np.uint8))
    n = sv.shape[0]
    if n >= _MEMMOVE_MIN:
        ctypes.memmove(dv.ctypes.data + dst_off, sv.ctypes.data, n)
    else:
        dv[dst_off : dst_off + n] = sv


def aligned_empty(nbytes: int, align: int = ALIGN) -> np.ndarray:
    """An uninitialized uint8 buffer whose data pointer is ``align``-byte
    aligned (over-allocate + offset)."""
    raw = np.empty(nbytes + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off : off + nbytes]


def is_adoptable(buf: np.ndarray) -> bool:
    return (
        buf.dtype == np.uint8
        and buf.flags["C_CONTIGUOUS"]
        and buf.ctypes.data % ALIGN == 0
    )


def adopt_as_device_array(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """``buf`` as a 1-D uint8 CPU tensor, zero-copy.  CPU arm only: the
    caller forfeits write access to ``buf``."""
    if torch.device(device).type != "cpu":
        raise ValueError(f"zero-copy adoption is CPU-only, got {device}")
    return torch.from_numpy(buf)
