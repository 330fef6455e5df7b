"""Wire-blob dequantization: K2 (int8) and K3 (int4) of the port.

The JAX package decodes a quantized wire blob on the device with two XLA
programs, ``models/quant.py::_decode_qblobs_impl`` (int8, ``:276``) and
``_decode_q4blobs_impl`` (int4, ``:305``).  Here each is a kernel written
by hand for Hopper, beside its plain PyTorch version:

- ``csrc/dequant.cu``: K2 (``dequant_int8_launch``) and K3
  (``dequant_int4_launch``), built with ``nvcc`` on first use and called
  through ``ctypes`` (``ops/cuda_build.py``); the source's note gives
  their bound and design;
- ``dequant_int8_ref`` / ``dequant_int4_ref``: the plain versions.

One call decodes one wire blob.  The blob's layout comes as a leaf table
(``Leaf`` entries in blob order, built by ``models/quant.leaf_table``),
and each leaf is written into its own preallocated output -- for a
stacked boot, slot ``i`` of an ``(n, *shape)`` tensor.  Every element is
``float(q) * scale`` in f32, rounded once to the output type (bf16, f16
or f32), which is bit-identical to the JAX package's
``(q.astype(f32) * scale).astype(dt)``: ``copy_`` into a bf16 or f16
tensor rounds to nearest even, as the kernels' ``__float2bfloat16_rn`` and
``__float2half_rn`` do.

``dequant`` takes the plain version only for a blob on the CPU.  For a
CUDA blob it launches the kernel or raises.  ``launches`` counts the
kernel launches, ``launches_by_kernel`` which kernel each was, and
``plain_calls`` the calls of each plain version, so a run can show which
path it took; ``launches_by_instance`` splits each kernel's launches by
output type (``"int8:float16"``) and ``launches_by_device`` by card;
``dequant`` also returns the launches it made.  A launch runs on the
blob's card: the wrapper makes it the current device for the call, as
``ops/flash_attention.py`` does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

SOURCE = "dequant.cu"
KINDS = ("int8", "int4")  # K2, K3
_SYMBOLS = {"int8": "dequant_int8_launch", "int4": "dequant_int4_launch"}
RUN = 16  # elements (int8) or packed bytes (int4, raw) per work item
MAX_LEAVES = 16  # the kernels' by-value table
OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
SCALE_BYTES = 4  # one f32 scale
_LAYOUTS = {"int8": ("q8",), "int4": ("q4", "raw")}
_LAYOUT_IDS = {"q8": 0, "q4": 1, "raw": 2}  # the source's LAYOUT_*

# Since the last reset_counts(): kernel launches, in all and per kernel,
# and calls of each plain version.
launches = 0
launches_by_kernel = {kind: 0 for kind in KINDS}
launches_by_instance = {f"{kind}:{str(dt).split('.')[-1]}": 0
                        for kind in KINDS for dt in OUT_KINDS}
# card ("cuda:k") -> kind -> launches on that card.
launches_by_device = {}
plain_calls = {kind: 0 for kind in KINDS}

_fns = {}
_lib_lock = threading.Lock()
_count_lock = threading.Lock()  # the stager and the warm-up count at once


class Leaf(NamedTuple):
    """One leaf's section of a wire blob.  ``layout``: ``"q8"`` (rows f32
    scales, then rows x cols int8), ``"q4"`` (rows x groups f32 scales,
    then rows x cols/2 packed bytes) or ``"raw"`` (the leaf's bytes in the
    output type).  ``offset``/``nbytes``: the section's place in the blob."""

    name: str
    shape: Tuple[int, ...]
    layout: str
    offset: int
    nbytes: int
    rows: int
    cols: int
    groups: int


def reset_counts() -> None:
    global launches
    with _count_lock:
        launches = 0
        for kind in KINDS:
            launches_by_kernel[kind] = 0
            plain_calls[kind] = 0
        for name in launches_by_instance:
            launches_by_instance[name] = 0
        launches_by_device.clear()


def _kernel(kind: str):
    with _lib_lock:
        if kind not in _fns:
            fn = getattr(cuda_build.load(SOURCE), _SYMBOLS[kind])
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[kind] = fn
        return _fns[kind]


def _check(kind: str, blob: torch.Tensor, table: Sequence[Leaf],
           outs: Sequence[torch.Tensor]) -> None:
    if kind not in KINDS:
        raise ValueError(f"no dequant kernel for {kind!r}")
    if blob.dim() != 1 or blob.dtype != torch.uint8 or not blob.is_contiguous():
        raise ValueError("blob must be a contiguous 1-D uint8 tensor")
    if len(table) != len(outs):
        raise ValueError(f"{len(table)} leaves but {len(outs)} outputs")
    off = 0
    for leaf, out in zip(table, outs):
        if leaf.layout not in _LAYOUTS[kind]:
            raise ValueError(f"leaf {leaf.name}: layout {leaf.layout!r} is "
                             f"not an {kind} layout")
        if leaf.offset != off:
            raise ValueError(f"leaf {leaf.name} at {leaf.offset}, expected "
                             f"{off}")
        if out.dtype not in OUT_KINDS or out.dtype != outs[0].dtype:
            raise ValueError(f"outputs must all be bfloat16, all float16 or "
                             f"all float32, got {out.dtype}")
        if out.device != blob.device or not out.is_contiguous():
            raise ValueError(f"output of {leaf.name} must be contiguous on "
                             f"{blob.device}")
        if tuple(out.shape) != tuple(leaf.shape) or (
                out.numel() != leaf.rows * leaf.cols):
            raise ValueError(f"output of {leaf.name}: shape "
                             f"{tuple(out.shape)} != {tuple(leaf.shape)}")
        if leaf.layout == "q8":
            want = leaf.rows * (SCALE_BYTES + leaf.cols)
        elif leaf.layout == "q4":
            if leaf.cols % 2 or leaf.groups < 1 or leaf.cols % leaf.groups:
                raise ValueError(f"leaf {leaf.name}: cols {leaf.cols} and "
                                 f"{leaf.groups} groups cannot pack")
            want = leaf.rows * (leaf.groups * SCALE_BYTES + leaf.cols // 2)
        else:
            want = out.numel() * out.element_size()
        if leaf.nbytes != want:
            raise ValueError(f"leaf {leaf.name}: {leaf.nbytes} bytes, its "
                             f"layout needs {want}")
        off += leaf.nbytes
    if off != blob.numel():
        raise ValueError(f"wire blob size {blob.numel()} != expected {off}")


def _f32(raw: torch.Tensor) -> torch.Tensor:
    """f32 values from a byte slice at any offset: a fresh copy is aligned
    for the view that a slice of the blob may not be."""
    return raw.clone().view(torch.float32)


def dequant_int8_ref(blob, table, outs) -> None:
    """Plain PyTorch K2 (same arguments as ``dequant``)."""
    _check("int8", blob, table, outs)
    with _count_lock:
        plain_calls["int8"] += 1
    for leaf, out in zip(table, outs):
        rows, cols = leaf.rows, leaf.cols
        q_off = leaf.offset + rows * SCALE_BYTES
        scale = _f32(blob[leaf.offset:q_off])
        q = blob[q_off:q_off + rows * cols].view(torch.int8).reshape(rows, cols)
        out.view(rows, cols).copy_(q.float() * scale[:, None])


def dequant_int4_ref(blob, table, outs) -> None:
    """Plain PyTorch K3 (same arguments as ``dequant``)."""
    _check("int4", blob, table, outs)
    with _count_lock:
        plain_calls["int4"] += 1
    for leaf, out in zip(table, outs):
        if leaf.layout == "raw":
            out.view(-1).view(torch.uint8).copy_(
                blob[leaf.offset:leaf.offset + leaf.nbytes])
            continue
        rows, cols, groups = leaf.rows, leaf.cols, leaf.groups
        c2 = cols // 2
        p_off = leaf.offset + rows * groups * SCALE_BYTES
        scale = _f32(blob[leaf.offset:p_off]).reshape(rows, groups, 1)
        packed = blob[p_off:p_off + rows * c2].reshape(rows, c2)
        q = torch.cat([(packed & 0xF).to(torch.int8) - 8,
                       (packed >> 4).to(torch.int8) - 8], dim=1)
        x = q.float().reshape(rows, groups, cols // groups) * scale
        out.view(rows, cols).copy_(x.reshape(rows, cols))


_REF = {"int8": dequant_int8_ref, "int4": dequant_int4_ref}


def _geometry(table: Sequence[Leaf],
              outs: Sequence[torch.Tensor]) -> Tuple[np.ndarray, int]:
    """The kernels' host table (the source's int64 fields per leaf, in its
    order) and the total work items."""
    rows_out: List[List[int]] = []
    items = 0
    for leaf, out in zip(table, outs):
        scale_off, data_off, nbytes = leaf.offset, 0, 0
        if leaf.layout == "q8":
            runs = -(-leaf.cols // RUN)
            n = leaf.rows * runs
            data_off = leaf.offset + leaf.rows * SCALE_BYTES
        elif leaf.layout == "q4":
            runs = -(-(leaf.cols // 2) // RUN)
            n = leaf.rows * runs
            data_off = leaf.offset + leaf.rows * leaf.groups * SCALE_BYTES
        else:
            runs = 0
            n = -(-leaf.nbytes // RUN)
            nbytes = leaf.nbytes
        if n >= 1 << 31 or leaf.rows >= 1 << 31 or leaf.cols >= 1 << 31:
            raise ValueError(f"leaf {leaf.name} too large for the kernel's "
                             f"32-bit row arithmetic")
        rows_out.append([_LAYOUT_IDS[leaf.layout], scale_off, data_off, items,
                         out.data_ptr(), nbytes, leaf.rows, leaf.cols,
                         leaf.groups, runs])
        items += n
    return np.asarray(rows_out, dtype=np.int64).reshape(-1), items


def dequant(kind: str, blob: torch.Tensor, table: Sequence[Leaf],
            outs: Sequence[torch.Tensor]) -> int:
    """Decode one ``kind`` ("int8": K2, "int4": K3) wire blob: leaf
    ``table[i]`` into ``outs[i]`` (contiguous, its leaf's shape, all bf16,
    all f16 or all f32, on the blob's device).  A CPU blob takes the plain
    version; a CUDA blob launches the kernel or raises.  Returns the
    kernel launches this call made (0 or 1)."""
    global launches
    _check(kind, blob, table, outs)
    if blob.device.type == "cpu":
        _REF[kind](blob, table, outs)
        return 0
    if blob.device.type != "cuda":
        raise ValueError(f"unsupported device {blob.device}")
    if len(table) > MAX_LEAVES:
        raise ValueError(f"{len(table)} leaves; the kernel takes at most "
                         f"{MAX_LEAVES}")
    geo, items = _geometry(table, outs)
    if items == 0:
        return 0
    fn = _kernel(kind)
    with torch.cuda.device(blob.device):
        stream = torch.cuda.current_stream(blob.device).cuda_stream
        err = fn(blob.data_ptr(), geo.ctypes.data, len(table), items,
                 OUT_KINDS[outs[0].dtype], stream)
    if err != 0:
        raise RuntimeError(f"dequant {kind} kernel launch failed: CUDA error "
                           f"{err}")
    with _count_lock:
        launches += 1
        launches_by_kernel[kind] += 1
        launches_by_instance[
            f"{kind}:{str(outs[0].dtype).split('.')[-1]}"] += 1
        per = launches_by_device.setdefault(str(blob.device), {})
        per[kind] = per.get(kind, 0) + 1
    return 1
