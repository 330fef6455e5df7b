"""On-device partial-layer reassembly.

Port of the JAX package's ``ops/reassembly.py``.  Fragments are written
into a preallocated device buffer at their element offsets, in place.
The JAX package splits buffers past 2^31 elements into a segmented
``(rows, seg)`` layout because the TPU backend indexes in 32 bits; CUDA
tensors index in 64 bits, so a ``LayerBuffer`` here is always flat.

``split_offsets``/``stripe_offsets`` are the same pure integer tilings the
host data plane shares.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..utils.device import resolve_device


class LayerBuffer:
    """A preallocated device reassembly target of any size (flat)."""

    def __init__(self, n_elements: int, dtype=None, device=None):
        self.n_elements = n_elements
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.buf = torch.zeros(n_elements, dtype=self.dtype,
                               device=resolve_device(device))

    def write(self, offset: int, frag: torch.Tensor) -> None:
        """Write ``frag`` at absolute element ``offset`` (in place)."""
        write_fragment(self.buf, frag, offset)

    def array(self) -> torch.Tensor:
        """The assembled contiguous layer."""
        return self.buf


def alloc_layer_buffer(n_elements: int, dtype=None, device=None) -> LayerBuffer:
    """Preallocate the reassembly target on ``device`` (None = CUDA)."""
    return LayerBuffer(n_elements, dtype, device)


def write_fragment(buf, frag: torch.Tensor, offset: int):
    """Write one fragment into ``buf`` (a ``LayerBuffer`` or a flat
    tensor) at element ``offset``, in place; returns ``buf``.  A fragment
    outside the buffer raises instead of being clamped."""
    if isinstance(buf, LayerBuffer):
        buf.write(offset, frag)
        return buf
    n = frag.numel()
    if offset < 0 or offset + n > buf.numel():
        raise ValueError(
            f"fragment [{offset}, {offset + n}) outside buffer of "
            f"{buf.numel()} elements")
    buf[offset : offset + n].copy_(frag.reshape(-1))
    return buf


def assemble_fragments(n_elements: int,
                       fragments: Sequence[Tuple[int, torch.Tensor]],
                       dtype=None, device=None) -> torch.Tensor:
    """Build a full layer on the device from (element_offset, fragment)
    pairs -- the device-side equivalent of the receiver's byte-range
    reassembly."""
    buf = LayerBuffer(n_elements, dtype, device)
    for offset, frag in fragments:
        buf.write(offset, frag)
    return buf.array()


def split_offsets(total: int, parts: int) -> Sequence[Tuple[int, int]]:
    """Contiguous (offset, size) tiling of ``total`` elements into
    ``parts`` chunks -- the shape of a flow schedule's per-sender jobs."""
    base, rem = divmod(total, parts)
    spans = []
    off = 0
    for i in range(parts):
        size = base + (1 if i < rem else 0)
        spans.append((off, size))
        off += size
    return spans


def stripe_offsets(total: int, parts: int,
                   min_size: int = 1) -> List[Tuple[int, int]]:
    """``split_offsets`` with a floor: the even tiling of ``total`` into
    at most ``parts`` spans, each at least ``min_size`` (the whole thing
    as one span when ``total < 2 * min_size``)."""
    if total <= 0:
        return []
    if min_size > 0:
        parts = min(parts, total // min_size)
    parts = max(1, parts)
    return [s for s in split_offsets(total, parts) if s[1] > 0]
