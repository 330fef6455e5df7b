"""WeightMover: staged host->device transfer of layer bytes.

Port of the JAX package's ``parallel/mover.py``.  Host bytes reach the
CUDA device through a small ring of pinned (page-locked) host chunks: a
caller copies a piece of its buffer into a free chunk (a GIL-releasing
memcpy) and the chunk's DMA is issued ``non_blocking`` on the mover's
side stream, so the memcpy of piece k+1 overlaps the DMA of piece k and
concurrent writers share the ring.  A chunk is reused only after the CUDA
event recorded behind its copy has completed.  On the CPU the "device"
is host memory and a copy is one memcpy.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..core.types import LayerID, LayerLocation, LayerSrc, LayersSrc
from ..utils import hostmem
from ..utils.device import resolve_device
from ..utils.logging import log

CHUNK_BYTES = 16 << 20
N_CHUNKS = 8


def bytes_to_array(data, dtype=torch.bfloat16) -> torch.Tensor:
    """Raw layer bytes as a 1-D CPU tensor of ``dtype``, zero-padded to
    the dtype's itemsize."""
    itemsize = dtype.itemsize
    src = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = src.shape[0]
    buf = np.zeros(n + (-n) % itemsize, dtype=np.uint8)
    buf[:n] = src
    return torch.from_numpy(buf).view(dtype)


def array_to_bytes(arr: torch.Tensor) -> bytes:
    """Round-trip: a device tensor back to its raw bytes."""
    return arr.detach().contiguous().reshape(-1).view(torch.uint8).cpu() \
        .numpy().tobytes()


@dataclasses.dataclass
class StageResult:
    layer_id: LayerID
    array: torch.Tensor
    nbytes: int
    seconds: float


class _Chunk:
    def __init__(self, nbytes: int):
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.view = self.host.numpy()
        self.event = torch.cuda.Event()


class WeightMover:
    """Moves layer bytes onto one device (None = the CUDA card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._free: Optional["queue.Queue[_Chunk]"] = None
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._free = queue.Queue()
            for _ in range(N_CHUNKS):
                self._free.put(_Chunk(CHUNK_BYTES))

    def order_after_current(self) -> None:
        """Make later copies wait for the work already queued on the
        caller's current stream (e.g. the previous owner of memory the
        caching allocator just handed out)."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def copy_to(self, dst: torch.Tensor, src) -> None:
        """Copy host bytes ``src`` into the 1-D uint8 tensor ``dst`` (same
        length).  Thread-safe.  On CUDA the copy may still be in flight on
        return: ``synchronize`` waits for it."""
        src = np.frombuffer(memoryview(src), dtype=np.uint8)
        n = src.shape[0]
        if dst.numel() != n:
            raise ValueError(f"copy of {n} bytes into {dst.numel()}")
        if self._stream is None:
            hostmem.copy_into(dst.numpy(), 0, src)
            return
        for off in range(0, n, CHUNK_BYTES):
            end = min(n, off + CHUNK_BYTES)
            chunk = self._free.get()
            try:
                chunk.event.synchronize()  # its previous DMA has landed
                hostmem.copy_into(chunk.view, 0, src[off:end])
                with torch.cuda.stream(self._stream):
                    dst[off:end].copy_(chunk.host[: end - off],
                                       non_blocking=True)
                    chunk.event.record(self._stream)
            finally:
                self._free.put(chunk)

    def copy_device(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Device-to-device copy ordered with the mover's host copies."""
        if self._stream is None:
            dst.copy_(src)
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            dst.copy_(src, non_blocking=True)
            src.record_stream(self._stream)

    def synchronize(self) -> None:
        """Wait until every copy issued so far has landed."""
        if self._stream is not None:
            self._stream.synchronize()

    def to_device(self, data) -> torch.Tensor:
        """Host bytes -> a new 1-D uint8 tensor on the device, landed."""
        n = len(memoryview(data).cast("B"))
        out = torch.empty(n, dtype=torch.uint8, device=self.device)
        self.order_after_current()
        self.copy_to(out, data)
        self.synchronize()
        return out

    @staticmethod
    def _host_view(layer: LayerSrc):
        if (layer.meta.location == LayerLocation.INMEM
                and layer.inmem_data is not None):
            return layer.inmem_data
        return layer.read_bytes()

    def stage(self, layer: LayerSrc) -> torch.Tensor:
        """One layer host->device; updates the LayerSrc in place to HBM
        state (``device_array`` is the layer's 1-D uint8 tensor)."""
        arr = self.to_device(self._host_view(layer))
        layer.device_array = arr
        layer.meta.location = LayerLocation.HBM
        return arr

    def stage_layers(self, layers: LayersSrc,
                     order: Optional[Sequence[LayerID]] = None
                     ) -> List[StageResult]:
        """Pipelined bulk staging: issue every layer's copies, then drain
        completions in order.  A layer's ``seconds`` is its completion
        delta (time from the previous completion or the batch start), so
        the figures sum to the batch wall time."""
        ids = list(order if order is not None else sorted(layers))
        results: List[StageResult] = []
        in_flight = []
        prev = time.monotonic()
        self.order_after_current()
        for lid in ids:
            host = self._host_view(layers[lid])
            n = len(memoryview(host).cast("B"))
            arr = torch.empty(n, dtype=torch.uint8, device=self.device)
            self.copy_to(arr, host)
            done = None
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
            in_flight.append((lid, arr, n, done))
            layers[lid].device_array = arr
            layers[lid].meta.location = LayerLocation.HBM
        for lid, arr, n, done in in_flight:
            if done is not None:
                done.synchronize()
            now = time.monotonic()
            dt = now - prev
            prev = now
            results.append(StageResult(lid, arr, n, dt))
            log.debug("layer staged to HBM", layerID=lid,
                      mib=round(n / (1 << 20), 2),
                      gbps=round(n / max(dt, 1e-9) / 1e9, 2))
        return results

    @staticmethod
    def throughput_gbps(results: Iterable[StageResult]) -> float:
        """Aggregate ingest throughput: total bytes over the batch span."""
        results = list(results)
        total = sum(r.nbytes for r in results)
        span = sum(r.seconds for r in results)
        return total / max(span, 1e-9) / 1e9
