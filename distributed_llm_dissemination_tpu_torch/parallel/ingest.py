"""Incremental layer ingest: fragments land on the device as they arrive.

Port of the JAX package's ``parallel/ingest.py`` for one device.  A
layer's fragments arrive in any order, possibly concurrently and
duplicated; ``ShardedLayerIngest`` lands each one at its byte offset and
``finalize`` hands back the whole layer once coverage is complete.  Two
arms, split by platform as in the JAX package:

- **CUDA (stream)**: the layer is one preallocated ``torch.uint8``
  device tensor; each fragment's bytes go host->device through the
  ``WeightMover``'s pinned chunks on its side stream, so the PCIe DMA of
  fragment k overlaps the arrival of fragment k+1.  PCIe carries the
  layer's bytes exactly once.
- **CPU (host-accumulate)**: fragments are memcpy'd into one 64-byte
  aligned host buffer and ``finalize`` adopts it zero-copy as the layer's
  tensor (``utils.hostmem``).

Both keep the JAX package's claim/commit discipline
(``utils.intervals.ClaimedCoverage``): ``write`` claims its uncovered
ranges under the lock before moving bytes (overlapping duplicates never
copy twice, concurrent writers never land the same range), a failed
write rolls its claim back, and ``finalize`` waits for full coverage with
no claim in flight.

The multi-device tiling and gather of the JAX package (a layer split
across a stage's devices and all-gathered over ICI) waits for the fabric
slice: a device list longer than one raises.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import hostmem, intervals, trace
from ..utils.device import resolve_device
from .mover import WeightMover


def _one_device(devices) -> torch.device:
    devs = [None] if devices is None else list(devices)
    if len(devs) != 1:
        raise NotImplementedError(
            f"ingest onto {len(devs)} devices needs the multi-device gather, "
            f"which waits for the fabric slice (ROADMAP, port Queue 1 item 6)")
    return resolve_device(devs[0])


def ingest_bytes(data, devices: Optional[Sequence] = None,
                 mover: Optional[WeightMover] = None) -> torch.Tensor:
    """One-shot ingest of a whole host buffer: a 1-D uint8 tensor on the
    device (None = the CUDA card).  On the CPU: one copy into an aligned
    buffer, adopted zero-copy."""
    dev = _one_device(devices)
    if dev.type == "cpu":
        view = np.frombuffer(memoryview(data), dtype=np.uint8)
        buf = hostmem.aligned_empty(view.shape[0])
        hostmem.copy_into(buf, 0, view)
        return hostmem.adopt_as_device_array(buf, dev)
    return (mover if mover is not None else WeightMover(dev)).to_device(data)


class ShardedLayerIngest:
    """Incremental device ingest of one layer (module docstring).
    Thread-safe: the receiver's handler pool may deliver fragments
    concurrently."""

    def __init__(self, total_bytes: int, devices: Optional[Sequence] = None,
                 stream: Optional[bool] = None,
                 mover: Optional[WeightMover] = None):
        """``devices``: a one-element list (None = the CUDA card).
        ``stream`` overrides the platform split (None): True forces the
        device-tensor arm, which tests run on the CPU.  ``mover`` shares a
        pinned-chunk ring across ingests (default: one of its own)."""
        if total_bytes <= 0:
            raise ValueError("empty layer")
        self.total = total_bytes
        self.device = _one_device(devices)
        if stream is None:
            stream = self.device.type != "cpu"
        self._cpu = not stream
        self._lock = threading.Lock()
        self._complete = threading.Condition(self._lock)
        self._cov = intervals.ClaimedCoverage()
        self._failed = False
        self._closed = False  # finalize/salvage ran: late writes no-op
        self._host: Optional[List[np.ndarray]] = None
        self._dev: Optional[torch.Tensor] = None
        self._mover: Optional[WeightMover] = None
        if self._cpu:
            self._host = [hostmem.aligned_empty(total_bytes)]
        else:
            self._mover = mover if mover is not None else WeightMover(
                self.device)
            self._dev = torch.empty(total_bytes, dtype=torch.uint8,
                                    device=self.device)
            self._mover.order_after_current()

    def share_host_buffer(self, buf) -> bool:
        """Adopt the caller's reassembly buffer as this ingest's span
        buffer -- the zero-copy CPU arm (the caller's own writes ARE the
        ingest and it reports them via :meth:`mark`).  Only on the CPU arm,
        with an adoptable buffer of the layer's size, before any coverage
        landed.  Idempotent for the same buffer."""
        if not self._cpu:
            return False
        with self._lock:
            if self._closed or self._failed:
                return False
            if self._host is not None and self._host[0] is buf:
                return True
            if self._cov.committed() or not self._cov.idle():
                return False
            if not (isinstance(buf, np.ndarray) and hostmem.is_adoptable(buf)
                    and buf.nbytes == self.total):
                return False
            self._host = [buf]
            return True

    def mark(self, offset: int, end: int) -> None:
        """Record externally written coverage (shared-buffer mode)."""
        with self._lock:
            if self._closed:
                return
            tok, _ = self._cov.claim(offset, end)
            if tok is not None:
                self._cov.commit(tok)
            if self._cov.idle():
                self._complete.notify_all()

    def write(self, offset: int, data) -> None:
        """Land ``data`` (a host buffer, or a 1-D uint8 tensor already on
        some device) at absolute byte ``offset``."""
        is_tensor = isinstance(data, torch.Tensor)
        if is_tensor:
            if data.dim() != 1 or data.dtype != torch.uint8:
                raise ValueError("device fragments must be 1-D uint8")
            length = data.shape[0]
        else:
            data = np.frombuffer(memoryview(data), dtype=np.uint8)
            length = data.shape[0]
        end = offset + length
        if offset < 0 or end > self.total:
            raise ValueError(
                f"fragment [{offset}, {end}) outside layer of {self.total} bytes")
        with self._lock:
            if self._closed:
                return  # a late duplicate racing finalize: already covered
            tok, claims = self._cov.claim(offset, end)
            if tok is None:
                return  # full duplicate -- idempotent
        try:
            for lo, hi in claims:
                piece = data[lo - offset : hi - offset]
                if self._cpu:
                    if is_tensor:
                        piece = piece.cpu().numpy()
                    # Claimed ranges are exclusive: concurrent writers
                    # memcpy into disjoint slices, lock-free.
                    hostmem.copy_into(self._host[0], lo, piece)
                elif is_tensor:
                    self._mover.copy_device(self._dev[lo:hi], piece)
                else:
                    self._mover.copy_to(self._dev[lo:hi], piece)
        except Exception:
            with self._lock:
                # Roll the claim back (its bytes never landed -- salvage
                # must not report them) and poison the ingest.
                self._cov.abort(tok)
                self._failed = True
                self._complete.notify_all()
            raise
        with self._lock:
            self._cov.commit(tok)
            if self._cov.idle():
                self._complete.notify_all()

    def _quiesce(self, timeout: float = 30.0) -> None:
        """Wait until no write claim is in flight (test hook)."""
        with self._lock:
            self._complete.wait_for(self._cov.idle, timeout=timeout)

    def fail(self) -> None:
        """Mark the ingest broken; wakes any ``finalize`` waiter, which
        then raises so the caller falls back to bulk staging."""
        with self._lock:
            self._failed = True
            self._complete.notify_all()

    def salvage(self) -> List[Tuple[int, bytes]]:
        """The committed byte ranges, read back out of the buffer -- the
        escape hatch when the ingest fails part-way.  Closes the ingest."""
        with self._lock:
            self._complete.wait_for(self._cov.idle, timeout=30.0)
            self._closed = True
            covered = self._cov.committed()
        if self._cpu:
            return [(s, self._host[0][s:e].tobytes()) for s, e in covered]
        self._mover.synchronize()
        return [(s, self._dev[s:e].cpu().numpy().tobytes())
                for s, e in covered]

    def finalize(self, timeout: float = 120.0) -> torch.Tensor:
        """Block until coverage is complete and no write is in flight,
        close the ingest, and return the layer as a 1-D uint8 tensor on
        the device with every byte landed."""
        with trace.phase("splice"):
            with self._lock:
                self._complete.wait_for(
                    lambda: self._failed or self._cov.complete(self.total),
                    timeout=timeout)
                self._closed = True  # any write from here on is a no-op
                if self._failed:
                    raise RuntimeError(
                        "ingest failed; fall back to bulk staging")
                if not self._cov.complete(self.total):
                    landed = intervals.covered(self._cov.committed())
                    raise RuntimeError(
                        f"ingest incomplete after {timeout}s: "
                        f"{landed}/{self.total} bytes landed")
            if self._cpu:
                # Zero-copy adoption: the aligned host buffer becomes the
                # layer's tensor; _closed guarantees no later writes.
                return hostmem.adopt_as_device_array(self._host[0],
                                                     self.device)
            self._mover.synchronize()
            return self._dev


def finalize_many(ingests: Sequence[ShardedLayerIngest],
                  timeout: float = 120.0) -> List[torch.Tensor]:
    """Finalize a batch of same-device ingests, in order.  (The JAX
    package batches their multi-device gathers into one collective; on
    one device there is no gather to batch.)"""
    for ing in ingests[1:]:
        if ing.device != ingests[0].device:
            raise ValueError("batched ingests must share their device")
    return [ing.finalize(timeout) for ing in ingests]


def hbm_headroom_bytes(device=None) -> Optional[int]:
    """What this process can still allocate on the CUDA ``device`` (None
    = the CUDA card), or ``None`` for the CPU, which reports no device
    memory.  The card's free bytes plus the blocks torch's caching
    allocator holds reserved but unused: ``mem_get_info`` counts those
    as used, and the JAX package's ``bytes_limit - bytes_in_use`` does
    not."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free) + max(0, int(cached))
