"""Incremental layer ingest: fragments land on the device as they arrive.

Port of the JAX package's ``parallel/ingest.py``.  A layer's fragments
arrive in any order, possibly concurrently and duplicated;
``ShardedLayerIngest`` lands each one at its byte offset and ``finalize``
hands back the whole layer once coverage is complete.

The layer's byte range is tiled across the stage's slots (one span per
slot, the shape of a mode-3 flow plan); each fragment is cut against the
tiling and every piece lands in its span's buffer.  With several slots,
``finalize`` gathers the spans (``collectives.gather_tiles``, pads
bucketed by ``plan_cache.bucket_pad``) into the full layer held by every
slot of the stage, a ``collectives.SlotTensor``; with one slot the span
buffer IS the layer.  Two arms, split by platform as in the JAX package:

- **CUDA (stream)**: each span is a preallocated ``torch.uint8`` device
  tensor; host bytes go host->device through a ``WeightMover``'s pinned
  chunks on its side stream (the DMA of fragment k overlaps the arrival
  of fragment k+1), and device fragments (the fabric's contributions)
  are device-to-device copies on that stream.  PCIe carries the layer's
  bytes exactly once.
- **CPU (host-accumulate)**: fragments are memcpy'd into 64-byte aligned
  host buffers and ``finalize`` adopts them zero-copy as tensors
  (``utils.hostmem``).

Both keep the JAX package's claim/commit discipline
(``utils.intervals.ClaimedCoverage``): ``write`` claims its uncovered
ranges under the lock before moving bytes (overlapping duplicates never
copy twice, concurrent writers never land the same range), a failed
write rolls its claim back, and ``finalize`` waits for full coverage with
no claim in flight.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.reassembly import split_offsets
from ..sched.flow import FlowJob
from ..utils import hostmem, intervals, trace
from ..utils.device import resolve_device
from .collectives import (SlotArray, SlotTensor, gather_tiles,
                          gather_tiles_batched)
from .mesh import DeviceMesh, Slot, make_mesh
from .mover import WeightMover
from .plan import execute_flow_plan
from .plan_cache import bucket_pad


def flat_mesh(devices: Sequence, axis: str = "ingest") -> DeviceMesh:
    """A 1-axis mesh over an explicit slot (or device) list: a stage's
    slots."""
    return make_mesh((len(devices),), (axis,), list(devices))


def synthesize_jobs(total_bytes: int, n: int,
                    layer_id: int = 0) -> List[FlowJob]:
    """An even byte-range tiling of a layer as FlowJobs -- the shape a
    mode-3 plan has, for stages where the real per-seeder split is not
    available."""
    return [
        FlowJob(sender_id=r, layer_id=layer_id, dest_id=0,
                data_size=size, offset=off)
        for r, (off, size) in enumerate(split_offsets(total_bytes, n))
        if size > 0
    ]


def _targets(devices) -> List:
    """The slots (or the one device, None = the CUDA card) an ingest
    lands on, each resolved so a missing card raises here."""
    devs = [None] if devices is None else list(devices)
    if not devs:
        raise ValueError("no devices to ingest onto")
    for d in devs:
        resolve_device(d)
    return devs


def _tagged(t: torch.Tensor, targets) -> torch.Tensor:
    """A one-slot result carries its slot, as a multi-slot gather does."""
    return SlotTensor(t, targets) if isinstance(targets[0], Slot) else t


def ingest_bytes(data, devices: Optional[Sequence] = None,
                 mover: Optional[WeightMover] = None) -> torch.Tensor:
    """One-shot ingest of a whole host buffer onto ``devices`` (slots or
    one device; None = the CUDA card): a 1-D uint8 tensor held by every
    one of them.  Several slots: split across them and gathered
    (``plan.execute_flow_plan``).  One CPU device: one copy into an
    aligned buffer, adopted zero-copy."""
    targets = _targets(devices)
    if len(targets) > 1:
        view = memoryview(data).cast("B")
        mesh = flat_mesh(targets)
        if len(view) < len(targets):
            from .collectives import replicate

            return replicate(np.frombuffer(view, np.uint8).copy(), mesh)
        jobs = synthesize_jobs(len(view), len(targets))
        frags = [bytes(view[j.offset : j.offset + j.data_size])
                 for j in jobs]
        return execute_flow_plan(jobs, frags, mesh, "ingest")
    dev = resolve_device(targets[0])
    if dev.type == "cpu":
        view = np.frombuffer(memoryview(data), dtype=np.uint8)
        buf = hostmem.aligned_empty(view.shape[0])
        hostmem.copy_into(buf, 0, view)
        return _tagged(hostmem.adopt_as_device_array(buf, dev), targets)
    mv = mover if mover is not None and mover.device == dev \
        else WeightMover(dev)
    return _tagged(mv.to_device(data), targets)


class ShardedLayerIngest:
    """Incremental device ingest of one layer onto a stage's slots
    (module docstring).  Thread-safe: the receiver's handler pool may
    deliver fragments concurrently."""

    def __init__(self, total_bytes: int, devices: Optional[Sequence] = None,
                 stream: Optional[bool] = None,
                 mover: Optional[WeightMover] = None):
        """``devices``: the stage's slots, or a one-element device list
        (None = the CUDA card).  ``stream`` overrides the platform split
        (None): True forces the device-tensor arm, which tests run on the
        CPU.  ``mover`` shares a pinned-chunk ring across ingests on its
        device (default: one of each device's own)."""
        if total_bytes <= 0:
            raise ValueError("empty layer")
        self.total = total_bytes
        self.targets = _targets(devices)
        self.devices = [resolve_device(d) for d in self.targets]
        self.device = self.devices[0]
        n = len(self.targets)
        # One span per slot; spans differ by <=1 byte and the buffers are
        # padded to the (bucketed) largest, so the gather is one program.
        # One slot needs no gather: its buffer stays exactly total-sized
        # (zero-copy adoption depends on it).
        self.spans: List[Tuple[int, int]] = list(split_offsets(total_bytes,
                                                               n))
        self.pad = max(size for _, size in self.spans)
        self.gpad = bucket_pad(self.pad) if n > 1 else self.pad
        if stream is None:
            stream = any(d.type != "cpu" for d in self.devices)
        self._cpu = not stream
        self._lock = threading.Lock()
        self._complete = threading.Condition(self._lock)
        self._cov = intervals.ClaimedCoverage()
        self._failed = False
        self._closed = False  # finalize/salvage ran: late writes no-op
        self._movers: Dict[torch.device, WeightMover] = {}
        if self._cpu:
            self._bufs = [hostmem.aligned_empty(self.gpad) for _ in range(n)]
        else:
            for d in self.devices:
                if d not in self._movers:
                    self._movers[d] = (mover if mover is not None
                                       and mover.device == d
                                       else WeightMover(d))
            self._bufs = [torch.empty(self.gpad, dtype=torch.uint8, device=d)
                          for d in self.devices]
            for m in self._movers.values():
                m.order_after_current()
        # The first slot's mover (the only one on one device).
        self._mover = self._movers.get(self.device)

    def share_host_buffer(self, buf) -> bool:
        """Adopt the caller's reassembly buffer as this ingest's span
        buffer -- the zero-copy CPU arm (the caller's own writes ARE the
        ingest and it reports them via :meth:`mark`).  Only on the CPU arm
        with one span, with an adoptable buffer of the layer's size,
        before any coverage landed.  Idempotent for the same buffer."""
        if not self._cpu or len(self.spans) != 1:
            return False
        with self._lock:
            if self._closed or self._failed:
                return False
            if self._bufs[0] is buf:
                return True
            if self._cov.committed() or not self._cov.idle():
                return False
            if not (isinstance(buf, np.ndarray) and hostmem.is_adoptable(buf)
                    and buf.nbytes == self.total):
                return False
            self._bufs = [buf]
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
        some device -- a fabric contribution) at absolute byte
        ``offset``."""
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
            if self._closed or self._failed:
                # A late duplicate racing finalize (already covered), or
                # a write into a poisoned ingest nobody will read.
                return
            tok, claims = self._cov.claim(offset, end)
            if tok is None:
                return  # full duplicate -- idempotent
        try:
            for lo, hi in claims:
                for r, (s_off, s_size) in enumerate(self.spans):
                    a, b = max(lo, s_off), min(hi, s_off + s_size)
                    if a >= b:
                        continue
                    piece = data[a - offset : b - offset]
                    dst = self._bufs[r]
                    if self._cpu:
                        if is_tensor:
                            piece = piece.cpu().numpy()
                        # Claimed ranges are exclusive: concurrent writers
                        # memcpy into disjoint slices, lock-free.
                        hostmem.copy_into(dst, a - s_off, piece)
                    elif is_tensor:
                        self._movers[self.devices[r]].copy_device(
                            dst[a - s_off : b - s_off], piece)
                    else:
                        self._movers[self.devices[r]].copy_to(
                            dst[a - s_off : b - s_off], piece)
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
        then raises so the caller falls back to bulk staging.  Later
        writes are no-ops, so a demoted layer's stragglers queue no more
        copies into buffers nobody reads."""
        with self._lock:
            self._failed = True
            self._complete.notify_all()

    def _sync(self) -> None:
        for m in self._movers.values():
            m.synchronize()

    def salvage(self) -> List[Tuple[int, bytes]]:
        """The committed byte ranges, read back out of the span buffers --
        the escape hatch when the ingest fails part-way.  Closes the
        ingest."""
        with self._lock:
            self._complete.wait_for(self._cov.idle, timeout=30.0)
            self._closed = True
            covered = self._cov.committed()
        self._sync()
        out: List[Tuple[int, bytes]] = []
        for s, e in covered:
            for r, (s_off, s_size) in enumerate(self.spans):
                lo, hi = max(s, s_off), min(e, s_off + s_size)
                if lo >= hi:
                    continue
                piece = self._bufs[r][lo - s_off : hi - s_off]
                if not self._cpu:
                    piece = piece.cpu().numpy()
                out.append((lo, piece.tobytes()))
        return out

    def _span_buffers(self, timeout: float = 120.0) -> List[torch.Tensor]:
        """Block until coverage is complete and no write is in flight,
        close the ingest, and return one span buffer per slot with every
        byte landed.  The shared head of ``finalize`` and
        ``finalize_many``."""
        with self._lock:
            self._complete.wait_for(
                lambda: self._failed or self._cov.complete(self.total),
                timeout=timeout)
            self._closed = True  # any write from here on is a no-op
            if self._failed:
                raise RuntimeError("ingest failed; fall back to bulk staging")
            if not self._cov.complete(self.total):
                landed = intervals.covered(self._cov.committed())
                raise RuntimeError(
                    f"ingest incomplete after {timeout}s: "
                    f"{landed}/{self.total} bytes landed")
        if self._cpu:
            # Zero-copy adoption: the aligned host buffers become the
            # tensors; _closed guarantees no later writes.
            return [hostmem.adopt_as_device_array(b, torch.device("cpu"))
                    for b in self._bufs]
        self._sync()
        return list(self._bufs)

    def finalize(self, timeout: float = 120.0) -> torch.Tensor:
        """The whole layer as a 1-D uint8 tensor held by every slot of the
        stage (a ``SlotTensor`` when the ingest was given slots): blocks
        until coverage is complete, then (several slots) gathers the
        spans."""
        with trace.phase("splice"):
            bufs = self._span_buffers(timeout)
        if len(bufs) == 1:
            return _tagged(bufs[0], self.targets)
        mesh = flat_mesh(self.targets)
        sizes = tuple(size for _, size in self.spans)
        return gather_tiles(mesh, "ingest", sizes, pad=self.gpad)(
            SlotArray(mesh, "ingest", bufs))


def finalize_many(ingests: Sequence[ShardedLayerIngest],
                  timeout: float = 120.0) -> List[torch.Tensor]:
    """Plan batching at the terminal hop: K same-tiling ingests finish as
    ONE batched gather.  All ingests must share their slots and span
    tiling (equal-size layers); each slot concatenates its K span buffers
    and one gather replicates every layer.  Returns one layer per ingest,
    in order; raises if any ingest failed or the tilings differ (the
    caller then finalizes per plan)."""
    if not ingests:
        return []
    first = ingests[0]
    if len(ingests) == 1:
        return [first.finalize(timeout)]
    n = len(first.targets)
    if n == 1:
        # No gather to batch: each finalize is already gather-free.
        if any(ing.targets != first.targets for ing in ingests):
            raise ValueError("batched ingests must share their device")
        return [ing.finalize(timeout) for ing in ingests]
    for ing in ingests[1:]:
        if (ing.targets != first.targets or ing.spans != first.spans
                or ing._cpu != first._cpu or ing.gpad != first.gpad):
            raise ValueError("batched ingests must share device tiling")
    k = len(ingests)
    with trace.phase("splice"):
        per_ingest = [ing._span_buffers(timeout) for ing in ingests]
        shards = [torch.cat([per_ingest[i][r] for i in range(k)])
                  for r in range(n)]
    mesh = flat_mesh(first.targets)
    sizes = tuple(size for _, size in first.spans)
    out = gather_tiles_batched(mesh, "ingest", sizes, tuple(range(n)), k,
                               pad=first.gpad)(SlotArray(mesh, "ingest",
                                                         shards))
    slots = out.slots
    return [SlotTensor(out[i], slots,
                       {d: rep[i] for d, rep in out._replicas.items()})
            for i in range(k)]


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
