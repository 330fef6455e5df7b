"""Per-layer receive-to-device streaming boot staging.

Port of the JAX package's ``runtime/stream_boot.py``.
``StreamingBootStager`` accepts each blob the moment its bytes are
complete (mid-wire for every blob but the last) and runs that blob's
share of the boot on one worker thread, ``boot.stage_blob_leaves``:

- **device path**: a blob already on the CUDA device becomes dtype views
  of its bytes -- no copy, no kernel;
- **host path**: the blob is decoded on the host and each leaf copied to
  the device, so the copy of layer k rides under the receive of k+1.

``boot_from_layers`` then assembles the staged leaves with one
device-local concat per leaf -- bit-identical to the bulk assembly in
any completion order, since each blob stages independently and the
concat is in layer-id order.  Leaves carry a leading length-1 axis.

The shard-gather half of the JAX stager (``submit_shard``,
``collect_gathered``) waits for the sharding slice.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Optional

from ..models import serde
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.logging import log
from .boot import stage_blob_leaves, verify_blob_digest

# Phase buckets (utils.trace): summed per-blob staging seconds, and the
# subset that ran while the wire was still active (before startup).
PHASE_STREAM_STAGE = "boot_stream_stage"
PHASE_STREAM_IN_WIRE = "boot_stream_in_wire"


class StreamingBootStager:
    """Stage completed blobs concurrently with the receive.

    ``submit`` is called from receiver handler threads (idempotent per
    blob) and enqueues; ONE worker thread drains the queue.  ``collect``
    blocks until every submitted blob is processed and returns the staged
    leaves.  Failures are per-blob and non-fatal: a blob that fails to
    stage is absent from ``collect`` and the boot infills it."""

    def __init__(self, cfg, codec: str = "raw", device=None, node_id=None,
                 digest_lookup=None, digest_verified=None):
        """``device``: where host-path leaves land (None = the CUDA
        card).  ``digest_lookup``/``digest_verified``: a ``blob_id ->
        expected digest (or None)`` callable and the already-verified id
        set; each blob with host bytes re-verifies before its decode
        unless the set already holds it."""
        self.cfg = cfg
        self.codec = codec
        self.device = resolve_device(device)
        self.node_id = node_id
        self.digest_lookup = digest_lookup
        self.digest_verified = digest_verified
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._staged: Dict[int, dict] = {}
        self._submitted: set = set()
        self._pending = 0
        self._closed = False
        self._startup_seen = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- intake

    def submit(self, blob_id: int, src) -> bool:
        """Queue a completed blob for staging; False for duplicates,
        closed stagers, or ids the boot can never use."""
        if self.cfg is None or blob_id > serde.head_blob_id(self.cfg):
            return False
        with self._lock:
            if self._closed or blob_id in self._submitted:
                return False
            self._submitted.add(blob_id)
            self._pending += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"boot-stream-{self.node_id}")
                self._thread.start()
            # Enqueue inside the lock: a racing close() must not slot its
            # sentinel ahead of this item.
            self._q.put((blob_id, src))
        return True

    def invalidate(self, blob_id: int) -> None:
        """Forget a blob whose bytes turned out corrupt after submission:
        drops the staged leaves and the dedup marker so a redelivered copy
        re-stages; a stage in flight for the bad bytes is discarded."""
        with self._lock:
            self._submitted.discard(blob_id)
            self._staged.pop(blob_id, None)

    def mark_startup(self) -> None:
        """Startup arrived: blobs staged from here on no longer overlap
        the wire (accounting only)."""
        with self._lock:
            self._startup_seen = True

    @property
    def staged_count(self) -> int:
        with self._lock:
            return len(self._staged)

    # ------------------------------------------------------------ consume

    def collect(self, blob_ids, timeout: float = 300.0) -> Dict[int, dict]:
        """Wait for all in-flight staging, then return {blob_id: leaves}
        for the requested ids that staged successfully."""
        with self._lock:
            self._done.wait_for(lambda: self._pending == 0, timeout=timeout)
            if self._pending:
                log.warn("streamed staging still in flight at collect; "
                         "boot falls back to bulk assembly",
                         pending=self._pending)
                return {}
            return {b: self._staged[b] for b in blob_ids
                    if b in self._staged}

    def close(self) -> None:
        """Stop the worker after the queued blobs (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._thread is not None
        if started:
            self._q.put(None)

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            blob_id, src = item
            leaves = None
            t0 = time.monotonic()
            try:
                leaves = self._stage_one(blob_id, src)
            except Exception as e:  # noqa: BLE001 -- the boot infills it
                log.warn("streamed boot staging failed for blob; the boot "
                         "will infill it", blobID=blob_id, err=repr(e))
            dt = time.monotonic() - t0
            with self._lock:
                if leaves is not None and blob_id not in self._submitted:
                    log.warn("discarding staged leaves for invalidated "
                             "blob", blobID=blob_id)
                    leaves = None
                if leaves is not None:
                    self._staged[blob_id] = leaves
                in_wire = not self._startup_seen
                self._pending -= 1
                if self._pending == 0:
                    self._done.notify_all()
            if leaves is not None:
                trace.add_phase(PHASE_STREAM_STAGE, dt)
                if in_wire:
                    trace.add_phase(PHASE_STREAM_IN_WIRE, dt)
                log.info("layer boot-staged (streamed)", blobID=blob_id,
                         stage_ms=round(dt * 1000, 1), in_wire=in_wire)

    def _stage_one(self, blob_id: int, src) -> dict:
        """One blob's staging -- ``boot.stage_blob_leaves`` verbatim, under
        the blob's own wire codec when it names one."""
        verify_blob_digest(blob_id, src, self.digest_lookup,
                           self.digest_verified)
        codec = src.meta.codec or self.codec
        return stage_blob_leaves(self.cfg, blob_id, src, codec=codec,
                                 device=self.device)
