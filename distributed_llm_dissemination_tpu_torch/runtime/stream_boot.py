"""Per-layer receive-to-device streaming boot staging.

Port of the JAX package's ``runtime/stream_boot.py``.
``StreamingBootStager`` accepts each blob the moment its bytes are
complete (mid-wire for every blob but the last) and runs that blob's
share of the boot on one worker thread, ``boot.stage_blob_leaves``:

- **device path**: a blob already on the CUDA device becomes dtype views
  of its bytes -- no copy, no kernel;
- **host path**: the blob is decoded on the host and each leaf copied to
  the device, so the copy of layer k rides under the receive of k+1.

``boot_from_layers`` then takes the staged leaves as its per-layer params,
in layer-id order, with no copy -- bit-identical to the bulk assembly in
any completion order, since each blob stages independently.  Leaves carry
a leading length-1 axis; ``staged_in_place`` says whether a blob's leaves
view its landed bytes.

The shard-gather half: ``submit_shard`` accepts one byte-range shard of
a layer at a time, and when a layer's last shard arrives the worker
gathers the full layer over device slots
(``parallel.collectives.gather_byte_shards``), decoding it on the device
in the same pass when the stager boots a model; ``collect_gathered``
returns the materialized wire bytes.
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
from .boot import (device_blob, stage_blob_leaves, verify_blob_digest,
                   views_blob)

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
                 digest_lookup=None, digest_verified=None, placement=None):
        """``device``: where host-path leaves land (None = the CUDA card,
        or ``node_id``'s stage slot when ``placement`` maps it).
        ``placement``: a ``parallel.mesh.StagePlacement``; its mesh's slots
        are the shard gathers' slots.  ``digest_lookup``/
        ``digest_verified``: a ``blob_id -> expected digest (or None)``
        callable and the already-verified id set; each blob with host
        bytes re-verifies before its decode unless the set already holds
        it."""
        self.cfg = cfg
        self.codec = codec
        self.placement = placement
        if (device is None and placement is not None
                and node_id in placement.node_to_stage):
            device = placement.devices_for_node(node_id)[0]
        self.device = resolve_device(device)
        self.node_id = node_id
        self.digest_lookup = digest_lookup
        self.digest_verified = digest_verified
        # Pod-delivery hook: called from the worker after every shard
        # gather with ``(blob_id, full_wire_bytes_or_None, codec)``.
        self.on_gathered = None
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._staged: Dict[int, dict] = {}
        self._in_place: Dict[int, bool] = {}  # staged as views of the blob
        # Shard-gather state: blob -> accumulated shard parts, and blob ->
        # the materialized full layer's wire bytes.
        self._shards: Dict[int, dict] = {}
        self._gathered: Dict[int, bytes] = {}
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
            self._in_place.pop(blob_id, None)

    def mark_startup(self) -> None:
        """Startup arrived: blobs staged from here on no longer overlap
        the wire (accounting only)."""
        with self._lock:
            self._startup_seen = True

    def staged_in_place(self, blob_id: int) -> bool:
        """Whether the staged leaves of ``blob_id`` are views of its
        landed device bytes (False for copies, and for unstaged ids)."""
        with self._lock:
            return self._in_place.get(blob_id, False)

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
            if item[0] == "gather":
                self._gather_one(item[1])
                continue
            blob_id, src = item
            leaves, in_place = None, False
            t0 = time.monotonic()
            try:
                leaves, in_place = self._stage_one(blob_id, src)
            except Exception as e:  # noqa: BLE001 -- the boot infills it
                trace.count("fallback.stream_stage_infill")
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
                    self._in_place[blob_id] = in_place
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

    def submit_shard(self, blob_id: int, spec: str, data, total: int,
                     expected_digest: str = "", codec: str = "") -> bool:
        """Feed one completed SHARD (``spec`` = ``1/N@K``) of a layer to
        the shard gather, in ANY completion order across shards.  False
        for duplicates and closed stagers.  When the layer's last shard
        arrives, the worker gathers the full layer over device slots and
        the result becomes available via ``collect_gathered`` -- verified
        against ``expected_digest`` (the stamped full-layer digest) when
        one is known.  ``codec``: the WIRE form the shards slice ("" =
        canonical); ``total``, the specs' ranges and the digest then live
        in encoded byte space, and a booting stager decodes the gathered
        blob on the device."""
        from ..core.types import parse_shard_spec

        parsed = parse_shard_spec(spec)
        n, k = parsed if parsed is not None else (1, 0)
        with self._lock:
            if self._closed:
                return False
            rec = self._shards.setdefault(
                blob_id, {"n": n, "total": int(total), "parts": {},
                          "digest": "", "codec": codec, "queued": False})
            if rec["n"] != n or rec["total"] != int(total):
                log.error("conflicting shard geometry submitted",
                          blobID=blob_id, have_n=rec["n"], got_n=n)
                return False
            if k in rec["parts"]:
                return False
            rec["parts"][k] = bytes(data)
            if expected_digest:
                rec["digest"] = expected_digest
            if codec:
                rec["codec"] = codec
            if len(rec["parts"]) < n or rec["queued"]:
                return True
            rec["queued"] = True
            self._pending += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name=f"boot-stream-{self.node_id}")
                self._thread.start()
            self._q.put(("gather", blob_id))
        return True

    def collect_gathered(self, blob_ids, timeout: float = 300.0
                         ) -> Dict[int, bytes]:
        """Wait for in-flight gathers, then return {blob_id: full layer
        bytes} for the requested ids whose shard sets materialized."""
        with self._lock:
            self._done.wait_for(lambda: self._pending == 0, timeout=timeout)
            if self._pending:
                log.warn("shard gathers still in flight at collect",
                         pending=self._pending)
                return {}
            return {b: self._gathered[b] for b in blob_ids
                    if b in self._gathered}

    def _gather_devices(self, n: int):
        """The slots a shard gather may use: the placement's whole mesh,
        else one slot per shard on the stager's device."""
        if self.placement is not None:
            return self.placement.mesh.slots
        from ..parallel.mesh import device_slots

        return device_slots(n, self.device)

    def _gather_one(self, blob_id: int) -> None:
        from ..parallel.collectives import gather_byte_shards

        t0 = time.monotonic()
        with self._lock:
            rec = self._shards.get(blob_id)
            if rec is None:
                parts, total, digest, codec = None, 0, "", ""
            else:
                parts = sorted(rec["parts"].items())
                total, digest = rec["total"], rec["digest"]
                codec = rec.get("codec", "")
        out, leaves = None, None
        if parts is not None:
            # A booting stager decodes the gathered blob in the same pass
            # (on the device when the gather ran over slots).
            decode = None
            if self.cfg is not None and blob_id <= serde.head_blob_id(
                    self.cfg):
                decode = (self.cfg, blob_id)
            try:
                got = gather_byte_shards(
                    parts, total, verify_digest=digest or None, codec=codec,
                    decode=decode, devices=self._gather_devices(len(parts)))
                out, leaves = got if decode is not None else (got, None)
            except Exception as e:  # noqa: BLE001 -- loud, never wedge
                log.error("on-mesh shard gather failed", blobID=blob_id,
                          err=repr(e))
        dt = time.monotonic() - t0
        with self._lock:
            if out is not None and blob_id in self._shards:
                self._gathered[blob_id] = out
                if leaves is not None:
                    # Already staged by the gather's decode: a later full
                    # delivery's ``submit`` dedupes.
                    self._submitted.add(blob_id)
                    self._staged[blob_id] = leaves
            in_wire = not self._startup_seen
            self._pending -= 1
            if self._pending == 0:
                self._done.notify_all()
        if out is not None:
            trace.add_phase(PHASE_STREAM_STAGE, dt)
            if in_wire:
                trace.add_phase(PHASE_STREAM_IN_WIRE, dt)
            log.info("layer materialized from shards (on-mesh gather)",
                     blobID=blob_id, gather_ms=round(dt * 1000, 1),
                     in_wire=in_wire, bytes=len(out),
                     codec=codec or None, digest_verified=bool(digest))
        hook = self.on_gathered
        if hook is not None:
            try:
                hook(blob_id, out, codec)
            except Exception as e:  # noqa: BLE001 -- the hook must not
                log.error("on_gathered hook failed", blobID=blob_id,
                          err=repr(e))  # kill the worker
        if out is None:
            trace.count("shard.gather_failed")

    def _stage_one(self, blob_id: int, src) -> tuple:
        """One blob's staging -- ``boot.stage_blob_leaves`` verbatim, under
        the blob's own wire codec when it names one: ``(leaves, whether
        they view the landed blob)``."""
        verify_blob_digest(blob_id, src, self.digest_lookup,
                           self.digest_verified)
        codec = src.meta.codec or self.codec
        blob = device_blob(src)  # before staging may release it
        leaves = stage_blob_leaves(self.cfg, blob_id, src, codec=codec,
                                   device=self.device)
        return leaves, views_blob(leaves, blob)
