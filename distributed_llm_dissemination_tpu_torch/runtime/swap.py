"""Zero-downtime weight swap: stage v2 while v1 serves, flip atomically
(docs/swap.md).

A weight update used to mean stop-serving → re-disseminate → re-boot —
exactly the downtime a fleet serving live traffic cannot afford.  This
module is the RECEIVER half of the live-swap subsystem: the v2 bytes
ride the existing data plane as a ``kind="swap"`` job (version-tagged
holdings/acks, ``sched/jobs.py`` + ``runtime/leader.py`` own the
leader half), and :class:`SwapController` turns them into a serving
flip with three invariants:

1. **v1 never stops.** Staging runs on a daemon worker concurrent with
   the serving path; the flip itself is one attribute swap under the
   receiver's serve gate — in-flight decodes finish on the v1 params
   they captured, new requests read v2.  No request is ever dropped.
2. **v2 never aliases v1.** v2 blobs arrive under their own layer ids
   (``swap_base + slot``) into the ordinary layer store — staging
   decodes them into SEPARATE buffers; the serving params are replaced,
   never mutated.  The version guard
   (:func:`~..models.generate.ensure_uniform_version`) refuses to
   assemble a serving tree from blobs with mismatched version tags, so
   a forward can never run across mixed versions.
3. **Unhappy paths keep v1.** A digest mismatch that exhausts its retry
   budget reports the failure to the leader (which aborts the swap
   cluster-wide); an abort releases the staged v2 set and leaves v1
   serving untouched; a node that staged everything but never saw the
   commit fence re-requests it (``SwapCommitMsg(query=True)``) on a
   bounded timer instead of serving a stale version forever.

HBM headroom policy: each v2 blob's decoded leaves stage into device
memory only when ``parallel.ingest.hbm_headroom_bytes`` reports
comfortable headroom at that moment (``HEADROOM_FACTOR`` × the blob's
bytes); otherwise the leaves stay in host RAM and pay their device_put
at flip time — a bounded tokens/s dip instead of an OOM'd serving
process.  ``None`` (platform reports no stats — notably the CPU
backend, where device memory IS host memory) stages to device.

Copy of the JAX package's ``runtime/swap.py``; staged leaves are torch
tensors on the receiver's device (``ReceiverNode.device``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

from ..utils import telemetry, trace
from ..utils.logging import log

# States of one tracked version at this node.
STAGING = "staging"      # prepare seen; v2 layers accumulating
PREPARED = "prepared"    # full set verified; params built, flip-ready
COMMITTED = "committed"  # flip applied; this version is serving
ABORTED = "aborted"      # rollout failed; staged set released
REVERTED = "reverted"    # flipped, then rolled BACK (SLO breach)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class SwapController:
    """Per-receiver live-swap state machine (docs/swap.md).

    Thread model: ``on_commit``/``on_layer`` are called from receiver
    handler threads and only mutate the tracked-version table under the
    controller lock; the expensive work — per-blob decode + staging,
    and the flip's wait-for-prepare — runs on dedicated daemon threads
    so the handler pool (and the serving path) never blocks behind a
    multi-second decode."""

    # Device staging wants this × blob bytes of free HBM; below it the
    # blob's decoded leaves stay host-resident until the flip.
    HEADROOM_FACTOR = 2.0
    # How long a PREPARED node waits for the commit fence before
    # re-requesting it, and how many re-requests before going quiet
    # (the leader's own commit watchdog re-sends from its side too).
    QUERY_RETRIES = 8
    # Bound on the flip's wait for an in-flight prepare.
    FLIP_WAIT_S = 300.0

    def __init__(self, receiver):
        self.r = receiver
        self._lock = threading.Lock()
        # version -> record: {"swap_base", "state", "per_slot", "head",
        # "host_slots", "params", "prepare_s", "event", "queries"}
        self._versions: Dict[str, dict] = {}
        self.query_interval = _env_float("DLD_SWAP_QUERY_S", 10.0)

    # ------------------------------------------------------------- intake

    def on_commit(self, msg) -> None:
        """Route one ``SwapCommitMsg`` from the leader.  Every outcome
        answers (the serving invariant): a flip or an abort confirms
        with ``applied=True``; an impossible commit reports ``error``
        so the leader aborts instead of re-sending forever."""
        if msg.finalize:
            # The rollback window is over (the wave's soak verdict
            # passed, or a plain swap's fleet flip completed): release
            # the retained pre-flip tree.  Advisory — no answer.
            self._finalize(msg.version)
            return
        if msg.abort:
            self._abort(msg.version, revert=msg.revert)
            self._answer(version=msg.version, applied=True)
            return
        with self._lock:
            rec = self._versions.get(msg.version)
            if rec is not None and rec["state"] in (ABORTED, REVERTED):
                # A retry rollout re-uses an aborted version name
                # (docs/swap.md): start over with a fresh record — the
                # released v2 set was re-announced away, so the retry
                # job redelivers it.
                log.warn("fresh fence for a previously aborted version; "
                         "re-tracking", version=msg.version)
                del self._versions[msg.version]
                rec = None
            if rec is None:
                if msg.swap_base < 0:
                    # Commit for a version this node never saw a prepare
                    # (or any v2 byte) for, and the fence carries no blob
                    # mapping: nothing stageable here.
                    self._answer(version=msg.version,
                                 error="unknown swap version at this node")
                    return
                rec = self._track_locked(msg.version, msg.swap_base)
            elif msg.swap_base >= 0 and rec["swap_base"] < 0:
                rec["swap_base"] = msg.swap_base
            if rec["state"] == COMMITTED:
                # Re-sent fence (our confirm was lost): re-confirm.
                self._answer(version=msg.version, applied=True)
                return
            already = rec.get("flip_pending", False)
            rec["flip_pending"] = True
        self._maybe_prepare(msg.version)
        if not already:
            threading.Thread(target=self._flip_when_ready,
                             args=(msg.version,), daemon=True,
                             name=f"swap-flip-{self.r.node.my_id}").start()

    def on_prepare(self, version: str, swap_base: int) -> None:
        """The leader announced a swap at admission: start tracking, so
        staging overlaps the rollout instead of serializing after it.
        A prepare for a previously ABORTED version is a retry rollout —
        re-track from scratch (docs/swap.md)."""
        with self._lock:
            rec = self._versions.get(version)
            if rec is not None and rec["state"] in (ABORTED, REVERTED):
                log.warn("prepare for a previously aborted version; "
                         "re-tracking for the retry", version=version)
                del self._versions[version]
                rec = None
            if rec is None:
                rec = self._track_locked(version, swap_base)
            elif swap_base >= 0 and rec["swap_base"] < 0:
                rec["swap_base"] = swap_base
        self._maybe_prepare(version)

    def on_layer(self, lid: int) -> None:
        """A layer completed + verified (any path: wire, content
        resolve, retransmit) — it may have completed a tracked
        version's v2 set."""
        version = self.r._layer_versions.get(lid)
        if not version:
            return
        self._maybe_prepare(version)

    def on_staging_failed(self, lid: int, reason: str) -> None:
        """A versioned layer is unrecoverable here (digest retry budget
        exhausted): the swap cannot complete on this replica — report
        to the leader, which aborts cluster-wide (rollback = keep
        serving v1)."""
        version = self.r._layer_versions.get(lid)
        if not version:
            return
        trace.count("swap.staging_failed")
        log.error("swap staging failed; reporting to leader for abort",
                  version=version, layerID=lid, reason=reason)
        self._answer(version=version,
                     error=f"layer {lid} unrecoverable: {reason}")

    # ------------------------------------------------------------ queries

    def state_of(self, version: str) -> Optional[str]:
        with self._lock:
            rec = self._versions.get(version)
            return rec["state"] if rec is not None else None

    # ----------------------------------------------------------- internal

    def _track_locked(self, version: str, swap_base: int) -> dict:
        rec = {
            "swap_base": int(swap_base),
            "state": STAGING,
            "per_slot": {},     # slot -> {name: leaf (np or jnp)}
            "host_slots": set(),  # slots staged host-side (headroom)
            "head": None,
            "params": None,     # fully assembled tree when all-device
            "prepare_s": 0.0,
            "prepare_started": False,
            "flip_pending": False,
            "event": threading.Event(),  # set at PREPARED (or terminal)
            "queries": 0,
            # The pre-flip serving state, retained from the flip until
            # the leader's FINALIZE fence: (boot_result, version,
            # tree-version map) — the rollback window of
            # docs/rollout.md.  None before the flip / after finalize.
            "prev": None,
        }
        self._versions[version] = rec
        log.info("tracking swap version", version=version,
                 swap_base=swap_base)
        return rec

    def _expected_ids(self, swap_base: int):
        from ..models import serde

        head = serde.head_blob_id(self.r.boot_cfg)
        return [swap_base + b for b in range(head + 1)]

    def _set_complete(self, swap_base: int) -> bool:
        """Whether every v2 blob is held AND digest-verified (a stamped
        digest must have passed the gate; unstamped layers verified by
        per-fragment CRC alone — the integrity plane's usual trust)."""
        r = self.r
        for lid in self._expected_ids(swap_base):
            with r._lock:
                src = r.layers.get(lid)
            if src is None:
                return False
            if src.meta.shard or src.meta.codec:
                # A shard slice or a still-ENCODED holding (codec form,
                # or a delta stream awaiting reconstruction) must never
                # enter the serving tree — the full canonical bytes
                # have to land first (docs/swap.md, docs/codec.md).
                return False
            if (r._expected_digest(lid) is not None
                    and lid not in r._digest_ok):
                return False
        return True

    def _maybe_prepare(self, version: str) -> None:
        with self._lock:
            rec = self._versions.get(version)
            if (rec is None or rec["state"] != STAGING
                    or rec["prepare_started"] or rec["swap_base"] < 0):
                return
            if not self._set_complete(rec["swap_base"]):
                return
            rec["prepare_started"] = True
        threading.Thread(target=self._prepare, args=(version,),
                         daemon=True,
                         name=f"swap-prepare-{self.r.node.my_id}").start()

    def _prepare(self, version: str) -> None:
        """Decode the full v2 set into flip-ready params on a worker
        thread, concurrent with v1 serving.  Per-blob headroom probe:
        roomy blobs decode straight onto device; tight ones stay host
        and pay their device_put at flip time."""
        t0 = time.monotonic()
        try:
            self._prepare_inner(version)
        except Exception as e:  # noqa: BLE001 — must report, never wedge
            log.error("swap prepare failed", version=version, err=repr(e))
            trace.count("swap.staging_failed")
            with self._lock:
                rec = self._versions.get(version)
                if rec is not None:
                    rec["prepare_started"] = False
                    rec["event"].set()  # release any flip waiter...
                    rec["event"] = threading.Event()  # ...then re-arm
            self._answer(version=version, error=f"prepare failed: {e!r}")
            return
        dt = time.monotonic() - t0
        with self._lock:
            rec = self._versions.get(version)
            if rec is None or rec["state"] != STAGING:
                return
            rec["state"] = PREPARED
            rec["prepare_s"] = dt
            rec["event"].set()
            n_host = len(rec["host_slots"])
            pending = rec["flip_pending"]
        trace.count("swap.prepared")
        log.info("swap version staged and flip-ready", version=version,
                 prepare_ms=round(dt * 1000, 1), host_staged_blobs=n_host)
        if not pending:
            # Staged but unfenced: arm the commit re-request timer — a
            # node that missed the fence must ask, not serve v1 forever
            # while the rest of the fleet moved to v2.
            self._arm_query(version)

    def _prepare_inner(self, version: str) -> None:
        from ..models import quant, serde
        from ..models.generate import ensure_uniform_version
        from ..parallel.ingest import hbm_headroom_bytes

        r = self.r
        cfg = r.boot_cfg
        with self._lock:
            rec = self._versions[version]
            swap_base = rec["swap_base"]
        head_id = serde.head_blob_id(cfg)
        ids = self._expected_ids(swap_base)
        # The mixed-version guard: every blob entering the serving tree
        # must carry THIS version's tag — a forward across layers of
        # two rollouts must be impossible by construction.
        ensure_uniform_version(
            {lid: r._layer_versions.get(lid, "") for lid in ids}, version)
        per_slot: Dict[int, dict] = {}
        head_leaves = None
        host_slots = set()
        for lid in ids:
            with r._lock:
                src = r.layers.get(lid)
            if src is None:
                raise RuntimeError(f"v2 blob {lid} vanished mid-prepare")
            data = (bytes(src.inmem_data) if src.inmem_data is not None
                    else src.read_bytes())
            slot = lid - swap_base
            leaves = quant.decode_blob_host(cfg, slot, data, r.boot_codec)
            # Probe against the DECODED leaf bytes, not the wire size:
            # a quantized blob decodes to several times its encoded
            # bytes, and sizing the check by the wire would OOM the
            # serving device — the exact failure this policy prevents.
            decoded = sum(getattr(v, "nbytes", len(data))
                          for v in leaves.values())
            headroom = hbm_headroom_bytes(r.device)
            tight = (headroom is not None
                     and headroom < decoded * self.HEADROOM_FACTOR)
            if tight:
                host_slots.add(slot)
                staged = dict(leaves)  # CPU tensors: the flip moves them
            else:
                staged = {k: v.to(r.device) for k, v in leaves.items()}
            if slot == head_id:
                head_leaves = staged
            else:
                per_slot[slot] = staged
        params = None
        if not host_slots:
            # Everything device-resident: assemble NOW so the flip is a
            # pure pointer swap (no device work between decode steps).
            params = self._assemble(per_slot, head_leaves)
        with self._lock:
            rec = self._versions.get(version)
            if rec is None or rec["state"] != STAGING:
                # An abort (or anything terminal) landed while this
                # prepare was decoding: storing the freshly decoded
                # leaves would re-pin the very memory the abort just
                # released — drop them instead (GC frees host + HBM).
                log.warn("discarding staged leaves for a no-longer-"
                         "staging version", version=version,
                         state=rec["state"] if rec else None)
                return
            rec["per_slot"] = per_slot
            rec["head"] = head_leaves
            rec["host_slots"] = host_slots
            rec["params"] = params

    def _assemble(self, per_slot: dict, head_leaves: dict):
        """The serving tree ``models.generate.generate`` consumes:
        stacked layer leaves [L, ...] + the head."""
        import torch

        dev = self.r.device
        n = self.r.boot_cfg.n_layers
        names = list(per_slot[0])
        layers = {name: torch.stack([per_slot[i][name].to(dev)
                                     for i in range(n)])
                  for name in names}
        return {"embed": head_leaves["embed"].to(dev),
                "layers": layers,
                "ln_f": head_leaves["ln_f"].to(dev),
                "lm_head": head_leaves["lm_head"].to(dev)}

    def _flip_when_ready(self, version: str) -> None:
        """The commit fence's flip half: wait (bounded) for the prepare,
        then atomically swap the serving params and confirm."""
        with self._lock:
            rec = self._versions.get(version)
            if rec is None:
                return
            ev = rec["event"]
        if not ev.wait(timeout=self.FLIP_WAIT_S):
            log.error("swap flip timed out waiting for staging",
                      version=version)
            self._answer(version=version,
                         error="staging never completed at this node")
            with self._lock:
                rec = self._versions.get(version)
                if rec is not None:
                    rec["flip_pending"] = False
            return
        t0 = time.monotonic()
        with self._lock:
            rec = self._versions.get(version)
            if rec is None:
                return
            if rec["state"] == COMMITTED:
                self._answer(version=version, applied=True)
                return
            if rec["state"] != PREPARED:
                # Aborted, or the prepare failed (its error report is
                # already on the wire): nothing to flip.
                rec["flip_pending"] = False
                return
            params = rec["params"]
            per_slot, head = rec["per_slot"], rec["head"]
            n_host = len(rec["host_slots"])
        if params is None:
            # Host-staged blobs pay their device_put here — the flip's
            # bounded dip, logged so the live_swap row can attribute it.
            params = self._assemble(per_slot, head)
        with self._lock:
            rec = self._versions.get(version)
            if rec is None or rec["state"] != PREPARED:
                # An abort landed during the assemble (it already
                # answered the leader): abandon the flip — applying it
                # now would put THIS replica on v2 while the leader
                # records a clean fleet-wide rollback.
                if rec is not None:
                    rec["flip_pending"] = False
                log.warn("flip abandoned; version left the prepared "
                         "state mid-assemble", version=version,
                         state=rec["state"] if rec else None)
                return
            # Claim the commit ATOMICALLY before applying: an abort
            # arriving from here on sees COMMITTED and refuses, loudly.
            rec["state"] = COMMITTED
            rec["flip_pending"] = False
            flip_slots = sorted(rec["per_slot"]) or sorted(per_slot)
            flip_base = rec["swap_base"]
            # The flipped-in tree owns the staged leaves now.
            rec["per_slot"] = {}
            rec["head"] = None
            rec["params"] = None
        # Retain the pre-flip serving state until the leader finalizes:
        # an SLO-breach rollback (docs/rollout.md) restores it with one
        # pointer swap instead of a re-dissemination.
        with self.r._lock:
            prev = (getattr(self.r, "boot_result", None),
                    getattr(self.r, "serving_version", ""),
                    dict(getattr(self.r, "_serving_tree_versions", {})))
        with self._lock:
            rec = self._versions.get(version)
            if rec is not None:
                rec["prev"] = prev
        self.r._apply_swap_result(version, params)
        dt = time.monotonic() - t0
        trace.count("swap.flips")
        # Pair-lifecycle spans (docs/observability.md): each staged v2
        # pair's terminal edge for swap/rollout pairs — acked→flipped is
        # the commit-fence propagation + flip cost the critical-path
        # walk attributes to the rollout plane.
        if flip_base >= 0:
            for slot in flip_slots:
                telemetry.span_event(
                    telemetry.span_id(self.r.node.my_id,
                                      flip_base + slot),
                    "flipped", node=self.r.node.my_id,
                    dest=self.r.node.my_id, layer=flip_base + slot,
                    version=version)
        log.info("swap committed: serving flipped atomically",
                 version=version, flip_ms=round(dt * 1000, 1),
                 host_staged_blobs=n_host)
        self._answer(version=version, applied=True)

    def _abort(self, version: str, revert: bool = False) -> None:
        """Rollback = don't flip: release the staged v2 set (decoded
        leaves AND the store's v2 blob entries) and keep serving v1.
        With ``revert`` (docs/rollout.md), an already-COMMITTED version
        rolls BACK: the retained pre-flip tree is restored with one
        pointer swap (the SLO-breach rollback); without it a committed
        version refuses the abort, as ever."""
        reverted = False
        kept_for_boot = False
        with self._lock:
            rec = self._versions.get(version)
            if rec is None:
                rec = self._track_locked(version, -1)
            if (rec["state"] == COMMITTED and revert and rec["prev"]
                    and rec["prev"][0] is None):
                # The flip WAS this replica's boot (it joined mid-
                # rollout and never served the pre-flip version):
                # "reverting" would restore a None tree and refuse
                # every request.  Keep the flipped tree serving —
                # degraded-but-serving beats dark — and release the
                # retained marker so duplicate reverts stay no-ops.
                rec["prev"] = None
                rec_state = COMMITTED
                kept_for_boot = True
            elif rec["state"] == COMMITTED and revert and rec["prev"]:
                prev = rec["prev"]
                rec["prev"] = None
                rec["state"] = REVERTED
                rec["event"].set()
                rec_state = REVERTED
                reverted = True
            elif rec["state"] in (COMMITTED, ABORTED, REVERTED):
                rec_state = rec["state"]
            else:
                rec["state"] = ABORTED
                rec["per_slot"] = {}
                rec["head"] = None
                rec["params"] = None
                rec["event"].set()
                rec_state = ABORTED
            swap_base = rec["swap_base"]
        if rec_state == COMMITTED:
            if kept_for_boot:
                trace.count("swap.revert_no_prev")
                log.error("revert refused: the flip was this replica's "
                          "boot (no pre-flip tree exists); keeping the "
                          "flipped tree serving", version=version)
            else:
                log.error("abort for an already-committed version "
                          "ignored (the flip happened; a plain abort "
                          "cannot undo it"
                          + (" and no retained pre-flip tree remains to "
                             "revert to" if revert else "") + ")",
                          version=version)
            return
        if rec_state == REVERTED and not reverted:
            return  # duplicate revert fence: already rolled back
        if reverted:
            prev_res, prev_version, prev_tree = prev
            with self.r._lock:
                self.r.boot_result = prev_res
                self.r.serving_version = prev_version
                self.r._serving_tree_versions = prev_tree
            trace.count("swap.reverted")
            log.warn("swap ROLLED BACK: serving restored to the "
                     "pre-flip tree", version=version,
                     restored_version=prev_version or "v1")
        dropped = 0
        if swap_base >= 0 and self.r.boot_cfg is not None:
            for lid in self._expected_ids(swap_base):
                with self.r._lock:
                    had = self.r.layers.pop(lid, None) is not None
                    self.r._own_digests.pop(lid, None)
                    self.r._digest_ok.discard(lid)
                if had:
                    dropped += 1
                    self.r.content_store.forget(lid)
        trace.count("swap.aborted")
        log.warn("swap aborted; v1 keeps serving, staged v2 released",
                 version=version, released_blobs=dropped)
        if dropped:
            # The leader's status rows still show the released v2 set
            # as delivered here (the acks landed): re-announce the
            # authoritative inventory, or a RETRY rollout under this
            # version would resolve its pairs at admit against bytes
            # this node no longer holds and wedge at the flip.
            try:
                self.r.announce()
            except (OSError, KeyError) as e:
                log.error("post-abort re-announce failed", err=repr(e))

    def _finalize(self, version: str) -> None:
        """Release the retained pre-flip tree: the rollback window is
        over (docs/rollout.md).  A finalize for an unknown/unflipped
        version is a harmless no-op — the fence is advisory."""
        with self._lock:
            rec = self._versions.get(version)
            if rec is None or rec["state"] != COMMITTED or not rec["prev"]:
                return
            rec["prev"] = None
        trace.count("swap.finalized")
        log.info("swap finalized; retained pre-flip tree released",
                 version=version)

    def _arm_query(self, version: str) -> None:
        if self.query_interval <= 0:
            return
        with self._lock:
            rec = self._versions.get(version)
            if rec is None or rec["state"] != PREPARED:
                return
            if rec["queries"] >= self.QUERY_RETRIES:
                log.error("commit fence re-request budget exhausted; "
                          "staying on the serving version", version=version)
                return
            rec["queries"] += 1
            n = rec["queries"]
        timer = threading.Timer(self.query_interval,
                                self._query_fire, args=(version, n))
        timer.daemon = True
        timer.start()

    def _query_fire(self, version: str, n: int) -> None:
        with self._lock:
            rec = self._versions.get(version)
            if rec is None or rec["state"] != PREPARED or rec["flip_pending"]:
                return
        trace.count("swap.fence_requeried")
        log.warn("staged swap never saw its commit fence; re-requesting",
                 version=version, attempt=n)
        self._answer(version=version, query=True)
        self._arm_query(version)

    def _answer(self, version: str, applied: bool = False,
                query: bool = False, error: str = "") -> None:
        from ..transport.messages import SwapCommitMsg

        self.r._send_to_leader(
            SwapCommitMsg(self.r.node.my_id, version, applied=applied,
                          query=query, error=error))
