"""Control-plane high availability: survive the leader (docs/failover.md).

The reference leaves node fault handling TODO (``crash(n node)``,
node.go:218-220); this repo added worker crash detection (PR on
``runtime/failure.py``) — but nothing monitored the LEADER: its death
froze every in-flight run.  This module closes that gap with three
cooperating pieces:

- :class:`ControlReplicator` — the leader half: every control-state
  mutation (status rows, acks, partial coverage, dropped assignments,
  digest stamps, mode-3 plan seq) streams to a config-declared ordered
  list of standbys as epoch-stamped ``ControlDeltaMsg``s — a full
  snapshot when a standby joins, deltas thereafter.
- :class:`ShadowLeaderState` — the standby half: the replicated shadow
  of the leader's control state, enough to construct a real leader of
  the run's mode at takeover.
- :class:`StandbyController` — lease watching + deterministic
  succession: the leader beacons ``LeaderLeaseMsg``; each standby feeds
  it to the existing :class:`~.failure.FailureDetector` with an expiry
  staggered by its succession rank, so the lowest-ranked LIVE standby
  fires first, promotes at ``epoch + 1``, and its first lease at the
  higher epoch IS the takeover announcement.  Workers re-point their
  leader and re-announce (inventory + checkpointed partials), so the
  new leader resumes delivery from partial coverage instead of
  restarting; every control message below the highest epoch seen is
  FENCED — a zombie ex-leader's plans are rejected, not raced.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

from ..core.types import (
    LayerLocation,
    LayerMeta,
    NodeID,
    layer_ids_from_json,
    layer_ids_to_json,
)
from ..transport.messages import ControlDeltaMsg, LeaderLeaseMsg
from ..utils import trace
from ..utils.logging import log
from .failure import FailureDetector


def _nested_layer_map_to_json(m: dict) -> dict:
    return {str(n): layer_ids_to_json(row) for n, row in m.items()}


def _nested_layer_map_from_json(d: dict) -> dict:
    return {int(n): layer_ids_from_json(row or {})
            for n, row in (d or {}).items()}


def _partial_to_json(p: dict) -> dict:
    # node -> {layer: {"Total": n, "Covered": [[s, e], ...]}}
    return {str(n): {str(l): info for l, info in per.items()}
            for n, per in p.items()}


def _partial_from_json(d: dict) -> dict:
    return {int(n): {int(l): info for l, info in (per or {}).items()}
            for n, per in (d or {}).items()}


class ControlReplicator:
    """Streams the leader's control-state mutations to its standbys.

    Best-effort by design: a delta lost to a dead standby only degrades
    that standby's shadow, and takeover reconciliation (every worker
    re-announces to the new leader) repairs any divergence — the shadow
    buys recovery SPEED, the re-announce buys correctness.

    Replication is ASYNCHRONOUS: publish() only enqueues; one drain
    thread per standby does the actual (possibly slow, dial-retrying)
    sends.  The hot control handlers that publish (handle_ack,
    handle_announce) must never stall behind a dead standby's TCP dial
    window — that would freeze the very control plane HA exists to
    protect.  Per-standby queues keep per-target delta ORDER; a full
    queue drops the delta (counted) rather than blocking the leader."""

    QUEUE_DEPTH = 1024

    def __init__(self, node, standbys: List[NodeID]):
        import queue as _queue

        self.node = node
        self.standbys = [s for s in standbys if s != node.my_id]
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._queues = {}
        for s in self.standbys:
            self._queues[s] = _queue.Queue(maxsize=self.QUEUE_DEPTH)
            threading.Thread(target=self._drain, args=(s,), daemon=True,
                             name=f"replicate-{s}").start()

    def publish(self, epoch: int, kind: str, data: dict) -> None:
        for standby in self.standbys:
            self.publish_to(standby, epoch, kind, data)

    def publish_to(self, standby: NodeID, epoch: int, kind: str,
                   data: dict) -> None:
        import queue as _queue

        q = self._queues.get(standby)
        if q is None:
            return
        msg = ControlDeltaMsg(self.node.my_id, epoch, next(self._seq),
                              kind, data)
        try:
            q.put_nowait(msg)
        except _queue.Full:
            # Best-effort by contract: the reconcile re-announce repairs
            # a lossy shadow; blocking the leader would not.
            trace.count("failover.replica_dropped")

    def _drain(self, standby: NodeID) -> None:
        import queue as _queue

        q = self._queues[standby]
        while not self._stop.is_set():
            try:
                msg = q.get(timeout=0.2)
            except _queue.Empty:
                continue
            try:
                self.node.add_node(standby)
                self.node.transport.send(standby, msg)
            except (OSError, KeyError) as e:
                log.debug("control delta send failed", standby=standby,
                          kind=msg.kind, err=repr(e))

    def close(self) -> None:
        self._stop.set()


class ShadowLeaderState:
    """A standby's replicated view of the leader's control state."""

    def __init__(self):
        self._lock = threading.Lock()
        self.mode: Optional[int] = None
        self.assignment: dict = {}
        self.status: dict = {}
        self.partial: dict = {}
        self.dropped: dict = {}
        self.digests: Dict[int, str] = {}
        self.plan_seq = 0
        self.startup_sent = False
        self.network_bw: Dict[NodeID, int] = {}
        self.failure_timeout = 0.0
        self.boot_enabled = True
        # Telemetry plane (docs/observability.md): the leader's folded
        # per-node metric snapshots ride replication too, so a takeover
        # keeps the cluster picture instead of starting blind.
        self.metrics: dict = {}
        # Fleet health timeline (docs/observability.md): the derived
        # event ring (straggler onsets and recoveries) — a promoted
        # standby keeps the health history, not just the raw counters.
        self.health: dict = {}
        # Autonomy engine (docs/autonomy.md): the policy engine's full
        # state — armed rules, cooldowns (remaining seconds), breach
        # streaks, quarantine mask, link demotions, in-flight actions
        # and the audit tail — a promoted standby inherits the closed
        # loop mid-action.
        self.policy: dict = {}
        # Mode-3 plan generation counter: fences stale revoke/dispatch
        # pairs across replans (docs/service.md, wrong-eat race).
        self.plan_gen = 0
        # Job plane (docs/service.md): the admitted-job table (raw
        # replication records, ``sched.jobs.JobManager.record``) and the
        # BASE single-run goal (``assignment`` above is the MERGED
        # effective goal) — a promoted standby resumes every job.
        self.jobs: dict = {}
        self.base_assignment: Optional[dict] = None
        # Live-swap driver records (docs/swap.md): version -> record,
        # so a promoted standby resumes (or re-fences) a half-finished
        # weight swap instead of stranding the fleet mid-rollout.
        self.swaps: dict = {}
        # Rollout pipeline records (docs/rollout.md): rollout_id ->
        # record (waves, per-wave states, SLO, verdicts, split) — a
        # promoted standby resumes the pipeline MID-WAVE with the
        # guard still armed.
        self.rollouts: dict = {}
        # Wire-codec plane (docs/codec.md): the leader's per-(dest,
        # layer) codec choices and the cluster capability table, so a
        # promoted leader keeps planning the byte spaces in-flight
        # encoded partials live in.
        self.wire_codecs: Dict[Tuple[NodeID, int], str] = {}
        self.node_codecs: Dict[NodeID, list] = {}
        # Pod-delivery plane (docs/fabric.md): the LIVE pod membership —
        # ``{"Table": {pid: [members]}, "Broken": [pids]}``.  A standby
        # promoted after a pod break/widen must adopt the broken set, or
        # its first re-plan would re-slice (resurrect) a pod whose
        # gather contributions can never arrive.
        self.pods: dict = {}
        # Hierarchical control (docs/hierarchy.md): the group table
        # (``{gid: {"Leader", "Members", "Dissolved"}}``) — a promoted
        # standby must reconstruct the SAME hierarchy (or its dissolved
        # remains), not fall back to flat planning.
        self.groups: dict = {}
        # Elastic membership (docs/membership.md): the replicated
        # roster (``{node: record}``) + the in-flight drain re-home
        # jobs (``{job_id: node}``) — a promoted standby resumes
        # admission and drains, and keeps departed members fenced.
        self.membership: dict = {}
        self.drain_jobs: dict = {}
        self.have_snapshot = False
        self.deltas_applied = 0

    @staticmethod
    def _codec_choices(d: dict) -> Dict[Tuple[NodeID, int], str]:
        out: Dict[Tuple[NodeID, int], str] = {}
        for key, c in (d or {}).items():
            try:
                dest, lid = str(key).split(":", 1)
                out[(int(dest), int(lid))] = str(c)
            except ValueError:
                continue
        return out

    def apply(self, msg: ControlDeltaMsg) -> None:
        d = msg.data
        with self._lock:
            self.deltas_applied += 1
            k = msg.kind
            if k == "snapshot":
                self.mode = int(d.get("Mode", 0))
                self.assignment = _nested_layer_map_from_json(
                    d.get("Assignment"))
                self.status = _nested_layer_map_from_json(d.get("Status"))
                self.partial = _partial_from_json(d.get("Partial"))
                self.dropped = _nested_layer_map_from_json(d.get("Dropped"))
                self.digests = {int(l): str(h)
                                for l, h in (d.get("Digests") or {}).items()}
                self.plan_seq = int(d.get("PlanSeq", 0))
                self.startup_sent = bool(d.get("StartupSent", False))
                self.network_bw = {int(n): int(b) for n, b in
                                   (d.get("NetworkBw") or {}).items()}
                self.failure_timeout = float(d.get("FailureTimeout", 0.0))
                self.boot_enabled = bool(d.get("BootEnabled", True))
                self.metrics = {int(n): dict(s) for n, s in
                                (d.get("Metrics") or {}).items()}
                self.health = dict(d.get("Health") or {})
                self.policy = dict(d.get("Policy") or {})
                self.plan_gen = int(d.get("PlanGen", 0))
                self.jobs = {str(j): dict(rec) for j, rec in
                             (d.get("Jobs") or {}).items()}
                self.swaps = {str(v): dict(rec) for v, rec in
                              (d.get("Swaps") or {}).items()}
                self.rollouts = {str(r): dict(rec) for r, rec in
                                 (d.get("Rollouts") or {}).items()}
                self.wire_codecs = self._codec_choices(d.get("WireCodecs"))
                self.node_codecs = {
                    int(n): [str(c) for c in caps]
                    for n, caps in (d.get("NodeCodecs") or {}).items()}
                if d.get("BaseAssignment") is not None:
                    self.base_assignment = _nested_layer_map_from_json(
                        d.get("BaseAssignment"))
                self.groups = {str(g): dict(rec) for g, rec in
                               (d.get("Groups") or {}).items()}
                self.pods = dict(d.get("Pods") or {})
                self.membership = {str(n): dict(rec) for n, rec in
                                   (d.get("Membership") or {}).items()}
                self.drain_jobs = {str(j): int(n) for j, n in
                                   (d.get("DrainJobs") or {}).items()}
                self.have_snapshot = True
            elif k == "status":
                self.status[int(d["Node"])] = layer_ids_from_json(
                    d.get("Layers") or {})
            elif k == "ack":
                row = self.status.setdefault(int(d["Node"]), {})
                row[int(d["Layer"])] = LayerMeta(
                    location=LayerLocation(int(d.get("Location", 0))),
                    data_size=int(d.get("Size", 0)),
                    shard=str(d.get("Shard", "")),
                    version=str(d.get("Version", "") or ""),
                    codec=str(d.get("Codec", "") or ""))
            elif k == "partial":
                node = int(d["Node"])
                per = d.get("Partial")
                if per:
                    self.partial[node] = {int(l): info
                                          for l, info in per.items()}
                else:
                    self.partial.pop(node, None)
            elif k == "crash":
                node = int(d["Node"])
                self.status.pop(node, None)
                dropped = d.get("Dropped")
                if dropped:
                    self.dropped[node] = layer_ids_from_json(dropped)
                    self.assignment.pop(node, None)
            elif k == "assignment":
                self.assignment = _nested_layer_map_from_json(
                    d.get("Assignment"))
                self.dropped = {}
            elif k == "digests":
                for l, h in (d.get("Digests") or {}).items():
                    self.digests[int(l)] = str(h)
            elif k == "startup":
                self.startup_sent = bool(d.get("Sent", True))
            elif k == "plan_seq":
                self.plan_seq = max(self.plan_seq, int(d.get("Seq", 0)))
            elif k == "revive":
                # A declared-dead node re-announced and was restored:
                # it is no longer written off (the adopt-time job-pair
                # re-drop must not hit a live dest).
                self.dropped.pop(int(d["Node"]), None)
            elif k == "base_assignment":
                self.base_assignment = _nested_layer_map_from_json(
                    d.get("Assignment"))
            elif k == "groups":
                # The hierarchical group table (docs/hierarchy.md):
                # always the full current table (a dissolve re-sends
                # it), so REPLACE.
                self.groups = {str(g): dict(rec) for g, rec in
                               (d.get("Groups") or {}).items()}
            elif k == "pods":
                # Pod membership (docs/fabric.md): always the full
                # current table + broken set (a break re-sends it), so
                # REPLACE like the group table.
                self.pods = dict(d.get("Pods") or {})
            elif k == "codecs":
                # Wire-codec choices + capability table (docs/codec.md).
                # REPLACE, don't merge: the delta always carries the
                # leader's full current maps, and a revoked capability
                # (or a reverted choice) is exactly an ABSENT entry —
                # an update-merge would resurrect it at takeover.
                self.wire_codecs = self._codec_choices(d.get("Choices"))
                self.node_codecs = {
                    int(n): [str(c) for c in caps]
                    for n, caps in (d.get("NodeCodecs") or {}).items()}
            elif k == "job":
                self.jobs[str(d["JobID"])] = dict(d)
            elif k == "swap":
                self.swaps[str(d["Version"])] = dict(d)
            elif k == "job_done":
                rec = self.jobs.get(str(d.get("JobID", "")))
                if rec is not None:
                    rec["State"] = "done"
                    rec["Remaining"] = []
            elif k == "membership":
                # Elastic membership (docs/membership.md): always the
                # leader's full current roster + drain map — REPLACE,
                # so a departed seat is exactly an absent/LEFT row.
                self.membership = {str(n): dict(rec) for n, rec in
                                   (d.get("Members") or {}).items()}
                self.drain_jobs = {str(j): int(n) for j, n in
                                   (d.get("DrainJobs") or {}).items()}
            elif k == "member_left":
                # A clean leave (drain finalize): the seat's control
                # rows vanish WITHOUT entering the dropped/crash
                # bookkeeping — a takeover must not resurrect it or
                # re-apply crash-path drops against it.
                node = int(d["Node"])
                self.status.pop(node, None)
                self.assignment.pop(node, None)
                self.partial.pop(node, None)
                self.dropped.pop(node, None)
            elif k == "metrics":
                self.metrics[int(d["Node"])] = {
                    "counters": dict(d.get("Counters") or {}),
                    "gauges": dict(d.get("Gauges") or {}),
                    "links": dict(d.get("Links") or {}),
                    "hists": dict(d.get("Hists") or {}),
                    "spans": [dict(ev) for ev in d.get("Spans") or []],
                    "t_wall_ms": float(d.get("T", 0.0)),
                    "proc": str(d.get("Proc", "")),
                }
            elif k == "health":
                # Fleet health events append-only (each delta carries
                # the new events; the snapshot carries the full ring),
                # BOUNDED like the leader's own ring — a flapping link
                # in a long service run must not grow shadow memory and
                # snapshot payloads without limit.
                from ..utils.telemetry import health_ring_size

                evs = self.health.setdefault("events", [])
                evs.extend(dict(ev) for ev in d.get("Events") or [])
                cap = health_ring_size()
                if len(evs) > cap:
                    del evs[:-cap]
            elif k == "rollout":
                # Rollout pipeline records (docs/rollout.md): the full
                # current record per delta — REPLACE per rollout id.
                self.rollouts[str(d["RolloutID"])] = dict(d)
            elif k == "policy":
                # Autonomy engine state (docs/autonomy.md): every delta
                # carries the engine's FULL current state (rules,
                # cooldowns, mask, in-flight actions) — REPLACE, so a
                # lifted quarantine or completed action is exactly an
                # absent entry.
                self.policy = dict(d)
            elif k == "plan_gen":
                self.plan_gen = max(self.plan_gen, int(d.get("Gen", 0)))
            else:
                log.warn("unknown control delta kind", kind=k)

    def export(self) -> dict:
        """A typed copy for :meth:`LeaderNode.adopt_shadow`."""
        with self._lock:
            return {
                "mode": self.mode,
                "assignment": {n: dict(r)
                               for n, r in self.assignment.items()},
                "status": {n: dict(r) for n, r in self.status.items()},
                "partial": {n: dict(p) for n, p in self.partial.items()},
                "dropped": {n: dict(r) for n, r in self.dropped.items()},
                "digests": dict(self.digests),
                "plan_seq": self.plan_seq,
                "startup_sent": self.startup_sent,
                "network_bw": dict(self.network_bw),
                "failure_timeout": self.failure_timeout,
                "boot_enabled": self.boot_enabled,
                "metrics": {n: dict(s) for n, s in self.metrics.items()},
                "health": {k: list(v) if isinstance(v, list) else dict(v)
                           for k, v in self.health.items()},
                "policy": dict(self.policy),
                "plan_gen": self.plan_gen,
                "jobs": {j: dict(rec) for j, rec in self.jobs.items()},
                "swaps": {v: dict(rec) for v, rec in self.swaps.items()},
                "rollouts": {r: dict(rec)
                             for r, rec in self.rollouts.items()},
                "base_assignment": (
                    {n: dict(r) for n, r in self.base_assignment.items()}
                    if self.base_assignment is not None else None),
                "wire_codecs": dict(self.wire_codecs),
                "node_codecs": {n: list(c)
                                for n, c in self.node_codecs.items()},
                "groups": {g: dict(rec) for g, rec in self.groups.items()},
                "pods": {k: (dict(v) if isinstance(v, dict) else list(v))
                         for k, v in self.pods.items()},
                "membership": {n: dict(rec)
                               for n, rec in self.membership.items()},
                "drain_jobs": dict(self.drain_jobs),
                "have_snapshot": self.have_snapshot,
            }


class StandbyController:
    """Attach to a receiver to make its node a leader standby.

    Registers the ``ControlDeltaMsg`` handler on the receiver's (already
    running) message loop, hooks the receiver's lease path, and monitors
    the leader's lease with an expiry staggered by succession rank —
    rank r waits ``lease_timeout * (1 + r)``, so the lowest-ranked LIVE
    standby always fires first and a dead first-in-line simply yields to
    the next by timeout, with no extra election protocol.  Promotion is
    deterministic takeover: build the run-mode leader over the worker's
    own loop/layers, adopt the shadow, bump the epoch, and beacon the
    new lease (workers re-point + re-announce = reconcile)."""

    def __init__(self, receiver, rank: int = 0, lease_timeout: float = 5.0,
                 standbys: Optional[List[NodeID]] = None,
                 mode: Optional[int] = None,
                 node_network_bw: Optional[Dict[NodeID, int]] = None,
                 failure_timeout: Optional[float] = None,
                 lease_interval: Optional[float] = None):
        self.receiver = receiver
        self.node = receiver.node
        self.shadow = ShadowLeaderState()
        self.rank = rank
        self.lease_timeout = lease_timeout
        self.lease_interval = lease_interval
        self.standbys = list(standbys or [])
        self._mode = mode
        self._bw = node_network_bw
        self._ft = failure_timeout
        self.promoted = threading.Event()  # set once self.leader is live
        self._promoting = False  # reentrancy latch (under self._lock)
        self.leader = None  # the promoted leader instance, post-takeover
        self.takeover_seconds: Optional[float] = None  # promote wall cost
        self._lock = threading.Lock()
        self._armed = False
        self._epoch_seen = -1
        timeout = lease_timeout * (1.0 + rank)
        self.detector = FailureDetector(timeout, self._leader_expired)
        receiver.loop.register(ControlDeltaMsg, self.handle_delta)
        receiver.on_leader_lease = self.handle_lease

    def close(self) -> None:
        self.detector.stop()
        if self.leader is not None:
            self.leader.close()

    # ------------------------------------------------------------- intake

    def handle_delta(self, msg: ControlDeltaMsg) -> None:
        with self._lock:
            if msg.epoch < self._epoch_seen:
                # A deposed leader's stale deltas must not pollute the
                # shadow the CURRENT leader is feeding.
                trace.count("failover.fenced_delta")
                return
            self._epoch_seen = max(self._epoch_seen, msg.epoch)
        self.detector.touch(msg.src_id)  # deltas are leader liveness too
        self.shadow.apply(msg)

    def handle_lease(self, msg: LeaderLeaseMsg) -> None:
        """Receiver hook — called AFTER the receiver's own fencing and
        leader re-pointing, so ``node.leader_id`` is already current."""
        with self._lock:
            if msg.epoch < self._epoch_seen:
                return  # zombie lease: the receiver fenced it already
            self._epoch_seen = max(self._epoch_seen, msg.epoch)
            if msg.standbys:
                self.standbys = [int(s) for s in msg.standbys]
                if self.node.my_id in self.standbys:
                    new_rank = self.standbys.index(self.node.my_id)
                    if new_rank != self.rank:
                        # Succession shortened (a standby ahead of us
                        # was promoted or dropped): tighten our expiry.
                        self.rank = new_rank
                        self.detector._timeout = self.lease_timeout * (
                            1.0 + new_rank)
            if msg.interval > 0:
                # Size the expiry off the leader's advisory beacon
                # period when it is longer than our config (never
                # shorter: a slow beacon must not fake-expire).
                floor = msg.interval * 3 * (1.0 + self.rank)
                if floor > self.detector._timeout:
                    self.detector._timeout = floor
            arm = not self._armed
            self._armed = True
        self.detector.touch(msg.src_id)
        if arm:
            self.detector.start()
        ldr = self.leader
        if ldr is not None:
            # The receiver owns the LeaderLeaseMsg handler on the shared
            # loop; forward so a PROMOTED leader can still depose itself
            # when a better claim (higher epoch, or equal-epoch lower
            # id) appears — without this, a double promotion would leave
            # two schedulers beaconing forever.
            ldr.handle_leader_lease(msg)

    # ----------------------------------------------------------- takeover

    def _leader_expired(self, node_id: NodeID) -> None:
        with self._lock:
            if self._promoting:
                return
        if node_id != self.node.leader_id:
            # A PREVIOUS leader's stale lease entry expired after a
            # takeover we already followed; only the current leader's
            # silence is a failover trigger.
            return
        self.promote(dead=node_id)

    def promote(self, dead: Optional[NodeID] = None) -> None:
        """Assume leadership: the deterministic takeover."""
        with self._lock:
            if self._promoting:
                return
            self._promoting = True
            epoch = max(self._epoch_seen, 0) + 1
            remaining = [s for s in self.standbys if s != self.node.my_id]
        t0 = time.monotonic()
        shadow = self.shadow.export()
        if not shadow["have_snapshot"]:
            log.error("promoting WITHOUT a replicated snapshot; recovery "
                      "depends entirely on worker re-announces")
        mode = self._mode if self._mode is not None else (
            shadow["mode"] or 0)
        ft = self._ft if self._ft is not None else shadow["failure_timeout"]
        interval = self.lease_interval or max(self.lease_timeout / 3.0, 0.05)
        log.error("leader lease expired; standby assuming leadership",
                  dead=dead, epoch=epoch, mode=mode, rank=self.rank,
                  shadow_deltas=self.shadow.deltas_applied)
        trace.count("failover.takeover")
        # Leadership is self-directed now: our own acks/announces must
        # short-circuit back into our loop.
        self.node.add_node(self.node.my_id)
        self.node.update_leader(self.node.my_id)
        self.receiver.note_leader_epoch(epoch)
        from .leader import (
            FlowRetransmitLeaderNode,
            HierarchicalFlowLeaderNode,
            LeaderNode,
            PullRetransmitLeaderNode,
            RetransmitLeaderNode,
        )

        classes = [LeaderNode, RetransmitLeaderNode,
                   PullRetransmitLeaderNode, FlowRetransmitLeaderNode]
        cls = classes[mode]
        groups = shadow.get("groups") or {}
        if mode == 3 and groups:
            # The dead root ran the hierarchy (docs/hierarchy.md): the
            # promoted leader must keep it — flat planning would send
            # leases to grouped members and re-point them all.
            cls = HierarchicalFlowLeaderNode
        kwargs = dict(start_loop=False, loop=self.receiver.loop,
                      lock=self.receiver._lock,
                      expected_nodes=set(), failure_timeout=ft,
                      standbys=remaining, lease_interval=interval,
                      epoch=epoch,
                      # The promoted leader inherits this seat's
                      # wire-codec plane (docs/codec.md): adopted codec
                      # choices stay plannable/stampable in encoded
                      # byte space across the takeover.
                      codecs=getattr(self.receiver, "codec_plane", None))
        args = (self.node, self.receiver.layers, shadow["assignment"])
        if mode == 3:
            bw = self._bw if self._bw is not None else shadow["network_bw"]
            if cls is HierarchicalFlowLeaderNode:
                kwargs["groups"] = groups
            pod_table = (shadow.get("pods") or {}).get("Table") or {}
            if pod_table:
                # The dead leader ran pod delivery (docs/fabric.md): the
                # promoted leader must keep the pod table — without it
                # the adopted goal's 1/R@k slices would never re-derive
                # their pod pairs, and the open-until-materialized
                # invariant would wedge on shard acks with no gather.
                kwargs["pods"] = {int(p): [int(m) for m in ms]
                                  for p, ms in pod_table.items()}
            leader = cls(*args, bw, **kwargs)
        else:
            leader = cls(*args, **kwargs)
        leader.boot_enabled = shadow["boot_enabled"]
        leader.adopt_shadow(shadow, dead_leader=dead)
        # Leader-bound swap traffic (confirm/query/error) arrives on the
        # shared loop's RECEIVER handler; forward it to the promoted
        # leader's swap driver (docs/swap.md).
        self.receiver.on_swap_leader_msg = leader.handle_swap_commit
        self.leader = leader
        self.promoted.set()  # only after self.leader is observable
        leader.detector.start()
        # First lease at the bumped epoch = the takeover announcement:
        # workers re-point their leader, flush requeued messages, and
        # re-announce (inventory + partials) — the reconcile channel.
        leader.start_ha()
        leader.resume_from_takeover()
        self.takeover_seconds = time.monotonic() - t0
        log.info("takeover complete; delivery resuming",
                 epoch=epoch, takeover_ms=round(
                     self.takeover_seconds * 1000, 1))
