"""Leader state machines: the four dissemination schedulers.

Re-design of the reference's leaders (``distributor/node.go``):

- **Mode 0** ``LeaderNode`` — naive broadcast: once every assigned node has
  announced, the leader itself sends every assigned layer to every assignee
  (node.go:228-469).
- **Mode 1** ``RetransmitLeaderNode`` — peer retransmission: layers already
  owned by some peer are forwarded by that peer instead, offloading the
  leader's NIC (node.go:472-626).
- **Mode 2** ``PullRetransmitLeaderNode`` — pull/work-stealing: rarest-first
  job table, min-loaded sender selection, and straggler mitigation by
  stealing pending jobs from slow senders, re-scheduled on every ack
  (node.go:629-1073).
- **Mode 3** ``FlowRetransmitLeaderNode`` — max-flow optimal: a global plan
  of partial-layer byte-range jobs with per-job rate budgets, computed by
  the time-parameterized max-flow solver (node.go:1076-1288).

Deviations from the reference, on purpose:
- ``start_distribution``/``ready`` queues are buffered, so a leader never
  deadlocks when the caller isn't listening yet (reference quirk: unbuffered
  send inside the announce handler, node.go:322).
- Startup/ready fire exactly once, guarded by a flag (the reference's mode-2
  per-node completion map can re-fire, node.go:753-759).

Copy of the JAX package's ``runtime/leader.py``: the leader is host code
and speaks the same wire protocol, so JAX and PyTorch nodes share one
cluster over TCP.  The single-controller device fabric (``fabric=`` a
``parallel.fabric.FabricPlane``) dispatches ``DevicePlanMsg`` plans as in
the JAX package, and so does the multi-controller fabric (``fabric=`` a
``parallel.spmd_fabric.SpmdFabric``: plans broadcast to every node in
global seq order) and mode-3 pod-shard delivery (``pods=``) over either.
A transfer the fabric cannot carry (a client-held source) or a plan that
could not be dispatched rides the host path and bumps a ``fallback.*``
trace counter.
"""

from __future__ import annotations

import dataclasses
import hmac
import itertools
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..core.types import (
    Assignment,
    LayerID,
    LayerIDs,
    LayerLocation,
    LayerMeta,
    LayersSrc,
    LayerSrc,
    NodeID,
    Status,
    codec_accepts,
    codec_capability,
    delivered,
    delta_base_digest,
    parse_shard_spec,
    layer_ids_to_json,
    satisfies,
    shard_covers,
    shard_range,
)
from ..sched.flow import (
    FlowJob,
    FlowJobsMap,
    pick_salvage_source,
    pod_shard_demands,
    rate_for,
    solve_joint,
)
from ..sched.jobs import Job, JobManager
from ..sched.native import make_flow_graph
from ..transport.messages import (
    AckMsg,
    AnnounceMsg,
    BootHintMsg,
    BootReadyMsg,
    DevicePlanMsg,
    DrainMsg,
    FlowRetransmitMsg,
    GenerateReqMsg,
    GenerateRespMsg,
    GroupPlanMsg,
    GroupStatusMsg,
    HeartbeatMsg,
    JoinMsg,
    JobRevokeMsg,
    JobStatusMsg,
    JobSubmitMsg,
    LayerDigestsMsg,
    LayerMsg,
    LayerNackMsg,
    LeaderLeaseMsg,
    MetricsReportMsg,
    PlanResendReqMsg,
    PolicyCtlMsg,
    RetransmitMsg,
    RolloutCtlMsg,
    ServeMsg,
    SourceDeadMsg,
    StartupMsg,
    SwapCommitMsg,
    TimeSyncMsg,
)
from ..utils import integrity, intervals, telemetry, trace
from ..utils.logging import log
from .checkpoint import map_through_gaps
from .failover import (
    ControlReplicator,
    _nested_layer_map_to_json,
    _partial_to_json,
)
from .failure import FailureDetector
from .membership import MembershipTable
from . import membership as mship
from .node import MessageLoop, Node
from .policy import PolicyEngine
from .rollout import RolloutDriver
from .store import ContentIndex
from .send import (
    NackRetransmitter,
    RevokeRegistry,
    contribute_device_plan,
    fetch_from_client,
    handle_flow_retransmit,
    release_upload_cache,
    reopen_upload_cache,
    send_layer,
)


def _range_key(spec: str, codec: str) -> str:
    """The range-digest cache's spec key: the shard spec, qualified by
    the wire codec when the range hashes the ENCODED blob
    (docs/codec.md; shard x codec pod pairs).  One definition shared
    by the stamping writer and the ack-time reader."""
    return spec + (f"+{codec}" if codec else "")


def assignment_satisfied(a: Assignment, s: Status) -> bool:
    """Every assigned layer is held in RAM/HBM by its node
    (node.go:435-446) — at a shard that COVERS the assigned one for
    sharded targets (docs/sharding.md; a shard-holder never satisfies a
    full-layer demand)."""
    for node_id, layers in a.items():
        held = s.get(node_id, {})
        for layer_id, want in layers.items():
            if not satisfies(held.get(layer_id), want):
                return False
    return True


class LeaderNode:
    """Mode 0: naive leader broadcast."""

    # Scheduler mode number, for the replicated snapshot (a promoted
    # standby must construct the SAME scheduler class at takeover).
    MODE = 0

    def __init__(
        self,
        node: Node,
        layers: LayersSrc,
        assignment: Assignment,
        start_loop: bool = True,
        expected_nodes: Optional[Set[NodeID]] = None,
        failure_timeout: float = 0.0,
        fabric=None,
        placement=None,
        standbys: Optional[List[NodeID]] = None,
        lease_interval: float = 0.0,
        epoch: int = -1,
        loop=None,
        lock=None,
        codecs=None,
    ):
        """``expected_nodes``: when given, distribution also waits for these
        nodes to announce — not just the assignment keys.  The reference
        starts once all *assignees* have announced (node.go:313-319), which
        races pure seeders' announcements and silently schedules around
        them (its benchmark config has 7 seeders and 1 assignee).

        ``failure_timeout``: seconds of silence after which an announced
        node is declared crashed and ``crash()`` re-plans around it; 0
        disables detection (the reference has none — crash() is its TODO,
        node.go:218-220).

        ``fabric`` + ``placement``: a ``parallel.fabric.FabricPlane`` and a
        ``parallel.mesh.fabric_placement`` covering every node.  When both
        are set, scheduled transfers whose participants all have fabric
        stages are dispatched as ``DevicePlanMsg`` control commands and the
        layer bytes move as device traffic (ICI) instead of TCP streams —
        the north-star data plane (SURVEY §5.8).  Transfers the fabric
        can't carry (client-held sources, unstaged nodes) fall back to the
        host path per transfer.

        Control-plane HA (docs/failover.md): ``standbys`` is the ordered
        succession list — when non-empty, every control-state mutation
        replicates to them as ``ControlDeltaMsg``s; ``lease_interval``
        > 0 beacons ``LeaderLeaseMsg`` liveness; ``epoch`` is this
        leader's fencing epoch (stamped onto every control message it
        emits; -1 = HA off, wire format unchanged).  ``loop``: share an
        already-running MessageLoop instead of owning one — the
        promoted-standby path, where the worker's loop keeps its
        data-plane handlers and the leader fills the control-plane
        gaps."""
        self.node = node
        self.layers = layers
        self.assignment = assignment
        # Multi-job service plane (docs/service.md): the constructor's
        # assignment is the BASE single-run goal; admitted jobs merge
        # into ``self.assignment`` (the effective cluster goal every
        # existing path reads) and are tracked per job.  Until a job is
        # admitted the two are the SAME object — zero behavior change
        # for single-run deployments.
        self._base_assignment = assignment
        self.jobs = JobManager()
        # Live-swap driver state (docs/swap.md): version -> record
        # {"version", "job_id", "swap_base", "dests", "state"
        # (rolling|committed|aborted), "confirmed"} — replicated to
        # standbys (delta kind "swap" + snapshot section) so a promoted
        # leader resumes a half-finished rollout.
        self._swaps: Dict[str, dict] = {}
        self._swaps_by_job: Dict[str, str] = {}
        # Rollout pipeline (docs/rollout.md): wave versions whose swap
        # commit is HELD for the pipeline (version -> rollout id) — the
        # driver writes the marker before submitting each wave job —
        # and the pipeline state machine itself.
        self._swap_holds: Dict[str, str] = {}
        self.rollouts = RolloutDriver(self)
        # Joiner seats whose NIC rate was PINNED to the most
        # conservative configured value at admission: their first
        # announce carrying a real rate supersedes it
        # (docs/membership.md).
        self._joiner_bw_pinned: Set[NodeID] = set()
        # Admission control (docs/service.md): the shared-secret job
        # token.  Read at construction like the other env knobs; empty
        # = open admission (the legacy behavior).
        self._job_token = os.environ.get("DLD_JOB_TOKEN", "")
        # Per-submitter quotas/rate limits (docs/service.md), keyed by
        # the DLD_JOB_TOKEN identity: DLD_JOB_QUOTA caps a submitter's
        # concurrently ACTIVE jobs, DLD_JOB_RATE ("N/SECONDS") caps its
        # submit attempts per window.  0/empty = unlimited (legacy).
        # Refusals are counted (jobs.quota_refused) and always ANSWER.
        try:
            self._job_quota = int(os.environ.get("DLD_JOB_QUOTA", "0"))
        except ValueError:
            self._job_quota = 0
        self._job_rate_n, self._job_rate_s = 0, 0.0
        rate_spec = os.environ.get("DLD_JOB_RATE", "")
        if rate_spec:
            try:
                n, s = rate_spec.split("/", 1)
                self._job_rate_n, self._job_rate_s = int(n), float(s)
            except ValueError:
                log.error("malformed DLD_JOB_RATE (want 'N/SECONDS'); "
                          "rate limiting disabled", value=rate_spec)
        self._submit_times: Dict[str, List[float]] = {}
        # Wire-codec plane (docs/codec.md): this leader's own
        # encode/decode capability + each announced node's (the
        # negotiation's capability table), the memoized per-(dest,
        # layer) codec CHOICE (stable across re-merges and re-plans),
        # and the codec-qualified digest cache the stamp reads.
        self.codecs = codecs
        self.node_codecs: Dict[NodeID, frozenset] = {}
        if codecs is not None:
            self.node_codecs[node.my_id] = frozenset(
                codecs.decode_codecs())
        self._codec_choice: Dict[Tuple[NodeID, LayerID], str] = {}
        self._codec_digest_cache: Dict[Tuple[LayerID, str], str] = {}
        # Content-delta plane (docs/codec.md): the per-layer pinned base
        # digest ("" = delta provably not worth it for this layer) and
        # digest → leader-local verified canonical bytes — what the
        # plane's delta encoder reads the base from.  The resolver is a
        # PLAIN dict .get: it runs inside the plane's encode path while
        # self._lock may be held, so it must never take the leader lock.
        self._delta_base: Dict[LayerID, str] = {}
        self._delta_base_src: Dict[str, LayerSrc] = {}
        if codecs is not None:
            codecs.base_resolver = self._delta_base_src.get
        # Sticky once ANY pair was ever chosen quantized: digests-off
        # stamps then carry explicit ""-codec entries so a REVERTED
        # pair still reconciles at the dest (mirrors _sharding_seen).
        self._codec_seen = False
        # (layer, dest) pairs already reported as content-skipped (the
        # counter/log fire once per pair, not once per replan).
        self._content_skip_seen: Set[Tuple[LayerID, NodeID]] = set()
        # Content-addressed holdings (runtime/store.py): digest →
        # (node, layer) holders, fed by announces and acks — lets a
        # delta-rollout job skip shipping layers whose bytes a dest
        # already holds under another id.
        self.content = ContentIndex()
        self.fabric = fabric
        self.placement = placement
        self._plan_seq = itertools.count()
        # Batch-hint ids must be unique across DISPATCH ROUNDS (a
        # re-plan within the dest's batch wait would otherwise collide
        # with a still-open group and fire a mixed batch); separate from
        # _plan_seq on purpose — consuming plan seqs for ids would punch
        # holes in the SPMD lockstep ordering.
        self._batch_seq = itertools.count()
        # seq -> the operative DevicePlanMsg broadcast for it (plan, or
        # the cancel that superseded it): the re-send store for SPMD
        # gap recovery (handle_plan_resend).  Insertion-ordered, bounded.
        self._sent_plans: Dict[int, DevicePlanMsg] = {}
        # seq -> {"t": dispatch time, "retries": n} for SPMD plans whose
        # (layer, dest) ack hasn't arrived: the WATCHDOG side of the gap
        # recovery.  The receiver-side gap report only fires when LATER
        # seqs queue behind a hole — a dropped TAIL plan stalls silently
        # (nothing queues, the dest never learned of it), so the leader
        # also re-broadcasts unacked plans on a timer and cancels after
        # PLAN_REBROADCASTS tries (the dest's collect-timeout
        # re-announce then re-plans the bytes, host path).
        self._plan_watch: Dict[int, dict] = {}
        self._watch_stop = threading.Event()
        self.expected_nodes = set(expected_nodes or ())
        self.status: Status = {}
        # A promoted standby's leader shares the hosting WORKER's lock
        # (``lock=``): both mutate the same ``layers`` store, and two
        # locks over one dict would race.
        self._lock = lock if lock is not None else threading.Lock()
        # Multi-controller lockstep fabric?  Fixed at construction.
        self._spmd = getattr(fabric, "kind", "") == "spmd"
        # SPMD fabric: declared crashes break pod-wide lockstep, so later
        # transfers fall back to the host path (_fabric_ok).
        self._fabric_disabled = False
        if fabric is not None and hasattr(fabric, "bind_store"):
            fabric.bind_store(layers, self._lock)
        self._start_q: "queue.Queue[Assignment]" = queue.Queue()
        self._ready_q: "queue.Queue[Assignment]" = queue.Queue()
        self._started = False
        self._starting = False
        self._startup_sent = False
        # The leader's boot decision rides StartupMsg so one flag governs
        # the whole run (see send_startup); the CLI sets this False for
        # dissemination-only runs of boot-capable topologies (-boot none).
        self.boot_enabled = True
        self._serve_promised = False  # StartupMsg said a ServeMsg follows
        self.serve_generate = 0  # >0: pod serving decodes N tokens (-gen)
        # Model-boot completion tracking (BootReadyMsg is an extension:
        # the reference's startup hook has no completion signal).
        self._boot_q: "queue.Queue[Dict[NodeID, float]]" = queue.Queue()
        self._booted: Dict[NodeID, float] = {}
        self._boot_kinds: Dict[NodeID, str] = {}  # serve needs "stage"
        self._boot_reported = False
        self._t_start: Optional[float] = None
        # node -> {layer: {"Total": n, "Covered": [[s, e], ...]}} from
        # announces of checkpoint-resuming receivers.
        self.partial_status: Dict[NodeID, dict] = {}
        # Assignments dropped by crash(), kept so a declared-dead node that
        # restarts and re-announces gets its layers back (resume).
        self._dropped_assignment: Dict[NodeID, LayerIDs] = {}
        # Elastic membership (docs/membership.md): the replicated
        # roster.  Configured seats (assignees, expected seeders,
        # standbys, the leader itself) are ACTIVE + source-verified from
        # the start — the config is the operator's trust statement;
        # joiners enter JOINING (dest immediately, source once their
        # holdings digest-verify) and drains run a re-home-then-prune
        # protocol that never touches the crash path.
        self.membership = MembershipTable()
        self.membership.seed(
            set(assignment) | set(expected_nodes or ())
            | set(standbys or ()) | {node.my_id}, epoch=epoch)
        # job_id -> the node a kind="drain" re-home job is draining;
        # its completion fires the atomic prune (_finalize_drain).
        self._drain_jobs: Dict[str, NodeID] = {}
        # joiner -> wanted layer ids ([] = the layer universe): admits
        # whose refill job waits for the joiner's FIRST announce — the
        # announce carries its cold-boot holdings (inventory, partials,
        # digests), so the job's remaining demand is computed against
        # them and only the complement ever ships.
        self._join_pending: Dict[NodeID, List[LayerID]] = {}
        # draining node -> requester seats awaiting the DONE notice.
        self._drain_waiters: Dict[NodeID, Set[NodeID]] = {}
        self.detector = FailureDetector(failure_timeout, self.crash)
        # Seed the liveness leases so a node that dies before ever
        # announcing is still detected (its lease simply expires).  Never
        # monitor the leader itself: it sends itself no heartbeats, and
        # "self-crashing" would drop its own layer inventory.
        for node_id in set(self.assignment) | self.expected_nodes:
            if node_id != node.my_id:
                self.detector.touch(node_id)

        # Integrity plane (docs/integrity.md): layer_id -> self-
        # describing digest of
        # the layer's true bytes — collected from holders' announces plus
        # the leader's own layers (hashed on a background thread: at
        # physical sizes the hash takes seconds, all of them PRE-timer,
        # overlapped with the announce round-trips).  Stamped per
        # assignee at distribution start (LayerDigestsMsg); the NACK
        # retransmit service serves corrupt-fragment re-requests for
        # layers the leader itself sends (all four modes).
        self.layer_digests: Dict[LayerID, str] = {}
        self._digests_ready = threading.Event()
        # (layer, shard spec) -> digest of exactly that byte range — the
        # sharded-delivery stamp cache (docs/sharding.md); replans and
        # per-dest stamps must not re-hash gigabytes.
        self._range_digest_cache: Dict[Tuple[LayerID, str], str] = {}
        # Sticky once any sharded target/holding has been seen: with
        # digests disabled, stamps then carry explicit ""-spec entries
        # so a widened target still reconciles at the dest.
        self._sharding_seen = False
        # Fabric-assisted pod delivery (docs/fabric.md): (layer, dest)
        # -> the pair's NIC shard spec.  Empty on every scheduler that
        # doesn't pod-plan (only mode 3 does, and only with a ``pods``
        # grouping configured); the goal stays OPEN until every pod
        # pair's FULL wire-form tree materialized (_pods_open_locked).
        self._pod_pairs: Dict[Tuple[LayerID, NodeID], str] = {}
        self.nacker = NackRetransmitter()
        # Preemption revoke (docs/service.md): the leader is a sender
        # too — its own queued flow sends honor revokes via this
        # registry (remote senders get JobRevokeMsg).
        self.revokes = RevokeRegistry()

        # Control-plane HA (docs/failover.md).
        self.epoch = epoch
        self.standbys: List[NodeID] = list(standbys or [])
        self.lease_interval = lease_interval
        self._lease_stop = threading.Event()
        self._lease_inflight: Set[NodeID] = set()
        self._deposed = False
        self._plan_seq_hint = 0  # last issued plan seq + 1, for snapshots
        # (layer, dest) pairs being range-salvaged after a source crash
        # (mode 3): their acks clear them; re-plans skip them.
        self._salvaging: Set[Tuple[LayerID, NodeID]] = set()
        self.replicator = (ControlReplicator(node, self.standbys)
                           if self.standbys else None)

        # Telemetry plane (docs/observability.md): the latest cumulative
        # MetricsReportMsg snapshot per node.  Replace-per-node fold (the
        # snapshots are run-scoped cumulative), replicated to standbys so
        # a takeover keeps the cluster picture; the leader's own process
        # metrics are read live from the registry at fold time.
        self.cluster_metrics: Dict[NodeID, dict] = {}
        # Live fleet health timeline (docs/observability.md): per-
        # interval deltas of those cumulative snapshots — per-link
        # throughput/stall/NACK series + first-class straggler events,
        # derived at every report fold, replicated so a promoted
        # standby keeps the event history.
        self.health = telemetry.HealthTimeline()
        # Closed-loop autonomy (docs/autonomy.md): the policy engine —
        # declarative rules over the folded signals, acting through the
        # SAME chokepoints the CLI verbs use.  Unarmed (no rules) it is
        # inert; the CLI arms it from the config's Policies block.  Its
        # state REPLACE-replicates (kind "policy" + snapshot section)
        # so a promoted standby inherits armed rules, cooldowns, and
        # in-flight actions.
        self.policy = PolicyEngine(self)

        if integrity.digests_enabled():
            threading.Thread(target=self._compute_own_digests,
                             name="layer-digests", daemon=True).start()
        else:
            self._digests_ready.set()

        # The leader's own layers seed its status row (node.go:251-257);
        # carry sizes so the flow solver can size any layer from status.
        self.status[node.my_id] = {
            lid: LayerMeta(
                location=src.meta.location,
                limit_rate=src.meta.limit_rate,
                source_type=src.meta.source_type,
                data_size=src.data_size,
                version=src.meta.version,
                codec=src.meta.codec,
            )
            for lid, src in self.layers.items()
        }

        self._shared_loop = loop is not None
        self.loop = loop if loop is not None else MessageLoop(node.transport)
        self._register_handlers()
        if start_loop:
            self.loop.start()
            self.detector.start()
            self.start_ha()
            if self._spmd:
                threading.Thread(target=self._plan_watchdog,
                                 name="plan-watchdog", daemon=True).start()

    # How many broadcast plans the leader retains for gap re-sends; a
    # goal's plan count is bounded by its (layer, dest) pairs, so this
    # comfortably covers any in-flight window while bounding memory.
    SENT_PLAN_RETENTION = 4096
    # Watchdog knobs (class attrs: tests tune them): how long an SPMD
    # plan may sit unacked before a re-broadcast, how often to check,
    # and how many re-broadcasts before the seq is cancelled.
    PLAN_ACK_TIMEOUT = 60.0
    PLAN_WATCH_PERIOD = 5.0
    PLAN_REBROADCASTS = 3

    def _plan_watchdog(self) -> None:
        """Tail-gap liveness (the receiver-side gap report's blind
        spot): re-broadcast unacked SPMD plans on a timer.

        The give-up CANCEL is crash-gated: a
        cancel advances processes that never entered the seq's
        collective — but peers already blocked INSIDE it (they received
        the plan; some other participant didn't, or the dest is merely
        slow) cannot be recalled, so a cancel fired while the dest is
        still alive would desynchronize the lockstep: the gap process
        skips the seq while its peers sit in the collective waiting for
        it.  So past the retry budget the watchdog only keeps
        re-broadcasting (duplicate deliveries are free — the executor
        returns the settled/pending handle for any seq it already saw)
        until the failure detector declares a participant crashed and
        ``crash()`` disables the fabric; ``crash()`` then cancels every
        still-watched seq so gap processes stop waiting on plans that
        can no longer execute.  See docs/fabric.md ("Failure domain and
        the cancel wedge")."""
        while not self._watch_stop.wait(self.PLAN_WATCH_PERIOD):
            now = time.monotonic()
            due = []
            with self._lock:
                fabric_down = self._fabric_disabled
                for seq, rec in list(self._plan_watch.items()):
                    if now - rec["t"] < self.PLAN_ACK_TIMEOUT:
                        continue
                    msg = self._sent_plans.get(seq)
                    if msg is None:
                        del self._plan_watch[seq]
                        continue
                    if rec["retries"] >= self.PLAN_REBROADCASTS:
                        if fabric_down:
                            # Crash declared: safe (and necessary) to
                            # advance the gap processes past the seq.
                            del self._plan_watch[seq]
                            due.append((seq, msg, True))
                        else:
                            # Dest alive (no crash declared): a cancel
                            # here could strand peers inside the
                            # collective.  Keep re-broadcasting at the
                            # ack-timeout cadence instead.
                            rec["t"] = now
                            due.append((seq, msg, False))
                    else:
                        rec["retries"] += 1
                        rec["t"] = now
                        due.append((seq, msg, False))
                recipients = sorted(set(self.status)
                                    | {self.node.my_id})
            for seq, msg, give_up in due:
                if give_up:
                    log.error("spmd plan unacked and fabric disabled; "
                              "cancelling seq (dest re-announce will "
                              "re-plan the bytes)", seq=seq,
                              plan=msg.plan_id)
                    out = self._make_plan_cancel(seq, msg)
                else:
                    log.warn("re-broadcasting unacked spmd plan",
                             seq=seq, plan=msg.plan_id)
                    out = msg
                self._send_plan_to(out, set(recipients) | {msg.dest_id},
                                   seq)

    def _make_plan_cancel(self, seq: int, msg: DevicePlanMsg) -> DevicePlanMsg:
        """Build (and retain for gap re-sends) the cancellation that
        supersedes ``seq``."""
        cancel = DevicePlanMsg(self.node.my_id, msg.plan_id,
                               msg.layer_id, msg.dest_id, 0, [], seq=seq,
                               epoch=self.epoch)
        with self._lock:
            self._sent_plans[seq] = cancel
        return cancel

    def _send_plan_to(self, out: DevicePlanMsg, recipients, seq: int) -> None:
        for r in sorted(recipients):
            try:
                self.node.transport.send(r, out)
            except (OSError, KeyError) as e:
                log.error("plan watchdog send failed", seq=seq,
                          dest=r, err=repr(e))

    def _register_handlers(self) -> None:
        # A PROMOTED leader shares the worker's already-running loop:
        # register-keep fills the control-plane gaps (announce / ack /
        # heartbeat / ...) without clobbering the worker's data-plane
        # handlers (layer reassembly, flow jobs, NACK service).
        reg = (self.loop.register_keep if self._shared_loop
               else self.loop.register)
        reg(AnnounceMsg, self.handle_announce)
        reg(AckMsg, self.handle_ack)
        reg(LayerMsg, self.handle_layer)
        reg(HeartbeatMsg, lambda msg: self.detector.touch(msg.src_id))
        reg(BootReadyMsg, self.handle_boot_ready)
        reg(DevicePlanMsg, self.handle_device_plan)
        reg(GenerateReqMsg, self.handle_generate_req)
        reg(PlanResendReqMsg, self.handle_plan_resend)
        reg(LayerNackMsg, self.handle_layer_nack)
        reg(LeaderLeaseMsg, self.handle_leader_lease)
        reg(MetricsReportMsg, self.handle_metrics_report)
        reg(TimeSyncMsg, self.handle_time_sync)
        reg(JobSubmitMsg, self.handle_job_submit)
        reg(JobStatusMsg, self.handle_job_status)
        reg(SwapCommitMsg, self.handle_swap_commit)
        reg(JoinMsg, self.handle_join)
        reg(DrainMsg, self.handle_drain)
        reg(RolloutCtlMsg, self.handle_rollout_ctl)
        reg(PolicyCtlMsg, self.handle_policy_ctl)

    # --------------------------------------------------- control-plane HA

    def start_ha(self) -> None:
        """Begin beaconing the leadership lease (no-op when HA is off).
        The first beat goes out immediately — for a promoted standby it
        IS the takeover announcement."""
        if self.lease_interval > 0 and self.epoch >= 0:
            threading.Thread(target=self._lease_loop, name="leader-lease",
                             daemon=True).start()

    def _lease_loop(self) -> None:
        while True:
            self._broadcast_lease()
            if self._lease_stop.wait(self.lease_interval):
                return

    def _lease_recipients_locked(self) -> Set[NodeID]:
        """Who hears the leadership beacon.  Lock held.  The
        hierarchical leader narrows this to sub-leaders + ungrouped
        seats: a grouped member's control parent is its SUB-LEADER, and
        a root lease reaching it would re-point it flat
        (docs/hierarchy.md)."""
        return (set(self.status) | set(self.standbys)
                | self.expected_nodes | set(self.assignment))

    def _broadcast_lease(self) -> None:
        with self._lock:
            if self._deposed:
                return
            recipients = self._lease_recipients_locked()
            recipients.discard(self.node.my_id)
        msg = LeaderLeaseMsg(self.node.my_id, self.epoch,
                             list(self.standbys), self.lease_interval)
        for r in sorted(recipients):
            self._lease_send_async(r, msg)

    def _lease_send_async(self, dest: NodeID, msg: LeaderLeaseMsg) -> None:
        """One NON-BLOCKING lease send per recipient, at most one in
        flight each: a dead peer's TCP dial-retry window (seconds) must
        not stall the single beacon thread past the standbys' expiry —
        that would fake the leader's own death to every LIVE observer
        and trigger a spurious (if benign) takeover."""
        with self._lock:
            if dest in self._lease_inflight:
                return  # previous beat to this peer still dialing
            self._lease_inflight.add(dest)

        def run():
            try:
                self.node.add_node(dest)
                self.node.transport.send(dest, msg)
            except (OSError, KeyError) as e:
                log.debug("lease send failed", dest=dest, err=repr(e))
            finally:
                with self._lock:
                    self._lease_inflight.discard(dest)

        threading.Thread(target=run, daemon=True,
                         name=f"lease-{dest}").start()

    def handle_leader_lease(self, msg: LeaderLeaseMsg) -> None:
        """A lease from ANOTHER leader at a higher epoch means a standby
        took over while this process was presumed dead: step down.  Our
        stale-epoch control traffic is already fenced cluster-wide; the
        step-down just stops this zombie from burning the wire and from
        declaring live nodes crashed.  EQUAL epochs (two standbys fired
        concurrently — pathological, but rank staggering is not
        consensus) break deterministically: the LOWER node id keeps the
        seat, the other deposes."""
        if msg.src_id == self.node.my_id:
            return
        if msg.epoch < self.epoch or (msg.epoch == self.epoch
                                      and msg.src_id > self.node.my_id):
            return
        with self._lock:
            if self._deposed:
                return
            self._deposed = True
        trace.count("failover.deposed")
        log.error("a higher-epoch leader exists; stepping down",
                  new_leader=msg.src_id, new_epoch=msg.epoch,
                  my_epoch=self.epoch)
        self._lease_stop.set()
        self.detector.stop()

    def _replicate(self, kind: str, **data) -> None:
        """Stream one control-state mutation to the standbys (no-op when
        HA is off).  Best-effort: takeover reconciliation repairs any
        divergence — replication buys recovery SPEED, not correctness."""
        rep = self.replicator
        if rep is not None and self.epoch >= 0:
            rep.publish(self.epoch, kind, data)

    def _snapshot_payload(self) -> dict:
        # Health snapshot BEFORE the leader lock: HealthTimeline.observe
        # calls back into _modeled_link_rate (health lock → leader
        # lock), so taking the health lock while holding the leader's
        # would be a lock-order inversion.
        health = self.health.snapshot()
        # Same discipline for the autonomy engine (docs/autonomy.md):
        # PolicyEngine._lock is leaf-most, so its state is folded
        # before the leader lock is taken.
        policy = self.policy.to_json()
        with self._lock:
            return {
                # Fleet health timeline (docs/observability.md): the
                # event ring + series tail — a promoted standby keeps
                # the straggler history with onset timestamps.
                "Health": health,
                # Autonomy engine (docs/autonomy.md): armed rules,
                # cooldowns (as remaining seconds), quarantine mask and
                # in-flight actions — a promoted standby inherits the
                # closed loop mid-action instead of re-deciding cold.
                "Policy": policy,
                "PlanGen": int(getattr(self, "_plan_gen", 0)),
                "Mode": self.MODE,
                "Assignment": _nested_layer_map_to_json(self.assignment),
                "BaseAssignment": _nested_layer_map_to_json(
                    self._base_assignment),
                # The admitted-job table (docs/service.md): a promoted
                # standby resumes EVERY job, not just one run.
                "Jobs": self.jobs.to_json(),
                # Live-swap driver records (docs/swap.md): a promoted
                # standby resumes a half-finished rollout's fence.
                "Swaps": {v: self._swap_record_locked(v)
                          for v in sorted(self._swaps)},
                # Rollout pipeline records (docs/rollout.md): a
                # promoted standby resumes the pipeline MID-WAVE with
                # the SLO guard still armed.
                "Rollouts": self.rollouts.to_json(),
                "Status": _nested_layer_map_to_json(self.status),
                "Partial": _partial_to_json(self.partial_status),
                "Dropped": _nested_layer_map_to_json(
                    self._dropped_assignment),
                "Digests": {str(l): d
                            for l, d in self.layer_digests.items()},
                # Wire-codec plane (docs/codec.md): the per-pair codec
                # choices and node capabilities — a promoted leader
                # must keep planning the SAME byte spaces mid-transfer
                # partials live in.
                "WireCodecs": {f"{d}:{l}": c for (d, l), c
                               in self._codec_choice.items() if c},
                "NodeCodecs": {str(n): sorted(s)
                               for n, s in self.node_codecs.items()},
                # Elastic membership (docs/membership.md): the roster +
                # in-flight drain re-home jobs — a promoted standby
                # resumes admission and drains, and keeps departed
                # members fenced.
                "Membership": self.membership.to_json(),
                "DrainJobs": {jid: int(n) for jid, n in
                              sorted(self._drain_jobs.items())},
                "PlanSeq": self._plan_seq_hint,
                "StartupSent": self._startup_sent,
                "NetworkBw": {str(n): b for n, b in getattr(
                    self, "node_network_bw", {}).items()},
                "FailureTimeout": self.detector._timeout,
                "BootEnabled": self.boot_enabled,
                # Private bookkeeping ("_recv_mono": THIS process's
                # monotonic clock) must not cross the wire — a standby
                # restoring it would compare a foreign clock against
                # its own in await_metrics.
                "Metrics": {str(n): {k: v for k, v in s.items()
                                     if not k.startswith("_")}
                            for n, s in self.cluster_metrics.items()},
                # Subclass sections (e.g. the hierarchical leader's
                # group table, docs/hierarchy.md).
                **self._snapshot_extra_locked(),
            }

    def _snapshot_extra_locked(self) -> dict:
        """Extra snapshot sections from subclasses.  Lock held."""
        return {}

    def _send_snapshot_to(self, standby: NodeID) -> None:
        if self.replicator is None or self.epoch < 0:
            return
        self.replicator.publish_to(standby, self.epoch, "snapshot",
                                   self._snapshot_payload())
        log.info("control snapshot sent to standby", standby=standby)

    def adopt_shadow(self, shadow: dict, dead_leader=None) -> None:
        """Assume a dead leader's replicated control state (the takeover
        half of ``runtime/failover.StandbyController``).  The dead
        leader's own status row is dropped — its in-RAM layers died with
        it; anything ONLY it held will surface as a loud "no owner"
        during re-planning, exactly like any other crashed holder."""
        with self._lock:
            own_row = {
                lid: LayerMeta(
                    location=src.meta.location,
                    limit_rate=src.meta.limit_rate,
                    source_type=src.meta.source_type,
                    data_size=src.data_size,
                    version=src.meta.version,
                    codec=src.meta.codec,
                )
                for lid, src in self.layers.items()
            }
            self.status = {n: dict(row)
                           for n, row in shadow["status"].items()
                           if n != dead_leader}
            self.status[self.node.my_id] = own_row
            self.assignment = {n: dict(r) for n, r in
                               shadow["assignment"].items()
                               if n != dead_leader}
            # Job plane (docs/service.md): restore the admitted-job
            # table and the base goal so EVERY job resumes, not just
            # the run.  The replicated merged assignment above already
            # carries the jobs' pairs; keeping it (rather than
            # re-merging) also survives lost best-effort job deltas.
            base = shadow.get("base_assignment")
            self._base_assignment = (
                {n: dict(r) for n, r in base.items() if n != dead_leader}
                if base is not None else self.assignment)
            self.jobs.load(shadow.get("jobs") or {})
            # Live-swap records (docs/swap.md): the promoted leader owns
            # every half-finished rollout's fence now.
            self._swaps = {}
            self._swaps_by_job = {}
            for v, rec in (shadow.get("swaps") or {}).items():
                r = {"version": str(rec.get("Version", v)),
                     "job_id": str(rec.get("JobID", "")),
                     "swap_base": int(rec.get("SwapBase", -1)),
                     "dests": [int(d) for d in rec.get("Dests") or []
                               if int(d) != dead_leader],
                     "state": str(rec.get("State", "rolling")),
                     "confirmed": {int(d) for d in
                                   rec.get("Confirmed") or []},
                     # Rollout-pipeline wave bookkeeping
                     # (docs/rollout.md), absent on plain swaps.
                     "hold": bool(rec.get("Hold", False)),
                     "staged": bool(rec.get("Staged", False)),
                     "rollout": str(rec.get("Rollout", "")),
                     "revert": bool(rec.get("Revert", False))}
                self._swaps[r["version"]] = r
                if r["job_id"]:
                    self._swaps_by_job[r["job_id"]] = r["version"]
            if dead_leader is not None:
                self.jobs.drop_dest(dead_leader)
            # Dests the DEAD leader declared crashed pre-takeover: the
            # "crash" delta recorded them in dropped, but the per-job
            # record re-replication may have been lost (best-effort) —
            # re-apply the drops so no adopted job waits on a dest the
            # cluster already wrote off.
            for node_id in list(shadow["dropped"]):
                self.jobs.drop_dest(node_id)
            self.partial_status = {n: dict(p) for n, p in
                                   shadow["partial"].items()}
            self._dropped_assignment = {n: dict(r) for n, r in
                                        shadow["dropped"].items()}
            for lid, dg in shadow["digests"].items():
                self.layer_digests.setdefault(lid, dg)
            # Wire-codec plane (docs/codec.md): adopt the dead leader's
            # codec choices and the cluster's capability table, so the
            # resumed plans keep the byte spaces in-flight partials are
            # accounted in (and the re-sent stamps carry the same
            # codec-qualified expectations).
            for key, c in (shadow.get("wire_codecs") or {}).items():
                self._codec_choice[key] = c
                if c:
                    self._codec_seen = True
                base = delta_base_digest(c)
                if base:
                    # Adopted delta pairs: re-pin the base per layer and
                    # re-point the plane's resolver at THIS seat's copy
                    # of the base bytes (reverse scan of its own digest
                    # table).  A seat that holds no such copy keeps the
                    # choice but can't encode — the digest-stamp path
                    # reverts those pairs to raw, loudly.
                    self._delta_base[key[1]] = base
                    if base not in self._delta_base_src:
                        for lid2, dg2 in self.layer_digests.items():
                            lay2 = self.layers.get(lid2)
                            if (dg2 == base and lay2 is not None
                                    and lay2.meta.location
                                    != LayerLocation.CLIENT):
                                self._delta_base_src[base] = lay2
                                break
            for n, caps in (shadow.get("node_codecs") or {}).items():
                if n != dead_leader:
                    self.node_codecs.setdefault(n, frozenset(caps))
            if self.codecs is None and self._codec_choice:
                # No codec plane here (a promoted seat without the
                # model): chosen pairs can't be sized or digest-stamped
                # in encoded space — revert them to raw, loudly.  The
                # re-sent stamp clears each dest's codec expectation
                # and its stale encoded partials demote for a clean raw
                # redelivery (docs/codec.md, honest limits).
                log.warn("adopted wire-codec choices without a codec "
                         "plane; reverting pairs to raw",
                         pairs=len(self._codec_choice))
                self._codec_choice = {
                    key: "" for key in self._codec_choice}
                for dest, lids in self.assignment.items():
                    for lid, meta in list(lids.items()):
                        if meta.codec:
                            lids[lid] = dataclasses.replace(meta, codec="")
            # The replicated telemetry picture survives the takeover:
            # the dead leader's fold is the starting table, and every
            # live node's next cumulative report simply replaces its row.
            self.cluster_metrics = {n: dict(s) for n, s in
                                    shadow.get("metrics", {}).items()}
            self._plan_seq = itertools.count(shadow["plan_seq"])
            self._plan_seq_hint = shadow["plan_seq"]
            self._started = True
            self._startup_sent = shadow["startup_sent"]
            self._t_start = time.monotonic()
            if self._spmd:
                # An epoch change breaks any presumed pod lockstep; the
                # rest of the run rides the host path.
                self._fabric_disabled = True
            peers = [n for n in self.status if n != self.node.my_id]
        # Rollout pipeline (docs/rollout.md): adopt the wave records so
        # the promoted leader resumes the pipeline mid-wave (the SLO
        # guard re-arms in resume_from_takeover).
        self.rollouts.load(shadow.get("rollouts") or {})
        # Fleet health timeline (docs/observability.md): adopt the dead
        # leader's event ring verbatim — straggler onset timestamps
        # survive the takeover; fresh interval deltas re-baseline from
        # the first post-takeover report round.
        self.health.ingest((shadow.get("health") or {}).get("events"))
        # Autonomy engine (docs/autonomy.md): inherit the armed rules,
        # cooldowns, quarantine mask and in-flight actions so the
        # promoted leader completes what the dead one started (policy
        # lock only — leaf-most, taken outside the leader lock).
        self.policy.load(shadow.get("policy") or {})
        if hasattr(self, "_plan_gen"):
            self._plan_gen = int(shadow.get("plan_gen") or 0)
        # Elastic membership (docs/membership.md): adopt the roster so
        # the promoted leader keeps departed members fenced, resumes
        # in-flight drains, and can dial adopted joiners (their
        # addresses rode the membership replication — they are in
        # nobody's config).
        self.membership.load(shadow.get("membership") or {})
        self.membership.seed(set(self.status) | set(self.assignment)
                             | {self.node.my_id}, epoch=self.epoch)
        if dead_leader is not None:
            self.membership.forget(dead_leader)
        with self._lock:
            self._drain_jobs = {str(j): int(n) for j, n in
                                (shadow.get("drain_jobs") or {}).items()}
        for n, addr in sorted(self.membership.addrs().items()):
            if n != self.node.my_id:
                self._install_member_addr(n, addr)
        for n in peers:
            if not self.membership.is_left(n):
                self.detector.touch(n)
        if dead_leader is not None:
            self.detector.forget(dead_leader)
        # Replicated job deltas are best-effort: reconcile remaining
        # pairs against the adopted status so a lost ack delta can't
        # strand a pair the cluster already shows delivered.
        with self._lock:
            status_view = {n: dict(r) for n, r in self.status.items()}
        for jid in self.jobs.credit_status(status_view):
            log.info("adopted job already complete per replicated status",
                     job=jid)

    def resume_from_takeover(self) -> None:
        """Re-drive delivery from the adopted shadow: finish immediately
        when the goal is already met, else run the mode's re-planner.
        Worker re-announces (triggered by the takeover lease) refine the
        picture as they arrive — each one re-plans incrementally via the
        existing re-announce machinery."""
        log.info("resuming distribution from replicated shadow state",
                 epoch=self.epoch,
                 dests=sorted(self.assignment),
                 partials=sorted(self.partial_status))
        self._resume_swaps()
        self.rollouts.resume_all()
        self._resume_drains()
        self._resume_joins()
        # Autonomy (docs/autonomy.md): re-apply inherited link
        # demotions and re-submit inherited in-flight actions whose
        # jobs did not survive the takeover — at the bumped epoch,
        # under the SAME action ids (no double-fire, no drop).
        self.policy.resume_from_takeover()
        with self._lock:
            already_done = self._startup_sent
        if already_done:
            # The dead leader finished delivery before dying (the
            # replicated ``startup`` delta says so): _maybe_finish will
            # never re-fire, so release this side's ready() waiters
            # directly — a completed goal must not read as a hang.
            log.info("takeover adopted a FINISHED distribution; "
                     "nothing to re-drive")
            self._ready_q.put(self.assignment)
            return
        self._drive(self._recover)

    def _resume_swaps(self) -> None:
        """Re-drive every adopted swap at the bumped epoch: committed
        fences re-send to unconfirmed nodes, aborted ones re-announce
        the release, and a rolling swap whose job the adopted status
        already shows complete fires its fence — otherwise the resumed
        job plane carries the rollout and the usual completion path
        commits (docs/swap.md)."""
        with self._lock:
            states = {v: rec["state"] for v, rec in self._swaps.items()}
        for version, state in sorted(states.items()):
            if state == "committed":
                log.warn("adopted a committed swap; re-driving its "
                         "fence at the new epoch", version=version)
                self._swap_send_round(version)
                threading.Thread(target=self._swap_watchdog,
                                 args=(version,), daemon=True,
                                 name=f"swap-fence-{version}").start()
            elif state == "aborted":
                self._swap_send_round(version)
            else:  # rolling
                with self._lock:
                    jid = self._swaps[version]["job_id"]
                job = self.jobs.get(jid)
                if job is not None and job.state == "done":
                    self._on_swap_job_done(jid)
                else:
                    log.info("adopted swap still rolling; the resumed "
                             "job plane carries it", version=version)

    # --------------------------------------------------------- integrity

    def handle_layer_nack(self, msg: LayerNackMsg) -> None:
        """A receiver's transport dropped a corrupt/abandoned fragment
        this leader sent: retransmit the byte range (bounded; in the
        transfer's own — possibly encoded — byte space)."""
        self.nacker.handle(self.node, self.layers, self._lock, msg,
                           codecs=self.codecs)

    def _compute_own_digests(self) -> None:
        """Hash the leader's own layers for the digest stamp (background
        — the announce wait overlaps it; _send_digests waits briefly)."""
        try:
            for lid, src in list(self.layers.items()):
                d = integrity.digest_layer_src(src)
                if d is None:
                    continue
                with self._lock:
                    prior = self.layer_digests.get(lid)
                    if (prior is not None and prior != d
                            and integrity.stamp_algo(prior)
                            == integrity.stamp_algo(d)):
                        # A holder's announce won the race against this
                        # background hash and disagrees: one copy is
                        # corrupt.  The leader's own digest wins — it
                        # was just computed from local bytes, and
                        # stamping the announcer's digest would let a
                        # rotted seeder's delivery VERIFY against its
                        # own rot.
                        trace.count("integrity.digest_conflict")
                        log.error("announced layer digest conflicts "
                                  "with the leader's own copy; a "
                                  "holder is corrupt (stamping the "
                                  "LEADER's digest)", layerID=lid,
                                  announced=prior, own=d)
                    self.layer_digests[lid] = d
        finally:
            self._digests_ready.set()

    def _merge_announced_digests(self, src_id, digests: dict) -> None:
        """Collect a holder's announced digests (first writer wins); a
        CONFLICT between two holders means one of them already holds
        corrupt bytes — loud, counted, and the first stamp stands."""
        if not digests:
            return
        with self._lock:
            for lid, d in digests.items():
                prior = self.layer_digests.get(lid)
                if prior is None:
                    self.layer_digests[lid] = d
                elif (prior != d and integrity.stamp_algo(prior)
                        == integrity.stamp_algo(d)):
                    trace.count("integrity.digest_conflict")
                    log.error("conflicting layer digest announced; a "
                              "holder's copy is corrupt (keeping the "
                              "first stamp)", layerID=lid, node=src_id,
                              stamped=prior, announced=d)

    def _send_digests(self) -> None:
        """Stamp each assignee with its layers' expected digests.  Waits
        (bounded, PRE-timer) for the leader's own background hash so the
        first stamp is complete; advisory — a dest without a digest for
        some layer simply skips end-to-end verification for it.

        Sharded targets ride the same stamp (docs/sharding.md) even
        with digests disabled: the shard SPEC is what tells a dest its
        interval set completes at shard coverage, so it must flow
        whenever any target is sub-layer."""
        if integrity.digests_enabled():
            self._digests_ready.wait(timeout=300.0)
        with self._lock:
            dests = self._digest_recipients_locked()
            digests = {str(l): d for l, d in self.layer_digests.items()}
        if digests:
            self._replicate("digests", Digests=digests)
        for dest in dests:
            self._send_digests_to(dest)

    def _digest_row_locked(self, dest: NodeID) -> dict:
        """The target metas the digest stamp to ``dest`` describes
        (lock held): the dest's assignment row — plus, in the
        hierarchical subclass, any synthetic group-ingress demand
        routed THROUGH the seat (docs/hierarchy.md), so a sub-leader
        ingesting a qualified (shard/codec/version) group form is
        stamped exactly like a direct dest."""
        return self.assignment.get(dest) or {}

    def _digest_recipients_locked(self) -> list:
        """Seats owed a digest stamp (lock held): every assignee — plus,
        in the hierarchical subclass, sub-leaders whose only demand is a
        synthetic group ingress (they'd otherwise verify nothing)."""
        return list(self.assignment)

    def _assigned_shards_locked(self, dest: NodeID) -> Dict[LayerID, str]:
        """Lock held.  The dest's sub-layer targets: {layer: spec}."""
        return {lid: meta.shard
                for lid, meta in self._digest_row_locked(dest).items()
                if meta.shard}

    def _range_digests_for(self, shards: Dict[LayerID, str],
                           codec_map: Optional[Dict[LayerID, str]] = None,
                           ) -> Dict[LayerID, str]:
        """Per-range digests for a dest's shard targets — the digest of
        exactly the target's byte range, so the shard verifies without
        the dest ever holding the full layer (docs/sharding.md).  Only
        computable for layers whose bytes this leader can read; absent
        entries verify by per-fragment CRC alone (honest limit).
        Cached per (layer, spec[, codec]): replans must not re-hash
        gigabytes.

        ``codec_map`` (docs/codec.md, docs/fabric.md): layers whose
        pair ships a wire codec hash the range of the ENCODED blob —
        shard x codec composes in encoded byte space, and the stamp
        must describe the bytes that actually cross the wire (this is
        what lets a quantized pod slice verify end-to-end)."""
        if not integrity.digests_enabled():
            return {}
        codec_map = codec_map or {}
        out: Dict[LayerID, str] = {}
        for lid, spec in shards.items():
            codec = codec_map.get(lid, "")
            key = (lid, _range_key(spec, codec))
            with self._lock:
                cached = self._range_digest_cache.get(key)
                layer = self.layers.get(lid)
            if cached is not None:
                out[lid] = cached
                continue
            if layer is None or layer.meta.shard:
                continue  # unreadable here (or leader holds a shard only)
            if codec:
                if self.codecs is None:
                    continue  # CRC-only verify (honest limit)
                enc = self.codecs.encoded_src(lid, layer, codec)
                if enc is None:
                    continue
                off, size = shard_range(spec, enc.data_size)
                d = integrity.digest_layer_src_range(enc, off, size)
            else:
                off, size = shard_range(spec, layer.data_size)
                d = integrity.digest_layer_src_range(layer, off, size)
            if d is None:
                continue
            with self._lock:
                self._range_digest_cache[key] = d
            out[lid] = d
        return out

    # ------------------------------------------------- wire-codec choice

    # Whether this scheduler supports negotiated wire codecs.  Mode 2's
    # pull/steal tables pick senders per-layer with no per-pair codec
    # admissibility, so it opts out (docs/codec.md, honest limits).
    WIRE_CODEC_OK = True

    def _node_bw(self, node_id: NodeID) -> int:
        """The node's modeled NIC rate for the codec-choice bottleneck
        estimate; 0 = unknown/unlimited.  Only mode 3 models NICs."""
        return 0

    def _pair_rate_locked(self, dest: NodeID, lid: LayerID,
                          want) -> int:
        """Lock held.  The (dest, layer) pair's modeled bottleneck rate
        (bytes/s): the best raw holder's source rate, capped by the
        dest's NIC.  0 = effectively unlimited (or unknown) — such a
        pair ships raw; only provably-slow links pay the encode/decode
        pass (docs/codec.md)."""
        inf = 1 << 62
        best = 0
        for node_id, row in self.status.items():
            m = row.get(lid)
            if m is None or m.location == LayerLocation.CLIENT:
                continue
            if m.shard or getattr(m, "codec", ""):
                continue  # rate-model raw full holders only
            r = m.limit_rate if m.limit_rate > 0 else (
                self._node_bw(node_id) or inf)
            best = max(best, r)
        if best == 0:
            return 0  # no raw holder visible: stay raw
        rate = min(best, self._node_bw(dest) or inf)
        return 0 if rate >= inf else rate

    def _decide_codec_locked(self, dest: NodeID, lid: LayerID,
                             meta) -> str:
        """Lock held.  The wire codec this (dest, layer) transfer
        ships under ("" = canonical): the run's configured codec, IFF
        the scheduler supports it, the dest advertised decode, the blob
        has a codec layout, the pair is unsharded/unversioned (honest
        limits: range digests hash raw ranges, and swap staging is
        untested against re-encoded forms), and the pair's modeled
        bottleneck is at or below the threshold — fast links ship raw.

        Content-delta (docs/codec.md) is tried FIRST: when the dest
        provably holds a verified base and the encoded (v2 − base) is
        small, the pair ships ``delta:<base>`` — an order-of-magnitude
        byte win whole-form quantization can't reach — and version-
        qualified rollout pairs are eligible (the wave's whole point)."""
        plane = self.codecs
        if plane is None or not self.WIRE_CODEC_OK:
            return ""
        target = self.layer_digests.get(lid)
        if (target and self.jobs.owner_of(dest, lid) is not None
                and self.content.node_has(dest, target)):
            # The dest already holds content-equal bytes and the job
            # plane's resolve path exists for this pair: the content
            # store acks it for ZERO wire bytes (_content_skip_locked,
            # which refuses codec-stamped targets) — any encoded form,
            # even a near-empty delta, would ship bytes a skip doesn't.
            return ""
        delta = self._decide_delta_locked(dest, lid, meta)
        if delta:
            return delta
        if not plane.enabled:
            return ""
        if meta.shard or meta.version:
            return ""
        c = plane.wire_codec
        if c not in self.node_codecs.get(dest, ()):
            return ""
        own = self.layers.get(lid)
        if own is not None and own.meta.location == LayerLocation.CLIENT:
            # The leader's own copy is client-held: modes 0-2 would
            # pipe-fetch RAW bytes under an encoded stamp (the client
            # stream can't encode) — keep the pair canonical.
            return ""
        if plane.nbytes(lid, c) is None:
            # Entropy forms are data-dependent: size them by actually
            # encoding the leader's own copy once (cached).  A pair
            # nobody here can size must not ship the form.
            if own is None or plane.ensure_sized(lid, own, c) is None:
                return ""
        rate = self._pair_rate_locked(dest, lid, meta)
        if rate <= 0 or rate > plane.min_rate_for(c):
            return ""
        return c

    def _decide_delta_locked(self, dest: NodeID, lid: LayerID,
                             meta) -> str:
        """Lock held.  The content-delta choice for this pair ("" = no
        delta): requires the integrity plane (reconstruction verifies
        against the stamped full-form digest — without it a stale base
        would poison the layer silently), a dest that announced the
        generic "delta" capability and PROVABLY holds the base
        (ContentIndex), a leader-readable raw canonical copy, a link
        slow enough that the encode pays, and an encoded delta that
        actually survived the worth-it gate (docs/codec.md)."""
        plane = self.codecs
        if plane is None or not plane.delta_enabled:
            return ""
        if not integrity.digests_enabled():
            return ""
        if meta.shard:
            # Honest limit: a pre-sharded target acks (and holds) its
            # range only — it can never reconstruct the full layer from
            # a slice of the delta stream.  Multi-source striping of a
            # FULL delta pair still shards fine (ranges of one blob).
            return ""
        if "delta" not in self.node_codecs.get(dest, ()):
            return ""
        if getattr(self, "_pod_of", {}).get(dest) is not None:
            # Honest limit: pod gathers assume a pod-uniform byte space;
            # per-dest bases would de-uniform the gather (docs/fabric.md).
            return ""
        own = self.layers.get(lid)
        if (own is None
                or own.meta.location == LayerLocation.CLIENT
                or own.meta.shard or getattr(own.meta, "codec", "")):
            return ""
        target = self.layer_digests.get(lid)
        if not target:
            return ""
        rate = self._pair_rate_locked(dest, lid, meta)
        if rate <= 0 or rate > plane.delta_min_rate:
            return ""
        base = self._delta_base.get(lid)
        if base is None:
            base = self._pick_delta_base_locked(lid, own)
            self._delta_base[lid] = base
        if not base or base == target:
            return ""
        if not self.content.node_has(dest, base):
            return ""
        codec = "delta:" + base
        if plane.ensure_sized(lid, own, codec) is None:
            return ""
        trace.count("codec.delta_pairs_chosen")
        return codec

    def _pick_delta_base_locked(self, lid: LayerID, own) -> str:
        """Lock held; runs once per layer (memoized by the caller, ""
        pins "no base").  Candidate bases are the leader's OWN verified
        raw full layers of the same byte length (the only bytes it can
        encode against); they're ranked by strided-sample XOR sparsity
        — cheap, no full encode per candidate — and only the winner is
        fully encoded.  A delta that fails to at least halve the raw
        bytes pins "": a rollout whose v2 actually changed everything
        must ship whole forms, not a delta dressed up as one."""
        plane = self.codecs
        try:
            raw = own.read_range()
        except (OSError, ValueError) as e:
            log.warn("delta base pick: target layer unreadable",
                     layerID=lid, err=repr(e))
            return ""
        target = self.layer_digests.get(lid, "")
        candidates: Dict[str, LayerSrc] = {}
        for other_lid, digest in self.layer_digests.items():
            if other_lid == lid or not digest or digest == target:
                continue
            if digest in candidates:
                continue
            layer = self.layers.get(other_lid)
            if (layer is None
                    or layer.meta.location == LayerLocation.CLIENT
                    or layer.meta.shard
                    or getattr(layer.meta, "codec", "")
                    or layer.data_size != len(raw)):
                continue
            candidates[digest] = layer
        if not candidates:
            return ""
        import numpy as np

        tgt = np.frombuffer(raw, dtype=np.uint8)[::257]
        scored: List[Tuple[float, str]] = []
        for digest, layer in candidates.items():
            try:
                cand = layer.read_range()
            except (OSError, ValueError):
                continue
            s = np.frombuffer(cand, dtype=np.uint8)[::257]
            frac = float(np.count_nonzero(tgt != s)) / max(1, tgt.size)
            scored.append((frac, digest))
        if not scored:
            return ""
        frac, base = min(scored)
        base_layer = candidates[base]
        # The resolver map must carry the base BEFORE the sizing encode
        # (the plane resolves it mid-encode, lock-free).
        self._delta_base_src[base] = base_layer
        sized = plane.ensure_sized(lid, own, "delta:" + base)
        if sized is None or sized * 2 >= len(raw):
            log.info("delta base rejected (encoded form not worth it)",
                     layerID=lid, base=base,
                     encoded=sized, raw_bytes=len(raw),
                     sampled_diff_frac=round(frac, 4))
            return ""
        log.info("delta base pinned for layer", layerID=lid, base=base,
                 encoded=sized, raw_bytes=len(raw),
                 sampled_diff_frac=round(frac, 4))
        return base

    def _stamp_codecs(self) -> None:
        """Choose (memoized) and stamp the wire codec onto every
        assignment target meta — called before digest stamping and
        before every plan, so re-merges (update/submit_job rebuild the
        merged goal codec-less) re-apply the stable choices.  Choices
        replicate to standbys: a promoted leader must keep planning the
        SAME byte spaces mid-transfer partials live in."""
        if self.codecs is None and not self._codec_choice:
            return
        changed = False
        with self._lock:
            for dest, lids in self.assignment.items():
                for lid, meta in lids.items():
                    key = (dest, lid)
                    choice = self._codec_choice.get(key)
                    if choice is None:
                        choice = self._decide_codec_locked(dest, lid, meta)
                        self._codec_choice[key] = choice
                        if choice:
                            changed = True
                            self._codec_seen = True
                            trace.count("codec.pairs_chosen")
                            log.info("wire codec chosen for slow pair",
                                     dest=dest, layerID=lid, codec=choice)
                    if meta.codec != choice:
                        lids[lid] = dataclasses.replace(meta, codec=choice)
            choices = dict(self._codec_choice)
        # Job targets must carry the same choices or quantized acks
        # would never credit their pairs (sched/jobs.apply_codecs).
        # Skipped while no pair was ever chosen (the common case) so
        # replan ticks don't rescan every job for nothing; individual
        # reverts apply their "" directly (_revert_codec_choice).
        if any(choices.values()):
            self.jobs.apply_codecs(
                {(d, l): c for (d, l), c in choices.items()})
        if changed:
            self._replicate_codecs()

    def _stamp_targets(self) -> None:
        """Pre-plan target stamping, in dependency order: the wire-codec
        choice first (it refuses sharded metas, and a pod slice must
        inherit the pair's codec), then the pod-delivery shard split
        (docs/fabric.md) over the codec-stamped metas."""
        self._stamp_codecs()
        self._stamp_pod_shards()

    def _stamp_pod_shards(self) -> None:
        """Hook: rewrite pod members' full targets into per-host shard
        slices (fabric-assisted pod delivery).  Only the mode-3 flow
        scheduler implements it; every other mode plans pods flat."""

    def _pods_open_locked(self) -> bool:
        """Lock held.  Whether any pod pair still owes its FULL
        materialized tree (the goal must not finish on shard coverage
        alone).  Base schedulers never pod-plan."""
        return False

    def _on_pod_ack(self, dest: NodeID, layer_id: LayerID, shard: str,
                    codec: str) -> None:
        """Hook: an ack landed for a pod-delivery pair (mode 3 drives
        the SPMD gather dispatch / completion accounting from here)."""

    def _pods_member_gone(self, node: NodeID) -> None:
        """Hook: a pod member crashed or departed — its pods' unfinished
        pairs must degrade to the host path (mode 3 only)."""

    def _replicate_codecs(self) -> None:
        with self._lock:
            choices = {f"{d}:{l}": c
                       for (d, l), c in self._codec_choice.items() if c}
            caps = {str(n): sorted(s)
                    for n, s in self.node_codecs.items()}
        self._replicate("codecs", Choices=choices, NodeCodecs=caps)

    def _codec_digest(self, lid: LayerID, codec: str) -> Optional[str]:
        """The codec-qualified digest stamped for a quantized pair —
        the hash of exactly the encoded bytes (cached; replans must not
        re-encode/re-hash).  None when this leader can't produce it."""
        key = (lid, codec)
        with self._lock:
            cached = self._codec_digest_cache.get(key)
            layer = self.layers.get(lid)
        if cached is not None:
            return cached
        if self.codecs is None or layer is None:
            return None
        d = self.codecs.encoded_digest(lid, layer, codec)
        if d is not None:
            with self._lock:
                self._codec_digest_cache[key] = d
        return d

    def _revert_codec_choice(self, dest: NodeID, lid: LayerID) -> None:
        """A chosen codec turned out unstampable (encode failed): the
        pair reverts to canonical, loudly, and the memo pins the
        reversion so replans don't flap."""
        log.warn("wire codec reverted to raw for pair (encoded digest "
                 "unavailable)", dest=dest, layerID=lid)
        with self._lock:
            self._codec_choice[(dest, lid)] = ""
            row = self.assignment.get(dest)
            if row is not None and lid in row:
                row[lid] = dataclasses.replace(row[lid], codec="")
            pod_pair = (lid, dest) in self._pod_pairs
        self.jobs.apply_codecs({(dest, lid): ""})
        if pod_pair:
            # The revert de-uniforms the pod's wire byte space for this
            # layer (docs/fabric.md: one gather = one encoding) —
            # degrade the (layer, pod) to host path instead of letting
            # the watchdog discover a gather that can never verify.
            pid = self._pod_of.get(dest)
            if pid is not None:
                log.warn("codec revert de-uniforms a pod layer; "
                         "degrading to host path", layerID=lid, pod=pid)
                self._degrade_pod_layer(lid, pid)

    def _send_digests_to(self, dest: NodeID) -> None:
        if dest == self.node.my_id:
            return
        with self._lock:
            digests = ({lid: self.layer_digests[lid]
                        for lid in self._digest_row_locked(dest)
                        if lid in self.layer_digests}
                       if integrity.digests_enabled() else {})
            shards = self._assigned_shards_locked(dest)
            # Versioned rollout targets (docs/swap.md): the stamp is
            # the one leader→dest channel preceding the bytes, so the
            # dest's holdings and acks carry the version tag.
            versions = {lid: meta.version
                        for lid, meta in
                        self._digest_row_locked(dest).items()
                        if meta.version}
            # Sticky: once ANY sharded target or shard holding exists,
            # later stamps must keep carrying the dest's target picture
            # even after widening removed the specs.
            self._sharding_seen = (
                self._sharding_seen or bool(shards)
                or any(m.shard for row in self.status.values()
                       for m in row.values()))
            if self._sharding_seen and not integrity.digests_enabled():
                # With digests OFF the shards map is the ONLY channel
                # that can tell a dest its target reverted to the full
                # layer (the digest-keyed widen detection has nothing
                # to iterate): explicit "" entries carry the reconcile.
                for lid in self._digest_row_locked(dest):
                    shards.setdefault(lid, "")
            # Wire-codec transfers (docs/codec.md): the chosen codec
            # per assigned layer rides the stamp — the one leader→dest
            # channel preceding the bytes — so the dest accounts the
            # transfer in encoded byte space from the first fragment.
            codec_map = {lid: meta.codec
                         for lid, meta in
                         self._digest_row_locked(dest).items()
                         if meta.codec}
            if self._codec_seen and not integrity.digests_enabled():
                # With digests OFF the codec map is the ONLY channel
                # that can tell a dest a pair REVERTED to raw (with
                # digests on, the pair's digest entry carries the
                # reconcile): explicit "" entries clear the dest's
                # stale codec expectation — same sticky-"" discipline
                # as the shards map above.
                for lid in self._digest_row_locked(dest):
                    codec_map.setdefault(lid, "")
        full_digests: Dict[LayerID, str] = {}
        if integrity.digests_enabled():
            # For codec pairs the stamped digest is CODEC-QUALIFIED:
            # the hash of exactly the encoded bytes — the CANONICAL
            # digest must never reach the dest for them (encoded bytes
            # would "fail" it forever).  Three cases, mirroring the
            # sharded range-digest policy (docs/sharding.md):
            # leader-readable layers stamp the encoded digest; a
            # readable layer that REFUSES to encode (not a model blob)
            # reverts the pair to raw; a holder-only layer keeps the
            # codec and stamps NO digest — the transfer verifies by
            # per-fragment CRC alone (docs/codec.md, honest limits;
            # the seeders' deterministic encode keeps multi-sender
            # ranges byte-identical).  Delta pairs additionally stamp
            # the CANONICAL digest under FullDigests: the wire stream
            # verifies under its own identity, the RECONSTRUCTED bytes
            # under the canonical one — both gates must pass before ack.
            bad = []
            for lid, c in sorted(codec_map.items()):
                d = self._codec_digest(lid, c)
                if d is not None:
                    digests[lid] = d
                    if delta_base_digest(c):
                        with self._lock:
                            full = self.layer_digests.get(lid)
                        if full:
                            full_digests[lid] = full
                        else:
                            # No canonical identity for the reconstructed
                            # form: the delta cannot gate — revert.
                            self._revert_codec_choice(dest, lid)
                            bad.append(lid)
                            digests.pop(lid, None)
                    continue
                with self._lock:
                    readable = (
                        self.layers.get(lid) is not None
                        and self.layers[lid].meta.location
                        != LayerLocation.CLIENT)
                if readable:
                    self._revert_codec_choice(dest, lid)
                    bad.append(lid)
                else:
                    digests.pop(lid, None)
                    log.info("codec pair stamped without a digest "
                             "(holder-only layer; CRC-only verify)",
                             dest=dest, layerID=lid, codec=c)
            for lid in bad:
                codec_map.pop(lid, None)
        # Fabric-assisted pod delivery (docs/fabric.md): the dest's pod
        # pairs ride the stamp as {layer: pod width} — the channel that
        # tells it to feed its verified shard into the on-mesh
        # reconstruction and ack the FULL tree, not stop at the shard.
        # Pods whose EVERY member already materialized are omitted: a
        # re-stamp (job admission, update) must not re-trigger
        # publish/gather rounds in the steady state.
        with self._lock:
            pods = {}
            pod_of = getattr(self, "_pod_of", {})
            pod_members = getattr(self, "pods", {})
            for (lid, d2), spec in self._pod_pairs.items():
                if d2 != dest:
                    continue
                want = (self.assignment.get(dest) or {}).get(lid)
                if want is None or want.shard != spec:
                    continue
                pid = pod_of.get(dest)
                members = (pod_members.get(pid, ())
                           if pid is not None else ())
                done = bool(members)
                for m in members:
                    if (lid, m) not in self._pod_pairs:
                        continue
                    held = self.status.get(m, {}).get(lid)
                    w = (self.assignment.get(m) or {}).get(lid)
                    if (held is None or not delivered(held) or held.shard
                            or (w is not None and not codec_accepts(
                                held.codec, w.codec))):
                        done = False
                        break
                if not done:
                    pods[lid] = parse_shard_spec(spec)[0]
        if (not digests and not shards and not versions and not codec_map
                and not pods):
            return
        try:
            self.node.transport.send(
                dest, LayerDigestsMsg(
                    self.node.my_id, digests, epoch=self.epoch,
                    shards=shards,
                    range_digests=self._range_digests_for(shards,
                                                          codec_map),
                    versions=versions, codecs=codec_map, pods=pods,
                    full_digests=full_digests))
        except (OSError, KeyError) as e:
            log.warn("digest stamp send failed", dest=dest, err=repr(e))

    # ------------------------------------------------------ telemetry plane

    def handle_time_sync(self, msg: TimeSyncMsg) -> None:
        """Answer a node's clock probe with this leader's wall clock —
        the reference clock multi-host traces align on (docs/
        observability.md).  Replies (another seat answering a probe this
        leader never sent) are ignored."""
        if msg.reply:
            return
        try:
            self.node.transport.send(
                msg.src_id,
                TimeSyncMsg(self.node.my_id, msg.t0_ms,
                            t1_ms=time.time() * 1000.0, reply=True))
        except (OSError, KeyError) as e:
            log.debug("time-sync reply send failed", dest=msg.src_id,
                      err=repr(e))

    def handle_metrics_report(self, msg: MetricsReportMsg) -> None:
        """Fold one node's cumulative telemetry snapshot into the
        cluster table.  Epoch-fenced: a reporter still pointing at a
        dead predecessor (its epoch is below this leader's) is stale
        by definition — its next lease observation re-points it and the
        following report carries the same cumulative totals, so nothing
        is lost by dropping the stale one."""
        if 0 <= msg.epoch < self.epoch:
            trace.count("telemetry.fenced_report")
            return
        snap = {"counters": msg.counters, "gauges": msg.gauges,
                "links": msg.links, "hists": msg.hists,
                "spans": msg.spans,
                "t_wall_ms": msg.t_wall_ms,
                "proc": msg.proc, "_recv_mono": time.monotonic()}
        with self._lock:
            self.cluster_metrics[msg.src_id] = snap
        self._replicate("metrics", Node=msg.src_id,
                        Counters=msg.counters, Gauges=msg.gauges,
                        Links=msg.links, Hists=msg.hists,
                        Spans=msg.spans,
                        T=msg.t_wall_ms, Proc=msg.proc)
        events = self._health_observe(msg.src_id, snap, foreign=msg.health)
        # Closed-loop autonomy (docs/autonomy.md): every metrics
        # interval IS the policy evaluation tick — the engine senses
        # the folded serve signals + the NEW health events and drives
        # the leader's own chokepoints.  Unarmed engines return
        # immediately.
        self.policy.tick(msg.src_id, snap, events)

    def _health_observe(self, node_id: NodeID, snap: dict,
                        foreign=None) -> List[dict]:
        """Fold one report into the fleet health timeline (docs/
        observability.md): interval deltas + straggler scoring against
        the modeled link rates.  New events are logged the moment they
        are detected — the live channel ``-watch`` surfaces — and
        replicated (kind "health") so a promoted standby keeps the
        event history with onset timestamps.  Returns the new events
        (the policy engine's link-rule input)."""
        events = self.health.observe(
            node_id, snap, self._modeled_link_rate,
            expected_srcs=self._health_expected_srcs(node_id))
        if foreign:
            # Advisory reporter-surfaced events (MetricsReportMsg
            # .health) fold in verbatim, deduplicated by onset.
            events = list(events) + self.health.ingest(foreign)
        for ev in events:
            trace.count(f"telemetry.health_{ev.get('kind', 'event')}")
            log.warn("fleet health event", **ev)
            self._replicate("health", Events=[ev])
        return list(events)

    def _modeled_link_rate(self, src: NodeID, dest: NodeID) -> int:
        """The modeled rate (bytes/s) health scoring judges the (src,
        dest) link against, or 0 to skip.  The base leader has no link
        model — mode 3 overrides this with the flow solver's inputs,
        gated to links with an in-flight pair so a completed burst is
        never mis-read as a straggler."""
        return 0

    def _health_expected_srcs(self, dest: NodeID):
        """Sources with dispatched in-flight pairs to ``dest`` — the
        links health scoring must judge even when their FIRST byte
        never landed (no snapshot row).  Base leader: none (no link
        model); mode 3 reads its live-job index."""
        return ()

    def await_metrics(self, newer_than: float = 0.0,
                      timeout: float = 5.0) -> bool:
        """Block until every node in status has reported a metrics
        snapshot received after ``newer_than`` (monotonic), or the
        timeout elapses — the -report path's freshness gate, so a fast
        run's report isn't written from pre-completion snapshots.
        Receivers flush a final report on startup, so the common wait
        is one control round-trip, not a report interval."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                peers = set(self.status) - {self.node.my_id}
                fresh = {n for n, s in self.cluster_metrics.items()
                         if s.get("_recv_mono", 0.0) >= newer_than}
            if peers <= fresh:
                return True
            if time.monotonic() >= deadline:
                log.warn("metrics reports missing at report time",
                         missing=sorted(peers - fresh))
                return False
            time.sleep(0.05)

    def cluster_telemetry(self) -> dict:
        """The folded cluster view: per-node snapshots (the leader's own
        process read live from the registry), cluster-summed counters,
        and the per-(src, dest) link table with each field taken from
        the endpoint that owns it (utils/telemetry.fold_links).  This is
        what the -watch hook logs mid-run and what cli/report.py renders
        into RUN_REPORT."""
        from ..utils import threads as threads_util

        threads_util.publish_census()
        own = telemetry.snapshot()
        own_gauges = dict(own.get("gauges") or {})
        for name, rec in (own.get("phases") or {}).items():
            own_gauges[f"phase.{name}_ms"] = rec["ms"]
        with self._lock:
            reports = {n: {k: v for k, v in s.items()
                           if not k.startswith("_")}
                       for n, s in self.cluster_metrics.items()}
        reports[self.node.my_id] = {
            "proc": own.get("proc", ""),
            "counters": own.get("counters") or {},
            "gauges": own_gauges,
            "links": own.get("links") or {},
            "spans": own.get("spans") or [],
            # A live registry read is by definition the freshest view
            # of this process — it must beat any shipped report from a
            # co-resident node in the per-process counter fold.
            "t_wall_ms": time.time() * 1000.0,
        }
        return {
            "nodes": reports,
            "counters": telemetry.fold_counters(reports),
            "links": telemetry.fold_links(reports),
            # The merged cluster span timeline + the derived fleet
            # health view (docs/observability.md) — what the critical-
            # path analyzer and the RUN_REPORT sections consume.
            "spans": telemetry.fold_spans(reports),
            "health": self.health.snapshot(),
        }

    def dest_bytes_table(self) -> Dict[str, dict]:
        """Per-dest WIRE vs DECODED byte accounting for the run report
        (docs/codec.md): ``wire_bytes`` is what actually crossed the
        network for each delivered pair — the ENCODED size for a
        quantized transfer, the shard range's bytes for a sharded one —
        and ``decoded_bytes`` is what the dest materializes.  The two
        are reported as separate columns on purpose: the telemetry link
        table reconciles against WIRE bytes, never the decoded side."""
        out: Dict[str, dict] = {}
        plane = self.codecs
        with self._lock:
            for dest, lids in self.assignment.items():
                if dest == self.node.my_id:
                    continue
                row = {"wire_bytes": 0, "decoded_bytes": 0, "layers": 0,
                       "codec_layers": 0}
                for lid, want in lids.items():
                    held = self.status.get(dest, {}).get(lid)
                    if not satisfies(held, want):
                        continue
                    raw = self._layer_size_locked(lid)
                    if not raw and plane is not None:
                        raw = plane.decoded_nbytes(lid) or 0
                    codec = held.codec
                    wire = raw
                    if codec and plane is not None:
                        wire = plane.nbytes(lid, codec) or raw
                    if held.shard:
                        wire = shard_range(held.shard, wire)[1]
                        raw = shard_range(held.shard, raw)[1]
                    row["wire_bytes"] += wire
                    row["decoded_bytes"] += raw
                    row["layers"] += 1
                    if codec:
                        row["codec_layers"] += 1
                if row["layers"]:
                    out[str(dest)] = row
        return out

    def log_cluster_metrics(self) -> dict:
        """Log (and return) the folded cluster table — the mid-run
        status hook behind ``cli.main -watch`` and the end-of-run dump
        the offline run report is built from.  The dump now also
        carries the merged span timeline + health events (the offline
        critical-path/health sections read them back), and each active
        job gets its own live progress line (docs/observability.md)."""
        table = self.cluster_telemetry()
        health = table.get("health") or {}
        log.info("cluster telemetry",
                 nodes=sorted(table["nodes"]),
                 counters=table["counters"],
                 links=table["links"],
                 gauges={str(n): s.get("gauges") or {}
                         for n, s in table["nodes"].items()},
                 spans=table.get("spans") or [],
                 health=health)
        for ev in (health.get("events") or [])[-8:]:
            log.warn("fleet health timeline", **ev)
        for jid, row in sorted(self.job_progress().items()):
            # The -watch per-job LIVE progress line: delivered/total
            # bytes from the per-job link split, ETA from the job's own
            # tier pacing (the solver's min-time for its remaining
            # demand at the last re-plan).
            log.info("job progress", job=jid, **row)
        return table

    def job_progress(self) -> Dict[str, dict]:
        """Per-job delivery progress (docs/observability.md):
        ``delivered_bytes`` summed off the job-tagged link rows of the
        folded cluster table (the interval-delta data ``-watch``
        already ships), ``remaining_bytes`` sized from the job's
        remaining pairs (raw layer sizes — codec/shard-qualified pairs
        size by their canonical bytes, the honest approximation the
        docs note), and ``eta_s`` from the job's TIER PACING — the
        joint solver's min-time budget for exactly this job's remaining
        demand at the last re-plan."""
        jobs = getattr(self, "jobs", None)
        if jobs is None:
            return {}
        pairs = jobs.progress_pairs()
        if not pairs:
            return {}
        with self._lock:
            reports = {n: {k: v for k, v in s.items()
                           if not k.startswith("_")}
                       for n, s in self.cluster_metrics.items()}
            tier_ms = dict(getattr(self, "_tier_time", {}) or {})
            sizes = {}
            for row in pairs.values():
                for _dest, lid in row["remaining"]:
                    if lid not in sizes:
                        sizes[lid] = self._layer_size_locked(lid)
        own = telemetry.snapshot()
        reports[self.node.my_id] = {"proc": own.get("proc", ""),
                                    "links": own.get("links") or {},
                                    "t_wall_ms": time.time() * 1000.0}
        links = telemetry.fold_links(reports)
        delivered_by_job: Dict[str, int] = {}
        for key, row in links.items():
            job = row.get("job")
            if job:
                delivered_by_job[job] = (delivered_by_job.get(job, 0)
                                         + int(row.get("delivered_bytes")
                                               or 0))
        out: Dict[str, dict] = {}
        for jid, row in pairs.items():
            remaining_b = sum(sizes.get(lid, 0)
                              for _d, lid in row["remaining"])
            delivered_b = delivered_by_job.get(jid, 0)
            rec = {"state": row["state"], "kind": row["kind"],
                   "remaining_pairs": len(row["remaining"]),
                   "total_pairs": row["total_pairs"],
                   "delivered_bytes": delivered_b,
                   "total_bytes": delivered_b + remaining_b}
            eta = tier_ms.get(jid)
            if row["state"] == "active" and eta:
                rec["eta_s"] = round(eta / 1000.0, 3)
            out[jid] = rec
        return out

    def handle_generate_req(self, msg: GenerateReqMsg) -> None:
        """The leader seat serves no model — refuse immediately so a
        misdirected request gets an error, not a requester timeout (the
        serving invariant: every reachable seat ANSWERS)."""
        try:
            self.node.transport.send(
                msg.src_id,
                GenerateRespMsg(self.node.my_id, msg.req_id, [],
                                "the leader seat serves no model; ask a "
                                "booted assignee"),
            )
        except (OSError, KeyError, ConnectionError) as e:
            log.error("generate refusal send failed", requester=msg.src_id,
                      err=repr(e))

    # ------------------------------------------------------------- lifecycle

    def start_distribution(self) -> "queue.Queue[Assignment]":
        """Fires when all assigned nodes have announced (node.go:222)."""
        return self._start_q

    def ready(self) -> "queue.Queue[Assignment]":
        """Fires when the assignment is satisfied (node.go:225)."""
        return self._ready_q

    def boot_ready(self) -> "queue.Queue[Dict[NodeID, float]]":
        """Fires once every assignee has reported booting its model from
        the delivered layers (receivers constructed with ``boot_cfg``);
        carries {node: that node's boot seconds}.  The leader's
        time-to-first-token — timer start → last boot report — is logged
        as "timer stop: first token"."""
        return self._boot_q

    def boots_seen(self):
        """Node ids that reported a boot outcome so far (diagnostics)."""
        with self._lock:
            return list(self._booted)

    def boot_kinds(self):
        """Reported boot kinds per node ("full"/"stage"/"skipped"/
        "failed") — the CLI surfaces failures in its exit status."""
        with self._lock:
            return dict(self._boot_kinds)

    def _touch_liveness(self, src_id: NodeID) -> None:
        """Refresh a reporter's lease.  The hierarchical leader skips
        GROUPED members — their liveness belongs to the sub-leader's
        detector, and a forwarded boot report must not create a
        root-side lease that later falsely expires."""
        self.detector.touch(src_id)

    def handle_boot_ready(self, msg: BootReadyMsg) -> None:
        self._touch_liveness(msg.src_id)
        logger = log.error if msg.kind == "failed" else log.info
        logger("node booted its model", node=msg.src_id, kind=msg.kind,
               boot_seconds=round(msg.seconds, 6))
        with self._lock:
            if msg.src_id not in self.assignment:
                # Only assignees gate the boot wait; a seeder's "skipped"
                # report (it holds no assigned model) is just liveness.
                return
            self._booted[msg.src_id] = msg.seconds
            self._boot_kinds[msg.src_id] = msg.kind
        self._maybe_complete_boot_wait()

    def _maybe_complete_boot_wait(self) -> None:
        """Fire the boot/TTFT wait exactly once, when every REMAINING
        assignee has reported a boot outcome (incl. "failed"/"skipped").
        Called from ``handle_boot_ready`` and from ``crash`` — a dead
        assignee shrinks the assignment, which can be what completes the
        wait (found live: a dest whose boot died silently left the
        leader blocked in ``boot_ready().get()`` forever)."""
        with self._lock:
            if (self._boot_reported or not self._startup_sent
                    or not self.boot_enabled):
                return
            if set(self.assignment) - set(self._booted):
                return
            self._boot_reported = True
            ttft = (time.monotonic() - self._t_start
                    if self._t_start is not None else 0.0)
            booted = dict(self._booted)
        log.info("timer stop: first token", seconds=round(ttft, 6))
        self._dispatch_serve()
        self._boot_q.put(booted)

    def _dispatch_serve(self) -> None:
        """Broadcast the ServeMsg (multi-controller serving) — or its
        CANCELLATION (empty members) when startup promised serving but
        the pod can no longer serve (a crash changed the assignment, the
        fabric got disabled): receivers told ``serve=True`` are waiting
        and must be released, not left to a timeout."""
        served = self.serve_members()
        members, counts = served if served is not None else (None, [])
        if members is not None:
            # Every member must have REALLY booted a stage model: a
            # "skipped" (opted-out) or "full" report can't enter the
            # collective, and dispatching anyway would park the others
            # inside it — cancel instead.
            with self._lock:
                kinds = {m: self._boot_kinds.get(m) for m in members}
            if any(k != "stage" for k in kinds.values()):
                log.warn("pod serve cancelled: not all members stage-"
                         "booted", kinds={str(k): v for k, v in
                                          kinds.items()})
                members = None
        if members is None and not self._serve_promised:
            return
        serve = ServeMsg(self.node.my_id, members or [],
                         counts=counts if members else [],
                         gen=self.serve_generate, epoch=self.epoch)
        with self._lock:
            recipients = sorted(
                (set(self.status) | set(members or ()))
                - {self.node.my_id}
            )
        failed_member = False
        for r in recipients:
            try:
                self.node.transport.send(r, serve)
            except (OSError, KeyError) as e:
                log.error("failed to send serveMsg", dest=r, err=repr(e))
                failed_member = failed_member or r in (members or ())
        if members and failed_member:
            # A member never got the ServeMsg: the others would block in
            # the collective on the absent peer.  Best-effort cancel
            # (a member that already ENTERED can't be recalled — the
            # same residual window as plan cancellation, see
            # parallel/spmd_fabric.py).
            cancel = ServeMsg(self.node.my_id, [], epoch=self.epoch)
            for r in recipients:
                try:
                    self.node.transport.send(r, cancel)
                except (OSError, KeyError) as e:
                    log.error("serve cancel undeliverable", dest=r,
                              err=repr(e))
            log.error("pod serve aborted: a member missed the ServeMsg")
            return
        if members:
            log.info("pod serve dispatched", members=members)
        else:
            log.warn("pod serve cancelled: pod no longer servable")

    def serve_members(self):
        """(Stage-ordered member nodes, their stage depths) for
        multi-controller serving, or None.  The leader is model-agnostic,
        so the check is structural (blob ids only): the max assigned id H
        is the head blob, every member holds H (a process can only decode
        what its store has), and the members' remaining ids are contiguous
        slices partitioning [0, H) — UNEVEN slices are fine (the members
        pad to the deepest stage, ``pp_serve``).  Counts come from the
        SAME assignment snapshot the membership was validated on (a
        concurrent update()/crash must not desynchronize them).
        Receivers re-validate against the model."""
        if not self._spmd or self.placement is None or not self.boot_enabled:
            return None
        with self._lock:
            assignment = {n: set(lids) for n, lids in self.assignment.items()}
        if len(assignment) < 2:
            return None
        all_ids = set().union(*assignment.values())
        if not all_ids:
            return None
        head = max(all_ids)
        if self._fabric_disabled:
            # Same hazard as device plans: a restarted member is outside
            # the runtime and one more collective hangs every survivor.
            return None
        slices = {}
        for n, lids in assignment.items():
            if head not in lids:
                return None
            body = sorted(lids - {head})
            if not body or body != list(range(body[0], body[-1] + 1)):
                return None
            slices[n] = (body[0], body[-1] + 1)
        spans = sorted(slices.values())
        pos = 0
        for s, e in spans:
            if s != pos:
                return None
            pos = e
        if pos != head:
            return None
        members = sorted(slices, key=lambda n: slices[n][0])
        return members, [slices[m][1] - slices[m][0] for m in members]

    def close(self) -> None:
        self._watch_stop.set()
        self._lease_stop.set()
        if self.replicator is not None:
            self.replicator.close()
        self.detector.stop()
        if not self._shared_loop:
            # A promoted leader borrows the worker's loop — closing it
            # here would kill the worker's data plane too.
            self.loop.stop()

    # -------------------------------------------------------------- handlers

    def _await_announce_set_locked(self) -> Set[NodeID]:
        """The nodes whose announce gates the distribution start.  Lock
        held.  Grouped members announce to their SUB-LEADER; the folded
        aggregate creates their status rows, which is what satisfies
        this gate for them (docs/hierarchy.md)."""
        return set(self.assignment) | self.expected_nodes

    def _maybe_start(self) -> bool:
        """Flip to started when every awaited node has announced."""
        with self._lock:
            if self._started or self._starting:
                return False
            for node_id in self._await_announce_set_locked():
                if node_id not in self.status:
                    return False
            self._starting = True
        # Digest stamps go out BEFORE the timer starts: the stamp (and
        # any wait for the leader's own background hash) is announce-
        # phase work, not delivery time.  _started stays False until the
        # timer exists — an announce landing mid-hash must register as a
        # fresh peer, not trigger a pre-start re-plan against a None
        # _t_start.  The latch MUST clear even if the digest send
        # raises, or every later announce bounces off it and the run
        # wedges with no timer and no layers ever sent.
        try:
            # Codec choices precede the stamp: the digest channel is
            # what tells each dest its transfers' byte spaces
            # (docs/codec.md).
            self._stamp_targets()
            self._send_digests()
            with self._lock:
                self._started = True
                self._t_start = time.monotonic()
        finally:
            with self._lock:
                self._starting = False
        log.info("timer start")
        self._start_q.put(self.assignment)
        self._send_boot_hints()
        return True

    def _send_boot_hints(self) -> None:
        """Tell each assignee what it will hold, so it can compile its
        boot programs while the bytes are still on the wire (shapes are
        all XLA needs).  Advisory: a lost hint only costs the overlap."""
        if not self.boot_enabled:
            return
        with self._lock:
            per_dest = {dest: sorted(ids)
                        for dest, ids in self.assignment.items()
                        if dest != self.node.my_id and ids}
        for dest, blob_ids in per_dest.items():
            try:
                self.node.transport.send(
                    dest, BootHintMsg(self.node.my_id, blob_ids,
                                      epoch=self.epoch))
            except (OSError, KeyError) as e:
                log.warn("boot hint send failed", dest=dest, err=repr(e))

    def _send_boot_hint_to(self, dest: NodeID) -> None:
        """One assignee's hint (re-announce / update paths)."""
        if not self.boot_enabled or dest == self.node.my_id:
            return
        with self._lock:
            ids = sorted(self.assignment.get(dest) or {})
        if not ids:
            return
        try:
            self.node.transport.send(
                dest, BootHintMsg(self.node.my_id, ids, epoch=self.epoch))
        except (OSError, KeyError) as e:
            log.warn("boot hint send failed", dest=dest, err=repr(e))

    def handle_announce(self, msg: AnnounceMsg) -> None:
        """Register the peer; once everyone announced, start sending
        (node.go:295-324).

        A *re*-announce after the start is a restarted process: its status
        row is refreshed (delivered-to-RAM layers died with it; surviving
        state arrives via the announce itself, checkpointed partials
        included) and the scheduler re-plans its missing layers."""
        if self.membership.is_left(msg.src_id):
            # Zombie rejoiner (docs/membership.md): a departed member's
            # late announce must not resurrect it as a schedulable seat
            # nobody monitors — only a fresh JoinMsg re-admits it.
            trace.count("membership.zombie_fenced")
            log.warn("announce from a departed member fenced (a new "
                     "JoinMsg re-admits it)", node=msg.src_id)
            return
        was_dead = self.detector.is_dead(msg.src_id)
        if was_dead:
            log.warn("declared-dead node announced again; reviving",
                     node=msg.src_id)
            self.detector.revive(msg.src_id)
        self.detector.touch(msg.src_id)
        # Wire-codec capability (docs/codec.md): what this node can
        # decode — the negotiation's capability table.  An announce
        # with no codecs is authoritative too (a restarted node may
        # have lost the capability with its config), and REVOCATION
        # replicates like a grant — a standby keeping a stale
        # capability would let a promoted leader choose quantized
        # transfers the node can no longer decode.  Compare-before-
        # replicate: re-announces with an unchanged table (every
        # recovery replan) add no replication traffic.
        with self._lock:
            new_caps = (frozenset(str(c) for c in msg.codecs)
                        if msg.codecs else None)
            old_caps = self.node_codecs.get(msg.src_id)
            if new_caps:
                self.node_codecs[msg.src_id] = new_caps
            else:
                self.node_codecs.pop(msg.src_id, None)
        if new_caps != old_caps:
            self._replicate_codecs()
        if self._verify_member_source(msg.src_id, msg.digests):
            self._merge_announced_digests(msg.src_id, msg.digests)
            # Content index: an announce is the node's authoritative
            # current inventory — replace its digest contribution
            # wholesale (a restarted node no longer vouches for its dead
            # incarnation's bytes); acks extend it as deliveries land.
            self.content.reset_node(msg.src_id, msg.digests)
        else:
            # Probation (docs/membership.md): a JOINING seat whose
            # holdings have not digest-verified neither stamps the
            # integrity plane nor vouches in the content index — it is
            # a dest, not a source, until a clean announce verifies.
            self.content.reset_node(msg.src_id, {})
        with self._lock:
            # A re-plan is only for a node the run already has business
            # with: one that restarted (still in status), one returning
            # from the dead (crash() popped its row / dropped its
            # assignment), or an assignee added by update() that hadn't
            # announced yet.  A brand-new late announcer with no assigned
            # layers must NOT re-drive in-flight transfers.
            known = (msg.src_id in self.status or was_dead
                     or msg.src_id in self._dropped_assignment
                     or msg.src_id in self.assignment)
            reannounce = self._started and known
            # Always refresh: an announce is the node's authoritative
            # current inventory (a pre-start restart must not leave a stale
            # row claiming layers the new incarnation lost).
            self.status[msg.src_id] = msg.layer_ids
            self.node.add_node(msg.src_id)
            dropped = self._dropped_assignment.pop(msg.src_id, None)
            if dropped and not self._startup_sent:
                # The node was declared crashed and its assignment dropped;
                # it's back, so it gets its layers back.
                self._restore_assignment(msg.src_id, dropped)
                log.info("restored dropped assignment for returned node",
                         node=msg.src_id, layers=sorted(dropped))
            elif dropped:
                log.warn("node returned after distribution finished; its "
                         "dropped assignment stays dropped", node=msg.src_id)
            if msg.partial:
                # Checkpointed in-progress coverage (resume extension);
                # mode 3 schedules only the complement.
                self.partial_status[msg.src_id] = msg.partial
            else:
                # A re-announce without partials supersedes any stale ones
                # (e.g. the checkpoint dir was wiped between restarts).
                self.partial_status.pop(msg.src_id, None)
            # A re-announcing dest's salvage pairs revert to the normal
            # re-plan machinery — its announce carries the authoritative
            # partial coverage the planner schedules around.
            if reannounce:
                self._salvaging = {p for p in self._salvaging
                                   if p[1] != msg.src_id}
        self._replicate("status", Node=msg.src_id,
                        Layers=layer_ids_to_json(msg.layer_ids))
        self._replicate(
            "partial", Node=msg.src_id,
            Partial=({str(l): info for l, info in msg.partial.items()}
                     if msg.partial else None))
        bw_map = getattr(self, "node_network_bw", None)
        if (bw_map is not None and msg.nic_bw > 0
                and (msg.src_id in self._joiner_bw_pinned
                     # A roster-admitted seat (it joined — its addr
                     # rides the replicated membership plane, so this
                     # ALSO covers a promoted leader whose local pinned
                     # set died with its predecessor) whose modeled
                     # rate differs from its announced one.
                     or (bool(self.membership.addr_of(msg.src_id))
                         and bw_map.get(msg.src_id)
                         != int(msg.nic_bw)))):
            # Joiner NIC modeling (docs/membership.md): the admit-time
            # value was the most conservative configured rate (the seat
            # is in nobody's config); the joiner's own announce-carried
            # rate supersedes it, so the solver models the real link
            # instead of starving the refill behind a worst-case guess.
            with self._lock:
                pinned = bw_map.get(msg.src_id)
                bw_map[msg.src_id] = int(msg.nic_bw)
            self._joiner_bw_pinned.discard(msg.src_id)
            trace.count("membership.joiner_bw_honored")
            log.info("joiner's announce-carried NIC rate honored",
                     node=msg.src_id, pinned=pinned, rate=msg.nic_bw)
        with self._lock:
            pending_want = self._join_pending.pop(msg.src_id, None)
        if pending_want is not None:
            # The joiner's first announce: its cold-boot holdings are
            # now in status (and, verified, in the content index), so
            # the refill job's remaining demand is exactly the
            # complement (docs/membership.md).
            self._admit_join_job(msg.src_id, pending_want)
        if self._started and self.jobs.has_active():
            # An announce is authoritative inventory, and an ACK can be
            # LOST in a failover window (sent to the dead leader before
            # the worker re-pointed): reconcile active jobs against the
            # refreshed status so a delivered-but-unacked pair credits
            # here instead of wedging the job (and any swap fence
            # waiting on it) forever — the same repair adopt_shadow
            # runs at takeover.
            with self._lock:
                status_view = {n: dict(r) for n, r in self.status.items()}
            finished = self.jobs.credit_status(status_view)
            if finished:
                log.info("announce reconciled job pairs a lost ack "
                         "left uncredited", jobs=finished,
                         node=msg.src_id)
                self._jobs_completed(finished)
        if dropped:
            # The node came back from declared death: purge it from the
            # shadow's dropped map too, or a takeover would re-apply
            # the job-pair drops against a LIVE dest (adopt_shadow
            # re-drops for every still-dropped node).
            self._replicate("revive", Node=msg.src_id)
        if msg.src_id in self.standbys:
            # A standby joined (or re-joined): snapshot first, deltas
            # thereafter.
            self._send_snapshot_to(msg.src_id)
        if self._maybe_start():
            self.send_layers()
            # Announce metadata can already satisfy the assignment (every
            # assignee holds its layers in RAM) — no acks will ever arrive,
            # so check now or hang.  (The reference checks only on acks,
            # node.go:410-432, and would hang here.)
            self._maybe_finish()
            return
        if reannounce:
            log.info("node re-announced; re-planning", node=msg.src_id)
            if self._spmd and not self._fabric_disabled:
                # Either the process restarted (fresh executor at seq 0,
                # possibly outside the jax.distributed runtime — a fabric
                # plan would hang every survivor inside the collective) or
                # a live dest is reporting a failed fabric plan.  Both
                # mean the lockstep is no longer trustworthy: the rest of
                # the run rides the host path.
                log.error("re-announce under spmd fabric; disabling the "
                          "device plane for the rest of the run",
                          node=msg.src_id)
                self._fabric_disabled = True
            self._maybe_finish()
            with self._lock:
                finished = self._startup_sent
            if not finished:
                # A restarted assignee lost its warm jit caches with its
                # process — and has the longest re-transfer window to
                # overlap a fresh precompile with.  (Receivers latch the
                # first hint, so a repeat to a live process is a no-op.)
                # It also lost its digest stamp: re-stamp before the
                # re-plan re-sends its layers.
                self._send_boot_hint_to(msg.src_id)
                self._send_digests_to(msg.src_id)
                self._on_reannounce(msg.src_id)

    def _on_reannounce(self, node_id: NodeID) -> None:
        """Re-drive delivery for a restarted node; mode 2 overrides (its
        job table needs surgical repair, not a wholesale re-run)."""
        self._recover()

    def _restore_assignment(self, node_id: NodeID, layers: LayerIDs) -> None:
        """Re-admit a previously dropped assignee (called under _lock).
        The dropped set is the node's MERGED promise (base + any job
        layers), so it restores into the base goal: jobs that completed
        with the drop stay completed, but the returned node still gets
        every layer it was promised."""
        self.assignment[node_id] = layers
        if self._base_assignment is not self.assignment:
            self._base_assignment[node_id] = layers

    def update(self, assignment: Assignment) -> None:
        """Re-target the distribution to a new goal state — the
        reference's never-implemented ``update(assignment)``
        (node.go:215-217).

        Declarative semantics: the new assignment wholly replaces the old
        BASE goal (admitted jobs keep their own targets and re-merge on
        top — a version rollout must not be cancelled by a base
        re-target).  Acked layers are not re-sent; missing ones are
        scheduled, and a layer still on the wire (not yet acked) counts
        as missing: the re-plan sends it again and the dest absorbs the
        duplicate.  If the new goal adds work after ``ready`` already
        fired, the completion cycle re-arms and ``ready()`` delivers
        again once the new goal is met."""
        with self._lock:
            self._base_assignment = assignment
            self.assignment = self.jobs.merged_assignment(assignment)
            self._dropped_assignment.clear()
            if self._started:
                # Re-arm: every update() answers with its own ready event,
                # immediate when the new goal is already met.  Replicated
                # under THIS lock — see _maybe_finish: the shadow's
                # startup flag must flip in write order, or a takeover
                # adopts "FINISHED" and never re-drives the new goal.
                self._startup_sent = False
                self._replicate("startup", Sent=False)
        # Re-merge dropped the codec choices from the target metas;
        # re-apply the memoized ones (docs/codec.md) before anything
        # replicates or stamps the new goal.
        self._stamp_targets()
        # New assignees that haven't announced get liveness leases, so one
        # that never shows up is still detected (as in __init__'s seeding).
        for node_id in assignment:
            if node_id != self.node.my_id and node_id not in self.status:
                self.detector.touch(node_id)
        log.info("assignment updated", dests=sorted(assignment))
        with self._lock:
            merged = _nested_layer_map_to_json(self.assignment)
        # The shadow's "assignment" tracks the MERGED goal (it is what
        # adopt_shadow resumes); the BASE re-target rides its own delta
        # — a standby that attached before this update would otherwise
        # restore the snapshot's stale base, and the first post-takeover
        # goal recompute would silently revert the re-target.
        self._replicate("assignment", Assignment=merged)
        self._replicate("base_assignment",
                        Assignment=_nested_layer_map_to_json(assignment))
        with self._lock:
            started = self._started
        if started:
            # New goal, possibly new assignees (or new held-sets for old
            # ones): re-hint everyone.  Receivers latch the first hint,
            # so live processes ignore the repeat.  Digest stamps are
            # leader-authoritative and re-sent for the new goal.
            self._send_boot_hints()
            self._send_digests()
        self._drive(self._update_replan)

    def _update_replan(self) -> None:
        """Schedule the new goal's missing deliveries; mode 2 overrides
        (its live job table needs incremental repair, not a rebuild)."""
        self._recover()

    # ------------------------------------------------- multi-job service

    def submit_job(self, job_id: str, assignment: Assignment,
                   priority: int = 0, kind: str = "push",
                   digests: Optional[Dict[LayerID, str]] = None,
                   avoid: Optional[Set[NodeID]] = None,
                   version: str = "", swap_base: int = -1,
                   submitter: str = "", waves=None, slo=None,
                   split: float = -1.0) -> dict:
        """Admit one dissemination job into the long-lived service plane
        (docs/service.md) — the multi-job generalization of ``update()``.

        The job's target merges into the effective cluster goal; its
        remaining (dest, layer) demands are planned WITH every other
        active job's in one shared-capacity flow solve (mode 3;
        priorities preempt at the re-plan), and acks credit all jobs
        wanting a pair.  ``digests`` keys the job's layers by content
        (``xxh3:<hex>``): a dest already holding content-equal bytes
        resolves the layer locally — zero wire bytes — via the
        content store.  Idempotent per ``job_id``; returns the job's
        status summary.

        ``version``/``swap_base`` (docs/swap.md): a ``kind="swap"`` job
        tags every target meta with the rollout version — only
        deliveries verified under that version complete its pairs —
        and registers the swap driver record; on the job's clean
        completion the epoch-fenced commit fence flips every replica.

        ``kind="rollout"`` (docs/rollout.md) does not admit a job at
        all: it EXPANDS into the declared waves — each a chained
        ``kind="swap"`` job over its replica subset with the commit
        held for the pipeline — and returns the rollout summary."""
        if kind == "rollout":
            return self.rollouts.admit(
                str(job_id), assignment, waves, str(version),
                int(swap_base), priority=int(priority),
                digests=digests, slo=slo, split=float(split))
        digests = dict(digests or {})
        if version:
            # Stamp the rollout version onto every target: the merged
            # goal, the digest stamps, and the acks all carry it.
            assignment = {
                dest: {lid: dataclasses.replace(meta, version=version)
                       for lid, meta in lids.items()}
                for dest, lids in assignment.items()}
        with self._lock:
            # A long-lived daemon's layer store GROWS between jobs (a
            # rollout seeder loads v2 bytes): refresh the leader's own
            # status row so the planner can size + source the new
            # layers (the constructor only saw the boot-time store).
            own = self.status.setdefault(self.node.my_id, {})
            for lid, src in self.layers.items():
                if lid not in own:
                    own[lid] = LayerMeta(
                        location=src.meta.location,
                        limit_rate=src.meta.limit_rate,
                        source_type=src.meta.source_type,
                        data_size=src.data_size,
                        version=src.meta.version)
            own_row = layer_ids_to_json(own)
        self._replicate("status", Node=self.node.my_id, Layers=own_row)
        if digests:
            with self._lock:
                for lid, d in digests.items():
                    # Job digests are authoritative for NEW layer ids;
                    # an existing stamp (e.g. a holder's announce) wins,
                    # matching the first-writer rule of the integrity
                    # plane — EXCEPT for a swap job, which owns its v2
                    # ids outright: a retry after a bad-digest abort
                    # must be able to supersede the poisoned stamp, or
                    # no corrected rollout can ever verify.
                    if kind == "swap":
                        self.layer_digests[lid] = d
                    else:
                        self.layer_digests.setdefault(lid, d)
        with self._lock:
            status_view = {n: dict(r) for n, r in self.status.items()}
        job = self.jobs.admit(
            Job(job_id=str(job_id), assignment=assignment,
                priority=int(priority), kind=str(kind), digests=digests,
                avoid_sources={int(n) for n in (avoid or ())},
                admit_ms=time.time() * 1000.0,
                version=str(version), swap_base=int(swap_base),
                submitter=str(submitter)),
            status_view)
        trace.count("jobs.admitted")
        log.info("dissemination job admitted", job=job.job_id,
                 priority=job.priority, kind=job.kind,
                 dests=sorted(job.assignment),
                 remaining=len(job.remaining),
                 resolved_at_admit=job.resolved_at_admit)
        with self._lock:
            self.assignment = self.jobs.merged_assignment(
                self._base_assignment)
            rearmed = self._started and job.state == "active"
            if rearmed:
                # Like update(): the completion cycle re-arms; ready()
                # fires again when the whole current goal (all jobs)
                # is met.  Replicated under THIS lock so the delta
                # order matches the flag-write order (_maybe_finish's
                # in-lock Sent=True is the other writer).
                self._startup_sent = False
                self._replicate("startup", Sent=False)
            merged = _nested_layer_map_to_json(self.assignment)
        # The re-merge rebuilt the goal codec-less: re-apply choices
        # (and choose for the job's new pairs) before stamps/replans.
        self._stamp_targets()
        for node_id in job.assignment:
            if node_id != self.node.my_id and node_id not in self.status:
                self.detector.touch(node_id)
        self._replicate("job", **self.jobs.record(job.job_id))
        if digests:
            self._replicate("digests",
                            Digests={str(l): d
                                     for l, d in digests.items()})
        self._replicate("assignment", Assignment=merged)
        with self._lock:
            started = self._started
        if started:
            for dest in sorted(job.assignment):
                # A job's dests need their (possibly new) digest stamps
                # BEFORE the re-plan: the stamp is what triggers the
                # dest-side content resolve, and what the ack gate
                # verifies shipped layers against.
                self._send_digests_to(dest)
                self._send_boot_hint_to(dest)
        if kind == "swap" and version:
            self._register_swap(job)
        # Preemption revoke (docs/service.md): queued sends of tiers
        # this admission demotes are dropped at their senders before
        # the re-plan reclaims their budget (mode-3 override).
        self._preempt_revoke(job)
        self._drive(self._update_replan)
        job = self.jobs.get(job.job_id) or job
        if kind == "swap" and version and job.state == "done":
            # Admission found every pair already satisfied (all v2
            # bytes verified): the fence can fire right now.
            self._on_swap_job_done(job.job_id)
        return job.summary()

    def _preempt_revoke(self, job: Job) -> None:
        """Hook: a newly admitted job may demote lower tiers' queued
        sends.  Only mode 3 tracks dispatched sends (``_live_jobs``);
        the base scheduler has nothing to revoke."""

    def _submitter_id(self, msg: JobSubmitMsg) -> str:
        """The submitter identity quotas key on (docs/service.md):
        derived from the DLD_JOB_TOKEN the submit authenticated with
        (hashed — the identity must never leak the secret into logs or
        job records), falling back to the wire seat id on open
        clusters."""
        if msg.auth:
            import hashlib

            return hashlib.sha256(msg.auth.encode()).hexdigest()[:12]
        return f"node{msg.src_id}"

    def _quota_refusal(self, msg: JobSubmitMsg) -> str:
        """Per-submitter quota/rate check (docs/service.md); returns
        the refusal text ("" = admitted).  Idempotent resubmits of a
        KNOWN job id are never refused — the retry path must stay safe.
        Every refusal counts on ``jobs.quota_refused`` and is ANSWERED
        by the caller (the serving invariant)."""
        if self._job_quota <= 0 and self._job_rate_n <= 0:
            return ""
        if self.jobs.get(msg.job_id) is not None:
            return ""
        ident = self._submitter_id(msg)
        now = time.monotonic()
        if self._job_rate_n > 0:
            with self._lock:
                times = self._submit_times.setdefault(ident, [])
                times[:] = [t for t in times
                            if now - t < self._job_rate_s]
                over = len(times) >= self._job_rate_n
                if not over:
                    times.append(now)
            if over:
                trace.count("jobs.quota_refused")
                log.warn("job submit rate-limited", job=msg.job_id,
                         submitter=ident, limit=self._job_rate_n,
                         window_s=self._job_rate_s)
                return (f"rate limited: {self._job_rate_n} submits per "
                        f"{self._job_rate_s:g}s per submitter")
        if (self._job_quota > 0
                and self.jobs.active_count_for(ident) >= self._job_quota):
            trace.count("jobs.quota_refused")
            log.warn("job submit over quota", job=msg.job_id,
                     submitter=ident, quota=self._job_quota)
            return (f"quota exceeded: {self._job_quota} active jobs "
                    "per submitter")
        return ""

    def handle_job_submit(self, msg: JobSubmitMsg) -> None:
        """Wire half of ``submit_job`` — the ``cli.main -submit`` entry
        point.  Always answered (the serving invariant): admission
        returns the job row, a refusal returns an error."""
        if self._deposed:
            reply = JobStatusMsg(self.node.my_id, epoch=self.epoch,
                                 error="deposed: a higher-epoch leader "
                                       "owns the job table")
        elif self._job_token and not hmac.compare_digest(
                msg.auth.encode(), self._job_token.encode()):
            # Admission control (docs/service.md): the job plane now
            # MUTATES cluster state (swaps flip serving models), so a
            # token-armed leader refuses unauthenticated submitters —
            # constant-time compare (no timing oracle), counted, and
            # ANSWERED (the serving invariant).
            trace.count("jobs.unauthorized")
            log.warn("unauthorized job submit rejected",
                     job=msg.job_id, submitter=msg.src_id)
            reply = JobStatusMsg(self.node.my_id, epoch=self.epoch,
                                 error="unauthorized: this leader "
                                       "requires a job token "
                                       "(DLD_JOB_TOKEN)")
        elif not msg.job_id or not msg.assignment:
            reply = JobStatusMsg(self.node.my_id, epoch=self.epoch,
                                 error="job_id and a non-empty "
                                       "assignment are required")
        elif (refusal := self._quota_refusal(msg)):
            # Per-submitter quotas/rate limits (docs/service.md): the
            # refusal ANSWERS — a throttled submitter sees why, never a
            # timeout.
            reply = JobStatusMsg(self.node.my_id, epoch=self.epoch,
                                 error=refusal)
        else:
            try:
                summary = self.submit_job(msg.job_id, msg.assignment,
                                          priority=msg.priority,
                                          kind=msg.kind,
                                          digests=msg.digests,
                                          avoid=msg.avoid,
                                          version=msg.version,
                                          swap_base=msg.swap_base,
                                          submitter=self._submitter_id(msg),
                                          waves=msg.waves, slo=msg.slo,
                                          split=msg.split)
                reply = JobStatusMsg(self.node.my_id,
                                     jobs={msg.job_id: summary},
                                     epoch=self.epoch)
            except Exception as e:  # noqa: BLE001 — ALWAYS answer
                # The admission tail runs a synchronous replan; if it
                # raises, the submitter must get the error, not a 30 s
                # timeout misdiagnosing a live daemon as down.
                log.error("job admission failed", job=msg.job_id,
                          err=repr(e))
                reply = JobStatusMsg(self.node.my_id, epoch=self.epoch,
                                     error=f"admission failed: {e!r}")
        try:
            self.node.add_node(msg.src_id)
            self.node.transport.send(msg.src_id, reply)
        except (OSError, KeyError) as e:
            log.error("job submit reply undeliverable", dest=msg.src_id,
                      err=repr(e))

    def handle_job_status(self, msg: JobStatusMsg) -> None:
        """Answer a ``-jobs`` query with the full admitted-job table; a
        non-query (someone's reply echoed here) is ignored."""
        if not msg.query:
            return
        try:
            self.node.add_node(msg.src_id)
            self.node.transport.send(
                msg.src_id,
                JobStatusMsg(self.node.my_id, jobs=self.jobs.table(),
                             epoch=self.epoch))
        except (OSError, KeyError) as e:
            log.error("job status reply undeliverable", dest=msg.src_id,
                      err=repr(e))

    # ------------------------------------------- zero-downtime swap driver

    # Commit-fence watchdog knobs (class attrs: tests tune them): how
    # often to re-send the fence to unconfirmed nodes, and how many
    # rounds before going quiet (the node-side query path can still
    # re-request later).
    SWAP_RESEND_S = 2.0
    SWAP_RESENDS = 10

    def _register_swap(self, job: Job) -> None:
        """Track a ``kind="swap"`` job as a live rollout and announce
        the version + blob mapping to every serving dest (the PREPARE
        notice: staging overlaps the rollout, docs/swap.md)."""
        with self._lock:
            prior = self._swaps.get(job.version)
            if prior is not None:
                if prior["job_id"] == job.job_id:
                    return  # idempotent re-submit of the same job
                if prior["state"] != "aborted":
                    # A live (rolling/committed) version name belongs to
                    # its job; a second job may not hijack its fence.
                    # LOUD, never silent: the new job still delivers as
                    # a plain rollout, but no flip will fire for it.
                    log.error("swap version already owned by another "
                              "job; refusing to re-register (pick a new "
                              "version name)", version=job.version,
                              owner=prior["job_id"], job=job.job_id)
                    return
                # Retrying an ABORTED rollout under the same version is
                # the mainline operator path: replace the dead record.
                log.warn("re-registering previously aborted swap "
                         "version for a retry job", version=job.version,
                         prior_job=prior["job_id"], job=job.job_id)
            self._swaps[job.version] = {
                "version": job.version,
                "job_id": job.job_id,
                "swap_base": job.swap_base,
                "dests": sorted(job.assignment),
                "state": "rolling",
                "confirmed": set(),
                # Rollout-pipeline wave bookkeeping (docs/rollout.md):
                # a HELD swap completes its rollout but does not
                # auto-commit — the pipeline releases the flip when the
                # previous wave's soak verdict passes.
                "hold": job.version in self._swap_holds,
                "staged": False,
                "rollout": self._swap_holds.get(job.version, ""),
                "revert": False,
            }
            self._swaps_by_job[job.job_id] = job.version
        trace.count("swap.registered")
        log.info("live swap registered; v2 disseminating while v1 "
                 "serves", version=job.version, job=job.job_id,
                 swap_base=job.swap_base, dests=sorted(job.assignment))
        self._replicate_swap(job.version)
        self._swap_send_round(job.version, prepare=True)

    def _swap_record_locked(self, version: str) -> dict:
        rec = self._swaps[version]
        out = {"Version": rec["version"], "JobID": rec["job_id"],
               "SwapBase": rec["swap_base"], "Dests": list(rec["dests"]),
               "State": rec["state"],
               "Confirmed": sorted(rec["confirmed"])}
        # Rollout-pipeline fields ride only when set (plain swap
        # records keep their pre-rollout shape).
        if rec.get("hold"):
            out["Hold"] = True
        if rec.get("staged"):
            out["Staged"] = True
        if rec.get("rollout"):
            out["Rollout"] = rec["rollout"]
        if rec.get("revert"):
            out["Revert"] = True
        return out

    def _replicate_swap(self, version: str) -> None:
        with self._lock:
            if version not in self._swaps:
                return
            data = self._swap_record_locked(version)
        self._replicate("swap", **data)

    def _swap_send_round(self, version: str, prepare: bool = False,
                         only: Optional[Set[NodeID]] = None,
                         finalize: bool = False) -> None:
        """One fence round: the operative message (prepare / commit /
        abort, per the record's state) to each dest — unconfirmed ones
        only, unless ``only`` narrows it further.  ``finalize`` sends
        the advisory release-the-retained-tree notice to EVERY dest
        (docs/rollout.md) regardless of confirm state."""
        with self._lock:
            rec = self._swaps.get(version)
            if rec is None:
                return
            state = rec["state"]
            revert = bool(rec.get("revert"))
            targets = [d for d in rec["dests"]
                       if (finalize or d not in rec["confirmed"])
                       and (only is None or d in only)
                       and d != self.node.my_id]
            swap_base = rec["swap_base"]
        for dest in targets:
            if finalize:
                msg = SwapCommitMsg(self.node.my_id, version,
                                    finalize=True, epoch=self.epoch)
            else:
                msg = SwapCommitMsg(self.node.my_id, version,
                                    swap_base=swap_base,
                                    abort=(state == "aborted"),
                                    revert=(state == "aborted"
                                            and revert),
                                    prepare=prepare
                                    and state == "rolling",
                                    epoch=self.epoch)
            try:
                self.node.add_node(dest)
                self.node.transport.send(dest, msg)
            except (OSError, KeyError) as e:
                log.warn("swap fence send failed", dest=dest,
                         version=version, err=repr(e))

    def _on_swap_job_done(self, job_id: str) -> None:
        """A swap job finished rolling: clean completion commits the
        fence; any dropped pair (dest crashed, pair cancelled) aborts —
        v1 keeps serving everywhere.  A HELD swap (a rollout wave,
        docs/rollout.md) marks STAGED instead of committing — the
        pipeline releases the flip."""
        with self._lock:
            version = self._swaps_by_job.get(job_id)
            rec = self._swaps.get(version) if version else None
            if rec is None or rec["state"] != "rolling":
                return
        job = self.jobs.get(job_id)
        if job is None or job.dropped_pairs > 0 or job.cancelled:
            self._abort_swap(version, "rollout degraded: "
                             f"{job.dropped_pairs if job else '?'} pairs "
                             "dropped")
            return
        with self._lock:
            rec = self._swaps.get(version)
            hold = rec is not None and rec.get("hold")
            if hold:
                rec["staged"] = True
        if hold:
            trace.count("swap.staged_held")
            log.info("held swap staged on every replica; awaiting the "
                     "pipeline's release", version=version)
            self._replicate_swap(version)
            self.rollouts.on_wave_staged(version)
            return
        self._commit_swap(version)

    def _commit_swap(self, version: str) -> None:
        with self._lock:
            rec = self._swaps.get(version)
            if rec is None or rec["state"] != "rolling":
                return
            rec["state"] = "committed"
        trace.count("swap.committed")
        log.info("swap rollout verified on every replica; issuing the "
                 "commit fence", version=version, epoch=self.epoch)
        self._replicate_swap(version)
        self._swap_send_round(version)
        threading.Thread(target=self._swap_watchdog, args=(version,),
                         daemon=True,
                         name=f"swap-fence-{version}").start()

    def _abort_swap(self, version: str, reason: str,
                    revert: bool = False) -> None:
        """Rollback = never flip: cancel the job (remaining pairs drop
        VISIBLY), tell every dest to release its staged v2, keep v1
        serving.  With ``revert`` (the rollout SLO guard's rollback,
        docs/rollout.md) an already-COMMITTED swap is allowed to abort:
        the fence carries ``Revert`` and each replica restores its
        retained pre-flip tree."""
        with self._lock:
            rec = self._swaps.get(version)
            if rec is None or rec["state"] in ("aborted",):
                return
            if rec["state"] == "committed" and not revert:
                log.error("abort requested for an already-committed "
                          "swap; refusing (the fleet flipped)",
                          version=version, reason=reason)
                return
            rec["state"] = "aborted"
            rec["confirmed"] = set()
            rec["revert"] = bool(revert)
            job_id = rec["job_id"]
            rollout = rec.get("rollout", "")
        trace.count("swap.aborts")
        if revert:
            trace.count("swap.reverts_issued")
        log.error("live swap ABORTED; "
                  + ("replicas reverting to the pre-flip tree"
                     if revert else "v1 keeps serving"),
                  version=version, reason=reason)
        if self.jobs.cancel(job_id):
            self._replicate("job", **self.jobs.record(job_id))
            with self._lock:
                self.assignment = self.jobs.merged_assignment(
                    self._base_assignment)
                merged = _nested_layer_map_to_json(self.assignment)
            self._replicate("assignment", Assignment=merged)
        self._replicate_swap(version)
        self._swap_send_round(version)
        self._maybe_finish()
        if rollout and not revert:
            # A wave that died OUTSIDE the guard's own rollback (dest
            # crash, staging failure): the pipeline pauses, loudly.
            self.rollouts.on_wave_aborted(version, reason)

    def _swap_watchdog(self, version: str) -> None:
        """Bounded fence re-send: a node that lost the commit gets it
        again until every dest confirmed (the node-side query path
        covers the long tail past the budget)."""
        for _ in range(self.SWAP_RESENDS):
            time.sleep(self.SWAP_RESEND_S)
            with self._lock:
                rec = self._swaps.get(version)
                if rec is None or rec["state"] != "committed":
                    return
                missing = [d for d in rec["dests"]
                           if d not in rec["confirmed"]]
                if not missing:
                    return
            if self._deposed or self._closed():
                return
            trace.count("swap.fence_resent")
            log.warn("swap fence unconfirmed; re-sending",
                     version=version, missing=missing)
            self._swap_send_round(version)
        log.error("swap fence re-send budget exhausted; remaining nodes "
                  "must query", version=version)

    def _closed(self) -> bool:
        # close() and a depose both set the lease stop — either way
        # this process must stop driving fences.
        return self._lease_stop.is_set()

    def handle_swap_commit(self, msg: SwapCommitMsg) -> None:
        """Node → leader swap traffic: flip confirmations, fence
        re-requests, and staging-failure reports.

        Gated to the swap's REGISTERED replica set: confirm/query/error
        are serving-state mutations (a forged error is a one-message
        rollout DoS; a forged confirm fakes a flip the fence watchdog
        would otherwise keep chasing), so a node outside the rollout's
        dest set is refused, loudly — the same posture as the
        DLD_JOB_TOKEN admission gate.  Honest limit: a compromised
        replica can still lie about ITSELF (inherent without
        per-message signatures; docs/swap.md)."""
        with self._lock:
            rec = self._swaps.get(msg.version)
            member = rec is not None and msg.src_id in rec["dests"]
        if (msg.applied or msg.query or msg.error) and not member:
            trace.count("swap.foreign_ctrl_dropped")
            log.warn("swap control message from a node outside the "
                     "rollout's replica set; dropped",
                     version=msg.version, node=msg.src_id,
                     applied=msg.applied, query=msg.query,
                     err=msg.error or None)
            return
        if msg.applied:
            with self._lock:
                rec = self._swaps.get(msg.version)
                if rec is None:
                    return
                rec["confirmed"].add(msg.src_id)
            self._replicate_swap(msg.version)
            self._maybe_swap_complete(msg.version)
            return
        if msg.query:
            # A staged node that never saw its fence: answer with the
            # operative state (commit/abort); a still-rolling swap has
            # nothing to say yet.
            with self._lock:
                rec = self._swaps.get(msg.version)
                state = rec["state"] if rec is not None else None
            if state in ("committed", "aborted"):
                self._swap_send_round(msg.version, only={msg.src_id})
            elif state is None:
                log.warn("fence query for an unknown swap version",
                         version=msg.version, node=msg.src_id)
            return
        if msg.error:
            log.error("replica reports unrecoverable swap staging; "
                      "aborting rollout", version=msg.version,
                      node=msg.src_id, err=msg.error)
            self._abort_swap(msg.version,
                             f"node {msg.src_id}: {msg.error}")
            return

    def _maybe_swap_complete(self, version: str) -> None:
        """Fire the fleet-flipped completion edge once every REMAINING
        fence dest has confirmed.  Called from the confirm path and
        from a dead dest's fence-set prune (``crash``): the prune can
        be what completes the set, and without this edge a plain
        swap's finalize round (or a rollout wave's soak open) would
        wait forever on a confirmation that can no longer arrive —
        survivors pinning their retained pre-flip trees the whole
        time."""
        with self._lock:
            rec = self._swaps.get(version)
            if (rec is None or rec["state"] != "committed"
                    or not set(rec["dests"]) <= rec["confirmed"]
                    or rec.get("fleet_flipped")):
                return
            rec["fleet_flipped"] = True
            held = bool(rec.get("rollout"))
        trace.count("swap.fleet_flipped")
        log.info("every replica confirmed the flip; swap complete",
                 version=version)
        if held:
            # A rollout wave: the flip edge opens its soak window
            # (docs/rollout.md).
            self.rollouts.on_wave_flipped(version)
        else:
            # A plain fleet-wide swap: everyone flipped — the rollback
            # window closes now; release the retained pre-flip trees
            # (advisory).
            self._swap_send_round(version, finalize=True)

    def swap_table(self) -> Dict[str, dict]:
        """JSON-ready swap driver state (reports, tests, -jobs)."""
        with self._lock:
            return {v: self._swap_record_locked(v)
                    for v in sorted(self._swaps)}

    # --------------------------------------------- rollout operator channel

    def handle_rollout_ctl(self, msg: RolloutCtlMsg) -> None:
        """The rollout pipeline's operator front door (docs/rollout.md):
        query the table, pause/resume a pipeline, move the traffic-split
        knob.  The MUTATING verbs (pause/resume/split) ride the
        DLD_JOB_TOKEN admission gate — a resume re-submits a
        rolled-back wave's swap job and a commit flips serving, exactly
        the mutation class the token exists for; query stays open like
        -jobs.  Every request is ANSWERED, refusals included."""
        if msg.table or msg.error:
            return  # someone's reply echoed here
        error = ""
        mutating = msg.pause or msg.resume or msg.split >= 0
        if self._deposed:
            error = "deposed: a higher-epoch leader owns the rollouts"
        elif (mutating and self._job_token
                and not hmac.compare_digest(msg.auth.encode(),
                                            self._job_token.encode())):
            trace.count("jobs.unauthorized")
            log.warn("unauthorized rollout control verb rejected",
                     rollout=msg.rollout_id, submitter=msg.src_id,
                     pause=msg.pause, resume=msg.resume)
            error = ("unauthorized: this leader requires a job token "
                     "(DLD_JOB_TOKEN) for pause/resume/split")
        elif msg.pause:
            error = self.rollouts.pause(msg.rollout_id)
        elif msg.resume:
            error = self.rollouts.resume(msg.rollout_id)
        elif msg.split >= 0:
            error = self.rollouts.set_split(msg.rollout_id, msg.split)
        elif not msg.query:
            error = "no verb: set Query, Pause, Resume, or Split"
        try:
            self.node.add_node(msg.src_id)
            self.node.transport.send(
                msg.src_id,
                RolloutCtlMsg(self.node.my_id,
                              rollout_id=msg.rollout_id,
                              table=self.rollouts.table(),
                              error=error, epoch=self.epoch))
        except (OSError, KeyError, ConnectionError) as e:
            log.error("rollout ctl reply undeliverable",
                      dest=msg.src_id, err=repr(e))

    def handle_policy_ctl(self, msg: PolicyCtlMsg) -> None:
        """The autonomy engine's operator front door (docs/autonomy.md):
        query the policy table, enable/disable automatic actioning.
        The MUTATING verbs (enable/disable) ride the DLD_JOB_TOKEN
        admission gate — flipping a fleet between self-driving and
        manual is exactly the mutation class the token exists for;
        query stays open like -jobs.  Every request is ANSWERED,
        refusals included."""
        if msg.table or msg.error:
            return  # someone's reply echoed here
        error = ""
        mutating = msg.enable or msg.disable
        if self._deposed:
            error = "deposed: a higher-epoch leader owns the policies"
        elif (mutating and self._job_token
                and not hmac.compare_digest(msg.auth.encode(),
                                            self._job_token.encode())):
            trace.count("jobs.unauthorized")
            log.warn("unauthorized policy control verb rejected",
                     submitter=msg.src_id, enable=msg.enable,
                     disable=msg.disable)
            error = ("unauthorized: this leader requires a job token "
                     "(DLD_JOB_TOKEN) for enable/disable")
        elif msg.enable and msg.disable:
            error = "conflicting verbs: Enable and Disable both set"
        elif msg.enable:
            self.policy.set_enabled(True)
        elif msg.disable:
            self.policy.set_enabled(False)
        elif not msg.query:
            error = "no verb: set Query, Enable, or Disable"
        try:
            self.node.add_node(msg.src_id)
            self.node.transport.send(
                msg.src_id,
                PolicyCtlMsg(self.node.my_id,
                             table=self.policy.table(),
                             error=error, epoch=self.epoch))
        except (OSError, KeyError, ConnectionError) as e:
            log.error("policy ctl reply undeliverable",
                      dest=msg.src_id, err=repr(e))

    def serve_quarantined(self) -> Set[NodeID]:
        """The policy engine's serve-rotation mask (docs/autonomy.md):
        replicas the A/B split and rollout soak baselining route
        around.  Empty on an unarmed fleet."""
        return self.policy.quarantined()

    def policy_grow(self, model_node: NodeID, action_id: str) -> str:
        """Autonomy actuator (docs/autonomy.md): grow the replica set
        of ``model_node`` — copy its held layer set onto a placeable
        spare via a join+refill job through ``submit_job`` (the same
        chokepoint the join path uses), origin avoided.  Returns the
        job id, or "" when no spare exists / nothing to copy (the
        engine audits the skip)."""
        with self._lock:
            metas = dict(self.status.get(model_node) or {})
            busy = set(self.assignment) | {self.node.my_id}
        if not metas:
            return ""
        spares = self.membership.spares(busy | {model_node})
        if not spares:
            log.warn("policy grow: no placeable spare",
                     model=model_node)
            return ""
        spare = spares[0]
        target = {spare: {int(lid): LayerMeta(
            version=getattr(meta, "version", ""))
            for lid, meta in metas.items()}}
        jid = f"policy-{action_id}"
        self.submit_job(jid, target, kind="join",
                        avoid={self.node.my_id} - {model_node},
                        submitter="policy")
        log.warn("policy grow submitted", job=jid, model=model_node,
                 spare=spare, layers=len(metas))
        return jid

    def policy_rehome(self, node: NodeID, action_id: str) -> str:
        """Autonomy actuator (docs/autonomy.md): proactively re-home a
        death-suspect node's UNIQUE holdings before the failure
        detector's crash path fires — the drain plane's re-home
        derivation reused as a NON-destructive repair job (the suspect
        stays a member; if it was merely slow, the run just gained
        redundant copies).  Returns the job id, or "" when nothing is
        uniquely at risk."""
        with self._lock:
            target: Assignment = {}
            for lid, shard, codec in self._unique_holdings_locked(node):
                dest = self._rehome_dest_locked(node, lid, shard, codec)
                if dest is None:
                    log.warn("policy rehome: no placeable dest",
                             node=node, layer=lid)
                    continue
                target.setdefault(dest, {})[lid] = LayerMeta(
                    shard=shard, codec=codec)
                if codec:
                    # Same pinning as _drain_rehome: the re-home ships
                    # the qualified form the suspect holds.
                    self._codec_choice[(dest, lid)] = codec
                    self._codec_seen = True
        if not target:
            return ""
        jid = f"policy-{action_id}"
        # The suspect is NOT avoided as a source: it may be the only
        # holder — if it is truly dead its sends stall and the crash
        # path's salvage takes over; if it is slow, slow beats never.
        self.submit_job(jid, target, kind="repair", submitter="policy")
        log.warn("policy rehome submitted", job=jid, node=node,
                 layers=sorted(l for r in target.values() for l in r))
        return jid

    # ------------------------------------------------ elastic membership

    def _replicate_membership(self) -> None:
        """Replicate the full roster + the in-flight drain-job map (the
        delta REPLACES, like the hierarchy's group table — a revoked
        membership is exactly an absent row)."""
        with self._lock:
            drains = {jid: int(n) for jid, n in self._drain_jobs.items()}
        self._replicate("membership", Members=self.membership.to_json(),
                        DrainJobs=drains)

    def _install_member_addr(self, node: NodeID, addr: str) -> None:
        """Make an unconfigured seat dialable: joiners exist in nobody's
        config, so their wire address rides the membership plane."""
        if not addr:
            return
        try:
            self.node.transport.addr_registry[node] = addr
        except (AttributeError, TypeError):
            pass
        self.node.add_node(node)

    def _verify_member_source(self, node: NodeID, digests: dict) -> bool:
        """Whether this announcer's holdings may be TRUSTED as transfer
        sources (docs/membership.md).  Configured members are verified
        by the config; an unknown legacy announcer is seeded ACTIVE
        (pre-membership interop).  A JOINING seat verifies when every
        announced digest agrees with the leader's existing stamp for
        that layer — a mismatch keeps it a dest-only seat, loudly.
        Layers without a stamp (and joins with digests disabled) can't
        be cross-checked and verify trivially — an honest limit the
        docs own."""
        st = self.membership.state_of(node)
        if st is None:
            # A seat the roster never met: the pre-membership announce
            # path admitted such peers silently — keep doing so.
            self.membership.seed([node], epoch=self.epoch)
            return True
        if st != mship.JOINING:
            return True
        with self._lock:
            for lid, d in (digests or {}).items():
                stamped = self.layer_digests.get(lid)
                if (stamped is not None and stamped != d
                        and integrity.stamp_algo(stamped)
                        == integrity.stamp_algo(d)):
                    trace.count("membership.join_verify_failed")
                    log.error("joiner's announced digest conflicts with "
                              "the stamped one; holdings stay "
                              "quarantined (dest-only seat)",
                              node=node, layerID=lid, announced=d,
                              stamped=stamped)
                    return False
        if self.membership.verify_source(node):
            trace.count("membership.source_verified")
            log.info("joiner's holdings digest-verified; admitted as a "
                     "source", node=node)
            self._replicate_membership()
        return True

    def _layer_universe_locked(self) -> List[LayerID]:
        """The default join target: every layer the current goal names
        plus the leader's own store (a pre-start pure-seeder goal may
        be empty).  Lock held."""
        out = {int(l) for lids in self.assignment.values() for l in lids}
        out |= {int(l) for l in self.layers}
        return sorted(out)

    def _place_joiner(self, node: NodeID) -> NodeID:
        """The joiner's control parent: the leader itself in flat mode.
        The hierarchical leader overrides — grouped clusters absorb
        joiners into the least-loaded live group and the parent is that
        group's sub-leader (docs/membership.md)."""
        return self.node.my_id

    def handle_join(self, msg: JoinMsg) -> None:
        """Admission (docs/membership.md): an unconfigured node asked
        to join the running cluster.  It becomes a delivery DEST — a
        ``kind="join"`` refill job over the layer universe it wants
        (default: everything the current goal disseminates), submitted
        on its FIRST announce so cold-boot holdings (inventory,
        checkpointed partials, content-equal bytes under other ids)
        reduce the demand before anything ships, planned with every
        other demand and refilled from current peer holders (the origin
        seeder is avoided whenever peers can serve, so admission cost
        stops scaling with origin bandwidth) — and a SOURCE only once
        its announced holdings digest-verify.  Idempotent per (seat,
        generation): a retried request re-answers the same admit."""
        if msg.admitted:
            return  # admit/roster notices are receiver business
        if self._deposed:
            return  # the higher-epoch leader owns admission now
        node = msg.src_id
        if node == self.node.my_id:
            return
        rejoin = self.membership.is_left(node)
        rec = self.membership.admit(node, addr=msg.addr, epoch=self.epoch)
        self._install_member_addr(node, msg.addr)
        trace.count("membership.joins")
        log.info("membership: join request", node=node,
                 addr=msg.addr or None, rejoin=rejoin,
                 generation=rec.generation,
                 want=sorted(int(l) for l in msg.want) or "universe")
        want = sorted(int(l) for l in msg.want)
        # Mode 3 models NICs: an unconfigured joiner starts at the most
        # conservative configured rate (the solver never over-promises
        # an unknown link) — PINNED only until its announce carries its
        # own rate, which supersedes (docs/membership.md).
        bw_map = getattr(self, "node_network_bw", None)
        if bw_map is not None and node not in bw_map:
            known = [b for b in bw_map.values() if b > 0]
            bw_map[node] = min(known) if known else 0
            self._joiner_bw_pinned.add(node)
        parent = self._place_joiner(node)
        if parent == self.node.my_id:
            # The root monitors ungrouped joiners directly; a grouped
            # joiner's liveness belongs to its sub-leader's detector.
            self.detector.revive(node)
        self._replicate_membership()
        # Roster notices go out BEFORE any plan can command a send to
        # the joiner — a sender must be able to dial it — and the
        # joiner gets the existing fleet's addresses in return (it is
        # in nobody's config and has nobody's): NACK retransmits to a
        # peer source, failover leases, and peer pulls all need to
        # dial.
        self._broadcast_roster(node, msg.addr)
        self._introduce_peers(node)
        with self._lock:
            announced = node in self.status
            if not announced:
                self._join_pending[node] = want
        if announced:
            # A live re-join (the seat never left): refill immediately
            # against its current status row.
            self._admit_join_job(node, want)
        parent_addr = ""
        if parent != self.node.my_id:
            try:
                parent_addr = str(
                    self.node.transport.addr_registry.get(parent, ""))
            except AttributeError:
                parent_addr = ""
        try:
            self.node.transport.send(
                node, JoinMsg(self.node.my_id, node=node, admitted=True,
                              parent=parent, parent_addr=parent_addr,
                              epoch=self.epoch))
        except (OSError, KeyError, ConnectionError) as e:
            log.warn("join admit reply undeliverable (the joiner "
                     "retries)", node=node, err=repr(e))

    def _admit_join_job(self, node: NodeID, want: List[LayerID]) -> None:
        """Submit the joiner's refill job ([] want = the current layer
        universe).  Grouped joiners stay off this root's detector."""
        with self._lock:
            lids = [int(l) for l in want] or self._layer_universe_locked()
        if not lids:
            return
        gen = self.membership.generation_of(node)
        jid = f"join-{node}-g{gen}"
        self.submit_job(jid, {node: {int(lid): LayerMeta()
                                     for lid in lids}}, kind="join")
        if self._place_joiner(node) != self.node.my_id:
            # submit_job seeds a root-side lease for unknown dests; a
            # grouped joiner heartbeats its SUB-LEADER, never this root
            # — drop it or it expires into a false crash.
            self.detector.forget(node)
        job = self.jobs.get(jid)
        with self._lock:
            finished = self._startup_sent
        if job is not None and job.state == "done" and finished:
            # The refill resolved AT ADMISSION (the joiner's cold-boot
            # holdings already cover its want) against an already-met
            # goal: _maybe_finish will never re-fire, so the joiner's
            # StartupMsg — its ready() release — must go out directly.
            try:
                self.node.transport.send(
                    node, StartupMsg(self.node.my_id,
                                     boot=self.boot_enabled,
                                     serve=self._serve_promised,
                                     epoch=self.epoch))
            except (OSError, KeyError, ConnectionError) as e:
                log.warn("startup to resolved-at-admit joiner "
                         "undeliverable", node=node, err=repr(e))

    def _broadcast_roster(self, node: NodeID, addr: str) -> None:
        """Tell every live member the joiner's address — a later plan
        may command ANY of them to send to it.  Best-effort: a seat
        that missed the notice fails its send loudly and the re-plan
        re-routes."""
        if not addr:
            return
        with self._lock:
            peers = sorted(set(self.status) | set(self.standbys))
        out = JoinMsg(self.node.my_id, node=node, addr=addr,
                      admitted=True, epoch=self.epoch)
        for p in peers:
            if p in (node, self.node.my_id):
                continue
            try:
                self.node.transport.send(p, out)
            except (OSError, KeyError, ConnectionError) as e:
                log.debug("roster notice send failed", dest=p,
                          err=repr(e))

    def _introduce_peers(self, node: NodeID) -> None:
        """Roster notices TO the joiner: every (peer, addr) this leader
        can dial, so the joiner can answer any seat that later serves
        or commands it.  Best-effort, like the outbound roster."""
        try:
            entries = dict(self.node.transport.addr_registry)
        except (AttributeError, TypeError):
            return
        for peer, addr in sorted((int(p), str(a))
                                 for p, a in entries.items()
                                 if isinstance(p, int) and int(p) >= 0):
            if peer == node or not addr:
                continue
            try:
                self.node.transport.send(
                    node, JoinMsg(self.node.my_id, node=peer, addr=addr,
                                  admitted=True, epoch=self.epoch))
            except (OSError, KeyError, ConnectionError) as e:
                log.debug("peer introduction send failed", dest=node,
                          peer=peer, err=repr(e))
                return

    def handle_drain(self, msg: DrainMsg) -> None:
        """Planned departure (docs/membership.md): re-home the
        drainer's unique holdings onto survivors BEFORE it leaves —
        zero lost pairs, never post-crash salvage — then prune it from
        the detector, lease recipients, and announce gating atomically
        with the membership delta, and answer every requester."""
        if msg.done:
            return  # done notices are the drainer's business
        if self._deposed:
            return
        node = msg.node if msg.node >= 0 else msg.src_id
        requester = msg.src_id
        if node == self.node.my_id:
            self._answer_drain(requester, node,
                               error="cannot drain the leader seat")
            return
        st = self.membership.state_of(node)
        if st == mship.LEFT:
            self._answer_drain(requester, node)  # idempotent: it's out
            return
        if st is None:
            self._answer_drain(requester, node,
                               error=f"unknown member {node}")
            return
        with self._lock:
            self._drain_waiters.setdefault(node, set()).add(requester)
        if not self.membership.start_drain(node):
            if self.membership.is_left(node):
                # Lost the race with a concurrent finalize: it already
                # answered ITS waiter set — answer this straggler now
                # instead of leaking an orphaned waiter entry.
                with self._lock:
                    waiters = self._drain_waiters.pop(node, set())
                for w in sorted(waiters):
                    self._answer_drain(w, node)
            return  # already draining: the finalize answers every waiter
        trace.count("membership.drains")
        log.warn("membership: draining node (unique holdings re-home "
                 "before it leaves)", node=node, requested_by=requester)
        self._replicate_membership()
        self._drain_rehome(node)

    def _unique_holdings_locked(
            self, node: NodeID) -> List[Tuple[LayerID, str, str]]:
        """``(layer, shard, codec)`` holdings whose only live copy
        CAPABLE of satisfying the same demands is the drainer's —
        losing the seat without re-homing them would lose the pair.
        A full canonical holding is unique when no survivor holds the
        full raw layer; a QUALIFIED holding (shard slice, encoded form
        — docs/sharding.md, docs/codec.md) is unique when no survivor
        holds a covering shard in an accepting codec, and re-homes
        shard/codec-QUALIFIED (the drainer re-seeds its own form
        verbatim), never inflated to a whole raw layer it may not even
        be able to produce.  Lock held."""
        row = self.status.get(node) or {}
        unique: List[Tuple[LayerID, str, str]] = []
        for lid, meta in sorted(row.items()):
            if not delivered(meta):
                continue
            shard = meta.shard
            codec = getattr(meta, "codec", "")
            held_elsewhere = False
            for n, other in self.status.items():
                if (n == node or self.membership.is_left(n)
                        or self.membership.is_draining(n)):
                    continue
                m = other.get(lid)
                if (m is not None and delivered(m)
                        and shard_covers(m.shard, shard)
                        and codec_accepts(getattr(m, "codec", ""),
                                          codec)):
                    held_elsewhere = True
                    break
            if not held_elsewhere:
                unique.append((lid, shard, codec))
        return unique

    def _rehome_dest_locked(self, node: NodeID, lid: LayerID,
                            shard: str = "",
                            codec: str = "") -> Optional[NodeID]:
        """The survivor a draining node's unique holding re-homes onto:
        the lowest-id placeable announced seat without a satisfying
        copy (non-leader seats first — the leader is the fallback, not
        the default dumping ground).  Lock held."""
        placeable = self.membership.placeable()
        candidates = [n for n in sorted(self.status)
                      if n != node and n in placeable
                      and n != self.node.my_id]
        candidates.append(self.node.my_id)
        for n in candidates:
            if n == node or n not in placeable:
                continue
            if codec and codec_capability(codec) not in \
                    self.node_codecs.get(n, ()):
                # A codec-qualified re-home pins the wire codec onto
                # the dest (_drain_rehome), bypassing the negotiation's
                # advertised-decode check — so enforce it here: never
                # ship encoded bytes to a seat that can't decode them.
                continue
            base_d = delta_base_digest(codec)
            if base_d and not (
                    self.content.node_has(n, base_d)
                    or (n == self.node.my_id
                        and base_d in self._delta_base_src)):
                # A delta re-home additionally needs the BASE bytes at
                # the new seat — capability alone can't reconstruct.
                continue
            meta = self.status.get(n, {}).get(lid)
            if (meta is not None and delivered(meta)
                    and shard_covers(meta.shard, shard)
                    and codec_accepts(getattr(meta, "codec", ""),
                                      codec)):
                continue
            return n
        return None

    def _drain_rehome(self, node: NodeID) -> None:
        """Plan (or finish) one drain: submit the re-home job for the
        drainer's unique holdings — full canonical AND shard/codec-
        qualified — or finalize
        immediately when nothing unique remains.  Also the takeover
        re-drive (docs/membership.md: a promoted leader resumes adopted
        drains in the bumped epoch)."""
        with self._lock:
            target: Assignment = {}
            qualified = 0
            for lid, shard, codec in self._unique_holdings_locked(node):
                dest = self._rehome_dest_locked(node, lid, shard, codec)
                if dest is None:
                    log.error("no survivor can take a draining node's "
                              "unique holding; its bytes leave with it",
                              node=node, layerID=lid,
                              shard=shard or None, codec=codec or None)
                    continue
                target.setdefault(dest, {})[lid] = LayerMeta(
                    shard=shard, codec=codec)
                if shard or codec:
                    qualified += 1
                    if codec:
                        # Pin the codec CHOICE so the stamp/accounting
                        # machinery treats the re-home exactly like a
                        # negotiated encoded pair (the dest accounts,
                        # journals, and acks in encoded byte space).
                        self._codec_choice[(dest, lid)] = codec
                        self._codec_seen = True
            n_prior = sum(1 for n in self._drain_jobs.values()
                          if n == node)
        if qualified:
            trace.count("membership.qualified_rehomed", qualified)
        if not target:
            self._finalize_drain(node)
            return
        gen = self.membership.generation_of(node)
        jid = (f"drain-{node}-g{gen}" if n_prior == 0
               else f"drain-{node}-g{gen}.{n_prior}")
        with self._lock:
            self._drain_jobs[jid] = node
        log.info("drain re-home job submitted", node=node, job=jid,
                 layers=sorted({int(l) for r in target.values()
                                for l in r}),
                 dests=sorted(target))
        self.submit_job(jid, target, kind="drain")
        job = self.jobs.get(jid)
        if job is not None and job.state == "done":
            # Admission found every re-home already satisfied (or the
            # survivors' acks landed synchronously): finish now.
            self._on_drain_job_done(jid)

    def _on_drain_job_done(self, jid: str) -> None:
        """A completed ``kind="drain"`` re-home job releases its
        drainer (no-op for every other job)."""
        with self._lock:
            node = self._drain_jobs.pop(jid, None)
        if node is not None:
            self._finalize_drain(node)

    def _forget_sender_jobs(self, node: NodeID) -> None:
        """Hook: a departed seat's dispatched sends are forgotten —
        never range-salvaged (mode 3 overrides; the base scheduler
        tracks none)."""

    def _finalize_drain(self, node: NodeID) -> None:
        """The atomic prune: DRAINING → LEFT together with removal from
        status, the goal, the failure detector, lease recipients, and
        announce gating — after this, nothing the departed seat does
        (or fails to do) can fire ``crash()`` or the salvage path."""
        if not self.membership.complete_drain(node):
            return
        # Ban BEFORE the state prune: a straggler heartbeat landing
        # between the two must not re-arm a lease that later expires
        # into a false crash.
        self.detector.remove(node)
        with self._lock:
            self.status.pop(node, None)
            dropped = self.assignment.pop(node, None)
            if self._base_assignment is not self.assignment:
                self._base_assignment.pop(node, None)
            self.expected_nodes.discard(node)
            self.partial_status.pop(node, None)
            # A clean leave is not a crash: nothing is parked for a
            # revival resume, and none of its pairs enter range salvage.
            self._dropped_assignment.pop(node, None)
            self._salvaging = {p for p in self._salvaging
                               if p[1] != node}
            waiters = self._drain_waiters.pop(node, set())
        self._forget_sender_jobs(node)
        self.content.drop_node(node)
        trace.count("membership.drained")
        log.warn("membership: node drained and released", node=node,
                 had_assignment=bool(dropped))
        self._replicate_membership()
        self._replicate("member_left", Node=node)
        affected, finished = self.jobs.drop_dest(node)
        for jid in affected:
            self._replicate("job", **self.jobs.record(jid))
        self._jobs_completed(finished)
        for w in sorted(waiters | {node}):
            if w == self.node.my_id:
                continue
            try:
                self.node.add_node(w)
                self.node.transport.send(
                    w, DrainMsg(self.node.my_id, node=node, done=True,
                                epoch=self.epoch))
            except (OSError, KeyError, ConnectionError) as e:
                log.debug("drain done notice undeliverable", dest=w,
                          err=repr(e))
        # A cleanly-departed pod member breaks its pod the same way a
        # crashed one does (docs/fabric.md): survivors' unfinished pod
        # pairs degrade to host-path delivery.
        self._pods_member_gone(node)
        self._drive(self._recover)
        self._maybe_finish()
        self._maybe_complete_boot_wait()

    def _answer_drain(self, requester: NodeID, node: NodeID,
                      error: str = "") -> None:
        """Every drain request is ANSWERED (the serving invariant),
        refusals included."""
        if requester == self.node.my_id:
            return
        try:
            self.node.add_node(requester)
            self.node.transport.send(
                requester, DrainMsg(self.node.my_id, node=node,
                                    done=not error, error=error,
                                    epoch=self.epoch))
        except (OSError, KeyError, ConnectionError) as e:
            log.debug("drain answer undeliverable", dest=requester,
                      err=repr(e))

    def _resume_joins(self) -> None:
        """Takeover re-drive: an adopted JOINING member whose refill
        job never replicated (the admit raced the old leader's death)
        gets a fresh pending entry — its next announce (triggered by
        the takeover lease) submits the job at the bumped epoch."""
        active = set(self.jobs.table())
        for node in self.membership.joining():
            gen = self.membership.generation_of(node)
            if f"join-{node}-g{gen}" in active:
                continue
            with self._lock:
                self._join_pending.setdefault(node, [])
            log.info("adopted joiner without a replicated refill job; "
                     "re-admitting on its next announce", node=node)

    def _resume_drains(self) -> None:
        """Takeover re-drive: every adopted DRAINING member either has
        its re-home job resumed by the job plane (active record), or is
        re-planned/finalized afresh at the bumped epoch."""
        for node in self.membership.draining():
            with self._lock:
                jids = [j for j, n in self._drain_jobs.items()
                        if n == node]
            if any((job := self.jobs.get(j)) is not None
                   and job.state == "active" for j in jids):
                log.info("adopted drain still re-homing; the resumed "
                         "job plane carries it", node=node)
                continue
            # The re-home record finished (or was lost with the dead
            # leader): recompute and finish — or re-plan — now.
            with self._lock:
                for j in jids:
                    self._drain_jobs.pop(j, None)
            self._drain_rehome(node)

    def _content_skip_locked(self, dest: NodeID, layer_id: LayerID) -> bool:
        """Lock held.  True when shipping (dest, layer) would be wasted
        wire bytes: a job claims the pair AND the content index shows
        the dest already holds content-equal bytes under another layer
        id — the dest's own digest-stamp resolve acks it locally
        (docs/service.md).  Gated on job ownership so pre-service peers
        (which lack the resolve path) are never starved.  Sharded
        targets never content-skip: their resolve key is the (digest,
        range) pair, and full-layer vouching doesn't carry it
        (docs/sharding.md, honest limits)."""
        want = (self.assignment.get(dest) or {}).get(layer_id)
        if want is not None and (want.shard or want.codec):
            # Sharded and codec targets resolve by (digest, range/codec)
            # keys that full-layer raw vouching doesn't carry
            # (docs/sharding.md, docs/codec.md — honest limits).
            return False
        if self.jobs.owner_of(dest, layer_id) is None:
            return False
        digest = self.layer_digests.get(layer_id)
        if not digest or not self.content.node_has(dest, digest):
            return False
        # Count + log once per PAIR, not per replan consultation — the
        # counter is "content-equal pairs never shipped", and replans
        # re-consult every pair.
        if (layer_id, dest) not in self._content_skip_seen:
            self._content_skip_seen.add((layer_id, dest))
            trace.count("store.leader_skipped")
            log.info("content store: dest holds content-equal bytes; "
                     "skipping the wire ship", layerID=layer_id,
                     dest=dest, digest=digest)
        return True

    def _drive(self, replan) -> None:
        """The shared goal-chasing tail of crash()/update(): start if the
        change unblocked the start, finish if the goal is already met,
        otherwise run the supplied re-planner."""
        with self._lock:
            started = self._started
        if not started:
            if self._maybe_start():
                self.send_layers()
                self._maybe_finish()
            return
        self._maybe_finish()
        with self._lock:
            finished = self._startup_sent
        if not finished:
            replan()

    def send_layers(self) -> None:
        """Leader sends every missing assigned layer itself
        (node.go:326-352) — over the device fabric when one is wired.
        A sharded target (docs/sharding.md) ships as exactly its shard's
        byte range over the host path (the fabric plane speaks whole
        layers only); a wire-codec target (docs/codec.md) ships its
        ENCODED form over the host path the same way."""
        self._stamp_targets()
        for node_id, layer_ids in self.assignment.items():
            for layer_id, want in layer_ids.items():
                with self._lock:
                    meta = self.status.get(node_id, {}).get(layer_id)
                    skip = (meta is None
                            and self._content_skip_locked(node_id,
                                                          layer_id))
                if satisfies(meta, want) or skip:
                    continue
                layer = self.layers.get(layer_id)
                if layer is None:
                    log.warn("no layers found", layerID=layer_id)
                    continue
                if (not want.shard and not want.codec
                        and self._try_fabric_full_layer(
                            layer_id, self.node.my_id, node_id)):
                    continue
                owner = self.jobs.owner_of(node_id, layer_id)
                self.loop.submit(self._send_one, node_id, layer_id, layer,
                                 owner[1] if owner else "", want.shard,
                                 want.codec)

    def _send_one(self, dest: NodeID, layer_id: LayerID, layer,
                  job_id: str = "", shard: str = "",
                  codec: str = "") -> None:
        try:
            send_layer(self.node, dest, layer_id, layer, job_id=job_id,
                       shard=shard, codec=codec, codecs=self.codecs)
        except Exception as e:  # noqa: BLE001
            log.error("couldn't send a layer", layerID=layer_id, err=repr(e))

    # --------------------------------------------------- device-fabric plane

    def handle_device_plan(self, msg: DevicePlanMsg) -> None:
        """The leader can be a seeder in a device plan (it dispatches the
        plan to itself like any other participant); it is never a fabric
        *dest* — ``_fabric_ok`` routes those to the host path."""
        if self.fabric is None or self.placement is None:
            log.error("device plan but no fabric wired", plan=msg.plan_id)
            return
        if self._spmd:
            # Multi-controller lockstep: the leader's process enters every
            # collective too (seeder or not).
            try:
                self.fabric.submit(msg)
            except Exception as e:  # noqa: BLE001
                log.error("spmd fabric submit failed", plan=msg.plan_id,
                          err=repr(e))
            return
        contribute_device_plan(self.node, self.layers, self._lock,
                               self.fabric, self.placement, msg)

    def _fabric_ok(
        self, layer_id: LayerID, layout: List[Tuple[NodeID, int, int]],
        dest: NodeID, total: int,
    ) -> bool:
        """Whether one scheduled transfer can ride the device fabric:
        fabric + placement wired, every participant mapped to a stage, and
        no sender serving the layer from an external client (a client's
        bytes live outside the fabric — host path).  Status rows are read
        under ``_lock``: pool-concurrent handlers insert rows
        (``handle_ack``) and pop them (``crash``), and a torn ``LayerMeta``
        view here could route a CLIENT-held layer onto the fabric."""
        if self.fabric is None or self.placement is None:
            return False
        if self._fabric_disabled:
            # SPMD lockstep needs every process alive; after a declared
            # crash the remaining transfers ride the host path.
            return False
        if self._spmd:
            # The SPMD collective reassembles the WHOLE layer from the
            # plan alone — it has no dest-side coverage seeding, so a
            # resumed dest's gaps-only layout (mode-3 checkpoint resume)
            # must ride the host path, not livelock the fabric.
            pos = 0
            for _, off, size in sorted(layout, key=lambda t: t[1]):
                if off != pos:
                    return False
                pos += size
            if pos != total:
                return False
            # Each sender's ranges must fit its stage's device slots:
            # the executor would otherwise raise deterministically on
            # every process and the dest's recovery re-announce would
            # disable the fabric for the whole run — reject the one
            # transfer here instead.
            ranges_per: Dict[NodeID, int] = {}
            for sender, _, _ in layout:
                ranges_per[sender] = ranges_per.get(sender, 0) + 1
            for sender, count in ranges_per.items():
                if sender not in self.placement.node_to_stage:
                    return False
                if count > len(self.placement.devices_for_node(sender)):
                    return False
        if dest == self.node.my_id or dest not in self.placement.node_to_stage:
            return False
        for sender, _, _ in layout:
            if sender not in self.placement.node_to_stage:
                return False
        with self._lock:
            for sender, _, _ in layout:
                meta = self.status.get(sender, {}).get(layer_id)
                if meta is None or meta.location == LayerLocation.CLIENT:
                    trace.count("fallback.fabric_client_host_path")
                    log.warn("transfer source is outside the fabric; host "
                             "path", layerID=layer_id, sender=sender,
                             dest=dest)
                    return False
        return True

    def _dispatch_device_plan(
        self, layer_id: LayerID, dest: NodeID,
        layout: List[Tuple[NodeID, int, int]], total: int,
        batch_id: str = "", batch_n: int = 1, pod=None,
    ) -> bool:
        """Send the plan to every participant; the layer bytes themselves
        never touch the transport (the fabric carries them).  Returns
        False when any participant missed the plan — the caller must then
        deliver over the host path instead (liveness: an incomplete plan
        would strand the dest waiting on contributions that never come,
        or pin seeders' uploads that nobody collects).

        ``batch_id``/``batch_n``: plan-batching hint (mode 3 groups
        same-dest equal-size plans) — the dest finishes the whole group
        as one batched gather instead of N serial collectives."""
        seq = next(self._plan_seq)
        self._plan_seq_hint = seq + 1
        self._replicate("plan_seq", Seq=seq + 1)
        plan_id = f"{layer_id}.{dest}.{seq}"
        spmd = self._spmd
        msg = DevicePlanMsg(self.node.my_id, plan_id, layer_id, dest,
                            total, list(layout), seq=seq if spmd else -1,
                            batch_id=batch_id, batch_n=batch_n,
                            pod=sorted(pod or []), epoch=self.epoch)
        with self._lock:
            active = not self._startup_sent
        if active:
            # Dispatching for an unfinished goal (first cycle, or a
            # re-armed update()): upload retention may re-arm — the next
            # startup will release again.
            reopen_upload_cache()
        if spmd:
            ok = self._broadcast_spmd_plan(msg)
        else:
            ok = self._send_inproc_plan(msg)
        if not ok:
            trace.count("fallback.fabric_plan_undelivered")
        if ok:
            log.info("dispatching device plan", plan=plan_id, layer=layer_id,
                     dest=dest, senders=sorted({s for s, _, _ in layout}),
                     total_bytes=total, spmd=spmd)
        return ok

    def _send_inproc_plan(self, msg: DevicePlanMsg) -> bool:
        # Dest first: if the dest never learns of the plan, abort before
        # any seeder uploads a contribution nobody will collect.
        try:
            self.node.transport.send(msg.dest_id, msg)
        except (OSError, KeyError) as e:
            log.error("couldn't send device plan to dest; host path",
                      plan=msg.plan_id, dest=msg.dest_id, err=repr(e))
            return False
        ok = True
        for participant in sorted(
            {s for s, _, _ in msg.layout} - {msg.dest_id}
        ):
            try:
                self.node.transport.send(participant, msg)
            except (OSError, KeyError) as e:
                log.error("couldn't send device plan to seeder; host path",
                          plan=msg.plan_id, dest=participant, err=repr(e))
                ok = False
        # On partial failure the dest's collect for this plan will time
        # out and discard any partial contributions; the host-path
        # duplicate delivery is tolerated by every receiver.
        return ok

    def _broadcast_spmd_plan(self, msg: DevicePlanMsg) -> bool:
        """SPMD lockstep: EVERY process (self included, via the transport
        self-delivery short-circuit) must receive every plan — all of them
        enter the collective.  On any send failure the seq must still be
        consumed everywhere, so a best-effort CANCELLATION (empty layout,
        same seq) follows.  Either way, the OPERATIVE message for the seq
        is retained (``_sent_plans``) so a process that missed its copy
        can ask for a re-send (``handle_plan_resend``) instead of
        stalling the pod until a human reads the logs."""
        with self._lock:
            recipients = sorted(set(self.status)
                                | {msg.dest_id, self.node.my_id})
            self._sent_plans[msg.seq] = msg
            while len(self._sent_plans) > self.SENT_PLAN_RETENTION:
                dropped = next(iter(self._sent_plans))
                self._sent_plans.pop(dropped)
                self._plan_watch.pop(dropped, None)
            self._plan_watch[msg.seq] = {"t": time.monotonic(),
                                         "retries": 0}
        failed = []
        for r in recipients:
            try:
                self.node.transport.send(r, msg)
            except (OSError, KeyError) as e:
                log.error("couldn't send spmd plan; cancelling seq",
                          plan=msg.plan_id, dest=r, err=repr(e))
                failed.append(r)
        if not failed:
            return True
        cancel = DevicePlanMsg(self.node.my_id, msg.plan_id, msg.layer_id,
                               msg.dest_id, 0, [], seq=msg.seq,
                               epoch=self.epoch)
        with self._lock:
            # The cancel supersedes the plan for this seq: a late
            # re-send of the ORIGINAL would have the gap process enter a
            # collective its peers already skipped.
            self._sent_plans[msg.seq] = cancel
        for r in recipients:
            try:
                self.node.transport.send(r, cancel)
            except (OSError, KeyError) as e:
                log.error("spmd plan cancel undeliverable; the gap "
                          "process will request a re-send",
                          plan=msg.plan_id, dest=r, err=repr(e))
        return False

    def handle_plan_resend(self, msg) -> None:
        """A fabric process's executor is stalled on missing plan seqs:
        re-send the retained message for each (the plan, or the cancel
        that superseded it).  An unknown seq gets a fresh CANCELLATION —
        advancing the requester past the hole is always safe, because a
        plan the leader no longer knows is one whose outcome the goal
        no longer depends on (its dest either acked or re-announced)."""
        with self._lock:
            stored = {s: self._sent_plans.get(s) for s in msg.seqs}
        for seq, plan in sorted(stored.items()):
            if plan is None:
                plan = DevicePlanMsg(self.node.my_id, f"cancel.{seq}",
                                     0, msg.src_id, 0, [], seq=seq,
                                     epoch=self.epoch)
            try:
                self.node.transport.send(msg.src_id, plan)
                log.info("re-sent spmd plan after gap report",
                         seq=seq, dest=msg.src_id,
                         cancelled=not plan.layout)
            except (OSError, KeyError) as e:
                log.error("plan re-send failed", seq=seq,
                          dest=msg.src_id, err=repr(e))

    def _try_fabric_full_layer(
        self, layer_id: LayerID, sender: NodeID, dest: NodeID
    ) -> bool:
        """Route a single-source full-layer send (modes 0-2) over the
        fabric; returns False when it must go the host path."""
        with self._lock:
            meta = self.status.get(sender, {}).get(layer_id)
            size = meta.data_size if meta is not None else 0
            if size <= 0 and sender == self.node.my_id:
                src = self.layers.get(layer_id)
                size = src.data_size if src is not None else 0
        if size <= 0:
            return False
        layout = [(sender, 0, size)]
        if not self._fabric_ok(layer_id, layout, dest, size):
            return False
        return self._dispatch_device_plan(layer_id, dest, layout, size)

    def handle_layer(self, msg: LayerMsg) -> None:
        """The leader can itself receive layers (e.g. from a client pipe):
        store + ack (node.go:376-407)."""
        with self._lock:
            src = msg.layer_src
            src.meta = LayerMeta(location=LayerLocation.INMEM)
            self.layers[msg.layer_id] = src
        self.node.transport.send(
            self.node.leader_id,
            AckMsg(self.node.my_id, msg.layer_id, LayerLocation.INMEM),
        )

    def _ack_liveness(self, src_id: NodeID) -> bool:
        """The ack path's liveness gate: False = the sender is written
        off and the ack must be ignored; True also refreshes its lease.
        The hierarchical leader overrides for GROUPED members — their
        liveness belongs to the sub-leader's detector, so an aggregated
        ack must neither create a root-side lease nor bounce off one
        (docs/hierarchy.md)."""
        if self.detector.is_dead(src_id):
            # Re-creating the status row would resurrect the node as a
            # schedulable sender that no one monitors anymore.
            log.warn("ignoring ack from crashed node", node=src_id)
            return False
        self.detector.touch(src_id)
        return True

    def handle_ack(self, msg: AckMsg) -> None:
        """Record delivery; on satisfaction broadcast startup + signal ready
        (node.go:410-432)."""
        if msg.src_id != self.node.my_id:
            if self.membership.is_left(msg.src_id):
                # A departed member's straggler ack must not recreate
                # its status row (docs/membership.md).
                trace.count("membership.zombie_fenced")
                log.warn("ack from a departed member fenced",
                         node=msg.src_id)
                return
            if not self._ack_liveness(msg.src_id):
                return
        with self._lock:
            row = self.status.setdefault(msg.src_id, {})
            # Carry the layer's size into the new owner's status entry (the
            # ack doesn't repeat it): schedulers size transfers from status,
            # and a size-less entry would wrongly disqualify this owner as
            # a future fabric sender for the layer it just received.
            prev = row.get(msg.layer_id)
            size = prev.data_size if prev is not None else 0
            if size <= 0:
                size = self._layer_size_locked(msg.layer_id)
            # Shard-qualified holding (docs/sharding.md): a shard ack
            # records a PARTIAL holding; never let it narrow a wider one
            # the row already has (a full copy covers every shard).
            shard = msg.shard
            if (prev is not None and delivered(prev)
                    and shard_covers(prev.shard, msg.shard)):
                shard = prev.shard
            # Version-qualified holding (docs/swap.md): an unversioned
            # duplicate re-ack must not strip a versioned holding's tag
            # (that would un-satisfy the swap pair and re-plan it).
            version = msg.version
            if (not version and prev is not None and delivered(prev)
                    and prev.version):
                version = prev.version
            # Codec-qualified holding (docs/codec.md): the ack reports
            # the form the dest's bytes are actually in — trusted
            # verbatim (a raw re-delivery over a stale quantized
            # holding must be able to upgrade the row to raw, or the
            # pair livelocks re-planning forever).
            codec = msg.codec
            row[msg.layer_id] = LayerMeta(location=msg.location,
                                          data_size=size, shard=shard,
                                          version=version, codec=codec)
            # A delivered (layer, dest) pair needs no more salvage, and
            # stops aging for health scoring.
            self._salvaging.discard((msg.layer_id, msg.src_id))
            getattr(self, "_pair_dispatch_mono", {}).pop(
                (msg.src_id, msg.layer_id), None)
            # The watchdog stops chasing any plan this ack settles.
            for seq, _rec in list(self._plan_watch.items()):
                plan = self._sent_plans.get(seq)
                if (plan is not None and plan.dest_id == msg.src_id
                        and plan.layer_id == msg.layer_id):
                    del self._plan_watch[seq]
        self._replicate("ack", Node=msg.src_id, Layer=msg.layer_id,
                        Location=int(msg.location), Size=size,
                        Shard=shard, Version=version, Codec=codec)
        # Pair-lifecycle span (docs/observability.md): the delivery's
        # terminal control edge — staged→acked is the ack-propagation +
        # leader-handling attribution.  The receiver's advisory SpanId
        # wins (it is the span its own events filed under); a legacy
        # ack falls back to the deterministic id.
        telemetry.span_event(
            msg.span_id or telemetry.span_id(msg.src_id, msg.layer_id),
            "acked", node=self.node.my_id, dest=msg.src_id,
            layer=msg.layer_id, shard=shard, version=version,
            codec=codec)
        # Content index + job plane: the delivered copy verified against
        # the stamped digest before acking, so the new owner vouches for
        # those bytes; the ack credits every admitted job wanting the
        # pair (docs/service.md).  A SHARD ack vouches for its (range
        # digest, shard) key only — it can never alias-complete a
        # full-layer pair (docs/sharding.md) — and a CODEC ack for its
        # (encoded digest, codec) key only (docs/codec.md).
        with self._lock:
            if shard:
                # A shard ack vouches for its RANGE's bytes only —
                # codec-qualified when the range hashes the encoded
                # blob (pod pairs); the FULL codec digest must never
                # stand in for it (docs/sharding.md, docs/codec.md).
                digest = self._range_digest_cache.get(
                    (msg.layer_id, _range_key(shard, codec)))
            elif codec:
                digest = self._codec_digest_cache.get(
                    (msg.layer_id, codec))
            else:
                digest = self.layer_digests.get(msg.layer_id)
        self.content.add(msg.src_id, msg.layer_id, digest, shard=shard,
                         codec=codec)
        self._jobs_completed(
            self.jobs.on_ack(msg.src_id, msg.layer_id, shard=shard,
                             version=version, codec=codec))
        # Fabric-assisted pod delivery (docs/fabric.md): a shard ack may
        # complete a pod's NIC phase (the SPMD gather dispatches here);
        # a full ack is the pair's materialized tree landing.
        self._on_pod_ack(msg.src_id, msg.layer_id, shard, codec)
        self._maybe_finish()

    def _jobs_completed(self, job_ids) -> None:
        """Log + replicate job completions (no-op on an empty list).
        A completed ``kind="swap"`` job drives its fence: clean
        completion commits, a degraded one aborts (docs/swap.md).  A
        completed ``kind="drain"`` re-home job releases its drainer
        (docs/membership.md)."""
        for jid in job_ids:
            job = self.jobs.get(jid)
            trace.count("jobs.completed")
            log.info("dissemination job complete", job=jid,
                     **(job.summary() if job is not None else {}))
            self._replicate("job_done", JobID=jid)
            self._on_swap_job_done(jid)
            self._on_drain_job_done(jid)

    def _layer_size_locked(self, layer_id: LayerID) -> int:
        """A layer's full size: the max announced ``data_size`` across
        status rows.  Iterates ``status`` — callers MUST hold ``_lock``
        (pool-concurrent handlers insert/pop rows)."""
        size = 0
        for layer_metas in self.status.values():
            meta = layer_metas.get(layer_id)
            if meta is not None and meta.data_size > size:
                size = meta.data_size
        return size

    def _maybe_finish(self) -> None:
        """Fire startup + ready exactly once when the (possibly shrunk)
        assignment is satisfied."""
        with self._lock:
            if self._startup_sent or not assignment_satisfied(
                self.assignment, self.status
            ) or self._pods_open_locked():
                return
            self._startup_sent = True
            # Replicate INSIDE the lock (publish only enqueues): every
            # writer of _startup_sent enqueues its delta under this
            # lock, so the standbys' shadow sees the flag flips in
            # write order — a completion racing a submit_job/update
            # re-arm must not land its Sent=True AFTER the re-arm's
            # Sent=False (a takeover would then adopt "FINISHED" and
            # never re-drive the admitted work).
            self._replicate("startup", Sent=True)
        log.info("timer stop: startup")
        self.send_startup()
        # End-of-delivery telemetry dump: the folded cluster table goes
        # into the log stream (the single source of truth the offline
        # run report and trace tooling read).  Reports are periodic, so
        # the last interval's bytes may still be in flight — the
        # -report path re-folds later, at process exit.
        self.log_cluster_metrics()
        self._ready_q.put(self.assignment)
        # Startup may have been unblocked by crashes that already emptied
        # the boot wait's remaining set (every assignee dead before
        # announcing): nothing will ever report, so complete it here —
        # with the crashes visible in boot_kinds — instead of holding the
        # CLI for its whole -bw timeout.
        self._maybe_complete_boot_wait()

    # ------------------------------------------------------------- failures

    def _recover(self) -> None:
        """Re-drive delivery after a crash; mode-specific schedulers
        override this when re-running ``send_layers`` wholesale would
        corrupt their job state."""
        self.send_layers()

    def crash(self, node_id: NodeID) -> None:
        """Remove a dead node and re-plan around it — the reference's
        never-implemented ``crash(n node)`` (node.go:218-220).

        A dead *sender*'s duties are re-scheduled onto the survivors.  A
        dead *assignee* is dropped from the assignment (its layers can
        never land), loudly, so the rest of the cluster still converges."""
        if node_id == self.node.my_id:
            log.error("refusing to declare self crashed")
            return
        if self.membership.is_left(node_id):
            # A cleanly-departed member can never crash: the drain
            # pruned it from every liveness table, and any straggler
            # report naming it is fenced (docs/membership.md).
            trace.count("membership.zombie_fenced")
            log.info("crash report for a departed member ignored",
                     node=node_id)
            return
        if self._spmd:
            # Every process must enter every collective; one is gone, so
            # remaining transfers take the host path.  Already-queued
            # plans referencing the dead node stall their executors — the
            # dests' plan waits time out and re-plan over TCP.
            log.error("node crashed under spmd fabric; disabling the "
                      "device plane for the rest of the run",
                      node=node_id)
            self._fabric_disabled = True
        self.detector.forget(node_id)
        cancels = []
        with self._lock:
            self.status.pop(node_id, None)
            # The crash broke pod lockstep for good (fabric disabled
            # above): every still-unacked plan can no longer execute, so
            # CANCEL each watched seq — this is the one moment the
            # give-up cancel is safe AND useful (peers stuck inside a
            # collective are already waiting on the dead participant;
            # gap processes must not wait forever on plans that will
            # never run).  The watchdog itself never cancels while no
            # crash is declared (_plan_watchdog).
            if self._spmd:
                for seq in list(self._plan_watch):
                    plan = self._sent_plans.get(seq)
                    del self._plan_watch[seq]
                    if plan is not None and plan.layout:
                        cancels.append((seq, plan))
            recipients = set(self.status) | {self.node.my_id}
            dropped = self.assignment.pop(node_id, None)
            if self._base_assignment is not self.assignment:
                self._base_assignment.pop(node_id, None)
            if dropped:
                # Remembered so a restarted incarnation that re-announces
                # gets its layers back (resume after declared death).
                self._dropped_assignment[node_id] = dropped
            self.expected_nodes.discard(node_id)
            # A dead assignee that never reported must stay VISIBLE as
            # "crashed" — erasing it would let the CLI report a
            # successful TTFT (exit 0) for a run where the model never
            # booted anywhere.  One that DID report keeps its record: a
            # receiver that booted fine, exited, and then had its lease
            # expire is a completed deployment, not a failure.
            if node_id not in self._boot_kinds:
                self._booted.pop(node_id, None)
                if dropped:
                    self._boot_kinds[node_id] = "crashed"
        for seq, plan in cancels:
            log.error("cancelling unacked spmd plan after declared crash",
                      seq=seq, plan=plan.plan_id, crashed=node_id)
            self._send_plan_to(self._make_plan_cancel(seq, plan),
                               recipients | {plan.dest_id}, seq)
        if dropped:
            log.error("crashed node was an assignee; dropping its layers",
                      node=node_id, layers=sorted(dropped))
        self._replicate("crash", Node=node_id,
                        Dropped=(layer_ids_to_json(dropped)
                                 if dropped else None))
        # Job plane: the dead dest's pairs can never land — drop them
        # from every admitted job (counted as dropped_pairs, so a job
        # completed this way is visibly degraded) and stop trusting the
        # node's content holdings.  Every MUTATED job record
        # re-replicates: a standby restoring admit-time remaining sets
        # would otherwise resurrect the dead dest's pairs at takeover
        # and wedge the adopted goal.
        self.content.drop_node(node_id)
        # A serving replica died mid-rollout: the swap can no longer
        # land everywhere — abort (v1 keeps serving on the survivors)
        # BEFORE the job drops mark it "done with drops" (docs/swap.md).
        # Rollout waves mid-flip/soak fail FIRST: a dead canary must
        # read as a breach (pause + revert), never as a silent no_data
        # pass — and failing the wave before the fence-set prune below
        # keeps the prune's completion edge from opening a soak window
        # on a wave that just lost a replica.
        self.rollouts.on_replica_crashed(node_id)
        pruned = []
        with self._lock:
            dead_swaps = [v for v, rec in self._swaps.items()
                          if rec["state"] == "rolling"
                          and node_id in rec["dests"]]
            for v, rec in self._swaps.items():
                # A COMMITTED swap's dead dest can never confirm: drop
                # it from the fence set so the watchdog completes on
                # the survivors.
                if rec["state"] == "committed" and node_id in rec["dests"]:
                    rec["dests"] = [d for d in rec["dests"]
                                    if d != node_id]
                    pruned.append(v)
        for version in pruned:
            # The prune must REPLICATE like every other swap mutation,
            # or a promoted standby re-adopts the dead dest and chases
            # its confirmation through the whole re-send budget.
            self._replicate_swap(version)
            # The dead dest may have been the LAST unconfirmed one:
            # the prune completes the fence set, so the completion
            # edge (finalize round / soak open) must fire here — no
            # further confirm will ever arrive to fire it.
            self._maybe_swap_complete(version)
        for version in dead_swaps:
            self._abort_swap(version, f"dest {node_id} crashed mid-rollout")
        if self.membership.is_draining(node_id):
            # The drainer died MID-drain: that is a real crash (the
            # salvage above applies — its unsent re-home bytes may be
            # lost), but the seat is terminally out: fence its
            # generation and answer waiters loudly instead of silence.
            self.membership.mark_left(node_id)
            with self._lock:
                waiters = self._drain_waiters.pop(node_id, set())
                for jid in [j for j, n in self._drain_jobs.items()
                            if n == node_id]:
                    del self._drain_jobs[jid]
            self._replicate_membership()
            for w in sorted(waiters):
                self._answer_drain(w, node_id,
                                   error=f"node {node_id} crashed "
                                         "mid-drain")
        affected, finished = self.jobs.drop_dest(node_id)
        for jid in affected:
            self._replicate("job", **self.jobs.record(jid))
        self._jobs_completed(finished)
        # Fabric-assisted pod delivery (docs/fabric.md): a dead pod
        # member's pod degrades to host-path delivery — survivors must
        # not wait on a gather contribution that can never arrive.
        self._pods_member_gone(node_id)
        self._drive(self._recover)
        # The crash may have removed the last assignee the boot/TTFT wait
        # was blocked on.
        self._maybe_complete_boot_wait()

    def send_startup(self) -> None:
        with self._lock:
            receivers = list(self.status)
        serve = self.serve_members() is not None
        self._serve_promised = serve  # a later cancel must release waiters
        for node_id in receivers:
            try:
                self.node.transport.send(
                    node_id,
                    StartupMsg(self.node.my_id, boot=self.boot_enabled,
                               serve=serve, epoch=self.epoch),
                )
            except (OSError, KeyError) as e:
                log.error("failed to send startup", dest=node_id, err=repr(e))
        if self.fabric is not None:
            release_upload_cache()  # the leader can be a fabric seeder too


class RetransmitLeaderNode(LeaderNode):
    """Mode 1: peers that already own a layer forward it (node.go:472-626)."""

    MODE = 1

    def __init__(self, node: Node, layers: LayersSrc, assignment: Assignment,
                 start_loop: bool = True,
                 expected_nodes: Optional[Set[NodeID]] = None,
                 failure_timeout: float = 0.0, fabric=None, placement=None,
                 **ha):
        self.layer_owners: Dict[LayerID, Set[NodeID]] = {}
        super().__init__(node, layers, assignment, start_loop=start_loop,
                         expected_nodes=expected_nodes,
                         failure_timeout=failure_timeout,
                         fabric=fabric, placement=placement, **ha)

    def crash(self, node_id: NodeID) -> None:
        """A dead node no longer serves its layers; re-run the owner
        scheduling for everything unacked (receivers tolerate duplicate
        deliveries, so re-sending in-flight layers is safe)."""
        with self._lock:
            for owners in self.layer_owners.values():
                owners.discard(node_id)
        super().crash(node_id)

    def _build_layer_owners(self) -> None:
        """(Re)index layer → owner set from live status (node.go:558-571).
        Rebuilt from scratch: status is the source of truth, and a
        restarted node no longer owns what its dead incarnation held.
        FULL CANONICAL holdings only: a shard-holder (docs/sharding.md)
        can't forward a whole layer, and a CODEC holder's bytes are the
        encoded form — forwarding them as a raw delivery would ship
        garbage under the layer's identity (docs/codec.md; mode 1/2's
        coarse per-layer pool can't express per-pair admissibility, so
        quantized holders simply never re-seed here — honest limit,
        mode 3's arc filter does it exactly).  UNVERIFIED joiners
        (docs/membership.md) are quarantined too: their announced
        holdings are not trusted as forward sources until they
        digest-verify."""
        self.layer_owners = {}
        quarantined = self.membership.unverified_sources()
        for node_id, layer_ids in self.status.items():
            if node_id in quarantined:
                continue
            for layer_id, meta in layer_ids.items():
                if meta.shard or getattr(meta, "codec", ""):
                    continue
                self.layer_owners.setdefault(layer_id, set()).add(node_id)

    def send_layers(self) -> None:
        self._stamp_targets()
        with self._lock:
            self._build_layer_owners()
            owners_by_layer = {k: set(v) for k, v in self.layer_owners.items()}
        for node_id, layer_ids in self.assignment.items():
            for layer_id, want in layer_ids.items():
                with self._lock:
                    held = self.status.get(node_id, {}).get(layer_id)
                    if self._content_skip_locked(node_id, layer_id):
                        continue
                if satisfies(held, want):
                    continue  # dest already holds its target (shard-aware)
                jid_owner = self.jobs.owner_of(node_id, layer_id)
                jid = jid_owner[1] if jid_owner else ""
                owners = owners_by_layer.get(layer_id, set())
                owners = owners - {node_id}
                if want.codec:
                    # A codec pair's owner must be able to ENCODE the
                    # forward (the pool holds raw full holders only;
                    # docs/codec.md) — and a delta pair's owner must
                    # ALSO hold the base it encodes against.
                    with self._lock:
                        owners = {o for o in owners
                                  if codec_capability(want.codec)
                                  in self.node_codecs.get(o, ())}
                        base_d = delta_base_digest(want.codec)
                        if base_d:
                            owners = {
                                o for o in owners
                                if self.content.node_has(o, base_d)
                                or (o == self.node.my_id
                                    and base_d in self._delta_base_src)}
                if owners:
                    # Deterministic owner pick (reference picks randomly via
                    # map iteration, node.go:583-588).
                    owner = min(owners)
                    try:
                        self.send_retransmit(layer_id, owner, node_id,
                                             job_id=jid, shard=want.shard,
                                             codec=want.codec)
                    except Exception as e:  # noqa: BLE001
                        log.error(
                            "couldn't send retransmit",
                            layerID=layer_id, owner=owner, err=repr(e),
                        )
                else:
                    layer = self.layers.get(layer_id)
                    if layer is None:
                        log.warn("no layers found", layerID=layer_id)
                        continue
                    if (not want.shard and not want.codec
                            and self._try_fabric_full_layer(
                                layer_id, self.node.my_id, node_id)):
                        continue
                    self.loop.submit(self._send_one, node_id, layer_id,
                                     layer, jid, want.shard, want.codec)

    def send_retransmit(self, layer_id: LayerID, owner: NodeID,
                        dest: NodeID, job_id: str = "",
                        shard: str = "", codec: str = "") -> None:
        """Ask ``owner`` to forward ``layer_id`` to ``dest``; leader-owned
        layers go out directly (node.go:611-626).  With a fabric wired the
        forward becomes a one-source device plan — the owner's copy enters
        the fabric from its own stage and lands in the dest's HBM with no
        TCP byte stream (modes 1 and 2 share this path).  ``shard``:
        forward only that byte-range slice (host path only — the fabric
        plane speaks whole layers).  ``codec``: forward the ENCODED form
        (host path only, docs/codec.md)."""
        # Pair-lifecycle span (docs/observability.md): the pair entered
        # a concrete plan NOW (modes 0-2's forward command; mode 3's
        # flow dispatch records its own).
        telemetry.span_event(telemetry.span_id(dest, layer_id), "planned",
                             node=self.node.my_id, src=owner, dest=dest,
                             layer=layer_id, job=job_id, codec=codec,
                             shard=shard)
        if (not shard and not codec
                and self._try_fabric_full_layer(layer_id, owner, dest)):
            return
        if owner == self.node.my_id:
            layer = self.layers.get(layer_id)
            if layer is None:
                log.warn("no layers found", layerID=layer_id)
                return
            # Off the caller's thread: send_layers drives this in a loop,
            # and an inline rate-paced send would serialize every
            # leader-owned transfer behind the previous one (mode 0's
            # sends are pooled for the same reason, node.go:343-349).
            self.loop.submit(self._send_one, dest, layer_id, layer, job_id,
                             shard, codec)
            return
        self.node.transport.send(
            owner, RetransmitMsg(self.node.my_id, layer_id, dest,
                                 epoch=self.epoch, job_id=job_id,
                                 shard=shard, codec=codec)
        )


class _JobInfo:
    """Mode-2 job table entry (node.go:639-647)."""

    __slots__ = ("sender", "status", "t_start")
    PENDING = 0
    SENDING = 1

    def __init__(self, sender: Optional[NodeID] = None):
        self.sender = sender
        self.status = _JobInfo.PENDING
        self.t_start: Optional[float] = None


class PullRetransmitLeaderNode(RetransmitLeaderNode):
    """Mode 2: pull/work-stealing scheduler (node.go:662-1073).

    Rarest-first initial assignment to the min-loaded owner; every ack frees
    its sender, which immediately pulls its rarest remaining job or steals a
    pending job from the slowest/overloaded sender (estimated by moving-
    average job duration × queue length)."""

    MODE = 2
    # Mode 2's pull/steal tables pick senders per layer with no
    # per-pair codec admissibility: it never chooses wire codecs
    # (docs/codec.md, honest limits).
    WIRE_CODEC_OK = False

    def __init__(self, node: Node, layers: LayersSrc, assignment: Assignment,
                 start_loop: bool = True,
                 expected_nodes: Optional[Set[NodeID]] = None,
                 failure_timeout: float = 0.0, fabric=None, placement=None,
                 **ha):
        # layer -> dest -> pull job (the mode-2 work-stealing table;
        # renamed from ``jobs`` when the SERVICE job plane took that
        # name on the base class, docs/service.md)
        self._pull_jobs: Dict[LayerID, Dict[NodeID, _JobInfo]] = {}
        self.sender_load: Dict[NodeID, int] = {}
        # sender -> (avg job duration seconds, completed count)
        self.performance: Dict[NodeID, Tuple[float, int]] = {}
        super().__init__(node, layers, assignment, start_loop=start_loop,
                         expected_nodes=expected_nodes,
                         failure_timeout=failure_timeout,
                         fabric=fabric, placement=placement, **ha)

    def crash(self, node_id: NodeID) -> None:
        """Surgical job-table repair: jobs destined for the dead node are
        dropped; jobs it was sending (or queued to send) are orphaned for
        ``_recover`` to reassign.  Living senders' load counters for
        dropped jobs are left as-is — they only bias the min-load
        heuristic, and self-correct as jobs complete."""
        with self._lock:
            self.sender_load.pop(node_id, None)
            self.performance.pop(node_id, None)
            for layer_id in list(self._pull_jobs):
                dests = self._pull_jobs[layer_id]
                dests.pop(node_id, None)
                for job in dests.values():
                    if job.sender == node_id:
                        job.sender = None
                        job.status = _JobInfo.PENDING
                        job.t_start = None
                if not dests:
                    del self._pull_jobs[layer_id]
        super().crash(node_id)

    def _release_pending_load(self, job: "_JobInfo") -> None:
        """Give back a superseded job's load slot (held only while
        PENDING — a pull already decremented it).  Lock held."""
        if job.status == _JobInfo.PENDING and job.sender is not None:
            self.sender_load[job.sender] = max(
                0, self.sender_load.get(job.sender, 1) - 1
            )

    def _schedule_missing_locked(
        self, dest: NodeID, replace_existing: bool = False
    ) -> Set[NodeID]:
        """Create PENDING jobs for ``dest``'s undelivered assigned layers
        and return the senders to kick.  Lock held.  With
        ``replace_existing`` the dest's current jobs are superseded (a
        restarted dest's in-flight transfers are dead)."""
        kicked: Set[NodeID] = set()
        for node_id in self.status:
            self.sender_load.setdefault(node_id, 0)
        held = self.status.get(dest, {})
        for layer_id, want in self.assignment.get(dest, {}).items():
            if satisfies(held.get(layer_id), want):
                continue
            old = self._pull_jobs.get(layer_id, {}).get(dest)
            if old is not None and not replace_existing:
                continue  # already queued or in flight
            sender = self._min_loaded_sender(layer_id)
            if sender is None:
                log.error("no owner for missing assigned layer",
                          layer=layer_id, dest=dest)
                continue
            if old is not None:
                self._release_pending_load(old)
            self._pull_jobs.setdefault(layer_id, {})[dest] = _JobInfo(sender)
            self.sender_load[sender] = self.sender_load.get(sender, 0) + 1
            kicked.add(sender)
        return kicked

    def _on_reannounce(self, node_id: NodeID) -> None:
        """Rebuild jobs for a restarted assignee's still-missing layers
        (its in-flight transfers died with the old process) and kick the
        chosen senders.  Jobs the restarted node was *sending* also died
        with it: those are reset to PENDING (kept with the node if it
        still owns the layer, orphaned otherwise) and re-driven."""
        kicked: Set[NodeID] = set()
        orphaned = False
        with self._lock:
            self._build_layer_owners()
            for layer_id, dests in self._pull_jobs.items():
                for dest, job in dests.items():
                    if job.sender != node_id or job.status != _JobInfo.SENDING:
                        continue
                    job.t_start = None
                    job.status = _JobInfo.PENDING
                    if layer_id in self.status.get(node_id, {}):
                        # Still owns it (e.g. disk layer): re-drive there.
                        self.sender_load[node_id] = (
                            self.sender_load.get(node_id, 0) + 1
                        )
                        kicked.add(node_id)
                    else:
                        job.sender = None  # _recover reassigns orphans
                        orphaned = True
            kicked |= self._schedule_missing_locked(node_id,
                                                    replace_existing=True)
        if orphaned:
            self._recover()
        for sender in kicked:
            self.loop.submit(self._assign_new_job_safe, sender)

    def _update_replan(self) -> None:
        """Incremental job-table repair for a changed assignment: prune
        PENDING jobs whose dest is no longer assigned the layer (in-flight
        SENDING jobs are left to finish — their acks re-kick the sender,
        and receivers tolerate the extra delivery), create jobs for newly
        missing (dest, layer) pairs, and kick their senders."""
        kicked: Set[NodeID] = set()
        with self._lock:
            self._build_layer_owners()
            for layer_id in list(self._pull_jobs):
                dests = self._pull_jobs[layer_id]
                for dest in list(dests):
                    job = dests[dest]
                    if (layer_id not in self.assignment.get(dest, {})
                            and job.status == _JobInfo.PENDING):
                        self._release_pending_load(dests.pop(dest))
                if not dests:
                    del self._pull_jobs[layer_id]
            for dest in self.assignment:
                kicked |= self._schedule_missing_locked(dest)
        for sender in kicked:
            self.loop.submit(self._assign_new_job_safe, sender)

    def _recover(self) -> None:
        """Reassign orphaned jobs to the min-loaded surviving owner and
        kick those senders (instead of the base full ``send_layers`` rerun,
        which would rebuild the live job table from scratch)."""
        kicked: Set[NodeID] = set()
        with self._lock:
            for layer_id, dests in self._pull_jobs.items():
                for dest, job in dests.items():
                    if job.sender is not None:
                        continue
                    sender = self._min_loaded_sender(layer_id)
                    if sender is None:
                        log.error("no surviving owner for orphaned job",
                                  layer=layer_id, dest=dest)
                        continue
                    job.sender = sender
                    self.sender_load[sender] += 1
                    kicked.add(sender)
        for sender in kicked:
            self.loop.submit(self._assign_new_job_safe, sender)

    def send_layers(self) -> None:
        """Build the job table rarest-first and kick every node
        (node.go:810-904)."""
        with self._lock:
            self._build_layer_owners()
            # Rarest-first layer order, layer-id tiebreak (node.go:842-851).
            sorted_layers = sorted(
                self.layer_owners,
                key=lambda lid: (len(self.layer_owners[lid]), lid),
            )
            for dest, layer_ids in self.assignment.items():
                held = self.status.get(dest, {})
                for layer_id, want in layer_ids.items():
                    if not satisfies(held.get(layer_id), want):
                        self._pull_jobs.setdefault(layer_id, {})[dest] = _JobInfo()
            for node_id in self.status:
                self.sender_load.setdefault(node_id, 0)
            for layer_id in sorted_layers:
                for dest in sorted(self._pull_jobs.get(layer_id, {})):
                    sender = self._min_loaded_sender(layer_id)
                    self._pull_jobs[layer_id][dest] = _JobInfo(sender)
                    self.sender_load[sender] += 1
                    log.info("job assignment", layer=layer_id, sender=sender)
            # Kick every node that might have work: assignment dests AND
            # loaded senders.  (The reference kicks only assignment nodes,
            # node.go:890-903, which strands jobs assigned to the leader
            # when no peer owns a layer.)
            nodes = sorted(
                set(self.assignment)
                | {s for s, load in self.sender_load.items() if load > 0}
            )
        for node_id in nodes:
            self.loop.submit(self._assign_new_job_safe, node_id)

    def _assign_new_job_safe(self, node_id: NodeID) -> None:
        try:
            self.assign_new_job(node_id)
        except Exception as e:  # noqa: BLE001
            log.error("failed to assign a new job", node=node_id, err=repr(e))

    def _min_loaded_sender(self, layer_id: LayerID) -> NodeID:
        """Owner with the fastest source rate, then least load, then lowest
        id (node.go:948-978)."""
        best, best_rate, min_count = None, -1, 1 << 62
        for sender in sorted(self.sender_load):
            count = self.sender_load[sender]
            meta = self.status.get(sender, {}).get(layer_id)
            if meta is None or meta.shard:
                # A shard-holder can't forward the whole layer
                # (docs/sharding.md); it never enters the sender pool.
                continue
            rate = meta.limit_rate if meta.limit_rate != 0 else 1 << 62
            if rate > best_rate or (
                rate == best_rate
                and (count < min_count or (count == min_count and sender < best))
            ):
                best, best_rate, min_count = sender, rate, count
        return best

    def _rarest_own_job(
        self, node_id: NodeID
    ) -> Optional[Tuple[LayerID, NodeID, _JobInfo]]:
        """This node's still-pending job with the rarest layer
        (node.go:981-1010)."""
        best = None
        min_owners = 1 << 62
        for layer_id, own_meta in self.status.get(node_id, {}).items():
            if own_meta.shard:
                continue  # shard holders don't forward (docs/sharding.md)
            for dest, job in self._pull_jobs.get(layer_id, {}).items():
                if job.sender != node_id or job.status != _JobInfo.PENDING:
                    continue
                owners = len(self.layer_owners.get(layer_id, ()))
                if owners < min_owners or (
                    best is not None and owners == min_owners and layer_id < best[0]
                ):
                    min_owners = owners
                    best = (layer_id, dest, job)
        return best

    def _rarest_stealable_job(
        self, node_id: NodeID
    ) -> Optional[Tuple[LayerID, NodeID, NodeID]]:
        """A pending job owned by a slower/overloaded sender that this node
        could serve instead (node.go:1012-1073)."""
        best = None  # (layer, dest, sender, owner_count, time_to_finish)
        for layer_id, own_meta in self.status.get(node_id, {}).items():
            if own_meta.shard:
                continue  # shard holders don't forward (docs/sharding.md)
            owner_count = len(self.layer_owners.get(layer_id, ()))
            for dest, job in self._pull_jobs.get(layer_id, {}).items():
                sender = job.sender
                if sender is None:
                    continue
                # Normalize the 0-means-unlimited sentinel before comparing
                # (the reference's raw comparison lets a slow node steal
                # from an unlimited-rate sender, node.go:1039-1040).
                _raw_s = self.status.get(sender, {}).get(layer_id, LayerMeta()).limit_rate
                _raw_n = self.status.get(node_id, {}).get(layer_id, LayerMeta()).limit_rate
                sender_rate = _raw_s if _raw_s != 0 else 1 << 62
                node_rate = _raw_n if _raw_n != 0 else 1 << 62
                if (
                    sender == node_id
                    or job.status != _JobInfo.PENDING
                    or self.sender_load.get(sender, 0) == 0
                    or node_rate < sender_rate
                ):
                    continue
                perf = self.performance.get(sender)
                if perf is None:
                    # Sender stuck on its first job: steal with priority.
                    ttf = float("inf")
                else:
                    ttf = perf[0] * self.sender_load.get(sender, 0)
                cand = (layer_id, dest, sender, owner_count, ttf)
                if (
                    best is None
                    or cand[3] < best[3]
                    or (cand[3] == best[3] and cand[4] > best[4])
                ):
                    best = cand
        if best is None:
            return None
        return best[0], best[1], best[2]

    def assign_new_job(self, node_id: NodeID) -> None:
        """The scheduling loop body (node.go:909-945)."""
        with self._lock:
            own = self._rarest_own_job(node_id)
            if own is not None:
                layer_id, dest, job = own
                job.status = _JobInfo.SENDING
                job.t_start = time.monotonic()
                self.sender_load[node_id] -= 1
                sender = node_id
            else:
                stolen = self._rarest_stealable_job(node_id)
                if stolen is None:
                    log.info("there is no job left to assign", node=node_id)
                    return
                layer_id, dest, prev_sender = stolen
                self.sender_load[prev_sender] -= 1
                job = self._pull_jobs[layer_id][dest]
                job.sender = node_id
                job.status = _JobInfo.SENDING
                job.t_start = time.monotonic()
                sender = node_id
                log.debug("steal a job", layer=layer_id, frm=prev_sender, to=node_id)
        jid_owner = self.jobs.owner_of(dest, layer_id)
        with self._lock:
            want = (self.assignment.get(dest) or {}).get(layer_id)
        self.send_retransmit(layer_id, sender, dest,
                             job_id=jid_owner[1] if jid_owner else "",
                             shard=want.shard if want is not None else "")

    def handle_ack(self, msg: AckMsg) -> None:
        """Completion accounting + throughput tracking + re-scheduling
        (node.go:741-807)."""
        super().handle_ack(msg)
        with self._lock:
            job = self._pull_jobs.get(msg.layer_id, {}).get(msg.src_id)
            if job is None:
                return  # e.g. a client-loaded layer: no tracked job
            log.info("job completed", node=job.sender, layerID=msg.layer_id)
            dur = (
                time.monotonic() - job.t_start if job.t_start is not None else 0.0
            )
            avg, count = self.performance.get(job.sender, (0.0, 0))
            self.performance[job.sender] = ((avg * count + dur) / (count + 1), count + 1)
            # The new owner can now serve this layer too — unless it
            # holds only a shard of it (docs/sharding.md).
            if not msg.shard:
                self.layer_owners.setdefault(msg.layer_id, set()).add(
                    msg.src_id)
            del self._pull_jobs[msg.layer_id][msg.src_id]
            sender = job.sender
        if sender is not None:
            self._assign_new_job_safe(sender)


class FlowRetransmitLeaderNode(RetransmitLeaderNode):
    """Mode 3: globally optimal plan via time-parameterized max-flow
    (node.go:1076-1288).

    Unlike the reference, which supports only one destination per layer
    (node.go:1078, error at :1092), the flow graph here models a vertex
    per (layer, dest) pair, so one layer can be scheduled to any number
    of receivers — each needing its own full copy — with per-sender
    contributions still exactly attributable (PP-stage replication needs
    this).  Crash recovery needs no dest bookkeeping: the re-plan derives
    everything from assignment + status."""

    MODE = 3

    def __init__(
        self,
        node: Node,
        layers: LayersSrc,
        assignment: Assignment,
        node_network_bw: Dict[NodeID, int],
        start_loop: bool = True,
        expected_nodes: Optional[Set[NodeID]] = None,
        failure_timeout: float = 0.0,
        fabric=None,
        placement=None,
        topology=None,
        pods=None,
        **ha,
    ):
        """``topology``: optional ``sched.flow.PodTopology`` — multi-slice
        pods plan cross-slice transfers against the per-pair DCN
        capacity instead of pretending every edge is ICI.

        ``pods`` (docs/fabric.md): ``{pod_id: [member node ids]}`` —
        groups of dests sharing an ICI domain.  A layer every member of
        a pod wants ships as ONE 1/R shard per host over the NIC
        (possibly quantized), and the full tree materializes over the
        on-mesh gather — pod NIC ingress is O(model_bytes), not
        O(model_bytes x replicas).  Members must be disjoint across
        pods and must not include the leader seat."""
        self.node_network_bw = dict(node_network_bw)
        self.topology = topology
        self.pods: Dict[int, List[NodeID]] = {}
        self._pod_of: Dict[NodeID, int] = {}
        for pid, members in sorted((pods or {}).items()):
            ms = sorted(int(m) for m in members)
            if int(node.my_id) in ms:
                raise ValueError("the leader seat cannot be a pod member")
            for m in ms:
                if m in self._pod_of:
                    raise ValueError(
                        f"node {m} appears in more than one pod")
                self._pod_of[m] = int(pid)
            self.pods[int(pid)] = ms
        # Pods that lost a member (crash/drain) degrade to host-path
        # delivery for the rest of the run — a silent mid-flight
        # re-shard would strand partials in dead byte spaces.
        self._pods_broken: Set[int] = set()
        # (layer, dest) -> monotonic time of the pair's SHARD ack: the
        # gather watchdog degrades pairs whose full tree never follows.
        self._pod_shard_acked: Dict[Tuple[LayerID, NodeID], float] = {}
        # (layer, pod) gathers already dispatched on the SPMD fabric.
        self._pod_gather_sent: Set[Tuple[LayerID, int]] = set()
        self._pod_plane_warned = False
        # sender -> dispatched (not yet known-delivered) flow jobs: the
        # range-salvage index — crash(sender) re-plans only its jobs'
        # DESTS' uncovered byte ranges (docs/failover.md).
        self._live_jobs: Dict[NodeID, List[FlowJob]] = {}
        # The INITIAL solve's predicted completion time (ms) and wall
        # solve cost — prediction-vs-achieved is the plan-fidelity
        # record the CLI prints next to TTD (re-plans keep the first
        # full solve: that is the prediction the TTD clock started on).
        self.predicted_ttd_ms = 0
        self.solve_ms = 0.0
        # job_id -> its priority tier's solved min time (ms): per-job
        # pacing for multi-job dispatches (docs/service.md).
        self._tier_time: Dict[str, int] = {}
        # Autonomy link demotions (docs/autonomy.md): (src, dest) ->
        # measured bytes/s.  The flow solver prices these arcs at the
        # measured rate instead of infinity, so re-plans route AROUND a
        # straggling link without removing it from the graph.
        self._link_demotions: Dict[Tuple[NodeID, NodeID], int] = {}
        # Plan generation: bumped on every solve.  Revokes carry the
        # generation they fenced; re-dispatched commands carry the NEW
        # one — a late revoke can no longer eat the re-plan's fresh
        # command for the same (job, dest, layer) (docs/service.md).
        self._plan_gen = 0
        if topology is not None:
            # Pre-warm the LP solver import (scipy + HiGHS, ~1-2 s cold)
            # off the critical path: the first assign_jobs otherwise pays
            # it inside the TTD clock.
            threading.Thread(
                target=self._warm_lp, name="lp-warm", daemon=True
            ).start()
        super().__init__(node, layers, assignment, start_loop=start_loop,
                         expected_nodes=expected_nodes,
                         failure_timeout=failure_timeout,
                         fabric=fabric, placement=placement, **ha)
        if self.pods and start_loop:
            threading.Thread(target=self._pod_watchdog,
                             name="pod-watchdog", daemon=True).start()

    @staticmethod
    def _warm_lp() -> None:
        from ..sched.flow import warm_lp

        warm_lp()

    def _register_handlers(self) -> None:
        super()._register_handlers()
        # register_keep on a shared loop: a promoted mode-3 worker keeps
        # its own (equivalent) flow-job handler.
        reg = (self.loop.register_keep if self._shared_loop
               else self.loop.register)
        reg(FlowRetransmitMsg, self.handle_flow_retransmit)

    def _node_bw(self, node_id: NodeID) -> int:
        """Mode 3 models NICs: the codec-choice bottleneck estimate
        uses them (docs/codec.md)."""
        return self.node_network_bw.get(node_id, 0)

    def send_layers(self) -> None:
        self._stamp_targets()
        t, self_jobs, jobs = self.assign_jobs()
        self._dispatch(t, self_jobs, jobs)

    def _plan_assignment_locked(self) -> Assignment:
        """The goal ``assign_jobs`` plans over — the full assignment in
        flat mode; the hierarchical leader reduces grouped members to
        group-ingress demands (docs/hierarchy.md).  Lock held."""
        return self.assignment

    # ------------------------------------------ fabric-assisted pod delivery

    # How long a pod pair may sit shard-complete without its FULL tree
    # ack before the whole (layer, pod) degrades to host-path delivery,
    # and the check cadence (class attrs: tests tune them).
    POD_GATHER_TIMEOUT = 60.0
    POD_WATCH_PERIOD = 1.0

    def _pod_plane_available(self) -> bool:
        """Whether the pod members have an ICI reconstruction plane:
        the SPMD lockstep fabric (the leader dispatches the gather), or
        a shared single-controller ``FabricPlane`` whose shard board the
        members self-coordinate over.  Without one, pod pairs would
        shard-deliver and then wedge waiting for peers that can never
        be reached — plan flat instead, loudly (the "hosts without a
        fabric fall back to the host path" rule, docs/fabric.md)."""
        if self._fabric_disabled:
            return False
        if self._spmd:
            return True
        return self.fabric is not None and hasattr(self.fabric,
                                                   "pod_publish")

    def _stamp_pod_shards(self) -> None:
        """The pod-delivery demand transform (docs/fabric.md; the
        pricing half lives in ``sched.flow.pod_shard_demands``): every
        layer ALL members of a pod want as a plain full target is
        re-targeted as one 1/R shard slice per member — the NIC then
        carries ~model_bytes per pod (x codec ratio), and the ICI
        gather materializes the other R-1 copies.  Idempotent across
        re-plans: existing pairs keep their specs verbatim (mid-flight
        partials live in those byte ranges)."""
        if not self.pods:
            return
        if not self._pod_plane_available():
            if not self._pod_plane_warned:
                self._pod_plane_warned = True
                log.warn("pods configured but no reconstruction plane "
                         "(fabric missing/disabled); pod pairs plan "
                         "flat over the host path")
            return
        added = []
        redrive: Set[Tuple[LayerID, int]] = set()
        with self._lock:
            live = {pid: [m for m in ms if m in self.assignment]
                    for pid, ms in self.pods.items()
                    if pid not in self._pods_broken}
            live = {pid: ms for pid, ms in live.items() if len(ms) >= 2}
            if not live:
                return
            # ADOPTION (failover re-derivation): a promoted leader's
            # replicated assignment already carries the predecessor's
            # pod shard specs, which the transform below deliberately
            # refuses to re-slice — recognize a consistent 1/R@k
            # pattern across a pod's members as the SAME pod pairs, or
            # the goal would close on shard acks with no gather ever
            # driven (the open-until-materialized invariant).
            for pid, ms in live.items():
                layers = sorted({lid for m in ms
                                 for lid in (self.assignment.get(m)
                                             or {})})
                for lid in layers:
                    if any((lid, m) in self._pod_pairs for m in ms):
                        continue
                    speced = []
                    for m in ms:
                        meta = (self.assignment.get(m) or {}).get(lid)
                        if meta is None or not meta.shard \
                                or meta.version:
                            continue
                        speced.append((m, meta.shard))
                    n = len(speced)
                    if n < 2 or [s for _, s in speced] != [
                            f"1/{n}@{k}" for k in range(n)]:
                        continue
                    for m, spec in speced:
                        self._pod_pairs[(lid, m)] = spec
                    redrive.add((lid, pid))
                    log.info("adopted in-flight pod pairs from the "
                             "replicated goal", layerID=lid, pod=pid,
                             members=[m for m, _ in speced])
            pairs = pod_shard_demands(self.assignment, live,
                                      prior=self._pod_pairs)
            for (lid, dest), spec in sorted(pairs.items()):
                row = self.assignment.get(dest)
                meta = (row or {}).get(lid)
                if meta is None or meta.version:
                    continue
                if (lid, dest) in self._pod_pairs:
                    # A goal re-merge (update/submit_job) rebuilds the
                    # assignment spec-less: re-apply the STABLE prior
                    # spec, exactly like _stamp_codecs re-applies its
                    # memoized choices.
                    if not meta.shard:
                        row[lid] = dataclasses.replace(meta, shard=spec)
                    continue
                row[lid] = dataclasses.replace(meta, shard=spec)
                self._pod_pairs[(lid, dest)] = spec
                added.append((lid, dest, spec))
        if added:
            trace.count("pod.pairs_planned", len(added))
            log.info("pod delivery planned",
                     pairs=len(added),
                     layers=sorted({lid for lid, _, _ in added}))
        # Re-drive adopted pods whose shard phase already finished
        # under the predecessor: seed the gather clock (the watchdog
        # must cover them) and, under SPMD, dispatch the gather —
        # no further shard ack will arrive to trigger it.
        for lid, pid in sorted(redrive):
            with self._lock:
                if not self._pod_shards_ready_locked(lid, pid):
                    continue
                now = time.monotonic()
                for m in self.pods.get(pid, ()):
                    if (lid, m) in self._pod_pairs:
                        self._pod_shard_acked.setdefault((lid, m), now)
            if self._spmd:
                self._maybe_dispatch_pod_gather(lid, pid)

    def _pods_open_locked(self) -> bool:
        """Lock held.  A pod pair is OPEN until its dest's status row
        shows the FULL wire-form tree (shard "" in an accepting codec)
        — shard coverage alone must not finish the goal
        (docs/fabric.md: the gathered tree is the deliverable)."""
        for (lid, dest), spec in self._pod_pairs.items():
            want = (self.assignment.get(dest) or {}).get(lid)
            if want is None or want.shard != spec:
                continue  # degraded/dropped pair: the plain goal rules
            held = self.status.get(dest, {}).get(lid)
            if (held is None or not delivered(held) or held.shard
                    or not codec_accepts(held.codec, want.codec)):
                return True
        return False

    def _on_pod_ack(self, dest: NodeID, layer_id: LayerID, shard: str,
                    codec: str) -> None:
        key = (layer_id, dest)
        with self._lock:
            spec = self._pod_pairs.get(key)
            if spec is None:
                return
            if not shard:
                # The materialized tree landed: the pair is closed (the
                # watchdog stops aging it).
                self._pod_shard_acked.pop(key, None)
                trace.count("pod.pairs_materialized")
                log.info("pod pair materialized its full tree",
                         layerID=layer_id, dest=dest,
                         codec=codec or None)
                return
            pid = self._pod_of.get(dest)
            # The gather clock starts only when the POD's shard set is
            # COMPLETE — no tree can materialize before the last shard
            # lands, so aging a pair from its own (possibly first) ack
            # would spuriously degrade a pod whose other members are
            # still legitimately downloading.
            if pid is not None and self._pod_shards_ready_locked(
                    layer_id, pid):
                now = time.monotonic()
                for m in self.pods.get(pid, ()):
                    if (layer_id, m) in self._pod_pairs:
                        self._pod_shard_acked.setdefault(
                            (layer_id, m), now)
        if self._spmd and pid is not None:
            self._maybe_dispatch_pod_gather(layer_id, pid)

    def _pod_shards_ready_locked(self, layer_id: LayerID,
                                 pid: int) -> bool:
        """Lock held.  Whether every member of ``pid`` with a pod pair
        for ``layer_id`` has delivered its shard (the reconstruction
        phase can begin — and be timed)."""
        any_pair = False
        for m in self.pods.get(pid, ()):
            spec = self._pod_pairs.get((layer_id, m))
            if spec is None:
                continue
            any_pair = True
            held = self.status.get(m, {}).get(layer_id)
            if (held is None or not delivered(held)
                    or not shard_covers(held.shard, spec)):
                return False
        return any_pair

    def _pod_wire_total_locked(self, layer_id: LayerID, codec: str) -> int:
        """Lock held.  The pod pair's wire-space total: encoded bytes
        for a codec pair, the canonical layer size otherwise."""
        if codec and self.codecs is not None:
            n = self.codecs.nbytes(layer_id, codec)
            if n is not None:
                return n
        return self._layer_size_locked(layer_id)

    def _maybe_dispatch_pod_gather(self, layer_id: LayerID,
                                   pid: int) -> None:
        """SPMD pods: once EVERY member of ``pid`` acked its shard of
        ``layer_id``, broadcast ONE reconstruction plan — layout = the
        members' shard ranges, ``pod`` = the members (all of them keep
        the gathered tree).  The members then verify the full wire-form
        digest and ack the FULL layer (receiver._await_spmd_plan)."""
        with self._lock:
            if (layer_id, pid) in self._pod_gather_sent:
                return
            members = [m for m in self.pods.get(pid, ())
                       if (layer_id, m) in self._pod_pairs]
            if len(members) < 2:
                return
            codec = ""
            layout = []
            for m in members:
                spec = self._pod_pairs[(layer_id, m)]
                held = self.status.get(m, {}).get(layer_id)
                want = (self.assignment.get(m) or {}).get(layer_id)
                if (held is None or not delivered(held)
                        or not shard_covers(held.shard, spec)):
                    return  # a member's shard is still in flight
                codec = want.codec if want is not None else held.codec
            total = self._pod_wire_total_locked(layer_id, codec)
            if total <= 0:
                return
            for m in members:
                off, size = shard_range(self._pod_pairs[(layer_id, m)],
                                        total)
                layout.append((m, off, size))
            self._pod_gather_sent.add((layer_id, pid))
        layout.sort(key=lambda t: t[1])
        dest = min(members)
        if not self._fabric_ok(layer_id, layout, dest, total):
            log.warn("pod gather not fabric-eligible; members keep "
                     "their shards (watchdog will degrade)",
                     layerID=layer_id, pod=pid)
            return
        trace.count("pod.gathers_dispatched")
        log.info("dispatching pod gather plan", layerID=layer_id,
                 pod=pid, members=members, total_bytes=total,
                 codec=codec or None)
        if not self._dispatch_device_plan(layer_id, dest, layout, total,
                                          pod=members):
            # The documented contract: a failed plan send means the
            # host path must carry the bytes — degrade NOW instead of
            # sitting out the watchdog on a plan nobody received.
            log.error("pod gather plan dispatch failed; degrading to "
                      "host path", layerID=layer_id, pod=pid)
            self._degrade_pod_layer(layer_id, pid)

    def _pod_watchdog(self) -> None:
        """Liveness for the reconstruction phase: a pod pair whose
        shards all landed but whose FULL tree never acks (a member's
        gather failed, a peer shard never published) degrades the whole
        (layer, pod) to host-path delivery after ``POD_GATHER_TIMEOUT``
        — bounded, loud, never a wedge (docs/fabric.md)."""
        while not self._watch_stop.wait(self.POD_WATCH_PERIOD):
            now = time.monotonic()
            stale: Set[Tuple[LayerID, int]] = set()
            with self._lock:
                for key, t0 in list(self._pod_shard_acked.items()):
                    if now - t0 < self.POD_GATHER_TIMEOUT:
                        continue
                    lid, dest = key
                    pid = self._pod_of.get(dest)
                    if pid is not None:
                        stale.add((lid, pid))
            for lid, pid in sorted(stale):
                log.error("pod gather timed out; degrading to host path",
                          layerID=lid, pod=pid)
                trace.count("pod.gather_degraded")
                self._degrade_pod_layer(lid, pid)

    def _degrade_pod_layer(self, layer_id: LayerID, pid: int) -> None:
        """Fall a (layer, pod)'s unfinished pairs back to plain
        full-layer host-path targets: clear the shard specs (the
        re-stamp's widen reconcile re-opens the members' partials, so
        the re-plan ships only the missing ranges) and forget the pod
        records.  Pairs whose tree already materialized keep it.  The
        pod stops pod-planning for the rest of the run (a degrade →
        re-shard → degrade loop must not be possible)."""
        widened = []
        with self._lock:
            self._pods_broken.add(pid)
            for m in self.pods.get(pid, ()):
                key = (layer_id, m)
                spec = self._pod_pairs.get(key)
                if spec is None:
                    continue
                self._pod_pairs.pop(key)
                self._pod_shard_acked.pop(key, None)
                row = self.assignment.get(m)
                meta = (row or {}).get(layer_id)
                if meta is None or meta.shard != spec:
                    continue
                held = self.status.get(m, {}).get(layer_id)
                if (held is not None and delivered(held)
                        and not held.shard
                        and codec_accepts(held.codec, meta.codec)):
                    continue  # tree already landed; nothing to redo
                row[layer_id] = dataclasses.replace(meta, shard="")
                widened.append(m)
            self._pod_gather_sent.discard((layer_id, pid))
        self._replicate_pods()
        if widened:
            # The widen must reach the members BEFORE the re-plan's
            # bytes: the stamp reconcile is what re-opens their shard
            # holdings as partials (docs/sharding.md).
            for m in widened:
                self._send_digests_to(m)
            self._drive(self._recover)

    def _pods_member_gone(self, node: NodeID) -> None:
        """A pod member crashed or departed: its pods' unfinished pod
        pairs (every member's) degrade to host-path full delivery, and
        the pod stops pod-planning for the rest of the run — the
        survivors must never wait on a gather contribution that can no
        longer arrive."""
        pid = self._pod_of.get(node)
        if pid is None:
            return
        with self._lock:
            fresh = pid not in self._pods_broken
            if fresh:
                self._pods_broken.add(pid)
            lids = sorted({lid for (lid, d) in self._pod_pairs
                           if self._pod_of.get(d) == pid})
            # The departed seat's own pairs drop outright (its
            # assignment row is going away with it).
            for lid in lids:
                self._pod_pairs.pop((lid, node), None)
                self._pod_shard_acked.pop((lid, node), None)
        if fresh:
            trace.count("pod.pods_broken")
            self._replicate_pods()
        if not lids:
            return
        # Degrade EVERY remaining pair — even for an already-broken pod
        # (a second member dying after a single-layer timeout degrade
        # still strands the other layers' gathers).
        log.warn("pod member gone; degrading its pod to host path",
                 node=node, pod=pid, layers=lids)
        for lid in lids:
            self._degrade_pod_layer(lid, pid)

    # ------------------------------------------------ pod-plane failover

    def _pods_json(self) -> dict:
        return {"Table": {str(p): list(ms)
                          for p, ms in sorted(self.pods.items())},
                "Broken": sorted(self._pods_broken)}

    def _snapshot_extra_locked(self) -> dict:
        extra = dict(super()._snapshot_extra_locked())
        if self.pods:
            extra["Pods"] = self._pods_json()
        return extra

    def _replicate_pods(self) -> None:
        """Replicate the LIVE pod membership — full table + broken set,
        REPLACE like the group table (docs/failover.md).  Without it a
        standby promoted after a pod break would re-slice pod pairs for
        a pod that already degraded, resurrecting a gather whose
        contributions can never arrive."""
        with self._lock:
            if not self.pods:
                return
            pj = self._pods_json()
        self._replicate("pods", Pods=pj)

    def adopt_shadow(self, shadow: dict, dead_leader=None) -> None:
        super().adopt_shadow(shadow, dead_leader)
        pods = shadow.get("pods") or {}
        broken = {int(p) for p in (pods.get("Broken") or ())}
        with self._lock:
            for p, ms in (pods.get("Table") or {}).items():
                pid = int(p)
                members = sorted(int(m) for m in ms)
                if pid not in self.pods:
                    self.pods[pid] = members
                    for m in members:
                        self._pod_of.setdefault(m, pid)
            self._pods_broken |= broken
            # A pod that BROKE before the takeover degraded at the dead
            # leader, but the widened goal may not have reached this
            # shadow: any leftover 1/R@k pod slice of a broken pod in
            # the adopted assignment is a dead byte space — widen it
            # back to the plain full target, exactly like the degrade
            # did (docs/fabric.md).  Completed trees satisfy the plain
            # want too, so widening them is harmless.
            widened = []
            for pid in sorted(broken):
                for m in self.pods.get(pid) or ():
                    row = self.assignment.get(m)
                    if not row:
                        continue
                    for lid, meta in list(row.items()):
                        s = meta.shard or ""
                        if (s.startswith("1/") and "@" in s
                                and not meta.version):
                            row[lid] = dataclasses.replace(meta, shard="")
                            widened.append(m)
        if widened:
            log.warn("adopted a broken pod's leftover shard slices; "
                     "widened to host-path full targets",
                     pods=sorted(broken), members=sorted(set(widened)))
            # The widen reconcile stamp re-opens the members' shard
            # holdings as partials (docs/sharding.md).
            for m in sorted(set(widened)):
                self._send_digests_to(m)

    def assign_jobs(self) -> Tuple[int, FlowJobsMap, FlowJobsMap]:
        """Split off self-jobs (dest already holds the layer at its own
        client), then solve the flow problem for the rest
        (node.go:1200-1234).

        Resume extension: when a dest announced checkpointed partial
        coverage for a layer, the solver plans over its *remaining* bytes
        and the resulting jobs are mapped back through the gap list, so a
        resumed transfer re-sends only what's missing."""
        self_jobs: FlowJobsMap = {}
        modified: Assignment = {}
        # (layer, dest) -> uncovered [start, end) ranges, for resumes.
        gaps_by_pair: Dict[Tuple[LayerID, NodeID], list] = {}
        # (layer, dest) -> remaining bytes to plan for.
        remaining_sizes: Dict[Tuple[LayerID, NodeID], int] = {}
        with self._lock:
            # The goal the flow graph plans over: the full assignment in
            # flat mode; the hierarchical leader substitutes group
            # INGRESS demands for grouped members' pairs, so the graph
            # grows with the group count, not the fleet size
            # (docs/hierarchy.md).
            plan_asg = self._plan_assignment_locked()
            # Elastic membership (docs/membership.md): an UNVERIFIED
            # joiner's announced holdings must not be planned as
            # transfer sources (its own demand reduction above/below
            # still reads the full status) — hand the graph a
            # source-filtered view.
            quarantined = self.membership.unverified_sources()
            src_status = ({n: row for n, row in self.status.items()
                           if n not in quarantined}
                          if quarantined else self.status)
            # Size every layer from announced metadata — the leader need not
            # hold a layer to schedule it (its own layers are in status too).
            # CODEC holdings are skipped: their data_size is the ENCODED
            # byte count, not the canonical layer size the raw pairs
            # plan by (codec pairs size via codec_sizes below).
            layer_sizes: Dict[LayerID, int] = {}
            for layer_metas in src_status.values():
                for layer_id, meta in layer_metas.items():
                    if meta.data_size > 0 and not getattr(
                            meta, "codec", ""):
                        layer_sizes[layer_id] = max(
                            layer_sizes.get(layer_id, 0), meta.data_size)
            # Wire-codec planning inputs (docs/codec.md): exact encoded
            # sizes per chosen (layer, codec) — the demand-side
            # "effective capacity = bandwidth x ratio" formulation —
            # and each node's encode capability for arc admissibility.
            codec_sizes: Dict[Tuple[LayerID, str], int] = {}
            base_holders: Dict[str, frozenset] = {}
            if self.codecs is not None:
                for dest_l, lids_l in plan_asg.items():
                    for lid_l, meta_l in lids_l.items():
                        if meta_l.codec:
                            # Data-dependent forms (entropy, delta) size
                            # by their one cached encode; model-derivable
                            # forms straight from the layout.
                            n = self.codecs.ensure_sized(
                                lid_l, self.layers.get(lid_l),
                                meta_l.codec)
                            if n is not None:
                                codec_sizes[(lid_l, meta_l.codec)] = n
                        if lid_l not in layer_sizes:
                            # Only codec holders announced (a re-seed
                            # cluster): the canonical size derives from
                            # the model layout.
                            n = self.codecs.decoded_nbytes(lid_l)
                            if n:
                                layer_sizes[lid_l] = n
                # Delta arc admissibility (sched/flow._arc_ok): a
                # delta:<base> pair may only route through senders that
                # PROVABLY hold the base — the ContentIndex holders plus
                # this leader when it pinned the base from its own store.
                bases = {delta_base_digest(m.codec)
                         for lids_l in plan_asg.values()
                         for m in lids_l.values() if m.codec}
                bases.discard("")
                for b in bases:
                    hs = {n for n, _ in self.content.holders(b)}
                    if b in self._delta_base_src:
                        hs.add(self.node.my_id)
                    base_holders[b] = frozenset(hs)
            node_codecs = {n: frozenset(s)
                           for n, s in self.node_codecs.items()}
            for dest, layer_ids in plan_asg.items():
                for layer_id, meta in layer_ids.items():
                    if layer_id not in layer_sizes:
                        log.error("no announced size for layer", layerID=layer_id)
                        continue
                    if (layer_id, dest) in self._salvaging:
                        # A crashed source's uncovered ranges are being
                        # re-fetched via the NACK retransmit plane
                        # (crash() below); a whole-layer re-plan here
                        # would defeat the point of range salvage.
                        continue
                    if self._content_skip_locked(dest, layer_id):
                        # Content-addressed delta (docs/service.md): the
                        # dest holds these exact bytes under another
                        # layer id; its digest-stamp resolve acks the
                        # pair with zero wire bytes.
                        continue
                    held = self.status.get(dest, {}).get(layer_id)
                    if (held is not None
                            and shard_covers(held.shard, meta.shard)
                            and codec_accepts(held.codec, meta.codec)):
                        # Already in RAM/HBM (at covering shard, in an
                        # acceptable codec form — a quantized holding
                        # never stands in for a raw target):
                        # satisfaction counts it as-is — a self-job would
                        # re-send the layer to itself for nothing.
                        # DISK/CLIENT copies DO need the self-fetch
                        # (delivery means in-memory, node.go:435-446;
                        # self-jobs at :1205-1217).
                        if not delivered(held):
                            self_jobs.setdefault(dest, []).append(
                                FlowJob(dest, layer_id,
                                        layer_sizes[layer_id], 0, dest)
                            )
                        continue
                    info = self.partial_status.get(dest, {}).get(layer_id)
                    if info:
                        covered = [(int(s), int(e)) for s, e in info["Covered"]]
                        # Sharded targets resume within their shard's
                        # range: only the SHARD's uncovered bytes plan
                        # (docs/sharding.md) — coverage outside it is
                        # irrelevant to this target.
                        s0, s_sz = shard_range(meta.shard,
                                               int(info["Total"]))
                        gaps = intervals.uncovered(covered, s0, s0 + s_sz)
                        remaining = intervals.covered(gaps)
                        if remaining <= 0:
                            continue  # fully covered; receiver will re-ack
                        gaps_by_pair[(layer_id, dest)] = gaps
                        remaining_sizes[(layer_id, dest)] = remaining
                        log.info("resuming partial layer", layer=layer_id,
                                 dest=dest, remaining=remaining,
                                 total=info["Total"], shard=meta.shard)
                    modified.setdefault(dest, {})[layer_id] = meta
            if not modified:
                log.info("No jobs to assign other than self-assignment")
                return 0, self_jobs, {}
            t0 = time.monotonic()
            # Multi-job service (docs/service.md): when admitted jobs
            # claim pairs, ALL demands — base run + every active job —
            # solve as one shared-capacity flow problem per priority
            # tier (sched.flow.solve_joint); higher tiers consume link
            # budget first (preemption at the re-plan), equal tiers
            # fair-share one graph.  With no jobs active this is the
            # single-graph path, byte-identical to the pre-service
            # planner.
            by_tier: Dict[Tuple[int, str], Assignment] = {}
            tagged = False
            for dest, lids in modified.items():
                for layer_id, meta in lids.items():
                    owner = self.jobs.owner_of(dest, layer_id)
                    key = owner if owner is not None else (0, "")
                    tagged = tagged or owner is not None
                    by_tier.setdefault(key, {}).setdefault(
                        dest, {})[layer_id] = meta
            # Every solve is a new plan generation: commands dispatched
            # below carry it, and any revoke issued against an EARLIER
            # generation can no longer eat them (docs/service.md).
            self._plan_gen += 1
            self._replicate("plan_gen", Gen=self._plan_gen)
            # Autonomy link demotions (docs/autonomy.md): straggling
            # links price at their measured rate instead of infinity.
            demotions = dict(self._link_demotions)
            if not tagged:
                graph = make_flow_graph(
                    modified, src_status, layer_sizes,
                    self.node_network_bw,
                    remaining=remaining_sizes, topology=self.topology,
                    codec_sizes=codec_sizes, node_codecs=node_codecs,
                    base_holders=base_holders,
                    link_demotions=demotions,
                )
                t, jobs = graph.get_job_assignment()
            else:
                demands = [
                    (prio, jid, asg,
                     self._job_avoid_locked(jid, asg) if jid else set())
                    for (prio, jid), asg in sorted(by_tier.items())]
                t_by_prio, jobs = solve_joint(
                    demands, src_status, layer_sizes,
                    self.node_network_bw, remaining=remaining_sizes,
                    topology=self.topology,
                    graph_factory=make_flow_graph,
                    codec_sizes=codec_sizes, node_codecs=node_codecs,
                    base_holders=base_holders,
                    link_demotions=demotions)
                t = max(t_by_prio.values(), default=0)
                # Per-job pacing: each send's rate budget comes from its
                # OWN tier's min time (a preempting tier must not be
                # slowed to the laggard tier's horizon).
                self._tier_time = {d[1]: t_by_prio.get(d[0], t)
                                   for d in demands}
        if gaps_by_pair:
            jobs = self._remap_resumed_jobs(jobs, gaps_by_pair)
        solve_ms = round((time.monotonic() - t0) * 1000, 3)
        with self._lock:
            if not self.predicted_ttd_ms and t > 0:
                self.predicted_ttd_ms = t
                self.solve_ms = solve_ms
        log.info(
            "Job assignment completed",
            computation_ms=solve_ms,
            predicted_s=round(t / 1000.0, 6),
        )
        return t, self_jobs, jobs

    def _preempt_revoke(self, job: Job) -> None:
        """Mode-3 preemption revoke (docs/service.md): the new job's
        tier reclaims budget at the re-plan, but commands DISPATCHED
        under the old solve are already queued at their senders —
        without a revoke, a high-priority swap job stalls behind
        in-flight bulk traffic the solver thinks it preempted.  Revoke
        every LOWER-tier job's dispatched-but-undelivered pairs at
        their senders; the re-plan that follows re-dispatches them at
        the demoted budget."""
        if job.state != "active":
            return
        targets: Dict[NodeID, Dict[str, Set[Tuple[NodeID, LayerID]]]] = {}
        with self._lock:
            # The generation being revoked: commands from the re-plan
            # that follows carry a HIGHER one, so a slow sender applying
            # this revoke late cannot eat the re-dispatched command for
            # the same (job, dest, layer) — the wrong-eat race
            # (docs/service.md).
            gen = self._plan_gen
            for sender, job_list in self._live_jobs.items():
                for fj in job_list:
                    if not fj.job_id or fj.job_id == job.job_id:
                        continue
                    other = self.jobs.get(fj.job_id)
                    if (other is None or other.state != "active"
                            or other.priority >= job.priority):
                        continue
                    held = self.status.get(fj.dest_id, {}).get(fj.layer_id)
                    want = (self.assignment.get(fj.dest_id)
                            or {}).get(fj.layer_id)
                    if (held is not None and want is not None
                            and satisfies(held, want)):
                        continue  # already landed: nothing to revoke
                    targets.setdefault(sender, {}).setdefault(
                        fj.job_id, set()).add((fj.dest_id, fj.layer_id))
        for sender, by_job in sorted(targets.items()):
            for jid, pairs in sorted(by_job.items()):
                trace.count("jobs.revokes_sent")
                log.info("revoking demoted tier's queued sends",
                         sender=sender, job=jid, pairs=sorted(pairs),
                         preempting=job.job_id)
                if sender == self.node.my_id:
                    # The leader's own queue honors the registry
                    # directly — no wire round-trip to itself.
                    self.revokes.add(jid, sorted(pairs), gen=gen)
                    continue
                try:
                    self.node.transport.send(
                        sender, JobRevokeMsg(self.node.my_id, jid,
                                             sorted(pairs),
                                             epoch=self.epoch, gen=gen))
                except (OSError, KeyError) as e:
                    log.warn("revoke send failed (the demoted sends "
                             "simply run)", sender=sender, err=repr(e))

    # ---------------------------------------- autonomy actuators (mode 3)

    def policy_demote_link(self, src: NodeID, dest: NodeID,
                           bps: int) -> None:
        """Install a straggler-link demotion and re-plan around it
        (docs/autonomy.md): the flow solver prices the (src, dest) arc
        at the measured ``bps`` instead of infinity, so every pair that
        CAN route elsewhere does, and pairs with no alternative keep
        the slow path at an honest rate budget.  Called by the policy
        engine (never under its lock)."""
        with self._lock:
            self._link_demotions[(int(src), int(dest))] = int(bps)
        log.warn("link demoted for planning; re-planning around it",
                 src=src, dest=dest, bps=int(bps))
        trace.count("policy.link_demotions")
        self._drive(self._update_replan)

    def policy_lift_link(self, src: NodeID, dest: NodeID) -> None:
        """Lift a link demotion after a ``link_recovered`` event and
        re-plan at full modeled capacity."""
        with self._lock:
            if self._link_demotions.pop((int(src), int(dest)),
                                        None) is None:
                return
        log.info("link demotion lifted; re-planning", src=src, dest=dest)
        self._drive(self._update_replan)

    def _forget_sender_jobs(self, node: NodeID) -> None:
        """A cleanly-departed seat's dispatched sends are simply
        forgotten (docs/membership.md): unlike ``crash()``, no
        SourceDeadMsg fires and nothing enters range salvage — the
        re-plan the drain finalize runs re-dispatches any pair its
        departure left uncovered from the survivors."""
        with self._lock:
            self._live_jobs.pop(node, None)
            for job_list in self._live_jobs.values():
                job_list[:] = [j for j in job_list
                               if j.dest_id != node]

    def _job_avoid_locked(self, jid: str, asg: Assignment) -> Set[NodeID]:
        """Lock held.  The sender-avoid set for one job's tier: the
        job's explicit ``avoid_sources``, plus — for "repair" jobs —
        every rate-limited MODELED source of a wanted layer whenever an
        unlimited delivered holder also exists (the refill policy: a
        repaired node pulls from the nearest current holder, sparing
        the busy origin seeder).  Advisory: solve_joint falls back to
        all sources, loudly, if avoidance starves the tier."""
        job = self.jobs.get(jid)
        if job is None:
            return set()
        avoid = set(job.avoid_sources)
        if job.kind not in ("repair", "join"):
            return avoid
        # "join" refills (docs/membership.md) extend the repair
        # politeness with ORIGIN avoidance: a late joiner pulls from
        # current peer holders, touching the origin seeder (the
        # leader's seat) only for bytes no peer holds — admission cost
        # must not scale with origin bandwidth.
        origin: Set[NodeID] = ({self.node.my_id} if job.kind == "join"
                               else set())
        for lids in asg.values():
            for lid in lids:
                slow: Set[NodeID] = set()
                free: Set[NodeID] = set()
                for n, row in self.status.items():
                    meta = row.get(lid)
                    if meta is None or not delivered(meta):
                        continue
                    (slow if meta.limit_rate else free).add(n)
                if free - avoid - origin:
                    avoid |= slow | origin
        return avoid

    @staticmethod
    def _remap_resumed_jobs(
        jobs: FlowJobsMap, gaps_by_pair: Dict[Tuple[LayerID, NodeID], list]
    ) -> FlowJobsMap:
        """Translate jobs planned over remaining-space into absolute byte
        ranges (one job may split across several gaps)."""
        out: FlowJobsMap = {}
        for sender, job_list in jobs.items():
            for job in job_list:
                gaps = gaps_by_pair.get((job.layer_id, job.dest_id))
                if gaps is None:
                    out.setdefault(sender, []).append(job)
                    continue
                for off, size in map_through_gaps(gaps, job.offset, job.data_size):
                    out.setdefault(sender, []).append(
                        FlowJob(sender, job.layer_id, size, off,
                                job.dest_id, job_id=job.job_id)
                    )
        return out

    # Max plans per batch hint: each batched gather holds K layers'
    # tiles in flight at once, so K bounds the dest's peak HBM.
    PLAN_BATCH_MAX = 4

    def _split_fabric_jobs(self, jobs: FlowJobsMap) -> FlowJobsMap:
        """Dispatch every fabric-eligible (layer, dest) job group as ONE
        device plan — the plan's multi-sender byte-range split executes as
        device traffic (seeders upload their ranges, the dest's sharded
        ingest gathers them over ICI) — and return the jobs the fabric
        can't carry for the host-path dispatch below.  A resumed dest's
        plan covers only its gaps; the dest seeds its ingest from the
        checkpointed bytes it already holds.

        Plan batching: eligible plans with the same dest and total size
        (a model's equal-size layers — the dest's ingest tiling is a
        function of the total alone) are stamped with one batch id, so
        the dest finishes the whole group as a single batched gather
        (``parallel.ingest.finalize_many``) instead of N serial
        collectives — the per-plan dispatch latency that dominated the
        physical fabric row amortizes over the batch."""
        if self.fabric is None or self.placement is None:
            return jobs
        groups: Dict[Tuple[LayerID, NodeID], List[FlowJob]] = {}
        for job_list in jobs.values():
            for job in job_list:
                groups.setdefault((job.layer_id, job.dest_id), []).append(job)
        host_jobs: FlowJobsMap = {}
        # First pass: decide eligibility per (layer, dest) group so the
        # batch sizes stamped below are exact (a plan counted into a
        # batch but sent host-path would strand the dest's batch wait).
        eligible: List[Tuple[LayerID, NodeID, list, int]] = []
        for (layer_id, dest), group in sorted(groups.items()):
            layout = sorted(
                ((j.sender_id, j.offset, j.data_size) for j in group),
                key=lambda t: t[1],
            )
            with self._lock:
                total = self._layer_size_locked(layer_id)
                want = (self.assignment.get(dest) or {}).get(layer_id)
            if want is not None and (want.shard or want.codec):
                # Sharded and wire-codec targets ride the host path:
                # the fabric plane's ingest/collectives materialize
                # WHOLE canonical layers only (docs/sharding.md,
                # docs/codec.md, honest limits).
                for j in group:
                    host_jobs.setdefault(j.sender_id, []).append(j)
                continue
            if total > 0 and self._fabric_ok(layer_id, layout, dest, total):
                eligible.append((layer_id, dest, layout, total))
            else:
                for j in group:
                    host_jobs.setdefault(j.sender_id, []).append(j)
        # Same-dest, same-size plans batch together (bounded).
        batches: Dict[Tuple[NodeID, int], List[int]] = {}
        for i, (_, dest, _, total) in enumerate(eligible):
            batches.setdefault((dest, total), []).append(i)
        batch_of: Dict[int, Tuple[str, int]] = {}
        for (dest, total), idxs in sorted(batches.items()):
            for start in range(0, len(idxs), self.PLAN_BATCH_MAX):
                chunk = idxs[start : start + self.PLAN_BATCH_MAX]
                if len(chunk) < 2:
                    continue  # nothing to amortize
                bid = f"b{dest}.{total}.{next(self._batch_seq)}"
                for i in chunk:
                    batch_of[i] = (bid, len(chunk))
        for i, (layer_id, dest, layout, total) in enumerate(eligible):
            bid, bn = batch_of.get(i, ("", 1))
            if not self._dispatch_device_plan(layer_id, dest, layout, total,
                                              batch_id=bid, batch_n=bn):
                # A mid-batch dispatch failure leaves earlier members
                # stamped with the full batch_n; the dest's bounded
                # FABRIC_BATCH_WAIT flush processes the present members
                # — a one-off, bounded delay on a rare failure path
                # (re-stamping already-sent plans would need a second
                # protocol round for a case the flush already covers).
                for j in groups[(layer_id, dest)]:
                    host_jobs.setdefault(j.sender_id, []).append(j)
        return host_jobs

    def _dispatch(self, min_time_ms: int, self_jobs: FlowJobsMap,
                  jobs: FlowJobsMap) -> None:
        """Send every flow job as a rate-budgeted command
        (node.go:1237-1288; the budget comes from the solver's
        millisecond-granular min time, not the reference's integer
        seconds).  Fabric-eligible job groups ride the device plane
        instead."""
        jobs = self._split_fabric_jobs(jobs)
        with self._lock:
            # The generation these commands belong to: a revoke fenced
            # at an older generation must not eat them (docs/service.md).
            gen = self._plan_gen
        for dest, job_list in self_jobs.items():
            for job in job_list:
                with self._lock:
                    rate = self.status.get(job.sender_id, {}).get(
                        job.layer_id, LayerMeta()
                    ).limit_rate
                self.node.transport.send(
                    job.sender_id,
                    FlowRetransmitMsg(
                        self.node.my_id, job.layer_id, job.sender_id,
                        job.data_size, job.offset, rate, epoch=self.epoch,
                        gen=gen,
                    ),
                )
        with self._lock:
            tier_time = dict(self._tier_time)
            # Wire-codec commands (docs/codec.md): each job's byte range
            # indexes the pair's chosen form — the command must say so.
            pair_codec = {
                (dest, lid): meta.codec
                for dest, lids in self.assignment.items()
                for lid, meta in lids.items() if meta.codec}
        for sender, job_list in jobs.items():
            for job in job_list:
                dest = job.dest_id
                t_job = (tier_time.get(job.job_id, min_time_ms)
                         if job.job_id else min_time_ms)
                rate = rate_for(job.data_size, t_job or min_time_ms)
                codec = pair_codec.get((dest, job.layer_id), "")
                # Pair-lifecycle span (docs/observability.md): the pair
                # entered the solved plan NOW — planned→dispatched is
                # then the sender-side queueing the critical-path walk
                # attributes.  One event per flow job; a multi-sender
                # split's last command wins (the walk reads one planned
                # edge per pair).
                telemetry.span_event(
                    telemetry.span_id(dest, job.layer_id), "planned",
                    node=self.node.my_id, src=sender, dest=dest,
                    layer=job.layer_id, job=job.job_id, codec=codec,
                    bytes=job.data_size)
                log.debug(
                    "dispatching a job",
                    layer=job.layer_id, sender=sender, rate_mibps=rate >> 20,
                    job=job.job_id or None, codec=codec or None,
                )
                try:
                    self.node.transport.send(
                        sender,
                        FlowRetransmitMsg(
                            self.node.my_id, job.layer_id, dest,
                            job.data_size, job.offset, rate,
                            epoch=self.epoch, job_id=job.job_id,
                            codec=codec, gen=gen,
                        ),
                    )
                except (OSError, KeyError) as e:
                    log.error("couldn't dispatch job", layerID=job.layer_id, err=repr(e))
                    continue
                # Salvage index: a dispatched job is live until its
                # (layer, dest) delivers — crash(sender) consults this
                # to re-plan only the uncovered byte ranges.  The
                # dispatch time feeds health scoring: a pair is only
                # straggler-judged once it has been in flight for a
                # full metrics interval.
                with self._lock:
                    self._live_jobs.setdefault(sender, []).append(job)
                    self.__dict__.setdefault(
                        "_pair_dispatch_mono", {})[
                        (dest, job.layer_id)] = time.monotonic()

    def _modeled_link_rate(self, src: NodeID, dest: NodeID) -> int:
        """Mode 3's health-scoring link model (docs/observability.md):
        the solver's own inputs — min(src NIC, dest NIC, the serving
        holder's modeled source rate) — but ONLY while a dispatched
        (src→dest) flow job's pair is still unsatisfied AND has been in
        flight for at least one metrics interval.  Both gates exist for
        honesty: a transfer that completed within one interval averages
        far below the modeled rate over that interval, and a report
        racing a just-dispatched (or just-finishing) burst would
        otherwise mis-read a healthy link as a straggler."""
        interval = telemetry.metrics_interval() or 2.0
        with self._lock:
            dispatch_t = getattr(self, "_pair_dispatch_mono", {})
            now = time.monotonic()
            live = None
            for fj in self._live_jobs.get(src) or ():
                if fj.dest_id != dest:
                    continue
                want = (self.assignment.get(dest) or {}).get(fj.layer_id)
                if want is None:
                    continue
                t0 = dispatch_t.get((dest, fj.layer_id))
                if t0 is None or now - t0 < interval:
                    continue  # too young to judge over a full interval
                held = self.status.get(dest, {}).get(fj.layer_id)
                if held is None or not satisfies(held, want):
                    live = fj
                    break
            if live is None:
                return 0
            bw = getattr(self, "node_network_bw", None) or {}
            cands = [bw.get(src), bw.get(dest)]
            meta = self.status.get(src, {}).get(live.layer_id)
            if meta is not None and meta.limit_rate:
                cands.append(meta.limit_rate)
        rates = [int(r) for r in cands if r]
        return min(rates) if rates else 0

    def _health_expected_srcs(self, dest: NodeID):
        """Mode 3: every sender with a dispatched live job to ``dest``
        (the age/satisfaction gates stay in ``_modeled_link_rate`` —
        an expected src whose pair is too young or already satisfied
        scores as unmodeled and is skipped)."""
        with self._lock:
            return sorted({s for s, jobs in self._live_jobs.items()
                           if any(fj.dest_id == dest for fj in jobs)})

    def crash(self, node_id: NodeID) -> None:
        """Range-level salvage (docs/failover.md): a dead SOURCE's
        in-flight jobs don't re-send their whole layers — each affected
        dest is told to NACK its uncovered byte ranges of the layer to a
        surviving holder (``SourceDeadMsg`` → ``LayerNackMsg`` → the
        byte-range NACK retransmitter), so recovery costs exactly the
        dead source's unsent bytes.  Pairs with no surviving holder fall
        through to the base whole-layer re-plan."""
        salvage = []
        with self._lock:
            jobs = self._live_jobs.pop(node_id, [])
            # Jobs sent TO the dead node die with its assignment.
            for job_list in self._live_jobs.values():
                job_list[:] = [j for j in job_list
                               if j.dest_id != node_id]
            for job in jobs:
                dest, lid = job.dest_id, job.layer_id
                if dest == node_id or dest == self.node.my_id:
                    continue
                want = (self.assignment.get(dest) or {}).get(lid)
                held = self.status.get(dest, {}).get(lid)
                if (held is not None and delivered(held)
                        and (want is None
                             or (shard_covers(held.shard, want.shard)
                                 and codec_accepts(held.codec,
                                                   want.codec)))):
                    continue  # already landed whole (target shard covered)
                if (lid, dest) in self._salvaging:
                    continue
                # The salvage source must really hold the bytes being
                # re-requested: the target's shard for sharded pairs,
                # the whole layer otherwise — and for a wire-codec pair,
                # the exact encoded form (or raw + encode capability).
                alt = pick_salvage_source(
                    self.status, lid,
                    exclude={node_id, dest}
                    | self.membership.unverified_sources(),
                    need_shard=want.shard if want is not None else "",
                    need_codec=want.codec if want is not None else "",
                    encoders=frozenset(
                        n for n, s in self.node_codecs.items()
                        if want is not None
                        and codec_capability(want.codec) in s
                        and (not delta_base_digest(want.codec)
                             or self.content.node_has(
                                 n, delta_base_digest(want.codec))
                             or (n == self.node.my_id
                                 and delta_base_digest(want.codec)
                                 in self._delta_base_src))))
                if alt is None:
                    continue  # no surviving holder: base re-plan covers it
                self._salvaging.add((lid, dest))
                salvage.append((dest, lid, alt))
        for dest, lid, alt in salvage:
            trace.count("failover.range_salvage")
            log.warn("source crashed mid-transfer; salvaging the dest's "
                     "uncovered ranges via NACK retransmit",
                     dead=node_id, layerID=lid, dest=dest, alt=alt)
            try:
                self.node.add_node(dest)
                self.node.transport.send(
                    dest, SourceDeadMsg(self.node.my_id, lid, node_id,
                                        alt, epoch=self.epoch))
            except (OSError, KeyError) as e:
                with self._lock:
                    self._salvaging.discard((lid, dest))
                log.error("source-dead notice undeliverable; falling "
                          "back to whole-layer re-plan", dest=dest,
                          layerID=lid, err=repr(e))
        super().crash(node_id)

    def handle_flow_retransmit(self, msg: FlowRetransmitMsg) -> None:
        """The leader can be a sender in the plan too (node.go:1168-1187)."""
        t0 = time.monotonic()
        log.info(
            "start sending layer",
            layer=msg.layer_id, dest=msg.dest_id, size_mb=msg.data_size >> 20,
            expected_mibps=msg.rate >> 20,
        )
        handle_flow_retransmit(
            self.node, self.layers, self._lock,
            lambda lid, dest: fetch_from_client(self.node, lid, dest), msg,
            revokes=self.revokes, codecs=self.codecs,
        )
        dur = time.monotonic() - t0
        log.info(
            "finished sending layer",
            layer=msg.layer_id, dest=msg.dest_id,
            send_dur_ms=round(dur * 1000, 3),
            throughput_mibps=round(msg.data_size / max(dur, 1e-9) / (1 << 20), 2),
        )


class HierarchicalFlowLeaderNode(FlowRetransmitLeaderNode):
    """Mode 3 scaled out: two-level control for fleet-size fan-out
    (docs/hierarchy.md).

    The fleet partitions into GROUPS, each owned by a sub-leader
    (``runtime/hierarchy.SubLeaderController`` on an ordinary receiver
    seat).  This root keeps the FULL member goal — completion,
    satisfaction, the job plane, and replication all still speak
    (member, layer) pairs — but every hot path is reduced to groups:

    - **Planning**: ``_plan_assignment_locked`` substitutes one group
      INGRESS demand (deliver the layer to the sub-leader) for all of a
      group's member pairs, so the flow graph — and the solve wall —
      grows with the group count, not the fleet size.  Sub-leaders fan
      layers out intra-group and members ack to THEM.
    - **Upward traffic**: members announce / ack / heartbeat / report
      metrics to their sub-leader; the root handles cumulative
      ``GroupStatusMsg`` aggregates — O(groups) messages per event
      where the flat plane handled O(nodes).
    - **Failover**: the group table rides the epoch-fenced snapshot +
      ``groups`` delta, so a promoted standby keeps the hierarchy; a
      DEAD sub-leader dissolves its group back to flat delivery
      (members are told to re-point at the root and re-announce).

    Qualified targets compose (docs/hierarchy.md): a group whose live
    members all want the SAME ``(shard, codec, version)`` form of a
    layer plans ONE synthetic group ingress carrying that form — the
    encoded / shard bytes cross the fleet fabric once, and the
    sub-leader chains them member-to-member.  Mixed forms within a
    group, and forms the ingress seat's own target conflicts with,
    still plan flat (honest limit); standbys must be ungrouped seats."""

    MODE = 3

    def __init__(self, node, layers, assignment, node_network_bw,
                 groups=None, **kw):
        self.groups: Dict[int, dict] = {}
        self._dissolved: Set[int] = set()
        self._member_group: Dict[NodeID, int] = {}
        self._group_of_subleader: Dict[NodeID, int] = {}
        self._dead_members: Set[NodeID] = set()
        for gid, rec in (groups or {}).items():
            gid = int(gid)
            sub = int(rec["leader"] if "leader" in rec else rec["Leader"])
            members = sorted(int(m) for m in (
                rec.get("members") or rec.get("Members") or []))
            dissolved = bool(rec.get("dissolved") or rec.get("Dissolved"))
            self.groups[gid] = {"leader": sub, "members": members}
            self._group_of_subleader[sub] = gid
            if dissolved:
                self._dissolved.add(gid)
                continue
            for m in members:
                if m != sub:
                    self._member_group[m] = gid
        for s in kw.get("standbys") or ():
            if int(s) in self._member_group or int(s) in \
                    self._group_of_subleader:
                raise ValueError(
                    f"standby {s} is a grouped seat: standbys must be "
                    "ungrouped (a promoted sub-leader's member-facing "
                    "handlers would collide with the root's)")
        super().__init__(node, layers, assignment, node_network_bw, **kw)
        # Grouped members are their sub-leader's to monitor: the ctor
        # seeded leases for every assignee, but a member never
        # heartbeats the root, and an expiring root-side lease would
        # falsely kill it.
        for m in self._member_group:
            self.detector.forget(m)

    # --------------------------------------------------------- wiring

    def _register_handlers(self) -> None:
        super()._register_handlers()
        reg = (self.loop.register_keep if self._shared_loop
               else self.loop.register)
        reg(GroupStatusMsg, self.handle_group_status)

    def _grouped(self, node_id: NodeID) -> bool:
        return node_id in self._member_group

    def _ack_liveness(self, src_id: NodeID) -> bool:
        if self._grouped(src_id):
            # Member liveness belongs to the sub-leader's detector; an
            # aggregated ack must neither create a root-side lease nor
            # resurrect a reported-dead member.
            return src_id not in self._dead_members
        return super()._ack_liveness(src_id)

    def _touch_liveness(self, src_id: NodeID) -> None:
        if not self._grouped(src_id):
            super()._touch_liveness(src_id)

    def _await_announce_set_locked(self) -> Set[NodeID]:
        """Grouped members stay IN the await set: their announces
        arrive as sub-leader folds (which create their status rows),
        and the start-time route/codec decisions need every member's
        form and capability picture before the first stamp latches
        (docs/hierarchy.md).  A member the sub reported dead was
        crash()-dropped from the assignment, so it no longer gates."""
        return super()._await_announce_set_locked()

    def _lease_recipients_locked(self) -> Set[NodeID]:
        return (super()._lease_recipients_locked()
                - set(self._member_group))

    # ------------------------------------------------------- planning

    @staticmethod
    def _form(meta: LayerMeta) -> Tuple[str, str, str]:
        return (meta.shard or "", meta.codec or "", meta.version or "")

    def _group_route_locked(self, gid: int, lid: LayerID):
        """How (group, layer) reaches the group, lock held.  Returns
        ``None`` (every member plans FLAT) or ``(kind, ingress_meta,
        form)`` — a member pair routes through the group iff its
        ``(shard, codec, version)`` form equals ``form``:

        - ``("synthetic", meta, form)``: the root emits one ingress
          demand ``meta`` at the sub-leader carrying the group's shared
          form — full-raw when any member wants the plain layer (and
          the sub-leader's own target, if any, is plain too: a
          qualified own pair would collide with the synthetic demand in
          one plan slot), else the ONE qualified form every member
          agrees on (docs/hierarchy.md).
        - ``("own", None, form)``: the sub-leader's OWN pair already
          carries the bytes the group needs — its existing target has
          the same form, or is plain raw while the group wants a
          codec-only form the sub-leader can encode-serve — so the
          root emits nothing extra.

        Mixed member forms route only the plain subset (qualified
        members plan flat, the pre-chain behavior); two or more
        distinct qualified forms plan flat entirely (honest limit)."""
        rec = self.groups[gid]
        sub = rec["leader"]
        own = (self.assignment.get(sub) or {}).get(lid)
        own_plain = own is None or not (own.shard or own.codec
                                        or own.version)
        plain_wanted = False
        qual: Dict[Tuple[str, str, str], LayerMeta] = {}
        for m in rec["members"]:
            if m == sub or m in self._dead_members:
                continue
            meta = (self.assignment.get(m) or {}).get(lid)
            if meta is None:
                continue
            form = self._form(meta)
            if form == ("", "", ""):
                plain_wanted = True
            else:
                qual[form] = meta
        if plain_wanted:
            return (("synthetic", LayerMeta(), ("", "", ""))
                    if own_plain else None)
        if len(qual) != 1:
            return None
        (form, meta), = qual.items()
        if own is None:
            return ("synthetic", dataclasses.replace(meta), form)
        if self._form(own) == form:
            return ("own", None, form)
        if (own_plain and not form[0] and not form[2]
                and codec_capability(form[1])
                in self.node_codecs.get(sub, ())
                and (not delta_base_digest(form[1])
                     or self.content.node_has(
                         sub, delta_base_digest(form[1])))):
            # Raw own ingress; the sub-leader encode-serves the
            # group's codec form from it (docs/codec.md) — a delta
            # form only when the sub PROVABLY holds the base bytes
            # the re-encode reads.
            return ("own", None, form)
        return None

    def _ingress_ok_locked(self, gid: int, lid: LayerID) -> bool:
        """Whether (group, layer) routes through the group at all —
        the route exists.  Lock held."""
        return self._group_route_locked(gid, lid) is not None

    def _plan_assignment_locked(self) -> Assignment:
        """The reduced goal the flow graph sees: grouped members'
        still-missing pairs collapse into one ingress demand per
        (group, layer) — full-raw for plain wants, the group's SHARED
        qualified form when every member agrees on one
        (``_group_route_locked``).  Members whose form differs from the
        routed one, and ungrouped seats, plan flat.  Lock held."""
        out: Assignment = {}
        routes: Dict[Tuple[int, LayerID], Optional[tuple]] = {}
        for dest, lids in self.assignment.items():
            gid = self._member_group.get(dest)
            if gid is None:
                row = out.setdefault(dest, {})
                for lid, meta in lids.items():
                    row[lid] = meta
                continue
            ingress = self.groups[gid]["leader"]
            for lid, meta in lids.items():
                key = (gid, lid)
                if key not in routes:
                    routes[key] = self._group_route_locked(gid, lid)
                route = routes[key]
                if route is None or route[2] != self._form(meta):
                    out.setdefault(dest, {})[lid] = meta
                    continue
                held = self.status.get(dest, {}).get(lid)
                if held is not None and satisfies(held, meta):
                    continue  # the member already holds it
                if route[0] == "own":
                    continue  # the sub-leader's own pair is the ingress
                out.setdefault(ingress, {}).setdefault(lid, route[1])
        return out

    def _group_ingress_row_locked(self, gid: int
                                  ) -> Dict[LayerID, LayerMeta]:
        """The SYNTHETIC ingress demands currently routed through
        ``gid``'s sub-leader (lock held), derived from the live routing
        decision — digest stamps read this BEFORE the first planning
        pass, so it cannot be a planning-time cache."""
        rows: Dict[LayerID, LayerMeta] = {}
        rec = self.groups[gid]
        for m in rec["members"]:
            if m == rec["leader"] or m in self._dead_members:
                continue
            for lid in (self.assignment.get(m) or {}):
                if lid in rows:
                    continue
                route = self._group_route_locked(gid, lid)
                if route is not None and route[0] == "synthetic":
                    rows[lid] = route[1]
        return rows

    def _digest_row_locked(self, dest: NodeID) -> dict:
        row = dict(super()._digest_row_locked(dest))
        gid = self._group_of_subleader.get(dest)
        if gid is not None and gid not in self._dissolved:
            for lid, meta in self._group_ingress_row_locked(gid).items():
                row.setdefault(lid, meta)
        return row

    def _send_digests_to(self, dest: NodeID) -> None:
        super()._send_digests_to(dest)
        # A grouped dest's pairs may route through its group: the
        # SUB-LEADER carries the ingress and needs the same stamp
        # (digest / version / codec — _digest_row_locked merges the
        # ingress row) BEFORE the bytes, or a versioned wave's ingress
        # would land unversioned and never serve the members
        # (docs/swap.md).  Idempotent, like every stamp re-send.
        with self._lock:
            gid = self._member_group.get(dest)
            sub = (self.groups[gid]["leader"]
                   if gid is not None and gid not in self._dissolved
                   else None)
        if sub is not None and sub != dest:
            super()._send_digests_to(sub)

    def _digest_recipients_locked(self) -> list:
        dests = super()._digest_recipients_locked()
        have = set(dests)
        for gid, rec in sorted(self.groups.items()):
            if gid in self._dissolved or rec["leader"] in have:
                continue
            if self._group_ingress_row_locked(gid):
                have.add(rec["leader"])
                dests.append(rec["leader"])
        return dests

    def send_layers(self) -> None:
        super().send_layers()
        self._send_group_plans()

    def _send_group_plans(self) -> None:
        """Hand every live sub-leader its members' current targets.
        Sent with every (re-)plan — idempotent at the sub-leader, and
        its receipt-reply (full cumulative coverage) doubles as the
        reconcile channel after a root takeover."""
        with self._lock:
            plans = []
            for gid, rec in sorted(self.groups.items()):
                if gid in self._dissolved:
                    continue
                targets = {}
                for m in rec["members"]:
                    if m == rec["leader"] or m in self._dead_members:
                        continue
                    # EVERY live member target rides the plan — even
                    # pairs the root plans flat: the sub-leader is the
                    # members' ack funnel, and it can only fold their
                    # coverage for targets it knows about.  Its own
                    # fan-out is gated on what its holdings can
                    # actually serve, so unroutable forms simply wait
                    # for the root's flat delivery.
                    row = dict(self.assignment.get(m) or {})
                    if row:
                        targets[m] = row
                plans.append((gid, rec["leader"], targets))
        for gid, sub, targets in plans:
            try:
                self.node.add_node(sub)
                self.node.transport.send(
                    sub, GroupPlanMsg(self.node.my_id, gid, targets,
                                      epoch=self.epoch))
                trace.count("hier.group_plans_sent")
            except (OSError, KeyError) as e:
                log.error("group plan send failed (next re-plan "
                          "re-sends)", group=gid, sub=sub, err=repr(e))

    # ----------------------------------------------------- aggregates

    def handle_group_status(self, msg: GroupStatusMsg) -> None:
        """One sub-leader aggregate: member announce inventories, member
        deaths, cumulative coverage, batched member telemetry — each
        applied through the SAME machinery the flat plane uses, so jobs,
        content index, replication, and completion are unchanged.

        Sender-gated like the swap fence's foreign-control check
        (docs/swap.md): only the REGISTERED sub-leader of a live group
        may speak for it, and only about its OWN members — any other
        seat could otherwise crash a healthy member or overwrite its
        status row with one message."""
        with self._lock:
            rec = self.groups.get(msg.group_id)
            foreign = (rec is None or rec["leader"] != msg.src_id
                       or msg.group_id in self._dissolved)
            group_members = set(rec["members"]) if rec else set()
        if foreign:
            trace.count("hier.foreign_status_dropped")
            log.warn("group status from a seat that does not own the "
                     "group; dropped", group=msg.group_id,
                     src=msg.src_id)
            return
        self.detector.touch(msg.src_id)
        replan_for = []
        if msg.codecs:
            # Folded member codec capabilities (docs/codec.md), applied
            # through the same grant/revoke discipline as the flat
            # announce path, so the planner can choose quantized
            # transfers for grouped members — the capability half of
            # letting codec-qualified pairs route THROUGH a group.
            # Absorbed BEFORE the announced rows: anything gated on a
            # member's status row existing (the start latch, the first
            # codec stamp) must see the member's capabilities too.
            changed = False
            with self._lock:
                for m, caps in sorted(msg.codecs.items()):
                    m = int(m)
                    if not self._grouped(m) or m not in group_members:
                        continue
                    new_caps = (frozenset(str(c) for c in caps)
                                if caps else None)
                    old_caps = self.node_codecs.get(m)
                    if new_caps:
                        self.node_codecs[m] = new_caps
                    else:
                        self.node_codecs.pop(m, None)
                    changed = changed or new_caps != old_caps
            if changed:
                self._replicate_codecs()
        if msg.announced:
            with self._lock:
                started = self._started
            for m, row in sorted(msg.announced.items()):
                if not self._grouped(m) or m not in group_members:
                    continue  # dissolved meanwhile / not this group's
                              # member: a direct announce supersedes
                self._revive_member(m)
                with self._lock:
                    known = m in self.status
                    self.status[m] = dict(row)
                # A fold IS the member's restart channel: like the flat
                # announce path, a re-announced member stops vouching
                # for its dead incarnation's bytes, and a JOINING
                # member's folded digest inventory is the verification
                # evidence the flat path reads off AnnounceMsg — the
                # same quarantine applies (docs/membership.md): a
                # grouped joiner whose holdings digest-verify becomes a
                # source; one that conflicts stays a dest.
                digs = {int(l): str(dg) for l, dg in
                        ((msg.digests or {}).get(m) or {}).items()}
                if self._verify_member_source(m, digs):
                    self._merge_announced_digests(m, digs)
                    self.content.reset_node(m, digs)
                else:
                    self.content.reset_node(m, {})
                self._replicate("status", Node=m,
                                Layers=layer_ids_to_json(row))
                with self._lock:
                    pending_want = self._join_pending.pop(m, None)
                if pending_want is not None:
                    # A grouped joiner's first announce arrives through
                    # its sub-leader's fold: admit its refill job here,
                    # exactly like the flat announce path
                    # (docs/membership.md).
                    self._admit_join_job(m, pending_want)
                if started and known:
                    replan_for.append(m)
            trace.count("hier.announce_aggregates")
            # The fold IS the members' announce-gate arrival: the start
            # latch waits on their status rows exactly like the flat
            # path waits on direct announces — and like that path, a
            # successful start must drive the first sends (and the
            # already-satisfied check) itself.
            if self._maybe_start():
                self.send_layers()
                self._maybe_finish()
        for m in msg.dead:
            with self._lock:
                fresh = (m in group_members and self._grouped(m)
                         and m not in self._dead_members)
                if fresh:
                    self._dead_members.add(m)
            if fresh:
                log.error("sub-leader reported member dead",
                          member=m, group=msg.group_id)
                trace.count("hier.member_crashes")
                self.crash(m)
        if msg.covered:
            for lid, members in sorted(msg.covered.items()):
                for m in members:
                    if int(m) in group_members:
                        self._apply_member_ack(
                            int(m), int(lid),
                            span=(msg.spans.get(int(lid)) or {}).get(
                                int(m), ""))
        for m, snap in sorted(msg.metrics.items()):
            if int(m) in group_members:
                self._fold_member_metrics(int(m), snap)
        if replan_for:
            # A restarted member re-announced (through the fold): its
            # RAM holdings are gone — re-plan its missing layers like a
            # direct re-announce would.
            log.info("aggregated re-announce; re-planning",
                     members=replan_for)
            self._maybe_finish()
            with self._lock:
                finished = self._startup_sent
            if not finished:
                self._recover()
        self._maybe_finish()

    def _revive_member(self, m: NodeID) -> None:
        """An announce fold naming a written-off member is its restart
        coming back through the sub-leader: restore its dropped pairs
        (pre-startup) exactly like a direct revival announce."""
        with self._lock:
            if m not in self._dead_members:
                return
            self._dead_members.discard(m)
            dropped = self._dropped_assignment.pop(m, None)
            if dropped and not self._startup_sent:
                self._restore_assignment(m, dropped)
        log.warn("dead-reported member announced again; reviving",
                 member=m)
        if dropped:
            self._replicate("revive", Node=m)

    def _apply_member_ack(self, m: NodeID, lid: LayerID,
                          span: str = "") -> None:
        """Apply one aggregated (member, layer) completion.  Reports
        are CUMULATIVE, so already-satisfied pairs short-circuit before
        touching replication or the job plane.  ``span``: the
        sub-leader's advisory fan-out child span id for the pair
        (docs/observability.md) — the synthesized ack carries it so the
        root's ``acked`` event files on the member's own span."""
        with self._lock:
            held = self.status.get(m, {}).get(lid)
            if held is not None and delivered(held):
                return
        self.handle_ack(AckMsg(m, lid, LayerLocation.INMEM, span_id=span))

    def _fold_member_metrics(self, member: NodeID, snap: dict) -> None:
        rec = {"counters": dict(snap.get("Counters") or {}),
               "gauges": dict(snap.get("Gauges") or {}),
               "links": dict(snap.get("Links") or {}),
               "hists": {k: dict(h)
                         for k, h in (snap.get("Hists") or {}).items()},
               "spans": [dict(ev) for ev in snap.get("Spans") or []],
               "t_wall_ms": float(snap.get("T", 0.0)),
               "proc": str(snap.get("Proc", "")),
               "_recv_mono": time.monotonic()}
        with self._lock:
            self.cluster_metrics[member] = rec
        self._replicate("metrics", Node=member, Counters=rec["counters"],
                        Gauges=rec["gauges"], Links=rec["links"],
                        Hists=rec["hists"], Spans=rec["spans"],
                        T=rec["t_wall_ms"], Proc=rec["proc"])
        self._health_observe(member, rec)

    # ------------------------------------------------------- failover

    def _groups_json(self) -> dict:
        return {str(g): {"Leader": rec["leader"],
                         "Members": list(rec["members"]),
                         "Dissolved": g in self._dissolved}
                for g, rec in sorted(self.groups.items())}

    def _snapshot_extra_locked(self) -> dict:
        extra = dict(super()._snapshot_extra_locked())
        extra["Groups"] = self._groups_json()
        return extra

    def crash(self, node_id: NodeID) -> None:
        gid = self._group_of_subleader.get(node_id)
        with self._lock:
            dissolve = gid is not None and gid not in self._dissolved
        if dissolve:
            self._dissolve_group(gid, node_id)
        super().crash(node_id)

    def _dissolve_group(self, gid: int, dead_sub: NodeID) -> None:
        """A dead sub-leader's group degrades to FLAT delivery: members
        re-point their control parent at this root and re-announce;
        the re-plan (riding the crash that got us here) then plans them
        directly.  Replicated, so a later takeover doesn't resurrect
        the dead hierarchy.  Mutations run under ``_lock``: a re-plan
        reading ``_member_group``/``_dissolved`` concurrently must see
        either the grouped or the fully-dissolved state, never a
        half-popped one."""
        with self._lock:
            rec = self.groups[gid]
            self._dissolved.add(gid)
            members = [m for m in rec["members"]
                       if m != dead_sub and m not in self._dead_members]
            for m in members:
                self._member_group.pop(m, None)
        for m in members:
            # Flat now: the root monitors them directly (their announce
            # refreshes the lease; one that never re-points expires).
            self.detector.touch(m)
        trace.count("hier.groups_dissolved")
        log.error("sub-leader crashed; dissolving group to flat",
                  group=gid, dead=dead_sub, members=members)
        self._replicate("groups", Groups=self._groups_json())
        out = GroupPlanMsg(self.node.my_id, gid, dissolve=True,
                           epoch=self.epoch)
        # The (declared-dead) sub-leader gets the notice too: a FALSE
        # positive — a partitioned-but-alive sub-leader — must stand
        # down (stop fanning out, stop dead-reporting members it no
        # longer hears from) instead of running a zombie group forever.
        for m in members + [dead_sub]:
            try:
                self.node.add_node(m)
                self.node.transport.send(m, out)
            except (OSError, KeyError) as e:
                log.warn("dissolve notice undeliverable (the seat's own "
                         "timeout will surface it)", member=m,
                         err=repr(e))

    # --------------------------------------------- elastic membership

    def _place_joiner(self, node: NodeID) -> NodeID:
        """Grouped clusters absorb joiners (docs/membership.md): the
        joiner lands in the least-loaded live group — bounded by the
        ``partition_groups`` sqrt sizing, so churn can't melt one
        sub-leader — and its control parent becomes that group's
        sub-leader; the next re-plan's ``GroupPlanMsg`` hands the
        sub-leader its targets.  A re-joining sub-leader seat, and a
        fleet whose groups are all dissolved/oversubscribed, plan
        flat (parent = this root)."""
        import math

        with self._lock:
            gid = self._member_group.get(node)
            if gid is not None:
                return self.groups[gid]["leader"]
            if node in self._group_of_subleader:
                return self.node.my_id
            candidates = sorted(
                (len([m for m in rec["members"]
                      if m not in self._dead_members]), g)
                for g, rec in self.groups.items()
                if g not in self._dissolved)
            if not candidates:
                return self.node.my_id
            n_seats = len(self._member_group) + len(self.groups) + 2
            cap = max(2, math.isqrt(n_seats) + 1)
            size, gid = candidates[0]
            if size >= 2 * cap:
                return self.node.my_id  # every group oversubscribed
            rec = self.groups[gid]
            if node not in rec["members"]:
                rec["members"] = sorted(set(rec["members"]) | {node})
            self._member_group[node] = gid
            self._dead_members.discard(node)
            sub = rec["leader"]
            gj = self._groups_json()
        trace.count("hier.joiners_grouped")
        log.info("joiner absorbed into group", node=node, group=gid,
                 sub=sub)
        self._replicate("groups", Groups=gj)
        return sub

    def handle_join(self, msg: JoinMsg) -> None:
        super().handle_join(msg)
        if not msg.admitted:
            # A re-admitted sub-leader seat re-forms its dissolved
            # group (docs/membership.md).
            self._maybe_reform(msg.src_id)

    def handle_announce(self, msg: AnnounceMsg) -> None:
        super().handle_announce(msg)
        # A dead sub-leader's seat coming back through a plain revival
        # announce re-forms its group too.
        if not self.membership.is_left(msg.src_id):
            self._maybe_reform(msg.src_id)

    def _maybe_reform(self, node: NodeID) -> None:
        """Re-form a dissolved group when its sub-leader seat is
        re-admitted: surviving members move back under it (re-point
        notices), the root stops monitoring them directly, and the
        next re-plan hands the sub-leader its targets again."""
        gid = self._group_of_subleader.get(node)
        if gid is None:
            return
        with self._lock:
            if gid not in self._dissolved:
                return
            self._dissolved.discard(gid)
            rec = self.groups[gid]
            members = [m for m in rec["members"]
                       if m != node and m not in self._dead_members
                       and not self.membership.is_left(m)]
            for m in members:
                self._member_group[m] = gid
            gj = self._groups_json()
        for m in members:
            # Their liveness belongs to the sub-leader's detector again.
            self.detector.forget(m)
        trace.count("hier.groups_reformed")
        log.warn("sub-leader seat re-admitted; re-forming its "
                 "dissolved group", group=gid, sub=node,
                 members=members)
        self._replicate("groups", Groups=gj)
        addr = self.membership.addr_of(node)
        out = JoinMsg(self.node.my_id, node=node, addr=addr,
                      admitted=True, parent=node, parent_addr=addr,
                      epoch=self.epoch)
        for m in members:
            try:
                self.node.add_node(m)
                self.node.transport.send(m, out)
            except (OSError, KeyError, ConnectionError) as e:
                log.warn("re-point notice undeliverable (the member "
                         "stays flat until the next lease)", member=m,
                         err=repr(e))
        self._send_group_plans()

    def _finalize_drain(self, node: NodeID) -> None:
        """A drained SUB-LEADER's group dissolves (members re-point at
        the root — the same degradation a sub-leader crash runs, minus
        the crash); a drained grouped MEMBER simply leaves its group's
        roster so fan-out stops chasing it."""
        gid = self._group_of_subleader.get(node)
        with self._lock:
            dissolve = gid is not None and gid not in self._dissolved
        if dissolve:
            self._dissolve_group(gid, node)
        gj = None
        with self._lock:
            mg = self._member_group.pop(node, None)
            if mg is not None:
                rec = self.groups.get(mg)
                if rec and node in rec["members"]:
                    rec["members"] = [m for m in rec["members"]
                                      if m != node]
                gj = self._groups_json()
        if gj is not None:
            self._replicate("groups", Groups=gj)
        super()._finalize_drain(node)
