"""Receiver state machines.

Re-design of the reference's receivers
(``distributor/node.go:1291-1589``):

- ``ReceiverNode`` (mode 0): announce initial layers to the leader, store
  received layers in RAM, ack, unblock ``ready()`` on startup.
- ``RetransmitReceiverNode`` (modes 1/2): additionally serves
  ``RetransmitMsg`` — forwards its copy of a layer to a named destination;
  client-held layers are piped cut-through from the external client.
- ``FlowRetransmitReceiverNode`` (mode 3): handles partial-layer commands
  and **really reassembles** byte ranges into one buffer at the right
  offsets — the reference only sums sizes and never copies the bytes
  (node.go:1545-1547), a measurement-harness shortcut this framework fixes.

Deviation: ``announce()`` includes each layer's ``SourceType`` so the
mode-3 flow graph can model per-source-class capacity; the reference drops
it on announce (node.go:1392-1403) which collapses all announced layers
into one source class.

Copy of the JAX package's ``runtime/receiver.py`` with its device seams on
this package's torch modules: ``-hbm`` staging through one shared
``parallel.mover.WeightMover`` on the node's ``device``, per-layer
incremental ``parallel.ingest.ShardedLayerIngest`` fed fragment by
fragment, ``runtime.stream_boot.StreamingBootStager``,
``runtime.boot.precompile_boot``/``boot_from_layers``, and served
``GenerateReqMsg`` through ``models.generate`` (sampling draws from a
``torch.Generator`` seeded with the request's seed, so sampled ids differ
from the JAX receiver's; greedy ids agree).  The single-controller device
fabric (``fabric=`` a ``parallel.fabric.FabricPlane`` with a
``parallel.mesh.fabric_placement``) and the multi-controller one
(``fabric=`` a ``parallel.spmd_fabric.SpmdFabric``, one process per node,
with its pod serving on ``ServeMsg``) run as in the JAX package; a layer
a plan delivers lands as a uint8 tensor on this node's device.  Each
"delivery beats staging" fallback still
fires as in the JAX package and also bumps a ``fallback.*`` trace counter
(the fabric's: ``fallback.fabric_host_assembly``,
``fallback.fabric_replan``), so a run that must stay on the device can
prove that none fired.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time as _time
from typing import Dict, Tuple

from ..core.types import (
    LayerIDs,
    LayerLocation,
    LayerMeta,
    LayerSrc,
    LayersSrc,
    delta_base_digest,
    shard_covers,
    shard_range,
)
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
    JobRevokeMsg,
    JoinMsg,
    LayerDigestsMsg,
    LayerMsg,
    LayerNackMsg,
    LeaderLeaseMsg,
    MetricsReportMsg,
    PlanResendReqMsg,
    RetransmitMsg,
    ServeMsg,
    SourceDeadMsg,
    StartupMsg,
    SwapCommitMsg,
    TimeSyncMsg,
)
from ..utils import (
    env as env_util,
    hostmem,
    integrity,
    intervals,
    telemetry,
    threads as threads_util,
    trace,
)
from ..utils.buffers import alloc_recv_buffer
from ..utils.logging import log
from .checkpoint import LayerCheckpointStore
from .failure import HeartbeatSender
from .node import MessageLoop, Node
from .store import ContentStore
from .swap import SwapController
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

# Max hinted held-sets a receiver keeps warm at once: hints are
# unauthenticated, and each warmup is a seconds-long XLA compile
# thread — a well-behaved run re-targets a handful of times.  Kept as
# an insertion-ordered window: when a new distinct set arrives at the
# cap, the OLDEST hinted set is evicted (superseded re-targets must
# not consume the budget forever — a long-lived receiver crossing
# many update()s still warms its newest target).
_PRECOMPILE_MAX_SETS = 4

# Integrity-plane bounds (docs/integrity.md).  NACKs per corrupt byte
# range: a persistently corrupt path must go quiet and fail loudly, not
# livelock the wire with retransmit requests.  Digest retries per layer:
# each mismatch re-opens the layer's intervals and re-announces (a full
# re-fetch), so a corrupt SOURCE is caught after a few rounds.
_NACK_MAX_PER_RANGE = 8
_DIGEST_MAX_RETRIES = 3
# Quiet-gap watchdog cadence (seconds; DLD_GAP_NACK_S overrides, 0
# disables): a partial mode-3 layer whose coverage sat unchanged — and
# claim-idle — across a full interval has lost frames SILENTLY (eaten
# retransmit, reset mid-flight, vanished sender): re-NACK its gaps to
# the last-seen sender so recovery never depends on one NACK round-trip
# surviving the same faulty path that ate the data.  Re-NACKs ride the
# same per-range budget as first NACKs, so a dead path still goes quiet.
_GAP_NACK_DEFAULT_S = 3.0
# Per-layer cap on journal CRC records (each journaled fragment appends
# one, and every meta write re-serializes the whole list): 1024 covers a
# 16 GiB layer at the 16 MiB fragment floor.  Past it the layer's CRC
# records are dropped (legacy journal — resume trusts the fsync
# ordering, loudly) rather than letting a tiny-fragment flood make the
# meta write O(n^2).
_JOURNAL_CRC_MAX_RECORDS = 1024



class ReceiverNode:
    """Mode 0 receiver (node.go:1299-1418).

    ``heartbeat_interval`` > 0 starts a liveness beacon to the leader on
    the first ``announce()`` — the receiver half of the failure detection
    the reference leaves TODO (node.go:218-220)."""

    # How long a fabric dest waits for a plan's contributions before
    # requesting a re-plan (class attribute: tests and deployments tune it).
    FABRIC_COLLECT_TIMEOUT = 120.0

    # How long a dest holds an incomplete plan batch before processing
    # the members that did arrive (a participant's dispatch failed and
    # its plan went host-path).
    FABRIC_BATCH_WAIT = 10.0

    # Serve-time request bounds (class attributes: deployments tune
    # them).  GenerateReqMsg is as unauthenticated as BootHintMsg, and
    # each request allocates a KV cache proportional to prompt+max_new
    # AND compiles one decode program per distinct (prompt_len,
    # max_new) shape — so both dimensions are hard-capped, mirroring
    # the _PRECOMPILE_MAX_SETS budget on the other unauthenticated
    # control path.  SERVE_MAX_CONCURRENT bounds simultaneous decodes
    # (each runs on its own daemon thread so the one-slot handler pool
    # stays free for control traffic); excess requests get an
    # immediate "busy" refusal — every outcome answers.
    SERVE_MAX_PROMPT = 4096
    SERVE_MAX_NEW = 1024
    SERVE_MAX_CONCURRENT = 2

    def __init__(
        self,
        node: Node,
        layers: LayersSrc,
        storage_path: str = ".",
        start_loop: bool = True,
        heartbeat_interval: float = 0.0,
        stage_hbm: bool = False,
        placement=None,
        boot_cfg=None,
        fabric=None,
        boot_codec: str = "raw",
        boot_generate: int = 0,
        codecs=None,
        device=None,
    ):
        """``boot_cfg``: a ``models.llama.ModelConfig``; when set, the
        startup message boots the model from the delivered layer blobs
        (``runtime.boot``) and reports a ``BootReadyMsg`` to the leader —
        the inference engine the reference's startup hook only gestures at
        (message.go:216-241).  ``boot_codec``: the transfer codec the
        blobs were encoded with (``models/quant.py``); ``boot_generate``
        > 0 additionally decodes that many tokens after a full boot (the
        KV-cached serving loop).

        ``stage_hbm``: stage each delivered layer into device memory (a
        1-D uint8 tensor on ``device``) before acking — the device-native
        terminal state; the reference stops at host RAM
        (node.go:435-446).

        ``device``: where staging, boot and serving run (None = the
        placement's device for this node, else the CUDA card).  Resolved
        only for nodes that stage or boot: a host-only seeder or leader
        never touches a device.

        ``placement``: a ``parallel.mesh.StagePlacement`` (derived from the
        Assignment + the config's Mesh section).  With it, a delivered
        layer lands replicated on *its pipeline stage's* devices via the
        sharded-ingest path (1/n host→device traffic per device + one ICI
        all-gather) instead of on the default device — the staged-inference
        layout the reference's startup hook presumes
        (distributor/message.go:216-241).

        ``fabric``: a ``parallel.fabric.FabricPlane`` shared with the
        leader and the other nodes of the pod.  The node then serves
        ``DevicePlanMsg`` commands: it publishes its planned byte ranges
        onto its own stage devices (seeder half) and ingests plans
        addressed to it over the device fabric (dest half) — layer bytes
        never touch the transport (the reference's per-transfer TCP byte
        stream, transport.go:267-274, replaced by ICI).

        ``codecs``: the node's ``runtime.codec.WireCodecPlane``
        (docs/codec.md).  With it, this node ANNOUNCES its wire-codec
        decode capability (the leader may then choose quantized
        transfers for it over slow links), serves encoded byte ranges
        as a SENDER (flow jobs, NACK retransmits, mode-1/2 forwards),
        and accounts decoded-vs-wire bytes for the run report."""
        self.node = node
        self.layers = layers
        self.storage_path = storage_path
        self.stage_hbm = stage_hbm
        self.placement = placement
        self.boot_cfg = boot_cfg
        self.boot_codec = boot_codec
        self.boot_generate = boot_generate
        self.fabric = fabric
        if (device is None and placement is not None
                and node.my_id in placement.node_to_stage):
            device = placement.devices_for_node(node.my_id)[0]
        # Kept for the pod gather, which resolves it only when a pod
        # layer lands: a host-only node never touches a device.
        self._device_req = device
        self.device = None
        if stage_hbm or boot_cfg is not None:
            from ..utils.device import resolve_device

            self.device = resolve_device(device)
        self.boot_result = None  # BootResult after a successful boot
        self._boot_started = False
        self._boot_finished = threading.Event()  # set after _boot (any outcome)
        # Set when the _boot TASK has fully drained (report sent, any
        # -gen decode done) — the CLI must not exit the process while a
        # boot runs on this daemon pool (it would die silently and the
        # leader's boot wait would hang on the missing report).
        self._boot_drained = threading.Event()
        # (seconds, kind) of the boot outcome, for re-answering a
        # re-sent startup when the first BootReadyMsg was lost.
        self._boot_report = None
        # One hint-time warmup per DISTINCT held-set: repeat hints for
        # the same set (re-announce, update) are no-ops, while an
        # update() that changes this node's held-set shape warms the new
        # program too.  Hard-capped (_PRECOMPILE_MAX_SETS): hints are
        # unauthenticated control messages, and unbounded distinct sets
        # would mean unbounded concurrent XLA compile threads.
        # _precompile_done is set exactly when NO warmup is in flight
        # (an in-flight counter, not a per-thread pulse).
        # Insertion-ordered (dict keys): newest-N window, oldest evicted.
        self._precompiled_sets: dict = {}
        self._precompile_inflight = 0
        self._serve_active = 0
        self._precompile_done = threading.Event()
        self._precompile_done.set()
        # (record, finished before startup) of every warm-up that ran.
        self.precompile_records: list = []
        # Startup marker for overlap accounting: precompiles and streamed
        # stagings that finish before this fires ran DURING the wire.
        self._startup_seen = threading.Event()
        # Integrity plane (docs/integrity.md): expected per-layer
        # self-describing
        # digests stamped by the leader (LayerDigestsMsg), this node's
        # own announced digests (cached — a re-announce must not
        # re-hash gigabytes), layers whose digest already verified (a
        # re-ack must not re-hash either), per-layer digest retry
        # counts, per-range NACK budgets, and the retransmit service
        # for NACKs this node receives as a SENDER.
        self.layer_digests: Dict[int, str] = {}
        # Sharded targets (docs/sharding.md): leader-stamped shard spec
        # per assigned layer (the interval set is complete — and acks —
        # at SHARD coverage), and the per-RANGE digest a shard verifies
        # against without ever holding the full layer.
        self._shard_specs: Dict[int, str] = {}
        self._range_digests: Dict[int, str] = {}
        # Fabric-assisted pod delivery (docs/fabric.md): leader-stamped
        # pod width per layer — this dest's shard target is one slice
        # of an n-way POD split; after the per-range digest gate the
        # shard feeds the on-mesh reconstruction and the FULL tree acks
        # once it verifies against the stamped full wire-form digest.
        self._pod_widths: Dict[int, int] = {}
        self._pod_collecting: set = set()
        self._pod_stager_obj = None
        # Versioned rollout targets (docs/swap.md): leader-stamped
        # version per assigned layer — stored holdings and acks carry
        # the tag, so a v2 delivery can never be mistaken for (or
        # clobbered by) an unversioned copy under the same id.
        self._layer_versions: Dict[int, str] = {}
        # Wire-codec targets (docs/codec.md): the node's codec plane
        # (capability + encoded serving), the leader-stamped codec per
        # assigned layer (interval accounting, journal, and NACK ranges
        # then live in ENCODED byte space, and the stamped digest is
        # codec-qualified), and the per-layer advisory frame tag — the
        # fallback identity when no stamp arrived (digests disabled),
        # so encoded bytes are never stored as raw.
        self.codec_plane = codecs
        self._layer_codecs: Dict[int, str] = {}
        self._frag_codec: Dict[int, str] = {}
        # Content-delta stamps (docs/codec.md): per assigned layer, the
        # canonical digest of the RECONSTRUCTED form of a delta
        # transfer (LayerDigestsMsg.full_digests) — the second gate a
        # delta pair passes (the first verifies the wire stream under
        # its codec-qualified identity).
        self._full_digests: Dict[int, str] = {}
        # The rollout version the serving params were assembled under
        # ("" until a swap commits here), and the per-blob version map
        # of the CURRENT serving tree — the per-step uniformity guard
        # of the token-granularity flip reads it (docs/rollout.md).
        self.serving_version = ""
        self._serving_tree_versions: Dict[int, str] = {}
        # This node's own modeled NIC rate (bytes/s, 0 = unknown),
        # carried on announces so a mode-3 leader admitting this seat
        # as a JOINER models the link honestly instead of pinning the
        # most conservative configured value (docs/membership.md).
        self.nic_bw = 0
        # Live-swap state machine (runtime/swap.py): stages v2 sets
        # concurrently with v1 serving and applies the epoch-fenced
        # commit flip.  Only serving-capable nodes carry one.
        self.swap = (SwapController(self) if boot_cfg is not None
                     else None)
        self._own_digests: Dict[int, str] = {}
        self._digest_ok: set = set()
        self._digest_retries: Dict[int, int] = {}
        self._nack_counts: Dict[Tuple[int, int], int] = {}
        self.nacker = NackRetransmitter()
        # Preemption revoke registry (docs/service.md): queued sends a
        # re-plan demoted; consulted by the flow-job executor.
        self.revokes = RevokeRegistry()
        # Content-addressed layer store (runtime/store.py,
        # docs/service.md): digest -> locally held layer ids, fed by
        # this node's own announce-time hashes and ack-gate verifies.
        # When a digest stamp names an ASSIGNED layer this node doesn't
        # hold but whose bytes it provably has under another id (a v2
        # rollout's unchanged layer), the store aliases the bytes and
        # acks instantly -- zero wire bytes.
        self.content_store = ContentStore()
        # Delta base lookup (docs/codec.md): the plane resolves a base
        # digest to this node's verified canonical holding — both for
        # RECONSTRUCTING a delivered delta and for ENCODING one when
        # this node is picked as a delta sender.  Only wired when no
        # role claimed the plane yet (a leader wires its own map).
        if (self.codec_plane is not None
                and self.codec_plane.base_resolver is None):
            self.codec_plane.base_resolver = self._resolve_delta_base
        # Per-layer streaming boot staging (runtime/stream_boot.py):
        # each completed blob's decode + host→device placement runs the
        # moment its interval set completes, concurrent with the
        # remaining transfers, and the startup boot assembles the staged
        # leaves with one concat per leaf.  Gated by DLD_STREAM_BOOT.
        self._boot_stager = None
        if boot_cfg is not None and env_util.stream_boot_enabled():
            from .stream_boot import StreamingBootStager

            self._boot_stager = StreamingBootStager(
                boot_cfg, codec=boot_codec, device=self.device,
                node_id=node.my_id, placement=placement,
                digest_lookup=self._expected_digest,
                digest_verified=self._digest_ok)
            self._boot_stager.on_gathered = self._on_pod_gathered
        # Multi-controller serving (runtime/pp_serve.py): startup said a
        # ServeMsg will follow; the CLI keeps the process alive until
        # serve_done() fires (or times out).
        self.expect_serve = False
        self.serve_started = threading.Event()  # a ServeMsg arrived
        self._serve_q: "queue.Queue[object]" = queue.Queue()
        # Eager when enabled: handlers run on a 16-worker pool, so a lazy
        # check-then-set would race.  ONE mover (one pinned chunk ring and
        # one side stream) serves the bulk path and every layer's
        # incremental ingest.
        self._mover = None
        if stage_hbm:
            from ..parallel.mover import WeightMover
            self._mover = WeightMover(self.device)
            self._mover.warm()  # pinned before the first fragment arrives
        self._ready_q: "queue.Queue[object]" = queue.Queue()
        self._lock = threading.Lock()
        self._spmd = getattr(fabric, "kind", "") == "spmd"
        if fabric is not None and hasattr(fabric, "bind_store"):
            # SPMD fabric: the executor reads this node's own byte ranges
            # straight from the layer store when serving plans.
            fabric.bind_store(self.layers, self._lock)
        if self._spmd:
            # Stall self-healing: a persistent seq gap (a DevicePlanMsg
            # this process never received) reports the missing seqs to
            # the leader, which re-sends its retained plan — or cancels
            # the seq — so the pod lockstep never waits forever on one
            # lost control message.
            fabric.on_gap = self._report_plan_gap
        # layer -> Event: staging-in-progress marker so a re-plan duplicate
        # completing concurrently never double-stages a multi-GB layer
        # (check-and-mark happens under self._lock; the duplicate waits).
        self._hbm_staging: Dict[int, threading.Event] = {}
        # Fabric dest pipeline state: the shared in-flight window (lazy —
        # only fabric dests pay for the retirement thread) and the
        # batch-accumulation groups for leader-stamped plan batches.
        self._plan_window = None
        self._plan_batches: Dict[str, dict] = {}
        # NOTE on fault injection: the old construction-gated
        # ``test_drop_plan_seqs`` receiver knob is gone — deterministic
        # fault injection now lives entirely in the transport wrapper
        # (``transport/faults.FaultyTransport``), which the CLI arms via
        # its explicit test flags.  Production receivers see a plain
        # transport; no environment variable can drop real plans.
        #
        # Control-plane HA (docs/failover.md): the highest leader epoch
        # seen (stale-epoch control traffic from a zombie ex-leader is
        # FENCED against it), the requeue buffer for leader-routed
        # messages that failed during a failover window (flushed on the
        # next lease), and the StandbyController's lease hook.
        self._leader_epoch = -1
        # Epoch at which the CURRENT leader claimed its seat: a worker
        # switches leaders only for a strictly better claim — higher
        # epoch, or same epoch from a lower node id (the deterministic
        # tiebreak for two concurrently-promoted standbys) — so
        # alternating equal-epoch leases can never flip-flop the
        # leader pointer.
        self._leader_claim_epoch = -1
        self._leader_pending: "collections.deque" = collections.deque(
            maxlen=256)
        self.on_leader_lease = None
        # Set by a promoting StandbyController: leader-bound swap
        # messages (confirm/query/error) forward to the promoted
        # leader's driver — the shared loop keeps THIS handler.
        self.on_swap_leader_msg = None
        # Hierarchical control (docs/hierarchy.md): an attached
        # SubLeaderController sets this to trigger intra-group fan-out
        # the moment one of this seat's own layers completes (fired at
        # the ack chokepoint, every completion path).
        self.on_layer_complete = None
        # Elastic membership (docs/membership.md): the join/drain
        # handshake latches — join() blocks on the admit notice,
        # request_drain() on the leader's done/refused answer.
        self._join_admitted = threading.Event()
        self._drain_done = threading.Event()
        self._drain_error = ""
        # Latched by close(): a closed receiver's still-draining daemon
        # work (a boot thread finishing late) must not emit leader-routed
        # messages — its seat's address may already belong to a NEW
        # incarnation's cluster, and a stale report would corrupt that
        # run's control state.
        self._closed_evt = threading.Event()
        # The heartbeat follows the CURRENT leader: after a takeover the
        # beacon must feed the successor's failure detector, not a dead
        # seat's queue.
        self.heartbeat = HeartbeatSender(
            node.transport, node.my_id, node.leader_id, heartbeat_interval,
            leader_fn=lambda: self.node.leader_id,
        )
        # Telemetry plane (docs/observability.md): periodic run-scoped
        # metric snapshots to the leader (MetricsReportMsg; cumulative,
        # so a lost report costs staleness, never skew), started with
        # the first announce; and the clock-offset estimate from the
        # announce-time TimeSyncMsg round trip (leader clock minus this
        # node's — logged so cli/trace.py aligns multi-host timelines).
        self.clock_offset_ms = None
        self._metrics_stop = threading.Event()
        self._metrics_thread = None
        interval = telemetry.metrics_interval()
        self._metrics_interval = interval if telemetry.enabled() else 0.0
        # Corrupt-fragment reports (a frame the transport dropped for a
        # failed CRC, an injected drop, or a TTL-pruned stripe group)
        # become bounded NACKs to the fragment's source.
        if hasattr(node.transport, "on_corrupt"):
            node.transport.on_corrupt = self._on_corrupt_fragment
        self.loop = MessageLoop(node.transport)
        self._register_handlers()
        if start_loop:
            self.loop.start()

    def _register_handlers(self) -> None:
        self.loop.register(LayerMsg, self.handle_layer)
        self.loop.register(StartupMsg, self.handle_startup)
        self.loop.register(DevicePlanMsg, self.handle_device_plan)
        self.loop.register(ServeMsg, self.handle_serve)
        self.loop.register(BootHintMsg, self.handle_boot_hint)
        self.loop.register(GenerateReqMsg, self.handle_generate_req)
        self.loop.register(LayerDigestsMsg, self.handle_layer_digests)
        self.loop.register(LeaderLeaseMsg, self.handle_leader_lease)
        self.loop.register(TimeSyncMsg, self.handle_time_sync)
        self.loop.register(SwapCommitMsg, self.handle_swap_commit)
        self.loop.register(GroupPlanMsg, self.handle_group_plan)
        self.loop.register(JoinMsg, self.handle_join)
        self.loop.register(DrainMsg, self.handle_drain)

    # ------------------------------------------------- control-plane HA

    def note_leader_epoch(self, epoch: int) -> None:
        """Raise the fencing watermark (a promoting StandbyController
        bumps its own worker past the old leader's epoch)."""
        with self._lock:
            if epoch > self._leader_epoch:
                self._leader_epoch = epoch

    def _fence_stale(self, msg) -> bool:
        """True when ``msg`` carries a leader epoch BELOW the highest
        seen — a zombie ex-leader's control traffic, which must be
        rejected, not raced (docs/failover.md).  Messages without an
        epoch (-1: HA off / legacy peer) always pass; higher epochs
        raise the watermark."""
        epoch = getattr(msg, "epoch", -1)
        if epoch < 0:
            return False
        with self._lock:
            cur = self._leader_epoch
            if epoch >= cur:
                self._leader_epoch = max(cur, epoch)
                return False
        trace.count("failover.fenced")
        log.warn("fencing stale-epoch control message",
                 kind=type(msg).__name__, src=getattr(msg, "src_id", None),
                 epoch=epoch, current=cur)
        return True

    def handle_leader_lease(self, msg: LeaderLeaseMsg) -> None:
        """The leader's liveness beacon.  A lease from a DIFFERENT node
        at a current-or-higher epoch is a completed takeover: re-point
        the leader, flush any messages requeued while the old leader was
        unreachable, and re-announce — the announce carries this node's
        authoritative inventory (checkpointed partials included), which
        is exactly the reconcile the new leader resumes delivery from."""
        if self._fence_stale(msg):
            return
        switched = False
        with self._lock:
            cur_leader = self.node.leader_id
            if msg.src_id == cur_leader:
                self._leader_claim_epoch = max(self._leader_claim_epoch,
                                               msg.epoch)
            elif (msg.epoch, -msg.src_id) > (self._leader_claim_epoch,
                                             -cur_leader):
                # Strictly better claim: higher epoch, or same epoch
                # from the lower node id (concurrent-promotion tiebreak).
                self._leader_claim_epoch = msg.epoch
                switched = True
        if switched:
            self.node.add_node(msg.src_id)
            self.node.update_leader(msg.src_id)
        hook = self.on_leader_lease
        if hook is not None:
            try:
                hook(msg)
            except Exception as e:  # noqa: BLE001 — standby hook is advisory
                log.error("leader-lease hook failed", err=repr(e))
        self._flush_leader_pending()
        if switched:
            trace.count("failover.leader_switch")
            log.warn("new leader lease observed; re-announcing to it",
                     leader=msg.src_id, epoch=msg.epoch)
            try:
                self.announce()
            except (OSError, KeyError) as e:
                log.error("re-announce to new leader failed", err=repr(e))

    def handle_group_plan(self, msg: "GroupPlanMsg") -> None:
        """Member half of hierarchical control (docs/hierarchy.md): a
        ``dissolve`` notice means this member's sub-leader was declared
        dead — re-point the control parent at the root and re-announce
        there (acks/heartbeats/metrics flow to the root; the group
        degrades to flat delivery).  A ``forward`` plan installs this
        member's chain relay roles (mode-3 receivers override the
        install; elsewhere it logs and the sub-leader's redrive covers
        the member by direct send).  A TARGETS plan is sub-leader
        business; a seat without an attached SubLeaderController (which
        replaces this handler) logs and ignores it."""
        if self._fence_stale(msg):
            return
        if not msg.dissolve:
            if msg.forward:
                self._install_forward_roles(msg)
                return
            log.warn("group plan received by a non-sub-leader seat; "
                     "ignoring", group=msg.group_id, src=msg.src_id)
            return
        trace.count("hier.dissolved_members")
        log.warn("group dissolved; re-pointing control parent at root",
                 group=msg.group_id, root=msg.src_id)
        self._clear_forward_roles()
        self.node.add_node(msg.src_id)
        with self._lock:
            self._leader_claim_epoch = max(self._leader_claim_epoch,
                                           msg.epoch)
        try:
            self.node.update_leader(msg.src_id)
        except KeyError:
            pass
        self._flush_leader_pending()
        try:
            self.announce()
        except (OSError, KeyError) as e:
            log.error("re-announce to root after dissolve failed",
                      err=repr(e))

    def _install_forward_roles(self, msg: "GroupPlanMsg") -> None:
        """Chain relay roles need the mode-3 reassembly plane; a plain
        receiver can't forward mid-flight bytes — the roles are advisory,
        so ignoring them is safe (the sub-leader's redrive converges
        this member by direct send)."""
        log.info("chain forward roles ignored (no relay plane at this "
                 "seat)", group=msg.group_id, layers=sorted(msg.forward))

    def _clear_forward_roles(self) -> None:
        """No relay plane, nothing to clear (mode 3 overrides)."""

    # ------------------------------------------------ elastic membership

    def join(self, want=None, timeout: float = 10.0,
             attempts: int = 3) -> bool:
        """Ask the leader to admit this UNCONFIGURED seat into the
        running cluster (docs/membership.md), then announce.  ``want``
        optionally names the layer ids to receive (empty = the current
        goal's layer universe).  Bounded retry: a request eaten by a
        fault window is re-sent; returns whether admission landed.
        The announce that follows carries this seat's local holdings
        (checkpointed partials + digests), so a COLD-BOOTING joiner
        refills only its missing bytes — mostly from peer holders."""
        self._join_admitted.clear()
        req = JoinMsg(self.node.my_id,
                      addr=self.node.transport.get_address(),
                      want=[int(l) for l in want or []])
        per_try = max(timeout / max(attempts, 1), 0.5)
        for _ in range(max(attempts, 1)):
            try:
                self.node.transport.send(self.node.leader_id, req)
            except (OSError, KeyError, ConnectionError) as e:
                log.warn("join request send failed; retrying",
                         err=repr(e))
            if self._join_admitted.wait(per_try):
                trace.count("membership.joined")
                self.announce()
                return True
        log.error("join request never admitted", leader=self.node.leader_id)
        return False

    def release_ready(self) -> None:
        """Release a ``ready()`` waiter without a StartupMsg: a DRAINED
        seat never receives one (it left the goal), so its driver calls
        this after a successful :meth:`request_drain` to unblock the
        normal exit path."""
        self._ready_q.put({})

    def request_drain(self, timeout: float = 30.0) -> bool:
        """Graceful leave (docs/membership.md): ask the leader to
        re-home this seat's unique holdings and release it.  Blocks
        until the DONE notice (True) or the timeout/refusal (False) —
        only a True return makes exiting crash-path-safe."""
        self._drain_done.clear()
        self._drain_error = ""
        trace.count("membership.drain_requested")
        self._send_to_leader(DrainMsg(self.node.my_id))
        if not self._drain_done.wait(timeout):
            log.error("drain request not answered within the timeout")
            return False
        if self._drain_error:
            log.error("drain refused", err=self._drain_error)
            return False
        return True

    def handle_join(self, msg: JoinMsg) -> None:
        """Receiver half of the JOIN vocabulary: the admit reply (this
        seat's own admission — re-point at the named parent and latch),
        roster notices (a peer joined: install its address), and
        re-point notices (a re-formed group moves this member back
        under its sub-leader)."""
        if not msg.admitted:
            return  # requests are leader business
        if self._fence_stale(msg):
            return
        subject = msg.node if msg.node >= 0 else msg.src_id
        if subject != self.node.my_id and msg.addr:
            # Roster notice: a peer joined — make it dialable.
            try:
                self.node.transport.addr_registry[subject] = msg.addr
            except (AttributeError, TypeError):
                pass
            self.node.add_node(subject)
        repoint = (msg.parent >= 0 and msg.parent != self.node.my_id
                   and (subject == self.node.my_id
                        or msg.parent == subject))
        if repoint and msg.parent != self.node.leader_id:
            # Admission placed (or a re-formed group moved) this seat
            # under a new control parent: announces, acks, heartbeats,
            # and metric reports flow there now.
            if msg.parent_addr:
                try:
                    self.node.transport.addr_registry[msg.parent] = \
                        msg.parent_addr
                except (AttributeError, TypeError):
                    pass
            self.node.add_node(msg.parent)
            try:
                self.node.update_leader(msg.parent)
            except KeyError:
                pass
            trace.count("membership.repointed")
            log.info("control parent re-pointed by membership notice",
                     parent=msg.parent)
            self._flush_leader_pending()
            if subject != self.node.my_id:
                # A re-point of an ALREADY-RUNNING member (group
                # re-form): re-announce to the new parent.  A joiner's
                # own admit skips this — join() announces once the
                # latch below releases it.
                try:
                    self.announce()
                except (OSError, KeyError) as e:
                    log.error("re-announce to new parent failed",
                              err=repr(e))
        if subject == self.node.my_id:
            self._join_admitted.set()

    def handle_drain(self, msg: DrainMsg) -> None:
        """The leader's answer to this seat's drain request (done or
        refused)."""
        if not msg.done and not msg.error:
            return  # requests are leader business
        if self._fence_stale(msg):
            return
        subject = msg.node if msg.node >= 0 else self.node.my_id
        if subject != self.node.my_id:
            return
        self._drain_error = msg.error
        self._drain_done.set()

    def _send_to_leader(self, msg) -> None:
        """Leader-routed send with failover-window requeue: a leader
        that just died must not eat acks/boot reports — they queue
        (bounded) and flush when the next lease names a live leader.
        A CLOSED receiver sends nothing: its late daemon work (a boot
        finishing after close) must not leak reports into whatever now
        owns its old address."""
        if self._closed_evt.is_set():
            log.debug("suppressing leader-routed send after close",
                      kind=type(msg).__name__)
            return
        try:
            self.node.transport.send(self.node.leader_id, msg)
        except (OSError, KeyError) as e:
            trace.count("failover.leader_requeued")
            with self._lock:
                self._leader_pending.append(msg)
            log.warn("leader unreachable; queued message for the "
                     "failover window", kind=type(msg).__name__,
                     err=repr(e))

    def _flush_leader_pending(self) -> None:
        while True:
            with self._lock:
                if not self._leader_pending:
                    return
                msg = self._leader_pending.popleft()
            try:
                self.node.transport.send(self.node.leader_id, msg)
            except (OSError, KeyError) as e:
                with self._lock:
                    self._leader_pending.appendleft(msg)
                log.warn("leader still unreachable; keeping queued "
                         "messages", err=repr(e))
                return

    def announce(self) -> None:
        """Tell the leader what I already hold, routed via the next hop
        (node.go:1392-1415)."""
        with self._lock:
            layer_ids: LayerIDs = {
                lid: LayerMeta(
                    location=src.meta.location,
                    limit_rate=src.meta.limit_rate,
                    source_type=src.meta.source_type,
                    data_size=src.data_size,
                    shard=src.meta.shard,
                    version=src.meta.version,
                    codec=src.meta.codec,
                )
                for lid, src in self.layers.items()
            }
        next_hop = self.node.get_next_hop(self.node.leader_id)
        if self.fabric is not None:
            # (Re)entering a distribution cycle: uploads may be retained
            # again until the next startup releases them.
            reopen_upload_cache()
        # Liveness BEFORE the digest hash: _announce_digests can run
        # seconds-to-minutes at physical sizes on a crc32-only host,
        # and the leader's failure-detector lease is already counting
        # down — heartbeats must flow while we hash.
        self.heartbeat.start()
        self.node.transport.send(
            next_hop,
            AnnounceMsg(self.node.my_id, layer_ids,
                        partial=self._announce_partial(),
                        digests=self._announce_digests(),
                        codecs=(self.codec_plane.decode_codecs()
                                if self.codec_plane is not None else []),
                        nic_bw=int(self.nic_bw or 0)),
        )
        # Telemetry plane: probe the leader's clock (request/response
        # midpoint → the offset cli/trace.py aligns timelines with) and
        # start the periodic metric reports.  Both advisory: a lost
        # probe or report costs observability, never delivery.
        try:
            self.node.transport.send(
                self.node.leader_id,
                TimeSyncMsg(self.node.my_id, _time.time() * 1000.0))
        except (OSError, KeyError) as e:
            log.debug("time-sync probe send failed", err=repr(e))
        self._start_metrics_reporter()

    # ------------------------------------------------------ telemetry plane

    def handle_time_sync(self, msg: TimeSyncMsg) -> None:
        """Both halves of the clock-offset probe.  A REQUEST is answered
        with this node's wall clock (any seat can answer; the leader's
        answer is the one that matters, and after a takeover the
        promoted worker answers with the new reference clock).  A REPLY
        closes this node's own probe: offset = t1 - (t0 + t2)/2, the
        NTP midpoint estimate, error-bounded by rtt/2 — both logged, so
        the offline trace tooling has what it needs."""
        now = _time.time() * 1000.0
        if not msg.reply:
            try:
                self.node.transport.send(
                    msg.src_id,
                    TimeSyncMsg(self.node.my_id, msg.t0_ms, t1_ms=now,
                                reply=True))
            except (OSError, KeyError) as e:
                log.debug("time-sync reply send failed", dest=msg.src_id,
                          err=repr(e))
            return
        rtt_ms = now - msg.t0_ms
        if rtt_ms < 0:
            return  # this process's own clock stepped mid-probe
        offset_ms = msg.t1_ms - (msg.t0_ms + now) / 2.0
        self.clock_offset_ms = offset_ms
        telemetry.gauge("clock_offset_ms", offset_ms)
        log.info("clock offset estimated", offset_ms=round(offset_ms, 3),
                 rtt_ms=round(rtt_ms, 3), reference=msg.src_id)

    def _start_metrics_reporter(self) -> None:
        if self._metrics_interval <= 0 or self._metrics_thread is not None:
            return
        self._metrics_thread = threading.Thread(
            target=self._metrics_loop, daemon=True,
            name=f"metrics-{self.node.my_id}")
        self._metrics_thread.start()

    def _metrics_loop(self) -> None:
        while not self._metrics_stop.wait(self._metrics_interval):
            self._send_metrics_report()

    def _send_metrics_report(self) -> None:
        """One cumulative run-scoped snapshot to the current leader.
        Best-effort by design (NOT the requeue path — a stale metric is
        worthless by the time a failover window drains): a failed send
        is simply superseded by the next interval's snapshot."""
        if self._closed_evt.is_set():
            return
        # Thread census by plane (docs/observability.md): refreshed
        # just before every snapshot, so the run report's
        # threads-by-plane table is per node and current.
        threads_util.publish_census()
        snap = telemetry.snapshot()
        gauges = dict(snap.get("gauges") or {})
        # Phase buckets ride as flat gauges so the leader's fold (and
        # the run report's cluster phase table) sees per-node phase
        # totals without a second wire vocabulary.
        for name, rec in (snap.get("phases") or {}).items():
            gauges[f"phase.{name}_ms"] = rec["ms"]
        with self._lock:
            epoch = self._leader_epoch
        msg = MetricsReportMsg(
            self.node.my_id, counters=snap.get("counters") or {},
            gauges=gauges, links=snap.get("links") or {},
            t_wall_ms=_time.time() * 1000.0, epoch=epoch,
            proc=snap.get("proc", ""),
            # Fixed-bucket histograms ride too (the rollout pipeline's
            # SLO guard reads per-replica serve latency from them,
            # docs/rollout.md).
            hists=snap.get("hists") or {},
            # Pair-lifecycle span ring (docs/observability.md):
            # cumulative like every section — the leader's fold is
            # replace-per-node.
            spans=snap.get("spans") or [])
        try:
            self.node.transport.send(self.node.leader_id, msg)
        except (OSError, KeyError) as e:
            log.debug("metrics report send failed", err=repr(e))

    # ------------------------------------------------------- integrity plane

    def _announce_digests(self) -> dict:
        """Self-describing digests (``integrity.layer_digest``) of this
        node's held full layers, cached (a re-announce must not re-hash
        gigabytes).  The layers not yet cached are hashed together by
        ``integrity.digest_layer_srcs``, concurrently where they are
        large enough.  Seeders announce before the leader starts, so the
        hash lands outside TTD but inside a fresh replica's time to
        serve."""
        if not integrity.digests_enabled():
            return {}
        with self._lock:
            # SHARD holdings never announce a layer digest: their buffer
            # is only real inside the shard's range, and hashing it as a
            # full layer would poison the leader's stamp collection
            # (docs/sharding.md).  CODEC holdings don't either: their
            # digest is the digest of the ENCODED form — presenting it
            # as the canonical layer digest would poison the stamp the
            # same way (docs/codec.md).  Both index their own key into
            # the content store at verify time instead.
            todo = [(lid, src) for lid, src in self.layers.items()
                    if lid not in self._own_digests
                    and not src.meta.shard and not src.meta.codec]
        digests = integrity.digest_layer_srcs(src for _, src in todo)
        for (lid, _), d in zip(todo, digests):
            if d is not None:
                self._own_digests[lid] = d
                self.content_store.index(lid, d)
        with self._lock:
            return {lid: d for lid, d in self._own_digests.items()
                    if not (self.layers.get(lid) is not None
                            and (self.layers[lid].meta.shard
                                 or self.layers[lid].meta.codec))}

    def handle_layer_digests(self, msg: LayerDigestsMsg) -> None:
        """The leader's expected-digest stamp for this dest's layers;
        leader-authoritative (a re-stamp after update() overwrites).

        Handlers run on an unordered pool (and layer frames ride
        separate data sockets), so a small layer can land — and ack —
        BEFORE its stamp is processed.  Close the race by re-checking
        already-held layers against the newly stamped digests: a
        mismatch demotes the layer and re-announces so the leader
        re-plans it, exactly like a mismatch at the ack gate."""
        if self._fence_stale(msg):
            return
        widened = []
        recoded = []
        with self._lock:
            # A CHANGED stamp (a swap retry superseding a poisoned
            # digest, docs/swap.md) resets the layer's verification
            # state: the old verdict and the spent retry budget belong
            # to the old expectation — without the reset, a corrected
            # rollout gives up instantly on the exhausted counter.
            for lid, d in msg.digests.items():
                prior = self.layer_digests.get(lid)
                if prior is not None and prior != d:
                    self._digest_retries.pop(lid, None)
                    self._digest_ok.discard(lid)
            self.layer_digests.update(msg.digests)
            # Content-delta stamps (docs/codec.md): the canonical
            # identity a delta pair's RECONSTRUCTED bytes verify
            # against.  A changed stamp resets the verification state
            # exactly like a changed stream digest above.
            for lid, d in msg.full_digests.items():
                prior = self._full_digests.get(lid)
                if prior is not None and prior != d:
                    self._digest_retries.pop(lid, None)
                    self._digest_ok.discard(lid)
            self._full_digests.update(msg.full_digests)
            # Rollout version stamps (docs/swap.md): which version each
            # assigned layer belongs to — stored holdings and acks
            # carry the tag from here on.
            self._layer_versions.update(msg.versions)
            # Wire-codec stamps (docs/codec.md): which ENCODED form
            # each assigned layer arrives in.  Leader-authoritative per
            # dest: a pair whose stamped codec CHANGED (re-targeted to
            # raw after a takeover, or to a different codec) invalidates
            # any in-flight partial state — its interval accounting
            # lives in the OLD form's byte space, and mixing spaces
            # would assemble garbage — so those layers demote for a
            # clean redelivery.  A RAW holding under a codec stamp
            # stays: canonical bytes satisfy every target.
            for lid in sorted(set(msg.digests) | set(msg.codecs)):
                new_codec = msg.codecs.get(lid, "")
                old_codec = self._layer_codecs.get(lid, "")
                if new_codec == old_codec:
                    continue
                src = self.layers.get(lid)
                held = src.meta.codec if src is not None else ""
                partial = lid in self._partial_totals_locked()
                if (held and held != new_codec) or (partial and old_codec):
                    recoded.append(lid)
                if new_codec:
                    self._layer_codecs[lid] = new_codec
                else:
                    self._layer_codecs.pop(lid, None)
            # The stamp is leader-authoritative per dest: a layer
            # stamped with a FULL digest and no shard entry — or an
            # explicit ``""`` entry in the shards map (the digests-off
            # form) — had its target WIDENED (e.g. a second job wanting
            # a disjoint shard merged the pair to full); one stamped
            # with a DIFFERENT spec the held shard doesn't cover was
            # RE-TARGETED.  Either way the stale spec must not keep
            # completing (and re-acking) at the old shard's coverage,
            # and an already-promoted shard holding must reopen as a
            # partial so the redelivered remainder completes the new
            # target (the replan/re-ack livelock this breaks: the
            # leader plans the new range forever while the dest's
            # dup-done path re-acks the old shard forever).
            def _reconcile(lid, new_spec):
                src = self.layers.get(lid)
                if (src is not None and src.meta.shard
                        and not shard_covers(src.meta.shard, new_spec)):
                    widened.append(lid)

            for lid in msg.digests:
                if lid not in msg.shards:
                    self._shard_specs.pop(lid, None)
                    self._range_digests.pop(lid, None)
                    _reconcile(lid, "")
            for lid, spec in msg.shards.items():
                if not spec:
                    self._shard_specs.pop(lid, None)
                    self._range_digests.pop(lid, None)
                _reconcile(lid, spec)
            self._shard_specs.update(
                {l: s for l, s in msg.shards.items() if s})
            self._range_digests.update(msg.range_digests)
            # Pod-delivery stamps (docs/fabric.md): which shard targets
            # are pod slices owing a full on-mesh reconstruction.  A
            # stamped layer whose pod entry DISAPPEARED was degraded to
            # plain delivery — stop expecting (or driving) a gather.
            for lid in set(msg.digests) | set(msg.shards):
                if lid not in msg.pods:
                    self._pod_widths.pop(lid, None)
            self._pod_widths.update(
                {int(l): int(n) for l, n in msg.pods.items() if n > 1})
        log.debug("layer digests stamped", n=len(msg.digests),
                  shards=len(msg.shards), codecs=len(msg.codecs))
        for lid in recoded:
            log.warn("layer's wire codec re-stamped; dropping stale "
                     "form for clean redelivery", layerID=lid,
                     codec=msg.codecs.get(lid, ""))
            self._demote_corrupt_layer(lid)
        if widened:
            self._reopen_widened(widened)
        self._recheck_stamped(list(msg.digests))
        self._try_content_resolve(sorted(msg.digests))
        if msg.shards:
            # Fragments can land BEFORE their shard stamp: a layer whose
            # coverage already satisfies the just-learned shard must
            # promote now — no later fragment will re-run the check.
            self._on_shard_specs(sorted(msg.shards))
        if msg.pods:
            # So can POD stamps: a member already holding its slice (or
            # the full tree) publishes it now instead of leaving peers
            # to time out waiting (docs/fabric.md).
            self._pod_publish_existing(sorted(msg.pods))
        if msg.versions:
            # Version stamps can lose the race against small layers the
            # same way: a layer that landed (and acked, unversioned)
            # before its stamp re-acks with the tag — the leader's swap
            # fence needs the versioned ack, and nothing else re-runs it.
            self._reack_versioned(sorted(msg.versions))

    def _reack_versioned(self, lids) -> None:
        for lid in lids:
            with self._lock:
                src = self.layers.get(lid)
                stamped = self._layer_versions.get(lid, "")
            if src is None or src.meta.shard:
                continue
            if src.meta.version == stamped:
                # Already acked under this tag (the stamp is re-sent on
                # every admission/replan): a re-ack here would make
                # every long-lived dest volley acks per new job.
                continue
            if (self._expected_digest(lid) is not None
                    and lid not in self._digest_ok):
                continue  # the ack gate will stamp + ack when it passes
            self._send_ack(lid, src.meta.location)

    def _reopen_widened(self, lids) -> None:
        """Hook: these SHARD holdings' targets widened (or re-targeted
        to a shard the held one doesn't cover).  The flow receiver
        demotes them back to partial coverage (keeping the shard's
        landed bytes); the base receiver can't reassemble fragments, so
        it drops the holding — the re-plan re-ships the whole target."""
        for lid in lids:
            with self._lock:
                src = self.layers.get(lid)
                if src is None or not src.meta.shard:
                    continue
                del self.layers[lid]
                self._own_digests.pop(lid, None)
                self._digest_ok.discard(lid)
            self.content_store.forget(lid)
            log.warn("shard holding's target widened/re-targeted; "
                     "dropped for redelivery", layerID=lid)

    def _on_shard_specs(self, lids) -> None:
        """Hook: shard specs were (re)stamped for these layers.  The
        flow receiver re-checks completion; the base receiver has no
        partial state to promote."""

    def _partial_totals_locked(self) -> dict:
        """Lock held.  In-flight partial transfer totals ({layer:
        total}) — the flow receiver's reassembly state; the base
        receiver has none."""
        return {}

    def _recheck_stamped(self, lids) -> None:
        """Retroactive digest verification for layers that landed before
        their stamp arrived (no-op for already-verified ones)."""
        for lid in lids:
            with self._lock:
                src = self.layers.get(lid)
                done = lid in self._digest_ok
                stamped_codec = self._layer_codecs.get(lid, "")
            if src is None or done or src.inmem_data is None:
                continue
            if src.meta.shard:
                # A shard holding verified against its RANGE digest at
                # the shard gate; the full-layer stamp doesn't apply to
                # its buffer (only the shard's range is real).
                continue
            if src.meta.codec != stamped_codec:
                # A RAW holding under a codec stamp: the stamped digest
                # is the ENCODED form's — it can't verify canonical
                # bytes, and raw satisfies the target anyway
                # (docs/codec.md).  Mismatched encoded forms were
                # demoted at stamp time.  EXCEPT a raw holding under a
                # DELTA stamp with a FullDigests entry: that's a
                # reconstructed (or pre-held) canonical form, and the
                # full digest verifies it (_verify_layer_digest).
                if not (not src.meta.codec
                        and delta_base_digest(stamped_codec)
                        and self._full_digests.get(lid)):
                    continue
            if self._verify_layer_digest(lid, memoryview(src.inmem_data),
                                         codec=src.meta.codec):
                continue
            self._demote_corrupt_layer(lid)
            log.error("stamped digest failed for an already-held layer; "
                      "demoted", layerID=lid)
            if self._bump_digest_retry(lid):
                self._request_replan()

    def _resolve_pending_for_layer(self, lid) -> None:
        """A layer just COMMITTED to the store: it can be the DONOR a
        stamped-but-missing layer was waiting for (the stamp arrived
        before these bytes did).  Without this re-check the pair would
        wedge — the leader's content index learns the holding from the
        ack and skips shipping, while nothing else ever re-runs the
        resolve.  Must not be called under ``self._lock``."""
        with self._lock:
            if (self._shard_specs.get(lid)
                    or self._layer_codecs.get(lid)
                    or (self.layers.get(lid) is not None
                        and (self.layers[lid].meta.shard
                             or self.layers[lid].meta.codec))):
                # A shard or codec holding can't donate full-layer
                # canonical bytes (its digest keys a different form).
                return
            digest = (self._own_digests.get(lid)
                      or self.layer_digests.get(lid))
            pending = ([l for l, d in self.layer_digests.items()
                        if d == digest and l not in self.layers
                        and not self._shard_specs.get(l)
                        and not self._layer_codecs.get(l)]
                       if digest else [])
        if pending:
            self._try_content_resolve(sorted(pending))

    def _try_content_resolve(self, lids) -> None:
        """Content-addressed instant resolve (docs/service.md): for each
        stamped layer this node does NOT hold, check the content store
        for locally held bytes with the SAME digest (a v2 rollout's
        unchanged layer under a new id).  A hit aliases the held buffer
        under the new layer id and acks immediately — zero wire bytes —
        which is what lets a delta rollout ship only changed layers.
        The alias shares the donor's buffer (received layers are never
        mutated after commit) and inherits its verified digest."""
        for lid in lids:
            with self._lock:
                if lid in self.layers:
                    continue
                if self._shard_specs.get(lid):
                    # Sharded targets resolve by the (digest, range)
                    # key, which full-layer vouching doesn't carry —
                    # no content resolve for them (docs/sharding.md,
                    # honest limits).
                    continue
                if self._layer_codecs.get(lid):
                    # Codec targets resolve by the (digest, codec) key;
                    # full-layer raw vouching doesn't carry it — no
                    # content resolve (docs/codec.md, honest limits).
                    continue
                digest = self.layer_digests.get(lid)
            if not digest:
                continue
            donor_lid = self.content_store.lookup(digest)
            if donor_lid is None:
                continue
            with self._lock:
                if lid in self.layers:
                    continue
                donor = self.layers.get(donor_lid)
                # Only a delivered-grade donor (host bytes in RAM, or
                # HBM with the retained host buffer) can vouch: an ack
                # means "in memory", and a DISK-only copy isn't.
                if (donor is None or donor.inmem_data is None
                        or donor.meta.location not in
                        (LayerLocation.INMEM, LayerLocation.HBM)):
                    continue
                alias = LayerSrc(
                    inmem_data=donor.inmem_data, fp=donor.fp,
                    data_size=donor.data_size,
                    meta=LayerMeta(location=LayerLocation.INMEM,
                                   source_type=donor.meta.source_type),
                )
                self.layers[lid] = alias
                self._own_digests[lid] = digest
                self._digest_ok.add(lid)
            self.content_store.index(lid, digest)
            trace.count("store.resolved_layers")
            trace.count("store.resolved_bytes", alias.data_size)
            log.info("content store resolved layer from local bytes; "
                     "no wire transfer", layerID=lid, donor=donor_lid,
                     bytes=alias.data_size, digest=digest)
            # Streamed boot staging treats the alias like any completed
            # layer; then ack so the leader credits every job waiting
            # on the pair.
            self._boot_stream_submit(lid, alias)
            self._send_ack(lid, alias.meta.location)

    def _bump_digest_retry(self, lid) -> bool:
        """Count one digest-mismatch recovery round for a layer; False
        when the budget is spent — the layer stays undelivered and the
        failure is loud (a corrupt SOURCE must never converge to a
        successful run, and must not livelock retransmits either)."""
        with self._lock:
            n = self._digest_retries.get(lid, 0) + 1
            self._digest_retries[lid] = n
        if n > _DIGEST_MAX_RETRIES:
            log.error("digest retry budget exhausted; layer stays "
                      "undelivered", layerID=lid, tries=n)
            trace.count("integrity.digest_given_up")
            if self.swap is not None:
                # A versioned layer that can never verify here means the
                # swap can never complete on this replica: report it so
                # the leader aborts cluster-wide (v1 keeps serving)
                # instead of waiting out the rollout forever.
                self.swap.on_staging_failed(lid, "digest retries exhausted")
            return False
        return True

    def _demote_corrupt_layer(self, lid) -> None:
        """Remove a digest-failed layer from the store (the flow
        receiver extends this with journal/partial/ingest teardown).
        The cached own-digest drops with it: a later re-announce must
        hash the REDELIVERED bytes, not re-announce the corrupt copy's
        digest.  So does any streamed boot staging of the corrupt bytes
        (stamp-race: a small layer can land, ack, and stage before its
        digest stamp is processed) — the redelivered copy re-stages."""
        with self._lock:
            self.layers.pop(lid, None)
            self._own_digests.pop(lid, None)
            self._frag_codec.pop(lid, None)
        self.content_store.forget(lid)
        if self._boot_stager is not None:
            self._boot_stager.invalidate(lid)

    def _expected_digest(self, lid):
        """The leader-stamped digest for a layer, falling back to this
        node's own announced digest (a seeder re-verifying its copy).
        For a SHARDED target the expected digest is the RANGE digest —
        the digest of exactly the shard's bytes (docs/sharding.md);
        callers hash the shard's slice against it.  None when the
        sharded stamp carried no range digest (the shard then verifies
        by per-fragment CRC alone)."""
        with self._lock:
            if self._shard_specs.get(lid):
                return self._range_digests.get(lid)
            return self.layer_digests.get(lid) or self._own_digests.get(lid)

    def _on_corrupt_fragment(self, src_id, layer_id, offset, size,
                             total, reason) -> None:
        """Transport hook: a frame was dropped before delivery (bad CRC,
        injected drop, or a TTL-pruned stripe group).  NACK the source
        for a byte-range retransmit — bounded per range, so a
        persistently corrupt path fails loudly instead of livelocking."""
        key = (layer_id, offset)
        with self._lock:
            n = self._nack_counts.get(key, 0) + 1
            self._nack_counts[key] = n
        if n > _NACK_MAX_PER_RANGE:
            log.error("NACK budget exhausted for range; leaving recovery "
                      "to crash detection", layerID=layer_id, offset=offset,
                      size=size, reason=reason)
            trace.count("integrity.nack_suppressed")
            return
        if src_id is None or src_id == self.node.my_id:
            return
        self._send_nack(src_id, layer_id, offset, size, total, reason)

    def _send_nack(self, src_id, layer_id, offset, size, total,
                   reason) -> None:
        trace.count("integrity.nack_sent")
        telemetry.link_add(src_id, self.node.my_id, nacks=1)
        # Wire-codec transfers NACK in ENCODED byte space: the codec
        # rides the NACK so the serving holder retransmits ranges of
        # the same encoded form (docs/codec.md).
        with self._lock:
            codec = (self._layer_codecs.get(layer_id)
                     or self._frag_codec.get(layer_id, ""))
        log.warn("layer fragment NACKed", layerID=layer_id, src=src_id,
                 offset=offset, bytes=size, reason=reason,
                 codec=codec or None)
        try:
            self.node.add_node(src_id)
            self.node.transport.send(
                src_id,
                LayerNackMsg(self.node.my_id, layer_id, offset, size,
                             total_size=total, reason=reason,
                             codec=codec),
            )
        except (OSError, KeyError, ConnectionError) as e:
            log.error("NACK send failed", dest=src_id, layerID=layer_id,
                      err=repr(e))

    def _verify_layer_digest(self, lid, data, shard: str = "",
                             codec: str = "") -> bool:
        """Check ``data`` against the layer's expected digest; True when
        no digest is known or it matches (memoized — a re-ack never
        re-hashes).  Counts + logs the outcome; the CALLER owns
        recovery (drop/NACK for whole-layer frames, interval re-open +
        re-announce for assembled mode-3 layers).  ``shard``: the spec
        ``data`` spans (the caller sliced the shard's range; the
        expected digest is then the stamped RANGE digest, and the
        verified bytes are content-indexed under the (digest, shard)
        key — docs/sharding.md).  ``codec``: the wire-codec form the
        bytes are in — the expected digest is then codec-qualified
        (the stamp hashed exactly the encoded bytes), and the content
        index carries the codec so encoded bytes never vouch for a raw
        pair (docs/codec.md)."""
        expected = self._expected_digest(lid)
        if not codec and not shard:
            with self._lock:
                stamped_c = self._layer_codecs.get(lid, "")
                if delta_base_digest(stamped_c):
                    # RAW bytes under a delta stamp: a reconstructed
                    # form's identity is the canonical FullDigests
                    # entry, never the delta stream's codec-qualified
                    # digest (docs/codec.md).
                    expected = self._full_digests.get(lid)
        if expected is None:
            return True
        with self._lock:
            if lid in self._digest_ok:
                return True
        ok, dt, got = integrity.digest_check(data, expected)
        if ok is None:
            return True  # xxh3 stamp, no xxhash here: advisory skip
        trace.add_phase("integrity_digest", dt)
        if ok:
            with self._lock:
                self._digest_ok.add(lid)
                # The bytes now provably hash to the stamp: seed the
                # announce cache so a recovery re-announce (replan,
                # digest retry) never re-hashes gigabytes it already
                # verified on the handler thread.  (Shard and codec
                # holdings skip it — their cache entry would be a RANGE
                # or encoded-form digest the announce must not present
                # as a canonical layer digest.)
                if not shard and not codec:
                    self._own_digests[lid] = expected
            self.content_store.index(lid, expected, shard=shard,
                                     codec=codec)
            log.info("layer digest verified", layerID=lid,
                     digest_ms=round(dt * 1000, 1), bytes=len(data),
                     codec=codec or None)
            return True
        trace.count("integrity.digest_mismatch")
        log.error("layer digest MISMATCH", layerID=lid, expected=expected,
                  got=got, bytes=len(data))
        return False

    # ------------------------------------------------ content-delta plane

    def _resolve_delta_base(self, digest):
        """digest → this node's verified canonical holding (the codec
        plane's ``base_resolver``): a content-store hit with
        delivered-grade host bytes, full-layer raw form only — the same
        donor rules as the content resolve.  Runs lock-free relative to
        the plane (only this node's own lock, never held by plane
        callers)."""
        lid = self.content_store.lookup(digest)
        if lid is None:
            return None
        with self._lock:
            src = self.layers.get(lid)
            if (src is None or src.inmem_data is None
                    or src.meta.shard or src.meta.codec):
                return None
            return src

    def _delta_reconstruct_bytes(self, lid, data, codec):
        """Canonical bytes from a VERIFIED delta stream, gated against
        the stamped FullDigests identity.  None = refused (no plane, no
        stamp, base lost here, or the reconstruction mismatched) — the
        caller demotes/drops for a raw re-plan; corrupt state never
        acks (docs/codec.md)."""
        plane = self.codec_plane
        if plane is None:
            log.error("delta transfer without a codec plane; refused",
                      layerID=lid)
            return None
        full = self._full_digests.get(lid, "")
        if not full:
            # The leader only chooses delta with the integrity plane on
            # and always stamps the canonical identity alongside —
            # reconstructing unverifiable bytes would trade corruption
            # for byte savings.
            log.error("delta transfer without a FullDigests stamp; "
                      "refusing reconstruction", layerID=lid)
            return None
        raw = plane.delta_reconstruct(lid, data, codec)
        if raw is None:
            return None
        ok, dt, got = integrity.digest_check(memoryview(raw), full)
        trace.add_phase("integrity_digest", dt)
        if ok is False:
            trace.count("integrity.digest_mismatch")
            log.error("delta reconstruction failed the canonical "
                      "digest", layerID=lid, expected=full, got=got)
            return None
        return raw

    def _note_delta_reconstructed(self, lid, wire_bytes: int,
                                  raw_bytes: int) -> None:
        """Bookkeeping after a reconstructed delta holding COMMITTED:
        the canonical digest seeds the announce cache and the content
        store (this node now vouches for — and can base future deltas
        on — the reconstructed bytes), and the wire/raw byte split is
        counted so the run report shows the delta win explicitly."""
        full = self._full_digests.get(lid, "")
        if full:
            with self._lock:
                self._own_digests[lid] = full
                self._digest_ok.add(lid)
            self.content_store.index(lid, full)
        trace.count("codec.delta_wire_bytes", wire_bytes)
        trace.count("codec.delta_raw_bytes", raw_bytes)
        log.info("delta stream reconstructed to canonical form",
                 layerID=lid, wire_bytes=wire_bytes,
                 raw_bytes=raw_bytes)

    def _finalize_delta(self, lid, src):
        """A completed, stream-verified delta holding reconstructs to
        canonical bytes NOW — the store must never stage (or ack) the
        delta stream itself.  Returns the replaced holding (or ``src``
        unchanged for non-delta forms); None when reconstruction
        refused — the layer demoted for a re-plan."""
        codec = src.meta.codec
        if not delta_base_digest(codec) or src.meta.shard:
            return src
        if src.inmem_data is None:
            log.error("delta holding without host bytes; demoted",
                      layerID=lid)
            raw = None
        else:
            raw = self._delta_reconstruct_bytes(
                lid, memoryview(src.inmem_data), codec)
        if raw is None:
            self._demote_corrupt_layer(lid)
            if self._bump_digest_retry(lid):
                self._request_replan()
            return None
        wire = src.data_size
        with self._lock:
            new_src = LayerSrc(
                inmem_data=bytearray(raw), data_size=len(raw),
                meta=LayerMeta(location=LayerLocation.INMEM,
                               source_type=src.meta.source_type,
                               version=src.meta.version),
            )
            new_src.offset = 0
            self.layers[lid] = new_src
        self._note_delta_reconstructed(lid, wire, len(raw))
        return new_src

    def _announce_partial(self) -> dict:
        """Checkpointed in-progress coverage to include in the announce;
        the base receiver has none."""
        return {}

    def ready(self) -> "queue.Queue[object]":
        return self._ready_q

    def _boot_stream_submit(self, layer_id, src) -> None:
        """Hand a freshly completed layer to the streaming boot stager
        (idempotent; a late duplicate no-ops).  Advisory: any failure
        here only costs the overlap — the startup boot's bulk assembly
        still covers every blob."""
        stager = self._boot_stager
        if stager is None or src is None:
            return
        try:
            stager.submit(layer_id, src)
        except Exception as e:  # noqa: BLE001 — staging is an optimization
            log.warn("streamed boot submit failed", layerID=layer_id,
                     err=repr(e))

    # ------------------------------------ fabric-assisted pod delivery

    def _pod_stager(self):
        """The shard-gather driver (docs/fabric.md): the boot stager
        when one exists (its gather ALSO dequants + stages the decoded
        leaves on device), else a lazily-built cfg-less stager that
        exists purely to run ``submit_shard``/``gather_byte_shards``
        off the handler threads."""
        if self._boot_stager is not None:
            return self._boot_stager
        with self._lock:
            if self._pod_stager_obj is None:
                from ..utils.device import resolve_device
                from .stream_boot import StreamingBootStager

                self._pod_stager_obj = StreamingBootStager(
                    None, node_id=self.node.my_id,
                    device=(self.device if self.device is not None
                            else resolve_device(self._device_req)))
                self._pod_stager_obj.on_gathered = self._on_pod_gathered
            return self._pod_stager_obj

    def _pod_board(self):
        """The pod shard-exchange board — the single-controller
        ``FabricPlane``'s in-process stand-in for the ICI hop.  None
        when this node has no fabric (or an SPMD one: there the leader
        dispatches the reconstruction as a lockstep plan instead)."""
        if self._spmd or self.fabric is None:
            return None
        return self.fabric if hasattr(self.fabric, "pod_publish") else None

    def _start_pod_collect(self, lid: int, src) -> None:
        """A verified holding covering this dest's pod slice exists
        (usually the freshly completed SHARD; also a pre-existing full
        or shard holding when the pod stamp arrives after a restart or
        over seeded bytes): publish the slice to the pod board and
        start this layer's collect loop (once) — peers' shards feed
        ``submit_shard`` in ANY completion order, and the last arrival
        fires the on-mesh gather."""
        board = self._pod_board()
        with self._lock:
            n = self._pod_widths.get(lid)
            # The STAMPED target spec names this dest's slice; the
            # holding may be wider (a full tree publishes its slice so
            # peers' gathers don't wait out the timeout for it).
            spec = self._shard_specs.get(lid) or src.meta.shard
            codec = self._layer_codecs.get(lid, "")
            if board is None or n is None or lid in self._pod_collecting:
                return
            self._pod_collecting.add(lid)
        from ..core.types import parse_shard_spec

        parsed = parse_shard_spec(spec)
        if (parsed is None or parsed[0] != n
                or not shard_covers(src.meta.shard, spec)
                or src.meta.codec != codec
                or src.inmem_data is None):
            log.error("pod stamp disagrees with the held bytes; not "
                      "gathering", layerID=lid, spec=spec, pod_n=n,
                      held_shard=src.meta.shard or None,
                      held_codec=src.meta.codec or None)
            with self._lock:
                # Un-claim: a corrected re-stamp must be able to retry.
                self._pod_collecting.discard(lid)
            return
        rank = parsed[1]
        total = src.data_size
        s0, s_sz = shard_range(spec, total)
        key = (lid, n, codec)
        board.pod_publish(key, rank,
                          memoryview(src.inmem_data)[s0:s0 + s_sz])
        log.info("pod shard published for on-mesh gather", layerID=lid,
                 rank=rank, pod_n=n, bytes=s_sz, codec=codec or None)
        threading.Thread(
            target=self._pod_collect_loop, args=(lid, n, total, codec),
            daemon=True, name=f"torch-pod-collect-{self.node.my_id}").start()

    def _pod_publish_existing(self, lids) -> None:
        """A pod stamp can name layers this dest ALREADY holds (restart
        re-announce, seeded replicas, a completed earlier pod round):
        publish the slice from the existing holding so peers' gathers
        never wait out the collect window for a member whose shard
        phase finished before the stamp."""
        if self._spmd:
            return  # the leader drives SPMD reconstruction explicitly
        for lid in lids:
            with self._lock:
                src = self.layers.get(lid)
                spec = self._shard_specs.get(lid, "")
                range_digest = self._range_digests.get(lid)
                verified = lid in self._digest_ok
            if src is None or src.inmem_data is None:
                continue
            if not verified and range_digest:
                # A pre-held full tree never crossed the shard gate:
                # its SLICE must verify against the stamped range
                # digest before it may enter peers' gathers.
                s0, s_sz = shard_range(spec, src.data_size)
                verified = integrity.digest_matches(
                    memoryview(src.inmem_data)[s0:s0 + s_sz],
                    range_digest)
                if not verified:
                    log.error("pre-held bytes fail the stamped range "
                              "digest; not publishing", layerID=lid)
                    continue
            elif not verified and range_digest is None:
                verified = True  # CRC-only regime (no digest stamped)
            self._start_pod_collect(lid, src)

    def _pod_collect_loop(self, lid: int, n: int, total: int,
                          codec: str) -> None:
        """Drain the board into the shard gather until all ``n`` shards
        arrived (the gather fires inside the stager's worker) or the
        collect window expires — bounded: a timeout leaves the shard
        holding acked as-is and the LEADER's pod watchdog degrades the
        (layer, pod) to host-path delivery; never a wedge."""
        board = self._pod_board()
        if board is None:
            return
        key = (lid, n, codec)
        stager = self._pod_stager()
        with self._lock:
            digest = self.layer_digests.get(lid, "")
        have: set = set()
        deadline = _time.monotonic() + self.FABRIC_COLLECT_TIMEOUT
        while len(have) < n:
            snap = board.pod_wait_new(key, len(have),
                                      deadline - _time.monotonic())
            if snap is None:
                trace.count("pod.collect_timeouts")
                log.error("pod delivery degraded to host path",
                          reason="peer shards never arrived",
                          layerID=lid, have=sorted(have), pod_n=n)
                board.pod_done(key, n, who=self.node.my_id)
                with self._lock:
                    # Un-claim so a redelivery can retry the collect.
                    self._pod_collecting.discard(lid)
                return
            for rank in sorted(set(snap) - have):
                have.add(rank)
                if not stager.submit_shard(
                        lid, f"1/{n}@{rank}", snap[rank], total,
                        expected_digest=digest, codec=codec):
                    # Closed stager / conflicting geometry: the gather
                    # can never fire here — fail LOUD and fast instead
                    # of draining the board as if it had.
                    trace.count("pod.collect_timeouts")
                    log.error("pod delivery degraded to host path",
                              reason="shard rejected by the gather "
                                     "driver", layerID=lid, rank=rank)
                    board.pod_done(key, n, who=self.node.my_id)
                    with self._lock:
                        self._pod_collecting.discard(lid)
                    return
        board.pod_done(key, n, who=self.node.my_id)

    def _on_pod_gathered(self, lid: int, out, codec: str) -> None:
        """Stager hook: this layer's on-mesh gather finished.  On
        success the FULL wire-form tree becomes the holding (exactly
        what a full host-path delivery at this codec would have
        stored — staging/boot/serving reuse every existing path) and
        the dest acks the full layer; on failure the shard holding
        stands and the leader's watchdog degrades the pair, loudly."""
        with self._lock:
            pod = lid in self._pod_widths
            self._pod_collecting.discard(lid)
        if not pod:
            return  # a plain sharded-delivery gather (harness-driven)
        if out is None:
            trace.count("pod.materialize_failed")
            log.error("pod gather failed; shard holding stands (leader "
                      "degrades the pair)", layerID=lid)
            return
        # The gather already verified the stamped full wire-form digest
        # (gather_byte_shards raises on mismatch).
        self._pod_store_full_tree(lid, out, codec, verified=True)

    def _pod_store_full_tree(self, lid: int, data, codec: str,
                             verified: bool, spmd: bool = False) -> None:
        """THE pod materialization chokepoint (docs/fabric.md): both
        reconstruction paths — the stager's board gather and the SPMD
        lockstep plan — funnel here so verify/store/stage/span/ack can
        never diverge.  ``verified``: the stamped full wire-form digest
        already checked upstream; otherwise it is checked now (directly
        — the per-lid memo and the range-digest lookup both describe
        the SHARD phase, not the gathered tree).  A mismatch keeps the
        shard holding (acked long ago); the leader's watchdog degrades
        the pair — corrupt bytes never ack."""
        if not verified:
            with self._lock:
                digest = self.layer_digests.get(lid, "")
            if digest:
                ok, dt, got = integrity.digest_check(
                    memoryview(data), digest)
                if ok is False:
                    trace.count("pod.materialize_failed")
                    log.error("pod-gathered tree failed the stamped "
                              "full wire digest; keeping the shard "
                              "holding", layerID=lid, expected=digest,
                              got=got)
                    return
                trace.add_phase("integrity_digest", dt)
        with self._lock:
            src = self.layers.get(lid)
            if src is not None and not src.meta.shard:
                return  # already full (host-path redelivery won)
            src = self.layers[lid] = LayerSrc(
                # A gather's read-back buffer is adopted, not copied.
                inmem_data=(data if isinstance(data, bytearray)
                            else bytearray(data)),
                data_size=len(data),
                meta=LayerMeta(location=LayerLocation.INMEM,
                               codec=codec))
            # Memoize the verdict so re-acks and stamp re-checks never
            # re-hash the full tree.
            if self.layer_digests.get(lid):
                self._digest_ok.add(lid)
        if codec:
            self._count_codec_delivery(lid, len(data), codec)
        loc = self._stage_to_hbm(lid, src)
        self._boot_stream_submit(lid, src)  # dedupes if pre-staged
        telemetry.span_event(
            telemetry.span_id(self.node.my_id, lid), "staged",
            node=self.node.my_id, dest=self.node.my_id, layer=lid,
            shard="", codec=codec)
        trace.count("pod.trees_materialized")
        log.info("pod delivery materialized full tree", layerID=lid,
                 bytes=len(data), codec=codec or None,
                 **({"spmd": True} if spmd else {}))
        self._send_ack(lid, loc)

    def close(self) -> None:
        self._closed_evt.set()
        self._metrics_stop.set()
        self.heartbeat.stop()
        self.loop.stop()
        if self._boot_stager is not None:
            self._boot_stager.close()
        if self._pod_stager_obj is not None:
            self._pod_stager_obj.close()
        with self._lock:
            window = self._plan_window
        if window is not None:
            # Let in-flight plans retire (their acks may still matter to
            # a live leader), then stop the retirement thread.
            window.drain(timeout=5.0)
            window.close()

    def _stage_to_hbm(self, layer_id, src, ingest=None) -> "LayerLocation":
        """Move a completed layer host→HBM when enabled; returns the
        location to ack with.  The device modules are imported lazily so
        host-only nodes never pay for them.  The HBM transition is check-and-marked under
        ``self._lock``: exactly one caller stages; a concurrent re-plan
        duplicate waits for that staging instead of double-allocating the
        layer on device.  ``ingest``: a completed incremental
        ``ShardedLayerIngest`` whose finalize replaces the bulk host→device
        transfer."""
        if not self.stage_hbm:
            return LayerLocation.INMEM
        with self._lock:
            if src.meta.location == LayerLocation.HBM:
                return LayerLocation.HBM  # a re-plan duplicate: already staged
            ev = self._hbm_staging.get(layer_id)
            if ev is not None:
                in_progress = ev
            else:
                in_progress = None
                ev = self._hbm_staging[layer_id] = threading.Event()
        if in_progress is not None:
            in_progress.wait()
            with self._lock:
                return src.meta.location
        try:
            t0 = _time.monotonic()
            self._stage_layer_device(layer_id, src, ingest)
            dt = _time.monotonic() - t0
            trace.count("hbm_staged.incremental_ingest" if ingest is not None
                        else "hbm_staged.bulk")
            log.info("layer staged to HBM", layerID=layer_id,
                     via="incremental ingest" if ingest is not None else "bulk",
                     stage_ms=round(dt * 1000, 1),
                     gbps=round(src.data_size / max(dt, 1e-9) / 1e9, 3))
            return LayerLocation.HBM
        except Exception as e:  # noqa: BLE001 — delivery beats staging
            trace.count("fallback.stage_host_ram")
            log.error("HBM staging failed; acking host RAM",
                      layerID=layer_id, err=repr(e))
            return LayerLocation.INMEM
        finally:
            ev.set()
            with self._lock:
                self._hbm_staging.pop(layer_id, None)

    def _stage_layer_device(self, layer_id, src, ingest=None) -> None:
        """The actual device landing (called once per layer, under the
        staging guard).  Priority: finalize an incremental ingest (the
        bytes are already on the device; finalize waits for the mover's
        side-stream copies, so any later reader sees every byte); else a
        one-shot ingest onto the stage's device; else the plain mover."""
        if ingest is not None:
            try:
                arr = ingest.finalize()
                with self._lock:
                    src.device_array = arr
                    src.meta.location = LayerLocation.HBM
                return
            except Exception as e:  # noqa: BLE001 — fall back to bulk path
                trace.count("fallback.ingest_finalize_bulk")
                log.error("ingest finalize failed; bulk staging instead",
                          layerID=layer_id, err=repr(e))
        if (self.placement is not None
                and layer_id in self.placement.layer_to_stage):
            from ..parallel.ingest import ingest_bytes

            data = (src.inmem_data if src.inmem_data is not None
                    else src.read_bytes())
            arr = ingest_bytes(data, self.placement.devices_for_layer(layer_id),
                               mover=self._mover)
            with self._lock:
                src.device_array = arr
                src.meta.location = LayerLocation.HBM
            return
        self._mover.stage(src)

    def handle_layer(self, msg: LayerMsg) -> None:
        """Store to RAM, ack the leader (node.go:1354-1384).  A re-plan
        duplicate keeps the existing (possibly already HBM-staged) entry —
        overwriting it would orphan the staged device array and leave the
        node acking HBM for a host-only copy.

        Integrity gate: a whole-layer frame verifies against the
        leader-stamped digest (the stamp names its own algorithm)
        BEFORE it is stored or acked — a
        mismatch (per-fragment CRC passed, so the SOURCE's bytes are
        bad) drops the frame and NACKs the sender for a retransmit."""
        with self._lock:
            src = self.layers.get(msg.layer_id)
        stored = False
        if src is None:
            fresh = msg.layer_src
            if 0 < fresh.data_size < msg.total_size:
                # A byte-range fragment (a shard-target send, or a
                # range retransmit) at a whole-layer receiver: this
                # class has no interval reassembly — storing it as the
                # layer would ack a buffer full of holes.  Flow-capable
                # receivers (mode 3's class) override this handler.
                log.error("byte-range fragment at a whole-layer "
                          "receiver; dropped (sharded targets need a "
                          "flow-capable receiver)", layerID=msg.layer_id,
                          offset=fresh.offset, size=fresh.data_size,
                          total=msg.total_size)
                return
            # Wire-codec identity (docs/codec.md): the leader's stamp is
            # authoritative; the frame's advisory tag is the fallback
            # when no stamp arrived (digests disabled) — encoded bytes
            # must never be stored as a raw holding.
            with self._lock:
                codec = self._layer_codecs.get(msg.layer_id, "")
            codec = codec or msg.codec
            # Digest-gate whole-layer frames only, and only when a
            # digest is stamped — no byte copy on the unstamped path.
            # For a codec transfer the stamped digest is the digest of
            # the ENCODED bytes — exactly what arrived.
            if (self._expected_digest(msg.layer_id) is not None
                    and fresh.data_size == msg.total_size):
                data = (memoryview(fresh.inmem_data)
                        if fresh.inmem_data is not None
                        else memoryview(fresh.read_bytes()))
                if not self._verify_layer_digest(msg.layer_id, data,
                                                 codec=codec):
                    # Budgeted like every digest recovery: a corrupt
                    # SOURCE re-serving the same bad bytes must go
                    # loud-and-quiet, not NACK-ping-pong forever.
                    if self._bump_digest_retry(msg.layer_id):
                        self._send_nack(msg.src_id, msg.layer_id, 0,
                                        msg.total_size, msg.total_size,
                                        "digest")
                    return
            delta_wire = 0
            if delta_base_digest(codec):
                # Content-delta frame (docs/codec.md): the verified
                # stream reconstructs to canonical bytes BEFORE the
                # store — the delta form itself must never be held,
                # staged, or acked.
                data = (memoryview(fresh.inmem_data)
                        if fresh.inmem_data is not None
                        else memoryview(fresh.read_bytes()))
                raw = self._delta_reconstruct_bytes(msg.layer_id, data,
                                                    codec)
                if raw is None:
                    if self._bump_digest_retry(msg.layer_id):
                        self._send_nack(msg.src_id, msg.layer_id, 0,
                                        msg.total_size, msg.total_size,
                                        "digest")
                    return
                delta_wire = fresh.data_size
                self._count_codec_delivery(msg.layer_id, delta_wire,
                                           codec)
                fresh = LayerSrc(
                    inmem_data=bytearray(raw), data_size=len(raw),
                    meta=LayerMeta(location=LayerLocation.INMEM))
                fresh.offset = 0
                codec = ""
            with self._lock:
                src = self.layers.get(msg.layer_id)
                if src is None:
                    src = fresh
                    src.meta = LayerMeta(location=LayerLocation.INMEM,
                                         codec=codec)
                    src.offset = 0
                    self.layers[msg.layer_id] = src
                    stored = True
            if stored:
                # Flight recorder: bytes COMMITTED to the store (a
                # re-plan duplicate records nothing), so per-link
                # delivered totals reconcile byte-exactly against the
                # goal state in the run report.
                telemetry.link_add(msg.src_id, self.node.my_id,
                                   job=msg.job_id,
                                   delivered_bytes=(delta_wire
                                                    or src.data_size))
                if delta_wire:
                    self._note_delta_reconstructed(
                        msg.layer_id, delta_wire, src.data_size)
                if codec:
                    self._count_codec_delivery(msg.layer_id,
                                               src.data_size, codec)
                # Pair-lifecycle span (docs/observability.md): a
                # whole-layer frame is first byte AND wire completion
                # in one event pair (and the digest gate above already
                # passed — the verify cost sits inside the frame walk).
                span = msg.span_id or telemetry.span_id(
                    self.node.my_id, msg.layer_id)
                telemetry.span_event(span, "first_byte",
                                     node=self.node.my_id,
                                     src=msg.src_id, dest=self.node.my_id,
                                     layer=msg.layer_id, job=msg.job_id,
                                     parent=msg.span_parent)
                telemetry.span_event(span, "wire_complete",
                                     node=self.node.my_id,
                                     src=msg.src_id, dest=self.node.my_id,
                                     layer=msg.layer_id, job=msg.job_id,
                                     bytes=src.data_size,
                                     parent=msg.span_parent)
        log.debug("saved layer in memory", layerID=msg.layer_id)
        loc = self._stage_to_hbm(msg.layer_id, src)
        # Streamed boot staging: this layer's decode + device placement
        # starts NOW, overlapping the remaining layers' transfers.
        self._boot_stream_submit(msg.layer_id, src)
        if stored:
            telemetry.span_event(
                telemetry.span_id(self.node.my_id, msg.layer_id),
                "staged", node=self.node.my_id, dest=self.node.my_id,
                layer=msg.layer_id)
        self._send_ack(msg.layer_id, loc)
        # The committed layer may be the donor a stamped-but-missing
        # layer was waiting for (stamp-before-donor race).
        self._resolve_pending_for_layer(msg.layer_id)

    # --------------------------------------------------- device-fabric plane

    def handle_device_plan(self, msg: DevicePlanMsg) -> None:
        """Serve one pod-fabric transfer command (``parallel/fabric.py``):
        contribute my planned byte ranges (seeder half, inline on the
        handler pool), then — when the plan is addressed to me — ingest
        every contribution over the device fabric on a dedicated thread.
        Dedicated because the ingest *waits* on other nodes' contributions:
        parked pool workers across many concurrent plans could otherwise
        starve the very contribution handlers they wait for."""
        if self._fence_stale(msg):
            return
        if self.fabric is None or self.placement is None:
            log.error("device plan but no fabric wired", plan=msg.plan_id)
            return
        if self._spmd:
            self._handle_spmd_plan(msg)
            return
        # Opportunistic GC: plans whose dest died before collecting would
        # otherwise pin full-layer device buffers forever.
        self.fabric.gc()
        contribute_device_plan(self.node, self.layers, self._lock,
                               self.fabric, self.placement, msg)
        if msg.dest_id == self.node.my_id:
            if self._batch_enqueue(msg):
                return  # a batch thread finishes the whole group
            threading.Thread(
                target=self._receive_device_plan, args=(msg,), daemon=True,
                name="torch-fabric-recv",
            ).start()

    def _report_plan_gap(self, missing) -> None:
        """SpmdFabric ``on_gap`` hook: ask the leader to re-send the
        plans this process never received (executor thread; one call per
        gap_timeout window)."""
        log.warn("requesting re-send of missing spmd plans",
                 seqs=list(missing))
        try:
            self.node.transport.send(
                self.node.leader_id,
                PlanResendReqMsg(self.node.my_id, list(missing)),
            )
        except (OSError, KeyError) as e:
            log.error("plan re-send request failed", err=repr(e))

    def _handle_spmd_plan(self, msg: DevicePlanMsg) -> None:
        """Multi-controller fabric (``parallel/spmd_fabric.py``): enqueue
        the plan on this process's lockstep executor; when it is addressed
        to me, await the collective's result on a dedicated thread (the
        handler pool must stay free to enqueue later plans — the executor
        can only reach mine after running everything before it).

        (Lost-plan fault injection for the gap-recovery tests lives in
        ``transport/faults.FaultyTransport``: the CLI's
        ``-test-drop-plan-seqs`` wraps the transport; this handler only
        ever sees plans that "arrived".)"""
        mine = (msg.dest_id == self.node.my_id
                or self.node.my_id in (msg.pod or ()))
        try:
            res = self.fabric.submit(msg)
        except Exception as e:  # noqa: BLE001 — closed/duplicate races
            log.error("spmd fabric submit failed", plan=msg.plan_id,
                      err=repr(e))
            if mine and msg.layout:
                self._request_replan()
            return
        if not mine or not msg.layout:
            return
        threading.Thread(
            target=self._await_spmd_plan, args=(msg, res), daemon=True,
            name="torch-spmd-await",
        ).start()

    def _await_spmd_plan(self, msg: DevicePlanMsg, res) -> None:
        from ..parallel.spmd_fabric import PlanFailed

        try:
            # Progress-aware: a deep plan queue (large startup) extends
            # the wait as long as the executor keeps retiring seqs.
            arr = self.fabric.wait_result(res)
        except PlanFailed as e:
            log.error("spmd fabric plan failed for dest; requesting "
                      "re-plan", plan=msg.plan_id, layerID=msg.layer_id,
                      err=repr(e))
            self._request_replan()
            return
        if arr is None:
            log.error("spmd fabric plan yielded no layer; requesting "
                      "re-plan", plan=msg.plan_id, layerID=msg.layer_id)
            self._request_replan()
            return
        if msg.pod:
            self._spmd_pod_store(msg, arr)
            return
        self._fabric_store(msg.layer_id, msg.total_size, device_arr=arr)
        # A duplicate plan for an already-held layer no-ops in the store:
        # ack whatever location the layer ACTUALLY has (a host-path copy
        # stays INMEM; claiming HBM would corrupt the leader's status).
        with self._lock:
            loc = self.layers[msg.layer_id].meta.location
        log.info("layer landed over device fabric", layerID=msg.layer_id,
                 plan=msg.plan_id, total_bytes=msg.total_size, spmd=True)
        self._send_ack(msg.layer_id, loc)

    def _spmd_pod_store(self, msg: DevicePlanMsg, arr) -> None:
        """A pod reconstruction plan's gathered tree landed on this
        member: read the wire-form bytes back and run the shared
        verify/store/stage/ack chokepoint (``_pod_store_full_tree``)."""
        import torch

        lid = msg.layer_id
        try:
            data = bytearray(msg.total_size)
            torch.frombuffer(data, dtype=torch.uint8).copy_(
                arr[:msg.total_size])
        except Exception as e:  # noqa: BLE001 — loud, never wedge
            log.error("pod gather readback failed", layerID=lid,
                      err=repr(e))
            return
        with self._lock:
            codec = self._layer_codecs.get(lid, "")
        self._pod_store_full_tree(lid, data, codec, verified=False,
                                  spmd=True)

    def _local_coverage(self, layer_id):
        """Byte ranges of an in-progress layer this node already holds
        (checkpoint-restored partials, mode 3): a resumed fabric plan ships
        only the gaps, so the ingest is seeded with these first.  The base
        receiver holds none."""
        return []

    def _fabric_store(self, layer_id, total: int, device_arr=None,
                      host_buf=None) -> None:
        """Record a fabric-delivered layer — HBM-resident when the ingest
        succeeded (the terminal state the Assignment prescribes; readers
        needing bytes pull them from the device array), else the
        host-assembled fallback buffer (delivery beats staging)."""
        with self._lock:
            if layer_id not in self.layers:
                self.layers[layer_id] = LayerSrc(
                    inmem_data=host_buf,
                    data_size=total,
                    meta=LayerMeta(location=LayerLocation.HBM
                                   if device_arr is not None
                                   else LayerLocation.INMEM),
                    device_array=device_arr,
                )
            src = self.layers[layer_id]
        # Fabric deliveries stream into the boot too: the landed layer's
        # decode overlaps the remaining plans.
        self._boot_stream_submit(layer_id, src)

    def _receive_device_plan(self, msg: DevicePlanMsg) -> None:
        """The dest half: pull every contribution into my stage's shard
        buffers as it arrives (device→device — ICI on real hardware),
        gather, store, ack.

        Liveness: a device-side failure (allocation, write, finalize) must
        not hang the run — the dest is alive and heartbeating, so the
        leader would never re-plan for it on its own.  On ingest failure
        the layer is assembled on host — already-written bytes salvaged
        from the shard buffers, later fragments kept as host copies — and
        acked INMEM, the same delivery-beats-staging fallback the host
        receive path has.  When even that can't complete (collect timeout
        from a dead seeder, or a device fault so deep the salvage read
        fails too), the dest RE-ANNOUNCES: the leader's re-announce path
        re-plans its missing layers, so the transfer is retried instead
        of stranded."""
        res = self._collect_plan(msg)
        if res is None:
            return
        kind, payload = res
        if kind == "ingest":
            self._finalize_one(msg, *payload)
        else:
            self._fabric_host_assemble(msg, *payload)

    def _fabric_window(self):
        """The dest's shared in-flight window: finalize collectives from
        successive plans stay dispatched together (upload and collective
        phases overlap across plans) instead of round-tripping per plan;
        acks fire at retirement, once the device work really finished."""
        with self._lock:
            if self._plan_window is None:
                from ..parallel.fabric import PlanWindow

                self._plan_window = PlanWindow()
            return self._plan_window

    def _batch_enqueue(self, msg: DevicePlanMsg) -> bool:
        """Admit a batch-stamped plan into its accumulation group; when
        the group is complete (or ``FABRIC_BATCH_WAIT`` expires with
        members missing — a participant's dispatch failed), one thread
        finishes the WHOLE group as a single batched gather.  Returns
        False for unbatched plans (the solo path handles them)."""
        if self._spmd or msg.batch_n <= 1 or not msg.batch_id:
            return False
        timer = None
        msgs = None
        with self._lock:
            rec = self._plan_batches.get(msg.batch_id)
            if rec is not None and rec["fired"]:
                # Late member of an already-processed batch: straight to
                # the solo path, NOT another batch wait.  Fired records
                # stay as tombstones precisely for this check.
                return False
            if rec is None:
                rec = self._plan_batches[msg.batch_id] = {
                    "msgs": [], "fired": False, "timer": None}
                timer = threading.Timer(
                    self.FABRIC_BATCH_WAIT, self._flush_batch,
                    args=(msg.batch_id,))
                timer.daemon = True
                rec["timer"] = timer
            rec["msgs"].append(msg)
            if len(rec["msgs"]) >= msg.batch_n:
                rec["fired"] = True
                msgs = rec["msgs"]
                rec["msgs"] = []  # tombstone keeps no message refs
                if rec["timer"] is not None:
                    rec["timer"].cancel()
                    rec["timer"] = None
                self._prune_batches_locked()
        if msgs is not None:
            threading.Thread(
                target=self._receive_device_batch, args=(msgs,), daemon=True,
                name="torch-fabric-batch",
            ).start()
        elif timer is not None:
            timer.start()
        return True

    def _prune_batches_locked(self) -> None:
        """Bound the tombstone map (fired batch records are kept so late
        members skip the batch wait); oldest fired records drop first.
        Caller holds ``self._lock``."""
        fired = [b for b, r in self._plan_batches.items() if r["fired"]]
        for b in fired[:max(0, len(fired) - 256)]:
            del self._plan_batches[b]

    def _flush_batch(self, batch_id: str) -> None:
        """Batch-wait expiry: some member plans never arrived (their
        dispatch failed and went host-path) — process what did, so the
        present plans aren't stranded behind the absent ones."""
        with self._lock:
            rec = self._plan_batches.get(batch_id)
            if rec is None or rec["fired"]:
                return
            rec["fired"] = True
            msgs = rec["msgs"]
            rec["msgs"] = []
            rec["timer"] = None
            self._prune_batches_locked()
        log.warn("fabric plan batch incomplete; processing present plans",
                 batch=batch_id, got=len(msgs))
        threading.Thread(
            target=self._receive_device_batch, args=(msgs,), daemon=True,
            name="torch-fabric-batch",
        ).start()

    def _receive_device_batch(self, msgs) -> None:
        """Finish a batch of same-size plans with ONE batched gather
        (``parallel.ingest.finalize_many``): collect each plan's
        contributions into its own ingest, then a single collective
        replicates every layer — per-plan dispatch latency amortizes
        over the batch.  Any plan that can't ride the batch (duplicate,
        dead ingest, tiling mismatch) takes its usual solo path."""
        # Collect members CONCURRENTLY (matching the solo path's
        # per-plan threads): one member whose contributions never come
        # must cost the batch one FABRIC_COLLECT_TIMEOUT, not one per
        # member — the healthy members' collects complete in parallel.
        ordered = sorted(msgs, key=lambda m: m.layer_id)
        results: Dict[int, object] = {}

        def collect_one(i, m):
            results[i] = self._collect_plan(m)

        threads = [threading.Thread(target=collect_one, args=(i, m),
                                    daemon=True,
                                    name=f"torch-fabric-collect-{i}")
                   for i, m in enumerate(ordered)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ready = []  # (msg, ingest, host_frags, local, upload_s)
        for i, msg in enumerate(ordered):
            res = results.get(i)
            if res is None:
                continue
            kind, payload = res
            if kind == "ingest":
                ready.append((msg,) + payload)
            else:
                self._fabric_host_assemble(msg, *payload)
        if not ready:
            return
        arrs = None
        if len(ready) > 1:
            from ..parallel.ingest import finalize_many

            try:
                arrs = finalize_many([ing for _, ing, _, _, _ in ready])
            except Exception as e:  # noqa: BLE001 — solo finalize still works
                log.warn("batched finalize unavailable; per-plan gathers",
                         batch=msgs[0].batch_id, err=repr(e))
        if arrs is not None:
            for (msg, ing, host_frags, local, up_s), arr in zip(ready, arrs):
                self._submit_fabric_result(msg, ing, host_frags, local,
                                           arr, up_s, batched=len(ready))
        else:
            for msg, ing, host_frags, local, up_s in ready:
                self._finalize_one(msg, ing, host_frags, local, up_s)

    def _collect_plan(self, msg: DevicePlanMsg):
        """Collect one plan's contributions into a fresh ingest.

        Returns ``None`` when the plan is fully handled here (a re-plan
        duplicate drained + re-acked, or a collect failure that already
        requested a re-plan); ``("ingest", (ingest, host_frags, local,
        upload_s))`` when the ingest holds every contribution; or
        ``("host", (local, ingest, host_frags))`` when device staging
        died and the caller must assemble on host."""
        with self._lock:
            existing = self.layers.get(msg.layer_id)
        if existing is not None:
            # A re-plan duplicate of a delivered layer: drain the plan's
            # contributions (seeders may publish AFTER this discard would
            # run — an immediate discard leaves their device buffers
            # pinned in the registry) and re-ack (the leader missed our
            # ack).  The drain is bounded and off the handler pool.
            try:
                for _ in self.fabric.collect(
                    msg.plan_id, len(msg.layout),
                    timeout=min(30.0, self.FABRIC_COLLECT_TIMEOUT),
                ):
                    pass
            except TimeoutError:
                pass
            finally:
                self.fabric.discard(msg.plan_id)
            self._send_ack(msg.layer_id, existing.meta.location)
            return None

        local = self._local_coverage(msg.layer_id)
        ingest = None
        try:
            from ..parallel.ingest import ShardedLayerIngest

            devices = self.placement.devices_for_node(self.node.my_id)
            ingest = ShardedLayerIngest(msg.total_size, devices)
            for off, data in local:
                ingest.write(off, data)
        except Exception as e:  # noqa: BLE001 — fall through to host path
            log.error("fabric ingest unavailable; will assemble on host",
                      layerID=msg.layer_id, err=repr(e))
            ingest = None
        # Fragments are NOT retained while the ingest is healthy (a
        # full-layer extra pin of seeder HBM); the fallback recovers
        # already-written bytes from the dest's own shard buffers
        # (ingest.salvage) and keeps HOST copies only of fragments that
        # arrive after a failure.
        ingest_alive = ingest is not None
        host_frags: list = []
        upload_s = 0.0
        try:
            try:
                for off, arr in self.fabric.collect(
                    msg.plan_id, len(msg.layout),
                    timeout=self.FABRIC_COLLECT_TIMEOUT,
                ):
                    if ingest_alive:
                        try:
                            t_up = _time.monotonic()
                            ingest.write(off, arr)
                            upload_s += _time.monotonic() - t_up
                            continue
                        except Exception as e:  # noqa: BLE001
                            log.error("fabric ingest write failed; will "
                                      "assemble on host",
                                      layerID=msg.layer_id, err=repr(e))
                            ingest_alive = False
                    host_frags.append((off, arr.cpu().numpy().tobytes()))
            finally:
                self.fabric.discard(msg.plan_id)
        except Exception as e:  # noqa: BLE001 — bytes missing: can't deliver
            trace.count("fallback.fabric_replan")
            log.error("fabric collect failed; requesting re-plan",
                      layerID=msg.layer_id, plan=msg.plan_id, err=repr(e))
            self._request_replan()
            return None
        if upload_s:
            from ..utils import trace as _trace

            _trace.add_phase("upload", upload_s)
        if ingest_alive:
            return "ingest", (ingest, host_frags, local, upload_s)
        return "host", (local, ingest, host_frags)

    def _finalize_one(self, msg: DevicePlanMsg, ingest, host_frags, local,
                      upload_s: float = 0.0) -> None:
        """Dispatch one plan's finalize gather and hand it to the shared
        in-flight window (the ack fires at retirement)."""
        try:
            device_arr = ingest.finalize()
        except Exception as e:  # noqa: BLE001
            log.error("fabric finalize failed; assembling on host",
                      layerID=msg.layer_id, err=repr(e))
            self._fabric_host_assemble(msg, local, ingest, host_frags)
            return
        self._submit_fabric_result(msg, ingest, host_frags, local,
                                   device_arr, upload_s, batched=1)

    def _submit_fabric_result(self, msg, ingest, host_frags, local,
                              device_arr, upload_s: float,
                              batched: int) -> None:
        """Queue a dispatched finalize on the in-flight window: the next
        plan's staging overlaps this collective; store + phase log + ack
        happen at retirement (bytes proven on device), and a device-side
        failure falls back to the host assembly path."""

        def on_ready(arr, collective_s):
            self._fabric_store(msg.layer_id, msg.total_size, device_arr=arr)
            log.info("layer landed over device fabric", layerID=msg.layer_id,
                     plan=msg.plan_id, total_bytes=msg.total_size,
                     upload_ms=round(upload_s * 1000, 1),
                     collective_ms=round(collective_s * 1000, 1),
                     batched=batched)
            self._send_ack(msg.layer_id, LayerLocation.HBM)

        def on_error(e):
            log.error("fabric collective failed; assembling on host",
                      layerID=msg.layer_id, plan=msg.plan_id, err=repr(e))
            self._fabric_host_assemble(msg, local, ingest, host_frags)

        try:
            self._fabric_window().submit(
                msg.plan_id, device_arr, msg.total_size, on_ready, on_error)
        except Exception as e:  # noqa: BLE001 — window closed: sync path
            log.error("plan window rejected submit; blocking inline",
                      plan=msg.plan_id, err=repr(e))
            try:
                from ..utils.device import synchronize

                synchronize(device_arr.device)
            except Exception as e2:  # noqa: BLE001
                on_error(e2)
                return
            on_ready(device_arr, 0.0)

    def _fabric_host_assemble(self, msg: DevicePlanMsg, local, ingest,
                              host_frags) -> None:
        """Delivery-beats-staging fallback: assemble the layer on host
        from checkpointed local bytes + salvaged shard buffers + host
        fragment copies, ack INMEM — or re-announce when even that can't
        complete."""
        trace.count("fallback.fabric_host_assembly")
        buf = bytearray(msg.total_size)
        covered: list = []

        def place(off, data):
            nonlocal covered
            buf[off : off + len(data)] = data
            covered = intervals.insert(covered, off, off + len(data))

        for off, data in local:
            place(off, data)
        if ingest is not None:
            try:
                for off, data in ingest.salvage():
                    place(off, data)
            except Exception as e:  # noqa: BLE001
                log.error("shard-buffer salvage failed",
                          layerID=msg.layer_id, err=repr(e))
        for off, data in host_frags:
            place(off, data)
        if intervals.covered(covered) < msg.total_size:
            log.error("host fallback incomplete; requesting re-plan",
                      layerID=msg.layer_id, plan=msg.plan_id,
                      have=intervals.covered(covered),
                      total=msg.total_size)
            self._request_replan()
            return
        if not self._verify_layer_digest(msg.layer_id, memoryview(buf)):
            # Salvaged/host-copied bytes failed the end-to-end digest:
            # never store or ack them — re-plan re-fetches the layer.
            log.error("host-assembled fabric layer failed digest; "
                      "requesting re-plan", layerID=msg.layer_id,
                      plan=msg.plan_id)
            self._request_replan()
            return
        self._fabric_store(msg.layer_id, msg.total_size, host_buf=buf)
        log.warn("layer assembled on host after fabric failure",
                 layerID=msg.layer_id, plan=msg.plan_id)
        self._send_ack(msg.layer_id, LayerLocation.INMEM)

    def _request_replan(self) -> None:
        """A delivery this node could not complete (failed fabric plan)
        would otherwise be stranded forever — the node is alive and
        heartbeating, so the failure detector never fires for it.
        Re-announcing is the recovery channel: the leader treats a known
        node's announce as authoritative inventory and re-plans every
        still-missing layer (leader.handle_announce)."""
        try:
            self.announce()
        except (OSError, KeyError) as e:
            log.error("re-announce for re-plan failed", err=repr(e))

    def _count_codec_delivery(self, layer_id, wire_bytes: int,
                              codec: str) -> None:
        """Account one quantized delivery's wire-vs-decoded bytes
        (docs/codec.md): the telemetry link table reconciles against
        ENCODED wire bytes, and these counters carry the decoded side
        so the run report shows both columns without conflating them."""
        trace.count("codec.wire_deliveries")
        trace.count("codec.wire_bytes", wire_bytes)
        if self.codec_plane is not None:
            dec = self.codec_plane.decoded_nbytes(layer_id)
            if dec:
                trace.count("codec.decoded_bytes", dec)

    def _send_ack(self, layer_id, loc, shard: str = "") -> None:
        """THE ack chokepoint: every completion path (whole-layer
        frames, flow reassembly, fabric delivery, content resolve,
        re-acks) funnels here so the version tag (docs/swap.md) is
        stamped exactly once — onto the stored holding (announce after
        a restart keeps it) and onto the wire ack (the leader's swap
        fence counts versioned acks) — and the live-swap controller
        sees every completed layer.  The wire ack also carries the
        holding's CODEC form (docs/codec.md): the leader records it,
        so a quantized copy can never satisfy — or be planned as a
        source for — a raw pair."""
        version = self._layer_versions.get(layer_id, "")
        with self._lock:
            src = self.layers.get(layer_id)
            if version and src is not None:
                src.meta.version = version
            codec = src.meta.codec if src is not None else ""
        self._send_to_leader(AckMsg(self.node.my_id, layer_id, loc,
                                    shard=shard, version=version,
                                    codec=codec,
                                    span_id=telemetry.span_id(
                                        self.node.my_id, layer_id)))
        if self.swap is not None and version:
            self.swap.on_layer(layer_id)
        hook = self.on_layer_complete
        if hook is not None:
            # Sub-leader fan-out trigger (docs/hierarchy.md): advisory —
            # a hook failure must never break the ack path.
            try:
                hook(layer_id)
            except Exception as e:  # noqa: BLE001
                log.error("layer-complete hook failed", layerID=layer_id,
                          err=repr(e))

    def handle_generate_req(self, msg: GenerateReqMsg) -> None:
        """Serve an inference request from this node's RESIDENT booted
        params — the startup hook's engine, reachable over the same
        transport that delivered its weights.  Full boots only (a stage
        boot alone can't produce logits; pod serving is the ServeMsg
        lockstep path).  Every outcome ANSWERS — the requester's timeout
        is for lost messages, not policy.  ALWAYS decodes on its own
        daemon thread: the handler pool has one slot, and a decode (or
        a boot wait) parked there would serialize every other control
        message — re-sent Startup re-answers, ServeMsg, concurrent
        generate requests — for the full decode duration.  Concurrent
        decodes are bounded (SERVE_MAX_CONCURRENT): each holds a KV
        cache, so an unauthenticated flood must hit an immediate
        "busy" refusal, not an unbounded thread/HBM pile-up."""
        with self._lock:
            if self._serve_active >= self.SERVE_MAX_CONCURRENT:
                busy = True
            else:
                busy = False
                self._serve_active += 1
        if busy:
            try:
                self.node.transport.send(
                    msg.src_id,
                    GenerateRespMsg(self.node.my_id, msg.req_id, [],
                                    f"busy: {self.SERVE_MAX_CONCURRENT} "
                                    "decodes already in flight"),
                )
            except (OSError, KeyError, ConnectionError) as e:
                log.error("busy refusal send failed",
                          requester=msg.src_id, req=msg.req_id, err=repr(e))
            return

        def _run():
            try:
                self._serve_generate_req(msg)
            finally:
                with self._lock:
                    self._serve_active -= 1

        threading.Thread(
            target=_run, daemon=True,
            name=f"genreq-{self.node.my_id}-{msg.req_id}",
        ).start()

    def _serve_generate_req(self, msg: GenerateReqMsg) -> None:
        t0 = _time.monotonic()
        me = self.node.my_id

        def reply(tokens=None, error=""):
            # Telemetry (docs/rollout.md): per-REPLICA request latency
            # and failure counters — the metric names carry the node id
            # because co-resident nodes share one registry, and the SLO
            # guard needs per-replica p99, not a process blur.  The
            # reply send is INSIDE the timed window on purpose: a
            # replica whose answers crawl out a congested NIC is slow
            # as far as its users (and its SLO) are concerned.
            try:
                self.node.transport.send(
                    msg.src_id,
                    GenerateRespMsg(self.node.my_id, msg.req_id,
                                    tokens or [], error),
                )
            except (OSError, KeyError, ConnectionError) as e:
                log.error("generate response send failed",
                          requester=msg.src_id, req=msg.req_id, err=repr(e))
            telemetry.observe_ms(f"serve.latency_ms.n{me}",
                                 (_time.monotonic() - t0) * 1000.0)
            telemetry.count(f"serve.requests.n{me}")
            if error:
                telemetry.count(f"serve.failures.n{me}")

        if self.boot_cfg is None:
            reply(error="no booted model at this node (no boot config)")
            return
        # Requests can race the boot; wait for it, bounded (a physical-
        # size boot compiles + first-forwards in seconds — minutes only
        # when the precompile overlap was lost).
        if not self._boot_finished.wait(timeout=300.0):
            reply(error="no booted model at this node "
                        "(boot still in flight)")
            return
        res = self.boot_result
        if res is None or res.kind != "full" or res.params is None:
            reply(error="no booted model at this node "
                        f"(kind={getattr(res, 'kind', None)})")
            return
        cfg = self.boot_cfg
        if msg.max_new <= 0:
            reply(error=f"max_new must be positive, got {msg.max_new}")
            return
        if msg.max_new > self.SERVE_MAX_NEW:
            reply(error=f"max_new {msg.max_new} exceeds this node's serve "
                        f"limit {self.SERVE_MAX_NEW}")
            return
        if not msg.prompt:
            reply(error="empty prompt")
            return
        if len(msg.prompt) > self.SERVE_MAX_PROMPT:
            reply(error=f"prompt length {len(msg.prompt)} exceeds this "
                        f"node's serve limit {self.SERVE_MAX_PROMPT}")
            return
        bad = [t for t in msg.prompt if t < 0 or t >= cfg.vocab]
        if bad:
            reply(error=f"prompt tokens outside vocab [0, {cfg.vocab}): "
                        f"{bad[:8]}")
            return
        import math

        # NOT `< 0`: NaN compares False both ways and would reach the
        # sampler keyless (garbage tokens as a "success"), and NaN/inf
        # also defeat the decode-program cache (NaN != NaN) — re-jitting
        # per request.
        if not (math.isfinite(msg.temperature) and msg.temperature >= 0):
            reply(error="temperature must be finite and >= 0, "
                        f"got {msg.temperature}")
            return
        try:
            import torch

            from ..models.generate import (
                ensure_uniform_version,
                generate,
                generate_stepwise,
            )

            temp = float(msg.temperature)
            dev = res.params["embed"].device
            prompt_arr = torch.tensor([list(msg.prompt)], dtype=torch.long,
                                      device=dev)
            # Sampling draws from a torch.Generator seeded with the
            # request's seed (the JAX receiver uses jax.random.key(seed):
            # sampled ids differ between the packages; greedy ids agree).
            prng = None
            if temp > 0:
                prng = torch.Generator(device=dev)
                prng.manual_seed(int(msg.seed))
            if os.environ.get("DLD_TOKEN_FLIP", "0") == "1":
                # Per-TOKEN flip granularity (docs/rollout.md): re-read
                # the serving tree before every decode step, so an
                # in-flight generation picks a freshly committed
                # version up at the NEXT token instead of finishing a
                # long request on the old one.  Guarded per step: the
                # tree's blob-version map must be uniform, or the step
                # refuses (a mixed tree can't happen through the
                # atomic flip — this is the invariant made executable).
                def params_fn():
                    with self._lock:
                        cur = self.boot_result
                        version = self.serving_version
                        tree = dict(self._serving_tree_versions)
                    ensure_uniform_version(tree, version)
                    return cur.params, version

                toks = generate_stepwise(
                    params_fn, prompt_arr, cfg, int(msg.max_new),
                    temperature=temp, generator=prng)
            else:
                toks = generate(
                    res.params, prompt_arr, cfg, int(msg.max_new),
                    temperature=temp, generator=prng)
            out = [int(t) for t in toks[0].tolist()]
        except Exception as e:  # noqa: BLE001 — must answer, not vanish
            log.error("generation request failed", requester=msg.src_id,
                      req=msg.req_id, err=repr(e))
            reply(error=f"decode failed: {e!r}")
            return
        dt = _time.monotonic() - t0
        log.info("served generation request", requester=msg.src_id,
                 req=msg.req_id, prompt_tokens=len(msg.prompt),
                 new_tokens=len(out), decode_ms=round(dt * 1000, 1),
                 tokens_per_s=round(len(out) / max(dt, 1e-9), 1))
        reply(tokens=out)

    # ---------------------------------------------- zero-downtime swap

    def handle_swap_commit(self, msg: SwapCommitMsg) -> None:
        """The live-swap control channel (docs/swap.md): prepare
        notices, the epoch-fenced commit flip, and aborts — all routed
        to the SwapController.  Confirm/query/error roles are
        leader-bound; one that reaches a receiver (misroute) is
        ignored.  A node with no serving engine answers with an error
        so the leader aborts instead of re-sending the fence forever."""
        if self._fence_stale(msg):
            return
        if msg.applied or msg.query or msg.error:
            # Leader-bound roles.  On a shared loop (this worker was
            # PROMOTED to leader) the receiver owns the handler — hand
            # the message to the promoted leader's swap driver so
            # confirms/queries keep flowing across a takeover.
            fwd = self.on_swap_leader_msg
            if fwd is not None:
                fwd(msg)
            return
        if self.swap is None:
            log.error("swap commit at a node with no serving engine",
                      version=msg.version)
            try:
                self._send_to_leader(SwapCommitMsg(
                    self.node.my_id, msg.version,
                    error="no serving engine at this node"))
            except Exception as e:  # noqa: BLE001 — advisory
                log.error("swap refusal send failed", err=repr(e))
            return
        if msg.prepare:
            self.swap.on_prepare(msg.version, msg.swap_base)
            return
        self.swap.on_commit(msg)

    def _apply_swap_result(self, version: str, params) -> None:
        """The atomic flip: replace the serving params pointer under the
        receiver lock.  In-flight decodes finish on the v1 tree they
        captured (the old params object is immutable and refcounted);
        every request admitted after this line decodes on v2 — no
        request is ever dropped, and no forward spans both versions."""
        from .boot import BootResult

        from ..models import serde

        cfg = self.boot_cfg
        res = BootResult(kind="full", seconds=0.0,
                         layer_ids=list(range(cfg.n_layers)),
                         params=params)
        with self._lock:
            self.boot_result = res
            self.serving_version = version
            # Every blob of the flipped-in tree carries THIS version:
            # the per-step guard of the token-granularity flip asserts
            # this map stays uniform (docs/rollout.md).
            self._serving_tree_versions = {
                slot: version
                for slot in range(serde.head_blob_id(cfg) + 1)}
            self._boot_started = True
            self._boot_report = (0.0, "full")
        # A swap can land on a node that never booted v1 (it joined the
        # fleet mid-rollout): the flip IS its boot — serve waiters
        # proceed.
        self._boot_finished.set()
        self._boot_drained.set()

    def handle_boot_hint(self, msg: BootHintMsg) -> None:
        """Overlap the boot's XLA compiles with the dissemination: the
        leader says what this node will hold, and shapes are all the
        compiler needs — so by the time the bytes land and startup asks
        for the boot, its jit calls hit warm caches.  Runs on its OWN
        daemon thread: a compile takes seconds and must not occupy a
        handler-pool slot that fragment delivery needs."""
        if self._fence_stale(msg):
            return
        if self.boot_cfg is None or not msg.blob_ids:
            return
        hinted = frozenset(int(b) for b in msg.blob_ids)
        with self._lock:
            if hinted in self._precompiled_sets:
                return
            # The window re-admits evicted sets, so the eviction alone
            # no longer bounds CONCURRENT warmups — an attacker cycling
            # distinct sets faster than compiles finish would otherwise
            # spawn a compile thread per hint.  Saturated = boot cold.
            if self._precompile_inflight >= _PRECOMPILE_MAX_SETS:
                log.warn("precompile warmups saturated; hinted set "
                         "boots cold", inflight=self._precompile_inflight)
                return
            while len(self._precompiled_sets) >= _PRECOMPILE_MAX_SETS:
                evicted = next(iter(self._precompiled_sets))
                del self._precompiled_sets[evicted]
                log.info("precompile window full; evicting oldest hinted "
                         "set (its jit caches stay warm until XLA drops "
                         "them)", evicted=sorted(evicted))
            self._precompiled_sets[hinted] = True
            self._precompile_inflight += 1
            self._precompile_done.clear()
        threading.Thread(
            target=self._precompile_boot, args=(sorted(hinted),),
            daemon=True, name=f"boot-precompile-{self.node.my_id}",
        ).start()

    def _precompile_boot(self, blob_ids) -> None:
        from .boot import precompile_boot

        try:
            t0 = _time.monotonic()
            rec = precompile_boot(
                self.boot_cfg, blob_ids, device=self.device,
                codec=self.boot_codec)
            # The run overlapped the wire exactly when it finished
            # before startup arrived.
            dt = _time.monotonic() - t0
            overlapped = not self._startup_seen.is_set()
            with self._lock:
                self.precompile_records.append((rec, overlapped))
            log.info("boot programs precompiled during dissemination",
                     in_wire=overlapped, seconds=round(dt, 6), **rec)
        except Exception as e:  # noqa: BLE001 — advisory: boot compiles cold
            trace.count("fallback.precompile_cold")
            log.warn("boot precompile failed; boot will compile at "
                     "startup instead", err=repr(e))
        finally:
            with self._lock:
                self._precompile_inflight -= 1
                if self._precompile_inflight == 0:
                    self._precompile_done.set()

    def handle_startup(self, msg: StartupMsg) -> None:
        """The inference-engine boot hook (node.go:1387-1389) — with
        ``boot_cfg`` it actually boots the engine: ``ready()`` unblocks
        immediately (delivery is done), the boot runs on the handler pool,
        and its completion is reported to the leader as a BootReadyMsg.

        The LEADER's boot decision (``msg.boot``) governs: with it off,
        nobody boots; with it on, a receiver that locally opted out
        (``-boot none``) reports a "skipped" BootReadyMsg instead of
        silence — the leader's boot wait can never deadlock on a flag
        mismatch."""
        if self._fence_stale(msg):
            return
        self.expect_serve = msg.serve  # before ready(): the CLI reads it
        # Delivery is done: flush a FINAL cumulative metrics snapshot
        # now (the periodic cadence could lag a fast run by a whole
        # interval, and the leader's -report fold wants completion-time
        # totals, not the last tick's).
        if self._metrics_interval > 0:
            self._send_metrics_report()
        # Overlap accounting: precompiles/streamed stagings that finish
        # after this point no longer ran during the wire.
        self._startup_seen.set()
        if self._boot_stager is not None:
            self._boot_stager.mark_startup()
        # Latch the boot decision BEFORE ready() fires: the CLI's
        # exit-time wait_boot_drain reads _boot_started the moment
        # ready() returns, and a latch set after the put would race it —
        # the process could exit before the boot task was ever submitted
        # (killing it silently: the hang class this latch exists for).
        boot_pending = False
        prior_report = None
        if msg.boot and self.boot_cfg is not None:
            with self._lock:
                if self._boot_started:
                    # A re-sent startup must not re-boot — but it MUST
                    # re-answer (below, outside the lock): the leader
                    # re-sends startup precisely when it suspects the
                    # first exchange was lost, and a completed boot whose
                    # BootReadyMsg send failed would otherwise be
                    # unrecoverable.  A boot still in flight (report
                    # None) reports when it finishes.
                    prior_report = self._boot_report
                else:
                    self._boot_started = True
                    boot_pending = True
        self._ready_q.put(object())
        if self.fabric is not None:
            # Dissemination is over: the cached fabric uploads' HBM now
            # belongs to whatever boots next.
            release_upload_cache()
        if not msg.boot:
            return
        if self.boot_cfg is None:
            # No latch ON PURPOSE: the report is idempotent and cheap,
            # and a leader that re-sends startup (after an update/re-plan,
            # or because this send failed) must get it again.
            log.info("startup asked for boot but this node opted out; "
                     "reporting skipped")
            self._send_to_leader(BootReadyMsg(self.node.my_id, 0.0,
                                              "skipped"))
            return
        if boot_pending:
            self.loop.submit(self._boot)
        elif prior_report is not None:
            self._send_to_leader(
                BootReadyMsg(self.node.my_id, *prior_report))

    def _boot(self) -> None:
        try:
            self._boot_inner()
        finally:
            self._boot_drained.set()

    def wait_boot_drain(self, timeout: float) -> bool:
        """Block until any started boot task has fully drained (report
        sent, -gen decode done).  True immediately when no boot started.
        The CLI calls this before process exit: the boot runs on daemon
        threads, and exiting mid-boot kills it silently — the leader
        then hangs waiting for a BootReadyMsg that never comes."""
        with self._lock:
            started = self._boot_started
        if not started:
            return True
        return self._boot_drained.wait(timeout=timeout)

    def _boot_inner(self) -> None:
        from .boot import boot_from_layers

        try:
            res = boot_from_layers(
                self.boot_cfg, self.layers, device=self.device,
                codec=self.boot_codec, stager=self._boot_stager,
                digest_lookup=self._expected_digest,
                digest_verified=self._digest_ok,
            )
            # Assign BEFORE the finally sets the event: _serve() waits on
            # _boot_finished and then reads boot_result, so the event must
            # guarantee the assignment is visible.  A swap FLIP can race
            # a slow v1 boot (the v2 delta verified + committed while v1
            # was still compiling): the flipped tree wins — a late v1
            # boot must never overwrite the serving v2 params while
            # serving_version says v2 (docs/swap.md).
            with self._lock:
                if not self.serving_version:
                    self.boot_result = res
                else:
                    log.warn("boot finished after a swap flip; keeping "
                             "the swapped serving params",
                             serving=self.serving_version)
        except Exception as e:  # noqa: BLE001 — boot failure must be loud but non-fatal
            log.error("model boot failed", err=repr(e))
            # The failure must still REPORT: the leader's TTFT wait gates
            # on every assignee's BootReadyMsg, and silence would hang it
            # (found live: a physical-size boot OOM left the leader
            # blocked in boot_ready().get() forever).
            with self._lock:
                self._boot_report = (0.0, "failed")
            self._send_to_leader(BootReadyMsg(self.node.my_id, 0.0,
                                              "failed"))
            return
        finally:
            self._boot_finished.set()  # serve waiters proceed either way
        with self._lock:
            self._boot_report = (res.seconds, res.kind)
        self._send_to_leader(
            BootReadyMsg(self.node.my_id, res.seconds, res.kind))
        if self.boot_generate > 0:
            # Decode AFTER reporting: the leader's TTFT clock stops at
            # the last BootReadyMsg, and serving time must not
            # contaminate it.
            from .boot import decode_after_boot

            try:
                decode_after_boot(self.boot_cfg, res, self.boot_generate)
            except Exception as e:  # noqa: BLE001 — serving is best-effort here
                log.error("post-boot decode failed", err=repr(e))

    # ------------------------------------------------- pod serving (spmd)

    def serve_done(self) -> "queue.Queue[object]":
        """Fires once after a ServeMsg is handled: the member's
        (logits, seconds), or None (not a member / serve failed)."""
        return self._serve_q

    def handle_serve(self, msg: ServeMsg) -> None:
        """Multi-controller serving: every member enters the pipelined
        forward across the stages (runtime/pp_serve.py).  An EMPTY
        members list is the leader's cancellation (the pod became
        unservable) — waiters are released immediately.  Runs on a
        dedicated thread — the collective blocks until all members are
        in, which must not starve the message pool."""
        if self._fence_stale(msg):
            return
        self.serve_started.set()
        threading.Thread(
            target=self._serve, args=(msg,), daemon=True, name="torch-serve"
        ).start()

    def _serve(self, msg: ServeMsg) -> None:
        from .pp_serve import spmd_pod_decode, spmd_pod_forward

        out = None
        try:
            if self.node.my_id not in msg.members:
                return
            if self.boot_cfg is None or self.placement is None:
                log.error("serveMsg but no boot_cfg/placement")
                return
            self._boot_finished.wait(timeout=300.0)
            res = self.boot_result
            if res is None or res.kind != "stage" or res.params is None:
                log.error("serveMsg but no stage boot to serve from",
                          kind=getattr(res, "kind", None))
                return
            counts = msg.counts or None
            if msg.gen > 0:
                # Pod generation: every member enters the lockstep
                # KV-cached greedy decode and emits IDENTICAL token ids.
                out = spmd_pod_decode(
                    self.boot_cfg, self.placement, msg.members,
                    self.node.my_id, res.params, self.layers,
                    max_new=msg.gen, codec=self.boot_codec,
                    batch=msg.batch, prompt_len=msg.seq_len,
                    member_counts=counts,
                )
                if out is not None:
                    toks, _ = out
                    log.info("pod generated token ids",
                             tokens=[int(t) for t in toks[0].tolist()])
            else:
                out = spmd_pod_forward(
                    self.boot_cfg, self.placement, msg.members,
                    self.node.my_id, res.params, self.layers,
                    codec=self.boot_codec, batch=msg.batch,
                    seq_len=msg.seq_len, member_counts=counts,
                )
        except Exception as e:  # noqa: BLE001 — serve failure is loud, non-fatal
            log.error("pod serve failed", err=repr(e))
        finally:
            self._serve_q.put(out)


class RetransmitReceiverNode(ReceiverNode):
    """Modes 1/2 receiver: can forward its layers on command
    (node.go:1421-1484)."""

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self.loop.register(RetransmitMsg, self.handle_retransmit)
        # Retransmit-capable receivers SERVE layers, so they also serve
        # NACKs for fragments a peer's transport dropped as corrupt —
        # and honor preemption revokes for their queued sends.
        self.loop.register(LayerNackMsg, self.handle_layer_nack)
        self.loop.register(JobRevokeMsg, self.handle_job_revoke)

    def handle_layer_nack(self, msg: LayerNackMsg) -> None:
        self.nacker.handle(self.node, self.layers, self._lock, msg,
                           codecs=self.codec_plane)

    def handle_job_revoke(self, msg: JobRevokeMsg) -> None:
        """Preemption revoke (docs/service.md): a re-plan demoted this
        job's tier — queued sends for the named pairs must not start
        (and in-flight ones stop between fragments)."""
        if self._fence_stale(msg):
            return
        n = self.revokes.add(msg.job_id, msg.pairs,
                             gen=getattr(msg, "gen", 0))
        log.info("preemption revoke registered", job=msg.job_id,
                 pairs=len(msg.pairs), registry=n)

    def handle_retransmit(self, msg: RetransmitMsg) -> None:
        if self._fence_stale(msg):
            return
        with self._lock:
            layer = self.layers.get(msg.layer_id)
        if layer is None:
            log.error("retransmit of unknown layer", layerID=msg.layer_id)
            return
        self.node.add_node(msg.dest_id)
        if layer.meta.location == LayerLocation.CLIENT:
            log.debug("loading layer from client", layer=msg.layer_id)
            fetch_from_client(self.node, msg.layer_id, msg.dest_id)
            return
        try:
            send_layer(self.node, msg.dest_id, msg.layer_id, layer,
                       job_id=msg.job_id, shard=msg.shard,
                       codec=msg.codec, codecs=self.codec_plane)
        except (OSError, KeyError) as e:
            log.error("failed to send layer", dest=msg.dest_id, err=repr(e))


class FlowRetransmitReceiverNode(RetransmitReceiverNode):
    """Mode 3 receiver: partial-layer reassembly + flow-job execution
    (node.go:1487-1589)."""

    def __init__(self, node: Node, layers: LayersSrc, storage_path: str = ".",
                 start_loop: bool = True, heartbeat_interval: float = 0.0,
                 checkpoint_dir: str = "", stage_hbm: bool = False,
                 placement=None, boot_cfg=None, fabric=None,
                 boot_codec: str = "raw", boot_generate: int = 0,
                 codecs=None, device=None):
        """``checkpoint_dir``: when set, every fragment is journaled there
        and partial layers survive a process restart (resume support —
        absent in the reference, whose partial accounting dies with the
        process, node.go:1542-1554)."""
        # layer -> (reassembly buffer, ClaimedCoverage): fragment byte
        # copies run OUTSIDE self._lock (a 16 MiB memcpy under the lock
        # serializes every other handler) under the claim/commit
        # discipline shared with parallel/ingest.ShardedLayerIngest —
        # completion and coverage readers see only committed bytes.
        self._partial: Dict[int, Tuple[bytearray,
                                       intervals.ClaimedCoverage]] = {}
        self._partial_total: Dict[int, int] = {}
        # layer -> DURABLY-covered ranges: only ranges whose .part write has
        # fsync'd merge in (under self._lock), so the journal can never
        # claim bytes another handler thread hasn't landed on disk yet.
        self._durable: Dict[int, list] = {}
        # layer -> [(offset, len, crc32), ...] of journaled fragments —
        # recorded in the meta journal so resume re-VERIFIES the disk
        # bytes (runtime/checkpoint.py): a corrupted disk can never
        # resume as "covered".
        self._durable_crcs: Dict[int, list] = {}
        # layer -> ShardedLayerIngest: incremental device staging, fed per
        # fragment so HBM ingest overlaps the network receive (the
        # reference-analogous alternative — one synchronous device_put
        # after full host assembly — serializes ingest behind the ack).
        # Guarded by its own lock so creation/teardown never holds the main
        # receiver lock during device work.
        self._ingests: Dict[int, object] = {}
        self._ingests_lock = threading.Lock()
        # layer -> whether its ingest shares the reassembly buffer
        # (zero-copy CPU arm); memoized so only the first fragment pays
        # the share attempt.
        self._ingest_share: Dict[int, bool] = {}
        # layer -> phase accumulators (first-fragment wall time, summed
        # assembly-copy and ingest-write seconds): the per-layer phase
        # breakdown the completion log emits, so a physical-size run's
        # TTD decomposes into wire / copy / device time from the logs
        # alone.
        self._phase: Dict[int, dict] = {}
        self._ingest_dead: set = set()  # layers whose ingest failed: fall back
        self._ingest_done: set = set()  # completed: late creation is a leak
        self.ckpt = LayerCheckpointStore(checkpoint_dir) if checkpoint_dir else None
        if self.ckpt is not None:
            for lid, (buf, covered, total) in self.ckpt.load().items():
                if intervals.covered(covered) >= total:
                    # Crashed between assembly and journal cleanup: done.
                    layers[lid] = LayerSrc(
                        inmem_data=buf, data_size=total,
                        meta=LayerMeta(location=LayerLocation.INMEM),
                    )
                    self.ckpt.complete(lid)
                else:
                    self._partial[lid] = (
                        buf, intervals.ClaimedCoverage(covered))
                    self._partial_total[lid] = total
                    self._durable[lid] = list(covered)  # restored = on disk
                    # Re-seed the journal CRC records from the VERIFIED
                    # restored ranges: the next meta write replaces the
                    # whole journal, and ranges without a CRC would fail
                    # verification on the resume after next.
                    self._durable_crcs[lid] = [
                        (s, e - s,
                         integrity.fragment_crc(memoryview(buf)[s:e]))
                        for s, e in covered
                    ]
        # Loop start is deferred past the checkpoint replay below so no
        # handler races the ingest reconstruction.
        super().__init__(node, layers, storage_path, start_loop=False,
                         heartbeat_interval=heartbeat_interval,
                         stage_hbm=stage_hbm, placement=placement,
                         boot_cfg=boot_cfg, fabric=fabric,
                         boot_codec=boot_codec, boot_generate=boot_generate,
                         codecs=codecs, device=device)
        # Replay checkpoint-restored coverage into device ingests so a
        # resumed transfer's already-held bytes are on-mesh too.
        if self.stage_hbm:
            for lid, (buf, cov) in self._partial.items():
                ing = self._get_or_create_ingest(lid, self._partial_total[lid])
                if ing is None:
                    continue
                try:
                    for s, e in cov.committed():
                        ing.write(s, memoryview(buf)[s:e])
                except Exception as err:  # noqa: BLE001
                    self._ingest_write_failed(lid, ing, err)
        # Zero-copy receive: let the transport land fragment bytes
        # straight in the reassembly buffers (TcpTransport.layer_sink).
        # Registered after super().__init__ — the sink uses locks the
        # base constructor creates; fragments racing the registration
        # just take the bounce path.
        if hasattr(node.transport, "layer_sink"):
            node.transport.layer_sink = self._layer_sink
        # Quiet-gap watchdog (docs/integrity.md): last sender seen per
        # in-flight layer, and a ticker that re-NACKs gaps whose
        # coverage sat silent for a full interval — silent frame loss
        # (an eaten retransmit, a reset mid-flight) becomes a bounded
        # re-request instead of a stall until crash detection.
        self._frag_src: Dict[int, int] = {}
        self._frag_t: Dict[int, float] = {}
        # Chain relay roles (docs/hierarchy.md): per-layer forward hops
        # installed by the sub-leader's chain plan — each role is
        # {"lo","hi","next","sent"} with ``sent`` the interval list of
        # wire bytes already forwarded downstream, so every committed
        # byte forwards exactly once no matter how fragments split.
        self._fwd_roles: Dict[int, list] = {}
        self._fwd_dispatched: set = set()  # (lid, next): relay span filed
        self._gap_stop = threading.Event()
        self._gap_thread = None
        try:
            gap_s = float(
                os.environ.get("DLD_GAP_NACK_S", _GAP_NACK_DEFAULT_S))
        except ValueError:
            gap_s = _GAP_NACK_DEFAULT_S
        if gap_s > 0:
            self._gap_thread = threading.Thread(
                target=self._gap_watchdog, args=(gap_s,),
                daemon=True, name="gap-nack")
            self._gap_thread.start()
        if start_loop:
            self.loop.start()

    def _layer_sink(self, layer_id, total_size, offset, size):
        """Transport hook: claim the fragment's byte range and expose it
        as a writable view into the reassembly buffer, so ``recv_into``
        lands the bytes IN PLACE — socket→assembly in one copy, no
        bounce buffer, no handler memcpy.  Returns None (bounce path)
        for duplicates, overlaps, or anything unusual — correctness
        never depends on the sink engaging."""
        end = offset + size
        if size <= 0 or offset < 0 or end > total_size:
            return None
        with self._lock:
            if layer_id in self.layers:
                return None  # finished layer: bounce path re-acks dups
            entry = self._partial.get(layer_id)
            if entry is None:
                entry = (alloc_recv_buffer(total_size),
                         intervals.ClaimedCoverage())
            buf, cov = entry
            tok, claims = cov.claim(offset, end)
            if tok is None:
                return None  # full duplicate
            if claims != [(offset, end)]:
                # Partial overlap: a contiguous recv target would clobber
                # committed bytes — hand it to the claim-splitting path.
                cov.abort(tok)
                return None
            self._partial[layer_id] = entry
            self._partial_total[layer_id] = total_size
            # Phase accounting happens at COMMIT time in handle_layer
            # for both paths — an aborted recv must not skew the
            # fragment counts or the span the breakdown reports.

        def abort():
            with self._lock:
                cov.abort(tok)

        return memoryview(buf)[offset:end], tok, abort

    def _gap_watchdog(self, gap_s: float) -> None:
        """Quiet-gap re-NACK ticker (docs/integrity.md): a partial layer
        whose coverage sat still — and claim-idle — for a full interval
        has lost frames SILENTLY (an eaten retransmit, a reset
        mid-flight), so its uncovered gaps are re-requested from the
        last sender seen for it.  Re-NACKs ride the same
        ``_NACK_MAX_PER_RANGE`` budget as first NACKs (via
        ``_on_corrupt_fragment``), so a dead path still goes quiet
        instead of livelocking; each round also re-arms the quiet timer
        so a slow retransmit gets a full interval to land."""
        while not self._gap_stop.wait(gap_s):
            now = _time.monotonic()
            stale = []
            spent = []
            with self._lock:
                for lid, (_, cov) in self._partial.items():
                    total = self._partial_total.get(lid)
                    src = self._frag_src.get(lid)
                    last = self._frag_t.get(lid)
                    if (total is None or src is None or last is None
                            or now - last < gap_s or not cov.idle()):
                        continue
                    s0, s_sz = shard_range(
                        self._shard_specs.get(lid, ""), total)
                    all_gaps = intervals.uncovered(cov.committed(),
                                                   s0, s0 + s_sz)
                    gaps = [(s, e) for s, e in all_gaps
                            if self._nack_counts.get((lid, s), 0)
                            < _NACK_MAX_PER_RANGE]
                    if gaps:
                        stale.append((lid, src, total, gaps))
                        self._frag_t[lid] = now
                    elif all_gaps:
                        # Every remaining gap's NACK budget is spent:
                        # stand down for this layer — recovery belongs
                        # to crash detection now, not a per-interval
                        # error line for the rest of the process.
                        self._frag_src.pop(lid, None)
                        self._frag_t.pop(lid, None)
                        spent.append(lid)
            for lid in spent:
                trace.count("integrity.gap_standdown")
                log.error("gap watchdog standing down: NACK budget "
                          "exhausted for every remaining gap; "
                          "re-announcing so the leader re-plans",
                          layerID=lid)
            if spent:
                # The NACK path is dead (a partitioned or crashed
                # holder); the re-announce carries this node's partial
                # coverage, so the leader re-plans ONLY the gaps — from
                # any surviving source.
                self._request_replan()
            for lid, src, total, gaps in stale:
                trace.count("integrity.gap_renack")
                log.warn("layer coverage quiet past watchdog interval; "
                         "re-NACKing gaps", layerID=lid, src=src,
                         gaps=len(gaps),
                         missing=sum(e - s for s, e in gaps))
                for s, e in gaps:
                    self._on_corrupt_fragment(src, lid, s, e - s, total,
                                              "stale")

    def _on_corrupt_fragment(self, src_id, layer_id, offset, size,
                             total, reason) -> None:
        # Arm the gap watchdog even when the FIRST frame of a layer is
        # the corrupt one: no successful store may ever happen for it,
        # and the re-NACK path needs a last-seen source + quiet timer.
        # Re-arming the timer on every drop is right — a NACK just went
        # out, so the retransmit gets a full quiet interval to land.
        if src_id is not None and src_id != self.node.my_id:
            with self._lock:
                self._frag_src[layer_id] = src_id
                self._frag_t[layer_id] = _time.monotonic()
        super()._on_corrupt_fragment(src_id, layer_id, offset, size,
                                     total, reason)

    # ------------------------------------------------ chain relay plane

    def _install_forward_roles(self, msg: GroupPlanMsg) -> None:
        """Install (REPLACE, per layer) this member's chain relay roles
        (docs/hierarchy.md).  A re-installed identical (lo, hi, next)
        hop keeps its ``sent`` coverage — re-chains after a member death
        must not re-ship ranges the survivor already forwarded — while
        a changed hop starts clean.  Bytes that landed BEFORE the roles
        arrived forward immediately via the backlog scan: role install
        and data arrival race freely."""
        installed = []
        with self._lock:
            for lid, hops in msg.forward.items():
                lid = int(lid)
                prior = {(r["lo"], r["hi"], r["next"]): r
                         for r in self._fwd_roles.get(lid, [])}
                fresh = []
                for lo, hi, nxt in hops:
                    key = (int(lo), int(hi), int(nxt))
                    old = prior.get(key)
                    fresh.append(old if old is not None else
                                 {"lo": key[0], "hi": key[1],
                                  "next": key[2], "sent": []})
                if fresh:
                    self._fwd_roles[lid] = fresh
                else:
                    self._fwd_roles.pop(lid, None)
                installed.append(lid)
        trace.count("hier.relay_roles")
        log.info("chain forward roles installed", group=msg.group_id,
                 layers=sorted(installed))
        for lid in installed:
            self._forward_committed(lid, None, None)

    def _clear_forward_roles(self) -> None:
        with self._lock:
            self._fwd_roles.clear()

    def _forward_committed(self, lid, ranges, total, job: str = "") -> None:
        """Relay hop of the chain (docs/hierarchy.md): forward the
        freshly committed ``ranges`` (None = backlog scan of everything
        already landed) downstream per this member's roles, the moment
        they land — cut-through at fragment granularity, never waiting
        for layer completion.  ``sent`` interval accounting dedups, so
        retransmitted duplicates forward nothing."""
        sends = []
        with self._lock:
            roles = self._fwd_roles.get(lid)
            if not roles:
                return
            layer = self.layers.get(lid)
            if layer is not None:
                buf = layer.inmem_data
                total = layer.data_size
                codec = layer.meta.codec
                # A completed SHARD holding's buffer is only real inside
                # its range (roles never exceed it by construction, but
                # the clip keeps a malformed plan from shipping zeros).
                s0, s_sz = shard_range(layer.meta.shard, total)
                committed = [(s0, s0 + s_sz)]
            else:
                entry = self._partial.get(lid)
                if entry is None:
                    return
                buf, cov = entry
                total = self._partial_total.get(lid, total)
                codec = (self._layer_codecs.get(lid)
                         or self._frag_codec.get(lid, ""))
                committed = cov.committed()
            if ranges is None:
                ranges = committed
            if total is None or buf is None:
                return
            for role in roles:
                for s, e in ranges:
                    cs, ce = max(s, role["lo"]), min(e, role["hi"])
                    if cs >= ce:
                        continue
                    for a, b in intervals.uncovered(role["sent"], cs, ce):
                        role["sent"] = intervals.insert(role["sent"], a, b)
                        sends.append((role["next"], a, b))
        for nxt, a, b in sends:
            threads_util.tx_pool().submit(
                self._forward_one, nxt, lid, buf, a, b - a, total, codec,
                job)

    def _forward_one(self, nxt, lid, buf, off, size, total, codec,
                     job) -> None:
        """One relay send — a byte-range LayerMsg whose offset indexes
        the SAME wire space the bytes landed in (the reassembly buffer
        is the full-size wire blob, so the landing offset IS the
        forwarding offset).  Failures are non-fatal: the downstream
        member's gap-NACK watchdog re-requests what never arrived, and
        the sub-leader's redrive star-sends around a dead hop."""
        try:
            self.node.add_node(nxt)
            span = telemetry.span_id(nxt, lid)
            with self._lock:
                first = (lid, nxt) not in self._fwd_dispatched
                if first:
                    self._fwd_dispatched.add((lid, nxt))
            if first:
                telemetry.span_event(
                    span, "dispatched", node=self.node.my_id,
                    src=self.node.my_id, dest=nxt, layer=lid, job=job,
                    codec=codec,
                    parent=telemetry.span_id(self.node.my_id, lid))
                log.info("relaying layer downstream", layerID=lid,
                         next=nxt)
            trace.count("hier.relay_frags")
            trace.count("hier.relay_bytes", size)
            src = LayerSrc(
                inmem_data=buf, data_size=size, offset=off,
                meta=LayerMeta(location=LayerLocation.INMEM))
            self.node.transport.send(
                nxt, LayerMsg(self.node.my_id, lid, src, total,
                              job_id=job, codec=codec, span_id=span,
                              span_parent=telemetry.span_id(
                                  self.node.my_id, lid)))
        except (OSError, KeyError, ConnectionError) as e:
            log.warn("relay forward failed (downstream gap-NACK / "
                     "sub-leader redrive recovers it)", layerID=lid,
                     next=nxt, err=repr(e))

    def handle_layer_nack(self, msg: LayerNackMsg) -> None:
        """Mode-3 NACK service: a mid-chain member can be asked to
        retransmit a range of a layer it is ITSELF still receiving (its
        downstream lost a relayed fragment) — serve fully-committed
        ranges straight from the reassembly buffer, and fall back to
        the completed-holdings retransmitter otherwise."""
        with self._lock:
            held = msg.layer_id in self.layers
        if not held and self._serve_nack_from_partial(msg):
            return
        super().handle_layer_nack(msg)

    def _serve_nack_from_partial(self, msg: LayerNackMsg) -> bool:
        """True when the NACK was handled here (served, or suppressed by
        the shared retry budget).  Only byte-for-byte certain ranges
        qualify: fully committed, inside the wire total, and in the SAME
        codec byte space the transfer runs in — anything else falls
        through to the holding path's loud refusals."""
        lid = msg.layer_id
        end = msg.offset + msg.size
        with self._lock:
            entry = self._partial.get(lid)
            total = self._partial_total.get(lid)
            if (entry is None or total is None or msg.size <= 0
                    or msg.offset < 0 or end > total):
                return False
            buf, cov = entry
            if intervals.uncovered(cov.committed(), msg.offset, end):
                return False  # not all landed here yet
            codec = (self._layer_codecs.get(lid)
                     or self._frag_codec.get(lid, ""))
        if (getattr(msg, "codec", "") or "") != (codec or ""):
            return False
        n = self.nacker.admit(msg.src_id, lid, msg.offset, msg.size)
        if not n:
            return True  # budget spent: suppressed, not re-servable
        self.node.add_node(msg.src_id)
        log.warn("NACK served from in-flight partial coverage",
                 layerID=lid, dest=msg.src_id, offset=msg.offset,
                 bytes=msg.size, reason=msg.reason, attempt=n,
                 codec=codec or None)
        trace.count("integrity.retransmit_frags")
        trace.count("integrity.retransmit_bytes", msg.size)
        telemetry.link_add(self.node.my_id, msg.src_id,
                           retransmit_frames=1, retransmit_bytes=msg.size)
        src = LayerSrc(inmem_data=buf, data_size=msg.size,
                       offset=msg.offset,
                       meta=LayerMeta(location=LayerLocation.INMEM))
        self.node.transport.send(
            msg.src_id,
            LayerMsg(self.node.my_id, lid, src, total, codec=codec,
                     span_id=telemetry.span_id(msg.src_id, lid)))
        return True

    def close(self) -> None:
        self._gap_stop.set()
        if self._gap_thread is not None:
            self._gap_thread.join(timeout=2.0)
        super().close()

    def _get_or_create_ingest(self, layer_id, total_size):
        """The layer's incremental device ingest, created on first use;
        None when device staging doesn't apply (no -hbm / no placement for
        this layer / a previous device failure on it / already completed).
        Must NOT be called while holding ``self._lock`` — creation
        dispatches device allocations under ``self._ingests_lock``."""
        if not self.stage_hbm:
            return None
        if (self.placement is None
                or layer_id not in self.placement.layer_to_stage):
            return None  # no stage mapping: stage whole at completion
        with self._ingests_lock:
            if layer_id in self._ingest_dead or layer_id in self._ingest_done:
                return None
            ing = self._ingests.get(layer_id)
            if ing is None:
                try:
                    from ..parallel.ingest import ShardedLayerIngest

                    ing = ShardedLayerIngest(
                        total_size, self.placement.devices_for_layer(layer_id),
                        mover=self._mover)
                except Exception as e:  # noqa: BLE001 — delivery beats staging
                    trace.count("fallback.ingest_unavailable_bulk")
                    log.error("device ingest unavailable for layer",
                              layerID=layer_id, err=repr(e))
                    self._ingest_dead.add(layer_id)
                    return None
                self._ingests[layer_id] = ing
            return ing

    def _ingest_write_failed(self, layer_id, ing, err) -> None:
        """A device write failed: poison the ingest (wakes any finalize
        waiter into the bulk-staging fallback) and stop feeding it."""
        trace.count("fallback.ingest_write_bulk")
        log.error("incremental device ingest failed; will stage at "
                  "completion", layerID=layer_id, err=repr(err))
        ing.fail()
        with self._ingests_lock:
            self._ingest_dead.add(layer_id)
            self._ingests.pop(layer_id, None)

    def _partial_totals_locked(self) -> dict:
        return self._partial_total

    def _announce_partial(self) -> dict:
        """Partial coverage for the announce — EXCLUDING in-flight copy
        claims, exactly like ``_local_coverage``: a range announced as
        held is a range the leader won't re-plan, so it must only ever
        name bytes that have really landed in the buffer."""
        with self._lock:
            return {
                lid: {
                    "Total": self._partial_total[lid],
                    "Covered": [list(iv) for iv in cov.committed()],
                }
                for lid, (_, cov) in self._partial.items()
                if lid in self._partial_total
            }

    def _reopen_widened(self, lids) -> None:
        """A promoted SHARD holding whose target widened (or
        re-targeted to a non-covered shard) demotes back to PARTIAL
        coverage — the shard's landed bytes stay (the buffer already is
        the full-size reassembly buffer), and the re-planned remainder
        completes the new target through the normal fragment path."""
        for lid in lids:
            with self._lock:
                src = self.layers.get(lid)
                if src is None or not src.meta.shard:
                    continue
                total = src.data_size
                s0, s_sz = shard_range(src.meta.shard, total)
                del self.layers[lid]
                self._own_digests.pop(lid, None)
                self._digest_ok.discard(lid)
                self._partial[lid] = (
                    src.inmem_data,
                    intervals.ClaimedCoverage([(s0, s0 + s_sz)]))
                self._partial_total[lid] = total
            self.content_store.forget(lid)
            with self._ingests_lock:
                self._ingest_done.discard(lid)
            log.warn("shard holding's target widened/re-targeted; "
                     "reopened as partial coverage", layerID=lid,
                     kept_bytes=s_sz, total=total)

    def _on_shard_specs(self, lids) -> None:
        """Shard specs just (re)stamped: promote any layer whose
        existing coverage already satisfies its shard — fragments can
        land before the stamp, and no later fragment would re-run the
        completion check (docs/sharding.md)."""
        for lid in lids:
            with self._lock:
                total = self._partial_total.get(lid)
            if total is None:
                continue
            # commit(None) is a no-op: this reuses the promotion gate
            # without releasing anyone's claim.
            if self._commit_fragment(lid, None, total):
                self._ack_completed(lid)

    def _local_coverage(self, layer_id):
        """Checkpoint-restored bytes seed a resumed fabric ingest: the
        leader's plan covers only the gaps (leader.assign_jobs), so what
        this node already holds must enter the shard buffers locally.
        Ranges whose copy is still in flight (claimed, not committed) are
        excluded — their buffer bytes aren't real yet."""
        with self._lock:
            entry = self._partial.get(layer_id)
            if entry is None:
                return []
            buf, cov = entry
            return [(s, bytes(memoryview(buf)[s:e]))
                    for s, e in cov.committed()]

    def _fabric_store(self, layer_id, total: int, device_arr=None,
                      host_buf=None) -> None:
        """A fabric completion supersedes any partial-transfer state: the
        host buffer and the durable journal for this layer are done."""
        super()._fabric_store(layer_id, total, device_arr=device_arr,
                              host_buf=host_buf)
        with self._lock:
            self._partial.pop(layer_id, None)
            self._partial_total.pop(layer_id, None)
            self._durable.pop(layer_id, None)
            self._durable_crcs.pop(layer_id, None)
        if self.ckpt is not None:
            self.ckpt.complete(layer_id)

    def _register_handlers(self) -> None:
        super()._register_handlers()
        self.loop.register(FlowRetransmitMsg, self.handle_flow_retransmit)
        self.loop.register(SourceDeadMsg, self.handle_source_dead)

    def handle_source_dead(self, msg: SourceDeadMsg) -> None:
        """Range-level salvage (docs/failover.md): the leader declared a
        mid-transfer SOURCE crashed.  Re-request ONLY this layer's
        uncovered byte ranges from the surviving ``alt_id`` holder via
        the NACK retransmit plane — the committed bytes the dead
        source (and everyone else) already delivered stay; recovery
        costs exactly the unsent remainder.  The gap watchdog re-arms
        against the alt holder, so a lost NACK round is re-requested
        instead of stalling."""
        if self._fence_stale(msg):
            return
        lid = msg.layer_id
        with self._lock:
            done = lid in self.layers
            entry = self._partial.get(lid)
            total = self._partial_total.get(lid)
        if done:
            # Completed while the notice was in flight: the leader
            # missed our ack — re-ack instead of re-fetching anything.
            self._ack_completed(lid)
            return
        if entry is None or total is None:
            # No coverage at all: nothing to salvage — re-announce so
            # the leader re-plans the whole layer.
            log.warn("source dead but no partial coverage; requesting "
                     "whole-layer re-plan", layerID=lid, dead=msg.dead_id)
            self._request_replan()
            return
        _, cov = entry
        with self._lock:
            self._frag_src[lid] = msg.alt_id
            self._frag_t[lid] = _time.monotonic()
            # committed() on purpose: ranges with an in-flight claim are
            # re-requested too.  A claim can still ABORT (failed copy),
            # and a range requested twice is absorbed by interval
            # reassembly — a range never requested is a stall until the
            # gap watchdog notices.  Slightly over-counts salvage_bytes;
            # never under-recovers.  Sharded targets salvage only their
            # shard's range (docs/sharding.md).
            s0, s_sz = shard_range(self._shard_specs.get(lid, ""), total)
            gaps = intervals.uncovered(cov.committed(), s0, s0 + s_sz)
        missing = sum(e - s for s, e in gaps)
        trace.count("failover.salvage_ranges", len(gaps))
        trace.count("failover.salvage_bytes", missing)
        log.warn("source declared dead mid-layer; NACKing uncovered "
                 "ranges to the surviving holder", layerID=lid,
                 dead=msg.dead_id, alt=msg.alt_id, ranges=len(gaps),
                 missing_bytes=missing, total=total)
        for s, e in gaps:
            self._on_corrupt_fragment(msg.alt_id, lid, s, e - s, total,
                                      "source-dead")

    def handle_layer(self, msg: LayerMsg) -> None:
        """Write the fragment at its offset; ack when the layer is whole
        (node.go:1520-1567, with the real byte copy the reference skips).

        Coverage is tracked as an interval union, not a byte counter (the
        reference sums sizes, node.go:1542-1554) — so duplicate or
        overlapping fragments from a crash-triggered re-plan can never ack
        a layer full of holes.

        The byte copy runs OUTSIDE ``self._lock`` under a claim/commit
        discipline (``utils.intervals.ClaimedCoverage``): the lock is
        held only to claim the
        fragment's uncovered ranges and, after the copy, to commit —
        concurrent senders' fragments assemble in parallel instead of
        serializing a 16 MiB memcpy each behind one lock, which matters
        exactly at physical layer sizes.  Completion (promote + ack) fires
        at the commit that sees full coverage with no copy in flight.

        Device staging is incremental: each fragment is also written to its
        span's device through the layer's ``ShardedLayerIngest`` as it
        arrives, so HBM ingest overlaps the network receive; completion
        runs one ICI all-gather instead of a full-layer device_put."""
        lid = msg.layer_id
        frag = msg.layer_src
        if (frag.offset < 0
                or frag.offset + frag.data_size > msg.total_size):
            # A malformed fragment must fail loudly BEFORE any claim: the
            # memmove assembly below has no implicit bounds check (the
            # old numpy slice assignment raised; ctypes.memmove corrupts).
            log.error("fragment outside layer; dropped", layerID=lid,
                      offset=frag.offset, size=frag.data_size,
                      total=msg.total_size)
            return
        with self._lock:
            already_done = lid in self.layers
        # Ingest creation dispatches device allocations — do it before
        # (and outside) the main critical section.
        ing = None
        if not already_done:
            ing = self._get_or_create_ingest(lid, msg.total_size)
        placed = frag.placed_token is not None
        # Materialize the fragment's bytes BEFORE claiming (one zero-copy
        # view for every consumer below; read_bytes would duplicate the
        # buffer per use): a read failure here must leave no claim behind
        # — a leaked claim wedges the layer forever (no commit can ever
        # see an empty in-flight set again).  A PLACED fragment's bytes
        # are already in the reassembly buffer (the transport sink
        # landed them there, claim held) — there is nothing to read.
        raw = None
        if not placed:
            raw = (frag.inmem_data if frag.inmem_data is not None
                   else frag.read_bytes())
        data_mv = memoryview(raw) if raw is not None else None
        claims: list = []
        tok = None
        journal = False
        dup_done = False
        foreign = False
        first_frag = False
        with self._lock:
            if lid in self.layers:
                # A re-plan duplicate of a finished layer: drop the bytes
                # but re-ack below — the re-send happened precisely because
                # the leader never saw our ack.  (A placed fragment can't
                # get here: its in-flight claim blocks completion.)
                dup_done = True
            elif placed and self._partial.get(lid) is None:
                # A placed fragment whose claim belongs to a PREVIOUS
                # incarnation's sink: a receiver replaced on a live
                # transport (declared-dead revival) drains its
                # predecessor's queued fragments, whose bytes live in
                # the DEAD incarnation's buffers.  Our sink never
                # claimed this range (the sink creates the _partial
                # entry at claim time), so drop it — the leader's
                # re-plan re-sends the range into OUR buffers.
                foreign = True
            else:
                entry = self._partial.get(lid)
                if entry is None:
                    # Allocate lazily (an eager dict.get default would
                    # build a full layer-sized buffer on *every* fragment)
                    # and unzeroed (zero-fill would hold the GIL for
                    # hundreds of ms at real layer sizes; coverage is
                    # tracked by intervals, so unwritten bytes are never
                    # exposed).
                    entry = (alloc_recv_buffer(msg.total_size),
                             intervals.ClaimedCoverage())
                buf, cov = entry
                if placed:
                    # The sink already claimed exactly this range and the
                    # bytes are in ``buf``; this handler owns the commit.
                    tok = frag.placed_token
                    claims = [(frag.offset, frag.offset + frag.data_size)]
                else:
                    tok, claims = cov.claim(
                        frag.offset, frag.offset + frag.data_size)
                ph = self._phase.setdefault(lid, {
                    "t0": _time.monotonic(), "copy_s": 0.0,
                    "ingest_s": 0.0, "frags": 0, "placed": 0})
                ph["frags"] += 1
                first_frag = ph["frags"] == 1
                if placed:
                    # Zero-copy receive: the transport landed this
                    # fragment (possibly one STRIPE of a striped
                    # transfer) directly in the reassembly buffer.
                    ph["placed"] = ph.get("placed", 0) + 1
                self._partial[lid] = (buf, cov)
                self._partial_total[lid] = msg.total_size
                # Gap-watchdog bookkeeping: who last fed this layer, and
                # when — ANY fragment counts as progress (even a
                # duplicate proves the path is alive).
                self._frag_src[lid] = msg.src_id
                self._frag_t[lid] = _time.monotonic()
                # Advisory codec tag (docs/codec.md): remembered so the
                # promotion (and NACKs) know the transfer's encoded
                # form even when the leader's stamp never arrived
                # (digests disabled).
                if msg.codec:
                    self._frag_codec[lid] = msg.codec
                # Journaled OUTSIDE the lock below (two fsyncs per
                # fragment must not serialize every other handler), and
                # only for fragments that landed NEW bytes — a full
                # re-plan duplicate's ranges were journaled by their
                # claim-holders already.
                journal = self.ckpt is not None and bool(claims)
                log.info(
                    "layer fragment stored",
                    layerID=lid, offset=frag.offset, size=frag.data_size,
                    received=cov.covered_bytes(),
                    total=msg.total_size,
                )
        if first_frag:
            # Pair-lifecycle span (docs/observability.md): the wire is
            # live — dispatched→first_byte is the transfer's startup
            # latency, first_byte→wire_complete its streaming window.
            telemetry.span_event(
                msg.span_id or telemetry.span_id(self.node.my_id, lid),
                "first_byte", node=self.node.my_id, src=msg.src_id,
                dest=self.node.my_id, layer=lid, job=msg.job_id,
                parent=msg.span_parent)
        if dup_done:
            self._ack_completed(lid)
            return
        if foreign:
            trace.count("failover.foreign_placed_dropped")
            log.warn("dropping placed fragment claimed by a previous "
                     "incarnation's sink", layerID=lid,
                     offset=frag.offset, size=frag.data_size)
            return
        if placed:
            # The fragment's bytes live in the reassembly buffer; every
            # consumer below (ingest, journal) reads them from there.
            data_mv = memoryview(buf)[
                frag.offset : frag.offset + frag.data_size]
        # Zero-copy CPU arm: the ingest adopts the reassembly buffer
        # itself (first fragment pays the attempt; memoized).  The
        # assembly write then IS the ingest — only coverage accounting
        # remains (``mark`` below, after the bytes are really in place).
        shared = False
        if ing is not None:
            shared = self._ingest_try_share(lid, ing, buf)
        # Ingest first: on an accelerator this dispatches the async DMA,
        # which then overlaps the host-side assembly copy right below.
        if ing is not None and not shared:
            try:
                t_ing = _time.monotonic()
                ing.write(frag.offset, data_mv)
                t_ing = _time.monotonic() - t_ing
                with self._lock:
                    ph = self._phase.get(lid)
                    if ph is not None:
                        ph["ingest_s"] += t_ing
            except Exception as e:  # noqa: BLE001 — delivery beats staging
                self._ingest_write_failed(lid, ing, e)
                ing = None
            else:
                telemetry.link_add(msg.src_id, self.node.my_id,
                                   place_s=t_ing)
        if tok is not None and not placed:
            try:
                t_cp = _time.monotonic()
                for lo, hi in claims:
                    # memmove-grade copy (GIL released): concurrent
                    # senders' fragments really assemble in parallel.
                    hostmem.copy_into(
                        buf, lo, data_mv[lo - frag.offset : hi - frag.offset])
                t_cp = _time.monotonic() - t_cp
                with self._lock:
                    ph = self._phase.get(lid)
                    if ph is not None:
                        ph["copy_s"] += t_cp
                telemetry.link_add(msg.src_id, self.node.my_id,
                                   place_s=t_cp)
            except Exception:
                with self._lock:
                    cov.abort(tok)
                raise
        if ing is not None and shared and tok is not None:
            # Bytes are in the shared buffer now (copied above, or placed
            # by the transport): record the coverage with the ingest.
            for lo, hi in claims:
                ing.mark(lo, hi)
        if tok is not None and claims:
            # Flight recorder: exactly the NEW bytes this fragment's
            # claims landed (duplicates and overlaps claim nothing), so
            # per-link delivered totals reconcile byte-exactly against
            # delivered layer bytes in the run report.
            telemetry.link_add(
                msg.src_id, self.node.my_id, job=msg.job_id,
                delivered_bytes=sum(hi - lo for lo, hi in claims))
        complete = self._commit_fragment(lid, tok, msg.total_size)
        if tok is not None and claims:
            # Chain relay (docs/hierarchy.md): the fragment's bytes are
            # committed — forward them downstream NOW, not at layer
            # completion (cut-through pipelining at hop granularity).
            self._forward_committed(lid, claims, msg.total_size,
                                    job=msg.job_id)
        if journal and not complete:
            # (The completing fragment skips the journal: its completion
            # already deleted the checkpoint files.)  Bytes first,
            # fsync'd; then merge ONLY this fragment's range into the
            # durable-coverage union under the lock — the meta can never
            # claim ranges whose .part writes are still pending in sibling
            # handler threads (which a crash would restore as zeros).
            off, data, total = frag.offset, bytes(data_mv), msg.total_size
            self.ckpt.write_bytes(lid, off, data, total)
            # The journaled range's crc32 rides the meta journal so
            # resume re-verifies the DISK bytes (integrity hardening).
            frag_crc = integrity.fragment_crc(data)
            with self._lock:
                raced_completion = lid in self.layers
                if not raced_completion:
                    durable = intervals.insert(
                        self._durable.get(lid, []), off, off + len(data)
                    )
                    self._durable[lid] = durable
                    crcs = self._durable_crcs.setdefault(lid, [])
                    if crcs is not None:
                        crcs.append((off, len(data), frag_crc))
                        if len(crcs) > _JOURNAL_CRC_MAX_RECORDS:
                            log.warn("journal CRC record cap hit; this "
                                     "layer's journal falls back to the "
                                     "un-verified legacy format",
                                     layerID=lid)
                            crcs = self._durable_crcs[lid] = None
                    crcs_snapshot = list(crcs) if crcs is not None else None
            if not raced_completion:
                self.ckpt.write_meta(lid, durable, total,
                                     frag_crcs=crcs_snapshot)
                with self._lock:
                    raced_completion = lid in self.layers
            if raced_completion:
                # Another thread completed the layer while we journaled;
                # drop the files our writes just resurrected.
                self.ckpt.complete(lid)
                with self._lock:
                    self._durable.pop(lid, None)
                    self._durable_crcs.pop(lid, None)
        if complete:
            self._ack_completed(lid)

    def _ingest_try_share(self, lid, ing, buf) -> bool:
        """Once per layer: try to make the ingest adopt the reassembly
        buffer (``ShardedLayerIngest.share_host_buffer``).  Memoized —
        only the first fragment pays the attempt; all later fragments
        read the cached verdict."""
        with self._ingests_lock:
            cached = self._ingest_share.get(lid)
            if cached is not None:
                return cached
            try:
                ok = bool(ing.share_host_buffer(buf))
            except Exception:  # noqa: BLE001 — sharing is an optimization
                ok = False
            self._ingest_share[lid] = ok
            return ok

    def _commit_fragment(self, lid, tok, total: int) -> bool:
        """Release this fragment's copy claim; promote the layer when
        coverage is full AND no sibling copy is in flight.  Returns
        whether THIS commit performed the promotion (exactly one does —
        the caller then stages + acks).

        SHARDED targets (docs/sharding.md) promote at SHARD coverage:
        the stamped spec's byte range is all this dest was ever promised
        — the holding is recorded shard-qualified (``meta.shard``), its
        buffer real only inside the range (the rest is unfaulted pages,
        so host RAM stays ≈ the shard fraction)."""
        with self._lock:
            entry = self._partial.get(lid)
            if entry is not None:
                entry[1].commit(tok)
            if lid in self.layers:
                return False  # a sibling already promoted (and acked)
            if entry is None:
                return False
            buf, cov = entry
            spec = self._shard_specs.get(lid, "")
            if spec:
                s0, s_sz = shard_range(spec, total)
                if not cov.complete_range(s0, s0 + s_sz):
                    return False
            elif not cov.complete(total):
                return False
            # Wire-codec identity (docs/codec.md): the stamp is
            # authoritative, the frames' advisory tag the fallback —
            # the promoted holding (and its ack) must carry the form
            # its bytes are actually in.
            codec = (self._layer_codecs.get(lid)
                     or self._frag_codec.pop(lid, ""))
            self.layers[lid] = LayerSrc(
                inmem_data=buf, data_size=total,
                meta=LayerMeta(location=LayerLocation.INMEM, shard=spec,
                               codec=codec),
            )
            del self._partial[lid]
            self._partial_total.pop(lid, None)
            self._durable.pop(lid, None)
            self._durable_crcs.pop(lid, None)
            frag_src = self._frag_src.pop(lid, None)
            self._frag_t.pop(lid, None)
            ph = self._phase.pop(lid, None)
        if codec:
            self._count_codec_delivery(lid, total, codec)
        if self.ckpt is not None:
            self.ckpt.complete(lid)
        extra = {}
        if ph is not None:
            span = _time.monotonic() - ph["t0"]
            extra = {
                "recv_span_ms": round(span * 1000, 1),
                "copy_ms": round(ph["copy_s"] * 1000, 1),
                "ingest_ms": round(ph["ingest_s"] * 1000, 1),
                "fragments": ph["frags"],
                "placed_fragments": ph.get("placed", 0),
                "gbps": round(total / max(span, 1e-9) / 1e9, 3),
            }
        telemetry.span_event(
            telemetry.span_id(self.node.my_id, lid), "wire_complete",
            node=self.node.my_id, src=frag_src, dest=self.node.my_id,
            layer=lid, bytes=total, codec=codec, shard=spec)
        log.info("layer fully received", layer=lid, total_bytes=total,
                 **extra)
        return True

    def _ack_completed(self, lid) -> None:
        """Stage (finalizing any incremental ingest) + ack a completed
        layer; also the re-ack path for a re-plan duplicate.

        Integrity gate FIRST: the assembled layer verifies against the
        leader-stamped digest BEFORE any device placement, streamed boot
        staging, or ack — a mismatch re-opens the covered intervals
        (the layer demotes back to "missing" and the node re-announces,
        so the leader re-plans the bytes) instead of acking corruption
        into the goal state."""
        with self._lock:
            src = self.layers.get(lid)
        if src is None:
            return
        if not self._digest_gate(lid, src):
            return
        # Content-delta (docs/codec.md): a stream-verified delta
        # holding reconstructs to canonical bytes before staging/ack.
        src = self._finalize_delta(lid, src)
        if src is None:
            return
        # Pair-lifecycle span (docs/observability.md): the integrity
        # gate passed — wire_complete→verified is the digest cost (zero
        # when no digest was stamped; the phase collapses in the walk).
        span = telemetry.span_id(self.node.my_id, lid)
        telemetry.span_event(span, "verified", node=self.node.my_id,
                             dest=self.node.my_id, layer=lid)
        with self._ingests_lock:
            self._ingest_done.add(lid)
            ing = self._ingests.pop(lid, None)
            self._ingest_share.pop(lid, None)
        shard = src.meta.shard
        if shard:
            # A SHARD holding stays host-resident and un-booted: its
            # buffer is only real inside the shard's range — the full
            # layer materializes on-mesh via the shard gather when the
            # target sharding demands it (docs/sharding.md).
            loc = LayerLocation.INMEM
        else:
            loc = self._stage_to_hbm(lid, src, ingest=ing)
            # Mid-wire boot staging: this layer's decode/upload overlaps
            # the layers still on the wire (runtime/stream_boot.py).
            self._boot_stream_submit(lid, src)
        telemetry.span_event(span, "staged", node=self.node.my_id,
                             dest=self.node.my_id, layer=lid,
                             shard=shard)
        self._send_ack(lid, loc, shard=shard)
        if shard:
            # Fabric-assisted pod delivery (docs/fabric.md): a verified
            # pod slice enters the on-mesh reconstruction — the FULL
            # tree acks separately once the gather verifies.  No-op for
            # plain sharded targets (no pod stamp).
            self._start_pod_collect(lid, src)
        # Stamp-before-donor race: this completed layer may be the
        # donor a stamped-but-missing layer was waiting for.
        self._resolve_pending_for_layer(lid)

    def _demote_corrupt_layer(self, lid) -> None:
        """Mode-3 demotion: beyond the store entry, also re-open the
        layer's intervals (partial state), wipe its journal, and poison
        any incremental device ingest — a re-delivery starts clean."""
        super()._demote_corrupt_layer(lid)
        with self._lock:
            self._partial.pop(lid, None)
            self._partial_total.pop(lid, None)
            self._durable.pop(lid, None)
            self._durable_crcs.pop(lid, None)
            self._frag_src.pop(lid, None)
            self._frag_t.pop(lid, None)
        with self._ingests_lock:
            self._ingest_done.discard(lid)
            self._ingest_share.pop(lid, None)
            ing = self._ingests.pop(lid, None)
        if ing is not None:
            try:
                ing.fail()
            except Exception:  # noqa: BLE001 — poison is best-effort
                pass
        if self.ckpt is not None:
            self.ckpt.complete(lid)

    def _digest_gate(self, lid, src) -> bool:
        """Verify a completed layer's digest; on mismatch DEMOTE it
        (``_demote_corrupt_layer``) and re-announce so the leader
        re-plans the whole layer (mode-3 fragments come from several
        senders, so there is no one peer to NACK).  Bounded: after
        ``_DIGEST_MAX_RETRIES`` rounds the layer stays un-acked and the
        failure is loud — corrupt SOURCE data must never converge to a
        successful run."""
        if src.inmem_data is None:
            return True  # no host bytes to hash (fabric HBM delivery)
        shard = src.meta.shard
        if shard:
            # A shard verifies over EXACTLY its range's bytes, against
            # the stamped RANGE digest — the full layer never has to be
            # held here (docs/sharding.md).
            s0, s_sz = shard_range(shard, src.data_size)
            view = memoryview(src.inmem_data)[s0:s0 + s_sz]
        else:
            view = memoryview(src.inmem_data)
        if self._verify_layer_digest(lid, view, shard=shard,
                                     codec=src.meta.codec):
            return True
        self._demote_corrupt_layer(lid)
        if self._bump_digest_retry(lid):
            log.error("re-opening layer after digest mismatch; "
                      "re-announcing for a re-plan", layerID=lid)
            self._request_replan()
        return False

    def handle_flow_retransmit(self, msg: FlowRetransmitMsg) -> None:
        import time as _time

        if self._fence_stale(msg):
            return
        t0 = _time.monotonic()
        log.info(
            "start sending layer",
            layer=msg.layer_id, dest=msg.dest_id, size=msg.data_size, rate=msg.rate,
        )
        # Elastic membership (docs/membership.md): a flow command for a
        # JUST-JOINED dest can overtake the roster notice carrying its
        # address (the handler pool doesn't order across message
        # types).  An unknown-peer failure here waits briefly for the
        # address to land instead of dropping the pair — re-sent
        # fragments from a mid-way retry are absorbed by interval
        # reassembly like any duplicate.
        for attempt in range(40):
            try:
                handle_flow_retransmit(
                    self.node, self.layers, self._lock,
                    lambda lid, dest: fetch_from_client(self.node, lid,
                                                        dest), msg,
                    revokes=self.revokes, codecs=self.codec_plane,
                )
                break
            except (ConnectionError, KeyError) as e:
                # Only the MISSING-ADDRESS case retries; a failure with
                # the dest already in the registry is a real defect (or
                # a dead peer) and must surface, not be masked by a 2 s
                # busy-wait.
                try:
                    unknown = (msg.dest_id
                               not in self.node.transport.addr_registry)
                except (AttributeError, TypeError):
                    unknown = False
                if not unknown:
                    raise
                if attempt == 39:
                    log.error("flow send dest unreachable past the "
                              "roster-wait budget; dropping (a re-plan "
                              "re-dispatches)", dest=msg.dest_id,
                              layerID=msg.layer_id, err=repr(e))
                    break
                trace.count("membership.roster_waits")
                _time.sleep(0.05)
        dur = _time.monotonic() - t0
        log.info(
            "finished sending layer",
            layer=msg.layer_id, dest=msg.dest_id,
            send_dur_ms=round(dur * 1000, 3),
            throughput_mibps=round(msg.data_size / max(dur, 1e-9) / (1 << 20), 2),
        )
