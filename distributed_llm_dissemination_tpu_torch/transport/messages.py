"""Typed control-plane protocol messages.

Re-design of the reference's message layer
(``distributor/message.go``): the same protocol vocabulary —
announce / ack / retransmit / flowRetransmit / layer / clientReq / startup —
as plain dataclasses with symmetric JSON payload codecs.  Layer payloads are
never JSON-encoded: a ``LayerMsg`` travels as a JSON header followed by the
raw byte stream (message.go:286-287, transport.go:308-373).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Union

from ..core.types import (
    LayerID,
    LayerIDs,
    LayerLocation,
    LayerSrc,
    NodeID,
    layer_ids_from_json,
    layer_ids_to_json,
)


class MsgType(enum.IntEnum):
    """Wire message kinds (message.go:16-28)."""

    ANNOUNCE = 0
    ACK = 1
    LAYER = 2
    RETRANSMIT = 3
    FLOW_RETRANSMIT = 4
    CLIENT_REQ = 5
    STARTUP = 6
    SIMPLE = 7
    # Extensions beyond the reference enum (message.go:16-28):
    # HEARTBEAT — liveness beacon for the failure detector, which the
    # reference leaves TODO (crash(n node), node.go:218-220).
    # BOOT_READY — receiver booted its model from the disseminated layers;
    # the reference's startup handler is a stub (node.go:1387-1389), so it
    # has nothing to report back.
    # DEVICE_PLAN — pod-fabric transfer command: the layer bytes move as
    # device traffic (ICI), so the control plane replaces the reference's
    # per-transfer TCP byte stream (transport.go:267-274) with this one
    # small message.
    # SERVE — multi-controller pod serving: after the stage boots, every
    # member process enters one pipelined forward across the stages
    # (runtime/pp_serve.py).
    # BOOT_HINT — leader → assignee at distribution start: the blob ids
    # the dest will end up holding, so its boot programs can COMPILE
    # while the bytes are still on the wire (XLA needs only shapes).
    # GENERATE_REQ / GENERATE_RESP — post-boot inference service: a peer
    # sends prompt token ids, the booted node decodes with its RESIDENT
    # params and answers — the startup hook's engine, actually servable
    # over the same transport that delivered its weights.
    # PLAN_RESEND_REQ — SPMD-fabric self-healing: a process whose
    # executor detects a persistent seq gap (it never received some
    # DevicePlanMsg; later plans queue behind the hole, stalling the
    # pod lockstep) asks the leader for the missing seqs.  The leader
    # re-sends its retained copy — or a cancellation when it has none —
    # so no transfer waits forever on one lost control message.
    # LAYER_NACK — integrity plane (docs/integrity.md): a receiver whose
    # transport dropped a corrupt layer fragment (bad advisory CRC, or a
    # stale abandoned stripe group) asks the fragment's SOURCE for a
    # byte-range retransmit — bounded-retry, so one flipped wire bit
    # costs one fragment re-send instead of a crash-detection timeout.
    # LAYER_DIGESTS — leader → assignee at distribution start: the
    # self-describing digest (xxh3:<hex> / blake2b hex) of each layer
    # the dest will receive (collected from
    # the holders' announces), so completed layers are verified
    # end-to-end BEFORE they are acked or staged to a device.
    # LEADER_LEASE — control-plane HA (docs/failover.md): the leader's
    # liveness beacon, carrying the current EPOCH and the ordered
    # standby succession list.  Standbys and workers feed it to a
    # FailureDetector; on expiry the lowest-ranked live standby assumes
    # leadership at epoch+1 and its first lease at the higher epoch IS
    # the takeover announcement — workers re-point their leader and
    # re-announce (the reconcile channel).
    # CONTROL_DELTA — leader → standbys: one epoch-stamped control-state
    # delta (status row, ack, partial coverage, dropped assignment,
    # digest stamp, plan seq) or a full snapshot, applied to the
    # standby's shadow leader state so takeover starts from replicated
    # knowledge instead of a blank slate.
    # SOURCE_DEAD — leader → dest (mode 3): a mid-transfer SOURCE was
    # declared crashed; the dest must NACK its uncovered byte ranges of
    # the named layer to the surviving ``alt_id`` holder (the
    # byte-range retransmit plane) instead of waiting for a whole-layer
    # re-send — recovery costs only the dead source's unsent bytes.
    # METRICS_REPORT — telemetry plane (docs/observability.md): a node's
    # periodic run-scoped metric snapshot (counters + per-link flight
    # recorder + gauges), folded by the leader into the cluster table
    # that the -watch hook and the RUN_REPORT render.  Epoch-stamped so
    # a failed-over cluster fences reporters still pointing at a dead
    # leader's run view; omitted-field wire-compatible (every section is
    # optional, an empty report is a liveness-sized envelope).
    # TIME_SYNC — telemetry plane: the request/response clock-offset
    # probe.  A node sends its wall clock (t0) at announce time; the
    # answering leader echoes it with its own wall clock (t1); the node
    # estimates offset = t1 - (t0 + t2)/2 (NTP's midpoint) and LOGS it,
    # so cli/trace.py can line multi-host Perfetto timelines up on the
    # leader's clock without any cross-host time sync daemon.
    # JOB_SUBMIT / JOB_STATUS — the dissemination service plane
    # (docs/service.md): a submitter asks the long-lived leader daemon
    # to admit one dissemination job (a target Assignment + priority +
    # optional per-layer content digests for delta resolution); the
    # leader answers — and answers `-jobs` queries — with the admitted
    # job table (states, remaining pairs, drop counts).  Omitted-field
    # wire-compatible like every extension.
    # SWAP_COMMIT — zero-downtime weight swap (docs/swap.md): the
    # epoch-fenced commit fence of a ``kind="swap"`` job.  Once a
    # replica's full v2 layer set is digest-verified (every versioned
    # ack landed), the leader tells each serving node to atomically
    # flip its serving params to the staged v2 set; the node confirms
    # with ``applied=True``, re-requests a fence it suspects it missed
    # with ``query=True``, and reports an unrecoverable staging failure
    # (digest retries exhausted) via ``error`` — which aborts the swap
    # cluster-wide (``abort=True``: keep serving v1, release staged v2).
    # JOB_REVOKE — preemption revoke (docs/service.md): when a newly
    # admitted higher-priority job demotes a lower tier at the re-plan,
    # the leader revokes that job's not-yet-started queued sends at
    # each sender — the sender drops the pending (job, dest, layer)
    # pairs (counted on ``jobs.revoked_pairs``) instead of burning the
    # reclaimed link budget on superseded commands.
    # GROUP_PLAN / GROUP_STATUS — hierarchical control
    # (docs/hierarchy.md): the root leader partitions its fleet into
    # groups, each owned by a SUB-LEADER.  GROUP_PLAN (root →
    # sub-leader, epoch-fenced) hands the sub-leader its members'
    # delivery targets — the root plans the flow problem over group
    # INGRESS nodes only, and the sub-leader owns intra-group fan-out;
    # with ``dissolve`` it is instead sent root → member when the
    # sub-leader died, telling the member to re-point its control
    # parent at the root (the group degrades to flat).  GROUP_STATUS
    # (sub-leader → root) is the aggregate upward channel: cumulative
    # member coverage (one message per completed layer instead of one
    # ack per member), member announce inventories, member deaths, and
    # batched member telemetry snapshots — the root handles O(groups)
    # control messages where the flat plane handled O(nodes).
    # JOIN / DRAIN — elastic membership (docs/membership.md): the
    # topology stops being a config constant.  JOIN is four roles in one
    # type, disambiguated by its flags like SWAP_COMMIT: a REQUEST
    # (unconfigured node → leader: admit me — my dialable address and,
    # optionally, the layer ids I want; default = the current goal's
    # layer universe), the ADMIT reply (leader → joiner,
    # ``admitted=True``: your control parent — the root, or a sub-leader
    # when a grouped cluster placed you — re-point and announce there),
    # the ROSTER notice (leader → members, ``admitted=True`` +
    # ``node``/``addr``: a peer joined; register its address so a later
    # plan can command sends to it), and the RE-POINT notice (leader →
    # member, ``parent`` set: your control parent changed — a re-formed
    # group's members move back under their re-admitted sub-leader).
    # DRAIN is the planned-departure verbs: a REQUEST (node → leader:
    # drain me; or operator seat → leader with ``node`` naming the
    # drainer) and the DONE notice (leader → drainer + requester,
    # ``done=True``: your unique holdings are re-homed and you are out
    # of every liveness/lease/announce table — exiting now cannot fire
    # the crash path).
    # ROLLOUT_CTL — SLO-guarded fleet rollout pipeline (docs/rollout.md):
    # the operator channel of a ``kind="rollout"`` job.  A QUERY
    # (operator seat → leader) asks for the rollout table (wave states,
    # SLO verdicts, traffic split); PAUSE/RESUME gate the pipeline's
    # wave commits; ``split`` (>= 0) sets the leader-owned traffic-split
    # knob; the leader's reply carries ``table``.  The rollout RECORDS
    # themselves replicate via ControlDeltaMsg kind "rollout" + the
    # snapshot's Rollouts section — this message is only the operator
    # front door.
    # POLICY_CTL — closed-loop fleet autonomy (docs/autonomy.md): the
    # operator channel of the leader-side policy engine.  A QUERY
    # (operator seat → leader) asks for the policy table (armed rules,
    # cooldowns, quarantine mask, audit trail); ENABLE/DISABLE toggle
    # automatic actioning at runtime (token-gated — dropping a fleet to
    # manual is an operator act); the leader's reply carries ``table``.
    # The policy STATE itself replicates via ControlDeltaMsg kind
    # "policy" + the snapshot's Policy section — this message is only
    # the operator front door.
    HEARTBEAT = 8
    BOOT_READY = 9
    DEVICE_PLAN = 10
    SERVE = 11
    BOOT_HINT = 12
    GENERATE_REQ = 13
    GENERATE_RESP = 14
    PLAN_RESEND_REQ = 15
    LAYER_NACK = 16
    LAYER_DIGESTS = 17
    LEADER_LEASE = 18
    CONTROL_DELTA = 19
    SOURCE_DEAD = 20
    METRICS_REPORT = 21
    TIME_SYNC = 22
    JOB_SUBMIT = 23
    JOB_STATUS = 24
    SWAP_COMMIT = 25
    JOB_REVOKE = 26
    GROUP_PLAN = 27
    GROUP_STATUS = 28
    JOIN = 29
    DRAIN = 30
    ROLLOUT_CTL = 31
    POLICY_CTL = 32


def _epoch_to_payload(payload: dict, epoch: int) -> dict:
    """Stamp the leader EPOCH onto an envelope payload, omitted-field
    style: -1 (HA off / legacy peer) adds nothing, so the wire format is
    byte-identical to the pre-failover one unless HA is armed."""
    if epoch >= 0:
        payload["Epoch"] = int(epoch)
    return payload


@dataclasses.dataclass
class AnnounceMsg:
    """Receiver → leader: my initial layers + metadata (message.go:31-58).

    ``partial`` is an extension the reference doesn't have: covered byte
    ranges of checkpointed in-progress layers,
    ``{layer_id: {"Total": n, "Covered": [[s, e), ...]}}`` — the mode-3
    leader schedules only the gaps (checkpoint/resume).

    ``digests`` (integrity plane, docs/integrity.md): self-describing
    hex digest (``xxh3:<hex>``, or bare blake2b hex)
    per announced full layer, ``{layer_id: hex}`` — the leader collects
    them and stamps each assignee's expected digests
    (``LayerDigestsMsg``) so delivered layers verify end-to-end.
    Advisory and omitted when empty (digests disabled, or the bytes are
    client-held and unreadable here).

    ``codecs`` (docs/codec.md): the wire codecs this node can DECODE
    (and encode-serve) — the capability half of the codec negotiation.
    The leader only ever chooses a quantized transfer for a dest that
    advertised the codec; pre-codec peers announce nothing and interop
    as raw.  Omitted when empty.

    ``nic_bw`` (docs/membership.md): this node's own modeled NIC rate
    in bytes/second — an unconfigured JOINER's announce carries its
    locally configured rate so the mode-3 leader can model the link
    honestly instead of pinning the most conservative configured value
    until an operator re-configures.  0 = unknown, omitted on the wire
    (every pre-membership announce)."""

    src_id: NodeID
    layer_ids: LayerIDs
    partial: dict = dataclasses.field(default_factory=dict)
    digests: dict = dataclasses.field(default_factory=dict)
    codecs: list = dataclasses.field(default_factory=list)
    nic_bw: int = 0

    msg_type = MsgType.ANNOUNCE

    def to_payload(self) -> dict:
        payload = {
            "SrcID": self.src_id,
            "LayerIDs": layer_ids_to_json(self.layer_ids),
        }
        if self.partial:
            payload["Partial"] = {
                str(lid): info for lid, info in self.partial.items()
            }
        if self.digests:
            payload["Digests"] = {
                str(lid): str(d) for lid, d in self.digests.items()
            }
        if self.codecs:
            payload["Codecs"] = [str(c) for c in self.codecs]
        if self.nic_bw:
            payload["NicBw"] = int(self.nic_bw)
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "AnnounceMsg":
        return cls(
            src_id=int(d["SrcID"]),
            layer_ids=layer_ids_from_json(d.get("LayerIDs") or {}),
            partial={
                int(lid): info for lid, info in (d.get("Partial") or {}).items()
            },
            digests={
                int(lid): str(h)
                for lid, h in (d.get("Digests") or {}).items()
            },
            codecs=[str(c) for c in d.get("Codecs") or []],
            nic_bw=int(d.get("NicBw", 0)),
        )


@dataclasses.dataclass
class AckMsg:
    """Receiver → leader: layer landed (message.go:62-91).

    ``shard`` (docs/sharding.md): the delivered shard spec — a dest
    whose target was a byte-range slice acks at SHARD coverage, and the
    leader records the holding as partial (a shard-holder never
    satisfies a full-layer demand).  "" = whole layer, omitted on the
    wire (legacy format unchanged).

    ``version`` (docs/swap.md): the rollout version the delivered
    layer was stamped with (``LayerDigestsMsg.versions``) — the leader
    records the holding version-qualified, so a v2 swap pair is only
    ever completed by bytes verified under v2, and the swap commit
    fence knows exactly when a replica's v2 set is whole.  "" =
    unversioned (every pre-swap ack), omitted on the wire.

    ``codec`` (docs/codec.md): the wire-codec form the delivered bytes
    are in ("" = canonical) — the leader records the holding
    codec-qualified, so a quantized copy can never be mistaken for (or
    satisfy) a raw demand, and can be re-planned as a SOURCE only for
    same-codec transfers.  Omitted on the wire at default."""

    src_id: NodeID
    layer_id: LayerID
    location: LayerLocation = LayerLocation.INMEM
    shard: str = ""
    version: str = ""
    codec: str = ""
    # Advisory pair-lifecycle span id (docs/observability.md): the span
    # this delivery's receiver-side events filed under, echoed so the
    # leader's ``acked`` event correlates without re-derivation.  ""
    # (every pre-span peer) omits the key — the legacy wire format.
    span_id: str = ""

    msg_type = MsgType.ACK

    def to_payload(self) -> dict:
        payload = {
            "SrcID": self.src_id,
            "LayerID": self.layer_id,
            "Location": int(self.location),
        }
        if self.shard:
            payload["Shard"] = str(self.shard)
        if self.version:
            payload["Version"] = str(self.version)
        if self.codec:
            payload["Codec"] = str(self.codec)
        if self.span_id:
            payload["SpanId"] = str(self.span_id)
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "AckMsg":
        return cls(
            src_id=int(d["SrcID"]),
            layer_id=int(d["LayerID"]),
            location=LayerLocation(d.get("Location", 0)),
            shard=str(d.get("Shard", "")),
            version=str(d.get("Version", "")),
            codec=str(d.get("Codec", "")),
            span_id=str(d.get("SpanId", "")),
        )


def _job_to_payload(payload: dict, job_id: str) -> dict:
    """Stamp the dissemination-job tag, omitted-field style: the base
    single-run goal ("" — every pre-service run) adds nothing, so the
    wire format is byte-identical unless a job plane is active."""
    if job_id:
        payload["Job"] = str(job_id)
    return payload


@dataclasses.dataclass
class RetransmitMsg:
    """Leader → owner: forward your copy of a layer to dest
    (message.go:94-118).  ``epoch``: the issuing leader's fencing epoch
    (docs/failover.md); -1 = HA off.  ``job_id``: the admitted job this
    forward serves (docs/service.md; "" = the base run).  ``shard``
    (docs/sharding.md): forward only this shard's byte range ("" = the
    whole layer; omitted on the wire — a legacy owner ships the full
    layer, which still covers the target).  ``codec`` (docs/codec.md):
    ship the layer in this wire-codec form (the owner encodes its raw
    copy, or serves an already-encoded same-codec holding verbatim);
    "" = canonical bytes, omitted on the wire."""

    src_id: NodeID
    layer_id: LayerID
    dest_id: NodeID
    epoch: int = -1
    job_id: str = ""
    shard: str = ""
    codec: str = ""

    msg_type = MsgType.RETRANSMIT

    def to_payload(self) -> dict:
        payload = _job_to_payload(_epoch_to_payload(
            {"SrcID": self.src_id, "LayerID": self.layer_id,
             "DestID": self.dest_id}, self.epoch), self.job_id)
        if self.shard:
            payload["Shard"] = str(self.shard)
        if self.codec:
            payload["Codec"] = str(self.codec)
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "RetransmitMsg":
        return cls(int(d["SrcID"]), int(d["LayerID"]), int(d["DestID"]),
                   int(d.get("Epoch", -1)), str(d.get("Job", "")),
                   str(d.get("Shard", "")), str(d.get("Codec", "")))


@dataclasses.dataclass
class FlowRetransmitMsg:
    """Leader → sender: partial-layer send command with a bandwidth budget
    (message.go:121-151).

    ``codec`` (docs/codec.md): the transfer's wire-codec form — the
    commanded byte range ``[offset, offset+data_size)`` then indexes the
    ENCODED blob (the sender encodes its raw copy once and serves
    ranges of the cached form, or serves a same-codec holding
    verbatim).  "" = canonical bytes, omitted on the wire — a legacy
    peer never sees the key.

    ``gen`` (docs/service.md): the leader plan generation that computed
    this command.  A revoke is keyed to the generation it revoked
    (``JobRevokeMsg.gen``); a replacing re-plan's command carries a
    NEWER generation and therefore survives a stale queued revoke — the
    close of the "wrong-eat race" (docs/service.md).  0 = pre-generation leader,
    omitted on the wire (legacy peers keep the old last-writer-wins
    semantics)."""

    src_id: NodeID
    layer_id: LayerID
    dest_id: NodeID
    data_size: int
    offset: int
    rate: int
    epoch: int = -1
    job_id: str = ""  # the admitted job this send serves ("" = base run)
    codec: str = ""
    gen: int = 0

    msg_type = MsgType.FLOW_RETRANSMIT

    def to_payload(self) -> dict:
        payload = _job_to_payload(_epoch_to_payload({
            "SrcID": self.src_id,
            "LayerID": self.layer_id,
            "DestID": self.dest_id,
            "DataSize": self.data_size,
            "Offset": self.offset,
            "Rate": self.rate,
        }, self.epoch), self.job_id)
        if self.codec:
            payload["Codec"] = str(self.codec)
        if self.gen:
            payload["Gen"] = int(self.gen)
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "FlowRetransmitMsg":
        return cls(
            int(d["SrcID"]),
            int(d["LayerID"]),
            int(d["DestID"]),
            int(d.get("DataSize", 0)),
            int(d.get("Offset", 0)),
            int(d.get("Rate", 0)),
            int(d.get("Epoch", -1)),
            str(d.get("Job", "")),
            str(d.get("Codec", "")),
            int(d.get("Gen", 0)),
        )


@dataclasses.dataclass
class LayerMsg:
    """A layer (or byte-range of one) in flight (message.go:154-190).

    Never JSON-serialized whole: the transport writes a ``LayerHeader``
    then streams the bytes.  ``total_size`` is the full layer size so a
    receiver can account partial transfers (mode 3).

    ``stripe_idx/stripe_n/stripe_off`` are ADVISORY stripe provenance
    (defaults = un-striped): a TCP sender may split one logical payload
    into N stripes riding N pooled data connections in parallel
    (``transport/tcp.py``); a receiving transport stamps the delivered
    fragment with which stripe it was.  Consumers never need them for
    correctness — each stripe is a well-formed byte-range fragment that
    the existing interval reassembly absorbs — they exist for logs,
    tests, and transport-level regrouping.

    ``crc``/``xxh3`` are the ADVISORY payload checksum (integrity
    plane): at most one is stamped — xxh3-64 where the ``xxhash``
    accelerator is importable, crc32 otherwise; both None means
    unstamped (a sender predating the fields, or ``DLD_WIRE_CRC=0``).
    Transports stamp it per frame on send and verify whichever is
    present on receive BEFORE delivery — consumers above the transport
    only ever see verified fragments.
    """

    src_id: NodeID
    layer_id: LayerID
    layer_src: LayerSrc
    total_size: int
    stripe_idx: int = 0
    stripe_n: int = 1
    stripe_off: int = 0
    crc: Optional[int] = None
    xxh3: Optional[int] = None
    # Dissemination-job tag (docs/service.md): which admitted job this
    # fragment serves ("" = the base run).  Advisory, telemetry-only —
    # the flight recorder splits link rows per job so overlapping jobs
    # stop sharing one undifferentiated counter pool.
    job_id: str = ""
    # Advisory shard-target tag (docs/sharding.md): the shard spec this
    # fragment serves ("" = a full-layer target).  Correctness rides the
    # byte ranges alone (offset/size are absolute layer coordinates
    # either way); the tag exists for logs and telemetry.
    shard: str = ""
    # Wire-codec tag (docs/codec.md): the encoded form this fragment's
    # bytes — and its offset/total coordinates — are in ("" = canonical
    # bytes, the pre-codec wire format).  Advisory like the stamp: the
    # dest's authoritative codec comes from the leader's digest-stamp
    # channel; the tag is the fallback identity when no stamp arrived
    # (digests disabled), so encoded bytes are never stored as raw.
    codec: str = ""
    # Advisory pair-lifecycle span correlation (docs/observability.md):
    # the span id this transfer's events file under, and — for a
    # sub-leader fan-out child — the PARENT span (the root-planned
    # group-ingress pair) the child chains beneath.  Both "" at default
    # and telemetry-only: a dropped tag only costs the receiver its
    # recomputation of the deterministic id.
    span_id: str = ""
    span_parent: str = ""

    msg_type = MsgType.LAYER


@dataclasses.dataclass
class LayerHeader:
    """Data-plane preamble (transport.go:47-54, sans the ``Offert`` typo).

    The ``stripe_*`` fields are ADVISORY and wire-compatible: an
    un-striped transfer omits them entirely (the payload is identical to
    the pre-striping wire format), and a peer that predates them sees
    each stripe as an ordinary byte-range fragment at its absolute
    ``offset`` — the existing fragment reassembly path absorbs it.  For
    striped frames, ``stripe_off`` is the stripe's byte offset WITHIN
    the original logical payload (so ``offset - stripe_off`` recovers
    the payload's base offset), ``stripe_span`` the payload's total
    bytes, and ``stripe_tid`` a sender-unique transfer id that groups
    the stripes of one logical send (a retry re-uses the id, so a
    half-landed stripe is simply overwritten).

    ``crc``/``xxh3`` are the ADVISORY checksum of exactly this frame's
    payload bytes (per stripe for striped transfers), omitted-field
    style like the ``stripe_*`` fields: at most one is stamped (xxh3-64
    where the ``xxhash`` accelerator is importable — ~6x the crc32 rate
    on this host — crc32 otherwise), an unstamped frame is
    byte-identical to the pre-CRC wire format, and a peer that predates
    the fields (or can't compute xxh3) ignores the stamp."""

    src_id: NodeID
    layer_id: LayerID
    layer_size: int
    total_size: int
    offset: int
    stripe_idx: int = 0
    stripe_n: int = 1
    stripe_off: int = 0
    stripe_span: int = 0
    stripe_tid: str = ""
    crc: Optional[int] = None
    xxh3: Optional[int] = None
    # Advisory dissemination-job tag (omitted when ""): lets the
    # receiving transport file this frame's bytes on the per-job link
    # row (docs/service.md).  A peer predating the field ignores it.
    job_id: str = ""
    # Advisory shard-target tag (omitted when ""; docs/sharding.md).
    shard: str = ""
    # Wire-codec tag (omitted when ""; docs/codec.md): the encoded form
    # this frame's payload — and byte coordinates — are in.
    codec: str = ""
    # Advisory span correlation tags (omitted when "";
    # docs/observability.md): the pair-lifecycle span this frame's
    # bytes serve, plus the parent span for sub-leader fan-out children.
    # A peer predating the fields ignores them.
    span_id: str = ""
    span_parent: str = ""

    def to_payload(self) -> dict:
        payload = {
            "SrcID": self.src_id,
            "LayerID": self.layer_id,
            "LayerSize": self.layer_size,
            "TotalSize": self.total_size,
            "Offset": self.offset,
        }
        if self.stripe_n > 1:
            payload["StripeIdx"] = self.stripe_idx
            payload["StripeN"] = self.stripe_n
            payload["StripeOff"] = self.stripe_off
            payload["StripeSpan"] = self.stripe_span
            payload["StripeTid"] = self.stripe_tid
        if self.crc is not None:
            payload["Crc"] = int(self.crc)
        if self.xxh3 is not None:
            payload["Xxh3"] = int(self.xxh3)
        if self.job_id:
            payload["Job"] = str(self.job_id)
        if self.shard:
            payload["Shard"] = str(self.shard)
        if self.codec:
            payload["Codec"] = str(self.codec)
        if self.span_id:
            payload["SpanId"] = str(self.span_id)
        if self.span_parent:
            payload["SpanParent"] = str(self.span_parent)
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "LayerHeader":
        return cls(
            int(d["SrcID"]),
            int(d["LayerID"]),
            int(d["LayerSize"]),
            int(d.get("TotalSize", 0)),
            int(d.get("Offset", 0)),
            int(d.get("StripeIdx", 0)),
            int(d.get("StripeN", 1)),
            int(d.get("StripeOff", 0)),
            int(d.get("StripeSpan", 0)),
            str(d.get("StripeTid", "")),
            int(d["Crc"]) if "Crc" in d else None,
            int(d["Xxh3"]) if "Xxh3" in d else None,
            str(d.get("Job", "")),
            str(d.get("Shard", "")),
            str(d.get("Codec", "")),
            str(d.get("SpanId", "")),
            str(d.get("SpanParent", "")),
        )


@dataclasses.dataclass
class ClientReqMsg:
    """Node → external client: stream me a layer (message.go:193-214)."""

    src_id: NodeID
    layer_id: LayerID
    save_disk: bool = False

    msg_type = MsgType.CLIENT_REQ

    def to_payload(self) -> dict:
        return {
            "SrcID": self.src_id,
            "LayerID": self.layer_id,
            "SaveDisk": self.save_disk,
        }

    @classmethod
    def from_payload(cls, d: dict) -> "ClientReqMsg":
        return cls(int(d["SrcID"]), int(d["LayerID"]), bool(d.get("SaveDisk", False)))


@dataclasses.dataclass
class StartupMsg:
    """Leader → all: assignment satisfied, boot the inference engine
    (message.go:217-241).  ``boot`` carries the LEADER's boot decision so
    one flag governs the whole run — a receiver can't be left booting (or
    skipping) while the leader expects the opposite."""

    src_id: NodeID
    boot: bool = True
    # Multi-controller serving will follow (a ServeMsg after all boots):
    # receivers must stay alive past ready() to enter the collective.
    serve: bool = False
    epoch: int = -1

    msg_type = MsgType.STARTUP

    def to_payload(self) -> dict:
        return _epoch_to_payload(
            {"SrcID": self.src_id, "Boot": self.boot, "Serve": self.serve},
            self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "StartupMsg":
        return cls(int(d["SrcID"]), bool(d.get("Boot", True)),
                   bool(d.get("Serve", False)), int(d.get("Epoch", -1)))


@dataclasses.dataclass
class SimpleMsg:
    """Free-form test message (message.go:244-270)."""

    src_addr: str
    payload_str: str

    msg_type = MsgType.SIMPLE

    def to_payload(self) -> dict:
        return {"SrcAddr": self.src_addr, "PayloadStr": self.payload_str}

    @classmethod
    def from_payload(cls, d: dict) -> "SimpleMsg":
        return cls(d.get("SrcAddr", ""), d.get("PayloadStr", ""))


@dataclasses.dataclass
class HeartbeatMsg:
    """Receiver → leader: I'm alive.  Extension beyond the reference
    (its failure handling is explicitly TODO, node.go:218-220)."""

    src_id: NodeID

    msg_type = MsgType.HEARTBEAT

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id}

    @classmethod
    def from_payload(cls, d: dict) -> "HeartbeatMsg":
        return cls(int(d["SrcID"]))


@dataclasses.dataclass
class BootReadyMsg:
    """Receiver → leader: model (or pipeline stage) booted from the
    delivered layers.  ``seconds`` is the receiver's blob-assembly +
    compile + first-forward wall time; ``kind`` is "full" or "stage"."""

    src_id: NodeID
    seconds: float = 0.0
    kind: str = ""

    msg_type = MsgType.BOOT_READY

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id, "Seconds": self.seconds, "Kind": self.kind}

    @classmethod
    def from_payload(cls, d: dict) -> "BootReadyMsg":
        return cls(int(d["SrcID"]), float(d.get("Seconds", 0.0)),
                   str(d.get("Kind", "")))


@dataclasses.dataclass
class BootHintMsg:
    """Leader → assignee, sent when distribution starts: the blob ids
    this dest's Assignment will deliver.  Purely advisory — the receiver
    uses it to lower + compile its boot programs (decode jits, the
    forward) on a background thread while the layer bytes are still in
    flight, so the post-startup boot hits warm caches and TTFT shrinks
    by the compile time.  Shapes are all XLA needs; the weights aren't.
    Losing or ignoring the hint costs nothing but the overlap."""

    src_id: NodeID
    blob_ids: list  # the dest's assigned blob ids
    epoch: int = -1

    msg_type = MsgType.BOOT_HINT

    def to_payload(self) -> dict:
        return _epoch_to_payload(
            {"SrcID": self.src_id,
             "BlobIDs": [int(b) for b in self.blob_ids]}, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "BootHintMsg":
        return cls(int(d["SrcID"]),
                   [int(b) for b in d.get("BlobIDs") or []],
                   int(d.get("Epoch", -1)))


@dataclasses.dataclass
class GenerateReqMsg:
    """Requester → booted node: decode ``max_new`` tokens after
    ``prompt`` (token ids) with the node's resident params and answer
    with a ``GenerateRespMsg`` echoing ``req_id``.  ``temperature`` 0 is
    greedy (deterministic); > 0 samples with ``seed`` (the same seed
    reproduces the same tokens).  ``src_id`` must be addressable by the
    serving node's transport (a topology node id, or the client role's
    id)."""

    src_id: NodeID
    req_id: int
    prompt: list  # token ids
    max_new: int
    temperature: float = 0.0
    seed: int = 0

    msg_type = MsgType.GENERATE_REQ

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id, "ReqID": self.req_id,
                "Prompt": [int(t) for t in self.prompt],
                "MaxNew": self.max_new,
                "Temperature": self.temperature, "Seed": self.seed}

    @classmethod
    def from_payload(cls, d: dict) -> "GenerateReqMsg":
        return cls(int(d["SrcID"]), int(d["ReqID"]),
                   [int(t) for t in d.get("Prompt") or []],
                   int(d.get("MaxNew", 0)),
                   float(d.get("Temperature", 0.0)),
                   int(d.get("Seed", 0)))


@dataclasses.dataclass
class GenerateRespMsg:
    """Booted node → requester: the decoded token ids (or why not)."""

    src_id: NodeID
    req_id: int
    tokens: list = dataclasses.field(default_factory=list)
    error: str = ""

    msg_type = MsgType.GENERATE_RESP

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id, "ReqID": self.req_id,
                "Tokens": [int(t) for t in self.tokens],
                "Error": self.error}

    @classmethod
    def from_payload(cls, d: dict) -> "GenerateRespMsg":
        return cls(int(d["SrcID"]), int(d["ReqID"]),
                   [int(t) for t in d.get("Tokens") or []],
                   str(d.get("Error", "")))


@dataclasses.dataclass
class ServeMsg:
    """Leader → all (multi-controller SPMD): the stage boots partition
    the model — every ``members`` process must now enter the SAME
    serving collective (``runtime/pp_serve.py``) with its resident stage
    weights: one pipelined forward, or (``gen`` > 0) a KV-cached greedy
    decode of ``gen`` tokens.  ``counts`` carries each member's stage
    depth (aligned with ``members``) so uneven partitions assemble
    identically on every process.  Non-members ignore it."""

    src_id: NodeID
    members: list  # stage-ordered node ids
    batch: int = 1
    seq_len: int = 16
    counts: list = dataclasses.field(default_factory=list)
    gen: int = 0  # >0: decode this many tokens instead of one forward
    epoch: int = -1

    msg_type = MsgType.SERVE

    def to_payload(self) -> dict:
        return _epoch_to_payload(
            {"SrcID": self.src_id,
             "Members": [int(m) for m in self.members],
             "Batch": self.batch, "SeqLen": self.seq_len,
             "Counts": [int(c) for c in self.counts],
             "Gen": self.gen}, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "ServeMsg":
        return cls(int(d["SrcID"]),
                   [int(m) for m in d.get("Members") or []],
                   int(d.get("Batch", 1)), int(d.get("SeqLen", 16)),
                   [int(c) for c in d.get("Counts") or []],
                   int(d.get("Gen", 0)), int(d.get("Epoch", -1)))


@dataclasses.dataclass
class DevicePlanMsg:
    """Leader → fabric participants: execute one layer transfer on the
    device data plane (``parallel/fabric.py``).

    ``layout`` is the plan's per-sender byte-range split,
    ``[(sender_id, offset, size), ...]`` — the same shape as a mode-3
    flow schedule's jobs (flow.go:193-211); modes 0-2 send a one-element
    layout (a single full-layer source).  Each listed sender uploads its
    range onto its own stage devices and publishes it under ``plan_id``;
    ``dest_id`` ingests every contribution over the fabric and acks.  The
    layer bytes themselves never touch the transport."""

    src_id: NodeID
    plan_id: str
    layer_id: LayerID
    dest_id: NodeID
    total_size: int
    layout: list  # [(sender_id, offset, size), ...]
    # Global plan order for the multi-controller SPMD fabric
    # (parallel/spmd_fabric.py): every process must enter the same
    # collective programs in the same order, so plans execute strictly by
    # seq.  An EMPTY layout with a seq is a cancellation — the leader
    # aborted dispatch mid-way and every process must advance past the
    # seq without entering a collective.  -1 = unordered (the in-process
    # FabricPlane ignores it).
    seq: int = -1
    # Plan batching (advisory): the leader groups same-dest, same-size
    # plans and stamps each member with one batch id + the member count;
    # the dest then finishes the whole group as ONE batched gather
    # (parallel.ingest.finalize_many) instead of N serial collectives.
    # Empty/1 = unbatched; receivers that predate the hint ignore it.
    batch_id: str = ""
    batch_n: int = 1
    # Pod-delivery gather (advisory, docs/fabric.md): the plan is the
    # on-mesh RECONSTRUCTION of a pod's NIC-delivered shards — every
    # node listed here keeps the gathered layer (not just ``dest_id``,
    # which is the lowest-id member, kept for legacy addressing).
    # Empty = a plain single-dest plan, omitted on the wire.
    pod: list = dataclasses.field(default_factory=list)
    epoch: int = -1

    msg_type = MsgType.DEVICE_PLAN

    def to_payload(self) -> dict:
        payload = {
            "SrcID": self.src_id,
            "PlanID": self.plan_id,
            "LayerID": self.layer_id,
            "DestID": self.dest_id,
            "TotalSize": self.total_size,
            "Layout": [[int(s), int(o), int(z)] for s, o, z in self.layout],
            "Seq": self.seq,
        }
        if self.batch_id:
            payload["BatchID"] = self.batch_id
            payload["BatchN"] = self.batch_n
        if self.pod:
            payload["Pod"] = [int(n) for n in self.pod]
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "DevicePlanMsg":
        return cls(
            int(d["SrcID"]),
            str(d["PlanID"]),
            int(d["LayerID"]),
            int(d["DestID"]),
            int(d.get("TotalSize", 0)),
            [(int(s), int(o), int(z)) for s, o, z in d.get("Layout") or []],
            int(d.get("Seq", -1)),
            str(d.get("BatchID", "")),
            int(d.get("BatchN", 1)),
            [int(n) for n in d.get("Pod") or []],
            int(d.get("Epoch", -1)),
        )


@dataclasses.dataclass
class PlanResendReqMsg:
    """Fabric process → leader: my SPMD executor is stalled on a seq gap
    — re-send (or cancel) these plan seqs.  See MsgType.PLAN_RESEND_REQ."""

    src_id: NodeID
    seqs: list  # missing plan sequence numbers, ascending

    msg_type = MsgType.PLAN_RESEND_REQ

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id, "Seqs": [int(s) for s in self.seqs]}

    @classmethod
    def from_payload(cls, d: dict) -> "PlanResendReqMsg":
        return cls(int(d["SrcID"]), [int(s) for s in d.get("Seqs") or []])


@dataclasses.dataclass
class LayerNackMsg:
    """Receiver → fragment source: the byte range ``[offset,
    offset+size)`` of ``layer_id`` arrived CORRUPT (advisory CRC
    mismatch) — or was abandoned mid-transfer (a TTL-pruned stripe
    group) — and was dropped before any accounting; please retransmit
    it.  ``src_id`` is the NACKing receiver (the retransmit's dest).
    Handled by every node that serves layers (leaders, retransmit
    receivers) with a bounded per-(dest, layer, range) retry budget —
    a persistently corrupt path must fail loudly, not livelock.

    ``codec`` (docs/codec.md): the wire-codec form of the transfer the
    NACK belongs to — offset/size/total then index the ENCODED blob,
    and the serving holder retransmits ranges of its cached encoded
    form.  "" = canonical bytes, omitted on the wire."""

    src_id: NodeID
    layer_id: LayerID
    offset: int
    size: int
    total_size: int = 0
    reason: str = "crc"  # "crc" | "drop" | "stale" | "digest"
    codec: str = ""

    msg_type = MsgType.LAYER_NACK

    def to_payload(self) -> dict:
        payload = {"SrcID": self.src_id, "LayerID": self.layer_id,
                   "Offset": self.offset, "Size": self.size,
                   "TotalSize": self.total_size, "Reason": self.reason}
        if self.codec:
            payload["Codec"] = str(self.codec)
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "LayerNackMsg":
        return cls(int(d["SrcID"]), int(d["LayerID"]),
                   int(d.get("Offset", 0)), int(d.get("Size", 0)),
                   int(d.get("TotalSize", 0)),
                   str(d.get("Reason", "crc")),
                   str(d.get("Codec", "")))


@dataclasses.dataclass
class LayerDigestsMsg:
    """Leader → assignee: the expected self-describing digest of each
    layer this
    dest will receive, ``{layer_id: hex}`` (collected from the holders'
    announces + the leader's own layers).  Advisory: a receiver verifies
    a completed layer against the digest BEFORE acking/staging it, and a
    mismatch re-opens the covered intervals (the layer is re-fetched)
    instead of acking corrupt bytes.  Layers without a digest (unstamped
    holder, digests disabled) verify by per-fragment CRC alone.

    Sharded targets (docs/sharding.md) ride this stamp too — it is the
    one leader→dest channel that precedes the bytes:

    - ``shards``: ``{layer_id: shard_spec}`` — the dest's target is
      THIS byte-range slice; its interval set is complete (and it acks)
      at shard coverage, not layer coverage.
    - ``range_digests``: ``{layer_id: hex}`` — the digest of exactly
      the dest's shard range, so a shard verifies end-to-end WITHOUT
      holding the full layer.  Stamped only when the leader can read
      the layer's bytes; absent, the shard verifies by per-fragment
      CRC alone (honest limit, docs/sharding.md).

    Versioned rollout targets (docs/swap.md) ride the stamp the same
    way: ``versions`` — ``{layer_id: version}`` — tells the dest which
    rollout version each assigned layer belongs to, so its ack (and
    its stored holding) carries the tag and the leader's swap fence
    can tell a v2 delivery from a stale copy under the same id.

    Wire-codec transfers (docs/codec.md) ride it too — the codec
    choice must precede the bytes: ``codecs`` — ``{layer_id: codec}``
    — tells the dest which encoded form each assigned layer will
    arrive in (interval accounting, journal, and NACK ranges then live
    in ENCODED byte space), and for those layers the ``digests`` entry
    is the CODEC-QUALIFIED digest — the hash of exactly the encoded
    bytes — so a quantized copy verifies (and acks) under its own byte
    identity and can never silently pass as a raw one.

    Fabric-assisted pod delivery (docs/fabric.md) rides the stamp the
    same way: ``pods`` — ``{layer_id: n}`` — tells the dest its shard
    target for the layer is one slice of an ``n``-way POD split (its
    rank is the ``@K`` of its shard spec); after per-range verification
    it feeds the shard into the on-mesh reconstruction and acks the
    FULL layer once the gathered tree verifies against the stamped
    full-layer (wire-form) digest, instead of acking at shard coverage.

    Content-delta transfers (docs/codec.md) stamp their base INSIDE
    the codec string — ``codecs[lid] = "delta:<base_digest_hex>"`` — so
    the choice, the byte space, and the base can never skew apart; the
    ``digests`` entry is then the digest of the encoded DELTA stream,
    and ``full_digests`` — ``{layer_id: hex}`` — carries the digest of
    the full RECONSTRUCTED form, which the dest verifies after applying
    the delta to its held base (and which its raw holding then vouches
    under).  Omitted for every non-delta layer.

    All omitted-at-default: an unsharded, unversioned, un-codec'd,
    un-pod run's stamp is byte-identical to the legacy format."""

    src_id: NodeID
    digests: dict  # {layer_id: hex digest}
    epoch: int = -1
    shards: dict = dataclasses.field(default_factory=dict)
    range_digests: dict = dataclasses.field(default_factory=dict)
    versions: dict = dataclasses.field(default_factory=dict)
    codecs: dict = dataclasses.field(default_factory=dict)
    pods: dict = dataclasses.field(default_factory=dict)
    full_digests: dict = dataclasses.field(default_factory=dict)

    msg_type = MsgType.LAYER_DIGESTS

    def to_payload(self) -> dict:
        payload = {"SrcID": self.src_id,
                   "Digests": {str(lid): str(h)
                               for lid, h in self.digests.items()}}
        if self.shards:
            payload["Shards"] = {str(lid): str(s)
                                 for lid, s in self.shards.items()}
        if self.range_digests:
            payload["RangeDigests"] = {
                str(lid): str(h)
                for lid, h in self.range_digests.items()}
        if self.versions:
            payload["Versions"] = {str(lid): str(v)
                                   for lid, v in self.versions.items()}
        if self.codecs:
            payload["WireCodecs"] = {str(lid): str(c)
                                     for lid, c in self.codecs.items()}
        if self.pods:
            payload["Pods"] = {str(lid): int(n)
                               for lid, n in self.pods.items()}
        if self.full_digests:
            payload["FullDigests"] = {
                str(lid): str(h)
                for lid, h in self.full_digests.items()}
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "LayerDigestsMsg":
        return cls(int(d["SrcID"]),
                   {int(lid): str(h)
                    for lid, h in (d.get("Digests") or {}).items()},
                   int(d.get("Epoch", -1)),
                   {int(lid): str(s)
                    for lid, s in (d.get("Shards") or {}).items()},
                   {int(lid): str(h)
                    for lid, h in (d.get("RangeDigests") or {}).items()},
                   {int(lid): str(v)
                    for lid, v in (d.get("Versions") or {}).items()},
                   {int(lid): str(c)
                    for lid, c in (d.get("WireCodecs") or {}).items()},
                   {int(lid): int(n)
                    for lid, n in (d.get("Pods") or {}).items()},
                   {int(lid): str(h)
                    for lid, h in (d.get("FullDigests") or {}).items()})


@dataclasses.dataclass
class LeaderLeaseMsg:
    """Leader → all: liveness lease + the fencing EPOCH + the ordered
    standby succession (docs/failover.md).  Standbys and workers feed it
    to a ``FailureDetector``; a lease at a HIGHER epoch from a different
    node is a completed takeover (workers re-point their leader and
    re-announce), and any control message below the highest epoch seen
    is fenced — a zombie ex-leader's plans are rejected, not raced.
    ``interval`` is the sender's advisory beacon period (receivers size
    their expiry off it when they have no config of their own)."""

    src_id: NodeID
    epoch: int
    standbys: list = dataclasses.field(default_factory=list)
    interval: float = 0.0

    msg_type = MsgType.LEADER_LEASE

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id, "Epoch": int(self.epoch),
                "Standbys": [int(s) for s in self.standbys],
                "Interval": float(self.interval)}

    @classmethod
    def from_payload(cls, d: dict) -> "LeaderLeaseMsg":
        return cls(int(d["SrcID"]), int(d.get("Epoch", 0)),
                   [int(s) for s in d.get("Standbys") or []],
                   float(d.get("Interval", 0.0)))


@dataclasses.dataclass
class ControlDeltaMsg:
    """Leader → standby: one epoch-stamped control-state delta (or a
    full ``snapshot``), applied to the standby's shadow leader state
    (``runtime/failover.ShadowLeaderState``).  ``kind`` names the
    mutation ("snapshot" | "status" | "ack" | "partial" | "crash" |
    "assignment" | "digests" | "startup" | "plan_seq" | "revive" |
    "metrics" | "base_assignment" | "job" | "job_done" — the last two
    carry the dissemination service's admitted-job records,
    docs/service.md — | "swap" | "rollout", the live-swap and
    rollout-pipeline records, docs/swap.md + docs/rollout.md — |
    "policy", the autonomy engine's full state REPLACE — armed rules,
    cooldowns, quarantine mask, in-flight actions — docs/autonomy.md);
    ``data`` is the
    kind-specific JSON payload; ``seq`` is a per-leader monotonic
    counter (diagnostics — the shadow is reconciliation-corrected at
    takeover, so ordering races only cost re-sent bytes, never
    correctness)."""

    src_id: NodeID
    epoch: int
    seq: int
    kind: str
    data: dict = dataclasses.field(default_factory=dict)

    msg_type = MsgType.CONTROL_DELTA

    def to_payload(self) -> dict:
        return {"SrcID": self.src_id, "Epoch": int(self.epoch),
                "Seq": int(self.seq), "Kind": self.kind,
                "Data": self.data}

    @classmethod
    def from_payload(cls, d: dict) -> "ControlDeltaMsg":
        return cls(int(d["SrcID"]), int(d.get("Epoch", 0)),
                   int(d.get("Seq", 0)), str(d.get("Kind", "")),
                   dict(d.get("Data") or {}))


@dataclasses.dataclass
class SourceDeadMsg:
    """Leader → dest (mode 3): the source ``dead_id`` of an in-flight
    transfer of ``layer_id`` was declared crashed.  The dest must NACK
    its UNCOVERED byte ranges of the layer to the surviving holder
    ``alt_id`` (the ``LayerNackMsg`` byte-range retransmit plane) —
    recovery then costs exactly the dead source's unsent bytes instead
    of a whole-layer re-send (docs/failover.md)."""

    src_id: NodeID
    layer_id: LayerID
    dead_id: NodeID
    alt_id: NodeID
    epoch: int = -1

    msg_type = MsgType.SOURCE_DEAD

    def to_payload(self) -> dict:
        return _epoch_to_payload(
            {"SrcID": self.src_id, "LayerID": self.layer_id,
             "DeadID": self.dead_id, "AltID": self.alt_id}, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "SourceDeadMsg":
        return cls(int(d["SrcID"]), int(d["LayerID"]), int(d["DeadID"]),
                   int(d["AltID"]), int(d.get("Epoch", -1)))


@dataclasses.dataclass
class MetricsReportMsg:
    """Node → leader: one run-scoped telemetry snapshot (docs/
    observability.md).  ``counters``/``gauges`` are flat name→number
    maps; ``links`` is ``{"src->dest": {field: number}}`` — the node's
    view of each link it touched (``utils/telemetry.py`` owns the field
    vocabulary and the rx/tx ownership split the leader folds by).
    Snapshots are CUMULATIVE for the run (the registry is run-scoped),
    so the leader's fold is replace-per-node — a lost report costs
    staleness, never skew, and a freshly promoted leader reconstructs
    the whole table from one report round.  ``epoch``: the leader epoch
    this reporter believes in (-1 = HA off); a failed-over leader fences
    reports from nodes still pointing at its dead predecessor."""

    src_id: NodeID
    counters: dict = dataclasses.field(default_factory=dict)
    gauges: dict = dataclasses.field(default_factory=dict)
    links: dict = dataclasses.field(default_factory=dict)
    t_wall_ms: float = 0.0
    epoch: int = -1
    # The reporter's process token (telemetry.PROC_TOKEN): co-resident
    # nodes share one registry, so the cluster counter fold counts one
    # snapshot per distinct token, not per node.  Omitted-field
    # compatible ("" = legacy reporter, counted per node).
    proc: str = ""
    # Fixed-bucket histograms (utils/telemetry.HIST_BUCKETS_MS):
    # ``{name: {"buckets": [...], "sum_ms": float, "n": int}}``.  Added
    # for the rollout pipeline's SLO guard (docs/rollout.md) — the
    # leader computes per-replica p99 serve latency from the shipped
    # buckets.  Omitted when empty (every pre-rollout reporter).
    hists: dict = dataclasses.field(default_factory=dict)
    # Pair-lifecycle span events (docs/observability.md): the node's
    # bounded span ring, cumulative like every other section — the
    # leader's fold is replace-per-node.  Omitted when empty (spans
    # disabled, or a pre-span reporter).
    spans: list = dataclasses.field(default_factory=list)
    # Advisory locally-detected health events (docs/observability.md):
    # a reporter MAY surface anomaly events for the leader's fleet
    # health timeline to ingest verbatim.  Nothing in this repo
    # populates it from plain receivers today — the timeline is
    # leader-derived — but the section rides the wire so aggregating
    # seats can.  Omitted when empty.
    health: list = dataclasses.field(default_factory=list)

    msg_type = MsgType.METRICS_REPORT

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id}
        if self.proc:
            payload["Proc"] = str(self.proc)
        if self.counters:
            payload["Counters"] = {str(k): int(v)
                                   for k, v in self.counters.items()}
        if self.gauges:
            payload["Gauges"] = {str(k): float(v)
                                 for k, v in self.gauges.items()}
        if self.links:
            payload["Links"] = {
                str(k): {str(f): v for f, v in row.items()}
                for k, row in self.links.items()
            }
        if self.hists:
            payload["Hists"] = {str(k): dict(h)
                                for k, h in self.hists.items()}
        if self.spans:
            payload["Spans"] = [dict(ev) for ev in self.spans]
        if self.health:
            payload["Health"] = [dict(ev) for ev in self.health]
        if self.t_wall_ms:
            payload["T"] = float(self.t_wall_ms)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "MetricsReportMsg":
        return cls(
            int(d["SrcID"]),
            {str(k): int(v)
             for k, v in (d.get("Counters") or {}).items()},
            {str(k): float(v)
             for k, v in (d.get("Gauges") or {}).items()},
            {str(k): dict(row)
             for k, row in (d.get("Links") or {}).items()},
            float(d.get("T", 0.0)),
            int(d.get("Epoch", -1)),
            str(d.get("Proc", "")),
            {str(k): dict(h) for k, h in (d.get("Hists") or {}).items()},
            [dict(ev) for ev in d.get("Spans") or []],
            [dict(ev) for ev in d.get("Health") or []],
        )


@dataclasses.dataclass
class TimeSyncMsg:
    """Clock-offset probe (docs/observability.md).  Request: a node
    sends its wall clock as ``t0_ms``.  Response (``reply=True``): the
    leader echoes ``t0_ms`` and stamps its own wall clock as ``t1_ms``;
    the requester, reading its clock again as t2, estimates
    ``offset = t1 - (t0 + t2) / 2`` — the leader-minus-me clock offset,
    assuming a symmetric path (the error bound is rtt/2, logged next to
    the estimate).  Purely advisory: nothing in the protocol consumes
    the offset; it exists so the LOGS carry enough to align multi-host
    trace timelines offline (cli/trace.py)."""

    src_id: NodeID
    t0_ms: float
    t1_ms: float = 0.0
    reply: bool = False

    msg_type = MsgType.TIME_SYNC

    def to_payload(self) -> dict:
        payload = {"SrcID": self.src_id, "T0": float(self.t0_ms)}
        if self.reply:
            payload["T1"] = float(self.t1_ms)
            payload["Reply"] = True
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "TimeSyncMsg":
        return cls(int(d["SrcID"]), float(d.get("T0", 0.0)),
                   float(d.get("T1", 0.0)), bool(d.get("Reply", False)))


@dataclasses.dataclass
class JobSubmitMsg:
    """Submitter → leader daemon: admit one dissemination job
    (docs/service.md).  ``assignment`` is the job's goal state (the
    single-run ``Assignment`` vocabulary — dest → layers it must end up
    holding); ``priority`` (higher preempts) and ``kind`` ("push" |
    "repair" | "ab" | ...) drive scheduling and reporting; ``digests``
    optionally names each layer's content stamp (``xxh3:<hex>``) so the
    content-addressed store ships only layers whose digest changed.
    Idempotent per ``job_id``: a retried submit returns the existing
    job's status.  The leader answers with a ``JobStatusMsg``.

    ``version``/``swap_base`` (docs/swap.md): a ``kind="swap"`` job
    names the rollout version it delivers and the blob-id base of the
    v2 set — v2 blob ``swap_base + slot`` carries model slot ``slot``,
    so the commit-time flip can map staged ids back to model blobs.

    ``auth`` (docs/service.md, admission control): the shared-secret
    job token.  A leader started with ``DLD_JOB_TOKEN`` set rejects
    (and counts) any submit whose token does not constant-time-compare
    equal; omitted on the wire when empty, so open clusters keep the
    legacy format.

    ``waves``/``slo``/``split`` (docs/rollout.md): a ``kind="rollout"``
    submission declares its staged wave plan — ``waves`` is an ordered
    list of replica-id subsets (canary first), ``slo`` the guard
    (``{"P99Ms": float, "MaxFailures": int, "SoakS": float}``), and
    ``split`` the initial traffic-split knob value.  All omitted at
    default: every pre-rollout submit keeps the legacy format."""

    src_id: NodeID
    job_id: str
    assignment: dict  # Assignment: {dest: {layer_id: LayerMeta}}
    priority: int = 0
    kind: str = "push"
    digests: dict = dataclasses.field(default_factory=dict)
    avoid: list = dataclasses.field(default_factory=list)
    epoch: int = -1
    version: str = ""
    swap_base: int = -1
    auth: str = ""
    waves: list = dataclasses.field(default_factory=list)
    slo: dict = dataclasses.field(default_factory=dict)
    # -1 = unset (the rollout driver applies its default); an EXPLICIT 0.0 is
    # a real operator choice (no eligible v2 traffic during soak) and
    # must ride the wire, so the sentinel mirrors RolloutCtlMsg.split.
    split: float = -1.0

    msg_type = MsgType.JOB_SUBMIT

    def to_payload(self) -> dict:
        payload = {
            "SrcID": self.src_id,
            "JobID": str(self.job_id),
            "Assignment": {str(n): layer_ids_to_json(r)
                           for n, r in self.assignment.items()},
        }
        if self.priority:
            payload["Priority"] = int(self.priority)
        if self.kind and self.kind != "push":
            payload["Kind"] = str(self.kind)
        if self.digests:
            payload["Digests"] = {str(l): str(d)
                                  for l, d in self.digests.items()}
        if self.avoid:
            payload["Avoid"] = [int(n) for n in self.avoid]
        if self.version:
            payload["Version"] = str(self.version)
        if self.swap_base >= 0:
            payload["SwapBase"] = int(self.swap_base)
        if self.auth:
            payload["Auth"] = str(self.auth)
        if self.waves:
            payload["Waves"] = [[int(n) for n in w] for w in self.waves]
        if self.slo:
            payload["SLO"] = dict(self.slo)
        if self.split >= 0:
            payload["Split"] = float(self.split)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "JobSubmitMsg":
        return cls(
            int(d["SrcID"]),
            str(d["JobID"]),
            {int(n): layer_ids_from_json(r or {})
             for n, r in (d.get("Assignment") or {}).items()},
            int(d.get("Priority", 0)),
            str(d.get("Kind", "push")),
            {int(l): str(h) for l, h in (d.get("Digests") or {}).items()},
            [int(n) for n in d.get("Avoid") or []],
            int(d.get("Epoch", -1)),
            str(d.get("Version", "")),
            int(d.get("SwapBase", -1)),
            str(d.get("Auth", "")),
            [[int(n) for n in w] for w in d.get("Waves") or []],
            dict(d.get("SLO") or {}),
            float(d.get("Split", -1.0)),
        )


@dataclasses.dataclass
class JobStatusMsg:
    """Job-table query/response (docs/service.md).  ``query=True`` asks
    the leader for the full admitted-job table; the response carries
    ``jobs`` — ``{job_id: summary}`` rows (``sched.jobs.Job.summary``:
    state, priority, remaining/total pairs, drop counts).  Also the
    leader's acknowledgement of a ``JobSubmitMsg`` (one row)."""

    src_id: NodeID
    jobs: dict = dataclasses.field(default_factory=dict)
    query: bool = False
    error: str = ""
    epoch: int = -1

    msg_type = MsgType.JOB_STATUS

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id}
        if self.query:
            payload["Query"] = True
        if self.jobs:
            payload["Jobs"] = {str(j): dict(row)
                               for j, row in self.jobs.items()}
        if self.error:
            payload["Error"] = str(self.error)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "JobStatusMsg":
        return cls(
            int(d["SrcID"]),
            {str(j): dict(row)
             for j, row in (d.get("Jobs") or {}).items()},
            bool(d.get("Query", False)),
            str(d.get("Error", "")),
            int(d.get("Epoch", -1)),
        )


@dataclasses.dataclass
class SwapCommitMsg:
    """The zero-downtime weight-swap fence (docs/swap.md) — one message
    type, four protocol roles, disambiguated by its flags:

    - **commit** (leader → serving node; no flags): every v2 layer of
      ``version`` verified on every replica — atomically flip the
      serving params to the staged v2 set (mapped ``blob = id -
      swap_base``) between decode steps, then release v1.  The leader
      re-sends an unconfirmed commit on a bounded watchdog, so a lost
      fence is re-delivered instead of leaving one node serving v1.
    - **prepare** (leader → serving node; ``prepare=True``, sent at
      swap-job admission): the version + blob mapping announcement —
      the node stages each v2 layer the moment it verifies, so the
      decode/device work overlaps the rollout's remaining transfers
      and the later flip is (headroom permitting) a pure pointer swap.
      Advisory: a lost prepare only costs the overlap — the commit
      carries the same mapping.
    - **abort** (leader → serving node; ``abort=True``): the rollout
      failed (digest mismatch, dest crash) — do NOT flip; release the
      staged v2 set and keep serving v1 uninterrupted.
    - **confirm** (node → leader; ``applied=True``): the flip (or the
      abort release) completed on this node.
    - **query** (node → leader; ``query=True``): this node staged its
      full v2 set but never saw the fence (it suspects a lost commit)
      — the leader answers with the operative commit/abort, so a node
      that missed the fence re-requests it instead of serving a stale
      version indefinitely.

    ``error`` (node → leader): an unrecoverable v2 staging failure
    (digest retry budget exhausted) — the leader aborts the swap.
    ``epoch``: leader fencing epoch (docs/failover.md); a promoted
    standby re-drives an adopted swap at its bumped epoch.

    Rollout-pipeline extensions (docs/rollout.md), omitted at default:

    - ``revert`` (with ``abort=True``): the abort targets a COMMITTED
      wave — the replica must roll its serving params BACK to the
      retained pre-flip tree (the SLO-breach rollback), where a plain
      abort of a committed version is refused.
    - ``finalize`` (leader → replica): the wave's soak verdict PASSED
      — release the retained pre-flip params (the rollback window is
      over).  Advisory: a lost finalize only costs retained memory
      until the next rollout."""

    src_id: NodeID
    version: str
    swap_base: int = -1
    abort: bool = False
    query: bool = False
    applied: bool = False
    prepare: bool = False
    error: str = ""
    epoch: int = -1
    revert: bool = False
    finalize: bool = False

    msg_type = MsgType.SWAP_COMMIT

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id,
                         "Version": str(self.version)}
        if self.swap_base >= 0:
            payload["SwapBase"] = int(self.swap_base)
        if self.abort:
            payload["Abort"] = True
        if self.query:
            payload["Query"] = True
        if self.applied:
            payload["Applied"] = True
        if self.prepare:
            payload["Prepare"] = True
        if self.error:
            payload["Error"] = str(self.error)
        if self.revert:
            payload["Revert"] = True
        if self.finalize:
            payload["Finalize"] = True
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "SwapCommitMsg":
        return cls(
            int(d["SrcID"]),
            str(d["Version"]),
            int(d.get("SwapBase", -1)),
            bool(d.get("Abort", False)),
            bool(d.get("Query", False)),
            bool(d.get("Applied", False)),
            bool(d.get("Prepare", False)),
            str(d.get("Error", "")),
            int(d.get("Epoch", -1)),
            bool(d.get("Revert", False)),
            bool(d.get("Finalize", False)),
        )


@dataclasses.dataclass
class JobRevokeMsg:
    """Leader → sender: a re-plan demoted a lower priority tier — drop
    the named job's queued-but-not-yet-started sends to these (dest,
    layer) pairs (docs/service.md).  Best-effort and advisory: a send
    already completed simply ignores the revocation (the registry entry
    is consumed on first match and TTL-bounded), and a send wrongly
    dropped is re-planned by the very re-plan that triggered the
    revoke.  Dropped pairs count on ``jobs.revoked_pairs``.

    ``gen``: the plan generation this revoke fences (docs/service.md) —
    the registry entry only eats commands stamped with ``gen`` <= this
    value, so the replacing re-plan's own (newer-generation) command
    can never be consumed by its stale revoke.  0 = pre-generation
    leader, omitted on the wire (legacy eat-anything semantics)."""

    src_id: NodeID
    job_id: str
    pairs: list = dataclasses.field(default_factory=list)  # [[dest, layer]]
    epoch: int = -1
    gen: int = 0

    msg_type = MsgType.JOB_REVOKE

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id, "JobID": str(self.job_id)}
        if self.pairs:
            payload["Pairs"] = [[int(d), int(l)] for d, l in self.pairs]
        if self.gen:
            payload["Gen"] = int(self.gen)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "JobRevokeMsg":
        return cls(
            int(d["SrcID"]),
            str(d["JobID"]),
            [[int(p[0]), int(p[1])] for p in d.get("Pairs") or []],
            int(d.get("Epoch", -1)),
            int(d.get("Gen", 0)),
        )


@dataclasses.dataclass
class GroupPlanMsg:
    """Root leader → sub-leader (docs/hierarchy.md): the group's member
    delivery targets.  Re-sent on every root re-plan — idempotent at
    the sub-leader (targets REPLACE; receipt also answers with a full
    cumulative ``GroupStatusMsg``, the takeover/reconcile poke).

    ``targets``: ``{member: {layer: LayerMeta json}}`` — what each
    member must end up holding.  The sub-leader fans a layer out to
    every member wanting it the moment its own copy completes.

    ``dissolve`` (root → MEMBER): the member's sub-leader was declared
    dead — re-point the control parent at ``src_id`` (the root) and
    re-announce there; the group degrades to flat delivery.  All other
    fields are omitted on a dissolve notice.

    ``forward`` (sub-leader → MEMBER, advisory): chain relay roles —
    ``{layer: [[lo, hi, next_member], ...]}`` byte ranges (in the
    transfer's wire byte space, i.e. the encoded blob for codec pairs)
    the receiving member forwards downstream the moment they land
    (docs/hierarchy.md).  Re-sent roles REPLACE per layer; an
    empty-list row clears that layer's roles.  A legacy member ignores
    the key and the sub-leader's redrive converges it by direct send.

    Epoch-fenced like every leader-originated control message: a
    zombie root's group plans are rejected, not raced."""

    src_id: NodeID
    group_id: int = 0
    targets: dict = dataclasses.field(default_factory=dict)
    dissolve: bool = False
    epoch: int = -1
    forward: dict = dataclasses.field(default_factory=dict)

    msg_type = MsgType.GROUP_PLAN

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id, "Group": int(self.group_id)}
        if self.targets:
            payload["Targets"] = {
                str(m): layer_ids_to_json(row)
                for m, row in self.targets.items()}
        if self.dissolve:
            payload["Dissolve"] = True
        if self.forward:
            payload["Forward"] = {
                str(lid): [[int(h[0]), int(h[1]), int(h[2])] for h in hops]
                for lid, hops in self.forward.items()}
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "GroupPlanMsg":
        return cls(
            src_id=int(d["SrcID"]),
            group_id=int(d.get("Group", 0)),
            targets={int(m): layer_ids_from_json(row or {})
                     for m, row in (d.get("Targets") or {}).items()},
            dissolve=bool(d.get("Dissolve", False)),
            epoch=int(d.get("Epoch", -1)),
            forward={int(lid): [[int(h[0]), int(h[1]), int(h[2])]
                                for h in hops or []]
                     for lid, hops in (d.get("Forward") or {}).items()},
        )


@dataclasses.dataclass
class GroupStatusMsg:
    """Sub-leader → root (docs/hierarchy.md): the aggregate upward
    channel — the root handles ONE message per group event where the
    flat plane handled one per member.

    ``covered``: cumulative ``{layer: [members]}`` — members whose copy
    of the layer completed (verified + acked to the sub-leader).
    CUMULATIVE on purpose: the root applies it as a set-union, so a
    report lost in a failover window is repaired by the next one (and
    by the reply every ``GroupPlanMsg`` receipt sends).

    ``announced``: ``{member: {layer: LayerMeta json}}`` — member
    announce inventories folded upward (pre-held layers reduce the
    group's ingress demand).

    ``dead``: members the sub-leader's own failure detector declared
    crashed; the root drops their pairs exactly like a direct crash.

    ``metrics``: batched member telemetry snapshots (``{member:
    {"Counters", "Gauges", "Links", "T", "Proc"}}``), folded into the
    root's cluster table like direct ``MetricsReportMsg`` reports.

    ``digests``: ``{member: {layer: digest}}`` — the members' announced
    digest inventories, folded with the same debounce as ``announced``.
    Advisory, but it is what lets the root digest-verify a GROUPED
    joiner and promote it to a source (docs/membership.md) — without
    it the aggregate fold left grouped joiners quarantined forever.

    ``codecs``: ``{member: [codec, ...]}`` — the members' announced
    wire-codec decode capabilities (docs/codec.md), folded with the
    same debounce.  An explicit empty list is a REVOCATION (a restarted
    member may have lost the capability with its config), mirroring the
    flat announce path; without this fold the root could never choose a
    quantized transfer for a grouped member, so codec-qualified pairs
    were forced to plan flat around the hierarchy.

    Every section is optional and omitted at default — a legacy peer
    decodes the required keys alone."""

    src_id: NodeID
    group_id: int = 0
    covered: dict = dataclasses.field(default_factory=dict)
    announced: dict = dataclasses.field(default_factory=dict)
    dead: list = dataclasses.field(default_factory=list)
    metrics: dict = dataclasses.field(default_factory=dict)
    digests: dict = dataclasses.field(default_factory=dict)
    codecs: dict = dataclasses.field(default_factory=dict)
    # Advisory span correlation for the aggregated coverage
    # (docs/observability.md): ``{layer: {member: span_id}}`` — the
    # sub-leader's fan-out child span per covered (member, layer), so
    # the root's ``acked`` events chain the members under the planned
    # group-ingress spans.  Omitted when empty (every pre-span peer).
    spans: dict = dataclasses.field(default_factory=dict)

    msg_type = MsgType.GROUP_STATUS

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id, "Group": int(self.group_id)}
        if self.covered:
            payload["Covered"] = {
                str(lid): [int(m) for m in members]
                for lid, members in self.covered.items()}
        if self.announced:
            payload["Announced"] = {
                str(m): layer_ids_to_json(row)
                for m, row in self.announced.items()}
        if self.dead:
            payload["Dead"] = [int(m) for m in self.dead]
        if self.metrics:
            payload["Metrics"] = {str(m): dict(snap)
                                  for m, snap in self.metrics.items()}
        if self.spans:
            payload["Spans"] = {
                str(lid): {str(m): str(s) for m, s in per.items()}
                for lid, per in self.spans.items()}
        if self.digests:
            payload["Digests"] = {
                str(m): {str(lid): str(dg) for lid, dg in row.items()}
                for m, row in self.digests.items()}
        if self.codecs:
            payload["Codecs"] = {str(m): [str(c) for c in caps]
                                 for m, caps in self.codecs.items()}
        return payload

    @classmethod
    def from_payload(cls, d: dict) -> "GroupStatusMsg":
        return cls(
            src_id=int(d["SrcID"]),
            group_id=int(d.get("Group", 0)),
            covered={int(lid): [int(m) for m in members]
                     for lid, members in (d.get("Covered") or {}).items()},
            announced={int(m): layer_ids_from_json(row or {})
                       for m, row in (d.get("Announced") or {}).items()},
            dead=[int(m) for m in d.get("Dead") or []],
            metrics={int(m): dict(snap)
                     for m, snap in (d.get("Metrics") or {}).items()},
            spans={int(lid): {int(m): str(s) for m, s in per.items()}
                   for lid, per in (d.get("Spans") or {}).items()},
            digests={int(m): {int(lid): str(dg) for lid, dg in row.items()}
                     for m, row in (d.get("Digests") or {}).items()},
            codecs={int(m): [str(c) for c in caps or []]
                    for m, caps in (d.get("Codecs") or {}).items()},
        )


@dataclasses.dataclass
class JoinMsg:
    """Elastic membership: the JOIN verb (docs/membership.md) — four
    protocol roles in one type (see MsgType.JOIN).

    - **request** (node → leader; no flags): admit ``src_id`` into the
      running cluster.  ``addr`` is the joiner's dialable transport
      address (the leader — and, via roster notices, every sender —
      installs it in its registry; an unconfigured seat is in nobody's
      config).  ``want`` optionally names the layer ids the joiner
      wants; empty = the current goal's full layer universe.
    - **admit** (leader → joiner; ``admitted=True``): admission
      confirmed at ``epoch``.  ``parent`` (>= 0) names the joiner's
      control parent — the root, or the sub-leader a grouped cluster
      placed it under (``parent_addr`` its address) — the joiner
      re-points its leader there and announces.
    - **roster** (leader → member; ``admitted=True`` + ``node``/
      ``addr``): peer ``node`` joined at ``addr`` — install the
      address so later plans can command sends to it.
    - **re-point** (leader → member; ``parent`` >= 0, ``node`` names
      the parent): your control parent changed (a dissolved group
      re-formed under its re-admitted sub-leader) — re-point and
      re-announce there.

    Epoch-fenced like every leader-originated notice: a zombie
    ex-leader's admits and re-points are rejected, not raced.  All
    extension fields are omitted at default — the request a legacy
    tool could mint is the minimal {SrcID} payload."""

    src_id: NodeID
    addr: str = ""
    want: list = dataclasses.field(default_factory=list)  # layer ids
    node: NodeID = -1  # subject of an admit/roster notice (-1 = src_id)
    admitted: bool = False
    parent: NodeID = -1  # control parent to re-point at (-1 = keep)
    parent_addr: str = ""
    error: str = ""
    epoch: int = -1

    msg_type = MsgType.JOIN

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id}
        if self.addr:
            payload["Addr"] = str(self.addr)
        if self.want:
            payload["Want"] = [int(l) for l in self.want]
        if self.node >= 0:
            payload["Node"] = int(self.node)
        if self.admitted:
            payload["Admitted"] = True
        if self.parent >= 0:
            payload["Parent"] = int(self.parent)
        if self.parent_addr:
            payload["ParentAddr"] = str(self.parent_addr)
        if self.error:
            payload["Error"] = str(self.error)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "JoinMsg":
        return cls(
            int(d["SrcID"]),
            str(d.get("Addr", "")),
            [int(l) for l in d.get("Want") or []],
            int(d.get("Node", -1)),
            bool(d.get("Admitted", False)),
            int(d.get("Parent", -1)),
            str(d.get("ParentAddr", "")),
            str(d.get("Error", "")),
            int(d.get("Epoch", -1)),
        )


@dataclasses.dataclass
class DrainMsg:
    """Elastic membership: the DRAIN verb (docs/membership.md) — a
    planned departure, never a crash.

    - **request** (node → leader; no flags): drain ``src_id`` —
      re-home my unique holdings onto survivors, then release me.  An
      OPERATOR seat drains another node by naming it in ``node``
      (the ``cli.main -drain NODE`` one-shot).
    - **done** (leader → drainer + requester; ``done=True``): ``node``'s
      unique holdings are re-homed and it is pruned from the failure
      detector, lease recipients, and announce gating — exiting now
      cannot fire the crash path.  ``error`` reports a refused drain
      (unknown node, the leader itself) instead of silence."""

    src_id: NodeID
    node: NodeID = -1  # the node to drain (-1 = src_id)
    done: bool = False
    error: str = ""
    epoch: int = -1

    msg_type = MsgType.DRAIN

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id}
        if self.node >= 0:
            payload["Node"] = int(self.node)
        if self.done:
            payload["Done"] = True
        if self.error:
            payload["Error"] = str(self.error)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "DrainMsg":
        return cls(
            int(d["SrcID"]),
            int(d.get("Node", -1)),
            bool(d.get("Done", False)),
            str(d.get("Error", "")),
            int(d.get("Epoch", -1)),
        )


@dataclasses.dataclass
class RolloutCtlMsg:
    """Operator ↔ leader channel of the SLO-guarded rollout pipeline
    (docs/rollout.md).  Request roles (operator seat → leader),
    disambiguated by flags like SWAP_COMMIT/JOIN:

    - **query** (``query=True``): answer with the rollout table —
      per-rollout wave states, SLO verdicts, the traffic-split knob,
      and the derived v1/v2 serving pools.
    - **pause** (``pause=True`` + ``rollout_id``): stop committing
      further waves (in-flight dissemination and soaks finish; nothing
      new flips).
    - **resume** (``resume=True`` + ``rollout_id``): re-arm a paused
      pipeline; a wave that was rolled back is re-disseminated as a
      retry wave job.
    - **set split** (``split`` >= 0 + ``rollout_id``): move the
      leader-owned traffic-split knob (the fraction of eligible
      traffic routed at v2 replicas during soak).

    The reply (leader → requester) carries ``table`` (and ``error``
    for refusals) — always ANSWERED, the serving invariant.

    ``auth``: the shared-secret job token (docs/service.md).  The
    MUTATING verbs — pause / resume / set-split — change what the
    fleet serves (resume re-submits a rolled-back wave's swap job), so
    a DLD_JOB_TOKEN-armed leader refuses them unauthenticated exactly
    like job submission; query stays open like ``-jobs``.  Omitted on
    the wire when empty."""

    src_id: NodeID
    rollout_id: str = ""
    query: bool = False
    pause: bool = False
    resume: bool = False
    split: float = -1.0
    table: dict = dataclasses.field(default_factory=dict)
    error: str = ""
    epoch: int = -1
    auth: str = ""

    msg_type = MsgType.ROLLOUT_CTL

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id}
        if self.rollout_id:
            payload["RolloutID"] = str(self.rollout_id)
        if self.query:
            payload["Query"] = True
        if self.pause:
            payload["Pause"] = True
        if self.resume:
            payload["Resume"] = True
        if self.split >= 0:
            payload["Split"] = float(self.split)
        if self.table:
            payload["Table"] = {str(k): dict(v)
                                for k, v in self.table.items()}
        if self.error:
            payload["Error"] = str(self.error)
        if self.auth:
            payload["Auth"] = str(self.auth)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "RolloutCtlMsg":
        return cls(
            int(d["SrcID"]),
            str(d.get("RolloutID", "")),
            bool(d.get("Query", False)),
            bool(d.get("Pause", False)),
            bool(d.get("Resume", False)),
            float(d.get("Split", -1.0)),
            {str(k): dict(v) for k, v in (d.get("Table") or {}).items()},
            str(d.get("Error", "")),
            int(d.get("Epoch", -1)),
            str(d.get("Auth", "")),
        )


@dataclasses.dataclass
class PolicyCtlMsg:
    """Operator seat ↔ leader: the autonomy engine's control channel
    (docs/autonomy.md).

    Verbs (operator seat → leader):

    - **query** (``query=True``): return the policy table — armed
      rules, enabled flag, cooldown deadlines, quarantine mask, and
      the recent audit trail of fired actions.
    - **enable** (``enable=True``) / **disable** (``disable=True``):
      toggle automatic actioning at runtime.  Disable is the soft
      kill-switch: rules keep evaluating (streaks/cooldowns stay
      warm) but no action fires until re-enabled.  The hard
      kill-switch is ``DLD_POLICY=0`` (env, overrides everything).

    The reply (leader → requester) carries ``table`` (and ``error``
    for refusals) — always ANSWERED, the serving invariant.

    ``auth``: the shared-secret job token (docs/service.md).  The
    MUTATING verbs — enable / disable — change whether the fleet acts
    on itself, so a DLD_JOB_TOKEN-armed leader refuses them
    unauthenticated exactly like job submission; query stays open like
    ``-jobs``.  Omitted on the wire when empty."""

    src_id: NodeID
    query: bool = False
    enable: bool = False
    disable: bool = False
    table: dict = dataclasses.field(default_factory=dict)
    error: str = ""
    epoch: int = -1
    auth: str = ""

    msg_type = MsgType.POLICY_CTL

    def to_payload(self) -> dict:
        payload: dict = {"SrcID": self.src_id}
        if self.query:
            payload["Query"] = True
        if self.enable:
            payload["Enable"] = True
        if self.disable:
            payload["Disable"] = True
        if self.table:
            payload["Table"] = dict(self.table)
        if self.error:
            payload["Error"] = str(self.error)
        if self.auth:
            payload["Auth"] = str(self.auth)
        return _epoch_to_payload(payload, self.epoch)

    @classmethod
    def from_payload(cls, d: dict) -> "PolicyCtlMsg":
        return cls(
            int(d["SrcID"]),
            bool(d.get("Query", False)),
            bool(d.get("Enable", False)),
            bool(d.get("Disable", False)),
            dict(d.get("Table") or {}),
            str(d.get("Error", "")),
            int(d.get("Epoch", -1)),
            str(d.get("Auth", "")),
        )


Message = Union[
    AnnounceMsg,
    AckMsg,
    RetransmitMsg,
    FlowRetransmitMsg,
    LayerMsg,
    ClientReqMsg,
    StartupMsg,
    SimpleMsg,
    HeartbeatMsg,
    BootReadyMsg,
    DevicePlanMsg,
    ServeMsg,
    PlanResendReqMsg,
    LayerNackMsg,
    LayerDigestsMsg,
    LeaderLeaseMsg,
    ControlDeltaMsg,
    SourceDeadMsg,
    MetricsReportMsg,
    TimeSyncMsg,
    JobSubmitMsg,
    JobStatusMsg,
    SwapCommitMsg,
    JobRevokeMsg,
    GroupPlanMsg,
    GroupStatusMsg,
    JoinMsg,
    DrainMsg,
    RolloutCtlMsg,
    PolicyCtlMsg,
]

_DECODERS = {
    MsgType.ANNOUNCE: AnnounceMsg,
    MsgType.ACK: AckMsg,
    MsgType.RETRANSMIT: RetransmitMsg,
    MsgType.FLOW_RETRANSMIT: FlowRetransmitMsg,
    MsgType.CLIENT_REQ: ClientReqMsg,
    MsgType.STARTUP: StartupMsg,
    MsgType.SIMPLE: SimpleMsg,
    MsgType.HEARTBEAT: HeartbeatMsg,
    MsgType.BOOT_READY: BootReadyMsg,
    MsgType.DEVICE_PLAN: DevicePlanMsg,
    MsgType.SERVE: ServeMsg,
    MsgType.BOOT_HINT: BootHintMsg,
    MsgType.GENERATE_REQ: GenerateReqMsg,
    MsgType.GENERATE_RESP: GenerateRespMsg,
    MsgType.PLAN_RESEND_REQ: PlanResendReqMsg,
    MsgType.LAYER_NACK: LayerNackMsg,
    MsgType.LAYER_DIGESTS: LayerDigestsMsg,
    MsgType.LEADER_LEASE: LeaderLeaseMsg,
    MsgType.CONTROL_DELTA: ControlDeltaMsg,
    MsgType.SOURCE_DEAD: SourceDeadMsg,
    MsgType.METRICS_REPORT: MetricsReportMsg,
    MsgType.TIME_SYNC: TimeSyncMsg,
    MsgType.JOB_SUBMIT: JobSubmitMsg,
    MsgType.JOB_STATUS: JobStatusMsg,
    MsgType.SWAP_COMMIT: SwapCommitMsg,
    MsgType.JOB_REVOKE: JobRevokeMsg,
    MsgType.GROUP_PLAN: GroupPlanMsg,
    MsgType.GROUP_STATUS: GroupStatusMsg,
    MsgType.JOIN: JoinMsg,
    MsgType.DRAIN: DrainMsg,
    MsgType.ROLLOUT_CTL: RolloutCtlMsg,
    MsgType.POLICY_CTL: PolicyCtlMsg,
}


def decode_msg(msg_type: MsgType, payload: dict) -> Message:
    """Envelope payload → typed message (message.go:280-301).  LAYER is
    intentionally absent: it is reconstructed by the transport from the
    binary stream, never JSON-decoded."""
    try:
        cls = _DECODERS[MsgType(msg_type)]
    except (KeyError, ValueError):
        raise ValueError(f"unknown MsgType: {msg_type}")
    return cls.from_payload(payload)


def src_of(msg: Message) -> Optional[NodeID]:
    """Originating node id, if the message carries one."""
    return getattr(msg, "src_id", None)
