"""Hierarchical control: sub-leaders own a group's fan-out and fold its
control traffic upward (docs/hierarchy.md).

The flat control plane makes the leader touch every (dest, layer) pair:
it plans them all in one flow graph, receives every announce, every ack,
every heartbeat, and every metrics report.  At fleet scale both ends of
that are the ceiling — the solve grows with node count, and the leader's
message loop handles O(nodes) control traffic per layer.

This module is the scale-out: the fleet partitions into GROUPS, each
owned by a sub-leader (itself an ordinary receiver seat).  The root
plans delivery to group INGRESS nodes only (``sched/flow.py`` over
groups and the inter-group links); the sub-leader owns its members'
plan dispatch, ack/NACK aggregation, liveness, and telemetry fold,
reporting only aggregate coverage upward (``GroupStatusMsg``) — the
root handles O(groups) messages where the flat plane handled O(nodes).

Pieces:

- :func:`partition_groups` — deterministic auto-partition (explicit
  group declarations come from the config's ``Groups`` section).
- :class:`SubLeaderController` — attach to a receiver to make its seat
  a sub-leader: registers the member-facing handlers (announce / ack /
  heartbeat / metrics) on the receiver's already-running loop, fans
  each completed layer out to the members wanting it, and folds
  everything upward.
- The root half is :class:`~.leader.HierarchicalFlowLeaderNode`
  (runtime/leader.py), which also owns the failover semantics: a dead
  sub-leader DISSOLVES its group back to flat delivery
  (``GroupPlanMsg(dissolve=True)`` to each member), and the group
  table rides the epoch-fenced ``ControlDeltaMsg`` replication so a
  promoted standby keeps the hierarchy.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional

from ..core.types import (
    LayerID,
    NodeID,
    codec_accepts,
    delivered,
    satisfies,
    shard_covers,
    shard_range,
)
from ..sched.flow import chain_forward_roles
from ..transport.messages import (
    AckMsg,
    AnnounceMsg,
    BootReadyMsg,
    GroupPlanMsg,
    GroupStatusMsg,
    HeartbeatMsg,
    MetricsReportMsg,
    SwapCommitMsg,
)
from ..utils import telemetry, threads, trace
from ..utils.logging import log
from .failure import FailureDetector
from .send import send_layer

# How often a sub-leader re-drives unacked member sends (the safety net
# under event-driven fan-out: a send eaten by a partition window or a
# member restart is re-sent instead of waiting on root-level recovery).
GROUP_RESEND_S = float(os.environ.get("DLD_GROUP_RESEND_S", "2.0"))
# Debounce for folding member announces into one upward aggregate: a
# fleet announcing at start collapses into ~one message per group.
ANNOUNCE_FOLD_S = float(os.environ.get("DLD_GROUP_ANNOUNCE_FOLD_S", "0.1"))
# Chain fan-out (docs/hierarchy.md): first dispatch of a layer wanted by
# ≥2 members rides a K-striped member-to-member chain, so the
# sub-leader's egress is O(model_bytes) instead of O(model_bytes × R).
# Off degrades to the pre-chain star.  The REDRIVE pass always sends
# direct — that is the convergence guarantee for legacy members (which
# ignore forward roles) and the repair path around dead hops.
GROUP_CHAIN = (os.environ.get("DLD_GROUP_CHAIN", "1").lower()
               not in ("0", "false", "off"))
GROUP_STRIPES = max(1, int(os.environ.get("DLD_GROUP_STRIPES", "4")))


def partition_groups(node_ids: List[NodeID],
                     group_size: int = 0) -> Dict[int, dict]:
    """Deterministic auto-partition of ``node_ids`` into groups:
    ``{gid: {"leader": sub_leader_id, "members": [...]}}`` (the
    sub-leader is the group's first member).  ``group_size`` 0 sizes
    groups at ~sqrt(N), so both the root's group count and each
    sub-leader's member count grow as sqrt(N) — the balanced two-level
    split (root-handled traffic grows sub-linearly in N)."""
    ids = sorted(int(n) for n in node_ids)
    if not ids:
        return {}
    size = int(group_size) or max(2, math.isqrt(len(ids)))
    out: Dict[int, dict] = {}
    for gid, start in enumerate(range(0, len(ids), size)):
        chunk = ids[start:start + size]
        out[gid] = {"leader": chunk[0], "members": chunk}
    return out


def groups_from_config(spec, node_ids: List[NodeID],
                       leader_id: NodeID) -> Dict[int, dict]:
    """The config's ``Groups`` section → the group table.  Either an
    auto-partition request (``{"Size": K}``; 0 = sqrt sizing) over every
    non-root seat, or an explicit list of ``{"Leader": id, "Members":
    [...]}`` declarations.  The root is never grouped."""
    ids = [int(n) for n in node_ids if int(n) != int(leader_id)]
    if isinstance(spec, dict):
        return partition_groups(ids, int(spec.get("Size", 0) or 0))
    out: Dict[int, dict] = {}
    seen: set = set()
    known = set(ids)
    for gid, rec in enumerate(spec or []):
        sub = int(rec["Leader"])
        members = sorted({int(m) for m in rec.get("Members") or []} | {sub})
        if int(leader_id) in members:
            raise ValueError("the root leader cannot be a group member")
        unknown = set(members) - known
        if unknown:
            # Fail at CONFIG time like every other topology error — a
            # hierarchy around a seat that doesn't exist would hang the
            # run (its members' ingress demand targets a dead address).
            raise ValueError(
                f"Groups names unknown node ids {sorted(unknown)}")
        overlap = seen & set(members)
        if overlap:
            raise ValueError(f"nodes {sorted(overlap)} appear in more "
                             "than one group")
        seen |= set(members)
        out[gid] = {"leader": sub, "members": members}
    return out


class SubLeaderController:
    """Make a receiver seat the sub-leader of one group.

    Attach AFTER the receiver's loop is running: the member-facing
    handlers (announce / ack / heartbeat / metrics report — message
    types a plain receiver never registers) go onto the same loop, and
    the receiver's ``on_layer_complete`` hook triggers fan-out the
    moment one of this seat's own layers completes.  Everything the
    members produce folds into cumulative ``GroupStatusMsg`` aggregates
    to whatever seat is currently the root (``node.leader_id`` — a
    takeover re-points it via the normal lease path, and the pending
    queue + the reply-to-every-``GroupPlanMsg`` rule reconcile the new
    root's view)."""

    def __init__(self, receiver, group_id: int, members: List[NodeID],
                 member_timeout: float = 0.0):
        self.receiver = receiver
        self.node = receiver.node
        self.group_id = int(group_id)
        self.members = [int(m) for m in members
                        if int(m) != self.node.my_id]
        self._lock = threading.Lock()
        self._active = True
        self._targets: Dict[NodeID, dict] = {}   # member -> {lid: meta}
        self._covered: Dict[LayerID, set] = {}   # lid -> members done
        # QUALIFIED coverage (shard/codec/version targets) is tracked
        # separately and NEVER pushed upward as ``covered`` — the root
        # synthesizes plain INMEM acks from that section, which would
        # erase the tags; qualified members ack the root verbatim (the
        # forwarded-ack path) and this set only stops re-sends.
        self._covered_q: Dict[LayerID, set] = {}
        self._announced: Dict[NodeID, dict] = {}  # member -> holdings
        self._member_digests: Dict[NodeID, dict] = {}  # member -> stamps
        self._member_codecs: Dict[NodeID, list] = {}  # member -> caps
        self._plan_epoch = -1
        self._announce_dirty: set = set()
        self._announce_timer: Optional[threading.Timer] = None
        self._dead: set = set()
        self._sent: Dict[tuple, float] = {}      # (member, lid) -> t
        self._member_metrics: Dict[NodeID, dict] = {}
        self._metrics_dirty = False
        self._metrics_since_push: set = set()
        self._stop = threading.Event()
        # Member liveness is the sub-leader's job now: a silent member
        # is reported upward as Dead (the root drops its pairs loudly),
        # never individually monitored by the root.
        self.detector = FailureDetector(member_timeout, self._member_dead)
        for m in self.members:
            self.detector.touch(m)
        loop = receiver.loop
        loop.register(GroupPlanMsg, self.handle_group_plan)
        loop.register(AnnounceMsg, self.handle_member_announce)
        loop.register(AckMsg, self.handle_member_ack)
        loop.register(HeartbeatMsg,
                      lambda msg: self.detector.touch(msg.src_id))
        loop.register(MetricsReportMsg, self.handle_member_metrics)
        # Root-bound member traffic the aggregate vocabulary doesn't
        # carry is FORWARDED verbatim: boot reports gate the root's
        # boot wait, and a member's swap confirm/query/error must reach
        # the rollout controller (the sub-leader handles leader-originated
        # swap roles itself — it can be a swap dest too).
        loop.register(BootReadyMsg, self._forward_to_root)
        loop.register(SwapCommitMsg, self._route_swap)
        receiver.on_layer_complete = self._on_own_layer
        self.detector.start()
        threading.Thread(target=self._redrive_loop, daemon=True,
                         name=f"subleader-redrive-{self.node.my_id}"
                         ).start()

    def close(self) -> None:
        self._stop.set()
        self.detector.stop()
        with self._lock:
            if self._announce_timer is not None:
                self._announce_timer.cancel()

    def drain(self, timeout: float = 2.0) -> None:
        """Bounded wait for every live member's final telemetry flush
        (receivers flush at startup, right before exiting a one-shot
        run) to arrive and fold upward — a sub-leader exiting the
        moment ITS startup lands would otherwise race its members'
        flushes and the root's run report would miss them.  Anything
        still dirty at the deadline is pushed as-is.  With the
        telemetry plane disabled members never report, so there is
        nothing to wait for."""
        from ..utils import telemetry

        if not telemetry.enabled():
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                live = {m for m in self.members if m not in self._dead}
                settled = (not self._metrics_dirty
                           and set(self._member_metrics) >= live)
            if settled:
                return
            time.sleep(0.05)
        self._push_metrics_if_dirty()

    # ------------------------------------------------------ root-facing

    def _push(self, **sections) -> None:
        """One aggregate upward.  Rides the receiver's leader-routed
        send, so a root lost to a failover window queues the report and
        the takeover lease flushes it."""
        msg = GroupStatusMsg(self.node.my_id, self.group_id, **sections)
        self.receiver._send_to_leader(msg)

    def _covered_snapshot_locked(self) -> Dict[LayerID, list]:
        return {lid: sorted(members)
                for lid, members in self._covered.items() if members}

    def _covered_spans(self, covered: Dict[LayerID, list]) -> dict:
        """The advisory span map riding a coverage push (docs/
        observability.md): each covered (member, layer)'s fan-out child
        span id — deterministic, so the root's synthesized acks file
        ``acked`` events on the members' own spans."""
        return {lid: {m: telemetry.span_id(m, lid) for m in members}
                for lid, members in covered.items()}

    def handle_group_plan(self, msg: GroupPlanMsg) -> None:
        if self.receiver._fence_stale(msg):
            return
        if msg.dissolve:
            # A root that declared THIS seat dead dissolved the group
            # (we are a zombie to it): stand down as sub-leader — stop
            # fan-out AND member liveness monitoring (members now
            # heartbeat the root; keeping the detector would dead-
            # report every one of them forever) — and follow the
            # member path: re-announce to the root.
            log.warn("sub-leader received dissolve; standing down",
                     group=self.group_id)
            with self._lock:
                self._active = False
                self._targets.clear()
            self.detector.stop()
            self.receiver.handle_group_plan(msg)
            return
        with self._lock:
            rearmed = not self._active
            self._active = True
            self._plan_epoch = msg.epoch
            self._targets = {int(m): dict(row)
                             for m, row in msg.targets.items()
                             if int(m) != self.node.my_id}
            # Elastic membership (docs/membership.md): the plan is the
            # root's authoritative member view — absorb seats it added
            # (joiners placed into this group) so liveness monitoring
            # and the announce/metrics flush gates cover them.
            for m in self._targets:
                if m not in self.members:
                    self.members.append(m)
                    self._dead.discard(m)
                    self.detector.touch(m)
            covered = self._covered_snapshot_locked()
        if rearmed:
            # A stood-down sub-leader whose group RE-FORMED (its seat
            # was re-admitted): member liveness re-arms with fan-out.
            self.detector.start()
        trace.count("hier.group_plans")
        log.info("group plan received", group=self.group_id,
                 members=sorted(self._targets),
                 layers=sorted({lid for row in msg.targets.values()
                                for lid in row}))
        # Receipt always answers with full cumulative coverage: this is
        # the reconcile channel a promoted root's first re-plan uses.
        self._push(covered=covered, spans=self._covered_spans(covered))
        self._fan_out_ready()

    # ---------------------------------------------------- member-facing

    def handle_member_announce(self, msg: AnnounceMsg) -> None:
        self.detector.touch(msg.src_id)
        if self.detector.is_dead(msg.src_id):
            self.detector.revive(msg.src_id)
        with self._lock:
            # A joiner the root placed here may announce before the
            # updated group plan lands: absorb it (docs/membership.md).
            if msg.src_id not in self.members:
                self.members.append(msg.src_id)
            self._dead.discard(msg.src_id)
            self._announced[msg.src_id] = dict(msg.layer_ids)
            # Digest fold (docs/membership.md): the member's announced
            # stamps ride the same debounce — they are what lets the
            # root verify a GROUPED joiner and promote it to a source.
            self._member_digests[msg.src_id] = dict(msg.digests or {})
            # Codec capability fold (docs/codec.md): an empty announce
            # is an authoritative revocation, exactly like the flat
            # path — the root must stop choosing quantized transfers
            # for a member that lost the capability with its config.
            self._member_codecs[msg.src_id] = [
                str(c) for c in (msg.codecs or [])]
            self._announce_dirty.add(msg.src_id)
            # A re-announce is a restart: its RAM holdings are whatever
            # the announce says now, so sends re-arm.
            for key in [k for k in self._sent if k[0] == msg.src_id]:
                del self._sent[key]
            for members in self._covered.values():
                members.discard(msg.src_id)
            for members in self._covered_q.values():
                members.discard(msg.src_id)
            for lid, meta in msg.layer_ids.items():
                want = self._targets.get(msg.src_id, {}).get(lid)
                held_ok = (satisfies(meta, want) if want is not None
                           else delivered(meta))
                if not held_ok:
                    continue
                if want is not None and (want.shard or want.codec
                                         or want.version):
                    self._covered_q.setdefault(lid, set()).add(msg.src_id)
                else:
                    self._covered.setdefault(lid, set()).add(msg.src_id)
            pending = set(self._announce_dirty)
        # This seat never member-announces to itself (its announce goes
        # to the root directly), so it must not count as a pending
        # announcer — with it in the set the immediate flush could
        # never fire and every fold would eat the full debounce.
        if pending >= set(m for m in self.members
                          if m not in self._dead
                          and m != self.node.my_id):
            self._flush_announces()
        else:
            with self._lock:
                if self._announce_timer is None:
                    self._announce_timer = threading.Timer(
                        ANNOUNCE_FOLD_S, self._flush_announces)
                    self._announce_timer.daemon = True
                    self._announce_timer.start()
        self._fan_out_ready()

    def _flush_announces(self) -> None:
        with self._lock:
            if self._announce_timer is not None:
                self._announce_timer.cancel()
                self._announce_timer = None
            dirty = {m: dict(self._announced.get(m) or {})
                     for m in self._announce_dirty}
            digests = {m: dict(self._member_digests.get(m) or {})
                       for m in self._announce_dirty
                       if self._member_digests.get(m)}
            codecs = {m: list(self._member_codecs.get(m) or [])
                      for m in self._announce_dirty
                      if m in self._member_codecs}
            self._announce_dirty.clear()
            covered = self._covered_snapshot_locked()
        if dirty:
            trace.count("hier.announce_folds")
            self._push(announced=dirty, covered=covered, digests=digests,
                       codecs=codecs)

    def handle_member_ack(self, msg: AckMsg) -> None:
        self.detector.touch(msg.src_id)
        if msg.shard or msg.version or msg.codec:
            # Qualified acks (sharded / versioned / codec holdings)
            # carry tags the aggregate vocabulary doesn't: forward the
            # ack VERBATIM so the root's swap fences and codec
            # bookkeeping keep full fidelity.  Locally it still settles
            # the member's chain/fan-out send when the tags match its
            # target — qualified coverage stops re-sends without ever
            # riding the plain ``covered`` section upward.
            with self._lock:
                want = self._targets.get(msg.src_id, {}).get(msg.layer_id)
                if (want is not None
                        and (msg.shard or "") == (want.shard or "")
                        and codec_accepts(msg.codec, want.codec)
                        and (not want.version
                             or msg.version == want.version)):
                    self._covered_q.setdefault(
                        msg.layer_id, set()).add(msg.src_id)
                    self._sent.pop((msg.src_id, msg.layer_id), None)
            trace.count("hier.acks_forwarded")
            self.receiver._send_to_leader(msg)
            return
        push = None
        with self._lock:
            done = self._covered.setdefault(msg.layer_id, set())
            if msg.src_id not in done:
                done.add(msg.src_id)
                self._sent.pop((msg.src_id, msg.layer_id), None)
                if self._layer_complete_locked(msg.layer_id):
                    push = self._covered_snapshot_locked()
        if push is not None:
            trace.count("hier.layer_folds")
            log.info("group layer fully covered; folding upward",
                     group=self.group_id, layerID=msg.layer_id)
            self._push(covered=push, spans=self._covered_spans(push))

    def handle_member_metrics(self, msg: MetricsReportMsg) -> None:
        self.detector.touch(msg.src_id)
        with self._lock:
            self._member_metrics[msg.src_id] = {
                "Counters": dict(msg.counters),
                "Gauges": dict(msg.gauges),
                "Links": dict(msg.links),
                # Hists and span events batch upward too (docs/
                # observability.md): the root's serve-p99 health view
                # and critical-path walk need the members' OWN data —
                # a grouped replica must not go silently blind to the
                # SLO guard or the span timeline.
                "Hists": {k: dict(h) for k, h in msg.hists.items()},
                "Spans": [dict(ev) for ev in msg.spans],
                "T": msg.t_wall_ms, "Proc": msg.proc}
            self._metrics_dirty = True
            self._metrics_since_push.add(msg.src_id)
            live = {m for m in self.members if m not in self._dead}
            flush_now = self._metrics_since_push >= live
        if flush_now:
            # Every live member has reported since the last batch: push
            # NOW instead of waiting out the redrive tick — a short run
            # (receivers exit right after startup, having flushed their
            # final snapshots) would otherwise end before the batch
            # ever left, and the root's report would miss the members.
            self._push_metrics_if_dirty()

    def _forward_to_root(self, msg) -> None:
        """Pass a member's root-bound message upward verbatim (boot
        reports; the forwarded-ack path uses this too)."""
        self.detector.touch(msg.src_id)
        trace.count("hier.msgs_forwarded")
        self.receiver._send_to_leader(msg)

    def _route_swap(self, msg: SwapCommitMsg) -> None:
        """Leader-bound swap roles (confirm/query/error) from a member
        forward to the root; leader-ORIGINATED roles (prepare / commit
        / abort) are this seat's own business — the sub-leader can be
        a swap dest like any receiver."""
        if msg.applied or msg.query or msg.error:
            self._forward_to_root(msg)
            return
        self.receiver.handle_swap_commit(msg)

    def _member_dead(self, member: NodeID) -> None:
        with self._lock:
            self._dead.add(member)
            # Chain repair (docs/hierarchy.md): un-claim every uncovered
            # send of the layers the dead member targeted, so the next
            # event pass re-chains over the SURVIVORS — fresh forward
            # roles splice around the hole, and the re-seeded stripes
            # re-drive the dead seat's tail.  Downstream holes from
            # bytes it never forwarded heal via the members' gap-NACK
            # watchdogs against their upstream hop.
            lids = set(self._targets.get(member) or {})
            for key in [k for k in self._sent
                        if k[0] == member
                        or (k[1] in lids and not self._covered_done_locked(
                            k[1], k[0]))]:
                del self._sent[key]
            covered = self._covered_snapshot_locked()
        trace.count("hier.member_dead_reports")
        log.error("group member silent past timeout; reporting upward",
                  group=self.group_id, member=member)
        self._push(dead=[int(member)], covered=covered)
        self._fan_out_ready()

    # ----------------------------------------------------------- fan-out

    def _covered_done_locked(self, lid: LayerID, member: NodeID) -> bool:
        return (member in self._covered.get(lid, ())
                or member in self._covered_q.get(lid, ()))

    def _layer_complete_locked(self, lid: LayerID) -> bool:
        wanting = [m for m, row in self._targets.items()
                   if lid in row and m not in self._dead]
        return bool(wanting) and all(
            self._covered_done_locked(lid, m) for m in wanting)

    def _on_own_layer(self, lid: LayerID) -> None:
        self._fan_out_ready()

    def _fan_out_ready(self, resend_after: Optional[float] = None) -> None:
        """Deliver every held layer to every member still missing it.

        FIRST dispatch of a layer wanted by ≥2 members rides a
        K-striped member-to-member CHAIN (docs/hierarchy.md): forward
        roles install on the members, each stripe seeds at its head,
        and the rest of the bytes relay peer-to-peer — this seat's
        egress is the wire size once, not once per member.  Single
        wanters, chain-disabled runs, and every REDRIVE go direct — the
        redrive star is the convergence guarantee (legacy members that
        ignore roles, dead mid-chain hops, eaten sends).

        Pairs are claimed under ONE lock pass: two concurrent triggers
        (own-layer hook + plan receipt) must not both dispatch."""
        now = time.monotonic()
        due = []        # (member, lid, meta): direct sends
        fresh: Dict[LayerID, list] = {}  # lid -> [(member, meta)] chains
        with self._lock:
            if not self._active:
                return
            for member, row in self._targets.items():
                if member in self._dead:
                    continue
                for lid, meta in row.items():
                    if self._covered_done_locked(lid, member):
                        continue
                    t_sent = self._sent.get((member, lid))
                    if t_sent is not None and (
                            resend_after is None
                            or now - t_sent < resend_after):
                        continue
                    self._sent[(member, lid)] = now
                    if GROUP_CHAIN and t_sent is None:
                        fresh.setdefault(lid, []).append((member, meta))
                    else:
                        due.append((member, lid, meta))
        landed = False
        for lid in sorted(fresh):
            pairs = fresh[lid]
            if len(pairs) < 2:
                due.extend((m, lid, meta) for m, meta in pairs)
                continue
            with self.receiver._lock:
                held = lid in self.receiver.layers
            if held and self._dispatch_chain(lid, pairs):
                continue
            # Not servable (layer in flight / wrong form / members want
            # mixed forms): un-claim so the next trigger re-collects.
            with self._lock:
                for m, _ in pairs:
                    self._sent.pop((m, lid), None)
            if held:
                # A holding the chain cannot serve: mixed forms degrade
                # to star.
                self._fan_out_star(due=[], retry=pairs, lid=lid)
                continue
            # In flight: its landing fires the own-layer trigger, which
            # chains these pairs -- unless it landed while they were
            # claimed here and that trigger passed them over.  Then
            # chain them now: a first dispatch never falls to the star.
            with self.receiver._lock:
                landed = landed or lid in self.receiver.layers
        self._fan_out_star(due)
        if landed:
            self._fan_out_ready()

    def _fan_out_star(self, due, retry=None, lid=None) -> None:
        """The direct-send leg: dispatch each (member, lid, meta) whose
        target this seat's holding can serve, un-claiming the rest.
        ``retry``: mixed-form chain rejects re-dispatched per member —
        each pair re-claims individually so forms that DO serve
        star-send now instead of waiting out a redrive tick."""
        if retry:
            now = time.monotonic()
            with self._lock:
                for m, meta in retry:
                    if (m, lid) not in self._sent:
                        self._sent[(m, lid)] = now
                        due = due + [(m, lid, meta)]
        for member, lid, meta in due:
            with self.receiver._lock:
                layer = self.receiver.layers.get(lid)
            if layer is None or not self._holding_serves(layer, meta):
                # Not landed here yet (the root's plan is in flight), or
                # a holding in the WRONG form for this target (e.g. a
                # version-stamped rollout copy against a plain target):
                # un-claim so the next trigger re-collects it once a
                # servable copy exists.
                with self._lock:
                    self._sent.pop((member, lid), None)
                continue
            trace.count("hier.fanout_sends")
            trace.count("hier.subleader_egress_bytes", layer.data_size)
            log.info("fanning layer out to group member", layerID=lid,
                     member=member, group=self.group_id)
            threads.tx_pool().submit(self._send_one, member, lid, layer,
                                     meta)

    def _holding_serves(self, layer, meta) -> bool:
        """Whether this seat's holding can produce the exact bytes the
        member's target meta names (docs/hierarchy.md): the same
        encoded form (or raw + an encode-capable plane), a shard range
        the holding covers, and no version mismatch — a version-stamped
        copy serves only that version's targets (a plain target's
        digest gate would reject its bytes)."""
        held = layer.meta
        want_codec = meta.codec or ""
        if held.codec and held.codec != want_codec:
            return False
        if (want_codec and not held.codec
                and getattr(self.receiver, "codec_plane", None) is None):
            return False
        if not shard_covers(held.shard or "", meta.shard or ""):
            return False
        if (held.version or "") != (meta.version or ""):
            return False
        return True

    def _dispatch_chain(self, lid: LayerID, pairs) -> bool:
        """Plan + dispatch one layer's chain: forward roles to the
        members, stripe seeds to the heads.  False when the holding
        can't serve, or the members disagree on the target form (a
        chain ships ONE byte space; mixed forms fall back to star)."""
        forms = {(meta.shard or "", meta.codec or "", meta.version or "")
                 for _, meta in pairs}
        if len(forms) != 1:
            return False
        meta = pairs[0][1]
        with self.receiver._lock:
            layer = self.receiver.layers.get(lid)
        if layer is None or not self._holding_serves(layer, meta):
            return False
        want_codec = meta.codec or ""
        if want_codec and not layer.meta.codec:
            plane = getattr(self.receiver, "codec_plane", None)
            # Data-dependent forms (entropy, delta) size by their one
            # cached encode — the same blob the stripe sends then serve
            # ranges of (docs/codec.md).
            wire_total = (plane.ensure_sized(lid, layer, want_codec)
                          if plane else None)
            if wire_total is None:
                return False
        else:
            wire_total = layer.data_size
        lo, size = shard_range(meta.shard or "", wire_total)
        if size <= 0:
            return False
        members = sorted(m for m, _ in pairs)
        stripes = min(GROUP_STRIPES, len(members))
        heads, roles = chain_forward_roles(members, lo, size, stripes)
        epoch = self._plan_epoch
        trace.count("hier.chain_plans")
        trace.count("hier.subleader_egress_bytes", size)
        log.info("group chain planned", layerID=lid, group=self.group_id,
                 members=len(members), stripes=len(heads),
                 wire_bytes=size)
        for m, hops in sorted(roles.items()):
            if not hops:
                continue
            try:
                self.node.add_node(m)
                self.node.transport.send(m, GroupPlanMsg(
                    self.node.my_id, self.group_id, epoch=epoch,
                    forward={lid: [[a, b, nxt] for a, b, nxt in hops]}))
            except (OSError, KeyError, ConnectionError) as e:
                log.warn("chain role install failed (redrive will "
                         "star-send)", member=m, layerID=lid,
                         err=repr(e))
        for head, (a, b) in heads:
            threads.tx_pool().submit(self._send_range, head, lid, layer,
                                     meta, (a, b - a))
        return True

    def _send_range(self, member: NodeID, lid: LayerID, layer, meta,
                    rng) -> None:
        """One stripe seed: ship only the stripe's wire range to its
        head member; the chain relays the rest of the layer to it."""
        try:
            self.node.add_node(member)
            send_layer(self.node, member, lid, layer,
                       shard=meta.shard, codec=meta.codec,
                       codecs=getattr(self.receiver, "codec_plane", None),
                       span_parent=telemetry.span_id(self.node.my_id, lid),
                       wire_range=rng)
        except (OSError, KeyError, ConnectionError) as e:
            log.warn("chain stripe send failed (redrive will retry)",
                     layerID=lid, member=member, err=repr(e))

    def _send_one(self, member: NodeID, lid: LayerID, layer,
                  meta=None) -> None:
        try:
            self.node.add_node(member)
            # Span correlation (docs/observability.md): the fan-out is
            # a CHILD span chained under this seat's own (root-planned)
            # group-ingress pair — the parent tag rides the frames.
            # Qualified targets ship in their stamped byte space: the
            # shard/codec tags come from the member's target meta, and
            # the plane encode-serves a raw holding (docs/codec.md).
            send_layer(self.node, member, lid, layer,
                       shard=(meta.shard if meta is not None else ""),
                       codec=(meta.codec if meta is not None else ""),
                       codecs=getattr(self.receiver, "codec_plane", None),
                       span_parent=telemetry.span_id(self.node.my_id, lid))
        except (OSError, KeyError, ConnectionError) as e:
            log.warn("group fan-out send failed (redrive will retry)",
                     layerID=lid, member=member, err=repr(e))

    # ----------------------------------------------------------- redrive

    def _redrive_loop(self) -> None:
        interval = max(GROUP_RESEND_S / 2, 0.05)
        while not self._stop.wait(interval):
            try:
                self._fan_out_ready(resend_after=GROUP_RESEND_S)
                self._push_metrics_if_dirty()
            except Exception as e:  # noqa: BLE001 — keep the net up
                log.error("sub-leader redrive failed", err=repr(e))

    def _push_metrics_if_dirty(self) -> None:
        with self._lock:
            if not self._metrics_dirty:
                return
            self._metrics_dirty = False
            self._metrics_since_push.clear()
            batch = {m: dict(s) for m, s in self._member_metrics.items()}
        if batch:
            self._push(metrics=batch)
