"""The port's hierarchical control, on ``tests/test_hierarchy.py``'s cases.

The JAX package's hierarchy tests, run with the port's classes (the
port's ``runtime/hierarchy.py`` is a copy of the JAX module).
The JAX file's account of what the cases show:

What the tentpole demands:

- group partition + config parsing units, and populated wire
  round-trips for the two new messages;
- an inmem hierarchical delivery that is BYTE-EXACT end to end, where
  the root provably handles FEWER control messages than the same
  cluster run flat (the aggregate-upward property);
- sub-leader kill: the group DISSOLVES to flat delivery and the run
  still completes byte-exactly (digests verified by the receivers);
- the seeded chaos smoke with sub-leaders enabled: worker partitions +
  a mid-run ROOT kill — the promoted standby reconstructs the
  HIERARCHICAL leader from its shadow's group table and the run stays
  byte-exact;
- qualified (versioned/sharded/codec) member acks are forwarded
  VERBATIM, never lossily aggregated.
"""

import queue
import threading
import time

import pytest

from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation,
    LayerMeta,
)
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    HierarchicalFlowLeaderNode,
    Node,
    StandbyController,
    SubLeaderController,
    groups_from_config,
    partition_groups,
)
from distributed_llm_dissemination_tpu_torch.transport import reset_registry
from distributed_llm_dissemination_tpu_torch.transport.faults import (
    FaultRule,
    FaultyTransport,
    rules_from_spec,
)
from distributed_llm_dissemination_tpu_torch.transport.messages import (
    AckMsg,
    GroupPlanMsg,
    GroupStatusMsg,
    MsgType,
)
from distributed_llm_dissemination_tpu_torch.utils import trace

from test_torch_node import (
    close_all,
    layer_bytes,
    make_transports,
    mem_layer,
)

TIMEOUT = 15.0
HB = 0.1


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    yield
    reset_registry()


def _wait_for(cond, timeout=TIMEOUT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _handled(node_id):
    return trace.counter_totals().get(f"ctrl.handled.{node_id}", 0)


# ------------------------------------------------------------ unit pieces


def test_partition_groups_sqrt_sizing():
    groups = partition_groups(list(range(1, 17)))  # 16 nodes -> size 4
    assert len(groups) == 4
    all_members = [m for rec in groups.values() for m in rec["members"]]
    assert sorted(all_members) == list(range(1, 17))
    for rec in groups.values():
        assert rec["leader"] == rec["members"][0]


def test_partition_groups_explicit_size():
    groups = partition_groups([5, 1, 9, 3], group_size=2)
    assert groups == {0: {"leader": 1, "members": [1, 3]},
                      1: {"leader": 5, "members": [5, 9]}}


def test_groups_from_config_auto_and_explicit():
    auto = groups_from_config({"Size": 3}, [0, 1, 2, 3, 4, 5, 6], 0)
    assert all(0 not in rec["members"] for rec in auto.values())
    exp = groups_from_config(
        [{"Leader": 1, "Members": [1, 2]}, {"Leader": 3, "Members": [4]}],
        [0, 1, 2, 3, 4], 0)
    assert exp[0] == {"leader": 1, "members": [1, 2]}
    assert exp[1] == {"leader": 3, "members": [3, 4]}  # leader auto-joins
    with pytest.raises(ValueError):
        groups_from_config([{"Leader": 0, "Members": [1]}], [0, 1], 0)
    with pytest.raises(ValueError):
        groups_from_config([{"Leader": 1, "Members": [2]},
                            {"Leader": 3, "Members": [2]}], [0, 1, 2, 3], 0)


def test_group_messages_populated_roundtrip():
    plan = GroupPlanMsg(0, 3, {2: {7: LayerMeta()}, 4: {8: LayerMeta()}},
                        epoch=5)
    assert GroupPlanMsg.from_payload(plan.to_payload()) == plan
    dis = GroupPlanMsg(0, 3, dissolve=True, epoch=6)
    assert GroupPlanMsg.from_payload(dis.to_payload()) == dis
    status = GroupStatusMsg(
        2, 3, covered={7: [4, 5]}, announced={4: {9: LayerMeta()}},
        dead=[6], metrics={4: {"Counters": {"x": 1}, "T": 1.0}})
    assert GroupStatusMsg.from_payload(status.to_payload()) == status


def test_hierarchical_refuses_grouped_standby():
    ts, _ = make_transports("inmem", [0, 1, 2])
    try:
        with pytest.raises(ValueError):
            HierarchicalFlowLeaderNode(
                Node(0, 0, ts[0]), {}, {}, {0: 10 ** 9},
                groups={0: {"leader": 1, "members": [1, 2]}},
                standbys=[2], lease_interval=0.2, epoch=0,
                start_loop=False)
    finally:
        for t in ts.values():
            t.close()


# ----------------------------------------------------- hierarchy cluster rig


def _build_hier(n_groups, group_size, layer_ids, layer_size=24 * 1024,
                root_id=0, member_timeout=0.0, kind="inmem",
                **leader_kw):
    """Root ``root_id`` seeding ``layer_ids`` + ``n_groups`` groups of
    ``group_size`` (sub-leader = first member), every grouped seat an
    assignee of every layer."""
    ids = [root_id] + list(range(root_id + 1,
                                 root_id + 1 + n_groups * group_size))
    ts, _ = make_transports(kind, ids)
    groups = partition_groups(ids[1:], group_size=group_size)
    assignment = {i: {lid: LayerMeta() for lid in layer_ids}
                  for i in ids[1:]}
    layers = {lid: mem_layer(lid, layer_size) for lid in layer_ids}
    subs = {rec["leader"] for rec in groups.values()}
    leader = HierarchicalFlowLeaderNode(
        Node(root_id, root_id, ts[root_id]), layers, assignment,
        {i: 10 ** 9 for i in ids}, groups=groups,
        expected_nodes=subs, **leader_kw)
    recvs, ctls = {}, []
    for gid, rec in sorted(groups.items()):
        sub = rec["leader"]
        r = FlowRetransmitReceiverNode(Node(sub, root_id, ts[sub]), {},
                                       heartbeat_interval=HB)
        ctls.append(SubLeaderController(r, gid, rec["members"],
                                        member_timeout=member_timeout))
        recvs[sub] = r
        for m in rec["members"]:
            if m != sub:
                recvs[m] = FlowRetransmitReceiverNode(
                    Node(m, sub, ts[m]), {}, heartbeat_interval=HB)
    return leader, recvs, ctls, ts, groups, assignment


def _close_hier(leader, recvs, ctls, ts):
    for c in ctls:
        c.close()
    close_all(leader, list(recvs.values()), ts)


# --------------------------------------------------------------- e2e


def test_hierarchical_delivery_byte_exact_and_aggregated():
    """2 groups x 3 on inmem: every member byte-exact, completion via
    aggregates, and the ROOT handled strictly fewer control messages
    than the SAME cluster run flat (the whole point of the plane)."""
    size = 24 * 1024
    lids = [0, 1]

    # Flat reference run first (fresh counters per run).
    trace.reset_counters()
    ids = list(range(7))
    ts, _ = make_transports("inmem", ids)
    assignment = {i: {lid: LayerMeta() for lid in lids} for i in ids[1:]}
    flat = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {lid: mem_layer(lid, size) for lid in lids},
        assignment, {i: 10 ** 9 for i in ids},
        expected_nodes=set(ids[1:]))
    recvs = [FlowRetransmitReceiverNode(Node(i, 0, ts[i]), {},
                                        heartbeat_interval=HB)
             for i in ids[1:]]
    try:
        for r in recvs:
            r.announce()
        flat.start_distribution().get(timeout=TIMEOUT)
        flat.ready().get(timeout=TIMEOUT)
        flat_handled = _handled(0)
    finally:
        close_all(flat, recvs, ts)
    reset_registry()

    trace.reset_counters()
    leader, recvs, ctls, ts, groups, assignment = _build_hier(
        2, 3, lids, layer_size=size)
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        got = leader.ready().get(timeout=TIMEOUT)
        assert set(got) == set(assignment)
        for i, lid_map in assignment.items():
            for lid in lid_map:
                data = bytes(recvs[i].layers[lid].inmem_data)
                assert data == layer_bytes(lid, size), (i, lid)
        hier_handled = _handled(0)
        totals = trace.counter_totals()
        assert totals.get("hier.layer_folds", 0) >= len(groups) * len(lids)
        assert totals.get("hier.group_plans_sent", 0) >= len(groups)
        # The aggregate-upward property, measured: the root of the
        # hierarchical run handles strictly less control traffic than
        # the flat root of the SAME cluster.
        assert hier_handled < flat_handled, (hier_handled, flat_handled)
    finally:
        _close_hier(leader, recvs, ctls, ts)


def test_member_status_reaches_root_through_aggregates():
    """The root's status table gains member rows ONLY via GroupStatus
    folds — and the link-table delivered bytes reconcile with the goal
    (every member x layer delivered exactly once despite aggregation)."""
    from distributed_llm_dissemination_tpu_torch.utils import telemetry

    size = 16 * 1024
    telemetry.reset_run()
    leader, recvs, ctls, ts, groups, assignment = _build_hier(
        2, 2, [0], layer_size=size)
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        for m in assignment:
            held = leader.status.get(m, {}).get(0)
            assert held is not None and held.location == LayerLocation.INMEM
        # Byte-exact reconcile: delivered bytes across all links ==
        # goal bytes (4 dests x 1 layer), aggregation notwithstanding.
        links = telemetry.snapshot()["links"]
        delivered = sum(row.get("delivered_bytes", 0)
                        for key, row in links.items() if "#" not in key)
        assert delivered == len(assignment) * size, links
    finally:
        _close_hier(leader, recvs, ctls, ts)


class _LandsOnFirstLook(dict):
    """A receiver's layer table whose layer ``lid`` lands at the first
    look for it: the look still finds it absent, and the landing fires the
    seat's own-layer hook (as the receiver's ack does) while the pass that
    looked holds its members' claims."""

    def __init__(self, lid, layer, hook):
        super().__init__()
        self._landing = (lid, layer, hook)

    def _look(self, key):
        if self._landing is not None and key == self._landing[0]:
            lid, layer, hook = self._landing
            self._landing = None
            super().__setitem__(lid, layer)
            hook(lid)
            return False
        return True

    def __contains__(self, key):
        return self._look(key) and super().__contains__(key)

    def get(self, key, default=None):
        return super().get(key, default) if self._look(key) else default


def test_first_dispatch_chains_when_its_layer_lands_during_the_pass():
    """The fan-out race: a pass claims the members' pairs, finds the
    layer not yet held, and the layer lands meanwhile -- its own-layer
    trigger passes the claimed pairs over.  The first dispatch must
    still ride the chain, never the star."""
    ts, _ = make_transports("inmem", [1])
    sub = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    ctl = SubLeaderController(sub, 0, [1, 2, 3])
    ctl._stop.set()  # no redrive pass in between
    ctl.detector.stop()
    chained, starred = [], []

    def chain(lid, pairs):
        if sub.layers.get(lid) is None:
            return False
        chained.append((lid, sorted(m for m, _ in pairs)))
        return True

    ctl._dispatch_chain = chain
    ctl._send_one = lambda member, lid, layer, meta=None: starred.append(
        (member, lid))
    try:
        sub.layers = _LandsOnFirstLook(0, mem_layer(0, 1024),
                                       ctl._on_own_layer)
        with ctl._lock:
            ctl._targets = {2: {0: LayerMeta()}, 3: {0: LayerMeta()}}
        ctl._fan_out_ready()
        deadline = time.monotonic() + 1.0  # star sends go through a pool
        while not starred and time.monotonic() < deadline:
            time.sleep(0.01)
        assert chained == [(0, [2, 3])]
        assert starred == []
    finally:
        ctl.close()
        sub.close()
        for t in ts.values():
            t.close()


def test_qualified_member_ack_forwarded_verbatim():
    """A versioned/sharded/codec ack must reach the root UNAGGREGATED —
    the swap fence and codec bookkeeping need the tags."""
    ts, _ = make_transports("inmem", [0, 1, 2])
    root_q = ts[0].deliver()
    sub = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    ctl = SubLeaderController(sub, 0, [1, 2])
    try:
        versioned = AckMsg(2, 7, LayerLocation.INMEM, version="v2")
        ts[2].send(1, versioned)
        got = root_q.get(timeout=TIMEOUT)
        while not isinstance(got, AckMsg):
            got = root_q.get(timeout=TIMEOUT)
        assert got == versioned
        # A PLAIN ack aggregates instead: nothing forwarded verbatim.
        ts[2].send(1, AckMsg(2, 8, LayerLocation.INMEM))
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            try:
                msg = root_q.get(timeout=0.1)
            except queue.Empty:
                continue
            assert not isinstance(msg, AckMsg), "plain ack leaked upward"
    finally:
        ctl.close()
        sub.close()
        for t in ts.values():
            t.close()


# ---------------------------------------------------------- failover


def test_subleader_kill_dissolves_group_byte_exact():
    """Kill a sub-leader whose outbound LAYER frames were wedged (so
    its members provably got nothing from it): the root dissolves the
    group, members re-point flat, and delivery completes byte-exact."""
    size = 24 * 1024
    trace.reset_counters()
    ids = list(range(5))  # 0 root; groups [1,2] and [3,4]
    ts, _ = make_transports("inmem", ids)
    # Sub-leader 1's outbound layers vanish: its group can only ever
    # complete through dissolution.
    wedged = FaultyTransport(
        ts[1], [FaultRule("drop", "out", msg_type=MsgType.LAYER)], seed=1)
    groups = partition_groups(ids[1:], group_size=2)
    assert groups == {0: {"leader": 1, "members": [1, 2]},
                      1: {"leader": 3, "members": [3, 4]}}
    assignment = {i: {0: LayerMeta()} for i in ids[1:]}
    leader = HierarchicalFlowLeaderNode(
        Node(0, 0, ts[0]), {0: mem_layer(0, size)}, assignment,
        {i: 10 ** 9 for i in ids}, groups=groups,
        expected_nodes={1, 3}, failure_timeout=0.6)
    sub1 = FlowRetransmitReceiverNode(Node(1, 0, wedged), {},
                                      heartbeat_interval=HB)
    ctl1 = SubLeaderController(sub1, 0, [1, 2])
    sub3 = FlowRetransmitReceiverNode(Node(3, 0, ts[3]), {},
                                      heartbeat_interval=HB)
    ctl3 = SubLeaderController(sub3, 1, [3, 4])
    m2 = FlowRetransmitReceiverNode(Node(2, 1, ts[2]), {},
                                    heartbeat_interval=HB)
    m4 = FlowRetransmitReceiverNode(Node(4, 3, ts[4]), {},
                                    heartbeat_interval=HB)
    recvs = {1: sub1, 2: m2, 3: sub3, 4: m4}
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        # Group 1 (healthy) completes; group 0's member 2 is starved.
        _wait_for(lambda: 4 in leader.status
                  and 0 in leader.status.get(4, {}),
                  what="healthy group to fold coverage")
        # Kill the wedged sub-leader: heartbeats stop, the root's
        # detector fires, the group dissolves.
        ctl1.close()
        sub1.close()
        wedged.close()
        leader.ready().get(timeout=TIMEOUT)
        assert trace.counter_totals().get("hier.groups_dissolved", 0) == 1
        for m in (2, 4):
            data = bytes(recvs[m].layers[0].inmem_data)
            assert data == layer_bytes(0, size), m
        # Member 2 was told to re-point at the root.
        assert m2.node.leader_id == 0
        assert trace.counter_totals().get("hier.dissolved_members", 0) >= 1
    finally:
        ctl3.close()
        close_all(leader, [m2, sub3, m4], ts)


SMOKE_SPEC = "seed=7,resetany=5,times=2,partition=1@0.2-0.8"


@pytest.mark.timeout(120)
def test_chaos_smoke_hierarchy_leader_kill(monkeypatch, chaos_seed):
    """The chaos smoke with sub-leaders enabled: seeded member faults
    (resets + a partition window) plus a mid-run ROOT kill.  The
    promoted standby must reconstruct the HIERARCHICAL leader from its
    shadow's replicated group table, keep the groups (no spurious
    dissolve), and deliver byte-exactly with digests verified."""
    chaos_seed(SMOKE_SPEC)
    monkeypatch.setenv("DLD_GAP_NACK_S", "0.4")
    size = 24 * 1024
    trace.reset_counters()
    ids = list(range(6))  # 0 root, 1 standby; groups [2,3] and [4,5]
    raw, _ = make_transports("inmem", ids)
    ts = dict(raw)
    # Wedge the root's outbound LAYER frames so the kill is guaranteed
    # to strike mid-delivery (the HA rig's determinism trick).
    ts[0] = FaultyTransport(
        raw[0], [FaultRule("drop", "out", msg_type=MsgType.LAYER)], seed=1)
    for m in (3, 5):
        seed, rules = rules_from_spec(SMOKE_SPEC)
        ts[m] = FaultyTransport(raw[m], rules, seed=seed + m)
    groups = partition_groups(ids[2:], group_size=2)
    assignment = {i: {0: LayerMeta()} for i in ids[2:]}
    mk_layers = lambda: {0: mem_layer(0, size)}  # noqa: E731
    leader = HierarchicalFlowLeaderNode(
        Node(0, 0, ts[0]), mk_layers(), assignment,
        {i: 10 ** 9 for i in ids}, groups=groups,
        expected_nodes={1, 2, 4}, failure_timeout=2.0,
        standbys=[1], lease_interval=0.15, epoch=0)
    # Standby 1 (ungrouped) holds a replica copy so the promoted root
    # can source the layer.
    standby = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), mk_layers(),
                                         heartbeat_interval=HB)
    ctl = StandbyController(standby, rank=0, lease_timeout=0.5,
                            standbys=[1], mode=3,
                            node_network_bw={i: 10 ** 9 for i in ids},
                            failure_timeout=2.0, lease_interval=0.15)
    sub2 = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {},
                                      heartbeat_interval=HB)
    ctl2 = SubLeaderController(sub2, 0, [2, 3])
    sub4 = FlowRetransmitReceiverNode(Node(4, 0, ts[4]), {},
                                      heartbeat_interval=HB)
    ctl4 = SubLeaderController(sub4, 1, [4, 5])
    m3 = FlowRetransmitReceiverNode(Node(3, 2, ts[3]), {},
                                    heartbeat_interval=HB)
    m5 = FlowRetransmitReceiverNode(Node(5, 4, ts[5]), {},
                                    heartbeat_interval=HB)
    recvs = {2: sub2, 3: m3, 4: sub4, 5: m5}
    try:
        standby.announce()
        for r in recvs.values():
            for _ in range(3):
                try:
                    r.announce()
                    break
                except (OSError, ConnectionError):
                    time.sleep(0.05)
        leader.start_distribution().get(timeout=TIMEOUT)
        _wait_for(lambda: ctl.shadow.groups, what="group table to "
                  "replicate into the standby shadow")
        time.sleep(0.4)
        leader.close()
        _wait_for(ctl.promoted.is_set, timeout=TIMEOUT,
                  what="standby promotion")
        assert isinstance(ctl.leader, HierarchicalFlowLeaderNode)
        assert set(ctl.leader.groups) == set(groups)
        ctl.leader.ready().get(timeout=30.0)
        for m in (2, 3, 4, 5):
            data = bytes(recvs[m].layers[0].inmem_data)
            assert data == layer_bytes(0, size), m
        # The hierarchy survived the takeover: nothing dissolved, and
        # the chaos actually fired.
        assert trace.counter_totals().get("hier.groups_dissolved", 0) == 0
        fired = sum(t.stats["reset"] + t.stats["partition"]
                    for t in ts.values()
                    if isinstance(t, FaultyTransport))
        assert fired > 0, "chaos smoke fired no faults; vacuous"
    finally:
        ctl2.close()
        ctl4.close()
        ctl.close()
        leader.close()
        for r in [standby] + list(recvs.values()):
            r.close()
        for t in ts.values():
            t.close()


# ------------------------------------------------- intra-group chain


def _chain_counters():
    t = trace.counter_totals()
    return (t.get("hier.chain_plans", 0), t.get("hier.relay_frags", 0))


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_chain_dissemination_byte_exact(kind):
    """The chain tentpole e2e, both backends: one group of four — the
    FIRST dispatch of every layer rides the K-striped member chain
    (forward roles installed, fragments relayed member-to-member), the
    run is byte-exact with digests verified at every seat, and the
    sub-leader's egress is O(model_bytes), strictly below the star's
    members x model_bytes."""
    from distributed_llm_dissemination_tpu_torch.utils import integrity

    size = 48 * 1024
    lids = [0, 1]
    trace.reset_counters()
    leader, recvs, ctls, ts, groups, assignment = _build_hier(
        1, 4, lids, layer_size=size, kind=kind)
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        for i in assignment:
            for lid in lids:
                assert bytes(recvs[i].layers[lid].inmem_data) == \
                    layer_bytes(lid, size), (i, lid)
                if integrity.digests_enabled():
                    assert lid in recvs[i]._digest_ok, (i, lid)
        totals = trace.counter_totals()
        assert totals.get("hier.chain_plans", 0) >= len(lids)
        assert totals.get("hier.relay_roles", 0) >= 1
        assert totals.get("hier.relay_frags", 0) >= 1
        # Egress accounting: the whole point — the sub-leader shipped
        # each layer's bytes ONCE (plus bounded redrive slack), never
        # once per member like the star.
        n_members = len(groups[0]["members"]) - 1  # minus the sub
        total = len(lids) * size
        egress = totals.get("hier.subleader_egress_bytes", 0)
        assert total <= egress < n_members * total, (egress, total)
    finally:
        _close_hier(leader, recvs, ctls, ts)


def test_chain_link_table_reconciles_byte_exact_multi_hop():
    """Tier-1 guard (satellite): when bytes traverse a multi-hop chain,
    the telemetry link table still reconciles BYTE-EXACTLY — every
    (seat, layer) counted once at its landing, forwarded bytes never
    double-counted, and the root's only data link is the group
    ingress."""
    from distributed_llm_dissemination_tpu_torch.utils import telemetry

    size = 32 * 1024
    lids = [0, 1]
    telemetry.reset_run()
    trace.reset_counters()
    leader, recvs, ctls, ts, groups, assignment = _build_hier(
        1, 4, lids, layer_size=size)
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        assert trace.counter_totals().get("hier.chain_plans", 0) >= 1
        links = telemetry.snapshot()["links"]
        base = {key: row for key, row in links.items() if "#" not in key}
        delivered = sum(row.get("delivered_bytes", 0)
                        for row in base.values())
        assert delivered == len(assignment) * len(lids) * size, base
        # The root shipped ONLY the group ingress: no root->member
        # data link ever carried a byte.
        sub = groups[0]["leader"]
        for key, row in base.items():
            if key.startswith("0->") and key != f"0->{sub}":
                assert row.get("delivered_bytes", 0) == 0, (key, row)
        assert base[f"0->{sub}"]["delivered_bytes"] == len(lids) * size
        # Relay hops really carried bytes (member->member rows exist).
        relayed = sum(
            row.get("delivered_bytes", 0) for key, row in base.items()
            if "->" in key
            and key.split("->")[0] not in ("0", str(sub)))
        assert relayed > 0, base
    finally:
        _close_hier(leader, recvs, ctls, ts)


@pytest.mark.timeout(90)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_chain_mid_member_kill_repairs_and_converges(kind, monkeypatch):
    """Seeded mid-chain member kill, both backends: a member whose
    inbound LAYER frames are dropped (so its stripe seed and every
    relay THROUGH it are provably lost) dies mid-run — the sub-leader's
    detector reports it, survivors re-chain around the hole (gap-NACK +
    re-seeded stripes), the root drops the dead seat's pairs, and the
    survivors converge byte-exact."""
    monkeypatch.setenv("DLD_GAP_NACK_S", "0.4")
    size = 48 * 1024
    trace.reset_counters()
    ids = list(range(5))  # 0 root; one group [1(sub), 2, 3, 4]
    raw, _ = make_transports(kind, ids)
    ts = dict(raw)
    victim = 3  # mid-chain hop of stripe 0 (members sorted: 2, 3, 4)
    ts[victim] = FaultyTransport(
        raw[victim], [FaultRule("drop", "in", msg_type=MsgType.LAYER)],
        seed=1)
    groups = {0: {"leader": 1, "members": [1, 2, 3, 4]}}
    assignment = {i: {0: LayerMeta()} for i in ids[1:]}
    leader = HierarchicalFlowLeaderNode(
        Node(0, 0, ts[0]), {0: mem_layer(0, size)}, assignment,
        {i: 10 ** 9 for i in ids}, groups=groups, expected_nodes={1},
        failure_timeout=2.0)
    sub = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {},
                                     heartbeat_interval=HB)
    ctl = SubLeaderController(sub, 0, [1, 2, 3, 4], member_timeout=0.8)
    recvs = {1: sub}
    for m in (2, 3, 4):
        recvs[m] = FlowRetransmitReceiverNode(Node(m, 1, ts[m]), {},
                                              heartbeat_interval=HB)
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        _wait_for(lambda: _chain_counters()[0] >= 1,
                  what="chain dispatch")
        # Kill the wedged mid-chain member: heartbeats stop, the
        # sub-leader's detector fires, the chain re-forms.
        recvs[victim].close()
        ts[victim].close()
        leader.ready().get(timeout=60.0)
        for m in (1, 2, 4):
            assert bytes(recvs[m].layers[0].inmem_data) == \
                layer_bytes(0, size), m
        totals = trace.counter_totals()
        assert totals.get("hier.member_dead_reports", 0) >= 1
        assert totals.get("hier.member_crashes", 0) >= 1
        assert totals.get("hier.relay_frags", 0) >= 1
    finally:
        ctl.close()
        close_all(leader, [r for m, r in recvs.items() if m != victim],
                  ts)


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_codec_qualified_delivery_plans_through_group(kind, monkeypatch):
    """Hierarchy x codecs (the lifted limit), both backends: every
    grouped seat sits on a slow link and advertises int8 decode (the
    members' capability rides the new GroupStatus codec fold) — the
    root routes the group's SHARED codec form through ONE encoded
    group ingress, the sub-leader chains the encoded bytes internally,
    and every member verifies the codec-qualified digest."""
    from test_torch_codec import _enc_blob, _blob_layer, _plane
    from distributed_llm_dissemination_tpu_torch.utils import (
        integrity,
        telemetry,
    )

    monkeypatch.setenv("DLD_CODEC_MIN_RATE", str(64 << 20))
    telemetry.reset_run()
    trace.reset_counters()
    ids = [0, 1, 2, 3]
    ts, _ = make_transports(kind, ids)
    groups = {0: {"leader": 1, "members": [1, 2, 3]}}
    lids = [0, 1]
    layers = {lid: _blob_layer(lid) for lid in lids}
    assignment = {i: {lid: LayerMeta() for lid in lids}
                  for i in (1, 2, 3)}
    bw = {0: 1 << 30, 1: 4 << 20, 2: 4 << 20, 3: 4 << 20}
    leader = HierarchicalFlowLeaderNode(
        Node(0, 0, ts[0]), layers, assignment, bw, groups=groups,
        expected_nodes={1}, codecs=_plane())
    sub = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {},
                                     heartbeat_interval=HB,
                                     codecs=_plane())
    ctl = SubLeaderController(sub, 0, [1, 2, 3])
    recvs = {1: sub}
    for m in (2, 3):
        recvs[m] = FlowRetransmitReceiverNode(Node(m, 1, ts[m]), {},
                                              heartbeat_interval=HB,
                                              codecs=_plane())
    try:
        for r in recvs.values():
            r.announce()
        # The members' decode capability must fold upward BEFORE the
        # first plan stamps codec choices (choices are memoized).
        _wait_for(lambda: all(m in leader.node_codecs for m in (1, 2, 3)),
                  what="member codec capabilities to fold to the root")
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        for m in (1, 2, 3):
            for lid in lids:
                src = recvs[m].layers[lid]
                assert src.meta.codec == "int8", (m, lid)
                assert bytes(src.inmem_data) == _enc_blob(lid), (m, lid)
                if integrity.digests_enabled():
                    assert lid in recvs[m]._digest_ok, (m, lid)
                assert leader.status[m][lid].codec == "int8", (m, lid)
        # ONE group ingress of the ENCODED bytes: the root's only data
        # link is to the sub-leader, and it carried exactly the
        # encoded model once.
        enc_total = sum(len(_enc_blob(lid)) for lid in lids)
        links = telemetry.snapshot()["links"]
        base = {key: row for key, row in links.items() if "#" not in key}
        root_out = sum(row.get("delivered_bytes", 0)
                       for key, row in base.items()
                       if key.startswith("0->"))
        assert root_out == enc_total, base
        assert base.get("0->1", {}).get("delivered_bytes", 0) == \
            enc_total
        totals = trace.counter_totals()
        assert totals.get("hier.chain_plans", 0) >= 1
        assert totals.get("hier.relay_frags", 0) >= 1
    finally:
        ctl.close()
        close_all(leader, list(recvs.values()), ts)


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_rollout_wave_plans_through_group(kind):
    """Hierarchy x versioned rollout (the lifted limit), both
    backends: a version-stamped wave job targeting two grouped members
    routes through ONE synthetic group ingress — the sub-leader (not
    itself a wave dest) receives the v2 bytes once, chains them to the
    members, and the members' VERSIONED acks ride verbatim to the root
    so the wave's commit-fence bookkeeping keeps full fidelity."""
    from distributed_llm_dissemination_tpu_torch.utils import (
        integrity,
        telemetry,
    )

    size = 32 * 1024
    telemetry.reset_run()
    trace.reset_counters()
    ids = [0, 1, 2, 3]
    ts, _ = make_transports(kind, ids)
    groups = {0: {"leader": 1, "members": [1, 2, 3]}}
    assignment = {i: {0: LayerMeta()} for i in (1, 2, 3)}
    leader = HierarchicalFlowLeaderNode(
        Node(0, 0, ts[0]), {0: mem_layer(0, size)}, assignment,
        {i: 10 ** 9 for i in ids}, groups=groups, expected_nodes={1})
    sub = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {},
                                     heartbeat_interval=HB)
    ctl = SubLeaderController(sub, 0, [1, 2, 3])
    recvs = {1: sub}
    for m in (2, 3):
        recvs[m] = FlowRetransmitReceiverNode(Node(m, 1, ts[m]), {},
                                              heartbeat_interval=HB)
    try:
        for r in recvs.values():
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        # The wave: v2 bytes under a NEW layer id, version-stamped
        # targets on the two members only (the sub-leader is not a
        # dest — the ingress demand is synthesized).
        wave_lid = 9
        with leader._lock:
            leader.layers[wave_lid] = mem_layer(wave_lid, size)
        dig = integrity.layer_digest(layer_bytes(wave_lid, size))
        leader.submit_job(
            "wave0", {2: {wave_lid: LayerMeta()},
                      3: {wave_lid: LayerMeta()}},
            version="v2", digests={wave_lid: dig})
        _wait_for(lambda: leader.jobs.table().get("wave0", {}).get(
            "State") == "done", what="wave job completion")
        for m in (2, 3):
            src = recvs[m].layers[wave_lid]
            assert src.meta.version == "v2", m
            assert bytes(src.inmem_data) == layer_bytes(wave_lid, size)
            if integrity.digests_enabled():
                assert wave_lid in recvs[m]._digest_ok, m
            # The versioned ack reached the root UNAGGREGATED.
            assert leader.status[m][wave_lid].version == "v2", m
        # The sub-leader carried the synthetic ingress (v2-stamped).
        assert sub.layers[wave_lid].meta.version == "v2"
        # Across the WHOLE run (base + wave) the root never shipped a
        # byte to a member directly: every delivery routed through the
        # group.
        links = telemetry.snapshot()["links"]
        base = {key: row for key, row in links.items() if "#" not in key}
        for key, row in base.items():
            if key.startswith("0->") and key != "0->1":
                assert row.get("delivered_bytes", 0) == 0, (key, row)
        assert base["0->1"]["delivered_bytes"] == 2 * size
        assert trace.counter_totals().get("hier.acks_forwarded", 0) >= 2
    finally:
        ctl.close()
        close_all(leader, list(recvs.values()), ts)
