"""Port parity: ``update(assignment)`` on a running leader, on
``tests/test_update.py``'s cases (``:36-234``).

``runtime/leader.py::update`` re-targets a distribution: work added after
``ready`` fired re-arms the completion cycle, a goal already met fires at
once, mode 2 repairs its job table incrementally, mode 3 re-plans its
flow, and an update that lands mid-flight (the receiver's loop held, so
nothing can ack) fires ``ready`` exactly once, with the new goal.  Each
twin runs its JAX scenario through both packages, the JAX one on
``tests/test_node.py``'s helpers and the port's on
``tests/test_torch_node.py``'s, and holds the goals ``ready`` answers and
the delivered bytes equal between them.
"""

import pytest

import test_node as jnode
import test_torch_node as tnode
from torch_parity import JAX, PKGS, TORCH, both, clean, mod

# Generous: these runs share a CI host with heavy device-plane tests.
TIMEOUT = 30.0

HELPERS = {JAX: jnode, TORCH: tnode}


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKGS:
        clean(pkg)
    yield
    for pkg in PKGS:
        mod(pkg, "transport").reset_registry()


def _goal(assignment):
    """A goal as plain ids, comparable across the two packages."""
    return {n: sorted(layers) for n, layers in assignment.items()}


def _assign(pkg, goal):
    meta = mod(pkg, "core.types").LayerMeta
    return {n: {lid: meta() for lid in lids} for n, lids in goal.items()}


def _mode0(pkg, first, second):
    h, rt = HELPERS[pkg], mod(pkg, "runtime")
    ts, _ = h.make_transports("inmem", [0, 1])
    leader = rt.LeaderNode(rt.Node(0, 0, ts[0]),
                           {i: h.mem_layer(i) for i in range(2)},
                           _assign(pkg, first))
    r1 = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {})
    try:
        r1.announce()
        goals = [_goal(leader.ready().get(timeout=TIMEOUT))]
        leader.update(_assign(pkg, second))
        goals.append(_goal(leader.ready().get(timeout=TIMEOUT)))
        held = {lid: bytes(r1.layers[lid].inmem_data)
                for lid in second[1]}
    finally:
        h.close_all(leader, [r1], ts)
    return goals, held


def test_mode0_update_adds_work_and_refires_ready():
    """``test_update.py:36``: work added after ``ready`` re-arms the
    cycle; ``ready`` answers the new goal and layer 1 lands exact."""
    goals, held = both(_mode0, {1: [0]}, {1: [0, 1]})
    assert goals == [{1: [0]}, {1: [0, 1]}]
    assert held[1] == tnode.layer_bytes(1)


def test_mode0_update_already_satisfied_fires_immediately():
    """``test_update.py:56``: a narrowed goal that is already delivered
    fires ``ready`` at once."""
    goals, _ = both(_mode0, {1: [0, 1]}, {1: [0]})
    assert goals == [{1: [0, 1]}, {1: [0]}]


def _mode2_incremental(pkg):
    h, rt = HELPERS[pkg], mod(pkg, "runtime")
    ts, _ = h.make_transports("inmem", [0, 1, 2])
    leader = rt.PullRetransmitLeaderNode(
        rt.Node(0, 0, ts[0]), {}, _assign(pkg, {2: [0]}),
        expected_nodes={1, 2})
    r1 = rt.RetransmitReceiverNode(rt.Node(1, 0, ts[1]),
                                   {i: h.mem_layer(i) for i in range(2)})
    r2 = rt.RetransmitReceiverNode(rt.Node(2, 0, ts[2]), {})
    try:
        r1.announce()
        r2.announce()
        goals = [_goal(leader.ready().get(timeout=TIMEOUT))]
        leader.update(_assign(pkg, {2: [0, 1]}))
        goals.append(_goal(leader.ready().get(timeout=TIMEOUT)))
        return goals, bytes(r2.layers[1].inmem_data)
    finally:
        h.close_all(leader, [r1, r2], ts)


def test_mode2_update_incremental_jobs():
    """``test_update.py:74``: seeder 1 owns both layers; node 2 first
    gets layer 0, then an update adds layer 1, served by a fresh job."""
    goals, data = both(_mode2_incremental)
    assert goals == [{2: [0]}, {2: [0, 1]}]
    assert data == tnode.layer_bytes(1)


def _late_assignee(pkg, mode):
    h, rt = HELPERS[pkg], mod(pkg, "runtime")
    ts, _ = h.make_transports("inmem", [0, 1, 2])
    layers = {i: h.mem_layer(i) for i in range(2)}
    first = _assign(pkg, {1: [0]})
    if mode == "m0":
        leader = rt.LeaderNode(rt.Node(0, 0, ts[0]), layers, first)
        mk = rt.ReceiverNode
    else:
        leader = rt.PullRetransmitLeaderNode(rt.Node(0, 0, ts[0]), layers,
                                             first)
        mk = rt.RetransmitReceiverNode
    r1 = mk(rt.Node(1, 0, ts[1]), {})
    try:
        r1.announce()
        goals = [_goal(leader.ready().get(timeout=TIMEOUT))]
        leader.update(_assign(pkg, {1: [0], 2: [1]}))  # 2 not announced yet
        r2 = mk(rt.Node(2, 0, ts[2]), {})
        try:
            r2.announce()
            goals.append(_goal(leader.ready().get(timeout=TIMEOUT)))
            data = bytes(r2.layers[1].inmem_data)
        finally:
            r2.close()
    finally:
        h.close_all(leader, [r1], ts)
    return goals, data


@pytest.mark.parametrize("mode", ["m0", "m2"])
def test_update_adds_assignee_that_announces_later(mode):
    """``test_update.py:100``: the update names a node that has not
    announced; its announce triggers the delivery."""
    goals, data = both(_late_assignee, mode)
    assert goals == [{1: [0]}, {1: [0], 2: [1]}]
    assert data == tnode.layer_bytes(1)


def _in_flight(pkg, kind, mode, first, second, leader_layers):
    """Start a distribution to a receiver whose loop is held (nothing
    can ack), ``update`` to ``second``, then release the loop.  Returns
    the goal ``ready`` answers, the held layers' bytes, and the ready
    events left queued."""
    h, rt = HELPERS[pkg], mod(pkg, "runtime")
    ts, _ = h.make_transports(kind, [0, 1])
    layers = {i: h.mem_layer(i) for i in leader_layers}
    if mode == "m0":
        leader = rt.LeaderNode(rt.Node(0, 0, ts[0]), layers,
                               _assign(pkg, first))
        r1 = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {}, start_loop=False)
    else:
        leader = rt.FlowRetransmitLeaderNode(
            rt.Node(0, 0, ts[0]), layers, _assign(pkg, first),
            {i: 10_000_000 for i in (0, 1)})
        r1 = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                           start_loop=False)
    try:
        r1.announce()
        # Delivery is now in flight: the leader started and dispatched,
        # but the held receiver cannot ack.
        leader.start_distribution().get(timeout=TIMEOUT)
        assert leader.ready().qsize() == 0
        with leader._lock:
            assert leader._started and not leader._startup_sent
        leader.update(_assign(pkg, second))  # mid-flight re-target
        assert leader.ready().qsize() == 0  # still nothing acked
        r1.loop.start()  # release the buffered deliveries and acks
        got = _goal(leader.ready().get(timeout=TIMEOUT))
        held = {lid: bytes(src.inmem_data) for lid, src in r1.layers.items()}
        return got, held, leader.ready().qsize()
    finally:
        h.close_all(leader, [r1], ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
@pytest.mark.parametrize("mode", ["m0", "m3"])
def test_update_rearms_while_delivery_in_flight(kind, mode):
    """``test_update.py:130``: ``ready`` fires exactly once, with the
    post-update goal, both layers byte-exact."""
    got, held, left = both(_in_flight, kind, mode, {1: [0]}, {1: [0, 1]},
                            range(2))
    assert got == {1: [0, 1]}
    assert held == {0: tnode.layer_bytes(0), 1: tnode.layer_bytes(1)}
    assert left == 0  # the pre-update goal fired no stale ready


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode3_update_narrowing_mid_flight_completes_immediately(kind):
    """``test_update.py:180``: narrowing the goal mid-flight to drop a
    layer nobody holds completes as soon as the rest is met; the dropped
    layer never lands."""
    got, held, _ = both(_in_flight, kind, "m3", {1: [0, 1]}, {1: [0]},
                         [0])  # layer 1 is missing
    assert got == {1: [0]}
    assert held == {0: tnode.layer_bytes(0)}


def _mode3_replan(pkg):
    h, rt = HELPERS[pkg], mod(pkg, "runtime")
    ts, _ = h.make_transports("inmem", [0, 1, 2])
    size = 2048
    bw = {i: 10_000_000 for i in range(3)}
    leader = rt.FlowRetransmitLeaderNode(
        rt.Node(0, 0, ts[0]), {i: h.mem_layer(i, size) for i in range(2)},
        _assign(pkg, {2: [0]}), bw, expected_nodes={1, 2})
    r1 = rt.FlowRetransmitReceiverNode(
        rt.Node(1, 0, ts[1]), {i: h.mem_layer(i, size) for i in range(2)})
    r2 = rt.FlowRetransmitReceiverNode(rt.Node(2, 0, ts[2]), {})
    try:
        r1.announce()
        r2.announce()
        goals = [_goal(leader.ready().get(timeout=TIMEOUT))]
        leader.update(_assign(pkg, {2: [0, 1]}))
        goals.append(_goal(leader.ready().get(timeout=TIMEOUT)))
        return goals, bytes(r2.layers[1].inmem_data)
    finally:
        h.close_all(leader, [r1, r2], ts)


def test_mode3_update_replans_flow():
    """``test_update.py:210``: a mode-3 update re-plans the flow and the
    added layer lands exact."""
    goals, data = both(_mode3_replan)
    assert goals == [{2: [0]}, {2: [0, 1]}]
    assert data == tnode.layer_bytes(1, 2048)
