"""The port's schedulers, modes 0-3, on ``tests/test_node.py``'s harness.

1 leader + up to 4 receivers in one process, on the port's inmem
transport and on real loopback TCP: the scenarios of ``tests/test_node.py``
run with the port's classes, and every delivered layer is byte-exact.
"""

import pytest

from distributed_llm_dissemination_tpu_torch.core.types import (
    CLIENT_ID,
    LayerMeta,
    LayerLocation,
    LayerSrc,
    SourceType,
)
from distributed_llm_dissemination_tpu_torch.core.config import (
    create_client_layer,
    create_client_layer_info,
)
from distributed_llm_dissemination_tpu_torch.runtime import (
    Client,
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    LeaderNode,
    Node,
    PullRetransmitLeaderNode,
    ReceiverNode,
    RetransmitLeaderNode,
    RetransmitReceiverNode,
)
from distributed_llm_dissemination_tpu_torch.transport import (
    InmemTransport,
    TcpTransport,
    reset_registry,
)
from distributed_llm_dissemination_tpu_torch.utils import telemetry

TIMEOUT = 20.0
N_RECEIVERS = 4


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()
    yield
    reset_registry()


def layer_bytes(layer_id: int, size: int = 64) -> bytes:
    return bytes([(layer_id * 37 + i) % 256 for i in range(size)])


def mem_layer(layer_id: int, size: int = 64, rate: int = 0) -> LayerSrc:
    """Distinct per-layer content so delivery integrity is checkable
    (the reference uses empty 1-B layers, node_test.go:74-91)."""
    data = bytearray(layer_bytes(layer_id, size))
    return LayerSrc(
        inmem_data=data,
        data_size=len(data),
        meta=LayerMeta(location=LayerLocation.INMEM, limit_rate=rate,
                       source_type=SourceType.MEM),
    )


def make_transports(kind, ids, extra_registry=None):
    if kind == "inmem":
        registry = {i: f"n{i}" for i in ids}
        registry.update(extra_registry or {})
        return {i: InmemTransport(registry[i], addr_registry=registry) for i in ids}, registry
    ts = {i: TcpTransport("127.0.0.1:0") for i in ids}
    registry = {i: ts[i].get_address() for i in ids}
    registry.update(extra_registry or {})
    for t in ts.values():
        t.addr_registry.update(registry)
    return ts, registry


def exec_distribution(leader, receivers, assignment):
    """Announce everyone, then drive start -> ready -> per-receiver startup
    (node_test.go:107-145)."""
    for r in receivers:
        r.announce()
    started = leader.start_distribution().get(timeout=TIMEOUT)
    assert started == assignment
    got = leader.ready().get(timeout=TIMEOUT)
    assert got == assignment
    for r in receivers:
        r.ready().get(timeout=TIMEOUT)


def check_delivery(receivers, assignment):
    for r in receivers:
        want = assignment.get(r.node.my_id, {})
        for lid in want:
            src = r.layers[lid]
            assert src.meta.location == LayerLocation.INMEM
            assert bytes(src.inmem_data) == layer_bytes(lid)


def close_all(leader, receivers, transports, clients=()):
    leader.close()
    for r in receivers:
        r.close()
    for c in clients:
        c.close()
    for t in transports.values():
        t.close()


def simple_assignment():
    # layer i assigned to receiver i+1 (node_test.go:93-105).
    return {i + 1: {i: LayerMeta()} for i in range(N_RECEIVERS)}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode0_simple_distribution(kind):
    ids = range(N_RECEIVERS + 1)
    ts, _ = make_transports(kind, ids)
    assignment = simple_assignment()
    leader_layers = {i: mem_layer(i) for i in range(N_RECEIVERS)}
    leader = LeaderNode(Node(0, 0, ts[0]), leader_layers, assignment)
    receivers = [
        ReceiverNode(Node(i, 0, ts[i]), {}) for i in range(1, N_RECEIVERS + 1)
    ]
    try:
        exec_distribution(leader, receivers, assignment)
        check_delivery(receivers, assignment)
    finally:
        close_all(leader, receivers, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode1_retransmission_ring(kind):
    # Node i's assigned layer is pre-seeded on node i+1 (ring), so every
    # transfer is peer retransmission (node_test.go:45-72).
    ids = range(N_RECEIVERS + 1)
    ts, _ = make_transports(kind, ids)
    assignment = simple_assignment()
    leader = RetransmitLeaderNode(Node(0, 0, ts[0]), {}, assignment)
    receivers = []
    for i in range(1, N_RECEIVERS + 1):
        seeded_layer = (i % N_RECEIVERS)  # node i holds layer assigned to i+1
        layers = {seeded_layer: mem_layer(seeded_layer)}
        receivers.append(RetransmitReceiverNode(Node(i, 0, ts[i]), layers))
    try:
        exec_distribution(leader, receivers, assignment)
        check_delivery(receivers, assignment)
    finally:
        close_all(leader, receivers, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode2_pull_retransmission(kind):
    ids = range(N_RECEIVERS + 1)
    ts, _ = make_transports(kind, ids)
    assignment = simple_assignment()
    leader = PullRetransmitLeaderNode(Node(0, 0, ts[0]), {}, assignment)
    receivers = []
    for i in range(1, N_RECEIVERS + 1):
        seeded_layer = (i % N_RECEIVERS)
        layers = {seeded_layer: mem_layer(seeded_layer)}
        receivers.append(RetransmitReceiverNode(Node(i, 0, ts[i]), layers))
    try:
        exec_distribution(leader, receivers, assignment)
        check_delivery(receivers, assignment)
    finally:
        close_all(leader, receivers, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode2_leader_seeds_unowned_layers(kind):
    # Layers nobody owns fall back to direct leader sends.
    ids = range(N_RECEIVERS + 1)
    ts, _ = make_transports(kind, ids)
    assignment = simple_assignment()
    leader_layers = {i: mem_layer(i) for i in range(N_RECEIVERS)}
    leader = PullRetransmitLeaderNode(Node(0, 0, ts[0]), leader_layers, assignment)
    receivers = [
        RetransmitReceiverNode(Node(i, 0, ts[i]), {})
        for i in range(1, N_RECEIVERS + 1)
    ]
    try:
        exec_distribution(leader, receivers, assignment)
        check_delivery(receivers, assignment)
    finally:
        close_all(leader, receivers, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode3_flow_distribution_multi_sender(kind):
    # Cold node 4 needs layers 0-2; nodes 1-3 seed all layers (plus the
    # leader) — the reference benchmark shape (conf/config.json) in
    # miniature.  Verifies REAL byte reassembly of multi-sender splits.
    ids = range(5)
    ts, _ = make_transports(kind, ids)
    size = 4096
    assignment = {4: {i: LayerMeta() for i in range(3)}}
    all_layers = lambda rate: {i: mem_layer(i, size, rate) for i in range(3)}  # noqa: E731
    bw = {i: 10_000_000 for i in ids}
    leader = FlowRetransmitLeaderNode(Node(0, 0, ts[0]), all_layers(0), assignment, bw)
    receivers = [
        FlowRetransmitReceiverNode(Node(i, 0, ts[i]), all_layers(0))
        for i in range(1, 4)
    ]
    cold = FlowRetransmitReceiverNode(Node(4, 0, ts[4]), {})
    receivers.append(cold)
    try:
        exec_distribution(leader, receivers, assignment)
        for lid in range(3):
            got = cold.layers[lid]
            assert got.data_size == size
            assert bytes(got.inmem_data) == layer_bytes(lid, size)
    finally:
        close_all(leader, receivers, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode3_multi_dest_replication(kind):
    # One layer set assigned to TWO cold receivers — PP-stage replication.
    # The reference's mode 3 errors on this (node.go:1078, :1092); here
    # the per-(layer, dest) flow graph delivers full copies to both.
    ids = range(5)
    ts, _ = make_transports(kind, ids)
    size = 4096
    assignment = {3: {i: LayerMeta() for i in range(2)},
                  4: {i: LayerMeta() for i in range(2)}}
    bw = {i: 10_000_000 for i in ids}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {i: mem_layer(i, size) for i in range(2)},
        assignment, bw,
    )
    seeders = [
        FlowRetransmitReceiverNode(
            Node(i, 0, ts[i]), {j: mem_layer(j, size) for j in range(2)}
        )
        for i in (1, 2)
    ]
    colds = [
        FlowRetransmitReceiverNode(Node(i, 0, ts[i]), {}) for i in (3, 4)
    ]
    try:
        exec_distribution(leader, seeders + colds, assignment)
        for cold in colds:
            for lid in range(2):
                got = cold.layers[lid]
                assert got.data_size == size
                assert bytes(got.inmem_data) == layer_bytes(lid, size)
    finally:
        close_all(leader, seeders + colds, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode0_client_source_pipe(kind):
    # Leader's layer 0 lives at an external client; delivery must flow
    # client -> leader (pipe) -> receiver.  Untested in the reference.
    ids = [0, 1]
    client_addr = {CLIENT_ID: "client0" if kind == "inmem" else None}
    if kind == "inmem":
        ts, registry = make_transports(kind, ids, extra_registry=client_addr)
        ct = InmemTransport("client0", addr_registry=registry)
    else:
        ts, registry = make_transports(kind, ids)
        ct = TcpTransport("127.0.0.1:0")
        registry[CLIENT_ID] = ct.get_address()
        ct.addr_registry.update(registry)
        for t in ts.values():
            t.addr_registry[CLIENT_ID] = ct.get_address()

    payload_size = 2048
    client_layers = {0: create_client_layer(0, payload_size, limit_rate=0)}
    client_layers[0].inmem_data[:] = layer_bytes(0, payload_size)
    client = Client(0, ct, client_layers)

    leader_layers = {0: create_client_layer_info(0, payload_size, limit_rate=0)}
    assignment = {1: {0: LayerMeta()}}
    leader = LeaderNode(Node(0, 0, ts[0]), leader_layers, assignment)
    receivers = [ReceiverNode(Node(1, 0, ts[1]), {})]
    try:
        exec_distribution(leader, receivers, assignment)
        got = receivers[0].layers[0]
        assert bytes(got.inmem_data) == layer_bytes(0, payload_size)
    finally:
        close_all(leader, receivers, ts, clients=[client])
        ct.close()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_receiver_already_has_layers_short_circuit(kind):
    # If every assigned layer is already held, ready must fire without any
    # transfer... after at least one ack-equivalent event.  Mode 0 leader
    # skips sends for held layers (node.go:335); satisfaction is checked on
    # announce? No — only on acks, so we seed all but one layer.
    ids = [0, 1]
    ts, _ = make_transports(kind, ids)
    assignment = {1: {0: LayerMeta(), 1: LayerMeta()}}
    leader = LeaderNode(Node(0, 0, ts[0]), {1: mem_layer(1)}, assignment)
    receivers = [ReceiverNode(Node(1, 0, ts[1]), {0: mem_layer(0)})]
    try:
        exec_distribution(leader, receivers, assignment)
        assert bytes(receivers[0].layers[1].inmem_data) == layer_bytes(1)
    finally:
        close_all(leader, receivers, ts)


def test_stopped_loop_hands_back_a_message_it_dequeued():
    """A loop whose ``stop()`` lands while its ``get`` is blocked puts the
    message back for the next loop on that transport (a client closed on
    a transport that another loop now drains) instead of dropping it."""
    import queue

    from distributed_llm_dissemination_tpu_torch.runtime.node import (
        MessageLoop,
    )

    class _StopDuringGet(queue.Queue):
        def get(self, block=True, timeout=None):
            msg = super().get(block, timeout)
            loop.stop()
            return msg

    q = _StopDuringGet()
    q.put("reply")

    class _Transport:
        def deliver(self):
            return q

    handled = []
    loop = MessageLoop(_Transport())
    loop.register(str, handled.append)
    loop.start()
    loop._thread.join(timeout=TIMEOUT)
    assert not loop._thread.is_alive()
    assert handled == []
    assert q.queue.popleft() == "reply"
