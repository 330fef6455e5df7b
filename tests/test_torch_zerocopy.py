"""Port parity: the zero-copy layer sink and the shared-buffer ingest, on
``tests/test_zerocopy.py``'s cases (``:71-512``).

Every mode-3 TCP round onto a device lands its fragments through the
receiver's ``_layer_sink`` (``runtime/receiver.py``), registered on the
transport as ``layer_sink`` and called from ``transport/tcp.py`` before
``recv_into``.  Each twin runs its JAX test's scenario through both
packages (``tests/torch_parity.py``) and holds what does not depend on
thread timing equal between them: the reassembled bytes, the sink's
engage/decline answers, and which ranges of a single-threaded fuzz the
sink placed.  Counts that depend on threads (fragments the sink placed
on a live round) hold the JAX test's own invariant in each package.

The JAX test holds the no-copy staging as ``unsafe_buffer_pointer() ==
inmem_data.ctypes.data``; the port holds it as the staged tensor's
``data_ptr()`` equal to the reassembly buffer's address
(``parallel/ingest.py::ShardedLayerIngest.share_host_buffer``).
"""

import random
import threading
import time

import pytest

from torch_parity import (
    JAX, PKGS, TORCH, clean, close_all, fragment, layer_bytes, mem_layer, mod,
    tcp_transports)

TIMEOUT = 15.0
SIZE = 64 * 1024


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKGS:
        clean(pkg)
    yield
    for pkg in PKGS:
        mod(pkg, "transport").reset_registry()


def _rt(pkg):
    return mod(pkg, "runtime")


def _layer_msg(pkg, layer_id, src, total):
    return mod(pkg, "transport.messages").LayerMsg(0, layer_id, src, total)


def _spy_sink(transport, placed):
    real_sink = transport.layer_sink
    assert real_sink is not None, "mode-3 receiver must register the sink"

    def spy(layer_id, total, offset, size):
        got = real_sink(layer_id, total, offset, size)
        if got is not None:
            placed.append((layer_id, offset, size))
        return got

    transport.layer_sink = spy


def _flow_round(pkg, monkeypatch, bw, tune=None):
    """Leader 0 and seeder 1 hold layers 0-1; cold node 2 takes both over
    TCP in mode 3.  Returns (cold's bytes per layer, sink placements,
    stripes seen)."""
    rt = _rt(pkg)
    monkeypatch.setattr(mod(pkg, "runtime.send"), "FLOW_FRAGMENT_BYTES",
                        32 * 1024 if tune else 8 * 1024)
    if tune:
        tcp_mod = mod(pkg, "transport.tcp")
        for name, value in tune.items():
            monkeypatch.setattr(tcp_mod, name, value)
    ids = range(3)
    ts = tcp_transports(pkg, ids)
    assignment = {2: {0: mod(pkg, "core.types").LayerMeta(),
                      1: mod(pkg, "core.types").LayerMeta()}}
    leader = rt.FlowRetransmitLeaderNode(
        rt.Node(0, 0, ts[0]), {i: mem_layer(pkg, i, SIZE) for i in range(2)},
        assignment, {i: bw for i in ids})
    seeder = rt.FlowRetransmitReceiverNode(
        rt.Node(1, 0, ts[1]), {i: mem_layer(pkg, i, SIZE) for i in range(2)})
    cold = rt.FlowRetransmitReceiverNode(rt.Node(2, 0, ts[2]), {})
    placed, stripes = [], []
    _spy_sink(ts[2], placed)
    orig_stripe = ts[2]._receive_stripe

    def stripe_spy(conn, envelope, header):
        stripes.append((header.layer_id, header.stripe_idx, header.stripe_n))
        return orig_stripe(conn, envelope, header)

    ts[2]._receive_stripe = stripe_spy
    try:
        seeder.announce()
        cold.announce()
        assert leader.ready().get(timeout=TIMEOUT)
        cold.ready().get(timeout=TIMEOUT)
        got = {lid: bytes(cold.layers[lid].inmem_data) for lid in range(2)}
    finally:
        close_all(leader, seeder, cold, ts)
    for lid in range(2):
        assert got[lid] == layer_bytes(lid, SIZE), (pkg, lid)
    return got, placed, stripes


def test_sink_engages_on_tcp_flow_transfers(monkeypatch):
    """``test_zerocopy.py:71``: mode-3 fragments over real TCP land
    through the sink, and the reassembled bytes are exact and equal the
    JAX package's."""
    got = {}
    for pkg in PKGS:
        got[pkg], placed, _ = _flow_round(pkg, monkeypatch, 10_000_000)
        # Multi-fragment transfers: the sink carried (at least most of)
        # the fragments directly into the assembly buffers.
        assert len(placed) >= 8, (pkg, placed)
    assert got[TORCH] == got[JAX]


def _fallback_answers(pkg):
    rt = _rt(pkg)
    ts = tcp_transports(pkg, [1])
    r = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                      start_loop=False)
    answers = []
    try:
        sink = r._layer_sink
        got = sink(0, 100, 0, 60)
        assert got is not None
        view, _tok, abort = got
        answers.append(len(view))
        answers.append(sink(0, 100, 30, 40))  # overlap: bounce path
        got2 = sink(0, 100, 60, 40)  # disjoint: engages
        answers.append(got2 is not None and len(got2[0]))
        abort()  # the first claim rolls back: claimable again
        got3 = sink(0, 100, 0, 60)
        answers.append(got3 is not None and len(got3[0]))
        # Malformed: never engages.
        answers += [sink(0, 100, 90, 20), sink(0, 100, -1, 10),
                    sink(0, 100, 0, 0)]
        # Completed layer: the sink declines so the bounce path re-acks.
        r.layers[5] = mem_layer(pkg, 5, SIZE)
        answers.append(sink(5, SIZE, 0, 10))
    finally:
        close_all(r, ts)
    return answers


def test_layer_sink_fallback_discipline():
    """``test_zerocopy.py:115``: overlap and duplicate give None, abort
    rolls the claim back, malformed ranges are refused, a completed layer
    declines -- the same answers, in the same order, as the JAX sink."""
    want = [60, None, 40, 60, None, None, None, None]
    for pkg in PKGS:
        assert _fallback_answers(pkg) == want, pkg


def test_shared_ingest_stages_reassembly_buffer_zero_copy(
        cpu_devices, monkeypatch):
    """``test_zerocopy.py:151``: a one-slot stage on the CPU arm adopts
    the reassembly buffer itself.  The port's staged tensor starts at the
    buffer the fragments were received into, its per-layer share verdict
    is cleaned at completion, and its bytes equal the JAX package's
    staged array's."""
    staged = {}
    for pkg in PKGS:
        rt = _rt(pkg)
        mesh_mod = mod(pkg, "parallel.mesh")
        monkeypatch.setattr(mod(pkg, "runtime.send"), "FLOW_FRAGMENT_BYTES",
                            8 * 1024)
        assignment = {1: {0: mod(pkg, "core.types").LayerMeta()}}
        devices = cpu_devices[:1] if pkg == JAX else ["cpu"]
        mesh = mesh_mod.make_mesh((1, 1), ("pp", "tp"), devices=devices)
        placement = mesh_mod.assignment_to_placement(assignment, mesh, "pp")
        ts = tcp_transports(pkg, range(2))
        leader = rt.FlowRetransmitLeaderNode(
            rt.Node(0, 0, ts[0]), {0: mem_layer(pkg, 0, SIZE)}, assignment,
            {i: 10_000_000 for i in range(2)})
        dest = rt.FlowRetransmitReceiverNode(
            rt.Node(1, 0, ts[1]), {}, stage_hbm=True, placement=placement)
        try:
            dest.announce()
            assert leader.ready().get(timeout=TIMEOUT)
            dest.ready().get(timeout=TIMEOUT)
            src = dest.layers[0]
            assert src.meta.location == mod(pkg, "core.types").LayerLocation.HBM
            staged[pkg] = mod(pkg, "parallel.mover").array_to_bytes(
                src.device_array)
            # Completion cleans the per-layer share verdict with the ingest.
            assert dest._ingest_share == {}, pkg
            host_ptr = src.inmem_data.ctypes.data
            if pkg == TORCH:
                assert src.device_array.device.type == "cpu"
                assert src.device_array.data_ptr() == host_ptr, (
                    "staging copied the buffer instead of adopting it")
            else:
                assert src.device_array.unsafe_buffer_pointer() == host_ptr
        finally:
            close_all(leader, dest, ts)
    assert staged[TORCH] == staged[JAX] == layer_bytes(0, SIZE)


def test_striped_flow_transfer_streams_through_sink(monkeypatch):
    """``test_zerocopy.py:193``: flow fragments past the stripe threshold
    ride several data connections, each stripe lands through the sink at
    its absolute offset, and the bytes are exact and equal the JAX
    package's."""
    tune = {"STRIPE_THRESHOLD": 16 * 1024, "STRIPE_MIN": 4 * 1024,
            "STRIPE_COUNT": 4,
            # The KiB-scale test layers' commanded rate is far below the
            # production budget threshold; lower it so paced jobs stripe.
            "STRIPE_PACED_MIN_RATE": 10 ** 6}
    got = {}
    for pkg in PKGS:
        got[pkg], placed, stripes = _flow_round(pkg, monkeypatch, 10 ** 10,
                                                tune)
        assert any(n > 1 for _, _, n in stripes), (pkg, stripes)
        assert len(placed) >= len(stripes) // 2, (pkg, placed, stripes)
    assert got[TORCH] == got[JAX]


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mixed_striped_and_unstriped_fragments_reassemble(kind, monkeypatch):
    """``test_zerocopy.py:260``: one fragment big enough to stripe, one
    below the threshold and a duplicate overlapping both assemble through
    the one fragment path, byte-exact and equal to the JAX package's."""
    total = 96 * 1024
    want = bytes((i * 11 + 3) % 256 for i in range(total))
    got = {}
    for pkg in PKGS:
        rt, tr = _rt(pkg), mod(pkg, "transport")
        tcp_mod = mod(pkg, "transport.tcp")
        monkeypatch.setattr(tcp_mod, "STRIPE_THRESHOLD", 16 * 1024)
        monkeypatch.setattr(tcp_mod, "STRIPE_MIN", 4 * 1024)
        monkeypatch.setattr(tcp_mod, "STRIPE_COUNT", 3)
        if kind == "tcp":
            ts = tcp_transports(pkg, [0, 1])
        else:
            ts = {i: tr.InmemTransport(str(i), addr_registry={0: "0", 1: "1"})
                  for i in (0, 1)}
        r = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {})
        try:
            for off, size in ((0, 64 * 1024), (64 * 1024, 32 * 1024),
                              (48 * 1024, 32 * 1024)):
                ts[0].send(1, _layer_msg(
                    pkg, 5, fragment(pkg, bytearray(want), off, size), total))
            deadline = time.time() + TIMEOUT
            while 5 not in r.layers and time.time() < deadline:
                time.sleep(0.01)
            assert 5 in r.layers, (pkg, "mixed transfer never completed")
            got[pkg] = bytes(r.layers[5].inmem_data)
        finally:
            close_all(r, ts)
    assert got[TORCH] == got[JAX] == want


def _fuzz_trial(pkg, trial, total, want, spans, layer_id):
    """Feed ``spans`` in order through the sink when it engages, else the
    bounce path.  Returns (assembled bytes, indices of placed spans)."""
    rt = _rt(pkg)
    ts = tcp_transports(pkg, [1])
    r = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                      start_loop=False)
    engaged = []
    try:
        for i, (a, b) in enumerate(spans):
            placed = r._layer_sink(layer_id, total, a, b - a)
            if placed is not None:
                view, tok, _abort = placed
                view[:] = want[a:b]
                src = fragment(pkg, None, a, b - a)
                src.placed_token = tok
                engaged.append(i)
            else:
                src = fragment(pkg, bytearray(want[a:b]), a, b - a)
            r.handle_layer(_layer_msg(pkg, layer_id, src, total))
        got = r.layers.get(layer_id)
        assert got is not None, (pkg, trial, total, spans)
        return bytes(got.inmem_data), engaged
    finally:
        close_all(r, ts)


def test_sink_and_bounce_interleave_fuzz():
    """``test_zerocopy.py:309``: random overlapping, duplicated,
    out-of-order fragments land through whichever path engages and the
    layer is byte-exact.  Single-threaded, so the port's sink must place
    exactly the spans the JAX sink places."""
    rng = random.Random(1234)
    for trial in range(8):
        total = rng.randint(1, 40_000)
        want = bytes(rng.getrandbits(8) for _ in range(total))
        spans, pos = [], 0
        while pos < total:  # a covering tiling...
            n = rng.randint(1, max(1, total // 3))
            spans.append((pos, min(total, pos + n)))
            pos += n
        for _ in range(rng.randint(0, 6)):  # ...plus random overlaps
            a = rng.randrange(total)
            spans.append((a, rng.randint(a + 1, total)))
        rng.shuffle(spans)
        out = {pkg: _fuzz_trial(pkg, trial, total, want, spans, 7)
               for pkg in PKGS}
        assert out[TORCH][0] == out[JAX][0] == want, (trial, total)
        assert out[TORCH][1] == out[JAX][1], (trial, spans)


def _threaded_fuzz(pkg, trial, total, want, chunks):
    rt = _rt(pkg)
    ts = tcp_transports(pkg, [1])
    r = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                      start_loop=False)
    errs = []

    def writer(my_spans, seed):
        try:
            my_rng = random.Random(seed)
            for a, b in my_spans:
                placed = (r._layer_sink(9, total, a, b - a)
                          if my_rng.random() < 0.5 else None)
                if placed is not None:
                    view, tok, _abort = placed
                    view[:] = want[a:b]
                    src = fragment(pkg, None, a, b - a)
                    src.placed_token = tok
                else:
                    src = fragment(pkg, bytearray(want[a:b]), a, b - a)
                r.handle_layer(_layer_msg(pkg, 9, src, total))
        except Exception as e:  # noqa: BLE001 -- asserted after the join
            errs.append(e)

    try:
        threads = [threading.Thread(target=writer, args=(c, i),
                                    name=f"torch-fuzz-writer-{i}")
                   for i, c in enumerate(chunks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errs, (pkg, errs)
        got = r.layers.get(9)
        assert got is not None, f"{pkg} trial {trial}: layer never completed"
        return bytes(got.inmem_data)
    finally:
        close_all(r, ts)


def test_sink_and_bounce_threaded_fuzz():
    """``test_zerocopy.py:363``: six writer threads race random
    overlapping fragments through sink and bounce; the claim and commit
    discipline yields a byte-exact layer with no wedge, in both
    packages."""
    for trial in range(3):
        rng = random.Random(500 + trial)
        total = 120_000
        want = bytes(rng.getrandbits(8) for _ in range(total))
        spans, pos = [], 0
        while pos < total:
            n = rng.randint(1, 20_000)
            spans.append((pos, min(total, pos + n)))
            pos += n
        for _ in range(10):
            a = rng.randrange(total)
            spans.append((a, rng.randint(a + 1, total)))
        rng.shuffle(spans)
        chunks = [spans[i::6] for i in range(6)]
        got = {pkg: _threaded_fuzz(pkg, trial, total, want, chunks)
               for pkg in PKGS}
        assert got[TORCH] == got[JAX] == want, trial


def test_sink_composes_with_checkpoint_resume(tmp_path):
    """``test_zerocopy.py:437``: a checkpoint-restored partial layer is
    the sink's target for the remaining gap, and the layer completes
    byte-exact, equal to the JAX package's."""
    total = 10_000
    want = bytes((i * 31) % 256 for i in range(total))
    got = {}
    for pkg in PKGS:
        rt = _rt(pkg)
        ckpt = str(tmp_path / pkg / "ck")
        ts = tcp_transports(pkg, [1])
        r = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                          start_loop=False,
                                          checkpoint_dir=ckpt)
        try:  # the first incarnation journals [0, 4000)
            r.handle_layer(_layer_msg(
                pkg, 3, fragment(pkg, bytearray(want[:4000]), 0, 4000),
                total))
        finally:
            close_all(r, ts)
        ts2 = tcp_transports(pkg, [1])
        r2 = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts2[1]), {},
                                           start_loop=False,
                                           checkpoint_dir=ckpt)
        try:
            assert 3 in r2._partial, pkg  # the restored in-progress layer
            placed = r2._layer_sink(3, total, 4000, total - 4000)
            assert placed is not None, pkg
            view, tok, _abort = placed
            view[:] = want[4000:]
            src = fragment(pkg, None, 4000, total - 4000)
            src.placed_token = tok
            r2.handle_layer(_layer_msg(pkg, 3, src, total))
            got[pkg] = bytes(r2.layers[3].inmem_data)
        finally:
            close_all(r2, ts2)
    assert got[TORCH] == got[JAX] == want


def test_sink_claim_survives_concurrent_bounce_duplicates():
    """``test_zerocopy.py:482``: a placed fragment's in-flight claim and a
    racing duplicate: the duplicate's sink call declines and the placed
    commit still completes the layer, as in the JAX package."""
    got = {}
    for pkg in PKGS:
        rt = _rt(pkg)
        ts = tcp_transports(pkg, [1])
        r = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                          start_loop=False)
        try:
            total = 100
            view, tok, _abort = r._layer_sink(0, total, 0, total)
            view[:] = bytes(range(100))
            assert r._layer_sink(0, total, 0, total) is None, pkg
            src = fragment(pkg, None, 0, total)
            src.placed_token = tok
            r.handle_layer(_layer_msg(pkg, 0, src, total))
            got[pkg] = bytes(r.layers[0].inmem_data)
        finally:
            close_all(r, ts)
    assert got[TORCH] == got[JAX] == bytes(range(100))
