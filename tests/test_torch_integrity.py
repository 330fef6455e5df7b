"""Port parity: the integrity plane, on ``tests/test_integrity.py``'s cases
(``:101-736``).

Per-fragment checksums and their drop and NACK, leader-stamped layer
digests (a mismatch reopens a layer's intervals instead of acking; a late
stamp demotes a held layer), the stream stager's digest gate and its
``invalidate``, the journal's verified resume, the stripe group's TTL
NACK and the seeded fault transport.  Each twin runs its JAX scenario
through both packages (``tests/torch_parity.py``) and holds equal what
does not depend on thread timing: checksums, digests, the fault
schedule's answers, delivered bytes, each NACK's range and reason, the
protocol messages a mismatch sends, which layers are demoted, the
journal's reopened ranges, and the stager's staged and decoded leaves.
Counters that depend on threads hold the JAX test's own invariant in each
package.

The port's ``utils/integrity.py`` adds one thing: the time holders spend
digesting their layers to stamp them is the ``integrity_digest_stamp``
phase; ``test_digest_stamp_phase_records_and_digests_match`` holds it.
The chaos soak keeps its original's ``slow`` and ``timeout(420)`` marks.
"""

import os
import queue
import threading
import types
import zlib

import numpy as np
import pytest
import torch

from torch_parity import (
    JAX, PKGS, TORCH, both, clean, close_all, fragment,
    layer_bytes as _bytes, mod, transports)

TIMEOUT = 10.0
SIZE = 4096


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKGS:
        clean(pkg)
    yield
    for pkg in PKGS:
        mod(pkg, "transport").reset_registry()


def layer_bytes(layer_id: int, size: int = SIZE) -> bytes:
    return _bytes(layer_id, size)


def mem_layer(pkg, layer_id: int, size: int = SIZE):
    t = mod(pkg, "core.types")
    data = bytearray(layer_bytes(layer_id, size))
    return t.LayerSrc(inmem_data=data, data_size=len(data),
                      meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                                       source_type=t.SourceType.MEM))


def _integrity(pkg):
    return mod(pkg, "utils.integrity")


def _counters(pkg):
    return mod(pkg, "utils.trace").counter_totals()


def _msgs(pkg):
    return mod(pkg, "transport.messages")


# --------------------------------------------------------------- primitives


def _helpers(pkg):
    integrity = _integrity(pkg)
    data = b"x" * 100_000
    bad = b"y" + data[1:]
    assert integrity.fragment_crc(data) == (zlib.crc32(data) & 0xFFFFFFFF)
    algo, value = integrity.fragment_checksum(data)
    assert algo in ("xxh3", "crc32")
    assert integrity.checksum_of(data, algo) == value
    kwargs = {"xxh3": value} if algo == "xxh3" else {"crc": value}
    stamps = (integrity.verify_stamp(data, **kwargs),
              integrity.verify_stamp(bad, **kwargs),
              integrity.verify_stamp(data))  # unstamped: advisory
    d = integrity.layer_digest(data)
    if d.startswith("xxh3:"):
        assert len(d) == len("xxh3:") + 32
    else:
        assert len(d) == 2 * integrity.DIGEST_SIZE
    assert d != integrity.layer_digest(bad)
    assert integrity.digest_matches(data, d)
    # A blake2b stamp verifies by its own algorithm even where the local
    # default is xxh3.
    b2 = integrity.layer_digest(data, algo="blake2b")
    assert len(b2) == 2 * integrity.DIGEST_SIZE
    assert integrity.digest_matches(data, b2)
    assert not integrity.digest_matches(bad, b2)
    src = mem_layer(pkg, 3)
    src_digest = integrity.digest_layer_src(src)
    assert src_digest == integrity.layer_digest(bytes(src.inmem_data))
    return (integrity.fragment_crc(data), (algo, value), stamps, d, b2,
            src_digest)


def test_integrity_helpers():
    """``test_integrity.py:101``: frame checksums, stamps and
    self-describing digests, each equal to the JAX package's."""
    both(_helpers)


def _file_checksum(pkg, path, data):
    integrity = _integrity(pkg)
    got = integrity.file_checksum(str(path), 3, len(data))
    assert got == integrity.fragment_checksum(data)
    crc = integrity.file_crc(str(path), 3, len(data))
    assert crc == integrity.fragment_crc(data)
    return got, crc


def test_file_checksum_matches_inmem(tmp_path):
    """``test_integrity.py:131``: a file range checksums as its bytes
    do, and as the JAX package checksums them."""
    data = layer_bytes(5, 300_000)
    p = tmp_path / "blob"
    p.write_bytes(b"pad" + data + b"tail")
    both(_file_checksum, p, data)


def test_hash_bench_shape():
    """``test_integrity.py:141``: the bench names the JAX bench's hashes,
    each with a positive rate."""
    rates = {pkg: _integrity(pkg).hash_bench(nbytes=2 << 20) for pkg in PKGS}
    assert sorted(rates[TORCH]) == sorted(rates[JAX])
    for key in ("crc32_gbps", "blake2b_gbps"):
        assert rates[TORCH][key] > 0


def _fires(pkg):
    seed, rules = mod(pkg, "transport").rules_from_spec(
        "seed=2,corrupt=3,times=2")
    (rule,) = rules
    return seed, [rule.should_fire(seed) for _ in range(12)]


def test_fault_rules_deterministic():
    """``test_integrity.py:147``: seed 2 fires the 3rd and 6th matches,
    then the times cap silences it -- the JAX schedule."""
    seed, fires = both(_fires)
    assert seed == 2
    assert fires == [False, False, True, False, False, True] + [False] * 6


# --------------------------------------------------- fault transport (unit)


def _drop_plan_seq(pkg, kind):
    tr = mod(pkg, "transport")
    ts = transports(pkg, kind, range(2))
    try:
        seed, rules = tr.rules_from_spec("drop-plan-seqs=5")
        faulty = tr.FaultyTransport(ts[1], rules, seed=seed)
        plan = _msgs(pkg).DevicePlanMsg(0, "p.5", 0, 1, 10, [(0, 0, 10)],
                                        seq=5)
        other = _msgs(pkg).DevicePlanMsg(0, "p.6", 0, 1, 10, [(0, 0, 10)],
                                         seq=6)
        ts[0].send(1, plan)
        ts[0].send(1, other)
        seqs = [faulty.deliver().get(timeout=TIMEOUT).seq]
        ts[0].send(1, plan)  # the re-send (gap recovery) passes
        seqs.append(faulty.deliver().get(timeout=TIMEOUT).seq)
        return seqs, faulty.stats["drop"]
    finally:
        close_all(ts)


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_fault_transport_drops_plan_seq_first_delivery(kind):
    """``test_integrity.py:160``: plan seq 5's first delivery vanishes,
    its re-send passes."""
    assert both(_drop_plan_seq, kind) == ([6, 5], 1)


def _reset_and_dup(pkg):
    tr = mod(pkg, "transport")
    ts = transports(pkg, "inmem", range(2))
    try:
        rules = [tr.FaultRule("reset", "out", msg_type=tr.MsgType.LAYER,
                              times=1),
                 tr.FaultRule("dup", "out", msg_type=tr.MsgType.LAYER,
                              times=1)]
        faulty = tr.FaultyTransport(ts[0], rules)
        msg = tr.LayerMsg(0, 7, mem_layer(pkg, 7), SIZE)
        with pytest.raises(ConnectionError):
            faulty.send(1, msg)
        faulty.send(1, msg)  # reset exhausted; dup fires: two copies
        copies = [bytes(ts[1].deliver().get(timeout=TIMEOUT)
                        .layer_src.inmem_data)
                  for _ in range(2)]
        return copies, faulty.stats["reset"], faulty.stats["dup"]
    finally:
        close_all(ts)


def test_fault_transport_outbound_reset_and_dup():
    """``test_integrity.py:180``: an outbound reset raises, then a dup
    delivers two copies, as in the JAX package."""
    copies, resets, dups = both(_reset_and_dup)
    assert copies == [layer_bytes(7)] * 2 and (resets, dups) == (1, 1)


# ------------------------------------------------- CRC drop + NACK (wired)


def _corrupt_layer(pkg, kind):
    tr, rt = mod(pkg, "transport"), mod(pkg, "runtime")
    ts = transports(pkg, kind, range(2))
    seed, rules = tr.rules_from_spec("corrupt=1,times=1")
    faulty = tr.FaultyTransport(ts[1], rules, seed=seed)
    assignment = {1: {0: mod(pkg, "core.types").LayerMeta()}}
    leader = rt.LeaderNode(rt.Node(0, 0, ts[0]), {0: mem_layer(pkg, 0)},
                           assignment)
    receiver = rt.ReceiverNode(rt.Node(1, 0, faulty), {})
    try:
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        receiver.ready().get(timeout=TIMEOUT)
        counts = _counters(pkg)
        assert counts.get("integrity.crc_drop", 0) >= 1, pkg
        assert counts.get("integrity.nack_sent", 0) >= 1, pkg
        assert counts.get("integrity.retransmit_frags", 0) >= 1, pkg
        # The digest the leader stamped verified on the dest.
        assert 0 in receiver._digest_ok, pkg
        return bytes(receiver.layers[0].inmem_data), faulty.stats["corrupt"]
    finally:
        close_all(leader, receiver, ts)


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_corrupt_layer_dropped_nacked_and_retransmitted(kind):
    """``test_integrity.py:201``: mode 0, the first delivery corrupted
    below the CRC check is dropped, NACKed and retransmitted; the layer
    lands byte-exact."""
    assert both(_corrupt_layer, kind) == (layer_bytes(0), 1)


def _mode3_corrupt_fragment(pkg, kind, monkeypatch):
    tr, rt = mod(pkg, "transport"), mod(pkg, "runtime")
    ts = transports(pkg, kind, range(2))
    seed, rules = tr.rules_from_spec("dropin=1,times=1")
    faulty = tr.FaultyTransport(ts[1], rules, seed=seed)
    size = 96 * 1024
    monkeypatch.setenv("DLD_FLOW_FRAGMENT_BYTES", str(32 * 1024))
    monkeypatch.setattr(mod(pkg, "runtime.send"), "FLOW_FRAGMENT_BYTES",
                        32 * 1024)
    assignment = {1: {0: mod(pkg, "core.types").LayerMeta()}}
    leader = rt.FlowRetransmitLeaderNode(
        rt.Node(0, 0, ts[0]), {0: mem_layer(pkg, 0, size)}, assignment,
        node_network_bw={0: 10 ** 9, 1: 10 ** 9})
    receiver = rt.FlowRetransmitReceiverNode(rt.Node(1, 0, faulty), {})
    try:
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        receiver.ready().get(timeout=TIMEOUT)
        counts = _counters(pkg)
        assert counts.get("integrity.nack_sent", 0) >= 1, pkg
        assert counts.get("integrity.retransmit_frags", 0) >= 1, pkg
        return bytes(receiver.layers[0].inmem_data)
    finally:
        close_all(leader, receiver, ts)


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mode3_corrupt_fragment_nack_retransmit(kind, monkeypatch):
    """``test_integrity.py:229``: one fragment of a mode-3 transfer is
    dropped by injection; the NACKed range is re-sent and reassembly
    completes byte-exact."""
    assert both(_mode3_corrupt_fragment, kind, monkeypatch) == layer_bytes(
        0, 96 * 1024)


def _quiet_receiver(pkg):
    rt = mod(pkg, "runtime")
    ts = transports(pkg, "inmem", range(2))
    return ts, rt.FlowRetransmitReceiverNode(rt.Node(1, 0, ts[1]), {},
                                             start_loop=False)


def _gap_renack(pkg):
    ts, receiver = _quiet_receiver(pkg)
    msgs = _msgs(pkg)
    try:
        size = 8192
        data = layer_bytes(0, size)
        receiver.handle_layer(msgs.LayerMsg(
            0, 0, fragment(pkg, bytearray(data[:4096]), 0, 4096), size))
        nack = ts[0].deliver().get(timeout=TIMEOUT)
        assert isinstance(nack, msgs.LayerNackMsg)
        first = (nack.layer_id, nack.offset, nack.size, nack.reason)
        assert _counters(pkg).get("integrity.gap_renack", 0) >= 1
        receiver.handle_layer(msgs.LayerMsg(
            0, 0, fragment(pkg, bytearray(data[4096:]), 4096, 4096), size))
        got = bytes(receiver.layers[0].inmem_data)
        # Completion cleans the watchdog bookkeeping with the partials.
        assert 0 not in receiver._frag_src and 0 not in receiver._frag_t
        while True:  # further stale NACKs may precede the ack
            msg = ts[0].deliver().get(timeout=TIMEOUT)
            if type(msg).__name__ == "AckMsg":
                assert msg.layer_id == 0
                break
            assert isinstance(msg, msgs.LayerNackMsg)
        return first, got
    finally:
        close_all(receiver, ts)


def test_gap_watchdog_renacks_quiet_partial_layer(monkeypatch):
    """``test_integrity.py:263``: a partial layer quiet for a watchdog
    interval re-NACKs its gap ("stale") to the last sender; a late
    fragment still completes it."""
    monkeypatch.setenv("DLD_GAP_NACK_S", "0.2")
    first, got = both(_gap_renack)
    assert first == (0, 4096, 4096, "stale")
    assert got == layer_bytes(0, 8192)


def _gap_armed_by_corrupt(pkg):
    ts, receiver = _quiet_receiver(pkg)
    msgs = _msgs(pkg)
    try:
        size = 8192
        # The sink claims the range, the transport fails the CRC and
        # rolls the claim back, then reports the drop.
        _view, _tok, abort = receiver._layer_sink(0, size, 0, 4096)
        abort()
        receiver._on_corrupt_fragment(0, 0, 0, 4096, size, "crc")
        assert receiver._frag_src.get(0) == 0  # the watchdog is armed
        nacks = []
        for _ in range(2):
            m = ts[0].deliver().get(timeout=TIMEOUT)
            assert isinstance(m, msgs.LayerNackMsg)
            nacks.append((m.offset, m.size, m.reason))
        return nacks
    finally:
        close_all(receiver, ts)


def test_gap_watchdog_armed_by_corrupt_first_fragment(monkeypatch):
    """``test_integrity.py:305``: a layer whose only frame was dropped as
    corrupt arms the watchdog from the report; the quiet-gap ticker then
    re-requests the whole uncovered layer."""
    monkeypatch.setenv("DLD_GAP_NACK_S", "0.2")
    assert both(_gap_armed_by_corrupt) == [(0, 4096, "crc"),
                                            (0, 8192, "stale")]


# ------------------------------------------------------------ layer digests


def _own_digest_wins(pkg, announced):
    integrity = _integrity(pkg)
    stamp = (integrity.layer_digest(b"rotted bytes") if announced == "rot"
             else integrity.layer_digest(layer_bytes(0), algo="blake2b"))
    fake = types.SimpleNamespace(layers={0: mem_layer(pkg, 0)},
                                 _lock=threading.Lock(),
                                 layer_digests={0: stamp},
                                 _digests_ready=threading.Event())
    mod(pkg, "runtime").LeaderNode._compute_own_digests(fake)
    assert fake.layer_digests[0] == integrity.layer_digest(layer_bytes(0))
    assert fake._digests_ready.is_set()
    return (fake.layer_digests[0],
            _counters(pkg).get("integrity.digest_conflict", 0))


def test_leader_own_digest_wins_over_conflicting_announce():
    """``test_integrity.py:339``: a rotted holder's announce loses to the
    leader's own digest, loudly (one conflict)."""
    assert both(_own_digest_wins, "rot")[1] == 1


def test_mixed_algorithm_digest_announce_is_not_a_conflict():
    """``test_integrity.py:360``: a blake2b stamp over the same bytes is a
    capability difference, not a conflict; the leader's digest wins."""
    if _integrity(TORCH).digest_algo() != "xxh3":
        pytest.skip("no second digest algorithm available on this host")
    assert both(_own_digest_wins, "blake2b")[1] == 0


def _digest_check(pkg):
    integrity = _integrity(pkg)
    data = layer_bytes(3)
    out = []
    for algo in ("blake2b", None):
        stamp = integrity.layer_digest(data, algo=algo)
        ok, dt, got = integrity.digest_check(data, stamp)
        assert ok is True and got == stamp and dt >= 0.0
        bad, _, _ = integrity.digest_check(b"y" + data[1:], stamp)
        out.append((stamp, bad))
    assert integrity.digest_matches(data, integrity.layer_digest(data))
    return out


def test_digest_check_uses_stamp_algorithm():
    """``test_integrity.py:382``: a stamp is checked by its own
    algorithm; stamps equal the JAX package's."""
    assert [bad for _, bad in both(_digest_check)] == [False, False]


def _whole_layer_mismatch(pkg):
    rt, msgs, integrity = mod(pkg, "runtime"), _msgs(pkg), _integrity(pkg)
    ts = transports(pkg, "inmem", range(2))
    receiver = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {}, start_loop=False)
    try:
        receiver.handle_layer_digests(
            msgs.LayerDigestsMsg(0, {0: "00" * integrity.DIGEST_SIZE}))
        receiver.handle_layer(msgs.LayerMsg(0, 0, mem_layer(pkg, 0), SIZE))
        assert 0 not in receiver.layers  # never stored, never acked
        nack = ts[0].deliver().get(timeout=TIMEOUT)
        assert isinstance(nack, msgs.LayerNackMsg)
        # The correct stamp: the same bytes land and ack.
        receiver.layer_digests[0] = integrity.layer_digest(layer_bytes(0))
        receiver.handle_layer(msgs.LayerMsg(0, 0, mem_layer(pkg, 0), SIZE))
        return ((nack.layer_id, nack.offset, nack.size, nack.reason),
                bytes(receiver.layers[0].inmem_data))
    finally:
        close_all(receiver, ts)


def test_digest_mismatch_whole_layer_not_stored_and_nacked():
    """``test_integrity.py:393``: a whole layer whose digest mismatches is
    not stored and is NACKed for its whole range ("digest")."""
    assert both(_whole_layer_mismatch) == ((0, 0, SIZE, "digest"),
                                            layer_bytes(0))


def _next_protocol_msg(ts):
    # The announce path also sends advisory telemetry (TimeSyncMsg
    # probes, MetricsReportMsg snapshots); skip those.
    while True:
        msg = ts[0].deliver().get(timeout=TIMEOUT)
        if type(msg).__name__ not in ("TimeSyncMsg", "MetricsReportMsg"):
            return msg


def _mode3_reopen(pkg, order, ckpt):
    rt, msgs, integrity = mod(pkg, "runtime"), _msgs(pkg), _integrity(pkg)
    ts = transports(pkg, "inmem", range(2))
    receiver = rt.FlowRetransmitReceiverNode(
        rt.Node(1, 0, ts[1]), {}, start_loop=False, checkpoint_dir=ckpt)
    size = 8192
    data = layer_bytes(0, size)
    try:
        receiver.handle_layer_digests(
            msgs.LayerDigestsMsg(0, {0: "00" * integrity.DIGEST_SIZE}))

        def feed():
            halves = [(0, data[:4096]), (4096, data[4096:])]
            if order == "rev":
                halves.reverse()
            for off, chunk in halves:
                receiver.handle_layer(msgs.LayerMsg(
                    0, 0, fragment(pkg, bytearray(chunk), off, len(chunk)),
                    size))

        feed()
        # Demoted, not acked; its intervals reopened, its journal wiped.
        state = (0 in receiver.layers, receiver._partial.get(0),
                 os.path.exists(os.path.join(ckpt, "0.meta.json")))
        ann = _next_protocol_msg(ts)  # the recovery re-announce
        sent = [type(ann).__name__, sorted(ann.layer_ids), dict(ann.partial),
                dict(ann.digests)]
        receiver.layer_digests[0] = integrity.layer_digest(data)
        feed()  # the correct stamp: re-delivery completes and acks
        got = bytes(receiver.layers[0].inmem_data)
        ack = _next_protocol_msg(ts)
        sent.append((type(ack).__name__, ack.layer_id))
        return state, sent, got
    finally:
        close_all(receiver, ts)


@pytest.mark.parametrize("order", ["fwd", "rev"])
def test_mode3_digest_mismatch_reopens_intervals(order, tmp_path):
    """``test_integrity.py:415``: a completed mode-3 layer whose digest
    mismatches is demoted (store entry, partial state and journal gone,
    re-announced with no coverage of it) and never acked; a correct
    re-delivery in either order completes and acks.  The reopened state
    and the messages sent equal the JAX package's."""
    out = {pkg: _mode3_reopen(pkg, order, str(tmp_path / pkg / "ckpt"))
           for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    state, sent, got = out[TORCH]
    assert state == (False, None, False)
    assert sent[0] == "AnnounceMsg" and sent[-1] == ("AckMsg", 0)
    assert got == layer_bytes(0, 8192)


def _late_stamp(pkg):
    rt, msgs, integrity = mod(pkg, "runtime"), _msgs(pkg), _integrity(pkg)
    ts = transports(pkg, "inmem", range(2))
    receiver = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {}, start_loop=False)
    try:
        # No digest known yet: the layer stores and acks.
        receiver.handle_layer(msgs.LayerMsg(0, 0, mem_layer(pkg, 0), SIZE))
        seen = [0 in receiver.layers,
                type(ts[0].deliver().get(timeout=TIMEOUT)).__name__]
        # The stamp arrives late and mismatches: demote and re-announce.
        receiver.handle_layer_digests(
            msgs.LayerDigestsMsg(0, {0: "00" * integrity.DIGEST_SIZE}))
        seen += [sorted(receiver.layers),
                 type(ts[0].deliver().get(timeout=TIMEOUT)).__name__]
        # A matching late stamp leaves a held layer alone.
        receiver.layer_digests.clear()
        receiver.handle_layer(msgs.LayerMsg(0, 0, mem_layer(pkg, 0), SIZE))
        receiver.handle_layer_digests(msgs.LayerDigestsMsg(
            0, {0: integrity.layer_digest(layer_bytes(0))}))
        seen += [bytes(receiver.layers[0].inmem_data),
                 0 in receiver._digest_ok]
        return seen
    finally:
        close_all(receiver, ts)


def test_stamp_after_delivery_demotes_corrupt_layer():
    """``test_integrity.py:473``: a layer that acked before its stamp is
    demoted by a mismatching late stamp and re-announced; a matching one
    leaves it held.  The same layers are demoted as in the JAX package."""
    assert both(_late_stamp) == [True, "AckMsg", [], "AnnounceMsg",
                                  layer_bytes(0), True]


def _tiny_blob(pkg, seed):
    if pkg == JAX:
        from distributed_llm_dissemination_tpu.models import serde
        from distributed_llm_dissemination_tpu.models.llama import CONFIGS

        cfg = CONFIGS["tiny"]
        return cfg, lambda bid: serde.seeded_blob(cfg, bid, seed=seed)
    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS

    cfg = CONFIGS["tiny"]
    return cfg, lambda bid: serde.seeded_blob(cfg, bid, seed, "cpu")


def _stager(pkg, cfg, **kw):
    cls = mod(pkg, "runtime.stream_boot").StreamingBootStager
    return cls(cfg, device="cpu", **kw) if pkg == TORCH else cls(cfg, **kw)


def _leaf_bits(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        return t.view(torch.int16 if t.element_size() == 2
                      else torch.int32).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _stager_rejects(pkg):
    integrity = _integrity(pkg)
    cfg, blob = _tiny_blob(pkg, 0)
    head = mod(pkg, "models.serde").head_blob_id(cfg)
    blobs = {bid: blob(bid) for bid in range(head + 1)}
    digests = {bid: integrity.layer_digest(b) for bid, b in blobs.items()}
    bad_id = 0
    digests[bad_id] = "00" * integrity.DIGEST_SIZE
    verified = set()
    stager = _stager(pkg, cfg, digest_lookup=digests.get,
                     digest_verified=verified)
    try:
        for bid, b in blobs.items():
            assert stager.submit(bid, fragment(pkg, bytearray(b), 0, len(b)))
        staged = stager.collect(list(blobs), timeout=60.0)
        assert _counters(pkg).get("integrity.digest_mismatch", 0) >= 1
        return (blobs, sorted(staged), sorted(verified),
                {bid: {name: _leaf_bits(leaf) for name, leaf in
                       sorted(leaves.items())}
                 for bid, leaves in staged.items()})
    finally:
        stager.close()


def test_stream_stager_rejects_bad_digest_bulk_boot_infills():
    """``test_integrity.py:504``: the stager verifies each blob before its
    decode; the bad blob is absent from ``collect`` (the bulk boot infills
    it), the good ones are memoized as verified, and their staged leaves
    equal the JAX stager's bit for bit."""
    blobs, staged, verified, _ = both(_stager_rejects)
    assert staged == verified == sorted(set(blobs) - {0})


def _stager_restage(pkg):
    cfg, blob = _tiny_blob(pkg, 0)
    _, corrupt_blob = _tiny_blob(pkg, 1)
    corrupt, good = corrupt_blob(0), blob(0)
    stager = _stager(pkg, cfg)
    try:
        assert stager.submit(0, fragment(pkg, bytearray(corrupt), 0,
                                         len(corrupt)))
        first = stager.collect([0], timeout=60.0)[0]
        dup = stager.submit(0, fragment(pkg, bytearray(good), 0, len(good)))
        stager.invalidate(0)
        again = stager.submit(0, fragment(pkg, bytearray(good), 0,
                                          len(good)))
        second = stager.collect([0], timeout=60.0)[0]
        return (dup, again,
                {name: _leaf_bits(leaf) for name, leaf in first.items()},
                {name: _leaf_bits(leaf) for name, leaf in second.items()})
    finally:
        stager.close()


def test_stager_invalidate_allows_restage():
    """``test_integrity.py:539``: a blob staged before its mismatching
    stamp is invalidated; the redelivered bytes restage and ``collect``
    answers leaves of the new bytes, equal to the JAX stager's."""
    dup, again, first, second = both(_stager_restage)
    assert (dup, again) == (False, True)
    leaf = next(iter(first))
    assert first[leaf] != second[leaf]


# ----------------------------------------------------------------- journal


def _journal_tamper(pkg, path):
    store = mod(pkg, "runtime.checkpoint").LayerCheckpointStore(str(path))
    a, b = layer_bytes(1, 4096), layer_bytes(2, 4096)
    crcs = [(0, 4096, zlib.crc32(a) & 0xFFFFFFFF),
            (4096, 4096, zlib.crc32(b) & 0xFFFFFFFF)]
    store.write_bytes(1, 0, a, 8192)
    store.write_bytes(1, 4096, b, 8192)
    store.write_meta(1, [(0, 8192)], 8192, frag_crcs=crcs)
    buf, covered, total = store.load()[1]
    clean_state = (list(covered), bytes(buf), total)
    part = path / "1.part"  # tamper one byte of the second fragment
    raw = bytearray(part.read_bytes())
    raw[5000] ^= 0xFF
    part.write_bytes(bytes(raw))
    state = type(store)(str(path)).load()
    buf, covered, total = state[1]
    return (clean_state, list(covered), bytes(buf[:4096]),
            _counters(pkg).get("integrity.journal_bad_range", 0))


def test_journal_resume_rejects_tampered_disk_bytes(tmp_path):
    """``test_integrity.py:578``: a clean resume covers both fragments; a
    tampered byte reopens exactly the JAX package's range."""
    out = {pkg: _journal_tamper(pkg, tmp_path / pkg) for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    clean_state, covered, head, bad = out[TORCH]
    assert clean_state[0] == [(0, 8192)]
    assert covered == [(0, 4096)] and head == layer_bytes(1, 4096)
    assert bad == 1


def _journal_legacy(pkg, path):
    store = mod(pkg, "runtime.checkpoint").LayerCheckpointStore(str(path))
    a = layer_bytes(1, 1024)
    store.write_bytes(1, 0, a, 1024)
    store.write_meta(1, [(0, 1024)], 1024)  # no FragCrcs (legacy)
    return list(store.load()[1][1])


def test_journal_legacy_meta_without_crcs_still_loads(tmp_path):
    """``test_integrity.py:604``: a journal without fragment CRCs still
    loads its coverage."""
    out = {pkg: _journal_legacy(pkg, tmp_path / pkg) for pkg in PKGS}
    assert out[TORCH] == out[JAX] == [(0, 1024)]


# --------------------------------------------------- stale-group TTL NACK


def _ttl_pruned(pkg, monkeypatch):
    tcp_mod = mod(pkg, "transport.tcp")
    monkeypatch.setattr(tcp_mod, "_STRIPE_GROUP_TTL", 0.4)
    ts = transports(pkg, "tcp", range(2))
    got = queue.Queue()
    ts[1].on_corrupt = lambda *a: got.put(a)
    try:
        payload = layer_bytes(9, 64 * 1024)
        sub = fragment(pkg, bytearray(payload), 0, 32 * 1024)
        stripe = {"idx": 0, "n": 2, "off": 0, "span": len(payload),
                  "tid": "deadbeef"}
        ts[0]._send_one_stream(ts[1].get_address(),
                               _msgs(pkg).LayerMsg(0, 9, sub, len(payload)),
                               stripe=stripe)
        report = got.get(timeout=TIMEOUT)
        with ts[1]._lock:
            assert not ts[1]._stripe_groups  # the buffer is released
        return report
    finally:
        close_all(ts)


def test_ttl_pruned_stripe_group_is_nacked(monkeypatch):
    """``test_integrity.py:616``: a striped transfer abandoned after its
    first stripe is TTL-pruned and reported for the whole span
    ("stale"), as the JAX transport reports it."""
    assert both(_ttl_pruned, monkeypatch) == (0, 9, 0, 64 * 1024,
                                               64 * 1024, "stale")


# ------------------------------------------- the port's digest-stamp phase


def _stamped_round(pkg):
    rt = mod(pkg, "runtime")
    ts = transports(pkg, "inmem", range(2))
    assignment = {1: {i: mod(pkg, "core.types").LayerMeta() for i in (0, 1)}}
    leader = rt.LeaderNode(rt.Node(0, 0, ts[0]),
                           {i: mem_layer(pkg, i) for i in (0, 1)}, assignment)
    receiver = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {})
    try:
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        receiver.ready().get(timeout=TIMEOUT)
        assert receiver._digest_ok >= {0, 1}, pkg
        return ({lid: leader.layer_digests[lid] for lid in (0, 1)},
                {lid: bytes(receiver.layers[lid].inmem_data)
                 for lid in (0, 1)},
                mod(pkg, "utils.trace").phase_totals())
    finally:
        close_all(leader, receiver, ts)


def test_digest_stamp_phase_records_and_digests_match():
    """The port's ``utils/integrity.py::digest_layer_src`` sums the time
    holders spend digesting their layers into the
    ``integrity_digest_stamp`` phase.  A stamped mode-0 round records it;
    the stamps, and the bytes they verified, equal the JAX package's."""
    out = {pkg: _stamped_round(pkg) for pkg in PKGS}
    digests, held, phases = out[TORCH]
    assert (digests, held) == out[JAX][:2]
    assert digests == {lid: _integrity(JAX).layer_digest(layer_bytes(lid))
                       for lid in (0, 1)}
    assert phases["integrity_digest_stamp"]["n"] >= 2
    assert "integrity_digest_stamp" not in out[JAX][2]


# -------------------------------------------------------------- chaos soak


def _build_cluster(kind, mode, n_receivers=3, layer_size=24 * 1024,
                   fault_spec=""):
    """The port's twin of ``test_integrity.py:649``: 1 leader + n
    receivers, every transport wrapped in the seeded fault layer;
    receiver i+1 holds layer 100+i, the leader layers 0..n-1."""
    tr, rt = mod(TORCH, "transport"), mod(TORCH, "runtime")
    meta = mod(TORCH, "core.types").LayerMeta
    ids = range(n_receivers + 1)
    raw = transports(TORCH, kind, ids)
    ts = {}
    for i in ids:
        if fault_spec:
            seed, rules = tr.rules_from_spec(fault_spec)
            ts[i] = tr.FaultyTransport(raw[i], rules, seed=seed + i)
        else:
            ts[i] = raw[i]
    assignment = {}
    for i in range(n_receivers):
        want = {i: meta()}
        if mode != 0:
            want[100 + ((i + 1) % n_receivers)] = meta()
        assignment[i + 1] = want
    leader_layers = {i: mem_layer(TORCH, i, layer_size)
                     for i in range(n_receivers)}
    lnode = rt.Node(0, 0, ts[0])
    if mode == 0:
        leader = rt.LeaderNode(lnode, leader_layers, assignment)
    elif mode == 1:
        leader = rt.RetransmitLeaderNode(lnode, leader_layers, assignment)
    elif mode == 2:
        leader = rt.PullRetransmitLeaderNode(lnode, leader_layers, assignment)
    else:
        leader = rt.FlowRetransmitLeaderNode(
            lnode, leader_layers, assignment,
            node_network_bw={i: 10 ** 9 for i in ids})
    cls = (rt.ReceiverNode if mode == 0
           else rt.RetransmitReceiverNode if mode in (1, 2)
           else rt.FlowRetransmitReceiverNode)
    receivers = [cls(rt.Node(i + 1, 0, ts[i + 1]),
                     {100 + i: mem_layer(TORCH, 100 + i, layer_size)})
                 for i in range(n_receivers)]
    return leader, receivers, ts, assignment


CHAOS_SPEC = "seed=1,corrupt=3,dropin=5,dup=4,delay=7:5,times=6"


@pytest.mark.slow
@pytest.mark.timeout(420)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_chaos_soak_byte_exact_under_faults(kind, mode):
    """``test_integrity.py:698`` on the port: modes 0-3 on both transports
    under the same seeded corrupt, drop, dup and delay schedule deliver
    every layer byte-exact (the bytes the JAX soak holds), every stamped
    layer verifies, and the drop and retransmit counters fire."""
    tr, integrity = mod(TORCH, "transport"), _integrity(TORCH)
    leader, receivers, ts, assignment = _build_cluster(
        kind, mode, fault_spec=CHAOS_SPEC)
    try:
        for r in receivers:
            r.announce()
        leader.ready().get(timeout=120.0)
        for r in receivers:
            r.ready().get(timeout=TIMEOUT)
        for r in receivers:
            for lid in assignment[r.node.my_id]:
                src = r.layers[lid]
                assert bytes(src.inmem_data) == layer_bytes(
                    lid, src.data_size), (kind, mode, lid)
                expected = r._expected_digest(lid)
                if expected is not None:
                    assert integrity.layer_digest(
                        bytes(src.inmem_data)) == expected
        counts = _counters(TORCH)
        fired = sum(t.stats["corrupt"] + t.stats["drop"]
                    for t in ts.values() if isinstance(t, tr.FaultyTransport))
        assert fired > 0, "the fault schedule never fired; soak is vacuous"
        assert counts.get("integrity.crc_drop", 0) >= 1
        assert counts.get("integrity.retransmit_frags", 0) >= 1
    finally:
        leader.close()
        close_all(receivers, ts)
