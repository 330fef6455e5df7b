"""The port's negotiated wire codecs on ``tests/test_codec.py``'s cases.

The JAX file's plane, solver, digest, delta and stager/boot cases, run
with the port's classes (``runtime/codec.py`` is a copy of the JAX
module; ``models/quant.py`` and ``models/entropy.py`` are the port's).
Left out: the job quota and rate-limit cases (the job plane, not the
codec plane).  Its end-to-end cases keep their bounded waits and
run on ephemeral ports.

Added: mixed clusters over TCP -- a JAX leader with port receivers, and
a port leader with a JAX dest -- shipping int8, int4 and ``delta:``
forms byte-exact, each holding verified against its codec-qualified
digest on the receiving side.

The JAX file's account of the invariants:

- the codec vocabulary is strict: canonical bytes satisfy every target,
  a quantized holding satisfies ONLY its exact codec — int8 bytes can
  never complete (or ack as) a raw demand;
- encode is deterministic and ``decode_to_raw`` re-materializes the
  canonical blob layout exactly;
- the flow solver sizes a codec pair by its ENCODED bytes (the
  effective-capacity formulation) and never plans a quantized holder as
  a source for a raw-only dest — nor a raw holder that can't encode for
  a quantized pair — while a same-codec holder re-seeds verbatim;
- end to end: the leader chooses the codec per (dest, layer) by link
  rate, stamps it (with the CODEC-QUALIFIED digest) on the digest
  channel, the seeder encodes-on-send, the dest assembles in encoded
  byte space, verifies the encoded digest, acks codec-qualified, and
  the telemetry link table reconciles BYTE-EXACTLY with encoded wire
  bytes (the tier-1 guard) while fast links keep shipping raw;
- a codec-qualified digest mismatch re-opens the transfer instead of
  acking corruption, and recovery (NACK/retransmit) runs in encoded
  byte space under seeded faults.
"""

import os

import pytest

from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation,
    LayerMeta,
    LayerSrc,
    SourceType,
    codec_accepts,
    satisfies,
)
from distributed_llm_dissemination_tpu_torch.models import quant
from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
from distributed_llm_dissemination_tpu.models.llama import (
    CONFIGS as JAX_CONFIGS,
)
from distributed_llm_dissemination_tpu.models.serde import seeded_blob
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    Node,
)
from distributed_llm_dissemination_tpu_torch.runtime.codec import WireCodecPlane
from distributed_llm_dissemination_tpu_torch.sched.flow import (
    FlowGraph,
    pick_salvage_source,
)
from distributed_llm_dissemination_tpu_torch.transport import reset_registry
from distributed_llm_dissemination_tpu_torch.transport.faults import (
    FaultyTransport,
    rules_from_spec,
)
from distributed_llm_dissemination_tpu_torch.transport.messages import (
    LayerDigestsMsg,
    LayerMsg,
)
from distributed_llm_dissemination_tpu_torch.utils import integrity, telemetry, trace

from test_torch_node import close_all, make_transports

TIMEOUT = 20.0
CFG = CONFIGS["tiny"]


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    yield
    reset_registry()


def _raw_blob(lid: int) -> bytes:
    """The JAX package's seeded blob: the port's ``seeded_blob`` gives the
    same bytes (``tests/test_torch_seeded.py``)."""
    return seeded_blob(JAX_CONFIGS["tiny"], lid, 0)


def _enc_blob(lid: int, codec: str = "int8") -> bytes:
    return quant.encode_blob(CFG, lid, _raw_blob(lid), codec)


def _blob_layer(lid: int, rate: int = 0) -> LayerSrc:
    data = _raw_blob(lid)
    return LayerSrc(
        inmem_data=bytearray(data), data_size=len(data),
        meta=LayerMeta(location=LayerLocation.INMEM, limit_rate=rate,
                       source_type=SourceType.MEM),
    )


def _plane(wire_codec: str = "int8") -> WireCodecPlane:
    return WireCodecPlane(CFG, wire_codec=wire_codec)


# ------------------------------------------------------ codec vocabulary


def test_codec_vocabulary():
    # Canonical bytes satisfy everything; quantized only its own form.
    assert codec_accepts("", "") and codec_accepts("", "int8")
    assert codec_accepts("int8", "int8")
    assert not codec_accepts("int8", "")
    assert not codec_accepts("int8", "int4")
    held = LayerMeta(location=LayerLocation.INMEM, codec="int8")
    assert satisfies(held, LayerMeta(codec="int8"))
    assert not satisfies(held, LayerMeta())  # the acceptance invariant
    assert not satisfies(held, LayerMeta(codec="int4"))
    raw = LayerMeta(location=LayerLocation.INMEM)
    assert satisfies(raw, LayerMeta(codec="int8"))  # raw is the superset


def test_encode_deterministic_and_decode_to_raw_layout():
    raw = _raw_blob(0)
    for codec in ("int8", "int4"):
        enc1 = quant.encode_blob(CFG, 0, raw, codec)
        enc2 = quant.encode_blob(CFG, 0, bytes(raw), codec)
        assert enc1 == enc2, f"{codec} encode is not deterministic"
        assert len(enc1) == quant.blob_nbytes_codec(CFG, 0, codec)
        # decode_to_raw re-materializes the canonical LAYOUT exactly:
        # re-encoding the decoded form reproduces the encoded bytes.
        back = quant.decode_to_raw(CFG, 0, enc1, codec)
        assert len(back) == len(raw)
        assert quant.encode_blob(CFG, 0, back, codec) == enc1


def test_wire_codec_plane_serves_and_caches_encoded_form():
    plane = _plane()
    assert plane.enabled
    assert set(plane.decode_codecs()) == {"int8", "int4", "int8e",
                                          "int4e", "delta"}
    layer = _blob_layer(0)
    enc = plane.encoded_src(0, layer, "int8")
    assert enc is not None and bytes(enc.inmem_data) == _enc_blob(0)
    assert enc.meta.codec == "int8"
    # Cached: the second call returns the same buffer (no re-encode).
    again = plane.encoded_src(0, layer, "int8")
    assert again.inmem_data is enc.inmem_data
    # The codec-qualified digest is the digest of the ENCODED bytes.
    d = plane.encoded_digest(0, layer, "int8")
    assert d == integrity.layer_digest(_enc_blob(0))
    # A non-model holding (size mismatch) refuses to encode.
    junk = LayerSrc(inmem_data=bytearray(b"x" * 100), data_size=100,
                    meta=LayerMeta(location=LayerLocation.INMEM))
    assert plane.encoded_src(2, junk, "int8") is None
    # An already-encoded holding never re-encodes.
    assert plane.encoded_src(0, enc, "int8") is None


# ------------------------------------------------------------- planner


RAW = len(_raw_blob(0))
ENC = len(_enc_blob(0))


def _graph(assignment, status, node_codecs=None, bw=1 << 30):
    nodes = set(status) | set(assignment)
    return FlowGraph(assignment, status, {7: RAW},
                     {n: bw for n in nodes},
                     codec_sizes={(7, "int8"): ENC},
                     node_codecs=node_codecs or {})


def test_flow_solver_sizes_codec_pair_by_encoded_bytes():
    status = {0: {7: LayerMeta(location=LayerLocation.INMEM,
                               data_size=RAW)}}
    # Link rate = RAW bytes/s, so the raw plan takes ~1000 ms and the
    # time ratio is readable.
    raw_t, raw_jobs = _graph({2: {7: LayerMeta()}}, status,
                             {0: frozenset(["int8"])},
                             bw=RAW).get_job_assignment()
    enc_t, enc_jobs = _graph({2: {7: LayerMeta(codec="int8")}}, status,
                             {0: frozenset(["int8"])},
                             bw=RAW).get_job_assignment()
    assert sum(j.data_size for jl in raw_jobs.values() for j in jl) == RAW
    planned = [j for jl in enc_jobs.values() for j in jl]
    assert sum(j.data_size for j in planned) == ENC
    assert all(j.offset + j.data_size <= ENC for j in planned)
    # Effective capacity = bandwidth x ratio: the predicted time shrinks
    # by the compression ratio (floor granularity aside).
    assert enc_t < raw_t
    assert enc_t <= raw_t * (ENC / RAW) + 2


def test_solver_never_plans_quantized_holder_for_raw_dest():
    # The ONLY holder has int8 bytes; the target wants raw: nothing may
    # be planned from it (acceptance criterion, docs/codec.md).
    status = {1: {7: LayerMeta(location=LayerLocation.INMEM,
                               data_size=ENC, codec="int8")}}
    _, jobs = _graph({2: {7: LayerMeta()}}, status).get_job_assignment()
    assert not jobs, f"quantized holder planned as raw source: {jobs}"
    # With a raw holder alongside, every byte comes from the raw one.
    status[0] = {7: LayerMeta(location=LayerLocation.INMEM,
                              data_size=RAW)}
    _, jobs = _graph({2: {7: LayerMeta()}}, status).get_job_assignment()
    senders = {j.sender_id for jl in jobs.values() for j in jl}
    assert senders == {0}


def test_solver_codec_pair_needs_encoder_or_same_codec_holder():
    raw_holder = {0: {7: LayerMeta(location=LayerLocation.INMEM,
                                   data_size=RAW)}}
    want = {2: {7: LayerMeta(codec="int8")}}
    # A raw holder WITHOUT encode capability can't serve the pair.
    _, jobs = _graph(want, raw_holder, node_codecs={}).get_job_assignment()
    assert not jobs
    # With capability it can.
    _, jobs = _graph(want, raw_holder,
                     node_codecs={0: frozenset(["int8"])}
                     ).get_job_assignment()
    assert sum(j.data_size for jl in jobs.values() for j in jl) == ENC
    # A SAME-codec holder re-seeds verbatim — no encode capability
    # needed (the encoded bytes forward as-is).
    enc_holder = {1: {7: LayerMeta(location=LayerLocation.INMEM,
                                   data_size=ENC, codec="int8")}}
    _, jobs = _graph(want, enc_holder, node_codecs={}).get_job_assignment()
    senders = {j.sender_id for jl in jobs.values() for j in jl}
    assert senders == {1}
    assert sum(j.data_size for jl in jobs.values() for j in jl) == ENC


def test_solver_never_plans_client_held_sender_for_codec_pair():
    """Regression: a CLIENT-held copy can only pipe-stream RAW
    bytes the node never touches — it must never be planned as a
    source for a quantized pair, whatever the node's own announced
    capability."""
    status = {1: {7: LayerMeta(location=LayerLocation.CLIENT,
                               data_size=RAW)}}
    want = {2: {7: LayerMeta(codec="int8")}}
    _, jobs = _graph(want, status,
                     node_codecs={1: frozenset(["int8"])}
                     ).get_job_assignment()
    assert not jobs, f"client-held copy planned for a codec pair: {jobs}"
    # The same holder serves the RAW pair fine (the normal pipe path).
    _, jobs = _graph({2: {7: LayerMeta()}}, status,
                     node_codecs={1: frozenset(["int8"])}
                     ).get_job_assignment()
    assert jobs


def test_digests_off_stamp_carries_explicit_codec_reversion(monkeypatch):
    """Regression: with digests OFF the codec map is the only
    channel that can tell a dest a pair REVERTED to raw (a plane-less
    takeover) — the stamp must carry explicit "" entries, and the dest
    must clear its stale codec expectation on them."""
    monkeypatch.setenv("DLD_LAYER_DIGESTS", "0")
    ts, _ = make_transports("inmem", [0, 1])
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {}, {1: {0: LayerMeta()}},
        {0: 1 << 30, 1: 1 << 30})
    r = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {},
                                   start_loop=False)
    try:
        leader._codec_seen = True  # a pair was once chosen quantized
        leader._codec_choice[(1, 0)] = ""  # ...and has reverted to raw
        leader._send_digests_to(1)
        msg = ts[1].deliver().get(timeout=TIMEOUT)
        assert isinstance(msg, LayerDigestsMsg)
        assert msg.codecs == {0: ""}
        # The dest's stale expectation clears on the explicit "".
        r._layer_codecs[0] = "int8"
        r.handle_layer_digests(msg)
        assert 0 not in r._layer_codecs
    finally:
        leader.close()
        r.close()
        for t in ts.values():
            t.close()


def test_mode1_owner_pool_excludes_codec_holders():
    """Regression: mode 1/2's per-layer owner pool can't express
    per-pair codec admissibility, so a quantized holder must never
    enter it — a deterministic owner pick would otherwise forward
    encoded bytes as a raw delivery."""
    from distributed_llm_dissemination_tpu_torch.runtime import (
        RetransmitLeaderNode,
    )

    ts, _ = make_transports("inmem", [0, 1, 2])
    leader = RetransmitLeaderNode(Node(0, 0, ts[0]),
                                  {0: _blob_layer(0)}, {})
    try:
        leader.status[1] = {0: LayerMeta(location=LayerLocation.INMEM,
                                         data_size=ENC, codec="int8")}
        leader.status[2] = {0: LayerMeta(location=LayerLocation.INMEM,
                                         data_size=RAW)}
        with leader._lock:
            leader._build_layer_owners()
        assert leader.layer_owners[0] == {0, 2}, (
            "codec holder entered the mode-1 owner pool")
    finally:
        leader.close()
        for t in ts.values():
            t.close()


def test_pick_salvage_source_is_codec_aware():
    status = {
        0: {7: LayerMeta(location=LayerLocation.INMEM)},          # raw
        1: {7: LayerMeta(location=LayerLocation.INMEM,
                         codec="int8")},                          # int8
    }
    # Raw need: the int8 holder never qualifies.
    assert pick_salvage_source(status, 7, exclude={0}) is None
    # Codec need: the same-codec holder qualifies; the raw holder only
    # with encode capability.
    assert pick_salvage_source(status, 7, need_codec="int8",
                               exclude={0}) == 1
    assert pick_salvage_source(status, 7, need_codec="int8",
                               exclude={1}) is None
    assert pick_salvage_source(status, 7, need_codec="int8",
                               exclude={1},
                               encoders=frozenset([0])) == 0


# ------------------------------------------------------------ end to end


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_codec_wire_end_to_end_mixed_links(kind, monkeypatch):
    """The tentpole e2e: one leader-held model layer set, one SLOW dest
    (NIC below the threshold — ships int8, digest-stamped) and one FAST
    dest (ships raw).  Asserts byte-exact encoded delivery, verified
    codec-qualified digests, codec-qualified acks/status, and the
    tier-1 guard: the telemetry link table reconciles BYTE-EXACTLY with
    ENCODED wire bytes while the decoded side rides its own counters."""
    monkeypatch.setenv("DLD_CODEC_MIN_RATE", str(64 << 20))
    telemetry.reset_run()
    ids = [0, 1, 2]
    ts, _ = make_transports(kind, ids)
    lids = [0, 1]
    layers = {lid: _blob_layer(lid) for lid in lids}
    assignment = {1: {lid: LayerMeta() for lid in lids},
                  2: {lid: LayerMeta() for lid in lids}}
    bw = {0: 1 << 30, 1: 4 << 20, 2: 1 << 30}  # dest 1 is the slow link
    leader = FlowRetransmitLeaderNode(Node(0, 0, ts[0]), layers,
                                      assignment, bw, codecs=_plane())
    receivers = [FlowRetransmitReceiverNode(Node(i, 0, ts[i]), {},
                                            codecs=_plane())
                 for i in (1, 2)]
    try:
        for r in receivers:
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        slow, fast = receivers
        for lid in lids:
            enc = _enc_blob(lid)
            # Slow dest: the encoded form, byte-exact, codec-qualified,
            # digest-verified against the ENCODED digest.
            src = slow.layers[lid]
            assert src.meta.codec == "int8"
            assert bytes(src.inmem_data) == enc
            assert lid in slow._digest_ok
            assert slow.content_store.codec_of(lid) == "int8"
            assert leader.status[1][lid].codec == "int8"
            # Fast dest: canonical bytes, raw ack.
            assert fast.layers[lid].meta.codec == ""
            assert bytes(fast.layers[lid].inmem_data) == _raw_blob(lid)
            assert leader.status[2][lid].codec == ""
            # The leader's content index keys the two forms apart.
            assert leader.content.node_has(
                1, integrity.layer_digest(enc), codec="int8")
            assert not leader.content.node_has(
                1, integrity.layer_digest(enc))
        # Tier-1 guard: link-table delivered bytes reconcile BYTE-EXACT
        # with ENCODED wire bytes per dest (never the decoded side).
        enc_total = sum(len(_enc_blob(lid)) for lid in lids)
        raw_total = sum(len(_raw_blob(lid)) for lid in lids)
        links = telemetry.snapshot()["links"]

        def delivered_to(dest):
            return sum(row.get("delivered_bytes", 0)
                       for key, row in links.items()
                       if "#" not in key and key.endswith(f"->{dest}"))

        assert delivered_to(1) == enc_total
        assert delivered_to(2) == raw_total
        counts = trace.counter_totals()
        assert counts.get("codec.wire_bytes", 0) == enc_total
        assert counts.get("codec.decoded_bytes", 0) == raw_total
        # The run report carries BOTH columns, unconflated.
        dests = leader.dest_bytes_table()
        assert dests["1"]["wire_bytes"] == enc_total
        assert dests["1"]["decoded_bytes"] == raw_total
        assert dests["1"]["codec_layers"] == len(lids)
        assert dests["2"]["wire_bytes"] == raw_total
        assert dests["2"]["codec_layers"] == 0
    finally:
        close_all(leader, receivers, ts)


def test_codec_digest_mismatch_reopens_and_redelivery_verifies():
    """Acceptance regression: a quantized copy whose bytes don't hash
    to the CODEC-QUALIFIED digest is demoted (never acked/stored) and
    re-requested; the correctly stamped redelivery verifies and stores
    codec-qualified."""
    ts, _ = make_transports("inmem", [0, 1])
    r = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {}, codecs=_plane())
    try:
        enc = _enc_blob(0)
        wrong = integrity.layer_digest(b"not the encoded bytes")
        r.handle_layer_digests(LayerDigestsMsg(
            0, {0: wrong}, codecs={0: "int8"}))

        def deliver():
            src = LayerSrc(inmem_data=bytearray(enc), data_size=len(enc),
                           meta=LayerMeta(location=LayerLocation.INMEM))
            r.handle_layer(LayerMsg(0, 0, src, len(enc), codec="int8"))

        before = trace.counter_totals().get("integrity.digest_mismatch", 0)
        deliver()
        # Mismatch: the layer is demoted — intervals re-opened, nothing
        # acked into the goal state.
        assert 0 not in r.layers
        assert trace.counter_totals().get(
            "integrity.digest_mismatch", 0) > before
        # The corrected stamp (the re-request's) resets the verdict and
        # the redelivery verifies against the encoded digest.
        r.handle_layer_digests(LayerDigestsMsg(
            0, {0: integrity.layer_digest(enc)}, codecs={0: "int8"}))
        deliver()
        assert 0 in r.layers
        assert r.layers[0].meta.codec == "int8"
        assert bytes(r.layers[0].inmem_data) == enc
        assert 0 in r._digest_ok
    finally:
        r.close()
        for t in ts.values():
            t.close()


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_chaos_quantized_wire_corrupt_dup_slow(kind, monkeypatch):
    """Chaos coverage (docs/codec.md): the seeded fault injector
    corrupts/drops/dups frames of a QUANTIZED multi-fragment transfer
    over a rate-limited link — NACK/retransmit recovery runs in encoded
    byte space and the delivered layer verifies digest-exact."""
    import distributed_llm_dissemination_tpu_torch.runtime.send as send_mod

    monkeypatch.setenv("DLD_CODEC_MIN_RATE", str(64 << 20))
    monkeypatch.setattr(send_mod, "FLOW_FRAGMENT_BYTES", 32 * 1024)
    telemetry.reset_run()
    ts, _ = make_transports(kind, [0, 1])
    seed, rules = rules_from_spec(
        "seed=3,corrupt=2,dup=5,times=3,slow=2000000")
    faulty = FaultyTransport(ts[1], rules, seed=seed)
    layers = {0: _blob_layer(0, rate=4 << 20)}
    assignment = {1: {0: LayerMeta()}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), layers, assignment,
        {0: 1 << 30, 1: 4 << 20}, codecs=_plane())
    receiver = FlowRetransmitReceiverNode(Node(1, 0, faulty), {},
                                          codecs=_plane())
    try:
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        enc = _enc_blob(0)
        src = receiver.layers[0]
        assert src.meta.codec == "int8"
        assert bytes(src.inmem_data) == enc
        assert 0 in receiver._digest_ok
        counts = trace.counter_totals()
        assert faulty.stats.get("corrupt", 0) >= 1, "fault never fired"
        assert counts.get("integrity.crc_drop", 0) >= 1
        assert counts.get("integrity.nack_sent", 0) >= 1
        assert counts.get("integrity.retransmit_frags", 0) >= 1
    finally:
        close_all(leader, [receiver], ts)


# ------------------------------------------- entropy + delta wire forms


def test_codec_registry_drift_guards():
    """The model registry, the runtime plane, the codec_bench table, the
    TTD markdown renderer (``cli/ttd_matrix``) and the wire-compat
    enumeration agree on the codec id set."""
    import inspect

    from distributed_llm_dissemination_tpu_torch.cli import ttd_matrix
    from distributed_llm_dissemination_tpu_torch.runtime.codec import (
        ENTROPY_FORMS,
        WHOLE_FORM_CODECS,
    )

    registered = set(quant.CODECS) - {"raw"}
    assert set(WHOLE_FORM_CODECS) == registered
    assert set(ENTROPY_FORMS) == set(quant.ENTROPY_CODECS)
    assert set(quant.ENTROPY_CODECS.values()) <= registered
    all_ids = registered | {"delta"}
    bench = quant.codec_bench(CFG, device="cpu")
    missing = all_ids - set(bench)
    assert not missing, f"codec_bench has no row for {sorted(missing)}"
    for codec in sorted(all_ids):
        row = bench[codec]
        assert row["encoded_bytes"] > 0 and row["encode_gbps"] > 0
        assert row["decode_host_gbps"] > 0
    for src in (inspect.getsource(ttd_matrix),
                open(__file__.replace("test_torch_codec",
                                      "test_messages_compat")).read()):
        for codec in sorted(all_ids):
            assert f'"{codec}"' in src, f"{codec} missing from {src[:40]}"


def test_plane_entropy_form_true_sizing_and_roundtrip():
    """The entropy forms are DATA-DEPENDENT: the plane refuses to guess
    their size (``nbytes`` None until sized), prices them by actually
    encoding once (``ensure_sized``), and the served stream peels back
    to exactly the base quantized bytes."""
    from distributed_llm_dissemination_tpu_torch.models import entropy

    plane = _plane(wire_codec="int8e")
    assert plane.enabled
    layer = _blob_layer(0)
    assert plane.nbytes(0, "int8e") is None  # unsized: data-dependent
    n = plane.ensure_sized(0, layer, "int8e")
    assert n is not None and n == plane.nbytes(0, "int8e")
    enc = plane.encoded_src(0, layer, "int8e")
    assert enc is not None and enc.data_size == n
    assert enc.meta.codec == "int8e"
    # The stream is a DLE1 coat over the int8 base form.
    assert entropy.decode(bytes(enc.inmem_data)) == _enc_blob(0, "int8")
    base, bb = quant.host_unwrap("int8e", bytes(enc.inmem_data))
    assert base == "int8" and bb == _enc_blob(0, "int8")
    # The codec-qualified digest is of the ENTROPY stream itself.
    d = plane.encoded_digest(0, layer, "int8e")
    assert d == integrity.layer_digest(bytes(enc.inmem_data))
    # Family thresholds: entropy and delta gates are their own knobs.
    assert plane.min_rate_for("int8") == plane.min_rate
    assert plane.min_rate_for("int8e") == plane.entropy_min_rate
    assert plane.min_rate_for("int4e") == plane.entropy_min_rate
    assert plane.min_rate_for("delta:" + "ab" * 8) == plane.delta_min_rate
    # Entropy sizes raise in quant (never guessed from the model).
    with pytest.raises(ValueError):
        quant.blob_nbytes_codec(CFG, 0, "int8e")


def _delta_fixture(n=256 << 10, stride=512):
    # Deterministic byte planes: v2 is a lightly-perturbed v1 sibling.
    v1 = bytes((i * 131 + 17) & 0xFF for i in range(n))
    v2 = bytearray(v1)
    for i in range(0, n, stride):
        v2[i] ^= 0xA5
    return v1, bytes(v2)


def test_plane_delta_modelless_encode_reconstruct_and_refusals():
    """The delta form needs NO model config — it rides arbitrary layer
    bytes — but it does need a VERIFIED base on both ends: the plane
    encodes only against a base its resolver vouches for, reconstructs
    only against a held base, and refuses (None, loudly) on a missing
    base or a length mismatch instead of shipping garbage."""
    v1, v2 = _delta_fixture()
    base_digest = integrity.layer_digest(v1)
    codec = "delta:" + base_digest
    plane = WireCodecPlane(None)
    assert plane.delta_enabled
    assert set(plane.decode_codecs()) >= {"delta"}
    base_src = LayerSrc(inmem_data=bytearray(v1), data_size=len(v1),
                        meta=LayerMeta(location=LayerLocation.INMEM))
    layer = LayerSrc(inmem_data=bytearray(v2), data_size=len(v2),
                     meta=LayerMeta(location=LayerLocation.INMEM))
    # No resolver wired: the plane can neither produce nor price delta.
    assert plane.encoded_src(5, layer, codec) is None
    plane.base_resolver = (
        lambda d: base_src if d == base_digest else None)
    enc = plane.encoded_src(5, layer, codec)
    assert enc is not None and enc.meta.codec == codec
    assert enc.data_size < len(v2) // 4  # the order-of-magnitude win
    # True-size cache: the solver prices the pair at the encoded size.
    assert plane.nbytes(5, codec) == enc.data_size
    assert plane.ensure_sized(5, None, codec) == enc.data_size
    # Reconstruction is byte-exact against the held base.
    assert plane.delta_reconstruct(5, bytes(enc.inmem_data), codec) == v2
    # Refusals: an unheld base, and a base of the wrong length.
    other = "delta:" + integrity.layer_digest(b"something else")
    assert plane.encoded_src(6, layer, other) is None
    assert plane.delta_reconstruct(6, bytes(enc.inmem_data), other) is None
    short = LayerSrc(inmem_data=bytearray(v1[:-1]),
                     data_size=len(v1) - 1,
                     meta=LayerMeta(location=LayerLocation.INMEM))
    plane.base_resolver = (
        lambda d: short if d == base_digest else None)
    plane._cache.clear()
    plane._sizes.clear()
    assert plane.encoded_src(7, layer, codec) is None
    # A model-less plane can never serve WHOLE forms (no blob layout).
    assert plane.encoded_src(5, layer, "int8") is None
    # Env kill switch: DLD_DELTA_CODEC=0 disables choosing delta.
    os.environ["DLD_DELTA_CODEC"] = "0"
    try:
        assert not WireCodecPlane(None).delta_enabled
    finally:
        del os.environ["DLD_DELTA_CODEC"]


def test_solver_delta_pair_needs_capability_and_base_holder():
    """A ``delta:<hex>`` pair is only admissible from a sender holding
    BOTH the generic delta capability and a verified copy of the base
    (``FlowGraph.base_holders``) — and it is priced at the encoded
    delta size, not raw."""
    base = integrity.layer_digest(b"v1 bytes")
    codec = "delta:" + base
    DSZ = 1000
    raw_holders = {
        0: {7: LayerMeta(location=LayerLocation.INMEM, data_size=RAW)},
        1: {7: LayerMeta(location=LayerLocation.INMEM, data_size=RAW)},
    }
    want = {2: {7: LayerMeta(codec=codec)}}

    def graph(node_codecs, base_holders):
        return FlowGraph(want, raw_holders, {7: RAW},
                         {n: 1 << 30 for n in (0, 1, 2)},
                         codec_sizes={(7, codec): DSZ},
                         node_codecs=node_codecs,
                         base_holders=base_holders)

    # Capability without the base: inadmissible.
    _, jobs = graph({0: frozenset(["delta"]), 1: frozenset(["delta"])},
                    {}).get_job_assignment()
    assert not jobs, f"delta planned without a base holder: {jobs}"
    # Base without the capability: inadmissible.
    _, jobs = graph({}, {base: frozenset([0, 1])}).get_job_assignment()
    assert not jobs
    # Both — but only on sender 0: every byte comes from 0, priced at
    # the encoded delta size.
    _, jobs = graph({0: frozenset(["delta"]), 1: frozenset(["delta"])},
                    {base: frozenset([0])}).get_job_assignment()
    senders = {j.sender_id for jl in jobs.values() for j in jl}
    assert senders == {0}
    planned = [j for jl in jobs.values() for j in jl]
    assert sum(j.data_size for j in planned) == DSZ
    assert all(j.offset + j.data_size <= DSZ for j in planned)
    # Salvage stays base-aware through the same vocabulary: a NACK
    # replacement sender must satisfy the full codec string too.
    assert pick_salvage_source(
        raw_holders, 7, need_codec=codec, exclude={0},
        encoders=frozenset([1])) in (None, 1)


@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_chaos_delta_wire_end_to_end(kind, monkeypatch):
    """The delta-tentpole e2e (docs/codec.md), under seeded faults on
    BOTH backends: a dest that verified v1 gets a v2 sibling as an
    encoded ``delta:<v1-digest>`` stream — corrupt/dup'd frames recover
    via NACK in the DELTA's byte coordinates — and the reconstructed
    layer verifies the stamped full-form digest before acking, with the
    telemetry link table reconciling in encoded byte space."""
    import distributed_llm_dissemination_tpu_torch.runtime.send as send_mod

    monkeypatch.setattr(send_mod, "FLOW_FRAGMENT_BYTES", 16 * 1024)
    telemetry.reset_run()
    ts, _ = make_transports(kind, [0, 1])
    seed, rules = rules_from_spec("seed=5,corrupt=2,dup=7,times=3")
    faulty = FaultyTransport(ts[1], rules, seed=seed)
    v1, v2 = _delta_fixture(n=512 << 10, stride=64)
    layers = {0: LayerSrc(inmem_data=bytearray(v1), data_size=len(v1),
                          meta=LayerMeta(location=LayerLocation.INMEM,
                                         limit_rate=8 << 20,
                                         source_type=SourceType.MEM))}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), layers, {1: {0: LayerMeta()}},
        {0: 1 << 30, 1: 8 << 20}, codecs=WireCodecPlane(None))
    receiver = FlowRetransmitReceiverNode(Node(1, 0, faulty), {},
                                          codecs=WireCodecPlane(None))
    try:
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        assert 0 in receiver._digest_ok  # the verified v1 base
        with leader._lock:
            leader.layers[100] = LayerSrc(
                inmem_data=bytearray(v2), data_size=len(v2),
                meta=LayerMeta(location=LayerLocation.INMEM,
                               limit_rate=8 << 20,
                               source_type=SourceType.MEM))
        leader.submit_job(
            "v2-delta", {1: {100: LayerMeta()}}, priority=1,
            kind="push", digests={100: integrity.layer_digest(v2)})
        leader.ready().get(timeout=TIMEOUT)
        # The leader chose the delta form against the dest's v1 base.
        choice = leader._codec_choice.get((1, 100), "")
        assert choice == "delta:" + integrity.layer_digest(v1), choice
        # Byte-exact reconstruction, full-form digest verified, and the
        # holding re-keyed canonical (servable raw).
        src = receiver.layers[100]
        assert bytes(src.inmem_data) == v2
        assert src.meta.codec == ""
        assert 100 in receiver._digest_ok
        counts = trace.counter_totals()
        assert counts.get("codec.delta_pairs_chosen", 0) >= 1
        assert counts.get("codec.delta_reconstructed", 0) >= 1
        delta_wire = counts.get("codec.delta_wire_bytes", 0)
        assert 0 < delta_wire < len(v2) // 4
        # The link table reconciles in ENCODED byte space: the v2 job's
        # delivered bytes are the delta stream's, never raw's.
        links = telemetry.snapshot()["links"]
        job_rx = sum(row.get("delivered_bytes", 0)
                     for key, row in links.items()
                     if key.endswith("#v2-delta"))
        assert job_rx == delta_wire
        # The faults really fired and recovery ran in delta coordinates.
        assert faulty.stats.get("corrupt", 0) >= 1, "fault never fired"
        assert counts.get("integrity.nack_sent", 0) >= 1
    finally:
        close_all(leader, [receiver], ts)


def test_content_equal_pair_resolves_free_over_any_delta():
    """A v2 id whose digest the dest PROVABLY already holds rides the
    content store's zero-wire resolve, never a codec stamp — even a
    near-empty delta ships bytes a skip doesn't (the delta_rollout
    row's unchanged layers; docs/codec.md).  The genuinely changed
    sibling in the same job still rides the delta form."""
    if not integrity.digests_enabled():
        pytest.skip("content addressing needs layer digests")
    telemetry.reset_run()
    ts, _ = make_transports("inmem", [0, 1])
    v1, v2 = _delta_fixture(n=128 << 10, stride=64)

    def mk(b):
        return LayerSrc(inmem_data=bytearray(b), data_size=len(b),
                        meta=LayerMeta(location=LayerLocation.INMEM,
                                       limit_rate=8 << 20,
                                       source_type=SourceType.MEM))

    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {0: mk(v1)}, {1: {0: LayerMeta()}},
        {0: 1 << 30, 1: 8 << 20}, codecs=WireCodecPlane(None))
    receiver = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {},
                                          codecs=WireCodecPlane(None))
    try:
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        before = trace.counter_totals().get("store.resolved_layers", 0)
        with leader._lock:
            leader.layers[100] = mk(v1)  # content-equal to held v1
            leader.layers[101] = mk(v2)  # genuinely changed
        leader.submit_job(
            "v2", {1: {100: LayerMeta(), 101: LayerMeta()}}, priority=1,
            kind="push",
            digests={100: integrity.layer_digest(v1),
                     101: integrity.layer_digest(v2)})
        leader.ready().get(timeout=TIMEOUT)
        assert leader._codec_choice.get((1, 100), "") == ""
        assert leader._codec_choice.get(
            (1, 101), "") == "delta:" + integrity.layer_digest(v1)
        assert bytes(receiver.layers[100].inmem_data) == v1
        assert bytes(receiver.layers[101].inmem_data) == v2
        assert trace.counter_totals().get(
            "store.resolved_layers", 0) == before + 1
        # The job's wire bytes are ONE small delta stream — the
        # content-equal pair shipped nothing.
        links = telemetry.snapshot()["links"]
        job_rx = sum(row.get("delivered_bytes", 0)
                     for key, row in links.items()
                     if key.endswith("#v2"))
        assert 0 < job_rx < len(v2) // 4
    finally:
        close_all(leader, [receiver], ts)


# -------------------------------------------------- failover replication


def test_shadow_replicates_codec_state():
    from distributed_llm_dissemination_tpu_torch.runtime.failover import (
        ShadowLeaderState,
    )
    from distributed_llm_dissemination_tpu_torch.transport.messages import (
        ControlDeltaMsg,
    )

    shadow = ShadowLeaderState()
    shadow.apply(ControlDeltaMsg(0, 1, 0, "snapshot", {
        "Mode": 3, "Assignment": {}, "Status": {},
        "WireCodecs": {"2:7": "int8"},
        "NodeCodecs": {"2": ["int8", "int4"]},
    }))
    # The codecs delta carries the leader's FULL current maps and
    # REPLACES: a revoked capability / reverted choice is an absent
    # entry, and a merge would resurrect it at takeover.
    shadow.apply(ControlDeltaMsg(0, 1, 1, "codecs", {
        "Choices": {"2:7": "int8", "3:8": "int4"},
        "NodeCodecs": {"3": ["int4"]},
    }))
    shadow.apply(ControlDeltaMsg(0, 1, 2, "ack", {
        "Node": 2, "Layer": 7, "Location": 0, "Size": 100,
        "Codec": "int8"}))
    out = shadow.export()
    assert out["wire_codecs"] == {(2, 7): "int8", (3, 8): "int4"}
    assert out["node_codecs"] == {3: ["int4"]}  # node 2's caps revoked
    assert out["status"][2][7].codec == "int8"


# ------------------------------------------------- decode-during-staging


def test_stager_decodes_blob_under_its_own_codec():
    """A blob delivered under a NEGOTIATED wire codec decodes under ITS
    form (not the run codec) during staging — the decode-at-staging
    half of the quantized wire path."""
    import torch

    from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
        StreamingBootStager,
    )

    enc = _enc_blob(0)
    src = LayerSrc(inmem_data=bytearray(enc), data_size=len(enc),
                   meta=LayerMeta(location=LayerLocation.INMEM,
                                  codec="int8"))
    stager = StreamingBootStager(CFG, codec="raw", device="cpu")
    try:
        assert stager.submit(0, src)
        staged = stager.collect([0], timeout=60.0)
        assert 0 in staged
        expect = quant.decode_blob_host(CFG, 0, enc, "int8")
        for name, arr in staged[0].items():
            got = arr[0]
            assert got.shape == expect[name].shape
            assert torch.equal(got, expect[name]), name
    finally:
        stager.close()


def test_boot_bulk_path_normalizes_codec_holding():
    """The bulk/infill boot path normalizes a wire-codec holding to the
    canonical raw form (host decode) so a stager miss never misdecodes
    encoded bytes as raw."""
    import torch

    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        stage_blob_leaves,
    )
    from distributed_llm_dissemination_tpu_torch.models.quant import (
        decode_to_raw,
    )

    enc = _enc_blob(1)
    raw = decode_to_raw(CFG, 1, enc, "int8")
    # What boot_from_layers' normalization produces, staged raw:
    norm = LayerSrc(inmem_data=bytearray(raw), data_size=len(raw),
                    meta=LayerMeta(location=LayerLocation.INMEM))
    staged = stage_blob_leaves(CFG, 1, norm, codec="raw", device="cpu")
    expect = quant.decode_blob_host(CFG, 1, enc, "int8")
    for name, arr in staged.items():
        assert torch.equal(arr[0], expect[name]), name


# ------------------------------------------------ mixed JAX/port clusters


def _mixed(kinds):
    from test_torch_dissemination import _transports

    return _transports(kinds)


def _pkg(kind):
    """(runtime, types, codec plane class, model config) of one package."""
    if kind == "jax":
        from distributed_llm_dissemination_tpu import runtime as jrt
        from distributed_llm_dissemination_tpu.core import types as jtypes
        from distributed_llm_dissemination_tpu.runtime.codec import (
            WireCodecPlane as JPlane,
        )

        return jrt, jtypes, JPlane, JAX_CONFIGS["tiny"]
    from distributed_llm_dissemination_tpu_torch import runtime as trt
    from distributed_llm_dissemination_tpu_torch.core import types as ttypes

    return trt, ttypes, WireCodecPlane, CFG


def _held(t, data, rate=0):
    return t.LayerSrc(inmem_data=bytearray(data), data_size=len(data),
                      meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                                       limit_rate=rate,
                                       source_type=t.SourceType.MEM))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("leader_kind,dest_kind",
                         [("jax", "port"), ("port", "jax")])
def test_mixed_cluster_ships_quantized_forms_over_tcp(leader_kind, dest_kind,
                                                      codec, monkeypatch):
    """A leader of one package and receivers of the other over TCP: the
    slow dest gets the ``codec`` form of every layer, byte-exact with the
    other package's encode and verified against the codec-qualified
    digest; the fast dest gets raw bytes."""
    monkeypatch.setenv("DLD_CODEC_MIN_RATE", str(64 << 20))
    lrt, lt, lplane, lcfg = _pkg(leader_kind)
    drt, dt, dplane, dcfg = _pkg(dest_kind)
    ts = _mixed({0: leader_kind, 1: dest_kind, 2: dest_kind})
    lids = [0, 1]
    assignment = {1: {lid: lt.LayerMeta() for lid in lids},
                  2: {lid: lt.LayerMeta() for lid in lids}}
    leader = lrt.FlowRetransmitLeaderNode(
        lrt.Node(0, 0, ts[0]), {lid: _held(lt, _raw_blob(lid)) for lid in lids},
        assignment, {0: 1 << 30, 1: 4 << 20, 2: 1 << 30},
        codecs=lplane(lcfg, wire_codec=codec))
    receivers = [drt.FlowRetransmitReceiverNode(
        drt.Node(i, 0, ts[i]), {}, codecs=dplane(dcfg, wire_codec=codec))
        for i in (1, 2)]
    try:
        for r in receivers:
            r.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        slow, fast = receivers
        for lid in lids:
            enc = _enc_blob(lid, codec)
            src = slow.layers[lid]
            assert src.meta.codec == codec
            assert bytes(src.inmem_data) == enc
            assert lid in slow._digest_ok
            assert leader.status[1][lid].codec == codec
            assert fast.layers[lid].meta.codec == ""
            assert bytes(fast.layers[lid].inmem_data) == _raw_blob(lid)
            assert lid in fast._digest_ok
    finally:
        close_all(leader, receivers, ts)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("leader_kind,dest_kind",
                         [("jax", "port"), ("port", "jax")])
def test_mixed_cluster_ships_delta_forms_over_tcp(leader_kind, dest_kind):
    """A dest of one package that verified v1 gets a v2 sibling from a
    leader of the other as a ``delta:<v1-digest>`` stream over TCP,
    reconstructs it byte-exact and verifies the full-form digest."""
    lrt, lt, lplane, _ = _pkg(leader_kind)
    drt, dt, dplane, _ = _pkg(dest_kind)
    ts = _mixed({0: leader_kind, 1: dest_kind})
    v1, v2 = _delta_fixture(n=256 << 10, stride=64)
    leader = lrt.FlowRetransmitLeaderNode(
        lrt.Node(0, 0, ts[0]), {0: _held(lt, v1, rate=8 << 20)},
        {1: {0: lt.LayerMeta()}}, {0: 1 << 30, 1: 8 << 20},
        codecs=lplane(None))
    dest = drt.FlowRetransmitReceiverNode(drt.Node(1, 0, ts[1]), {},
                                          codecs=dplane(None))
    try:
        dest.announce()
        leader.ready().get(timeout=TIMEOUT)
        assert 0 in dest._digest_ok
        with leader._lock:
            leader.layers[100] = _held(lt, v2, rate=8 << 20)
        leader.submit_job(
            "v2-delta", {1: {100: lt.LayerMeta()}}, priority=1, kind="push",
            digests={100: integrity.layer_digest(v2)})
        leader.ready().get(timeout=TIMEOUT)
        choice = leader._codec_choice.get((1, 100), "")
        assert choice == "delta:" + integrity.layer_digest(v1), choice
        src = dest.layers[100]
        assert bytes(src.inmem_data) == v2
        assert src.meta.codec == ""
        assert 100 in dest._digest_ok
    finally:
        close_all(leader, [dest], ts)


# ------------------------------------------- the port's boot, codec paths


def _device_held(data, codec):
    """A holding staged on a CPU "device" (``device_array`` set), as the
    -hbm ingest leaves it."""
    import torch

    src = LayerSrc(inmem_data=bytearray(data), data_size=len(data),
                   meta=LayerMeta(location=LayerLocation.HBM, codec=codec))
    src.device_array = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return src


def _stage_entropy_device_blobs(codec, device):
    """Layer blob 0 and the head blob in the ``codec`` entropy form, held
    on ``device`` and staged by the boot's device paths.  Returns
    [(blob id, staged leaves)]."""
    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        decode_head,
        stage_blob_leaves,
    )

    head_id = serde.head_blob_id(CFG)
    out = []
    for lid in (0, head_id):
        src = _device_held(_enc_blob(lid, codec), codec)
        src.device_array = src.device_array.to(device)
        if lid == head_id:
            got = decode_head(CFG, src, codec, device=device)
        else:
            got = {name: a[0] for name, a in stage_blob_leaves(
                CFG, lid, src, codec=codec, device=device).items()}
        out.append((lid, got))
    return out


def _base_host_decode(lid, codec):
    """The host decode of blob ``lid`` in ``codec``'s base form."""
    base = quant.ENTROPY_CODECS[codec]
    return quant.decode_blob_host(CFG, lid, _enc_blob(lid, base), base)


@pytest.mark.parametrize("codec", ["int8e", "int4e"])
def test_entropy_device_blob_unwraps_on_the_host(codec, monkeypatch):
    """An entropy form has no device decode (``device_decode_jit``
    raises): a device-resident one comes back to the host for its DLE1
    pass only, and its base form decodes on the device through the base
    codec's device decode -- layer and head blobs alike."""
    import torch

    base = quant.ENTROPY_CODECS[codec]
    decoded = []
    real = quant.device_decode_jit

    def spy(c, donate=False):
        decoded.append(c)
        return real(c, donate)

    monkeypatch.setattr(quant, "device_decode_jit", spy)
    host_decodes = []
    monkeypatch.setattr(quant, "decode_blob_host",
                        lambda *a: host_decodes.append(a))
    staged = _stage_entropy_device_blobs(codec, "cpu")
    monkeypatch.undo()
    assert decoded == [base, base]
    assert host_decodes == []  # never the host path
    for lid, got in staged:
        for name, a in _base_host_decode(lid, codec).items():
            assert torch.equal(got[name], a), (lid, name)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8e", "int4e"])
def test_entropy_device_blob_decodes_through_its_kernel_on_the_card(codec):
    """On the card the unwrapped base form launches K2/K3, never the
    plain version, and equals the host decode bit for bit."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from distributed_llm_dissemination_tpu_torch.ops import dequant

    base = quant.ENTROPY_CODECS[codec]
    dequant.reset_counts()
    staged = _stage_entropy_device_blobs(codec, "cuda")
    assert dequant.launches_by_kernel[base] == 2
    assert not any(dequant.plain_calls.values())
    for lid, got in staged:
        for name, a in _base_host_decode(lid, codec).items():
            assert got[name].device.type == "cuda", (lid, name)
            assert torch.equal(got[name].cpu().view(torch.int16),
                               a.view(torch.int16)), (lid, name)


def test_boot_normalizes_only_what_the_stager_did_not_stage(monkeypatch):
    """A negotiated int8 holding the streaming stager decoded under its
    own codec is not decoded again on the host at boot; one it missed is
    normalized to raw.  Both boots give the same params."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        boot_from_layers,
    )
    from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
        StreamingBootStager,
    )

    ids = list(range(serde.head_blob_id(CFG) + 1))
    normalized = []
    real = quant.decode_to_raw

    def counting(cfg, lid, data, codec):
        normalized.append(lid)
        return real(cfg, lid, data, codec)

    monkeypatch.setattr(quant, "decode_to_raw", counting)
    layers = {lid: _device_held(_enc_blob(lid), "int8") for lid in ids}
    stager = StreamingBootStager(CFG, codec="raw", device="cpu")
    try:
        for lid in ids:
            assert stager.submit(lid, layers[lid])
        res = boot_from_layers(CFG, layers, device="cpu", stager=stager)
    finally:
        stager.close()
    assert normalized == []
    assert res.via == "streamed per-layer"
    bulk = boot_from_layers(CFG, {lid: _device_held(_enc_blob(lid), "int8")
                                  for lid in ids}, device="cpu")
    assert sorted(normalized) == ids
    for name, per_layer in res.params["layers"].items():
        other = bulk.params["layers"][name]
        assert len(per_layer) == len(other), name
        assert all(torch.equal(a, b) for a, b in zip(per_layer, other)), name
