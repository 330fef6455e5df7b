"""The port's zero-downtime weight swap on ``tests/test_swap.py``'s cases.

The JAX file's cases, run with the port's classes (``runtime/swap.py``
and the leader's swap driver are copies of the JAX modules; staged
leaves are torch tensors on the receiver's device, here the CPU).  The
v1/v2 models are ``tiny`` blobs made by the JAX package's
``serde.blobs_from_params``, handed to the port as bytes; the expected
ids come from the port's ``generate`` on the CPU and are held equal to
the JAX package's greedy ids.  ``test_swap_soak_under_straggler_link``
is ``slow``, as its JAX twin is.

Added: one swap job in a mixed cluster each way over TCP -- a JAX
leader with a port replica, and a port leader with a JAX replica --
where the flip commits, the version tags and digests agree between the
packages, and the post-flip ids equal v2's.

The JAX file's account of what the cases show:

- a mid-serve v1→v2 swap completes with ZERO failed requests: v1
  serves while v2 disseminates, the epoch-fenced commit flips the
  serving params atomically, and every post-swap answer decodes on v2
  (dual backend);
- rollback: an injected v2 digest mismatch (wrong stamped digest)
  exhausts its retry budget, the replica reports the failure, the
  leader ABORTS, and v1 keeps serving uninterrupted with the staged v2
  released;
- a dest crash mid-rollout aborts the swap the same way;
- a leader killed mid-swap: the promoted standby resumes the rollout
  from its shadow (swap record + job + versioned acks all replicated)
  and completes the flip at the bumped epoch (dual backend);
- the version vocabulary: versioned targets are only satisfied by
  same-version holdings, versioned acks only credit same-version
  pairs, and the mixed-version guard refuses to assemble a serving
  tree across rollouts;
- satellites: preemption revoke drops a demoted tier's queued sends
  (``jobs.revoked_pairs``), the seeded ``slow=RATE@P`` fault rate-
  limits one link deterministically, and a token-armed leader rejects
  unauthenticated submits (``jobs.unauthorized``).
"""

import functools
import queue
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import generate as jgen
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu_torch.models import generate as tgen
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde

from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation,
    LayerMeta,
    LayerSrc,
    SourceType,
    satisfies,
)
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    Node,
)
from distributed_llm_dissemination_tpu_torch.runtime.failover import (
    StandbyController,
)
from distributed_llm_dissemination_tpu_torch.sched import Job, JobManager
from distributed_llm_dissemination_tpu_torch.transport import reset_registry
from distributed_llm_dissemination_tpu_torch.transport.faults import (
    FaultRule,
    FaultyTransport,
    rules_from_spec,
)
from distributed_llm_dissemination_tpu_torch.transport.messages import (
    JobSubmitMsg,
    JobStatusMsg,
    MsgType,
)
from distributed_llm_dissemination_tpu_torch.utils import (
    integrity,
    telemetry,
    trace,
)

from test_torch_node import close_all, make_transports, mem_layer

TIMEOUT = 60.0
SWAP_BASE = 1000


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()  # the port's own run-scoped telemetry
    # One compute thread: tiny shapes gain nothing from more, and the
    # tier-1 run shares the host's cores with the JAX package's tests.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    reset_registry()


def _counters():
    return dict(trace.counter_totals())


def _delta(before, key):
    return trace.counter_totals().get(key, 0) - before.get(key, 0)


def _wait_for(cond, timeout=TIMEOUT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ------------------------------------------------- version vocabulary


def test_satisfies_requires_version_match():
    held = LayerMeta(location=LayerLocation.INMEM, version="")
    want_v2 = LayerMeta(version="v2")
    assert not satisfies(held, want_v2), (
        "an unversioned holding must never satisfy a versioned target")
    held_v2 = LayerMeta(location=LayerLocation.INMEM, version="v2")
    assert satisfies(held_v2, want_v2)
    assert not satisfies(
        held_v2, LayerMeta(version="v3")), "cross-version must not satisfy"
    # An UNVERSIONED target accepts any verified holding of the id
    # (mirrors shard coverage): a later push/repair job over swapped
    # layer ids must not wedge forever on the tag.
    assert satisfies(held_v2, LayerMeta())
    # The pre-swap vocabulary is untouched: "" == "".
    assert satisfies(held, LayerMeta())


def test_versioned_holding_satisfies_later_unversioned_job():
    """The post-swap wedge regression: a plain (unversioned) job whose
    pair the dest already holds verified-under-v2 must resolve at admit
    — and an unversioned pair must accept a version-tagged ack."""
    mgr = JobManager()
    status = {2: {7: LayerMeta(location=LayerLocation.INMEM,
                              version="v2")}}
    job = mgr.admit(Job("post-swap-push", {2: {7: LayerMeta()},
                                           3: {7: LayerMeta()}}), status)
    assert job.resolved_at_admit == 1, "held-under-v2 must satisfy"
    assert job.remaining == {(3, 7)}
    assert mgr.on_ack(3, 7, version="v2") == ["post-swap-push"]


def test_job_manager_versioned_ack_crediting():
    mgr = JobManager()
    mgr.admit(Job("swap", {2: {7: LayerMeta(version="v2")}},
                  kind="swap", version="v2", swap_base=SWAP_BASE),
              {})
    # An unversioned ack for the pair must NOT credit the swap job.
    assert mgr.on_ack(2, 7) == []
    assert mgr.get("swap").remaining == {(2, 7)}
    assert mgr.on_ack(2, 7, version="v2") == ["swap"]
    # Round-trip: version/swap_base survive replication records.
    restored = JobManager()
    restored.load(mgr.to_json())
    job = restored.get("swap")
    assert job.version == "v2" and job.swap_base == SWAP_BASE


def test_job_manager_cancel_is_visibly_degraded():
    mgr = JobManager()
    mgr.admit(Job("j", {2: {7: LayerMeta()}, 3: {8: LayerMeta()}}), {})
    assert mgr.cancel("j")
    job = mgr.get("j")
    assert job.state == "done" and job.cancelled
    assert job.dropped_pairs == 2 and not job.remaining
    assert "Cancelled" in job.summary()
    assert not mgr.cancel("j")  # idempotent


def test_mixed_version_guard():
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        MixedVersionError,
        ensure_uniform_version,
    )

    assert ensure_uniform_version({0: "v2", 1: "v2"}, "v2") == "v2"
    with pytest.raises(MixedVersionError, match="mixed"):
        ensure_uniform_version({0: "v2", 1: ""})
    with pytest.raises(MixedVersionError, match="committed version"):
        ensure_uniform_version({0: "v1", 1: "v1"}, "v2")


def test_swap_gate_refuses_encoded_or_sharded_holdings():
    """Swap completeness gates on FULL canonical bytes: a shard slice
    or a still-ENCODED v2 holding (a negotiated codec form, or a delta
    stream awaiting reconstruction) must never count toward the flip —
    staging it would decode garbage into the serving tree
    (docs/swap.md, docs/codec.md)."""
    from types import SimpleNamespace

    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.runtime.swap import (
        SwapController,
    )

    cfg = CONFIGS["tiny"]
    base = 1000

    def holding(codec="", shard=""):
        return LayerSrc(
            inmem_data=bytearray(b"x"), data_size=1,
            meta=LayerMeta(location=LayerLocation.INMEM, codec=codec,
                           shard=shard))

    layers = {base + b: holding()
              for b in range(serde.head_blob_id(cfg) + 1)}
    r = SimpleNamespace(node=SimpleNamespace(my_id=1),
                        _lock=threading.Lock(), layers=layers,
                        _digest_ok=set(),
                        _expected_digest=lambda lid: None, boot_cfg=cfg)
    ctl = SwapController(r)
    assert ctl._set_complete(base)
    for bad in (holding(codec="int8"), holding(codec="int8e"),
                holding(codec="delta:" + "ab" * 16),
                holding(shard="1/4@0")):
        good = layers[base]
        layers[base] = bad
        assert not ctl._set_complete(base), bad.meta
        layers[base] = good
    assert ctl._set_complete(base)
    # A missing blob, and a stamped-but-unverified digest, still gate.
    r._expected_digest = lambda lid: "xxh3:ab"
    assert not ctl._set_complete(base)
    del layers[base]
    assert not ctl._set_complete(base)


# ------------------------------------------------- serving rig helpers


def _tiny():
    return tllama.CONFIGS["tiny"]


@functools.lru_cache(maxsize=None)
def _model_blobs(seed: int):
    """The JAX package's ``tiny`` blobs of ``init_params(key(seed))``,
    handed to the port as bytes."""
    jcfg = jllama.CONFIGS["tiny"]
    return jserde.blobs_from_params(
        jcfg, jllama.init_params(jcfg, jax.random.key(seed)))


def _port_params(seed: int):
    return tserde.params_from_blobs(_tiny(), _model_blobs(seed))


def _generate(params, prompt, max_new: int):
    """The port's greedy ids on the CPU."""
    return tgen.generate(params, torch.tensor([list(prompt)]), _tiny(),
                         max_new)[0].tolist()


@functools.lru_cache(maxsize=None)
def _expected(seed: int, prompt: tuple, max_new: int):
    got = _generate(_port_params(seed), prompt, max_new)
    jcfg = jllama.CONFIGS["tiny"]
    want = np.asarray(jgen.generate(
        jllama.init_params(jcfg, jax.random.key(seed)),
        jnp.asarray([list(prompt)], jnp.int32), jcfg, max_new))[0].tolist()
    assert got == want, f"port greedy ids {got} != JAX's {want}"
    return tuple(got)


def _expected_tokens(seed: int, prompt, max_new: int):
    """The port's greedy ids for ``seed``'s model, held equal to the JAX
    package's."""
    return list(_expected(seed, tuple(prompt), max_new))


def _blob_layer(data: bytes) -> LayerSrc:
    return LayerSrc(
        inmem_data=bytearray(data), data_size=len(data),
        meta=LayerMeta(location=LayerLocation.INMEM,
                       source_type=SourceType.MEM))


def _swap_assignment(dests):
    cfg = _tiny()
    from distributed_llm_dissemination_tpu_torch.models import serde

    ids = [SWAP_BASE + b for b in range(serde.head_blob_id(cfg) + 1)]
    return {d: {lid: LayerMeta() for lid in ids} for d in dests}


# ------------------------------------- mid-serve swap, zero drops (e2e)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_mid_serve_swap_zero_dropped_requests(kind):
    """The acceptance scenario: v1 serves generation requests the whole
    time; a kind="swap" job disseminates v2 under version-tagged ids;
    the commit fence flips the replica atomically; every request
    answers (zero failures) and post-flip answers decode on v2."""
    before = _counters()
    cfg = _tiny()
    v1, v2 = _model_blobs(0), _model_blobs(1)
    ids = [0, 1, 9]
    ts, _ = make_transports(kind, ids)
    seed = {b: _blob_layer(v1[b]) for b in v1}
    seed.update({SWAP_BASE + b: _blob_layer(v2[b]) for b in v2})
    base = {1: {b: LayerMeta() for b in v1}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed, base, {i: 10 ** 9 for i in ids},
        expected_nodes={1})
    dest = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {}, boot_cfg=cfg,
                                      device="cpu")
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester,
    )

    requester = GenRequester(ts[9], my_id=9)
    prompt, max_new = [3, 5, 7], 4
    v1_tokens = _expected_tokens(0, prompt, max_new)
    v2_tokens = _expected_tokens(1, prompt, max_new)
    assert v1_tokens != v2_tokens, "seeds must produce distinct models"
    failures: list = []
    answers: list = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                answers.append(requester.request(1, prompt, max_new,
                                                 timeout=TIMEOUT))
            except Exception as e:  # noqa: BLE001 — any failure counts
                failures.append(repr(e))
            time.sleep(0.02)

    try:
        dest.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        # v1 serves before the swap.
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        summary = leader.submit_job(
            "swap-v2", _swap_assignment([1]), priority=2, kind="swap",
            version="v2", swap_base=SWAP_BASE)
        assert summary.get("Version") == "v2"
        _wait_for(lambda: leader.swap_table().get("v2", {}).get(
            "State") == "committed", what="swap commit")
        _wait_for(lambda: dest.serving_version == "v2",
                  what="replica flip")
        _wait_for(lambda: 1 in leader.swap_table()["v2"]["Confirmed"],
                  what="flip confirmation")
        # Serve on v2 for a few more requests, then stop the hammer.
        time.sleep(0.5)
        stop.set()
        t.join(timeout=TIMEOUT)
        assert failures == [], f"requests failed during the swap: " \
                               f"{failures[:3]}"
        assert answers, "the hammer never got an answer"
        # Every answer is a COHERENT model's decode — v1 before the
        # flip, v2 after; never anything else (no mixed forward).
        for a in answers:
            assert a in (v1_tokens, v2_tokens), a
        # Post-flip answers are v2's.
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v2_tokens
        if integrity.digests_enabled():
            # Every v2 layer byte-exact against its stamped digest.
            for b in v2:
                assert SWAP_BASE + b in dest._digest_ok, b
        # v1 blobs were never clobbered: the store still holds them.
        assert bytes(dest.layers[0].inmem_data) == v1[0]
        assert _delta(before, "swap.flips") == 1
        assert _delta(before, "swap.committed") == 1
        assert leader.jobs.table()["swap-v2"]["State"] == "done"
        assert leader.jobs.table()["swap-v2"]["DroppedPairs"] == 0
    finally:
        stop.set()
        requester.close()
        close_all(leader, [dest], ts)


# ------------------------------------------- rollback: digest mismatch


@pytest.mark.timeout(240)
def test_digest_mismatch_mid_rollout_aborts_and_v1_keeps_serving():
    """A v2 layer whose stamped digest can never match (the job stamps
    a WRONG digest) exhausts the dest's retry budget; the replica
    reports the failure, the leader aborts the swap, the staged v2 set
    is released, and v1 serves on — uninterrupted."""
    if not integrity.digests_enabled():
        pytest.skip("the rollback trigger is the digest plane")
    before = _counters()
    cfg = _tiny()
    v1, v2 = _model_blobs(0), _model_blobs(1)
    ids = [0, 1, 9]
    ts, _ = make_transports("inmem", ids)
    seed = {b: _blob_layer(v1[b]) for b in v1}
    base = {1: {b: LayerMeta() for b in v1}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed, base, {i: 10 ** 9 for i in ids},
        expected_nodes={1})
    dest = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {}, boot_cfg=cfg,
                                      device="cpu")
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester,
    )

    requester = GenRequester(ts[9], my_id=9)
    prompt, max_new = [2, 4], 3
    v1_tokens = _expected_tokens(0, prompt, max_new)
    try:
        dest.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        # v2 loads AFTER construction (so the leader's own digest pass
        # never hashed it) and the job stamps a WRONG digest for blob 0.
        with leader._lock:
            for b in v2:
                leader.layers[SWAP_BASE + b] = _blob_layer(v2[b])
        digests = {SWAP_BASE + b: integrity.layer_digest(v2[b])
                   for b in v2}
        digests[SWAP_BASE + 0] = "xxh3:00000000deadbeef"
        leader.submit_job("swap-bad", _swap_assignment([1]), priority=2,
                          kind="swap", version="v2", swap_base=SWAP_BASE,
                          digests=digests)
        _wait_for(lambda: leader.swap_table().get("v2", {}).get(
            "State") == "aborted", timeout=120.0, what="swap abort")
        # Rollback semantics: never flipped, staged v2 released, job
        # visibly cancelled.
        assert dest.serving_version == ""
        _wait_for(lambda: SWAP_BASE + 0 not in dest.layers,
                  what="staged v2 release")
        table = leader.jobs.table()["swap-bad"]
        assert table["State"] == "done" and table.get("Cancelled")
        assert _delta(before, "swap.aborts") == 1
        assert _delta(before, "swap.flips") == 0
        assert _delta(before, "integrity.digest_given_up") >= 1
        # v1 serves on, byte-identical answers.
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        # RETRY under the SAME version name with the digest fixed: the
        # mainline operator path after a failed rollout.  The aborted
        # record must be replaced (leader + replica), the released v2
        # set redelivered, and the flip must land this time.
        digests[SWAP_BASE + 0] = integrity.layer_digest(v2[0])
        leader.submit_job("swap-retry", _swap_assignment([1]),
                          priority=2, kind="swap", version="v2",
                          swap_base=SWAP_BASE, digests=digests)
        _wait_for(lambda: dest.serving_version == "v2", timeout=120.0,
                  what="retry rollout flipping after the abort")
        assert leader.swap_table()["v2"]["State"] == "committed"
        assert leader.swap_table()["v2"]["JobID"] == "swap-retry"
        v2_tokens = _expected_tokens(1, prompt, max_new)
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v2_tokens
    finally:
        requester.close()
        close_all(leader, [dest], ts)


# --------------------------------------------- rollback: dest crash


@pytest.mark.timeout(240)
def test_dest_crash_mid_rollout_aborts_swap_v1_serves_on():
    """Two replicas; the rollout to one is wedged (its v2 frames drop
    on the floor) and the leader declares it crashed mid-swap.  The
    swap must abort everywhere — the healthy replica releases its
    staged v2 and keeps serving v1."""
    before = _counters()
    cfg = _tiny()
    v1, v2 = _model_blobs(0), _model_blobs(1)
    ids = [0, 1, 2, 9]
    ts, _ = make_transports("inmem", ids)
    # Dest 2's LAYER frames vanish at the leader's NIC: the rollout to
    # it stalls deterministically mid-swap.
    ts[0] = FaultyTransport(
        ts[0], [FaultRule("drop", "out", msg_type=MsgType.LAYER, dest=2)],
        seed=1)
    seed = {b: _blob_layer(v1[b]) for b in v1}
    seed.update({SWAP_BASE + b: _blob_layer(v2[b]) for b in v2})
    base = {1: {b: LayerMeta() for b in v1}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed, base, {i: 10 ** 9 for i in ids},
        expected_nodes={1, 2})
    dest = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {}, boot_cfg=cfg,
                                      device="cpu")
    lame = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {}, boot_cfg=cfg,
                                      device="cpu")
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester,
    )

    requester = GenRequester(ts[9], my_id=9)
    prompt, max_new = [6, 1], 3
    v1_tokens = _expected_tokens(0, prompt, max_new)
    try:
        dest.announce()
        lame.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        boots = leader.boot_ready().get(timeout=TIMEOUT)
        assert 1 in boots
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        leader.submit_job("swap-v2", _swap_assignment([1, 2]),
                          priority=2, kind="swap", version="v2",
                          swap_base=SWAP_BASE)
        # Replica 1 stages its full v2 set; replica 2 never can.
        _wait_for(lambda: all(SWAP_BASE + b in dest.layers for b in v2),
                  what="healthy replica staging v2")
        assert leader.swap_table()["v2"]["State"] == "rolling"
        leader.crash(2)
        _wait_for(lambda: leader.swap_table()["v2"]["State"] == "aborted",
                  what="swap abort after dest crash")
        _wait_for(lambda: SWAP_BASE + 0 not in dest.layers,
                  what="staged v2 release on the survivor")
        assert dest.serving_version == ""
        assert _delta(before, "swap.aborts") == 1
        assert _delta(before, "swap.flips") == 0
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
    finally:
        requester.close()
        close_all(leader, [dest, lame], ts)


# ------------------------------------ leader killed mid-swap (failover)


HB = 0.15
LEASE = 0.2
STANDBY_EXPIRY = 0.8


@pytest.mark.timeout(240)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_leader_killed_mid_swap_promoted_standby_completes_flip(kind):
    """The HA acceptance scenario (docs/swap.md): the leader admits a
    swap whose v2 bytes it can never deliver (its data plane is
    fault-wedged), replicates the swap record + job + versioned acks,
    and dies.  The promoted standby — which holds replica copies of the
    v2 set — must resume the rollout, complete it, and drive the commit
    fence at the bumped epoch until the replica confirms the flip."""
    before = _counters()
    cfg = _tiny()
    v2 = _model_blobs(1)
    ids = [0, 1, 2]
    raw, _ = make_transports(kind, ids)
    ts = dict(raw)
    ts[0] = FaultyTransport(
        raw[0], [FaultRule("drop", "out", msg_type=MsgType.LAYER)],
        seed=1)
    v2_layers = lambda: {SWAP_BASE + b: _blob_layer(v2[b])  # noqa: E731
                         for b in v2}
    ha = dict(expected_nodes={1, 2}, standbys=[1], lease_interval=LEASE,
              epoch=0)
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), v2_layers(), {},
        {i: 10 ** 9 for i in ids}, **ha)
    leader.boot_enabled = False  # the flip IS the serving transition
    standby = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), v2_layers(),
                                         heartbeat_interval=HB)
    ctl = StandbyController(
        standby, rank=0, lease_timeout=STANDBY_EXPIRY, standbys=[1],
        mode=3, node_network_bw={i: 10 ** 9 for i in ids},
        failure_timeout=0.0, lease_interval=LEASE)
    worker = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {},
                                        boot_cfg=cfg, device="cpu",
                                        heartbeat_interval=HB)
    try:
        standby.announce()
        worker.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.submit_job("swap-v2", _swap_assignment([2]), priority=2,
                          kind="swap", version="v2", swap_base=SWAP_BASE)
        # The swap record replicated; the rollout is wedged (the
        # leader's layer frames drop; the standby holds the only other
        # copies but the OLD leader planned itself as the source).
        time.sleep(0.6)
        assert ts[0].stats["drop"] > 0, "kill would not be mid-rollout"
        assert leader.swap_table()["v2"]["State"] == "rolling"
        leader.close()
        _wait_for(ctl.promoted.is_set, what="standby promotion")
        new_leader = ctl.leader
        assert new_leader is not None and new_leader.epoch == 1
        _wait_for(lambda: new_leader.swap_table().get("v2", {}).get(
            "State") == "committed", timeout=120.0,
            what="promoted leader committing the resumed swap")
        _wait_for(lambda: worker.serving_version == "v2",
                  timeout=120.0, what="replica flip after takeover")
        _wait_for(lambda: 2 in new_leader.swap_table()["v2"]["Confirmed"],
                  what="flip confirmation at the promoted leader")
        # The flipped replica's params decode v2's tokens.
        prompt, max_new = [1, 2, 3], 3
        assert worker.boot_result is not None
        got = _generate(worker.boot_result.params, prompt, max_new)
        assert got == _expected_tokens(1, prompt, max_new)
        assert _delta(before, "failover.takeover") >= 1
        assert _delta(before, "swap.flips") == 1
    finally:
        ctl.close()
        close_all(leader, [standby, worker], ts)


# --------------------------------------- swap soak: straggler link


@pytest.mark.slow
@pytest.mark.timeout(300)
def test_swap_soak_under_straggler_link():
    """The chaos case the ``slow=RATE@P`` injection exists for: the
    replica's v2 rollout crawls behind a seeded rate-limited link while
    v1 serves a continuous request stream.  The swap must still flip
    atomically with ZERO failed requests — the straggler stretches the
    rollout, never the serving plane."""
    before = _counters()
    cfg = _tiny()
    v1, v2 = _model_blobs(0), _model_blobs(1)
    ids = [0, 1, 9]
    ts, _ = make_transports("inmem", ids)
    # v2's ~1.3 MiB crawls at 256 KB/s past the burst: a multi-second
    # rollout window under live traffic, deterministically.
    ts[0] = FaultyTransport(
        ts[0], [FaultRule("slow", "out", msg_type=MsgType.LAYER,
                          dest=1, rate=256 * 1024)], seed=0)
    seed = {b: _blob_layer(v1[b]) for b in v1}
    seed.update({SWAP_BASE + b: _blob_layer(v2[b]) for b in v2})
    base = {1: {b: LayerMeta() for b in v1}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed, base, {i: 10 ** 9 for i in ids},
        expected_nodes={1})
    dest = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {}, boot_cfg=cfg,
                                      device="cpu")
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester,
    )

    requester = GenRequester(ts[9], my_id=9)
    prompt, max_new = [3, 5, 7], 4
    v1_tokens = _expected_tokens(0, prompt, max_new)
    v2_tokens = _expected_tokens(1, prompt, max_new)
    failures: list = []
    served = [0]
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                got = requester.request(1, prompt, max_new,
                                        timeout=TIMEOUT)
                assert got in (v1_tokens, v2_tokens), got
                served[0] += 1
            except Exception as e:  # noqa: BLE001
                failures.append(repr(e))
            time.sleep(0.05)

    try:
        dest.announce()
        assert leader.ready().get(timeout=120.0) == base
        assert set(leader.boot_ready().get(timeout=120.0)) == {1}
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        t_roll = time.monotonic()
        leader.submit_job("swap-v2", _swap_assignment([1]), priority=2,
                          kind="swap", version="v2",
                          swap_base=SWAP_BASE)
        _wait_for(lambda: dest.serving_version == "v2", timeout=180.0,
                  what="flip behind the straggler link")
        rollout_s = time.monotonic() - t_roll
        stop.set()
        t.join(timeout=TIMEOUT)
        assert failures == [], failures[:3]
        # The straggler really stretched the rollout (the injected
        # limit bit), and v1 served right through it.
        assert rollout_s > 1.5, rollout_s
        assert ts[0].stats["slow"] > 0
        assert served[0] >= 5, served[0]
        assert _delta(before, "swap.flips") == 1
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v2_tokens
    finally:
        stop.set()
        requester.close()
        close_all(leader, [dest], ts)


# ----------------------------------------------- preemption revoke


@pytest.mark.timeout(120)
def test_preemption_revoke_drops_demoted_queued_sends(monkeypatch):
    """A higher-priority admission revokes a lower tier's dispatched-
    but-undelivered sends: the revoke is keyed to the PRE-re-plan
    generation, so the ORIGINAL in-flight send eats it at a fragment
    boundary (counted on jobs.revoked_pairs) while the re-plan's
    re-dispatch — stamped with the bumped generation — sails through
    and completes delivery at the demoted budget."""
    from distributed_llm_dissemination_tpu_torch.runtime import send as send_mod

    # Small fragments so the 1 MiB crawl spans several fragment
    # boundaries: the mid-job revoke check only runs BETWEEN fragments,
    # and at the default 16 MiB (x stripes) the layer is one fragment
    # and the original send would never look.
    monkeypatch.setattr(send_mod, "FLOW_FRAGMENT_BYTES", 64 * 1024)
    before = _counters()
    ids = [0, 1, 2]
    ts, _ = make_transports("inmem", ids)
    size = 1024 * 1024
    # The lo tier's send to dest 1 crawls under the seeded slow-link
    # fault (1 MiB at 256 KB/s past the 256 KiB burst ≈ 3 s in
    # flight) so its pair is still undelivered when the high tier
    # preempts — the deterministic straggler-mid-rollout case the
    # ``slow=`` injection exists for.
    ts[0] = FaultyTransport(
        ts[0], [FaultRule("slow", "out", msg_type=MsgType.LAYER,
                          dest=1, rate=256 * 1024)], seed=0)
    seed = {0: mem_layer(0, size), 1: mem_layer(1, 64 * 1024)}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed, {}, {i: 10 ** 9 for i in ids},
        expected_nodes={1, 2})
    r1 = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    r2 = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {})
    try:
        r1.announce()
        r2.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.ready().get(timeout=TIMEOUT)
        leader.submit_job("lo", {1: {0: LayerMeta()}}, priority=1)
        time.sleep(0.3)  # the lo send is mid-crawl on the slow link
        leader.submit_job("hi", {2: {1: LayerMeta()}}, priority=5)
        _wait_for(lambda: leader.jobs.table()["hi"]["State"] == "done",
                  what="preempting job completion")
        _wait_for(lambda: leader.jobs.table()["lo"]["State"] == "done",
                  timeout=120.0, what="demoted job completion")
        assert _delta(before, "jobs.revokes_sent") >= 1
        assert _delta(before, "jobs.revoked_pairs") >= 1
        # The demoted pair still landed, byte-exact.
        from test_torch_node import layer_bytes

        assert bytes(r1.layers[0].inmem_data) == layer_bytes(0, size)
    finally:
        close_all(leader, [r1, r2], ts)


# ----------------------------------------------- slow=RATE@P fault


def test_slow_fault_rate_limits_one_link_deterministically():
    seed, rules = rules_from_spec("slow=1000000@2")
    assert seed == 0 and len(rules) == 1
    assert rules[0].kind == "slow" and rules[0].rate == 1_000_000
    assert rules[0].dest == 2
    ids = [0, 1, 2]
    ts, _ = make_transports("inmem", ids)
    faulty = FaultyTransport(ts[0], rules, seed=seed)
    try:
        from distributed_llm_dissemination_tpu_torch.transport.messages import (
            LayerMsg,
        )

        # 1 MiB at 1 MB/s to peer 2: past the 256 KiB bucket burst the
        # remaining ~768 KiB must wait ≈ 0.8 s; the same bytes to the
        # unmatched peer 1 fly.
        src = mem_layer(3, 512 * 1024)
        t0 = time.monotonic()
        for _ in range(2):
            faulty.send(1, LayerMsg(0, 3, src, src.data_size))
        fast = time.monotonic() - t0
        t0 = time.monotonic()
        for _ in range(2):
            faulty.send(2, LayerMsg(0, 3, src, src.data_size))
        slow = time.monotonic() - t0
        assert fast < 0.4, fast
        assert slow >= 0.5, (
            f"slow link finished in {slow:.2f}s; the injected rate "
            "limit did not bite")
        assert faulty.stats["slow"] >= 2
    finally:
        faulty.close()
        for t in ts.values():
            if t is not faulty.inner:
                t.close()


def test_slow_fault_spec_without_peer_matches_all():
    _, rules = rules_from_spec("slow=1000000")
    assert rules[0].dest is None and rules[0].rate == 1_000_000


# ------------------------------------------------- admission control


@pytest.mark.timeout(60)
def test_job_token_rejects_unauthenticated_submits(monkeypatch):
    monkeypatch.setenv("DLD_JOB_TOKEN", "sesame")
    before = _counters()
    ids = [0, 1, 9]
    ts, _ = make_transports("inmem", ids)
    base = {1: {0: LayerMeta()}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {0: mem_layer(0), 1: mem_layer(1)}, base,
        {i: 10 ** 9 for i in ids}, expected_nodes={1})
    r1 = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    from distributed_llm_dissemination_tpu_torch.runtime.node import MessageLoop

    loop = MessageLoop(ts[9])
    replies: "queue.Queue" = queue.Queue()
    loop.register(JobStatusMsg, replies.put)
    loop.start()
    try:
        r1.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        # No token: rejected, counted, ANSWERED.
        ts[9].send(0, JobSubmitMsg(9, "nope", {1: {1: LayerMeta()}}))
        resp = replies.get(timeout=TIMEOUT)
        assert "unauthorized" in resp.error
        assert leader.jobs.get("nope") is None
        # Wrong token: same refusal.
        ts[9].send(0, JobSubmitMsg(9, "still-no", {1: {1: LayerMeta()}},
                                   auth="guess"))
        assert "unauthorized" in replies.get(timeout=TIMEOUT).error
        # The right token admits.
        ts[9].send(0, JobSubmitMsg(9, "yes", {1: {1: LayerMeta()}},
                                   auth="sesame"))
        ok = replies.get(timeout=TIMEOUT)
        assert not ok.error and "yes" in ok.jobs
        assert _delta(before, "jobs.unauthorized") == 2
    finally:
        loop.stop()
        close_all(leader, [r1], ts)


# ------------------------------------- swap fence hardening (review)


@pytest.mark.timeout(60)
def test_announce_reconciles_job_pair_lost_ack():
    """The failover-window lost-ack wedge: a pair DELIVERED at the dest
    whose ack went to a dead leader must credit the job when the dest's
    (re)announce reaches the live leader — a swap fence waiting on the
    job must fire, not hang forever."""
    from distributed_llm_dissemination_tpu_torch.runtime import (
        LeaderNode,
        ReceiverNode,
    )

    ids = [0, 1]
    ts, _ = make_transports("inmem", ids)
    leader = LeaderNode(Node(0, 0, ts[0]),
                        {0: mem_layer(0), 1: mem_layer(1)},
                        {1: {0: LayerMeta()}})
    r1 = ReceiverNode(Node(1, 0, ts[1]), {})
    try:
        r1.announce()
        assert leader.ready().get(timeout=TIMEOUT)
        # Admit a job, then simulate the lost-ack state: the dest holds
        # the delivered bytes (it will announce them) but the leader's
        # job table still shows the pair outstanding (as if the ack
        # died with an old leader during a failover window).
        leader.submit_job("j-lost", {1: {1: LayerMeta()}})
        _wait_for(lambda: leader.jobs.table()["j-lost"]["State"]
                  == "done", what="job completion")
        job = leader.jobs.get("j-lost")
        with leader.jobs._lock:
            job.state = "active"
            job.remaining = {(1, 1)}
        assert leader.jobs.has_active()
        r1.announce()
        _wait_for(lambda: leader.jobs.table()["j-lost"]["State"]
                  == "done", what="announce-driven job reconcile")
    finally:
        close_all(leader, [r1], ts)


@pytest.mark.timeout(60)
def test_foreign_swap_control_is_dropped():
    """Leader-bound fence roles (confirm/query/error) from a node
    OUTSIDE the rollout's replica set must be refused: a forged error
    is a one-message rollout DoS, a forged confirm fakes a flip."""
    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode
    from distributed_llm_dissemination_tpu_torch.transport.messages import (
        SwapCommitMsg,
    )

    before = _counters()
    ids = [0, 1]
    ts, _ = make_transports("inmem", ids)
    leader = LeaderNode(Node(0, 0, ts[0]), {}, {1: {0: LayerMeta()}})
    try:
        with leader._lock:
            leader._swaps["v2"] = {
                "version": "v2", "job_id": "j", "swap_base": SWAP_BASE,
                "dests": [1], "state": "rolling", "confirmed": set()}
            leader._swaps_by_job["j"] = "v2"
        # Node 7 is not a replica: its forged abort-trigger and its
        # forged confirmation must both bounce.
        leader.handle_swap_commit(SwapCommitMsg(7, "v2", error="boom"))
        assert leader.swap_table()["v2"]["State"] == "rolling"
        leader.handle_swap_commit(SwapCommitMsg(7, "v2", applied=True))
        assert leader.swap_table()["v2"]["Confirmed"] == []
        assert _delta(before, "swap.foreign_ctrl_dropped") == 2
        # The registered replica's report still lands.
        leader.handle_swap_commit(SwapCommitMsg(1, "v2", applied=True))
        assert leader.swap_table()["v2"]["Confirmed"] == [1]
    finally:
        close_all(leader, [], ts)


@pytest.mark.timeout(60)
def test_committed_swap_prunes_and_replicates_dead_dest():
    """A committed swap's dead dest leaves the fence set AND the change
    replicates — a promoted standby must not chase the dead node's
    confirmation through the whole re-send budget."""
    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode

    ids = [0, 1, 2, 3]
    ts, _ = make_transports("inmem", ids)
    leader = LeaderNode(Node(0, 0, ts[0]), {}, {1: {0: LayerMeta()}},
                        standbys=[3], lease_interval=0.2, epoch=0)
    try:
        with leader._lock:
            leader._swaps["v2"] = {
                "version": "v2", "job_id": "j", "swap_base": SWAP_BASE,
                "dests": [1, 2], "state": "committed",
                "confirmed": {1}}
            leader._swaps_by_job["j"] = "v2"
        replicated = []
        orig = leader._replicate

        def spy(kind, **data):
            replicated.append((kind, data))
            orig(kind, **data)

        leader._replicate = spy
        leader.crash(2)
        row = leader.swap_table()["v2"]
        assert row["Dests"] == [1]
        assert any(k == "swap" and d.get("Dests") == [1]
                   for k, d in replicated), replicated
    finally:
        close_all(leader, [], ts)


def test_crash_prune_completing_fence_fires_finalize():
    """The dead dest was the LAST unconfirmed one: the prune itself
    completes the fence set, so the completion edge (the finalize
    round releasing the survivors' retained pre-flip trees) must fire
    from ``crash()`` — no further confirm will ever arrive to fire
    it."""
    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode

    ids = [0, 1, 2, 3]
    ts, _ = make_transports("inmem", ids)
    leader = LeaderNode(Node(0, 0, ts[0]), {}, {1: {0: LayerMeta()}},
                        standbys=[3], lease_interval=0.2, epoch=0)
    try:
        with leader._lock:
            leader._swaps["v2"] = {
                "version": "v2", "job_id": "j", "swap_base": SWAP_BASE,
                "dests": [1, 2], "state": "committed",
                "confirmed": {1}}
            leader._swaps_by_job["j"] = "v2"
        finalized = []
        orig = leader._swap_send_round

        def spy(version, **kw):
            if kw.get("finalize"):
                finalized.append(version)
            orig(version, **kw)

        leader._swap_send_round = spy
        before = dict(trace.counter_totals())
        leader.crash(2)
        assert finalized == ["v2"]
        assert (trace.counter_totals().get("swap.fleet_flipped", 0)
                - before.get("swap.fleet_flipped", 0)) == 1
        # The edge fires ONCE: a later duplicate confirm from the
        # survivor must not re-run it.
        from distributed_llm_dissemination_tpu_torch.transport.messages import (
            SwapCommitMsg,
        )
        leader.handle_swap_commit(
            SwapCommitMsg(1, "v2", applied=True))
        assert finalized == ["v2"]
    finally:
        close_all(leader, [], ts)


# --------------------------------------------- headroom staging policy


def test_headroom_probe_host_fallback(monkeypatch):
    """With the probe reporting tight headroom, every blob stages
    host-side (CPU tensors) and the flip still produces a servable
    tree — the bounded-dip fallback of docs/swap.md."""
    from distributed_llm_dissemination_tpu_torch.parallel import ingest
    from distributed_llm_dissemination_tpu_torch.runtime.swap import (
        SwapController,
    )

    monkeypatch.setattr(ingest, "hbm_headroom_bytes", lambda device=None: 0)

    class _R:  # the minimal receiver surface the controller touches
        def __init__(self):
            from distributed_llm_dissemination_tpu_torch.models import serde

            cfg = _tiny()
            self.boot_cfg = cfg
            self.boot_codec = "raw"
            self.device = torch.device("cpu")
            self._lock = threading.Lock()
            self._digest_ok = set()
            self._layer_versions = {}
            self.layers = {}
            self.node = type("N", (), {"my_id": 1})()
            self.sent = []
            v2 = _model_blobs(1)
            for b in v2:
                self.layers[SWAP_BASE + b] = _blob_layer(v2[b])
                self._layer_versions[SWAP_BASE + b] = "v2"
            self.head_id = serde.head_blob_id(cfg)
            self.applied = []

        def _expected_digest(self, lid):
            return None  # unstamped: CRC-only trust

        def _send_to_leader(self, msg):
            self.sent.append(msg)

        def _apply_swap_result(self, version, params):
            self.applied.append((version, params))

    r = _R()
    ctl = SwapController(r)
    ctl.query_interval = 0  # no re-request timers in a unit test
    from distributed_llm_dissemination_tpu_torch.transport.messages import (
        SwapCommitMsg,
    )

    ctl.on_commit(SwapCommitMsg(0, "v2", swap_base=SWAP_BASE))
    _wait_for(lambda: r.applied, what="host-staged flip")
    version, params = r.applied[0]
    assert version == "v2"
    # Host staging really happened: every blob took the tight path.
    rec = ctl._versions["v2"]
    assert len(rec["host_slots"]) == r.head_id + 1
    assert rec["state"] == "committed"
    # The flipped tree decodes v2's tokens (it is a real servable
    # params tree, not a stub).
    assert all(p.device.type == "cpu" for p in [
        params["embed"], params["lm_head"], *params["layers"].values()])
    got = _generate(params, [5, 5], 2)
    assert got == _expected_tokens(1, [5, 5], 2)
    # The confirm went leader-ward.
    assert any(getattr(m, "applied", False) for m in r.sent)


def test_revert_with_no_preflip_tree_keeps_flipped_tree(monkeypatch):
    """A replica whose flip WAS its boot (it joined mid-rollout and
    never served the pre-flip version) refuses a revert instead of
    restoring a None tree: degraded-but-serving beats a seat that
    answers nothing (``swap.revert_no_prev``)."""
    from distributed_llm_dissemination_tpu_torch.parallel import ingest
    from distributed_llm_dissemination_tpu_torch.runtime.swap import (
        SwapController,
    )
    from distributed_llm_dissemination_tpu_torch.transport.messages import (
        SwapCommitMsg,
    )

    monkeypatch.setattr(ingest, "hbm_headroom_bytes", lambda device=None: 0)

    class _R:
        def __init__(self):
            from distributed_llm_dissemination_tpu_torch.models import serde

            cfg = _tiny()
            self.boot_cfg = cfg
            self.boot_codec = "raw"
            self.device = torch.device("cpu")
            self._lock = threading.Lock()
            self._digest_ok = set()
            self._layer_versions = {}
            self.layers = {}
            self.node = type("N", (), {"my_id": 1})()
            self.sent = []
            v2 = _model_blobs(1)
            for b in v2:
                self.layers[SWAP_BASE + b] = _blob_layer(v2[b])
                self._layer_versions[SWAP_BASE + b] = "v2"
            self.head_id = serde.head_blob_id(cfg)
            self.applied = []
            # No boot_result: the flip IS this replica's boot.

        def _expected_digest(self, lid):
            return None

        def _send_to_leader(self, msg):
            self.sent.append(msg)

        def _apply_swap_result(self, version, params):
            self.applied.append((version, params))
            self.boot_result = params

    r = _R()
    ctl = SwapController(r)
    ctl.query_interval = 0
    ctl.on_commit(SwapCommitMsg(0, "v2", swap_base=SWAP_BASE))
    _wait_for(lambda: r.applied, what="flip-as-boot commit")
    assert ctl._versions["v2"]["state"] == "committed"
    before = dict(trace.counter_totals())
    ctl.on_commit(SwapCommitMsg(0, "v2", swap_base=SWAP_BASE,
                                abort=True, revert=True))
    totals = trace.counter_totals()
    assert (totals.get("swap.revert_no_prev", 0)
            - before.get("swap.revert_no_prev", 0)) == 1
    assert (totals.get("swap.reverted", 0)
            - before.get("swap.reverted", 0)) == 0
    # Still COMMITTED, still serving the flipped tree, nothing re-
    # applied, and the retained marker is released (a duplicate revert
    # stays a no-op).
    rec = ctl._versions["v2"]
    assert rec["state"] == "committed" and rec["prev"] is None
    assert len(r.applied) == 1
    assert r.boot_result is r.applied[0][1]


# ------------------------------------- mixed clusters (the wire rule)


def _pkg(name):
    """One package's swap-plane classes, for a mixed cluster."""
    import importlib

    root = {"jax": "distributed_llm_dissemination_tpu",
            "port": "distributed_llm_dissemination_tpu_torch"}[name]
    rt = importlib.import_module(root + ".runtime")
    return SimpleNamespace(
        name=name, t=importlib.import_module(root + ".core.types"),
        Leader=rt.FlowRetransmitLeaderNode,
        Receiver=rt.FlowRetransmitReceiverNode, Node=rt.Node,
        GenRequester=importlib.import_module(
            root + ".runtime.client").GenRequester,
        integrity=importlib.import_module(root + ".utils.integrity"),
        cfg=(tllama if name == "port" else jllama).CONFIGS["tiny"],
        boot_kw={"device": "cpu"} if name == "port" else {})


def _holdings(t, blobs, base=0):
    return {base + b: t.LayerSrc(
        inmem_data=bytearray(data), data_size=len(data),
        meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                         source_type=t.SourceType.MEM))
        for b, data in blobs.items()}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("leader_pkg,dest_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_mixed_cluster_swap_commits_across_packages(leader_pkg, dest_pkg):
    """One swap job over TCP with the leader in one package and the
    serving replica in the other: the flip commits and is confirmed,
    each v2 blob carries the version tag "v2" and verifies against the
    leader's stamp, the two packages' digests of every v2 blob agree,
    and the replica's answers go from v1's ids to v2's."""
    from test_torch_dissemination import _transports

    L, D = _pkg(leader_pkg), _pkg(dest_pkg)
    v1, v2 = _model_blobs(0), _model_blobs(1)
    ids = [0, 1, 9]
    ts = _transports({0: leader_pkg, 1: dest_pkg, 9: dest_pkg})
    seed = _holdings(L.t, v1)
    seed.update(_holdings(L.t, v2, SWAP_BASE))
    base = {1: {b: L.t.LayerMeta() for b in v1}}
    leader = L.Leader(L.Node(0, 0, ts[0]), seed, base,
                      {i: 10 ** 9 for i in ids}, expected_nodes={1})
    dest = D.Receiver(D.Node(1, 0, ts[1]), {}, boot_cfg=D.cfg, **D.boot_kw)
    requester = D.GenRequester(ts[9], my_id=9)
    prompt, max_new = [3, 5, 7], 4
    try:
        dest.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        assert requester.request(1, prompt, max_new, timeout=TIMEOUT) == \
            _expected_tokens(0, prompt, max_new)
        summary = leader.submit_job(
            "swap-v2", {1: {SWAP_BASE + b: L.t.LayerMeta() for b in v2}},
            priority=2, kind="swap", version="v2", swap_base=SWAP_BASE)
        assert summary.get("Version") == "v2"
        _wait_for(lambda: leader.swap_table().get("v2", {}).get(
            "State") == "committed", what="swap commit")
        _wait_for(lambda: dest.serving_version == "v2",
                  what="replica flip")
        _wait_for(lambda: 1 in leader.swap_table()["v2"]["Confirmed"],
                  what="flip confirmation")
        assert requester.request(1, prompt, max_new, timeout=TIMEOUT) == \
            _expected_tokens(1, prompt, max_new)
        for b, data in v2.items():
            lid = SWAP_BASE + b
            assert dest._layer_versions.get(lid) == "v2", lid
            assert bytes(dest.layers[lid].inmem_data) == data
            digest = L.integrity.layer_digest(data)
            assert digest == D.integrity.layer_digest(data)
            if dest._expected_digest(lid) is not None:
                assert dest._expected_digest(lid) == digest
                assert lid in dest._digest_ok, lid
        row = leader.jobs.table()["swap-v2"]
        assert row["State"] == "done" and row["DroppedPairs"] == 0
    finally:
        requester.close()
        close_all(leader, [dest], ts)
