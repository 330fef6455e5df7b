"""The port's SLO-guarded rollout pipeline on ``tests/test_rollout.py``'s
cases.

The JAX file's cases, run with the port's classes (``runtime/rollout.py``
is a copy of the JAX module), with replicas serving the JAX-made ``tiny``
blobs on the CPU (``tests/test_torch_swap.py``'s helpers: expected ids
from the port's ``generate``, held equal to the JAX package's).  The
guard's math (histogram percentiles, soak verdicts, SLO parsing, wave
versions) and the per-token ``generate_stepwise`` are compared with the
JAX package's on the same inputs.  Every wait keeps the JAX file's
bound, and the request threads are named ``torch-hammer-*``.

The JAX file's account of what the cases show:

- wave plan expansion + validation (disjointness, trailing wave for
  unwaved dests, default canary-per-replica plan);
- the SLO guard's math: fixed-bucket p99, soak-window deltas, verdicts
  (pass / breach / no_data);
- HEALTHY pipeline e2e (inmem, mode 3): two waves flip in order with
  the next wave's dissemination overlapped, A/B serving is observable
  mid-pipeline (wave-0 replica answers v2 while wave-1 still answers
  v1), both soak verdicts PASS, the rollout completes, zero failed
  requests;
- BAD WAVE e2e: the wave-1 replica's answers are slowed by the seeded
  ``slowserve`` fault — its soak p99 breaches the declared SLO, the
  pipeline auto-PAUSES and rolls the wave back to v1 through the
  first-class revert-abort while the wave-0 replica KEEPS serving v2,
  zero dropped requests;
- leader killed MID-WAVE (both backends): the promoted standby adopts
  the replicated rollout record and resumes the pipeline at the
  correct wave, SLO guard still armed (verdicts recorded at the new
  leader), every wave flips;
- the seeded chaos smoke: corrupt/drop faults on the rollout's data
  plane, seed registered with conftest's replay printer;
- per-TOKEN flip granularity: ``generate_stepwise`` matches
  ``generate`` under a constant provider, and a mid-generation
  provider switch picks the new params up at the next decode step.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.runtime import rollout as jrmod
from distributed_llm_dissemination_tpu.utils import telemetry as jtelemetry

from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation,
    LayerMeta,
    LayerSrc,
    SourceType,
)
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    Node,
)
from distributed_llm_dissemination_tpu_torch.runtime import rollout as rmod
from distributed_llm_dissemination_tpu_torch.runtime.failover import (
    StandbyController,
)
from distributed_llm_dissemination_tpu_torch.transport import reset_registry
from distributed_llm_dissemination_tpu_torch.transport.faults import (
    FaultRule,
    FaultyTransport,
    rules_from_spec,
)
from distributed_llm_dissemination_tpu_torch.transport.messages import (
    MsgType,
    RolloutCtlMsg,
)
from distributed_llm_dissemination_tpu_torch.utils import telemetry, trace

from test_torch_node import close_all, make_transports
from test_torch_swap import (
    _expected_tokens,
    _model_blobs,
    _port_params,
    _tiny,
)

TIMEOUT = 60.0
SWAP_BASE = 1000


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    reset_registry()
    telemetry.reset_run()  # the port's own run-scoped telemetry
    # Fast telemetry shipping: the SLO guard reads the leader's folded
    # per-replica snapshots, so reports must beat the (short) soaks.
    monkeypatch.setenv("DLD_METRICS_INTERVAL_S", "0.25")
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


# --------------------------------------------------------- guard math


def test_percentile_from_hist_is_conservative():
    # 10 samples in the 16..64ms bucket: p99 reads the UPPER bound.
    h = {"buckets": [0, 0, 0, 10] + [0] * 6, "n": 10}
    assert telemetry.percentile_from_hist(h, 0.99) == 64.0
    # A sample in the unbounded tail reads inf — always a breach.
    h = {"buckets": [0] * 9 + [1], "n": 1}
    assert telemetry.percentile_from_hist(h, 0.99) == float("inf")
    assert telemetry.percentile_from_hist({}, 0.99) is None
    assert telemetry.percentile_from_hist(None, 0.99) is None
    # The JAX package reads every histogram the same way.
    for buckets in ([0, 0, 0, 10] + [0] * 6, [0] * 9 + [1],
                    [3, 1, 4, 1, 5, 9, 2, 6, 0, 0]):
        h = {"buckets": buckets, "n": sum(buckets)}
        for q in (0.5, 0.9, 0.99):
            assert telemetry.percentile_from_hist(h, q) == \
                jtelemetry.percentile_from_hist(h, q)
    assert telemetry.HIST_BUCKETS_MS == jtelemetry.HIST_BUCKETS_MS


def test_hist_delta_and_verdicts():
    base = {"hist": {"buckets": [5] + [0] * 9, "sum_ms": 5.0, "n": 5},
            "requests": 5, "failures": 0}
    now = {"hist": {"buckets": [5, 0, 0, 0, 0, 0, 4, 0, 0, 0],
                    "sum_ms": 9000.0, "n": 9},
           "requests": 9, "failures": 0}
    slo = rmod.parse_slo({"P99Ms": 500.0, "MaxFailures": 0,
                          "SoakS": 1.0})
    v = rmod.slo_verdict(base, now, slo)
    # The window's 4 new samples all landed in the 1024..4096 bucket.
    assert v["verdict"] == "breach" and v["p99_ms"] == 4096.0
    assert v["requests"] == 4
    # Same window under a lax SLO passes.
    lax = rmod.parse_slo({"P99Ms": 5000.0})
    assert rmod.slo_verdict(base, now, lax)["verdict"] == "pass"
    # Failure counting breaches independently of latency.
    bad = dict(now, failures=2)
    assert rmod.slo_verdict(base, bad, lax)["verdict"] == "breach"
    # An empty window is no_data, never a silent pass/fail.
    assert rmod.slo_verdict(base, base, slo)["verdict"] == "no_data"
    # Every verdict is the JAX package's on the same windows.
    for spec in ({"P99Ms": 500.0, "MaxFailures": 0, "SoakS": 1.0},
                 {"P99Ms": 5000.0}):
        for a, b in ((base, now), (base, bad), (base, base)):
            assert rmod.slo_verdict(a, b, rmod.parse_slo(spec)) == \
                jrmod.slo_verdict(a, b, jrmod.parse_slo(spec))


def test_parse_slo_defaults():
    slo = rmod.parse_slo(None)
    assert slo["p99_ms"] == 0.0 and slo["max_failures"] == 0
    assert slo["soak_s"] == rmod.DEFAULT_SOAK_S
    assert rmod.parse_slo({"p99_ms": 9.0})["p99_ms"] == 9.0
    for spec in (None, {"p99_ms": 9.0}, {"P99Ms": 500.0, "SoakS": 2.5},
                 {"MaxFailures": 3}):
        assert rmod.parse_slo(spec) == jrmod.parse_slo(spec)
    assert rmod.DEFAULT_SOAK_S == jrmod.DEFAULT_SOAK_S
    assert rmod.DEFAULT_SPLIT == jrmod.DEFAULT_SPLIT


def test_effective_p99_bound_disclosed():
    """The guard enforces p99 at histogram bucket granularity: a
    declared threshold between bucket bounds rounds DOWN to the bound
    below it, and that effective bound is disclosed — in parse_slo's
    output and in every breach message — instead of silently
    surprising the operator with a stricter-than-declared bar."""
    # Bounds pass through; in-between values round down; tiny/zero.
    assert rmod.effective_p99_bound(1024.0) == 1024.0
    assert rmod.effective_p99_bound(2000.0) == 1024.0
    assert rmod.effective_p99_bound(500.0) == 256.0
    assert rmod.effective_p99_bound(0.5) == 0.0
    assert rmod.effective_p99_bound(0.0) == 0.0
    for ms in (0.0, 0.5, 1.0, 3.0, 500.0, 1024.0, 2000.0, 1e9):
        assert rmod.effective_p99_bound(ms) == jrmod.effective_p99_bound(ms)
    assert rmod.parse_slo(
        {"P99Ms": 500.0})["effective_p99_ms"] == 256.0
    # A breach verdict names the enforced bound when it differs from
    # the declared threshold.
    base = {"hist": {"buckets": [0] * 10, "n": 0},
            "requests": 0, "failures": 0}
    now = {"hist": {"buckets": [0, 0, 0, 0, 0, 4, 0, 0, 0, 0],
                    "sum_ms": 2000.0, "n": 4},
           "requests": 4, "failures": 0}
    v = rmod.slo_verdict(base, now, rmod.parse_slo({"P99Ms": 500.0}))
    assert v["verdict"] == "breach"
    assert "enforced at bucket bound 256.0ms" in v["breaches"][0]
    # A declared threshold AT a bound keeps the plain message.
    v = rmod.slo_verdict(base, now, rmod.parse_slo({"P99Ms": 256.0}))
    assert v["verdict"] == "breach"
    assert "enforced at" not in v["breaches"][0]


def test_wave_version_vocabulary():
    assert rmod.wave_version("v2", 3) == "v2#w3"
    assert rmod.base_version("v2#w3") == "v2"
    assert rmod.base_version("v2") == "v2"
    for v, i in (("v2", 0), ("v10", 7), ("a#b", 1)):
        assert rmod.wave_version(v, i) == jrmod.wave_version(v, i)
        assert rmod.base_version(rmod.wave_version(v, i)) == \
            jrmod.base_version(jrmod.wave_version(v, i))


# --------------------------------------------------- plan validation


def test_rollout_wave_plan_validation():
    ids = [0]
    ts, _ = make_transports("inmem", ids)
    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode

    leader = LeaderNode(Node(0, 0, ts[0]), {}, {})
    asg = {d: {SWAP_BASE: LayerMeta()} for d in (1, 2, 3)}
    try:
        with pytest.raises(ValueError, match="disjoint"):
            leader.rollouts.admit("r-dup", asg, [[1], [1, 2]], "v2",
                                  SWAP_BASE)
        with pytest.raises(ValueError, match="non-assignment"):
            leader.rollouts.admit("r-alien", asg, [[7]], "v2", SWAP_BASE)
        with pytest.raises(ValueError, match="Version"):
            leader.rollouts.admit("r-nover", asg, [[1]], "", SWAP_BASE)
        with pytest.raises(ValueError, match="SwapBase"):
            leader.rollouts.admit("r-nobase", asg, [[1]], "v2", -1)
        # Unwaved dests ride one trailing wave; default = one per dest.
        s = leader.rollouts.admit("r-trail", asg, [[2]], "v2", SWAP_BASE,
                                  slo={"SoakS": 60.0})
        assert s["Waves"] == [[2], [1, 3]]
        s2 = leader.rollouts.admit("r-default",
                                   {d: {SWAP_BASE: LayerMeta()}
                                    for d in (5, 4)}, None, "v3",
                                   SWAP_BASE, slo={"SoakS": 60.0})
        assert s2["Waves"] == [[4], [5]]
        # Idempotent re-admission returns the existing record.
        again = leader.rollouts.admit("r-trail", asg, [[2]], "v2",
                                      SWAP_BASE)
        assert again["Waves"] == [[2], [1, 3]]
        # A version belongs to ONE rollout, ever: a second rollout
        # reusing it would cross-wire the wave fences.
        with pytest.raises(ValueError, match="already claimed"):
            leader.rollouts.admit("r-clash",
                                  {7: {SWAP_BASE: LayerMeta()}},
                                  None, "v2", SWAP_BASE)
    finally:
        close_all(leader, [], ts)


def test_rollout_cli_refuses_combined_mutating_verbs():
    """The leader's ctl verb chain executes exactly ONE verb per
    message, so combined CLI flags would silently drop (or mis-target)
    the rest — the tool refuses them up front."""
    from types import SimpleNamespace

    from distributed_llm_dissemination_tpu_torch.cli.main import (
        run_rollouttool,
    )

    args = SimpleNamespace(rollouts=False, rollout_pause="a",
                           rollout_resume="", rollout_split="b:0.5")
    with pytest.raises(SystemExit, match="ONE of"):
        run_rollouttool(args, None)


def test_pause_state_machine_edges():
    """Three pause-window edges of the driver's state machine: a last
    wave that passes while PAUSED still completes the rollout (else it
    reports "running" forever with nothing left to drive); a commit
    racing a pause is WITHHELD (back to held-staged, recommitted on
    resume); and a next wave that failed/aborted during its overlap
    dissemination is retried at the predecessor's pass hand-off."""
    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode

    ts, _ = make_transports("inmem", [0])
    leader = LeaderNode(Node(0, 0, ts[0]), {}, {})
    drv = leader.rollouts
    try:
        # 1. Terminal edge while paused.
        drv.admit("r-p1", {1: {SWAP_BASE: LayerMeta()}}, [[1]], "vp1",
                  SWAP_BASE, slo={"SoakS": 60.0})
        with drv._lock:
            rec = drv._recs["r-p1"]
            rec["wave_states"][0] = rmod.W_PASSED
            rec["state"] = rmod.PAUSED
        drv._advance("r-p1", 0)
        assert drv.summary("r-p1")["State"] == "done"
        assert "vp1#w0" not in leader._swap_holds  # pruned at DONE
        # 2. Commit withheld when a pause lands under the fence.
        drv.admit("r-p2", {1: {SWAP_BASE: LayerMeta()}}, [[1]], "vp2",
                  SWAP_BASE, slo={"SoakS": 60.0})
        fences = []
        leader._commit_swap = lambda wv: fences.append(wv)
        with drv._lock:
            rec = drv._recs["r-p2"]
            rec["wave_states"][0] = rmod.W_COMMITTING
            rec["state"] = rmod.PAUSED
        drv._commit_wave("r-p2", 0)
        assert fences == []
        assert drv.summary("r-p2")["WaveStates"] == ["staged"]
        # 3. A failed/aborted NEXT wave retries at the pass hand-off.
        drv.admit("r-p3", {d: {SWAP_BASE: LayerMeta()} for d in (1, 2)},
                  [[1], [2]], "vp3", SWAP_BASE, slo={"SoakS": 60.0})
        with drv._lock:
            rec = drv._recs["r-p3"]
            rec["wave_states"] = [rmod.W_PASSED, rmod.W_ABORTED]
        drv._advance("r-p3", 0)
        row = drv.summary("r-p3")
        assert row["WaveStates"][1] == "disseminating"
        assert "r-p3:w1.r1" in leader.jobs.table()
    finally:
        close_all(leader, [], ts)


def test_explicit_zero_split_honored():
    """An operator's Split 0.0 (NO eligible v2 traffic during soak) is
    a real choice, not "unset": it rides the wire (JobSubmitMsg uses
    the -1 sentinel, like RolloutCtlMsg) and the driver honors it
    instead of silently coercing it to the 0.5 default."""
    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode
    from distributed_llm_dissemination_tpu_torch.transport.messages import (
        JobSubmitMsg,
    )

    m = JobSubmitMsg(1, "j1", {2: {7: LayerMeta()}}, split=0.0)
    assert m.to_payload()["Split"] == 0.0
    assert JobSubmitMsg.from_payload(m.to_payload()).split == 0.0
    # Unset still omits the key and decodes to the sentinel.
    bare = JobSubmitMsg(1, "j1", {2: {7: LayerMeta()}})
    assert "Split" not in bare.to_payload()
    assert JobSubmitMsg.from_payload(bare.to_payload()).split == -1.0

    ts, _ = make_transports("inmem", [0])
    leader = LeaderNode(Node(0, 0, ts[0]), {}, {})
    try:
        s = leader.rollouts.admit(
            "r-zsplit", {1: {SWAP_BASE: LayerMeta()}}, [[1]], "vz",
            SWAP_BASE, slo={"SoakS": 60.0}, split=0.0)
        assert s["Split"] == 0.0
        s2 = leader.rollouts.admit(
            "r-dsplit", {2: {SWAP_BASE: LayerMeta()}}, [[2]], "vd",
            SWAP_BASE, slo={"SoakS": 60.0})
        assert s2["Split"] == rmod.DEFAULT_SPLIT
    finally:
        close_all(leader, [], ts)


@pytest.mark.timeout(60)
def test_rollout_ctl_mutating_verbs_require_job_token(monkeypatch):
    """Resume re-submits a wave's swap job and a commit flips serving —
    exactly the mutation class DLD_JOB_TOKEN exists for: a token-armed
    leader refuses unauthenticated pause/resume/split (ANSWERED) while
    query stays open like -jobs."""
    import queue as _queue

    from distributed_llm_dissemination_tpu_torch.runtime import LeaderNode
    from distributed_llm_dissemination_tpu_torch.runtime.node import MessageLoop

    monkeypatch.setenv("DLD_JOB_TOKEN", "sesame")
    ids = [0, 9]
    ts, _ = make_transports("inmem", ids)
    leader = LeaderNode(Node(0, 0, ts[0]), {}, {})
    loop = MessageLoop(ts[9])
    replies: "_queue.Queue" = _queue.Queue()
    loop.register(RolloutCtlMsg, replies.put)
    loop.start()

    def ctl(**kw):
        ts[9].send(0, RolloutCtlMsg(9, **kw))
        return replies.get(timeout=TIMEOUT)

    try:
        leader.rollouts.admit(
            "r-auth", {5: {SWAP_BASE: LayerMeta()}}, None, "v9",
            SWAP_BASE, slo={"SoakS": 60.0})
        before = _counters()
        # Unauthenticated mutating verbs: refused, counted, ANSWERED.
        assert "unauthorized" in ctl(rollout_id="r-auth",
                                     pause=True).error
        assert "unauthorized" in ctl(rollout_id="r-auth",
                                     resume=True, auth="guess").error
        assert "unauthorized" in ctl(rollout_id="r-auth",
                                     split=0.1).error
        assert leader.rollouts.summary("r-auth")["State"] == "running"
        assert _delta(before, "jobs.unauthorized") == 3
        # Query stays open; the right token mutates.
        assert not ctl(query=True).error
        resp = ctl(rollout_id="r-auth", pause=True, auth="sesame")
        assert not resp.error
        assert resp.table["r-auth"]["State"] == "paused"
    finally:
        loop.stop()
        close_all(leader, [], ts)


# ------------------------------------------------- serving rig helpers


def _blob_layer(data: bytes) -> LayerSrc:
    return LayerSrc(
        inmem_data=bytearray(data), data_size=len(data),
        meta=LayerMeta(location=LayerLocation.INMEM,
                       source_type=SourceType.MEM))


def _rollout_assignment(dests):
    from distributed_llm_dissemination_tpu_torch.models import serde

    cfg = _tiny()
    ids = [SWAP_BASE + b for b in range(serde.head_blob_id(cfg) + 1)]
    return {d: {lid: LayerMeta() for lid in ids} for d in dests}


def _rig(kind, replica_ids, requester_id=9, wrap=None):
    """Leader 0 seeding v1 + v2; serving replicas; a GenRequester."""
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester,
    )

    cfg = _tiny()
    v1, v2 = _model_blobs(0), _model_blobs(1)
    ids = [0, *replica_ids, requester_id]
    ts, _ = make_transports(kind, ids)
    if wrap:
        for nid, rules, seed in wrap:
            ts[nid] = FaultyTransport(ts[nid], rules, seed=seed)
    seed_layers = {b: _blob_layer(v1[b]) for b in v1}
    seed_layers.update({SWAP_BASE + b: _blob_layer(v2[b]) for b in v2})
    base = {r: {b: LayerMeta() for b in v1} for r in replica_ids}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed_layers, base,
        {i: 10 ** 9 for i in ids}, expected_nodes=set(replica_ids))
    replicas = {r: FlowRetransmitReceiverNode(Node(r, 0, ts[r]), {},
                                              boot_cfg=cfg, device="cpu")
                for r in replica_ids}
    requester = GenRequester(ts[requester_id], my_id=requester_id)
    return leader, replicas, requester, ts, (v1, v2)


class _Hammer:
    """One request loop per replica: continuous traffic so every soak
    window has per-replica latency samples."""

    def __init__(self, requester, replica_ids, prompt, max_new,
                 expect=None):
        self.requester = requester
        self.prompt, self.max_new = prompt, max_new
        self.expect = expect  # allowed answers, or None
        self.failures: list = []
        self.answers: dict = {r: [] for r in replica_ids}
        self.stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._run, args=(r,), daemon=True,
                             name=f"torch-hammer-{r}")
            for r in replica_ids]

    def _run(self, replica):
        while not self.stop.is_set():
            try:
                got = self.requester.request(replica, self.prompt,
                                             self.max_new,
                                             timeout=TIMEOUT)
                if self.expect is not None and got not in self.expect:
                    self.failures.append(f"unexpected answer {got}")
                self.answers[replica].append(got)
            except Exception as e:  # noqa: BLE001 — any failure counts
                self.failures.append(repr(e))
            time.sleep(0.03)

    def start(self):
        for t in self.threads:
            t.start()

    def finish(self, timeout=TIMEOUT):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=timeout)


# ------------------------------------------------ healthy pipeline e2e


@pytest.mark.timeout(240)
def test_rollout_pipeline_healthy_two_waves():
    """Two waves flip IN ORDER under continuous traffic: wave 0 commits
    and soaks while wave 1 disseminates (the overlap), A/B serving is
    observable mid-pipeline, both verdicts PASS, zero failed requests,
    and the committed replicas' retained v1 trees are finalized away."""
    before = _counters()
    leader, replicas, requester, ts, (v1, v2) = _rig("inmem", [1, 2])
    prompt, max_new = [3, 5, 7], 4
    v1_tokens = _expected_tokens(0, prompt, max_new)
    v2_tokens = _expected_tokens(1, prompt, max_new)
    assert v1_tokens != v2_tokens
    hammer = _Hammer(requester, [1, 2], prompt, max_new,
                     expect=(v1_tokens, v2_tokens))
    try:
        for r in replicas.values():
            r.announce()
        leader.ready().get(timeout=TIMEOUT)
        leader.boot_ready().get(timeout=TIMEOUT)
        for r in (1, 2):  # warm the decode jits pre-rollout
            assert requester.request(r, prompt, max_new,
                                     timeout=TIMEOUT) == v1_tokens
        hammer.start()
        summary = leader.submit_job(
            "roll-v2", _rollout_assignment([1, 2]), priority=2,
            kind="rollout", version="v2", swap_base=SWAP_BASE,
            waves=[[1], [2]],
            slo={"P99Ms": 60_000.0, "MaxFailures": 5, "SoakS": 0.8},
            split=0.5)
        assert summary["Waves"] == [[1], [2]]
        # Wave 0 flips first: A/B serving — replica 1 on v2 while
        # replica 2 still answers v1.
        _wait_for(lambda: replicas[1].serving_version == "v2#w0",
                  what="wave-0 flip")
        assert replicas[2].serving_version == ""
        assert requester.request(2, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        traffic = leader.rollouts.traffic_table("roll-v2")
        assert 1 in traffic["v2"] and 2 in traffic["v1"]
        assert traffic["split"] == 0.5
        # The pipeline overlap: wave 1's dissemination job was
        # submitted at wave 0's commit, before wave 0's verdict.
        _wait_for(lambda: "roll-v2:w1" in leader.jobs.table(),
                  what="overlapped wave-1 dissemination")
        # Wave 1 flips after wave 0's soak PASSES.
        _wait_for(lambda: replicas[2].serving_version == "v2#w1",
                  timeout=120.0, what="wave-1 flip")
        _wait_for(lambda: leader.rollouts.summary("roll-v2")["State"]
                  == "done", timeout=120.0, what="rollout completion")
        hammer.finish()
        assert hammer.failures == [], hammer.failures[:3]
        row = leader.rollouts.summary("roll-v2")
        assert row["WaveStates"] == ["passed", "passed"]
        assert {v["verdict"] for v in row["Verdicts"].values()} == {
            "pass"}
        assert row["Traffic"]["v2"] == [1, 2]
        # Post-pipeline: both replicas answer v2.
        for r in (1, 2):
            assert requester.request(r, prompt, max_new,
                                     timeout=TIMEOUT) == v2_tokens
        # Finalize released the retained pre-flip trees.
        for r, wv in ((1, "v2#w0"), (2, "v2#w1")):
            _wait_for(lambda r=r, wv=wv: replicas[r].swap
                      ._versions[wv]["prev"] is None,
                      what=f"finalize releasing wave {wv} on {r}")
        assert _delta(before, "rollout.wave_passed") == 2
        assert _delta(before, "rollout.done") == 1
        assert _delta(before, "rollout.slo_breach") == 0
        assert _delta(before, "swap.flips") == 2
        # DONE pruned the pipeline bookkeeping: a later plain swap
        # colliding with a stale hold marker would register HELD and
        # never flip.
        assert not any(k.startswith("v2#w")
                       for k in leader._swap_holds), leader._swap_holds
    finally:
        hammer.stop.set()
        requester.close()
        close_all(leader, list(replicas.values()), ts)


# --------------------------------------------------- bad wave rollback


@pytest.mark.timeout(240)
def test_bad_wave_breaches_slo_pauses_and_rolls_back():
    """The acceptance scenario (docs/rollout.md): wave 1's replica
    answers slowly (seeded ``slowserve`` delay on its GenerateRespMsg
    sends) — its soak p99 breaches the declared SLO, the pipeline
    auto-PAUSES, and the wave rolls BACK to v1 through the revert-abort
    while the wave-0 replica keeps serving v2.  Zero dropped requests
    fleet-wide."""
    before = _counters()
    _, rules = rules_from_spec("slowserve=1500")
    leader, replicas, requester, ts, (v1, v2) = _rig(
        "inmem", [1, 2], wrap=[(2, rules, 0)])
    prompt, max_new = [2, 4, 6], 4
    v1_tokens = _expected_tokens(0, prompt, max_new)
    v2_tokens = _expected_tokens(1, prompt, max_new)
    hammer = _Hammer(requester, [1, 2], prompt, max_new,
                     expect=(v1_tokens, v2_tokens))
    try:
        for r in replicas.values():
            r.announce()
        leader.ready().get(timeout=TIMEOUT)
        leader.boot_ready().get(timeout=TIMEOUT)
        for r in (1, 2):
            assert requester.request(r, prompt, max_new,
                                     timeout=TIMEOUT) == v1_tokens
        hammer.start()
        leader.submit_job(
            "roll-bad", _rollout_assignment([1, 2]), priority=2,
            kind="rollout", version="v2", swap_base=SWAP_BASE,
            waves=[[1], [2]],
            # p99 bar 2s: the healthy replica's decode sits orders of
            # magnitude below it (bucket bounds 256/1024ms absorb CFS
            # noise), the injected 1.5s answer delay lands every slow
            # sample in the 4096ms bucket — deterministic breach.
            slo={"P99Ms": 2000.0, "MaxFailures": 5, "SoakS": 2.5})
        _wait_for(lambda: replicas[1].serving_version == "v2#w0",
                  what="wave-0 flip")
        # Wave 1 flips, then its soak BREACHES: the guard pauses the
        # pipeline and rolls the wave back.
        _wait_for(lambda: leader.rollouts.summary("roll-bad")["State"]
                  == "paused", timeout=120.0, what="SLO-breach pause")
        hammer.finish()
        row = leader.rollouts.summary("roll-bad")
        assert row["WaveStates"] == ["passed", "failed"]
        verdict = row["Verdicts"]["1"]
        assert verdict["verdict"] == "breach"
        assert verdict["replicas"]["2"]["p99_ms"] > 2000.0
        assert "SLO breach" in row["PausedReason"]
        # Rollback semantics: replica 2 reverted to v1 and answers it;
        # replica 1 (the earlier committed wave) KEEPS serving v2.
        _wait_for(lambda: replicas[2].serving_version == "",
                  what="bad wave reverting to v1")
        assert requester.request(2, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        assert replicas[1].serving_version == "v2#w0"
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v2_tokens
        # Zero dropped requests fleet-wide (slow answers still answer).
        assert hammer.failures == [], hammer.failures[:3]
        assert _delta(before, "rollout.slo_breach") == 1
        assert _delta(before, "rollout.paused") == 1
        assert _delta(before, "swap.reverted") == 1
        assert _delta(before, "swap.reverts_issued") == 1
        # The bad wave's staged v2 was released on the replica.
        assert SWAP_BASE not in replicas[2].layers
        # The leader's swap table shows the wave aborted, wave 0
        # committed.
        assert leader.swap_table()["v2#w1"]["State"] == "aborted"
        assert leader.swap_table()["v2#w0"]["State"] == "committed"
    finally:
        hammer.stop.set()
        requester.close()
        close_all(leader, list(replicas.values()), ts)


@pytest.mark.timeout(240)
def test_replica_crash_during_soak_pauses_and_reverts():
    """A wave replica that CRASHES during its soak must read as a
    breach, never as a silent ``no_data`` pass: the wave fails, the
    pipeline pauses, and the surviving wave replicas revert to the
    pre-flip tree — the guard's whole purpose is stopping the very v2
    that may have killed the canary."""
    before = _counters()
    leader, replicas, requester, ts, (v1, v2) = _rig("inmem", [1, 2])
    try:
        for r in replicas.values():
            r.announce()
        leader.ready().get(timeout=TIMEOUT)
        leader.boot_ready().get(timeout=TIMEOUT)
        leader.submit_job(
            "roll-crash", _rollout_assignment([1, 2]), priority=2,
            kind="rollout", version="v2", swap_base=SWAP_BASE,
            waves=[[1, 2]], slo={"P99Ms": 60_000.0, "SoakS": 60.0})
        _wait_for(lambda: all(
            replicas[r].serving_version == "v2#w0" for r in (1, 2)),
            what="wave-0 flip")
        _wait_for(lambda: leader.rollouts.summary("roll-crash")
                  ["WaveStates"] == ["soaking"], what="soak open")
        leader.crash(2)
        _wait_for(lambda: leader.rollouts.summary("roll-crash")
                  ["State"] == "paused", what="pause on replica crash")
        row = leader.rollouts.summary("roll-crash")
        assert row["WaveStates"] == ["failed"]
        assert "crashed" in row["PausedReason"]
        # The surviving replica rolled back to its pre-flip tree.
        _wait_for(lambda: replicas[1].serving_version == "",
                  what="survivor revert")
        assert _delta(before, "rollout.replica_crashed") == 1
        assert _delta(before, "swap.reverted") >= 1
        # The 60s soak timer fires long after this test: the verdict
        # path must see the failed wave and record nothing.
        assert row["Verdicts"] == {}
    finally:
        requester.close()
        close_all(leader, list(replicas.values()), ts)


# ------------------------------------- leader killed mid-wave (failover)


HB = 0.15
LEASE = 0.2
STANDBY_EXPIRY = 0.8


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_leader_killed_mid_wave_standby_resumes_pipeline(kind):
    """The HA acceptance scenario (docs/rollout.md): the leader admits
    a 2-wave rollout whose v2 bytes it can never deliver (data plane
    fault-wedged), replicates the rollout record + wave swap records +
    job, and dies mid-wave-0.  The promoted standby — holding replica
    copies of the v2 set — must resume the pipeline at wave 0, flip
    BOTH waves in order with the SLO guard still armed (verdicts
    recorded at the NEW leader), and complete the rollout."""
    before = _counters()
    cfg = _tiny()
    v2 = _model_blobs(1)
    ids = [0, 1, 2, 3]
    raw, _ = make_transports(kind, ids)
    ts = dict(raw)
    ts[0] = FaultyTransport(
        raw[0], [FaultRule("drop", "out", msg_type=MsgType.LAYER)],
        seed=1)
    v2_layers = lambda: {SWAP_BASE + b: _blob_layer(v2[b])  # noqa: E731
                         for b in v2}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), v2_layers(), {},
        {i: 10 ** 9 for i in ids}, expected_nodes={2, 3},
        standbys=[1], lease_interval=LEASE, epoch=0)
    leader.boot_enabled = False  # the flip IS the serving transition
    standby = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), v2_layers(),
                                         heartbeat_interval=HB)
    ctl = StandbyController(
        standby, rank=0, lease_timeout=STANDBY_EXPIRY, standbys=[1],
        mode=3, node_network_bw={i: 10 ** 9 for i in ids},
        failure_timeout=0.0, lease_interval=LEASE)
    workers = {w: FlowRetransmitReceiverNode(Node(w, 0, ts[w]), {},
                                             boot_cfg=cfg, device="cpu",
                                             heartbeat_interval=HB)
               for w in (2, 3)}
    try:
        standby.announce()
        for w in workers.values():
            w.announce()
        leader.start_distribution().get(timeout=TIMEOUT)
        leader.submit_job(
            "roll-ha", _rollout_assignment([2, 3]), priority=2,
            kind="rollout", version="v2", swap_base=SWAP_BASE,
            waves=[[2], [3]], slo={"SoakS": 0.5})
        # Mid-wave: the rollout record replicated, wave 0's job is
        # wedged (the leader's layer frames drop; the standby holds
        # the only other copies).
        time.sleep(0.6)
        assert ts[0].stats["drop"] > 0, "kill would not be mid-wave"
        assert leader.rollouts.summary("roll-ha")["WaveStates"][0] in (
            "disseminating", "staged")
        leader.close()
        _wait_for(ctl.promoted.is_set, what="standby promotion")
        new_leader = ctl.leader
        assert new_leader is not None and new_leader.epoch == 1
        # The adopted pipeline resumes at wave 0 and completes BOTH
        # waves, in order, at the bumped epoch.
        _wait_for(lambda: workers[2].serving_version == "v2#w0",
                  timeout=150.0, what="wave-0 flip after takeover")
        _wait_for(lambda: workers[3].serving_version == "v2#w1",
                  timeout=150.0, what="wave-1 flip after takeover")
        _wait_for(lambda: new_leader.rollouts.summary("roll-ha")
                  .get("State") == "done", timeout=120.0,
                  what="resumed rollout completing")
        row = new_leader.rollouts.summary("roll-ha")
        assert row["WaveStates"] == ["passed", "passed"]
        # The guard stayed ARMED across the takeover: both waves have
        # verdicts recorded at the NEW leader (no serve traffic in
        # this rig, so they are honest no_data passes).
        assert set(row["Verdicts"]) == {"0", "1"}
        assert _delta(before, "failover.takeover") >= 1
        assert _delta(before, "swap.flips") == 2
    finally:
        ctl.close()
        close_all(leader, [standby, *workers.values()], ts)


# ------------------------------------------------- seeded chaos smoke


@pytest.mark.timeout(240)
def test_rollout_chaos_smoke_seeded_faults(chaos_seed):
    """Tier-1 chaos: the rollout's v2 dissemination rides a seeded
    corrupt/drop schedule (integrity plane re-requests), a continuous
    request stream hammers both replicas, and the pipeline still
    completes every wave with zero failed requests."""
    spec = "seed=5,corrupt=5,dropin=7,times=6"
    chaos_seed(spec)
    seed, rules = rules_from_spec(spec)
    before = _counters()
    # Inbound faults land on the REPLICA receive path: wrap replica 1.
    leader, replicas, requester, ts, (v1, v2) = _rig(
        "inmem", [1, 2], wrap=[(1, rules, seed)])
    prompt, max_new = [1, 2, 3], 3
    v1_tokens = _expected_tokens(0, prompt, max_new)
    v2_tokens = _expected_tokens(1, prompt, max_new)
    hammer = _Hammer(requester, [1, 2], prompt, max_new,
                     expect=(v1_tokens, v2_tokens))
    try:
        for r in replicas.values():
            r.announce()
        leader.ready().get(timeout=TIMEOUT)
        leader.boot_ready().get(timeout=TIMEOUT)
        for r in (1, 2):
            assert requester.request(r, prompt, max_new,
                                     timeout=TIMEOUT) == v1_tokens
        hammer.start()
        leader.submit_job(
            "roll-chaos", _rollout_assignment([1, 2]), priority=2,
            kind="rollout", version="v2", swap_base=SWAP_BASE,
            waves=[[1], [2]],
            slo={"P99Ms": 60_000.0, "MaxFailures": 5, "SoakS": 0.6})
        _wait_for(lambda: leader.rollouts.summary("roll-chaos")["State"]
                  == "done", timeout=150.0,
                  what="rollout completing under seeded faults")
        hammer.finish()
        assert hammer.failures == [], hammer.failures[:3]
        faulty = ts[1]
        assert faulty.stats["corrupt"] + faulty.stats["drop"] > 0, (
            "chaos smoke fired no faults — vacuous")
        for r, wv in ((1, "v2#w0"), (2, "v2#w1")):
            assert replicas[r].serving_version == wv
        assert _delta(before, "swap.flips") == 2
    finally:
        hammer.stop.set()
        requester.close()
        close_all(leader, list(replicas.values()), ts)


# ------------------------------------------- per-token flip granularity


def test_generate_stepwise_matches_generate_with_constant_params():
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate,
        generate_stepwise,
    )

    cfg = _tiny()
    params = _port_params(0)
    prompt = torch.tensor([[3, 5, 7]])
    ref = generate(params, prompt, cfg, max_new=5)
    got = generate_stepwise(lambda: (params, "v1"), prompt, cfg, max_new=5)
    assert got.tolist() == ref.tolist(), (
        "stepwise decode drifted from the scan path under constant "
        "params")
    # ...and both are the JAX package's greedy ids.
    assert got[0].tolist() == _expected_tokens(0, [3, 5, 7], 5)


def _switching(v1, v2, switch_at):
    calls = [0]

    def provider():
        calls[0] += 1
        # Call 1 = prefill, call k+1 = step k: steps >= switch_at run
        # on v2.
        return (v1, "v1") if calls[0] <= switch_at else (v2, "v2")

    return provider


def test_generate_stepwise_picks_up_new_params_next_step():
    """The per-token flip: an in-flight generation finishes its current
    token on v1 and decodes the NEXT step on v2 — the emitted sequence
    shares v1's prefix up to the switch and then diverges, as the JAX
    package's does."""
    from distributed_llm_dissemination_tpu.models import generate as jgen
    from distributed_llm_dissemination_tpu.models import llama as jllama
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate_stepwise,
    )

    cfg = _tiny()
    v1, v2 = _port_params(0), _port_params(1)
    prompt = torch.tensor([[3, 5, 7]])
    max_new, switch_at = 6, 3
    mixed = generate_stepwise(_switching(v1, v2, switch_at), prompt, cfg,
                              max_new=max_new)[0].tolist()
    pure_v1 = generate_stepwise(lambda: (_port_params(0), "v1"), prompt,
                                cfg, max_new=max_new)[0].tolist()
    # The prefix decoded under v1 matches; the tail picked up v2.
    assert mixed[:switch_at] == pure_v1[:switch_at]
    assert mixed != pure_v1, (
        "the provider switch never reached the decode loop")
    jcfg = jllama.CONFIGS["tiny"]
    jv1, jv2 = (jllama.init_params(jcfg, jax.random.key(s)) for s in (0, 1))
    want = np.asarray(jgen.generate_stepwise(
        _switching(jv1, jv2, switch_at), jnp.asarray([[3, 5, 7]], jnp.int32),
        jcfg, max_new=max_new))[0].tolist()
    assert mixed == want, f"port {mixed} != JAX {want}"


def test_serve_path_token_flip_guard(monkeypatch):
    """DLD_TOKEN_FLIP=1 re-reads the serving tree per step and runs the
    uniformity guard: a request served across a flip completes (its
    answer may legitimately be a cross-version hybrid), and the serve
    telemetry records per-replica latency samples."""
    monkeypatch.setenv("DLD_TOKEN_FLIP", "1")
    leader, replicas, requester, ts, (v1, v2) = _rig("inmem", [1])
    prompt, max_new = [3, 5], 3
    v1_tokens = _expected_tokens(0, prompt, max_new)
    try:
        replicas[1].announce()
        leader.ready().get(timeout=TIMEOUT)
        leader.boot_ready().get(timeout=TIMEOUT)
        assert requester.request(1, prompt, max_new,
                                 timeout=TIMEOUT) == v1_tokens
        snap = telemetry.snapshot()
        assert "serve.latency_ms.n1" in snap["hists"]
        assert snap["counters"]["serve.requests.n1"] >= 1
    finally:
        requester.close()
        close_all(leader, list(replicas.values()), ts)


# --------------------------------------------------- operator channel


@pytest.mark.timeout(120)
def test_rollout_ctl_pause_resume_split_and_query():
    """The operator verbs answer (the serving invariant) and gate the
    pipeline: paused → wave 1 stays held after wave 0 passes; resume →
    it commits; split moves the knob."""
    import queue as _queue

    from distributed_llm_dissemination_tpu_torch.runtime.node import MessageLoop

    leader, replicas, requester, ts, (v1, v2) = _rig("inmem", [1, 2])
    prompt, max_new = [4, 2], 3
    loop = MessageLoop(ts[9])
    replies: "_queue.Queue" = _queue.Queue()
    loop.register(RolloutCtlMsg, replies.put)
    loop.start()
    requester.close()  # this test drives ctl, not generation

    def ctl(**kw):
        ts[9].send(0, RolloutCtlMsg(9, **kw))
        return replies.get(timeout=TIMEOUT)

    try:
        for r in replicas.values():
            r.announce()
        leader.ready().get(timeout=TIMEOUT)
        leader.boot_ready().get(timeout=TIMEOUT)
        leader.submit_job(
            "roll-ctl", _rollout_assignment([1, 2]), priority=2,
            kind="rollout", version="v2", swap_base=SWAP_BASE,
            waves=[[1], [2]], slo={"SoakS": 0.4})
        # Pause IMMEDIATELY: wave 0 may stage but nothing commits.
        resp = ctl(rollout_id="roll-ctl", pause=True)
        assert not resp.error
        assert resp.table["roll-ctl"]["State"] == "paused"
        _wait_for(lambda: leader.swap_table().get("v2#w0", {})
                  .get("Staged"), what="wave 0 staging while paused")
        time.sleep(0.5)
        assert replicas[1].serving_version == "", (
            "a paused pipeline must not flip")
        # Unknown id refused, loudly.
        assert ctl(rollout_id="nope", pause=True).error
        # Split knob.
        resp = ctl(rollout_id="roll-ctl", split=0.75)
        assert not resp.error
        assert resp.table["roll-ctl"]["Split"] == 0.75
        assert ctl(rollout_id="roll-ctl", split=7.0).error
        # Resume: the held wave commits and the pipeline runs out.
        resp = ctl(rollout_id="roll-ctl", resume=True)
        assert not resp.error
        _wait_for(lambda: leader.rollouts.summary("roll-ctl")["State"]
                  == "done", timeout=120.0,
                  what="resumed pipeline completing")
        q = ctl(query=True)
        assert q.table["roll-ctl"]["WaveStates"] == ["passed", "passed"]
    finally:
        loop.stop()
        close_all(leader, list(replicas.values()), ts)
