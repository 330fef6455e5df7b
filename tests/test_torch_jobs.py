"""The port's multi-job service on ``tests/test_jobs.py``'s cases.

The JAX file's cases, run with the port's classes (``sched/jobs.py`` and
the leader's job plane are copies of the JAX modules).  Where a case
plans or answers, the JAX package gets the same inputs and the results
are compared: the job manager's tables and replication records, the
joint solver's tiers and send plans, the job messages' wire bytes.

Added, the job cases other port files left out: the per-submitter quota
and rate limit (``tests/test_codec.py``), the ``-daemon`` / ``-submit``
/ ``-jobs`` CLI loop as port processes on ephemeral ports, and the
``-gen`` boot CLI (``tests/test_tools.py``; ``slow`` as its twin is).

The JAX file's account of what the cases show:

- two overlapping jobs (different priorities) admitted against a live
  leader complete byte-exact with digests verified, and the per-link
  flight recorder splits their bytes per job (dual backend);
- the joint solver plans priority tiers against residual link budget
  (preemption) and fair-shares equal priorities in one graph;
- a v2 delta rollout against a populated content store ships only the
  CHANGED layers — unchanged layers resolve locally, zero wire bytes;
- a node-repair refill sources from a CURRENT holder, not the original
  (slow) seeder;
- the wire plane: JobSubmitMsg admission + JobStatusMsg table query
  from a plain submitter seat.
"""

import json
import os
import queue
import subprocess
import time
from types import SimpleNamespace

import pytest

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu import sched as jsched
from distributed_llm_dissemination_tpu.runtime import store as jstore
from distributed_llm_dissemination_tpu.transport import messages as jmsgs
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation,
    LayerMeta,
    LayerSrc,
    SourceType,
    Status,
)
from distributed_llm_dissemination_tpu_torch import sched as tsched
from distributed_llm_dissemination_tpu_torch.runtime import (
    ContentIndex,
    ContentStore,
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    LeaderNode,
    Node,
    ReceiverNode,
)
from distributed_llm_dissemination_tpu_torch.runtime import store as tstore
from distributed_llm_dissemination_tpu_torch.runtime.node import MessageLoop
from distributed_llm_dissemination_tpu_torch.transport import (
    messages as tmsgs,
    reset_registry,
)
from distributed_llm_dissemination_tpu_torch.transport.messages import (
    JobStatusMsg,
    JobSubmitMsg,
)
from distributed_llm_dissemination_tpu_torch.utils import (
    integrity,
    telemetry,
    trace,
)

from test_torch_cli import _env, _ephemeral, _kill, _port_cmd, _write
from test_torch_node import close_all, layer_bytes, make_transports, mem_layer

TIMEOUT = 20.0
CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")

# Each package's job plane, for the cases run in both.
PORT = SimpleNamespace(t=ttypes, sched=tsched, store=tstore, msgs=tmsgs)
JAX = SimpleNamespace(t=jtypes, sched=jsched, store=jstore, msgs=jmsgs)


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()  # the port's own run-scoped telemetry
    yield
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


def _both(scenario):
    """Run ``scenario(pkg)`` with the port's and the JAX package's job
    plane; the two results must be equal."""
    got = scenario(PORT)
    assert got == scenario(JAX)
    return got


# ------------------------------------------------------- JobManager unit


def _status(pk, held) -> Status:
    return {n: {l: pk.t.LayerMeta(location=pk.t.LayerLocation.INMEM)
                for l in lids} for n, lids in held.items()}


def test_job_manager_admit_ack_complete():
    def scenario(pk):
        M = pk.t.LayerMeta
        mgr = pk.sched.JobManager()
        job = mgr.admit(pk.sched.Job("j1", {2: {7: M(), 8: M()}},
                                     priority=3), _status(pk, {2: [7]}))
        assert job.state == "active"
        assert job.total_pairs == 2 and job.resolved_at_admit == 1
        assert job.remaining == {(2, 8)}
        assert mgr.owner_of(2, 8) == (3, "j1")
        assert mgr.owner_of(2, 7) is None  # already satisfied at admit
        assert mgr.on_ack(2, 9) == []      # unrelated pair
        assert mgr.on_ack(2, 8) == ["j1"]
        assert mgr.get("j1").state == "done"
        assert not mgr.has_active()
        # Idempotent re-admit returns the existing (done) record.
        again = mgr.admit(pk.sched.Job("j1", {2: {8: M()}}),
                          _status(pk, {}))
        assert again.state == "done"
        return mgr.to_json()

    _both(scenario)


def test_job_manager_overlapping_jobs_one_delivery_credits_both():
    def scenario(pk):
        M = pk.t.LayerMeta
        mgr = pk.sched.JobManager()
        mgr.admit(pk.sched.Job("a", {2: {7: M()}}, priority=1),
                  _status(pk, {}))
        mgr.admit(pk.sched.Job("b", {2: {7: M()}, 3: {7: M()}}),
                  _status(pk, {}))
        # Highest priority (then lexical) claimant owns the shared pair.
        assert mgr.owner_of(2, 7) == (1, "a")
        assert sorted(mgr.on_ack(2, 7)) == ["a"]
        assert mgr.get("b").remaining == {(3, 7)}
        # The merged goal carries every ACTIVE job's full target (dest
        # 2's satisfied pair included — the planner skips delivered
        # pairs).
        merged = mgr.merged_assignment({1: {0: M()}})
        assert set(merged) == {1, 2, 3}
        return mgr.table(), {n: sorted(ls) for n, ls in merged.items()}

    _both(scenario)


def test_job_manager_drop_dest_completes_with_visible_degradation():
    def scenario(pk):
        M = pk.t.LayerMeta
        mgr = pk.sched.JobManager()
        mgr.admit(pk.sched.Job("j", {2: {7: M()}, 3: {8: M()}}),
                  _status(pk, {}))
        # (affected, finished): the first drop mutates the record (so
        # the leader re-replicates it) without completing the job.
        assert mgr.drop_dest(2) == (["j"], [])
        assert mgr.get("j").dropped_pairs == 1
        assert 2 not in mgr.get("j").assignment
        assert mgr.drop_dest(3) == (["j"], ["j"])
        job = mgr.get("j")
        assert job.state == "done" and job.dropped_pairs == 2
        assert mgr.drop_dest(2) == ([], [])  # done jobs are untouched
        return mgr.table()

    _both(scenario)


def test_job_manager_record_load_roundtrip():
    def scenario(pk):
        mgr = pk.sched.JobManager()
        mgr.admit(pk.sched.Job("j1", {2: {7: pk.t.LayerMeta()}},
                               priority=2, kind="repair",
                               digests={7: "xxh3:ab"}, avoid_sources={4}),
                  _status(pk, {}))
        record = mgr.to_json()
        restored = pk.sched.JobManager()
        restored.load(record)
        job = restored.get("j1")
        assert job.priority == 2 and job.kind == "repair"
        assert job.digests == {7: "xxh3:ab"}
        assert job.avoid_sources == {4}
        assert job.remaining == {(2, 7)}
        # credit_status reconciles a stale remaining set (takeover path).
        assert restored.credit_status(_status(pk, {2: [7]})) == ["j1"]
        return record

    record = _both(scenario)
    # A replication record written by either package loads in the other.
    for src, dst in ((PORT, JAX), (JAX, PORT)):
        mgr = src.sched.JobManager()
        mgr.admit(src.sched.Job("j1", {2: {7: src.t.LayerMeta()}},
                                priority=2, kind="repair",
                                digests={7: "xxh3:ab"}, avoid_sources={4}),
                  _status(src, {}))
        other = dst.sched.JobManager()
        other.load(json.loads(json.dumps(mgr.to_json())))
        assert other.to_json() == record


# ------------------------------------------------------ solve_joint unit


def _plan(out):
    """A joint solve's (tier times, sends) in a comparable form."""
    t_by_prio, jobs = out
    return t_by_prio, {s: sorted((j.sender_id, j.layer_id, j.data_size,
                                  j.offset, j.dest_id, j.job_id)
                                 for j in jl)
                       for s, jl in jobs.items()}


def test_solve_joint_priority_tiers_consume_residual_budget():
    """One seeder, two jobs to two dests: the higher tier plans at the
    full NIC rate; the lower tier sees only the residue, so its solved
    min-time is strictly worse — preemption by budget reclaim."""
    def scenario(pk):
        M = pk.t.LayerMeta
        size = 1_000_000
        status = {0: {7: M(data_size=size), 8: M(data_size=size)}}
        sizes = {7: size, 8: size}
        bw = {0: 1_000_000, 1: 1_000_000, 2: 1_000_000}
        t_by_prio, jobs = pk.sched.solve_joint(
            [(2, "hi", {1: {7: M()}}), (1, "lo", {2: {8: M()}})],
            status, sizes, bw)
        assert set(t_by_prio) == {1, 2}
        # Tier 2 gets the whole seeder NIC: ~1s.  Tier 1 then shares
        # the leftovers; the seeder's residual is ~0, so its time blows
        # past the high tier's.
        assert t_by_prio[2] <= 1100
        assert t_by_prio[1] > 2 * t_by_prio[2]
        tags = {j.job_id for jl in jobs.values() for j in jl}
        assert tags == {"hi", "lo"}
        return _plan((t_by_prio, jobs))

    _both(scenario)


def test_solve_joint_equal_priorities_fair_share_one_graph():
    """Equal priorities merge into ONE graph: the seeder's NIC splits
    across both jobs and each job's emitted bytes equal its demand."""
    def scenario(pk):
        M = pk.t.LayerMeta
        size = 1_000_000
        status = {0: {7: M(data_size=size), 8: M(data_size=size)}}
        sizes = {7: size, 8: size}
        bw = {0: 1_000_000, 1: 10_000_000, 2: 10_000_000}
        t_by_prio, jobs = pk.sched.solve_joint(
            [(1, "a", {1: {7: M()}}), (1, "b", {2: {8: M()}})],
            status, sizes, bw)
        assert list(t_by_prio) == [1]
        # Both jobs share the 1 MB/s seeder: 2 MB total ≈ 2 s, not 1 s.
        assert 1800 <= t_by_prio[1] <= 2300
        by_job = {}
        for jl in jobs.values():
            for j in jl:
                by_job[j.job_id] = by_job.get(j.job_id, 0) + j.data_size
        assert by_job == {"a": size, "b": size}
        return _plan((t_by_prio, jobs))

    _both(scenario)


def test_solve_joint_shared_pair_planned_once():
    def scenario(pk):
        M = pk.t.LayerMeta
        size = 4096
        status = {0: {7: M(data_size=size)}}
        t_by_prio, jobs = pk.sched.solve_joint(
            [(0, "a", {1: {7: M()}}), (0, "b", {1: {7: M()}})],
            status, {7: size}, {0: 10**9, 1: 10**9})
        total = sum(j.data_size for jl in jobs.values() for j in jl)
        assert total == size  # one delivery serves both jobs
        assert {j.job_id for jl in jobs.values() for j in jl} == {"a"}
        return _plan((t_by_prio, jobs))

    _both(scenario)


# -------------------------------------------------- content store units


def test_content_store_index_lookup_forget():
    def scenario(pk):
        st = pk.store.ContentStore()
        st.index(3, "xxh3:aa")
        st.index(9, "xxh3:aa")
        st.index(4, "xxh3:bb")
        out = [st.lookup("xxh3:aa"), st.digest_of(4)]
        assert out == [3, "xxh3:bb"]  # deterministic lowest id
        st.forget(3)
        out.append(st.lookup("xxh3:aa"))
        assert out[-1] == 9
        st.forget(9)
        assert st.lookup("xxh3:aa") is None
        # Re-indexing a layer under a new digest drops the old vouching.
        st.index(4, "xxh3:cc")
        assert st.lookup("xxh3:bb") is None
        return out + [st.lookup("xxh3:cc")]

    assert ContentStore is tstore.ContentStore
    _both(scenario)


def test_content_index_announce_resets_ack_extends():
    def scenario(pk):
        idx = pk.store.ContentIndex()
        idx.reset_node(2, {7: "xxh3:aa"})
        idx.add(2, 9, "xxh3:bb")
        assert idx.node_has(2, "xxh3:aa") and idx.node_has(2, "xxh3:bb")
        assert idx.holders("xxh3:aa") == [(2, 7)]
        # A re-announce is authoritative: the old vouching is replaced.
        idx.reset_node(2, {9: "xxh3:bb"})
        assert not idx.node_has(2, "xxh3:aa")
        held = idx.holders("xxh3:bb")
        idx.drop_node(2)
        assert not idx.node_has(2, "xxh3:bb")
        return held

    assert ContentIndex is tstore.ContentIndex
    _both(scenario)


# --------------------------------------- overlapping jobs, end to end


@pytest.mark.timeout(90)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_two_overlapping_jobs_byte_exact_with_split_telemetry(kind):
    """The acceptance scenario: two jobs with different priorities
    admitted mid-service complete byte-exact with digests verified, and
    the link flight recorder shows each job's bytes on its own row."""
    before = _counters()
    ids = [0, 1, 2]
    ts, _ = make_transports(kind, ids)
    size = 8 * 1024
    bw = {i: 10**9 for i in ids}
    base = {1: {0: LayerMeta()}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {i: mem_layer(i, size) for i in range(4)},
        base, bw, expected_nodes={1, 2})
    r1 = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    r2 = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {})
    try:
        r1.announce()
        r2.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base

        s_hi = leader.submit_job(
            "j-hi", {1: {1: LayerMeta()}, 2: {1: LayerMeta()}},
            priority=2)
        s_lo = leader.submit_job(
            "j-lo", {2: {2: LayerMeta(), 3: LayerMeta()}}, priority=1)
        assert s_hi["Priority"] == 2 and s_lo["Priority"] == 1

        got = leader.ready().get(timeout=TIMEOUT)
        assert set(got) == {1, 2}
        for node, lids in ((r1, [0, 1]), (r2, [1, 2, 3])):
            for lid in lids:
                src = node.layers.get(lid)
                assert src is not None, (kind, node.node.my_id, lid)
                assert bytes(src.inmem_data) == layer_bytes(lid, size)
                if node._expected_digest(lid) is not None:
                    assert lid in node._digest_ok, (kind, lid)
        table = leader.jobs.table()
        assert table["j-hi"]["State"] == "done"
        assert table["j-lo"]["State"] == "done"
        assert _delta(before, "jobs.admitted") == 2
        assert _delta(before, "jobs.completed") == 2
        # Per-job telemetry split: each job's delivered bytes landed on
        # its own link rows, and sum to exactly its demand.
        links = telemetry.snapshot()["links"]
        per_job = {}
        for key, row in links.items():
            base_key, _, job = key.partition("#")
            if job:
                per_job[job] = (per_job.get(job, 0)
                                + row.get("delivered_bytes", 0))
                # the base row carries at least the job rows' bytes
                assert (links[base_key].get("delivered_bytes", 0)
                        >= row.get("delivered_bytes", 0))
        assert per_job["j-hi"] == 2 * size
        assert per_job["j-lo"] == 2 * size
    finally:
        close_all(leader, [r1, r2], ts)


def _wire(msg):
    return json.dumps(msg.to_payload(), sort_keys=True).encode()


def test_job_messages_wire_bytes_match_jax():
    """The submit/status plane's messages encode to the JAX package's
    bytes, and each decodes in the other package."""
    def msgs(pk):
        M = pk.t.LayerMeta
        return [
            pk.msgs.JobSubmitMsg(9, "wire-job", {1: {1: M()}}, priority=1,
                                 avoid=[8]),
            pk.msgs.JobSubmitMsg(9, "swap-v2", {2: {1000: M(version="v2")}},
                                 priority=2, kind="swap", version="v2",
                                 swap_base=1000,
                                 digests={1000: "xxh3:ab"}, auth="sesame"),
            pk.msgs.JobStatusMsg(9, query=True),
            pk.msgs.JobStatusMsg(0, jobs={"j": {"State": "done",
                                                "DroppedPairs": 0}},
                                 error="unauthorized: token"),
        ]

    for t, j in zip(msgs(PORT), msgs(JAX)):
        assert _wire(t) == _wire(j)
        assert t.msg_type.value == j.msg_type.value
        back = tmsgs.decode_msg(t.msg_type, json.loads(_wire(j)))
        assert _wire(back) == _wire(j)
        fwd = jmsgs.decode_msg(j.msg_type, json.loads(_wire(t)))
        assert _wire(fwd) == _wire(t)


@pytest.mark.timeout(60)
def test_job_submit_and_status_over_the_wire():
    """The -submit/-jobs plane: a plain submitter seat admits a job via
    JobSubmitMsg, gets the admission row back, and a JobStatusMsg query
    returns the full table.  Also: a malformed submit is answered with
    an error, never silence."""
    ids = [0, 1, 9]  # 9 = the submitter's idle seat
    ts, _ = make_transports("inmem", ids)
    size = 4096
    base = {1: {0: LayerMeta()}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {i: mem_layer(i, size) for i in range(2)},
        base, {i: 10**9 for i in ids}, expected_nodes={1})
    r1 = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    loop = MessageLoop(ts[9])
    replies: "queue.Queue" = queue.Queue()
    loop.register(JobStatusMsg, replies.put)
    loop.start()
    try:
        r1.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base

        ts[9].send(0, JobSubmitMsg(9, "wire-job",
                                   {1: {1: LayerMeta()}}, priority=1,
                                   avoid=[8]))
        resp = replies.get(timeout=TIMEOUT)
        assert resp.jobs["wire-job"]["State"] in ("active", "done")
        assert not resp.error
        # The wire-carried avoid set really reaches the admitted job.
        assert leader.jobs.get("wire-job").avoid_sources == {8}

        got = leader.ready().get(timeout=TIMEOUT)
        assert 1 in got[1]
        assert bytes(r1.layers[1].inmem_data) == layer_bytes(1, size)

        ts[9].send(0, JobStatusMsg(9, query=True))
        table = replies.get(timeout=TIMEOUT)
        assert table.jobs["wire-job"]["State"] == "done"
        # The table row is the JAX package's row for the same job.
        jmgr = jsched.JobManager()
        jmgr.admit(jsched.Job("wire-job", {1: {1: jtypes.LayerMeta()}},
                              priority=1, avoid_sources={8}), {})
        jmgr.on_ack(1, 1)
        want = jmgr.table()["wire-job"]
        assert {k: v for k, v in table.jobs["wire-job"].items()
                if not k.endswith("At") and k != "Seconds"} == {
            k: v for k, v in want.items()
            if not k.endswith("At") and k != "Seconds"}

        ts[9].send(0, JobSubmitMsg(9, "", {}))
        bad = replies.get(timeout=TIMEOUT)
        assert bad.error
    finally:
        loop.stop()
        close_all(leader, [r1], ts)


# ------------------------------------------------- quotas / rate limits


def _blob_layer(lid):
    data = bytearray(layer_bytes(lid, 4096))
    return LayerSrc(inmem_data=data, data_size=len(data),
                    meta=LayerMeta(location=LayerLocation.INMEM,
                                   source_type=SourceType.MEM))


def _submit(leader, ts, job_id, src_id=5, auth=""):
    leader.handle_job_submit(JobSubmitMsg(
        src_id, job_id, {1: {0: LayerMeta()}}, auth=auth))
    reply = ts[src_id].deliver().get(timeout=TIMEOUT)
    assert isinstance(reply, JobStatusMsg)
    return reply


def test_job_quota_per_submitter_refuses_loudly(monkeypatch):
    monkeypatch.setenv("DLD_JOB_QUOTA", "1")
    ts, _ = make_transports("inmem", [0, 1, 5, 6])
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {0: _blob_layer(0)}, {},
        {0: 1 << 30, 1: 1 << 30})
    try:
        before = trace.counter_totals().get("jobs.quota_refused", 0)
        ok = _submit(leader, ts, "job-a", src_id=5)
        assert not ok.error and "job-a" in ok.jobs
        # The same submitter's second ACTIVE job is refused — loudly,
        # counted, and ANSWERED.
        refused = _submit(leader, ts, "job-b", src_id=5)
        assert "quota" in refused.error
        assert trace.counter_totals().get(
            "jobs.quota_refused", 0) == before + 1
        # Idempotent resubmit of the known id is never quota-refused.
        again = _submit(leader, ts, "job-a", src_id=5)
        assert not again.error
        # A DIFFERENT submitter identity has its own quota.
        other = _submit(leader, ts, "job-c", src_id=6)
        assert not other.error
    finally:
        leader.close()
        for t in ts.values():
            t.close()


def test_job_rate_limit_per_submitter(monkeypatch):
    monkeypatch.setenv("DLD_JOB_RATE", "1/60")
    ts, _ = make_transports("inmem", [0, 1, 5])
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {0: _blob_layer(0)}, {},
        {0: 1 << 30, 1: 1 << 30})
    try:
        assert not _submit(leader, ts, "job-a").error
        refused = _submit(leader, ts, "job-b")
        assert "rate limited" in refused.error
        assert trace.counter_totals().get("jobs.quota_refused", 0) >= 1
    finally:
        leader.close()
        for t in ts.values():
            t.close()


# ------------------------------------------------- delta rollout (store)


@pytest.mark.timeout(90)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_delta_rollout_ships_only_changed_layers(kind):
    """v2 rollout against a populated content store: layer ids 100/101
    carry v2's content where 100's bytes EQUAL v1 layer 0's (unchanged)
    and 101 is new.  The dest must resolve 100 locally (zero wire
    bytes) and receive only 101 — shipped bytes < changed-fraction ×
    model bytes is asserted on the job's own link telemetry."""
    if not integrity.digests_enabled():
        pytest.skip("content addressing needs layer digests")
    before = _counters()
    ids = [0, 1]
    ts, _ = make_transports(kind, ids)
    size = 8 * 1024
    # v2 content: 100 == v1 layer 0's bytes; 101 is genuinely new.
    v2_unchanged = mem_layer(0, size)
    v2_changed = mem_layer(101, size)
    seed = {0: mem_layer(0, size), 1: mem_layer(1, size),
            100: v2_unchanged, 101: v2_changed}
    base = {1: {0: LayerMeta(), 1: LayerMeta()}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), seed, base, {i: 10**9 for i in ids},
        expected_nodes={1})
    r1 = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), {})
    try:
        r1.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        digests = {
            100: integrity.layer_digest(bytes(v2_unchanged.inmem_data)),
            101: integrity.layer_digest(bytes(v2_changed.inmem_data)),
        }
        assert digests[100] == integrity.layer_digest(
            layer_bytes(0, size))
        summary = leader.submit_job(
            "v2", {1: {100: LayerMeta(), 101: LayerMeta()}},
            priority=1, kind="push", digests=digests)
        assert summary["State"] == "active"
        got = leader.ready().get(timeout=TIMEOUT)
        assert set(got[1]) == {0, 1, 100, 101}
        # Byte-exact: the resolved alias carries v1 layer 0's bytes,
        # the shipped layer carries the new content.
        assert bytes(r1.layers[100].inmem_data) == layer_bytes(0, size)
        assert bytes(r1.layers[101].inmem_data) == layer_bytes(101, size)
        assert leader.jobs.table()["v2"]["State"] == "done"
        # The store did the work: one layer resolved locally, and the
        # leader never shipped it.
        assert _delta(before, "store.resolved_layers") == 1
        assert _delta(before, "store.resolved_bytes") == size
        assert _delta(before, "store.leader_skipped") >= 1
        # Delta bound: shipped == changed bytes only, i.e. half the job.
        links = telemetry.snapshot()["links"]
        v2_rx = sum(row.get("rx_bytes", 0) for key, row in links.items()
                    if key.endswith("#v2"))
        total_job_bytes = 2 * size
        changed_fraction = 0.5
        assert 0 < v2_rx <= total_job_bytes * changed_fraction
    finally:
        close_all(leader, [r1], ts)


@pytest.mark.timeout(60)
def test_content_resolve_when_donor_lands_after_stamp():
    """The stamp-before-donor race: the digest stamp names a missing
    layer whose content-equal DONOR hasn't arrived yet.  When the donor
    lands and verifies, the receiver must re-run the resolve — without
    it the pair wedges (the leader's content index learns the holding
    from the donor's ack and skips shipping forever)."""
    if not integrity.digests_enabled():
        pytest.skip("content addressing needs layer digests")
    from distributed_llm_dissemination_tpu_torch.transport.messages import (
        AckMsg,
        LayerDigestsMsg,
        LayerMsg,
    )

    ids = [0, 1]
    ts, _ = make_transports("inmem", ids)
    r = ReceiverNode(Node(1, 0, ts[1]), {})
    donor = mem_layer(0, 4096)
    digest = integrity.layer_digest(bytes(donor.inmem_data))
    try:
        ts[0].send(1, LayerDigestsMsg(0, {0: digest, 100: digest}))
        _wait_for(lambda: 100 in r.layer_digests,
                  what="digest stamps to land")
        assert 100 not in r.layers  # nothing to resolve from yet
        ts[0].send(1, LayerMsg(0, 0, donor, donor.data_size))
        _wait_for(lambda: 0 in r.layers and 100 in r.layers,
                  what="donor delivery + deferred content resolve")
        assert bytes(r.layers[100].inmem_data) == layer_bytes(0, 4096)
        acked = set()
        deadline = time.monotonic() + TIMEOUT
        while acked < {0, 100} and time.monotonic() < deadline:
            try:
                msg = ts[0].deliver().get(timeout=0.2)
            except queue.Empty:
                continue
            if isinstance(msg, AckMsg):
                acked.add(msg.layer_id)
        assert acked >= {0, 100}, acked
    finally:
        r.close()
        for t in ts.values():
            t.close()


# ----------------------------------------------- repair refill (store)


@pytest.mark.timeout(90)
def test_repair_refill_sources_from_current_holder_not_seeder():
    """A repaired node refills from the nearest CURRENT holder: the
    original seeder models a slow source (1 MB/s), the v1 dest holds
    the layer unlimited — the joint plan must pull the refill from the
    dest, and the link telemetry proves where the bytes came from."""
    ids = [0, 1, 2, 3]
    ts, _ = make_transports("inmem", ids)
    size = 64 * 1024
    lid = 7
    base = {2: {lid: LayerMeta()}}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {}, base, {i: 10**8 for i in ids},
        expected_nodes={1, 2, 3})
    seeder = FlowRetransmitReceiverNode(
        Node(1, 0, ts[1]), {lid: mem_layer(lid, size, rate=1_000_000)})
    holder = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {})
    repaired = FlowRetransmitReceiverNode(Node(3, 0, ts[3]), {})
    try:
        seeder.announce()
        holder.announce()
        repaired.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        assert bytes(holder.layers[lid].inmem_data) == layer_bytes(
            lid, size)

        summary = leader.submit_job(
            "repair-3", {3: {lid: LayerMeta()}}, priority=1,
            kind="repair")
        assert summary["State"] == "active"
        got = leader.ready().get(timeout=TIMEOUT)
        assert lid in got[3]
        assert bytes(repaired.layers[lid].inmem_data) == layer_bytes(
            lid, size)
        links = telemetry.snapshot()["links"]
        from_holder = links.get("2->3", {}).get("delivered_bytes", 0)
        from_seeder = links.get("1->3", {}).get("delivered_bytes", 0)
        assert from_holder == size, links.get("2->3")
        assert from_seeder == 0, (
            "the refill must come from the current holder, not the "
            f"slow original seeder (got {from_seeder} B from it)")
    finally:
        close_all(leader, [seeder, holder, repaired], ts)


# ---------------------------------- jobs ride modes 0-2 (merged goal)


@pytest.mark.timeout(60)
def test_mode0_job_admission_rides_merged_goal():
    ids = [0, 1]
    ts, _ = make_transports("inmem", ids)
    base = {1: {0: LayerMeta()}}
    leader = LeaderNode(Node(0, 0, ts[0]),
                        {i: mem_layer(i) for i in range(2)}, base)
    r1 = ReceiverNode(Node(1, 0, ts[1]), {})
    try:
        r1.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        leader.submit_job("m0-job", {1: {1: LayerMeta()}})
        got = leader.ready().get(timeout=TIMEOUT)
        assert set(got[1]) == {0, 1}
        assert bytes(r1.layers[1].inmem_data) == layer_bytes(1)
        assert leader.jobs.table()["m0-job"]["State"] == "done"
    finally:
        close_all(leader, [r1], ts)


@pytest.mark.timeout(60)
def test_update_preserves_active_job_targets():
    """update() re-targets the BASE goal only: an admitted job's layers
    survive the re-merge instead of being cancelled by the update."""
    ids = [0, 1]
    ts, _ = make_transports("inmem", ids)
    base = {1: {0: LayerMeta()}}
    leader = LeaderNode(Node(0, 0, ts[0]),
                        {i: mem_layer(i) for i in range(3)}, base)
    r1 = ReceiverNode(Node(1, 0, ts[1]), {})
    try:
        r1.announce()
        assert leader.ready().get(timeout=TIMEOUT) == base
        leader.submit_job("keep-me", {1: {1: LayerMeta()}})
        leader.update({1: {0: LayerMeta(), 2: LayerMeta()}})
        got = leader.ready().get(timeout=TIMEOUT)
        # The merged goal carries BOTH the update and the job.
        assert set(got[1]) == {0, 1, 2}
        assert bytes(r1.layers[1].inmem_data) == layer_bytes(1)
        assert bytes(r1.layers[2].inmem_data) == layer_bytes(2)
    finally:
        close_all(leader, [r1], ts)


# ------------------------------------------------ the service CLI loop


@pytest.mark.timeout(240)
def test_daemon_submit_jobs_cli_end_to_end(tmp_path):
    """The dissemination service CLI (docs/service.md) as port
    processes: a -daemon leader + daemon-held receivers finish the boot
    run, then a one-shot `-submit` seat admits a job over the wire and
    `-jobs` polls the table until the job is done."""
    with open(os.path.join(CONF_DIR, "local_4node.json")) as f:
        conf = json.load(f)
    # One extra IDLE seat (id 5) for the submitter.
    conf["Nodes"].append({"Id": 5, "Addr": ":0", "NetworkBW": 12500000000})
    conf_path = _write(tmp_path, "daemon.json", _ephemeral(conf))
    spec_path = str(tmp_path / "job.json")
    with open(spec_path, "w") as f:
        # Node 2 doesn't hold layer 0; holders: the leader and node 4.
        json.dump({"JobID": "cli-push", "Priority": 1,
                   "Assignment": {"2": [0]}}, f)
    node = _port_cmd("main", "-f", conf_path, "-m", "3", "-daemon", "150")
    procs = []
    try:
        for i in range(1, 5):
            procs.append(subprocess.Popen(
                node + ["-id", str(i)], env=_env(),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        procs.append(subprocess.Popen(
            node + ["-id", "0"], env=_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))

        def jobtool(*extra):
            return subprocess.run(
                _port_cmd("main", "-f", conf_path, "-id", "5", *extra),
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                timeout=60)

        # Submit retries until the daemon window is open (the initial
        # delivery may still be running).
        deadline = time.monotonic() + 140
        while True:
            sub = jobtool("-submit", spec_path)
            if sub.returncode == 0:
                break
            assert time.monotonic() < deadline, sub.stdout[-2000:]
            time.sleep(0.5)
        admitted = json.loads(sub.stdout)
        assert "cli-push" in admitted["jobs"], admitted

        while True:
            q = jobtool("-jobs")
            assert q.returncode == 0, q.stdout[-2000:]
            table = json.loads(q.stdout)["jobs"]
            if table.get("cli-push", {}).get("State") == "done":
                break
            assert time.monotonic() < deadline, table
            time.sleep(0.5)
        assert table["cli-push"]["DroppedPairs"] == 0
    finally:
        _kill(procs)


@pytest.mark.slow
@pytest.mark.timeout(420)
def test_boot_cli_generates_tokens(tmp_path):
    """The full CLI serving loop as port processes on the CPU: the
    boot_tiny topology with -gen — the assignee boots the delivered
    model AND decodes tokens; the leader prints Time to first token."""
    with open(os.path.join(CONF_DIR, "boot_tiny_4node.json")) as f:
        conf = json.load(f)
    conf_path = _write(tmp_path, "boot.json", _ephemeral(conf))
    node = _port_cmd("main", "-f", conf_path, "-m", "3", "-gen", "2",
                     "-device", "cpu")
    procs = []
    try:
        for i in range(1, 4):
            procs.append(subprocess.Popen(
                node + ["-id", str(i)], env=_env(),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        leader = subprocess.run(
            node + ["-id", "0"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, timeout=180, env=_env(), text=True)
        assert "Time to deliver" in leader.stdout
        assert "Time to first token" in leader.stdout
        errs = {}
        for i, p in enumerate(procs, start=1):
            _, errs[i] = p.communicate(timeout=30)
            assert p.returncode == 0, errs[i][-2000:]
        # The assignee (node 3) decoded tokens after its full boot.
        assert '"generated": 2' in errs[3], errs[3][-2000:]
    finally:
        _kill(procs)
