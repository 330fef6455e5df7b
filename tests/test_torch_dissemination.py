"""Port parity of the slice as a whole: a mode-3 round of the port's
control plane delivers JAX-made blobs of ``tiny``, stages them, boots
and serves, on the CPU.

- The port twin of ``__graft_entry__._dryrun_dissemination``: leader 0
  and seeder 1 hold every blob (``serde.seeded_blob`` of the JAX package),
  cold dest 2 is assigned all of them with ``stage_hbm``, a one-device
  placement and a boot config (``device="cpu"``).  Every blob lands as a
  tensor with the source's bytes, via incremental ingest, digests
  verified and no fallback fired; the boot's logits lie within
  ``tests/test_torch_model.py``'s tolerance of the JAX boot of the same
  blobs; a ``GenerateReqMsg`` is answered with greedy ids equal to the
  JAX ``generate`` up to the first near-tie.
- Mixed clusters over TCP deliver byte-exact with digests verified: a JAX
  leader with port receivers, and a port leader with a JAX dest.
- ``precompile_boot`` on the CPU returns its record.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.models import generate as jgen
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu.runtime import boot as jboot
from distributed_llm_dissemination_tpu.runtime import (
    FlowRetransmitLeaderNode as JLeader,
    FlowRetransmitReceiverNode as JReceiver,
    Node as JNode,
)
from distributed_llm_dissemination_tpu.transport.tcp import (
    TcpTransport as JTcp,
)
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
    assignment_to_placement,
)
from distributed_llm_dissemination_tpu_torch.runtime import boot as tboot
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode as TLeader,
    FlowRetransmitReceiverNode as TReceiver,
    Node as TNode,
)
from distributed_llm_dissemination_tpu_torch.runtime.client import (
    GenRequester,
)
from distributed_llm_dissemination_tpu_torch.transport.inmem import (
    InmemTransport,
    reset_registry,
)
from distributed_llm_dissemination_tpu_torch.transport.tcp import (
    TcpTransport as TTcp,
)
from distributed_llm_dissemination_tpu_torch.utils import telemetry, trace

from test_torch_model import LOGIT_ATOL, LOGIT_MEAN_ATOL, assert_greedy_agrees

TIMEOUT = 60.0
# The card round's NIC model: far above what the test moves, the dest's
# twice a seeder's so the max-flow plan may use both seeders.
NIC = {0: 1 << 40, 1: 1 << 40, 2: 1 << 41}


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    reset_registry()


@pytest.fixture(scope="module")
def tiny():
    """(jcfg, tcfg, blobs) with blobs from the JAX ``seeded_blob``."""
    jcfg = jllama.CONFIGS["tiny"]
    blobs = {lid: jserde.seeded_blob(jcfg, lid, 0)
             for lid in range(jserde.head_blob_id(jcfg) + 1)}
    return jcfg, tllama.CONFIGS["tiny"], blobs


def _holdings(t, blobs):
    return {lid: t.LayerSrc(inmem_data=bytearray(b), data_size=len(b),
                            meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                                             source_type=t.SourceType.MEM))
            for lid, b in blobs.items()}


def _transports(kinds):
    """One transport per node id; ``kinds[i]`` is ``"inmem"``, ``"port"``
    (port TCP) or ``"jax"`` (JAX TCP)."""
    if all(k == "inmem" for k in kinds.values()):
        reg = {i: f"n{i}" for i in kinds}
        return {i: InmemTransport(reg[i], addr_registry=reg) for i in kinds}
    cls = {"port": TTcp, "jax": JTcp}
    ts = {i: cls[k]("127.0.0.1:0") for i, k in kinds.items()}
    reg = {i: t.get_address() for i, t in ts.items()}
    for t in ts.values():
        t.addr_registry.update(reg)
    return ts


def _close(nodes, ts):
    for n in nodes:
        n.close()
    for t in ts.values():
        t.close()


def _drive(leader, receivers):
    for r in receivers:
        r.announce()
    leader.start_distribution().get(timeout=TIMEOUT)
    leader.ready().get(timeout=TIMEOUT)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_port_round_stages_boots_and_serves_like_jax(kind, tiny):
    jcfg, tcfg, blobs = tiny
    ids = sorted(blobs)
    assignment = {2: {lid: ttypes.LayerMeta() for lid in ids}}
    placement = assignment_to_placement(assignment, ["cpu"])
    t = "inmem" if kind == "inmem" else "port"
    ts = _transports({0: t, 1: t, 2: t, 3: t})
    leader = TLeader(TNode(0, 0, ts[0]), _holdings(ttypes, blobs),
                     assignment, NIC, expected_nodes={1, 2})
    seeder = TReceiver(TNode(1, 0, ts[1]), _holdings(ttypes, blobs))
    dest = TReceiver(TNode(2, 0, ts[2]), {}, stage_hbm=True,
                     placement=placement, boot_cfg=tcfg)
    requester = GenRequester(ts[3], my_id=3)
    try:
        assert dest.device == torch.device("cpu")
        _drive(leader, [seeder, dest])
        booted = leader.boot_ready().get(timeout=TIMEOUT)
        assert set(booted) == {2}

        for lid in ids:
            src = dest.layers[lid]
            assert src.meta.location == ttypes.LayerLocation.HBM
            assert isinstance(src.device_array, torch.Tensor)
            assert src.device_array.numpy().tobytes() == blobs[lid]
        assert dest._digest_ok >= set(ids)
        counters = trace.counter_totals()
        assert counters.get("hbm_staged.incremental_ingest") == len(ids)
        assert not any(v for k, v in counters.items()
                       if k.startswith("fallback."))
        assert dest._precompile_done.wait(TIMEOUT)
        assert dest.precompile_records and \
            dest.precompile_records[0][0]["compiled"]

        res = dest.boot_result
        assert res.kind == "full" and res.via == "streamed per-layer"
        jres = jboot.boot_from_layers(jcfg, _holdings(jtypes, blobs))
        err = np.abs(res.logits.float().numpy() - np.asarray(jres.logits))
        assert err.max() < LOGIT_ATOL, err.max()
        assert err.mean() < LOGIT_MEAN_ATOL, err.mean()

        prompt = np.random.default_rng(5).integers(
            0, jcfg.vocab, (1, 12)).astype(np.int32)
        got = requester.request(2, prompt[0].tolist(), 6, timeout=TIMEOUT)
        want = jgen.generate(jres.params, jnp.asarray(prompt), jcfg, 6)
        assert len(got) == 6
        assert_greedy_agrees(np.asarray([got]), np.asarray(want), prompt,
                             jcfg, jres.params)
    finally:
        requester.close()
        _close([leader, seeder, dest], ts)


def _check_delivered(dest, blobs, t):
    for lid, b in blobs.items():
        src = dest.layers[lid]
        assert src.meta.location == t.LayerLocation.INMEM
        assert bytes(src.inmem_data[:src.data_size]) == b
    assert dest._digest_ok >= set(blobs)


@pytest.mark.timeout(120)
def test_jax_leader_delivers_to_port_receivers_over_tcp(tiny):
    jcfg, _, blobs = tiny
    assignment = {2: {lid: jtypes.LayerMeta() for lid in blobs}}
    ts = _transports({0: "jax", 1: "port", 2: "port"})
    leader = JLeader(JNode(0, 0, ts[0]), _holdings(jtypes, blobs),
                     assignment, NIC, expected_nodes={1, 2})
    seeder = TReceiver(TNode(1, 0, ts[1]), _holdings(ttypes, blobs))
    dest = TReceiver(TNode(2, 0, ts[2]), {})
    try:
        _drive(leader, [seeder, dest])
        _check_delivered(dest, blobs, ttypes)
    finally:
        _close([leader, seeder, dest], ts)


@pytest.mark.timeout(120)
def test_port_leader_delivers_to_a_jax_dest_over_tcp(tiny):
    jcfg, _, blobs = tiny
    assignment = {2: {lid: ttypes.LayerMeta() for lid in blobs}}
    ts = _transports({0: "port", 1: "port", 2: "jax"})
    leader = TLeader(TNode(0, 0, ts[0]), _holdings(ttypes, blobs),
                     assignment, NIC, expected_nodes={1, 2})
    seeder = TReceiver(TNode(1, 0, ts[1]), _holdings(ttypes, blobs))
    dest = JReceiver(JNode(2, 0, ts[2]), {})
    try:
        _drive(leader, [seeder, dest])
        _check_delivered(dest, blobs, jtypes)
    finally:
        _close([leader, seeder, dest], ts)


def test_precompile_boot_on_the_cpu_returns_its_record(tiny):
    _, tcfg, blobs = tiny
    rec = tboot.precompile_boot(tcfg, sorted(blobs), device="cpu")
    assert rec["launches"] == {}  # the plain paths launch no kernel
    assert rec["compiled"] == [
        f"attention:prefill:sq={tboot.BOOT_TOKENS}:hd={tcfg.head_dim}",
        f"attention:decode:sq=1:hd={tcfg.head_dim}",
        f"matmul:{tboot.BOOT_TOKENS}x{tcfg.d_model}x{tcfg.d_model}"]
    assert tboot.precompile_boot(tcfg, [0, 2], device="cpu") == {
        "compiled": [], "launches": {}}
    with pytest.raises(NotImplementedError, match="int8"):
        tboot.precompile_boot(tcfg, sorted(blobs), device="cpu",
                              codec="int8")


def test_fabric_and_pods_are_refused_at_construction():
    ts = _transports({0: "inmem", 1: "inmem"})
    try:
        with pytest.raises(NotImplementedError, match="fabric"):
            TReceiver(TNode(1, 0, ts[1]), {}, fabric=object())
        with pytest.raises(NotImplementedError, match="fabric"):
            TLeader(TNode(0, 0, ts[0]), {}, {}, NIC, fabric=object())
        with pytest.raises(NotImplementedError, match="pod"):
            TLeader(TNode(0, 0, ts[0]), {}, {}, NIC, pods={0: [1]})
    finally:
        for t in ts.values():
            t.close()
