"""The port's mode-3 planner plans exactly what the JAX package plans.

On the instances of ``tests/test_flow.py`` (and seeded random clusters),
the port's ``FlowGraph`` (pure Python) and ``NativeFlowGraph`` (the C++
Dinic, built with ``g++`` into ``build/flow_solver/``) give the same
predicted time and the same jobs as the JAX package's solver of the same
kind: sender, dest, layer, offset, size and the paced rate the leader
derives (``sched.flow.rate_for``).  Inside the port, the Python and C++
solvers agree on the predicted time and both tile every layer.
"""

import random

import pytest

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.native import load_flow_solver as jload
from distributed_llm_dissemination_tpu.sched import flow as jflow
from distributed_llm_dissemination_tpu.sched import native as jnative
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.native import (
    BUILD_DIR,
    load_flow_solver as tload,
)
from distributed_llm_dissemination_tpu_torch.sched import flow as tflow
from distributed_llm_dissemination_tpu_torch.sched import native as tnative

PY = {"jax": jflow.FlowGraph, "port": tflow.FlowGraph}
NATIVE = {"jax": jnative.NativeFlowGraph, "port": tnative.NativeFlowGraph}
TYPES = {"jax": jtypes, "port": ttypes}


def _instance(name, t):
    """One ``tests/test_flow.py`` instance, built with package ``t``'s
    ``LayerMeta``/``SourceType``."""
    def meta(rate=0, st=None):
        return t.LayerMeta(limit_rate=rate,
                           source_type=st if st is not None
                           else t.SourceType.MEM)

    if name == "single_sender_min_time":
        return dict(assignment={1: {0: meta()}}, status={0: {0: meta(100)}},
                    layer_sizes={0: 100}, node_network_bw={0: 100, 1: 100})
    if name == "two_senders_split_layer":
        return dict(assignment={2: {0: meta()}},
                    status={0: {0: meta(100)}, 1: {0: meta(100)}},
                    layer_sizes={0: 200},
                    node_network_bw={0: 100, 1: 100, 2: 200})
    if name == "heterogeneous_rates":
        return dict(assignment={2: {0: meta()}},
                    status={0: {0: meta(10)}, 1: {0: meta(90)}},
                    layer_sizes={0: 100},
                    node_network_bw={0: 100, 1: 100, 2: 100})
    if name == "receiver_nic_bound":
        return dict(assignment={9: {0: meta()}},
                    status={i: {0: meta(1000)} for i in range(4)},
                    layer_sizes={0: 800},
                    node_network_bw={**{i: 1000 for i in range(4)}, 9: 100})
    if name == "unlimited_rate_uses_nic_bw":
        return dict(assignment={1: {0: meta()}}, status={0: {0: meta(0)}},
                    layer_sizes={0: 500}, node_network_bw={0: 100, 1: 100})
    if name == "multiple_layers_multiple_receivers":
        return dict(assignment={1: {0: meta()}, 2: {1: meta()}},
                    status={0: {0: meta(100), 1: meta(100)}},
                    layer_sizes={0: 100, 1: 100},
                    node_network_bw={0: 100, 1: 100, 2: 100})
    if name == "multi_dest_replication":
        return dict(assignment={1: {0: meta()}, 2: {0: meta()}},
                    status={0: {0: meta(100)}}, layer_sizes={0: 100},
                    node_network_bw={0: 200, 1: 100, 2: 100})
    if name == "multi_dest_multi_sender_split":
        return dict(assignment={2: {0: meta()}, 3: {0: meta()}},
                    status={0: {0: meta(100)}, 1: {0: meta(100)}},
                    layer_sizes={0: 200},
                    node_network_bw={0: 100, 1: 100, 2: 100, 3: 100})
    if name == "remaining_override":
        return dict(assignment={1: {0: meta()}, 2: {0: meta()}},
                    status={0: {0: meta(100)}}, layer_sizes={0: 100},
                    node_network_bw={0: 200, 1: 100, 2: 100},
                    remaining={(0, 1): 25})
    if name == "pod_scale":
        n_nodes, n_layers = 32, 80
        return dict(
            assignment={n_nodes - 1: {lid: meta() for lid in range(n_layers)}},
            status={i: {lid: meta(209_715_200, t.SourceType.DISK)
                        for lid in range(n_layers)}
                    for i in range(n_nodes - 1)},
            layer_sizes={lid: 1_750_000_000 for lid in range(n_layers)},
            node_network_bw={i: 1_562_500_000 for i in range(n_nodes)})
    if name == "llama3_8b_d4_two_seeders":
        # The card round's plan: two unlimited seeders, a dest NIC twice
        # a seeder's, the five blobs of llama3-8b-d4.
        sizes = {0: 436_224_000, 1: 436_224_000, 2: 436_224_000,
                 3: 436_224_000, 4: 2_101_354_496}
        return dict(assignment={2: {lid: meta() for lid in sizes}},
                    status={s: {lid: meta() for lid in sizes} for s in (0, 1)},
                    layer_sizes=sizes,
                    node_network_bw={0: 1 << 40, 1: 1 << 40, 2: 1 << 41})
    if name.startswith("random"):
        rng = random.Random(7 + int(name[len("random"):]))
        n_senders, n_layers = rng.randint(1, 6), rng.randint(1, 5)
        sizes = {lid: rng.randint(1, 10_000) for lid in range(n_layers)}
        status = {}
        for s in range(n_senders):
            held = rng.sample(range(n_layers), rng.randint(1, n_layers))
            status[s] = {lid: meta(rng.choice([0, 50, 100, 1000]),
                                   rng.choice(list(t.SourceType)))
                         for lid in held}
        for lid in range(n_layers):
            if not any(lid in held for held in status.values()):
                status[rng.randrange(n_senders)][lid] = meta(100)
        bw = {i: rng.choice([100, 500, 2000]) for i in status}
        bw[100] = rng.choice([100, 500, 2000])
        return dict(assignment={100: {lid: meta() for lid in range(n_layers)}},
                    status=status, layer_sizes=sizes, node_network_bw=bw)
    raise KeyError(name)


NAMES = ["single_sender_min_time", "two_senders_split_layer",
         "heterogeneous_rates", "receiver_nic_bound",
         "unlimited_rate_uses_nic_bw", "multiple_layers_multiple_receivers",
         "multi_dest_replication", "multi_dest_multi_sender_split",
         "remaining_override", "llama3_8b_d4_two_seeders"]
NAMES += [f"random{i}" for i in range(6)]


def _plan(cls, kwargs):
    t, jobs = cls(**kwargs).get_job_assignment()
    rows = sorted((j.sender_id, j.dest_id, j.layer_id, j.offset, j.data_size,
                   jflow.rate_for(j.data_size, t), j.job_id)
                  for js in jobs.values() for j in js)
    return t, rows


def _tiles(rows, kwargs):
    """Every (dest, layer) pair's jobs tile ``[0, n)`` contiguously, where
    n is the layer's size or the pair's ``remaining`` bytes (a resumed
    pair plans in the coordinates of its gaps)."""
    remaining = kwargs.get("remaining") or {}
    by_pair = {}
    for _, dest, lid, off, size, _, _ in rows:
        by_pair.setdefault((dest, lid), []).append((off, off + size))
    for (dest, lid), spans in by_pair.items():
        spans.sort()
        assert spans[0][0] == 0
        assert spans[-1][1] == remaining.get((lid, dest),
                                             kwargs["layer_sizes"][lid])
        for (_, e1), (s2, _) in zip(spans, spans[1:]):
            assert e1 == s2


@pytest.mark.parametrize("name", NAMES)
def test_python_solver_plans_as_the_jax_package(name):
    j = _plan(PY["jax"], _instance(name, jtypes))
    p = _plan(PY["port"], _instance(name, ttypes))
    assert p == j
    _tiles(p[1], _instance(name, ttypes))


@pytest.mark.parametrize("name", NAMES + ["pod_scale"])
def test_native_solver_plans_as_the_jax_package(name):
    if jload() is None or tload() is None:
        pytest.skip("no C++ toolchain: the native solver cannot build")
    j = _plan(NATIVE["jax"], _instance(name, jtypes))
    p = _plan(NATIVE["port"], _instance(name, ttypes))
    assert p == j
    _tiles(p[1], _instance(name, ttypes))


@pytest.mark.parametrize("name", NAMES)
def test_port_native_and_python_agree_on_predicted_time(name):
    if tload() is None:
        pytest.skip("no C++ toolchain: the native solver cannot build")
    kwargs = _instance(name, ttypes)
    t_py, rows_py = _plan(tflow.FlowGraph, kwargs)
    t_nat, rows_nat = _plan(tnative.NativeFlowGraph, kwargs)
    assert t_py == t_nat
    _tiles(rows_py, kwargs)
    _tiles(rows_nat, kwargs)


def test_card_round_plan_uses_both_seeders():
    """The plan ``chip_smoke.py``'s dissemination phase relies on: with
    the dest's NIC twice a seeder's, both seeders carry bytes."""
    kwargs = _instance("llama3_8b_d4_two_seeders", ttypes)
    _, rows = _plan(tnative.make_flow_graph, kwargs)
    sent = {}
    for src, _, _, _, size, _, _ in rows:
        sent[src] = sent.get(src, 0) + size
    assert set(sent) == {0, 1} and all(sent.values())
    assert sum(sent.values()) == sum(kwargs["layer_sizes"].values())


def test_native_library_builds_outside_the_package():
    if tload() is None:
        pytest.skip("no C++ toolchain: the native solver cannot build")
    import os

    import distributed_llm_dissemination_tpu_torch as port

    assert os.path.exists(os.path.join(BUILD_DIR, "libflowsolver.so"))
    assert not os.path.commonpath([BUILD_DIR, os.path.dirname(port.__file__)]
                                  ) == os.path.dirname(port.__file__)
