"""The port across several cards of one host: mesh slots over the cards,
and kernel launches on their tensor's card.

``parallel.mesh.slot_devices(n_slots, n_cards, device)`` is where each
mesh slot runs, a pure function of the host's card count: slot i on card
``i mod n_cards`` by default (the JAX package's row-major fill of
``jax.devices()``; the port repeats cards where JAX raises, so one card
still runs every mesh), every slot on card k for ``cuda:k``, on the CPU
for ``cpu``.  Held here without a card.  Then, for the ``Mesh`` sections
of ``conf/`` with at most 8 positions and for ``chip_smoke.py`` phase
16b's topology, the port's node -> (slot index, card) map against the JAX
package's ``fabric_placement(..., mesh_from_conf(conf.mesh))`` over its 8
virtual CPU devices (device ids against card indices).

The ``cuda``-marked case launches K1 and K2 on ``cuda:1`` while
``cuda:0`` is current; it needs two cards and skips here.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.core import config as jcfg
from distributed_llm_dissemination_tpu.parallel import mesh as jmesh
from distributed_llm_dissemination_tpu_torch.core import config as tcfg
from distributed_llm_dissemination_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("n_slots, n_cards, device, want", [
    (5, 1, None, _cuda(0, 0, 0, 0, 0)),           # one card runs any mesh
    (4, 4, None, _cuda(0, 1, 2, 3)),              # one slot per card
    (5, 4, None, _cuda(0, 1, 2, 3, 0)),           # more slots than cards
    (8, 4, "cuda", _cuda(0, 1, 2, 3, 0, 1, 2, 3)),  # "cuda": not pinned
    (3, 4, "cuda:2", _cuda(2, 2, 2)),             # pinned to card 2
    (3, 0, "cpu", [torch.device("cpu")] * 3),     # the tests' CPU runs
    (2, 4, torch.device("cpu"), [torch.device("cpu")] * 2),
])
def test_slot_devices(n_slots, n_cards, device, want):
    assert tmesh.slot_devices(n_slots, n_cards, device) == want


@pytest.mark.parametrize("n_cards, device, match", [
    (0, None, "device='cpu'"),       # no card, none asked for by name
    (0, "cuda:0", "device='cpu'"),
    (4, "cuda:4", "4 cards"),        # a card the host lacks
])
def test_slot_devices_refuses(n_cards, device, match):
    with pytest.raises((RuntimeError, ValueError), match=match):
        tmesh.slot_devices(3, n_cards, device)


def test_device_slots_on_the_cpu_needs_no_card():
    assert tmesh.device_slots(4, "cpu") == [torch.device("cpu")] * 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.device_slots(4)


def _conf_dicts():
    """``conf/`` topologies whose Mesh has at most 8 positions, and phase
    16b's (chip_smoke.py) and phase 12's."""
    import chip_smoke

    out = {}
    for name in sorted(os.listdir(os.path.join(REPO, "conf"))):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(REPO, "conf", name)) as f:
            d = json.load(f)
        mesh = d.get("Mesh")
        if mesh and int(np.prod(mesh.get("AxisSizes", [1]))) <= 8:
            out[name] = d
    sizes = {i: 1 << 20 for i in range(5)}
    out["phase16b"] = chip_smoke.fabric_conf_dict(
        "llama3-8b-d4", 0, sizes, chip_smoke.FABRIC_CUT,
        leader=chip_smoke.CARDS4_LEADER)
    out["phase12"] = chip_smoke.fabric_conf_dict(
        "llama3-8b-d4", 0, sizes, chip_smoke.FABRIC_CUT)
    return out


def test_the_confs_cover_the_small_meshes():
    names = set(_conf_dicts())
    assert {"pod_fabric_4node.json", "train_tiny_pod.json", "phase16b",
            "phase12"} <= names


@pytest.mark.parametrize("name", sorted(_conf_dicts()))
@pytest.mark.parametrize("n_cards", [8, 4])
def test_node_to_slot_and_card_matches_jax(name, n_cards, cpu_devices):
    """Each node's stage slots as (slot index, card index) against JAX's
    (position in the mesh, device id).  With 8 cards the ids are JAX's
    exactly; with 4 (a four-card H100 host) card ``id mod
    4``."""
    d = _conf_dicts()[name]
    jc, tc = jcfg.Config.from_json(d), tcfg.Config.from_json(d)
    ids = [nc.id for nc in tc.nodes]
    assert ids == [nc.id for nc in jc.nodes]
    n = int(np.prod(tc.mesh.axis_sizes))
    slots = [tmesh.Slot(i, dev)
             for i, dev in enumerate(tmesh.slot_devices(n, n_cards))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # nodes sharing stages: both warn
        tp = tmesh.fabric_placement(ids, tc.assignment,
                                    tmesh.mesh_from_conf(tc.mesh, slots),
                                    tc.mesh.pipeline_axis)
        jm = jmesh.mesh_from_conf(jc.mesh)
        jp = jmesh.fabric_placement(ids, jc.assignment, jm,
                                    jc.mesh.pipeline_axis)
    position = {dev.id: i for i, dev in enumerate(jm.devices.reshape(-1))}
    assert tp.node_to_stage == jp.node_to_stage
    for node in ids:
        got = [(s.index, s.device.index) for s in tp.devices_for_node(node)]
        want = [(position[dev.id], dev.id % n_cards)
                for dev in jp.devices_for_node(node)]
        assert got == want, (name, node)


def test_phase16b_puts_stages_and_seeders_on_their_own_cards():
    """Phase 16b's mesh on four cards: the two dests' stages on different
    cards, and the seeders on neither of them."""
    import chip_smoke

    d = _conf_dicts()["phase16b"]
    tc = tcfg.Config.from_json(d)
    slots = [tmesh.Slot(i, dev) for i, dev in enumerate(
        tmesh.slot_devices(int(np.prod(tc.mesh.axis_sizes)), 4))]
    pl = tmesh.fabric_placement([nc.id for nc in tc.nodes], tc.assignment,
                                tmesh.mesh_from_conf(tc.mesh, slots),
                                tc.mesh.pipeline_axis)
    card = {n: pl.devices_for_node(n)[0].device.index
            for n in pl.node_to_stage}
    assert card[3] != card[4]
    assert {card[1], card[2]}.isdisjoint({card[3], card[4]})
    assert card[1] != card[2]
    assert chip_smoke.CARDS4_LEADER not in (1, 2, 3, 4)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card():
    """K1 (decode and prefill) and K2 on ``cuda:1`` while ``cuda:0`` is
    current: each launches on card 1 (``launches_by_device``) and equals
    its plain version there."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the CUDA kernels have no CPU "
                    "mode")
    from distributed_llm_dissemination_tpu_torch.models import quant, serde
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.ops import (
        flash_attention as fa)

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    fa.reset_counts()
    for sq, t, q_off in ((1, 160, 159), (128, 128, 0)):
        qg, k, v = (torch.randn(shape, generator=gen, device=dev)
                    .to(torch.bfloat16)
                    for shape in ((1, 8, 4, sq, 128), (1, 8, t, 128),
                                  (1, 8, t, 128)))
        got = fa.block_attention(qg, k, v, q_off, 0)
        want = fa.block_attention_ref(qg, k, v, q_off, 0)
        torch.cuda.synchronize(dev)
        assert all(x.device == dev for x in got)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
        bound = 1e-4 * (1 + want[0].abs()) + fa.p_round_bound(
            want[2], t, float(v.float().abs().max()),
            torch.bfloat16)[..., None]
        assert bool(((got[0] - want[0]).abs() <= bound).all())
    assert fa.launches_by_device == {"cuda:1": {"decode": 1, "prefill": 1}}
    assert torch.cuda.current_device() == 0

    cfg = CONFIGS["tiny"]
    blob = serde.seeded_blob(cfg, 0, seed=0)
    wire = quant.encode_blob(cfg, 0, blob, "int8")
    table = quant.leaf_table("int8", serde.layer_param_specs(cfg), cfg.dtype)
    src = torch.frombuffer(bytearray(wire), dtype=torch.uint8).to(dev)
    outs = [torch.empty(t.shape, dtype=cfg.dtype, device=dev) for t in table]
    refs = [torch.empty_like(o) for o in outs]
    dq.reset_counts()
    assert dq.dequant("int8", src, table, outs) == 1
    dq.dequant_int8_ref(src, table, refs)
    torch.cuda.synchronize(dev)
    for a, b in zip(outs, refs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert dq.launches_by_device == {"cuda:1": {"int8": 1}}
