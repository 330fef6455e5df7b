"""Port parity: the slice as a whole, on the CPU.

JAX-made blobs are delivered as shuffled, duplicated byte-range
fragments into the port's ``ShardedLayerIngest`` (the device-tensor arm
CUDA uses), each finished blob goes to a ``StreamingBootStager`` in
forward or reverse completion order, and ``boot_from_layers(device=
"cpu")`` boots and serves.  The port's stacked params must be
bit-identical to the JAX boot of the same blobs; logits and greedy ids
are held to ``test_torch_model``'s stated tolerance and near-tie rule.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu.runtime import boot as jboot
from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation, LayerMeta, LayerSrc)
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.ops.reassembly import split_offsets
from distributed_llm_dissemination_tpu_torch.parallel.ingest import (
    ShardedLayerIngest)
from distributed_llm_dissemination_tpu_torch.runtime import boot as tboot
from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
    StreamingBootStager)
from distributed_llm_dissemination_tpu_torch.utils import integrity

from test_torch_model import LOGIT_ATOL, assert_greedy_agrees


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; under a parallel
    test run extra threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _blobs(name, seed=0):
    jcfg = jllama.CONFIGS[name]
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tllama.CONFIGS[name], jserde.blobs_from_params(jcfg, params)


def _deliver(blob: bytes, seed: int) -> torch.Tensor:
    """Shuffled 8-way fragments plus one duplicate through the ingest."""
    ing = ShardedLayerIngest(len(blob), ["cpu"], stream=True)
    frags = split_offsets(len(blob), 8)
    random.Random(seed).shuffle(frags)
    for off, size in frags + frags[:1]:
        ing.write(off, memoryview(blob)[off : off + size])
    return ing.finalize(timeout=5)


def _port_store(blobs, device_resident=True):
    layers = {}
    for lid, blob in blobs.items():
        src = LayerSrc(inmem_data=bytearray(blob), data_size=len(blob),
                       meta=LayerMeta(location=LayerLocation.INMEM,
                                      data_size=len(blob)))
        if device_resident:
            src.device_array = _deliver(blob, lid)
            src.meta.location = LayerLocation.HBM
        layers[lid] = src
    return layers


def _jax_store(blobs):
    return {lid: jtypes.LayerSrc(inmem_data=bytearray(b), data_size=len(b))
            for lid, b in blobs.items()}


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("name,order", [("tiny", "forward"),
                                        ("tiny", "reverse"),
                                        ("tiny2", "reverse")])
def test_streamed_boot_matches_jax_boot(name, order):
    jcfg, tcfg, blobs = _blobs(name)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab, (1, 16)).astype(np.int32)
    jres = jboot.boot_from_layers(jcfg, _jax_store(blobs),
                                  tokens=jnp.asarray(prompt),
                                  generate_tokens=4)

    layers = _port_store(blobs)
    stager = StreamingBootStager(tcfg, device="cpu")
    ids = sorted(layers)
    for lid in (ids if order == "forward" else ids[::-1]):
        assert stager.submit(lid, layers[lid])
    res = tboot.boot_from_layers(tcfg, layers, device="cpu", stager=stager,
                                 tokens=torch.from_numpy(prompt).long(),
                                 generate_tokens=4)
    stager.close()
    assert res.kind == "full" and res.via == "streamed per-layer"
    for name_ in jres.params["layers"]:
        np.testing.assert_array_equal(_bits(res.params["layers"][name_]),
                                      _bits(jres.params["layers"][name_]))
    for name_ in ("embed", "ln_f", "lm_head"):
        np.testing.assert_array_equal(_bits(res.params[name_]),
                                      _bits(jres.params[name_]))
    err = np.abs(res.logits.numpy() - np.asarray(jres.logits))
    assert err.max() < LOGIT_ATOL, err.max()
    assert tuple(res.tokens.shape) == (1, 4)
    assert_greedy_agrees(res.tokens.numpy(), np.asarray(jres.tokens), prompt,
                         jcfg, jres.params)


def test_stager_miss_is_infilled():
    _, tcfg, blobs = _blobs("tiny")
    layers = _port_store(blobs)
    stager = StreamingBootStager(tcfg, device="cpu")
    for lid in layers:
        if lid != 1:
            stager.submit(lid, layers[lid])
    res = tboot.boot_from_layers(tcfg, layers, device="cpu", stager=stager)
    assert res.via == "streamed per-layer (+1 infilled)"
    ref = tboot.boot_from_layers(tcfg, _port_store(blobs, False),
                                 device="cpu")
    assert ref.via == "host assembly"
    assert torch.equal(res.logits, ref.logits)


def test_device_assembly_and_forced_donation(monkeypatch):
    _, tcfg, blobs = _blobs("tiny")
    layers = _port_store(blobs)
    res = tboot.boot_from_layers(tcfg, layers, device="cpu")
    assert res.via == "device bitcast"
    assert all(src.device_array is not None for src in layers.values())
    monkeypatch.setenv("DLD_BOOT_DONATE", "1")
    layers = _port_store(blobs)
    donated = tboot.boot_from_layers(tcfg, layers, device="cpu")
    assert donated.via == "device bitcast (donated)"
    assert all(src.device_array is None for src in layers.values())
    assert torch.equal(donated.logits, res.logits)


def test_stage_boot_of_a_layer_slice():
    _, tcfg, blobs = _blobs("tiny")
    layers = {lid: src for lid, src in _port_store(blobs).items()
              if lid in (1, 2)}
    res = tboot.boot_from_layers(tcfg, layers, device="cpu",
                                 generate_tokens=3)
    assert res.kind == "stage" and list(res.layer_ids) == [1, 2]
    assert tuple(res.activations.shape) == (1, 16, tcfg.d_model)
    assert res.tokens is None
    assert tuple(res.params["wq"].shape[:1]) == (2,)


def test_digest_gate():
    _, tcfg, blobs = _blobs("tiny")
    digests = {lid: integrity.layer_digest(b) for lid, b in blobs.items()}
    verified = set()
    tboot.boot_from_layers(tcfg, _port_store(blobs, False), device="cpu",
                           digest_lookup=digests.get,
                           digest_verified=verified)
    assert verified == set(blobs)
    bad = dict(digests)
    bad[0] = integrity.layer_digest(b"not the layer")
    with pytest.raises(ValueError, match="digest"):
        tboot.boot_from_layers(tcfg, _port_store(blobs, False),
                               device="cpu", digest_lookup=bad.get)


def test_classify_held_blobs_matches_jax():
    jcfg, tcfg = jllama.CONFIGS["tiny"], tllama.CONFIGS["tiny"]
    for held in ([0, 1, 2, 3, 4], [1, 2], [2], [0, 1, 2, 3, 4, 9]):
        assert (tboot.classify_held_blobs(tcfg, held)
                == jboot.classify_held_blobs(jcfg, held))
    for held in ([0, 2], [4], []):
        with pytest.raises(ValueError):
            tboot.classify_held_blobs(tcfg, held)
        with pytest.raises(ValueError):
            jboot.classify_held_blobs(jcfg, held)


def test_stager_dedup_invalidate_and_close():
    _, tcfg, blobs = _blobs("tiny")
    layers = _port_store(blobs)
    stager = StreamingBootStager(tcfg, device="cpu")
    assert stager.submit(0, layers[0])
    assert not stager.submit(0, layers[0])  # duplicate
    assert not stager.submit(99, layers[0])  # past the head blob
    assert set(stager.collect([0, 1])) == {0}
    assert stager.staged_count == 1
    stager.invalidate(0)
    assert stager.collect([0]) == {}
    assert stager.submit(0, layers[0])  # re-stages after invalidate
    stager.mark_startup()
    assert set(stager.collect([0])) == {0}
    stager.close()
    assert not stager.submit(1, layers[1])


def test_attention_calls_follow_chip_smoke_launch_plan():
    """``chip_smoke.py`` requires exactly ``serving_shapes``' launch count
    from the main path; the boot + serve makes exactly those calls, in
    that order, with those shapes."""
    import chip_smoke
    from distributed_llm_dissemination_tpu_torch.ops import (
        flash_attention as tfa)

    _, tcfg, blobs = _blobs("tiny")
    calls = []

    def counting(qg, k, v, q_off, k_off):
        calls.append((qg.shape[3], k.shape[2], q_off, k_off))
        return tfa.block_attention_ref(qg, k, v, q_off, k_off)

    prompt, gen = 8, 5
    tboot.boot_from_layers(tcfg, _port_store(blobs), device="cpu",
                           tokens=torch.zeros((1, prompt), dtype=torch.long),
                           generate_tokens=gen, attention=counting)
    plan = [(sq, t, q_off, 0)
            for n, sq, t, q_off in chip_smoke.serving_shapes(tcfg, prompt, gen)
            for _ in range(n)]
    assert calls == plan
