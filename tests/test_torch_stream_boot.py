"""Port parity: ``runtime/stream_boot.py`` and the boot around it, on
``tests/test_stream_boot.py``'s cases from the release of consumable
blobs on (``:209-485``).

``tests/test_torch_boot.py`` holds the stager's staging, infill, dedup,
digest gate and slices; this file mirrors the rest:

- the per-blob release of consumed device blobs under forced donation,
  and auto donation leaving CPU tensors alone;
- the spliced salvage round trip of a two-slot ingest;
- the warm boot and the boot warm-up (``precompile_boot``).  The JAX
  tests hold XLA's persistent compilation cache there; the port has none
  (its kernels are built once per source hash by ``ops/cuda_build``, held
  by ``tests/test_torch_cuda_build.py``), so the twins hold what the
  cache must not change: a warm boot, and a boot after the warm-up, equal
  a cold boot bit for bit, and the int8 warm-up runs the one dequant entry
  the stager then calls once per blob (on a card: with no library build);
- a receiver streaming every delivered blob into its boot, whose logits
  equal the port's forward of the source params bit for bit and the JAX
  forward within ``tests/test_torch_model.py``'s tolerance;
- the ``DLD_STREAM_BOOT`` gate.

``tests/test_stream_boot.py:375`` (``ensure_compile_cache``) has no twin:
the port does not port XLA's compilation cache (``ROADMAP.md``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation, LayerMeta, LayerSrc, SourceType)
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import quant, serde
from distributed_llm_dissemination_tpu_torch.ops import dequant
from distributed_llm_dissemination_tpu_torch.parallel.ingest import (
    ShardedLayerIngest)
from distributed_llm_dissemination_tpu_torch.parallel.mesh import make_mesh
from distributed_llm_dissemination_tpu_torch.runtime.boot import (
    boot_from_layers, precompile_boot)
from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
    StreamingBootStager)
from distributed_llm_dissemination_tpu_torch.transport import (
    InmemTransport, reset_registry)

from test_torch_model import LOGIT_ATOL, LOGIT_MEAN_ATOL

CFG = tllama.CONFIGS["tiny"]
SEED = 0
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    reset_registry()
    yield
    torch.set_num_threads(prev)
    reset_registry()


def blob_layer(data: bytes) -> LayerSrc:
    return LayerSrc(inmem_data=bytearray(data), data_size=len(data),
                    meta=LayerMeta(location=LayerLocation.INMEM,
                                   source_type=SourceType.MEM))


def seeded_layers(cfg, codec: str = "raw", device: bool = False):
    """{blob_id: LayerSrc} of the seeded model, with the wire blob also
    held as a CPU "device" tensor when ``device`` (the -hbm shape)."""
    out = {}
    for bid in range(serde.head_blob_id(cfg) + 1):
        enc = quant.encode_blob(cfg, bid, serde.seeded_blob(cfg, bid, SEED,
                                                            "cpu"), codec)
        src = blob_layer(enc)
        if device:
            src.device_array = torch.frombuffer(bytearray(enc),
                                                dtype=torch.uint8)
            src.meta.location = LayerLocation.HBM
        out[bid] = src
    return out


def stage_all(cfg, layers, order, codec: str = "raw"):
    stager = StreamingBootStager(cfg, codec=codec, device="cpu")
    for bid in order:
        assert stager.submit(bid, layers[bid])
    return stager


def _boot(cfg, layers, **kw):
    return boot_from_layers(cfg, layers, device="cpu", **kw)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _same_boot(a, b):
    assert torch.equal(a.logits, b.logits)
    for name, per_layer in a.params["layers"].items():
        other = b.params["layers"][name]
        assert len(per_layer) == len(other), name
        for leaf, want in zip(per_layer, other):
            assert torch.equal(_bits(leaf), _bits(want)), name


# ---------------------------------------------------------- donated staging


def test_streamed_staging_releases_consumable_blobs(monkeypatch):
    """``test_stream_boot.py:209``: with donation forced, each decoded
    blob's device tensor is dropped as its decode runs, mid-stream, and
    the boot equals a host-path boot."""
    monkeypatch.setenv("DLD_BOOT_DONATE", "1")
    cfg = dataclasses.replace(CFG, vocab=240)
    layers = seeded_layers(cfg, device=True)
    ids = sorted(layers)
    stager = stage_all(cfg, layers, ids)
    try:
        assert set(stager.collect(ids, timeout=TIMEOUT)) == set(ids)
        assert all(layers[lid].device_array is None for lid in ids)
        assert layers[0].read_bytes()  # the host copy still serves
        res = _boot(cfg, layers, stager=stager)
    finally:
        stager.close()
    assert res.kind == "full"
    _same_boot(res, _boot(cfg, seeded_layers(cfg)))


def test_auto_donation_keeps_cpu_tensors(monkeypatch):
    """``test_stream_boot.py:233``: auto mode never donates a CPU tensor
    (it may adopt the very host buffer retransmits read)."""
    monkeypatch.delenv("DLD_BOOT_DONATE", raising=False)
    cfg = dataclasses.replace(CFG, vocab=272)
    layers = seeded_layers(cfg, device=True)
    arrs = {lid: layers[lid].device_array for lid in layers}
    res = _boot(cfg, layers)
    assert res.kind == "full"
    assert all(layers[lid].device_array is arrs[lid] for lid in layers)


def test_spliced_salvage_roundtrip():
    """``test_stream_boot.py:247``: after the span buffers are taken,
    salvage reads them clamped to the real spans -- exactly the layer's
    bytes, no pad tail."""
    total = 1000
    data = os.urandom(total)
    slots = make_mesh((2,), ("nodes",), ["cpu"] * 2).slots
    ing = ShardedLayerIngest(total, slots, stream=True)
    assert ing.gpad > ing.pad  # each span buffer carries a pad tail
    for off in range(0, total, 100):
        ing.write(off, data[off:off + 100])
    assert len(ing._span_buffers(timeout=TIMEOUT)) == 2
    rebuilt, covered = bytearray(total), 0
    for off, chunk in ing.salvage():
        rebuilt[off:off + len(chunk)] = chunk
        covered += len(chunk)
    assert covered == total
    assert bytes(rebuilt) == data


# ----------------------------------------------- warm boot and the warm-up


def test_warm_boot_equals_the_cold_boot():
    """``test_stream_boot.py:316``: a second boot of the same blobs in a
    process the first boot warmed equals the cold boot bit for bit."""
    cfg = dataclasses.replace(CFG, vocab=304)
    blobs = {bid: serde.seeded_blob(cfg, bid, SEED, "cpu")
             for bid in range(serde.head_blob_id(cfg) + 1)}
    cold = _boot(cfg, {bid: blob_layer(b) for bid, b in blobs.items()})
    warm = _boot(cfg, {bid: blob_layer(b) for bid, b in blobs.items()})
    assert cold.kind == warm.kind == "full"
    _same_boot(warm, cold)


def test_precompile_then_boot_equals_a_cold_boot():
    """``test_stream_boot.py:352``: the hint-time warm-up names what it
    warmed, and the boot after it equals a boot without it."""
    cfg = dataclasses.replace(CFG, vocab=336)
    ids = list(range(serde.head_blob_id(cfg) + 1))
    cold = _boot(cfg, seeded_layers(cfg))
    rec = precompile_boot(cfg, ids, device="cpu")
    g = cfg.n_heads // cfg.n_kv_heads
    assert rec == {"compiled": [
        f"attention:prefill:sq=16:hd={cfg.head_dim}",
        f"attention:{'decode' if g <= 8 else 'prefill'}:sq=1"
        f":hd={cfg.head_dim}",
        f"matmul:16x{cfg.d_model}x{cfg.d_model}"], "launches": {}}
    _same_boot(_boot(cfg, seeded_layers(cfg)), cold)


def test_precompile_int8_warms_the_stager_decode():
    """``test_stream_boot.py:389``: the int8 warm-up runs the dequant
    entry the stager then calls, once per blob, and the streamed leaves
    equal the host decode bit for bit."""
    cfg = dataclasses.replace(CFG, vocab=368)
    ids = list(range(serde.head_blob_id(cfg) + 1))
    before = dequant.plain_calls["int8"]
    rec = precompile_boot(cfg, ids, device="cpu", codec="int8")
    assert rec["compiled"][0] == "dequant:int8"
    assert dequant.plain_calls["int8"] - before == 1
    layers = seeded_layers(cfg, codec="int8", device=True)
    stager = stage_all(cfg, layers, ids, codec="int8")
    try:
        streamed = stager.collect(ids, timeout=TIMEOUT)
    finally:
        stager.close()
    assert set(streamed) == set(ids)
    assert dequant.plain_calls["int8"] - before == 1 + len(ids)
    for bid in ids:
        host = quant.decode_blob_host(cfg, bid, layers[bid].read_bytes(),
                                      "int8")
        for name, leaf in streamed[bid].items():
            assert torch.equal(_bits(leaf[0]), _bits(host[name])), (bid, name)


@pytest.mark.cuda
def test_precompile_int8_on_the_card_leaves_the_stager_nothing_to_build(
        monkeypatch):
    """On a card: after the int8 warm-up has loaded the dequant library,
    the stager's decodes build nothing and launch K2 once per blob."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from distributed_llm_dissemination_tpu_torch.ops import cuda_build

    ids = list(range(serde.head_blob_id(CFG) + 1))
    rec = precompile_boot(CFG, ids, device="cuda", codec="int8")
    assert f"library:{dequant.SOURCE}" in rec["compiled"]
    assert rec["launches"] == {"dequant_int8": 1}

    def no_build(source):
        raise AssertionError(f"{source} built after the warm-up")

    monkeypatch.setattr(cuda_build, "build", no_build)
    layers = seeded_layers(CFG, codec="int8")
    for src in layers.values():
        src.device_array = torch.frombuffer(
            bytearray(src.read_bytes()), dtype=torch.uint8).cuda()
    before = dequant.launches_by_kernel["int8"]
    stager = StreamingBootStager(CFG, codec="int8", device="cuda")
    try:
        for bid in ids:
            assert stager.submit(bid, layers[bid])
        assert set(stager.collect(ids, timeout=TIMEOUT)) == set(ids)
    finally:
        stager.close()
    assert dequant.launches_by_kernel["int8"] - before == len(ids)


# ------------------------------------------------------- receiver e2e path


def test_receiver_streams_layers_into_the_boot():
    """``test_stream_boot.py:441``: every delivered blob goes to the
    stager mid-run (inmem transport, mode 0), and the startup boot's
    logits equal the port's forward of the source params bit for bit and
    the JAX forward within ``LOGIT_ATOL``/``LOGIT_MEAN_ATOL``."""
    from distributed_llm_dissemination_tpu_torch.runtime import (
        LeaderNode, Node, ReceiverNode)

    params = tllama.init_params(CFG, SEED, "cpu")
    blobs = serde.blobs_from_params(CFG, params)
    jcfg = jllama.CONFIGS["tiny"]
    jparams = jllama.init_params(jcfg, jax.random.key(SEED))
    assert blobs == jserde.blobs_from_params(jcfg, jparams)
    assignment = {1: {bid: LayerMeta() for bid in blobs}}
    ts = {i: InmemTransport(str(i)) for i in (0, 1)}
    leader = LeaderNode(Node(0, 0, ts[0]),
                        {bid: blob_layer(b) for bid, b in blobs.items()},
                        assignment, expected_nodes={1})
    leader.boot_enabled = True
    receiver = ReceiverNode(Node(1, 0, ts[1]), {}, boot_cfg=CFG,
                            device="cpu")
    try:
        assert receiver._boot_stager is not None  # stream boot default-on
        receiver.announce()
        leader.ready().get(timeout=TIMEOUT)
        receiver.ready().get(timeout=TIMEOUT)
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        assert receiver._boot_stager.staged_count == len(blobs)
        res = receiver.boot_result
        assert res is not None and res.kind == "full"
        assert res.via.startswith("streamed per-layer")
        tokens = torch.zeros((1, 16), dtype=torch.long)
        assert torch.equal(res.logits, tllama.forward(params, tokens, CFG))
        want = np.asarray(jllama.forward_jit(
            jparams, jnp.zeros((1, 16), jnp.int32), jcfg), np.float32)
        diff = np.abs(res.logits.float().numpy() - want)
        assert diff.max() < LOGIT_ATOL and diff.mean() < LOGIT_MEAN_ATOL
    finally:
        leader.close()
        receiver.close()
        for t in ts.values():
            t.close()


def test_stream_boot_env_gate(monkeypatch):
    """``test_stream_boot.py:485``: ``DLD_STREAM_BOOT=0`` builds no
    stager."""
    from distributed_llm_dissemination_tpu_torch.runtime import (
        Node, ReceiverNode)

    monkeypatch.setenv("DLD_STREAM_BOOT", "0")
    t = InmemTransport("5")
    r = ReceiverNode(Node(5, 0, t), {}, boot_cfg=CFG, device="cpu")
    try:
        assert r._boot_stager is None
    finally:
        r.close()
        t.close()
