"""The boot holds each layer's leaves as views of its landed blob.

``runtime/boot.py`` assembles a stage or a whole model as a mapping from
leaf name to per-layer tensors, with no stacked copy: a raw blob already
on the device is viewed in place, whichever path assembles it (the
streaming stager, the boot's infill of a blob the stager missed, or the
bulk device path), so a stage needs no memory beyond its landed blobs.
An int8 blob decodes once per layer into leaves of its own.  The values
are the JAX package's boot of the same blobs, bit for bit, for ``tiny``
and ``tiny-moe``; the boot's counters ``boot.stage_bytes`` and
``boot.stage_copied_bytes`` say what it assembled and what it copied.

A two-stage ``tiny-moe`` pod booted this way serves the logits of the
stacked model, and its forward counts the router's picks
(``moe.routed_rows``) against the rows the dense dispatch computed
(``moe.computed_rows``).  On a card the boot of a raw stage allocates
next to nothing.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import quant as jquant
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu.runtime import boot as jboot
from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation, LayerMeta, LayerSrc)
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.runtime import boot as tboot
from distributed_llm_dissemination_tpu_torch.runtime import pp_serve as tpp
from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
    StreamingBootStager)
from distributed_llm_dissemination_tpu_torch.utils import telemetry, trace

from test_torch_pp_serve import PORT, two_stage_boots

STAGE = (1, 2)  # the layer slice a stage boot holds


@pytest.fixture(autouse=True)
def _clean():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.reset_run()
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _blobs(name):
    jcfg = jllama.CONFIGS[name]
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jserde.blobs_from_params(jcfg, params)


def _held(name, kind):
    blobs = _blobs(name)
    ids = sorted(blobs) if kind == "full" else list(STAGE)
    return {lid: blobs[lid] for lid in ids}


@functools.lru_cache(maxsize=None)
def _jax_layers(name, kind, codec="raw"):
    """The JAX package's booted layer leaves, stacked, as int16 bits."""
    jcfg = jllama.CONFIGS[name]
    held = {lid: jquant.encode_blob(jcfg, lid, b, codec)
            for lid, b in _held(name, kind).items()}
    store = {lid: jtypes.LayerSrc(inmem_data=bytearray(b), data_size=len(b))
             for lid, b in held.items()}
    res = jboot.boot_from_layers(jcfg, store, codec=codec)
    layers = res.params["layers"] if kind == "full" else res.params
    return {name_: np.asarray(a).view(np.int16)
            for name_, a in layers.items()}


def _landed(blobs, codec="raw", cfg=None):
    """Each blob as a receiver holds it once landed on the device: a 1-D
    uint8 tensor of its own (here on the CPU), and no host copy."""
    out = {}
    for lid, b in blobs.items():
        if codec != "raw":
            b = jquant.encode_blob(jllama.CONFIGS[cfg.name], lid, b, codec)
        arr = torch.frombuffer(bytearray(b), dtype=torch.uint8)
        out[lid] = LayerSrc(device_array=arr, data_size=len(b),
                            meta=LayerMeta(location=LayerLocation.HBM,
                                           data_size=len(b),
                                           codec="" if codec == "raw"
                                           else codec))
    return out


def _boot(cfg, layers, path, codec="raw"):
    stager = None
    if path != "bulk":
        stager = StreamingBootStager(cfg, codec=codec, device="cpu")
        for lid in sorted(layers)[1 if path == "infill" else 0:]:
            assert stager.submit(lid, layers[lid])
    try:
        return tboot.boot_from_layers(cfg, layers, device="cpu", codec=codec,
                                      stager=stager)
    finally:
        if stager is not None:
            stager.close()


def _layer_params(res):
    return res.params["layers"] if res.kind == "full" else res.params


def _storage(t):
    return t.untyped_storage().data_ptr()


VIA = {"streamed": "streamed per-layer", "infill":
       "streamed per-layer (+1 infilled)", "bulk": "device bitcast"}


@pytest.mark.parametrize("path", ["streamed", "infill", "bulk"])
@pytest.mark.parametrize("kind", ["stage", "full"])
@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_raw_boot_views_its_landed_blobs_and_equals_the_jax_boot(
        name, kind, path):
    cfg = tllama.CONFIGS[name]
    layers = _landed(_held(name, kind))
    landed = {lid: src.device_array for lid, src in layers.items()}
    res = _boot(cfg, layers, path)
    assert res.kind == kind and res.via == VIA[path]
    params = _layer_params(res)
    ids = list(res.layer_ids)
    assert ids == (list(range(cfg.n_layers)) if kind == "full"
                   else list(STAGE))
    assert tllama.n_layers_of(params) == len(ids)
    want = _jax_layers(name, kind)
    assert set(params) == set(want)
    for leaf, per_layer in params.items():
        assert isinstance(per_layer, list) and len(per_layer) == len(ids)
        for j, lid in enumerate(ids):
            t = per_layer[j]
            assert _storage(t) == _storage(landed[lid]), (leaf, lid)
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want[leaf][j], err_msg=leaf)
    # The landed blobs stay where they are, and are what the leaves view.
    assert all(layers[lid].device_array is landed[lid] for lid in ids)
    counters = trace.counter_totals()
    nbytes = sum(tserde.blob_nbytes(cfg, lid) for lid in ids)
    assert counters["boot.stage_bytes"] == nbytes
    assert counters["boot.stage_copied_bytes"] == 0


@pytest.mark.parametrize("path", ["streamed", "bulk"])
def test_int8_stage_boot_decodes_one_copy_per_layer_like_jax(path):
    cfg = tllama.CONFIGS["tiny"]
    layers = _landed(_held("tiny", "stage"), codec="int8", cfg=cfg)
    landed = {lid: _storage(src.device_array) for lid, src in layers.items()}
    res = _boot(cfg, layers, path, codec="int8")
    assert res.via == ("streamed per-layer" if path == "streamed"
                       else "device int8 dequant")
    want = _jax_layers("tiny", "stage", "int8")
    seen = set()
    for leaf, per_layer in res.params.items():
        assert len(per_layer) == len(STAGE)
        for j, lid in enumerate(STAGE):
            t = per_layer[j]
            # decoded into memory of its own, one copy, shared with no
            # other layer's leaf (no stacked second copy)
            assert _storage(t) != landed[lid]
            assert _storage(t) not in seen
            seen.add(_storage(t))
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want[leaf][j], err_msg=leaf)
    counters = trace.counter_totals()
    assert counters["boot.stage_copied_bytes"] == counters[
        "boot.stage_bytes"] == sum(tserde.blob_nbytes(cfg, lid)
                                   for lid in STAGE)


def test_host_held_blobs_go_up_once_and_count_as_copied():
    cfg = tllama.CONFIGS["tiny"]
    held = _held("tiny", "stage")
    layers = {lid: LayerSrc(inmem_data=bytearray(b), data_size=len(b),
                            meta=LayerMeta(location=LayerLocation.INMEM,
                                           data_size=len(b)))
              for lid, b in held.items()}
    res = tboot.boot_from_layers(cfg, layers, device="cpu")
    assert res.via == "host assembly"
    want = _jax_layers("tiny", "stage")
    for leaf, per_layer in res.params.items():
        for j in range(len(STAGE)):
            np.testing.assert_array_equal(
                per_layer[j].view(torch.int16).numpy(), want[leaf][j])
    counters = trace.counter_totals()
    assert counters["boot.stage_copied_bytes"] == counters["boot.stage_bytes"]


def _recording_routes(monkeypatch):
    """Patch ``llama.route_topk`` to keep each call's route mask."""
    masks = []
    real = tllama.route_topk

    def route(weights, cfg):
        w = real(weights, cfg)
        masks.append(w > 0)
        return w

    monkeypatch.setattr(tllama, "route_topk", route)
    return masks


def test_two_stage_moe_pod_from_views_serves_the_stacked_models_logits(
        monkeypatch):
    name = "tiny-moe"
    cfg = tllama.CONFIGS[name]
    blobs = {b: jserde.seeded_blob(jllama.CONFIGS[name], b, 0)
             for b in range(jserde.head_blob_id(jllama.CONFIGS[name]) + 1)}
    tokens = torch.as_tensor(np.arange(32).reshape(2, 16) % cfg.vocab)
    with two_stage_boots(PORT, cfg, 2, blobs) as (placement, results,
                                                  stores):
        for node, res in results.items():
            assert res.kind == "stage"
            for per_layer in res.params.values():
                for j, lid in enumerate(res.layer_ids):
                    assert _storage(per_layer[j]) == _storage(
                        stores[node][lid].device_array)
        telemetry.reset_run()
        masks = _recording_routes(monkeypatch)
        logits, _ = tpp.pod_forward(cfg, placement, results, stores, tokens)
    want = tllama.forward(tserde.params_from_blobs(cfg, blobs), tokens, cfg)
    assert torch.equal(logits, want)
    # The first n_layers masks are the pod forward's (the reference
    # forward above runs outside any count).
    pod = masks[:cfg.n_layers]
    counters = trace.counter_totals()
    assert counters["moe.routed_rows"] == sum(int(m.sum()) for m in pod)
    assert counters["moe.computed_rows"] == sum(m.numel() for m in pod)
    assert counters["moe.computed_rows"] == (
        cfg.n_layers * tokens.numel() * cfg.n_experts)
    assert trace.phase_totals()["moe_ffn"]["n"] == 2 * cfg.n_layers


def test_moe_rows_count_only_inside_the_block_and_nest(monkeypatch):
    cfg = tllama.CONFIGS["tiny-moe"]
    params = tserde.params_from_blobs(
        cfg, {b: jserde.seeded_blob(jllama.CONFIGS["tiny-moe"], b, 0)
              for b in range(cfg.n_layers + 1)})
    tokens = torch.zeros((1, 8), dtype=torch.long)
    masks = _recording_routes(monkeypatch)
    tllama.forward(params, tokens, cfg)  # outside: not counted
    with tllama.MoeRows() as outer:
        tllama.forward(params, tokens, cfg)
        with tllama.MoeRows() as inner:
            tllama.forward(params, tokens, cfg)
    assert inner.report() == sum(int(m.sum()) for m in masks[8:12])
    assert outer.report() == sum(int(m.sum()) for m in masks[4:8])
    counters = trace.counter_totals()
    assert counters["moe.computed_rows"] == 2 * cfg.n_layers * 8 * 4
    # top-2 of 4 experts, ties kept: at least half the rows are routed
    assert (counters["moe.computed_rows"] // 2 <= counters["moe.routed_rows"]
            <= counters["moe.computed_rows"])


@pytest.mark.cuda
def test_raw_stage_boot_on_the_card_allocates_under_5_percent_of_it():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = tllama.ModelConfig(name="boot-views-card", vocab=1024,
                             d_model=4096, n_layers=4, n_heads=32,
                             n_kv_heads=8, d_ff=2048)
    ids = list(range(cfg.n_layers))
    # Warm the kernels and the library handles first: their workspaces
    # are the process's, not the boot's.
    tboot.precompile_boot(cfg, ids, device="cuda")
    layers = {}
    for lid in ids:
        blob = tserde.seeded_blob(cfg, lid, 0, "cuda")
        arr = torch.frombuffer(bytearray(blob), dtype=torch.uint8).cuda()
        layers[lid] = LayerSrc(device_array=arr, data_size=arr.numel(),
                               meta=LayerMeta(location=LayerLocation.HBM,
                                              data_size=arr.numel()))
    stage = sum(tserde.blob_nbytes(cfg, lid) for lid in ids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res = tboot.boot_from_layers(cfg, layers, device="cuda")
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    assert res.kind == "stage" and res.via == "device bitcast"
    assert rise < 0.05 * stage, (rise, stage)
    assert trace.counter_totals()["boot.stage_copied_bytes"] == 0
