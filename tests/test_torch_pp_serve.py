"""The port's pod-level pipelined serving on ``tests/test_pp_serve.py``'s
cases, the quantized pod fabric (``tests/test_quant.py``) and a Hugging
Face checkpoint served across two stages (``tests/test_hf.py``).

A model's seeded blobs (the JAX package's ``serde.seeded_blob``) are
disseminated across two pipeline stages; the stages boot from the landed
bytes and the pod serves one forward (``runtime.pp_serve.pod_forward``)
and a greedy decode (``pod_decode``) from them.  The same dissemination
runs in the JAX package (8 virtual CPU devices) and its pod decode's ids
must equal the port's.  Logits are held to the JAX reference forward
with ``tests/test_torch_model.py``'s tolerance (``LOGIT_ATOL`` on the
max difference, ``LOGIT_MEAN_ATOL`` on the mean).
"""

import contextlib
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu import parallel as jpar
from distributed_llm_dissemination_tpu import runtime as jrt
from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.models import generate as jgen
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu.runtime import pp_serve as jpp
from distributed_llm_dissemination_tpu.transport import (
    InmemTransport as JInmem,
)
from distributed_llm_dissemination_tpu_torch import runtime as trt
from distributed_llm_dissemination_tpu_torch.core import config as cfg_mod
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.models import generate as tgen
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.parallel import mesh as tmesh
from distributed_llm_dissemination_tpu_torch.runtime import pp_serve as tpp
from distributed_llm_dissemination_tpu_torch.transport import (
    InmemTransport,
    reset_registry,
)
from distributed_llm_dissemination_tpu_torch.utils import telemetry

from test_torch_model import LOGIT_ATOL, LOGIT_MEAN_ATOL

TIMEOUT = 60.0
SEED = 0

PORT = SimpleNamespace(
    rt=trt, t=ttypes, transport=InmemTransport,
    placement=lambda a: tmesh.assignment_to_placement(
        a, tmesh.make_mesh((2, 4), ("pp", "tp"), ["cpu"] * 8), "pp"))
JAX = SimpleNamespace(
    rt=jrt, t=jtypes, transport=JInmem,
    placement=lambda a: jpar.assignment_to_placement(
        a, jpar.make_mesh((2, 4), ("pp", "tp")), "pp"))


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()
    yield
    reset_registry()


def _blob_layer(t, data: bytes):
    return t.LayerSrc(
        inmem_data=bytearray(data), data_size=len(data),
        meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                         source_type=t.SourceType.MEM))


def _seeded_blobs(name):
    jcfg = jllama.CONFIGS[name]
    return {b: jserde.seeded_blob(jcfg, b, SEED)
            for b in range(jserde.head_blob_id(jcfg) + 1)}


@contextlib.contextmanager
def two_stage_boots(pkg, mcfg, cut, blobs):
    """Disseminate ``blobs`` (the model ``mcfg``'s) across two stages
    split at ``cut`` (stage 2 also gets the head blob), wait for the
    stage boots, and yield (placement, results, stores)."""
    head_id = max(blobs)
    t = pkg.t
    assignment = {
        1: {b: t.LayerMeta() for b in range(cut)},
        2: {b: t.LayerMeta() for b in range(cut, head_id + 1)},
    }
    placement = pkg.placement(assignment)
    ts = {i: pkg.transport(str(i)) for i in range(3)}
    rt = pkg.rt
    leader = rt.FlowRetransmitLeaderNode(
        rt.Node(0, 0, ts[0]),
        {b: _blob_layer(t, d) for b, d in blobs.items()},
        assignment, {i: 10**9 for i in range(3)}, expected_nodes={1, 2})
    receivers = {
        i: rt.FlowRetransmitReceiverNode(
            rt.Node(i, 0, ts[i]), {}, stage_hbm=True, placement=placement,
            boot_cfg=mcfg)
        for i in (1, 2)
    }
    try:
        for r in receivers.values():
            r.announce()
        assert leader.start_distribution().get(timeout=TIMEOUT) == assignment
        assert leader.ready().get(timeout=TIMEOUT) == assignment
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1, 2}
        results = {i: r.boot_result for i, r in receivers.items()}
        stores = {i: r.layers for i, r in receivers.items()}
        yield placement, results, stores
    finally:
        leader.close()
        for r in receivers.values():
            r.close()
        for t_ in ts.values():
            t_.close()


def _tokens(vocab):
    return np.arange(32).reshape(2, 16) % vocab


def _jax_logits(name, tokens):
    jcfg = jllama.CONFIGS[name]
    want = jllama.forward_jit(jllama.init_params(jcfg, jax.random.key(SEED)),
                              jnp.asarray(tokens, jnp.int32), jcfg)
    return np.asarray(jax.device_get(want), np.float32)


def _assert_logits(got, want):
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() < LOGIT_ATOL, diff.max()
    assert diff.mean() < LOGIT_MEAN_ATOL, diff.mean()


def test_two_stage_dissemination_then_pod_forward():
    cfg = tllama.CONFIGS["tiny"]
    with two_stage_boots(PORT, cfg, 2, _seeded_blobs("tiny")) as (
            placement, results, stores):
        assert all(r.kind == "stage" for r in results.values())
        tokens = _tokens(cfg.vocab)
        out = tpp.pod_forward(cfg, placement, results, stores,
                              torch.as_tensor(tokens))
        assert out is not None, "pod not servable"
        logits, dt = out
        assert dt > 0
        _assert_logits(logits, _jax_logits("tiny", tokens))
        # The boots' per-layer leaves are served in place: no weight copy.
        assembled = tpp.assemble_pp_params(cfg, placement, results, stores)
        layer0 = assembled[1][0][0]["wq"]
        assert layer0.data_ptr() == results[1].params["wq"][0].data_ptr()


@pytest.mark.parametrize("name,cut", [("tiny", 2), ("tiny2", 3),
                                      ("tiny-moe", 2)])
def test_uneven_partition_forward_and_decode(name, cut):
    """Even (2/2), UNEVEN (3/1) and MoE stage slices: the pod's greedy
    ids equal the JAX package's pod decode on the same dissemination and
    the port's single-process ``generate``; the pipelined forward holds
    to the JAX reference forward."""
    prompt = np.zeros((1, 8 if name == "tiny-moe" else 16), np.int64)
    max_new = 4 if name == "tiny-moe" else 6
    blobs = _seeded_blobs(name)
    jcfg, cfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    with two_stage_boots(JAX, jcfg, cut, blobs) as (jplace, jres, jstores):
        jtoks, _ = jpp.pod_decode(jcfg, jplace, jres, jstores,
                                  max_new=max_new,
                                  prompt=jnp.asarray(prompt, jnp.int32))
        jtoks = np.asarray(jtoks)
    with two_stage_boots(PORT, cfg, cut, blobs) as (placement, results,
                                                    stores):
        depths = [len(r.layer_ids) for r in results.values()]
        assert depths == [cut, cfg.n_layers - cut]
        if name != "tiny-moe":
            tokens = _tokens(cfg.vocab)
            logits, _ = tpp.pod_forward(cfg, placement, results, stores,
                                        torch.as_tensor(tokens))
            _assert_logits(logits, _jax_logits(name, tokens))
        toks, _ = tpp.pod_decode(cfg, placement, results, stores,
                                 max_new=max_new,
                                 prompt=torch.as_tensor(prompt))
        full = tserde.params_from_blobs(cfg, blobs)
        want = tgen.generate(full, torch.as_tensor(prompt), cfg,
                             max_new=max_new)
    np.testing.assert_array_equal(toks.numpy(), want.numpy())
    np.testing.assert_array_equal(toks.numpy(), jtoks)


def test_pod_forward_skips_non_partition():
    placement = tmesh.assignment_to_placement(
        {1: {0: ttypes.LayerMeta()}},
        tmesh.make_mesh((2, 4), ("pp", "tp"), ["cpu"] * 8), "pp")
    cfg = tllama.CONFIGS["tiny"]

    class R:
        kind = "full"
        params = {}
        layer_ids = list(range(cfg.n_layers))

    assert tpp.pod_forward(cfg, placement, {1: R()}, {1: {}}) is None
    # The multi-controller serve: a non-member enters nothing, and a
    # member whose store lacks the head blob cannot serve.
    assert tpp.spmd_pod_forward(cfg, placement, [1], 2, {}, {}) is None
    assert tpp.spmd_pod_decode(cfg, placement, [1], 2, {}, {},
                               max_new=2) is None
    with pytest.raises(RuntimeError, match="head blob"):
        tpp.spmd_pod_forward(cfg, placement, [1], 1, {}, {})
    with pytest.raises(RuntimeError, match="head blob"):
        tpp.spmd_pod_decode(cfg, placement, [1], 1, {}, {}, max_new=2)


def _pipeline_conf(name="tiny", codec=None):
    cfg = tllama.CONFIGS[name]
    head_id = tserde.head_blob_id(cfg)
    cut = cfg.n_layers // 2
    d = {
        "Model": name, "ModelSeed": SEED,
        "Nodes": [
            {"Id": 0, "Addr": "0", "IsLeader": True, "Sources": {"2": 0},
             "NetworkBW": 10**9,
             "InitialLayers": {"2": {str(b): {} for b in range(head_id + 1)}}},
            {"Id": 1, "Addr": "1", "Sources": {"2": 0}, "NetworkBW": 10**9,
             "InitialLayers": {}},
            {"Id": 2, "Addr": "2", "Sources": {"2": 0}, "NetworkBW": 10**9,
             "InitialLayers": {}},
        ],
        "Assignment": {
            "1": {str(b): {} for b in range(cut)},
            "2": {str(b): {} for b in range(cut, head_id + 1)},
        },
        "Mesh": {"AxisNames": ["nodes", "tp"], "AxisSizes": [4, 2],
                 "PipelineAxis": "nodes", "Fabric": True},
    }
    if codec:
        d["ModelCodec"] = codec
    return d


def test_podrun_pipeline_assignment_serves():
    """podrun end to end: the Assignment splits the model across two
    stages; after the stage boots the pod serves and decodes the JAX
    package's ids."""
    from distributed_llm_dissemination_tpu_torch.cli.podrun import run_pod

    conf = cfg_mod.Config.from_json(_pipeline_conf())
    summary = run_pod(conf, mode=3, timeout=120.0, gen=4, device="cpu")
    assert summary["boot_nodes"] == 2
    assert summary.get("pod_forward_s", 0) > 0
    jcfg = jllama.CONFIGS["tiny"]
    want = jgen.generate(jllama.init_params(jcfg, jax.random.key(SEED)),
                         jnp.zeros((1, 16), jnp.int32), jcfg, max_new=4)
    assert summary["tokens"] == [int(t) for t in np.asarray(want)[0]]


def test_moe_pod_decode_matches_single_process():
    """MoE pipeline serving generates: the expert-routed layers under the
    pod's KV-cached decode emit the single-process loop's ids."""
    name = "tiny-moe"
    cfg = tllama.CONFIGS[name]
    prompt = torch.zeros((1, 8), dtype=torch.long)
    with two_stage_boots(PORT, cfg, cfg.n_layers // 2,
                         _seeded_blobs(name)) as (placement, results,
                                                  stores):
        toks, _ = tpp.pod_decode(cfg, placement, results, stores, max_new=4,
                                 prompt=prompt)
    jcfg = jllama.CONFIGS[name]
    want = jgen.generate(jllama.init_params(jcfg, jax.random.key(SEED)),
                         jnp.zeros((1, 8), jnp.int32), jcfg, max_new=4)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_quantized_over_pod_fabric_boots(codec):
    """Codec x fabric: quantized blobs ride the device plane and the dest
    dequantizes on the device at boot (the dequant wrappers' plain
    versions on CPU tensors)."""
    from distributed_llm_dissemination_tpu_torch.cli.podrun import run_pod
    from distributed_llm_dissemination_tpu_torch.ops import dequant

    with open("conf/pod_fabric_4node.json") as f:
        d = json.load(f)
    cfg = tllama.CONFIGS["tiny"]
    blob_ids = [str(b) for b in range(tserde.head_blob_id(cfg) + 1)]
    d["Model"], d["ModelSeed"], d["ModelCodec"] = "tiny", SEED, codec
    d["Nodes"][0]["InitialLayers"] = {"2": {b: {} for b in blob_ids}}
    for n in d["Nodes"][1:]:
        n["InitialLayers"] = {}
    d["Assignment"] = {"3": {b: {} for b in blob_ids}}
    vias = []
    before = dequant.plain_calls.get(codec, 0)
    summary = run_pod(cfg_mod.Config.from_json(d), mode=3, timeout=120.0,
                      device="cpu",
                      on_delivered=lambda leader, receivers, placement:
                      vias.extend(r.boot_result.via for r in receivers
                                  if r.boot_result is not None))
    assert summary["fabric"] is True
    assert summary["ttd_s"] > 0
    assert summary.get("boot_nodes") == 1
    assert vias and all(codec in v or "streamed" in v for v in vias), vias
    assert dequant.plain_calls.get(codec, 0) > before


def test_hf_checkpoint_two_stage_pod_serve(tmp_path):
    """A Hugging Face checkpoint (``tests/test_hf.py``'s tiny Llama)
    disseminated across two stages: the pod's logits match
    ``transformers``, and its greedy ids are ``transformers``' ids."""
    from test_torch_hf import _hf_generate, _hf_logits
    from transformers import LlamaConfig, LlamaForCausalLM

    from distributed_llm_dissemination_tpu_torch.models import hf

    hcfg = LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(0)
    path = str(tmp_path / "tiny-llama")
    LlamaForCausalLM(hcfg).eval().save_pretrained(path)
    cfg = hf.config_from_dir(path)
    head_id = tserde.head_blob_id(cfg)
    nc = cfg_mod.NodeConf(
        id=0, addr="0",
        initial_layers={ttypes.SourceType.MEM: {b: 0 for b in
                                                range(head_id + 1)}},
        sources={ttypes.SourceType.MEM: 0})
    seed_layers = cfg_mod.create_layers(nc, save_disk=False,
                                        model="hf:" + path, device="cpu")
    blobs = {b: bytes(seed_layers[b].inmem_data) for b in seed_layers}
    with two_stage_boots(PORT, cfg, cfg.n_layers // 2, blobs) as (
            placement, results, stores):
        tokens = np.arange(32, dtype=np.int64).reshape(2, 16) % cfg.vocab
        assembled = tpp.assemble_pp_params(cfg, placement, results, stores)
        logits, _ = tpp.pod_forward(cfg, placement, results, stores,
                                    torch.as_tensor(tokens),
                                    assembled=assembled)
        np.testing.assert_allclose(logits.numpy(), _hf_logits(path, tokens),
                                   rtol=2e-3, atol=2e-3)
        prompt = np.array([[11, 42, 7, 199]], np.int64)
        toks, _ = tpp.pod_decode(cfg, placement, results, stores, max_new=6,
                                 prompt=torch.as_tensor(prompt),
                                 assembled=assembled)
        np.testing.assert_array_equal(toks.numpy(),
                                      _hf_generate(path, prompt, 6))


@pytest.mark.cuda
def test_pod_serve_on_the_card_runs_k1_only():
    """Phase 12's kernel path at tiny size: a two-stage pod of ``tiny`` on
    the card launches K1 for the pipelined forward, its prefill and every
    decode step, never the plain attention, and decodes the unstaged
    ``generate``'s ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from distributed_llm_dissemination_tpu_torch.models.sharded import (
        build_pp_decode, build_pp_forward)
    from distributed_llm_dissemination_tpu_torch.ops import (
        flash_attention as fa)

    cfg = tllama.CONFIGS["tiny"]
    params = tserde.params_from_blobs(cfg, _seeded_blobs("tiny"))
    params = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
                  else v.cuda()) for k, v in params.items()}
    mesh = tmesh.make_mesh((2,), ("pp",), ["cuda", "cuda"])
    layers = [tllama.layer_slice(params["layers"], i)
              for i in range(cfg.n_layers)]
    stages = [layers[:2], layers[2:]]
    head = {k: params[k] for k in ("embed", "ln_f", "lm_head")}
    prompt = torch.zeros((1, 16), dtype=torch.long, device="cuda")
    fa.reset_counts()
    build_pp_forward(cfg, mesh, "pp")(stages, [2, 2], head, prompt)
    ids = build_pp_decode(cfg, mesh, "pp", 4)(stages, [2, 2], head, prompt)
    L = cfg.n_layers
    assert fa.launches == 2 * L + 3 * L and fa.plain_calls == 0
    assert torch.equal(ids, tgen.generate(params, prompt, cfg, 4))
