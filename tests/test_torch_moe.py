"""Port parity of the MoE FFN (``models/llama.py``: ``route_topk``,
``moe_ffn``) on ``tiny-moe``, with the JAX package as the oracle.

Tolerances:

- ``route_topk`` keeps ties: the set of surviving experts equals JAX's
  exactly, and the renormalised weights agree to ``1e-6`` (one f32 sum
  in another order).
- ``moe_ffn`` on the same input: f32 to ``1e-5`` (measured ``1.1e-6``
  against outputs up to ~4.8); bf16 to ``2**-5``, one bf16 rounding of
  the residual sum at values up to 4, as the dense FFN test states
  (measured ``2**-6``).
- full-forward logits: f32 to ``1e-4`` (measured ``3.6e-6``).  In bf16
  the routing is discontinuous: the layers' hidden states differ by bf16
  roundings, and where two routing weights of a token are nearly equal at
  the k-th place, two evaluations may keep different experts (bf16
  router logits tie exactly often, and then three experts are kept).
  Such a token's logits move by up to ~1.8, and attention carries the
  change to every later position.  The JAX package differs from itself
  this way: its scanned ``forward`` and the same layers run one by one
  differ by up to 1.08 on these inputs.  So the bf16 logits are held
  against the JAX layers run one by one, to ``tests/test_torch_model.py``'s
  tolerance (max 0.1, mean 0.02; measured max 0.051-0.060, mean ~0.009),
  at every position before the first one that the two route differently
  in some layer; those positions must be at least half of all, and the
  two must route at least 95% of (layer, token) pairs alike.
- greedy ids: as ``tests/test_torch_model.py`` (equal up to the first
  logit near-tie of the JAX model); f32 ``generate`` equals the argmax of
  the full forward exactly, as ``tests/test_generate.py`` holds for JAX.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.models import generate as jgen
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import quant as jquant
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu.runtime import boot as jboot
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.models import generate as tgen
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import quant as tquant
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.ops import flash_attention
from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
    assignment_to_placement,
)
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode as TLeader,
    FlowRetransmitReceiverNode as TReceiver,
    Node as TNode,
)
from distributed_llm_dissemination_tpu_torch.runtime import boot as tboot
from distributed_llm_dissemination_tpu_torch.runtime.client import (
    GenRequester,
)
from distributed_llm_dissemination_tpu_torch.transport.inmem import (
    reset_registry,
)
from distributed_llm_dissemination_tpu_torch.utils import telemetry, trace

from test_torch_dissemination import NIC, _close, _drive, _holdings, _transports
from test_torch_model import (
    LOGIT_ATOL,
    LOGIT_MEAN_ATOL,
    _to_torch,
    assert_greedy_agrees,
)

NAME = "tiny-moe"
TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    reset_registry()


def _cfgs(dtype_name="bfloat16"):
    jcfg, tcfg = jllama.CONFIGS[NAME], tllama.CONFIGS[NAME]
    if dtype_name == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _models(dtype_name="bfloat16", seed=0):
    jcfg, tcfg = _cfgs(dtype_name)
    jparams = jllama.init_params(jcfg, jax.random.key(seed))
    blobs = jserde.blobs_from_params(jcfg, jparams)
    return jcfg, tcfg, jparams, tserde.params_from_blobs(tcfg, blobs)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _route_case(kind):
    """(routing weights [2, 3, e], ModelConfig of e experts and top_k)."""
    rng = np.random.default_rng(0)
    w = rng.random((2, 3, 4)).astype(np.float32)
    top_k = 2
    if kind == "ties":
        # More than k weights survive: three-way and four-way ties at the
        # k-th place, and a tie above it.
        w[0, 0] = [0.3, 0.3, 0.3, 0.1]
        w[0, 1] = [0.25, 0.25, 0.25, 0.25]
        w[0, 2] = [0.4, 0.4, 0.1, 0.1]
        w[1, 0] = [0.1, 0.5, 0.2, 0.2]
    elif kind == "top1":
        top_k = 1
        w[1, 1] = [0.7, 0.7, 0.1, 0.0]
    elif kind == "top_k_equals_experts":
        top_k = 4
    elif kind == "top_k_above_experts":
        top_k = 5
    w /= w.sum(-1, keepdims=True)
    return w, dict(n_experts=4, top_k=top_k)


@pytest.mark.parametrize("kind", ["random", "ties", "top1",
                                  "top_k_equals_experts",
                                  "top_k_above_experts"])
def test_route_topk_matches_jax(kind):
    w, fields = _route_case(kind)
    jcfg = dataclasses.replace(jllama.CONFIGS[NAME], **fields)
    tcfg = dataclasses.replace(tllama.CONFIGS[NAME], **fields)
    want = np.asarray(jllama.route_topk(jnp.asarray(w), jcfg))
    got = tllama.route_topk(torch.from_numpy(w), tcfg).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if fields["top_k"] >= fields["n_experts"]:
        np.testing.assert_array_equal(got, w)  # untouched
    if kind == "ties":
        assert (got[0, 0] > 0).sum() == 3 and (got[0, 1] > 0).sum() == 4
        assert (got[1, 0] > 0).sum() == 3


@pytest.mark.parametrize("dtype_name,atol", [("float32", 1e-5),
                                             ("bfloat16", 2 ** -5)])
def test_moe_ffn_matches_jax(dtype_name, atol):
    jcfg, tcfg, jparams, tparams = _models(dtype_name, seed=1)
    x = np.random.default_rng(1).standard_normal((2, 8, jcfg.d_model))
    jx = jnp.asarray(x, jcfg.dtype)
    for i in range(jcfg.n_layers):
        jp = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])
        tp = tllama.layer_slice(tparams["layers"], i)
        want = _f32(jllama.moe_ffn(jp, jx, jcfg))
        got = _f32(tllama.moe_ffn(tp, _to_torch(jx), tcfg))
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=f"layer {i}")
        # ffn dispatches MoE configs to moe_ffn.
        assert torch.equal(tllama.ffn(tp, _to_torch(jx), tcfg),
                           tllama.moe_ffn(tp, _to_torch(jx), tcfg))


def _jax_layers(jcfg, jparams, tokens):
    """The JAX package's layers run one by one: (f32 logits, routing masks
    [n_layers, b, s, e] of the experts each token keeps)."""
    positions = jnp.arange(tokens.shape[1])
    x = jparams["embed"][jnp.asarray(tokens)]
    masks = []
    for i in range(jcfg.n_layers):
        p = jax.tree_util.tree_map(lambda a: a[i], jparams["layers"])
        x = jllama.attention_block(p, x, positions, jcfg)
        xn = jllama.rms_norm(x, p["ln2"], jcfg.norm_eps)
        logits = jnp.einsum("bsd,de->bse", xn, p["router"])
        w = jllama.route_topk(
            jax.nn.softmax(logits.astype(jnp.float32), axis=-1), jcfg)
        masks.append(np.asarray(w) > 0)
        x = jllama.moe_ffn(p, x, jcfg)
    x = jllama.rms_norm(x, jparams["ln_f"], jcfg.norm_eps)
    logits = jnp.einsum("bsd,dv->bsv", x, jparams["lm_head"],
                        preferred_element_type=jnp.float32)
    return np.asarray(logits), np.stack(masks)


def _port_masks(tcfg, tparams, tokens):
    """The port's routing masks, as ``_jax_layers`` gives JAX's."""
    x = tparams["embed"][torch.from_numpy(tokens).long()]
    masks = []
    for i in range(tcfg.n_layers):
        p = tllama.layer_slice(tparams["layers"], i)
        x = tllama.attention_block(p, x, tcfg)
        xn = tllama.rms_norm(x, p["ln2"], tcfg.norm_eps)
        w = tllama.route_topk(torch.softmax((xn @ p["router"]).float(), -1),
                              tcfg)
        masks.append((w > 0).numpy())
        x = tllama.moe_ffn(p, x, tcfg)
    return np.stack(masks)


def test_forward_logits_match_jax_in_f32():
    jcfg, tcfg, jparams, tparams = _models("float32")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 24))
    want = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    got = tllama.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_logits_match_jax_in_bf16_before_a_routing_flip(seed):
    jcfg, tcfg, jparams, tparams = _models("bfloat16", seed=seed)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (8, 24))
    got = tllama.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32 and got.shape == (8, 24, jcfg.vocab)
    assert bool(torch.isfinite(got).all())
    want, jmasks = _jax_layers(jcfg, jparams, toks)
    routed_alike = (jmasks == _port_masks(tcfg, tparams, toks)).all(-1)
    assert routed_alike.mean() >= 0.95, routed_alike.mean()
    flips = ~routed_alike.all(0)  # [b, s]: some layer routes differently
    errs = []
    for b in range(toks.shape[0]):
        upto = int(np.argmax(flips[b])) if flips[b].any() else toks.shape[1]
        errs.append(np.abs(got[b, :upto].numpy() - want[b, :upto]).reshape(-1))
    err = np.concatenate(errs)
    assert err.size >= toks.size * jcfg.vocab // 2, "too few positions held"
    assert err.max() < LOGIT_ATOL, err.max()
    assert err.mean() < LOGIT_MEAN_ATOL, err.mean()


def test_greedy_generate_equals_full_forward_argmax():
    """The cached layer dispatches to the same ``moe_ffn`` as the full
    forward, so MoE serves exactly (``tests/test_generate.py``)."""
    _, tcfg, _, tparams = _models("float32", seed=2)
    prompt = torch.tensor([[5, 4, 3, 2]])
    got = tgen.generate(tparams, prompt, tcfg, max_new=6)
    toks = prompt
    for _ in range(6):
        logits = tllama.forward(tparams, toks, tcfg)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    assert torch.equal(got, toks[:, 4:])


def test_greedy_ids_match_jax_up_to_near_tie():
    jcfg, tcfg, jparams, tparams = _models("bfloat16", seed=3)
    prompt = np.random.default_rng(4).integers(0, jcfg.vocab, (1, 8))
    prompt = prompt.astype(np.int32)
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg, 12))
    got = tgen.generate(tparams, torch.from_numpy(prompt).long(), tcfg, 12)
    assert_greedy_agrees(got.numpy(), want, prompt, jcfg, jparams)


@pytest.fixture(scope="module")
def seeded():
    """(jcfg, tcfg, raw blobs) of the JAX ``seeded_blob``."""
    jcfg = jllama.CONFIGS[NAME]
    blobs = {lid: jserde.seeded_blob(jcfg, lid, 0)
             for lid in range(jserde.head_blob_id(jcfg) + 1)}
    return jcfg, tllama.CONFIGS[NAME], blobs


def test_int8_expert_leaves_decode_like_jax(seeded):
    """The rank-3 expert leaves ([e, d, f]) through the plain K2, bit for
    bit against the JAX host decode."""
    jcfg, tcfg, blobs = seeded
    enc = tquant.encode_blob(tcfg, 0, blobs[0], "int8")
    assert enc == jquant.encode_blob(jcfg, 0, blobs[0], "int8")
    got = tquant.decode_blob_host(tcfg, 0, enc, "int8")
    want = jquant.decode_blob_host(jcfg, 0, enc, "int8")
    for name in ("router", "w1", "w3", "w2"):
        assert got[name].dim() == (2 if name == "router" else 3)
        np.testing.assert_array_equal(
            got[name].view(torch.int16).numpy(),
            np.asarray(want[name]).view(np.int16), err_msg=name)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_seeded_round_boots_and_serves_like_jax(codec, seeded):
    """A mode-3 round of the port delivers seeded ``tiny-moe`` blobs (raw
    or int8 wire forms) to a dest that stages them on the CPU, boots
    through ``moe_ffn`` and answers a request with JAX's greedy ids."""
    jcfg, tcfg, raw = seeded
    blobs = {lid: (raw[lid] if codec == "raw" else
                   jquant.encode_blob(jcfg, lid, raw[lid], codec))
             for lid in raw}
    ids = sorted(blobs)
    assignment = {2: {lid: ttypes.LayerMeta() for lid in ids}}
    placement = assignment_to_placement(assignment, ["cpu"])
    ts = _transports({i: "inmem" for i in range(4)})
    leader = TLeader(TNode(0, 0, ts[0]), _holdings(ttypes, blobs),
                     assignment, NIC, expected_nodes={1, 2})
    seeder = TReceiver(TNode(1, 0, ts[1]), _holdings(ttypes, blobs))
    dest = TReceiver(TNode(2, 0, ts[2]), {}, stage_hbm=True,
                     placement=placement, boot_cfg=tcfg, boot_codec=codec)
    requester = GenRequester(ts[3], my_id=3)
    try:
        _drive(leader, [seeder, dest])
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {2}
        counters = trace.counter_totals()
        assert counters.get("hbm_staged.incremental_ingest") == len(ids)
        res = dest.boot_result
        assert res.kind == "full" and res.via == "streamed per-layer"
        jres = jboot.boot_from_layers(jcfg, _holdings(jtypes, blobs),
                                      codec=codec)
        for name, _ in tserde.layer_param_specs(tcfg):
            np.testing.assert_array_equal(
                torch.stack(res.params["layers"][name]).view(
                    torch.int16).numpy(),
                np.asarray(jres.params["layers"][name]).view(np.int16),
                err_msg=name)
        err = np.abs(res.logits.float().numpy() - np.asarray(jres.logits))
        assert err.max() < LOGIT_ATOL, err.max()
        assert err.mean() < LOGIT_MEAN_ATOL, err.mean()

        prompt = np.random.default_rng(5).integers(
            0, jcfg.vocab, (1, 12)).astype(np.int32)
        got = requester.request(2, prompt[0].tolist(), 8, timeout=TIMEOUT)
        want = jgen.generate(jres.params, jnp.asarray(prompt), jcfg, 8)
        assert len(got) == 8
        assert_greedy_agrees(np.asarray([got]), np.asarray(want), prompt,
                             jcfg, jres.params)
    finally:
        requester.close()
        _close([leader, seeder, dest], ts)


def test_precompile_boot_warms_a_moe_boot_on_the_cpu(seeded):
    _, tcfg, blobs = seeded
    rec = tboot.precompile_boot(tcfg, sorted(blobs), device="cpu",
                                codec="int8")
    assert rec["launches"] == {}
    assert rec["compiled"][0] == "dequant:int8"
    assert f"attention:prefill:sq={tboot.BOOT_TOKENS}:hd=32" in \
        rec["compiled"]


def _wobbled_attention(rel):
    """The plain attention with its ``pv`` scaled by ``1 + rel * sin(i)``:
    ``rel`` 3e-3 moves the logits by about what K1's roundings do on the
    card (0.03-0.05), and routes a few tokens to other experts."""
    def attention(qg, k, v, q_off, k_off):
        pv, m, l = flash_attention.block_attention_ref(qg, k, v, q_off, k_off)
        wobble = torch.sin(torch.arange(pv.numel(), dtype=torch.float32))
        return pv * (1 + rel * wobble.reshape(pv.shape)), m, l
    return attention


@pytest.mark.parametrize("rel,holds", [(0.0, True), (3e-3, True),
                                       (0.1, False)])
def test_chip_smoke_moe_parity_holds_the_attention(rel, holds):
    """``chip_smoke.py``'s MoE parity on the CPU, the wobbled attention
    standing in for the plain one: under one routing an attention off by
    roundings passes at every prompt position and decode step, and one
    off by 10% fails."""
    import chip_smoke

    _, tcfg, _, tparams = _models("bfloat16")
    prompt = torch.from_numpy(
        np.random.default_rng(5).integers(0, tcfg.vocab, (1, 64)))
    served = tgen.generate(tparams, prompt, tcfg, 16)[0].tolist()
    fa = SimpleNamespace(block_attention_ref=_wobbled_attention(rel))
    if not holds:
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            chip_smoke.moe_parity(fa, tcfg, tparams, prompt, served)
        return
    rec = chip_smoke.moe_parity(fa, tcfg, tparams, prompt, served)
    assert rec["decode_steps"] == 16
    assert rec["routed_alike"] >= chip_smoke.ROUTED_ALIKE
    assert rec["cpu_max_abs_err"] == 0.0  # the card is the CPU here
    if rel:
        # Routing differs somewhere, so the replay is what holds the rest.
        assert rec["routed_alike"] < 1.0
        assert 0 < rec["max_abs_logit_diff"] <= 0.02 * rec["largest_logit"]
    else:
        assert rec["ids_equal"] and rec["max_abs_step_logit_diff"] == 0.0
