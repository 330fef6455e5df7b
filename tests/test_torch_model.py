"""Port parity: the Llama forward and the KV-cached serving loop.

The port and the JAX package run the same blobs (made by the JAX
package's ``init_params``) on the same numpy-made tokens.

Logit tolerance: ``LOGIT_ATOL = 0.1`` on the max difference and 0.02 on
the mean.  Both models keep hidden states in bf16, and the two frameworks
round at different places: matmul accumulation order flips bf16
roundings of layer outputs, and JAX casts the attention probabilities to
bf16 before the PV product while the port's kernel keeps them in f32.
Measured on ``tiny``/``tiny2`` over three seeds: max 0.05-0.072, mean
~0.01, of logits up to ~4.5; with JAX-style bf16 probabilities the max
is still ~0.05, so most of the gap is the bf16 matmul roundings.  Parts
without a bf16 matmul (``rms_norm``, ``rope``) are bit-identical.

Greedy ids must agree up to the first near-tie: the first step where
they differ must be one where the JAX model's top-1/top-2 logit margin
is below ``LOGIT_ATOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import generate as jgen
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu_torch.models import generate as tgen
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.ops import flash_attention as tfa

LOGIT_ATOL = 0.1
LOGIT_MEAN_ATOL = 0.02
CONFIG_NAMES = ["tiny", "tiny2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; under a parallel
    test run extra threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(name, seed=0):
    jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    blobs = jserde.blobs_from_params(jcfg, jparams)
    return jcfg, tcfg, jparams, tserde.params_from_blobs(tcfg, blobs)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _jax_margin(jcfg, jparams, ids):
    """The JAX model's top-1 minus top-2 logit after ``ids`` [1, n]."""
    lg = np.asarray(jllama.forward(jparams, jnp.asarray(ids), jcfg))[0, -1]
    top = np.sort(lg)[-2:]
    return float(top[1] - top[0])


def assert_greedy_agrees(port_ids, jax_ids, prompt, jcfg, jparams):
    port_ids, jax_ids = np.asarray(port_ids), np.asarray(jax_ids)
    diff = np.nonzero(port_ids[0] != jax_ids[0])[0]
    if diff.size == 0:
        return
    i = int(diff[0])
    ids = np.concatenate([prompt, jax_ids[:, :i]], axis=1)
    margin = _jax_margin(jcfg, jparams, ids)
    assert margin < LOGIT_ATOL, (
        f"greedy ids diverge at step {i} where the JAX margin {margin:.4f} "
        f"is not a near-tie: port {port_ids[0].tolist()} vs JAX "
        f"{jax_ids[0].tolist()}")


def test_rms_norm_and_rope_bit_identical():
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((2, 24, 128)))
    w = _bf16(1 + 0.1 * rng.standard_normal(128))
    np.testing.assert_array_equal(
        _f32(tllama.rms_norm(_to_torch(x), _to_torch(w), 1e-5)),
        _f32(jllama.rms_norm(x, w, 1e-5)))
    xh = _bf16(rng.standard_normal((2, 24, 4, 32)))
    pos = np.arange(5, 29)
    np.testing.assert_array_equal(
        _f32(tllama.rope(_to_torch(xh), torch.from_numpy(pos), 5e5)),
        _f32(jllama.rope(xh, jnp.asarray(pos), 5e5)))


def test_dense_ffn_matches_jax_to_a_bf16_ulp():
    jcfg, tcfg, jparams, tparams = _models("tiny")
    x = _bf16(np.random.default_rng(1).standard_normal((2, 8, 128)))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    tp = tllama.layer_slice(tparams["layers"], 0)
    got = _f32(tllama.dense_ffn(tp, _to_torch(x), tcfg))
    want = _f32(jllama.dense_ffn(jp, x, jcfg))
    # One bf16 rounding of the residual sum (values up to ~4: ulp 2^-6).
    np.testing.assert_allclose(got, want, atol=2 ** -5, rtol=0)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_forward_logits_match_jax(name):
    jcfg, tcfg, jparams, tparams = _models(name)
    toks = _tokens(jcfg.vocab, (2, 24))
    want = np.asarray(jllama.forward(jparams, jnp.asarray(toks), jcfg))
    got = tllama.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want)
    assert err.max() < LOGIT_ATOL, err.max()
    assert err.mean() < LOGIT_MEAN_ATOL, err.mean()


def test_forward_attention_argument_selects_plain_version():
    _, tcfg, _, tparams = _models("tiny")
    toks = torch.from_numpy(_tokens(tcfg.vocab, (1, 12))).long()
    assert torch.equal(
        tllama.forward(tparams, toks, tcfg),
        tllama.forward(tparams, toks, tcfg,
                       attention=tfa.block_attention_ref))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_layer_with_cache_matches_jax(name):
    jcfg, tcfg, jparams, tparams = _models(name, seed=1)
    rng = np.random.default_rng(2)
    max_len, s = 16, 8
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    tp = tllama.layer_slice(tparams["layers"], 0)
    jk = jnp.zeros((1, max_len, jcfg.n_kv_heads, jcfg.head_dim), jnp.bfloat16)
    jv = jk
    tk = torch.zeros((1, tcfg.n_kv_heads, max_len, tcfg.head_dim),
                     dtype=torch.bfloat16)
    tv = tk.clone()
    # Prefill at 0, then one decode row at s.
    for start, n in ((0, s), (s, 1)):
        x = _bf16(rng.standard_normal((1, n, jcfg.d_model)))
        jx, jk, jv = jgen._layer_with_cache(
            jp, x, jnp.arange(start, start + n), jk, jv, jcfg)
        tx, tk, tv = tgen._layer_with_cache(tp, _to_torch(x), start, tk, tv,
                                            tcfg)
        # Residual stream |x| < 4 here: 2^-4 is four bf16 ulps at [2, 4).
        np.testing.assert_allclose(_f32(tx), _f32(jx), atol=2 ** -4, rtol=0)
        # The port keeps the cache heads-major: [b, kvh, max_len, hd].
        for t_c, j_c in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(_f32(t_c.transpose(1, 2)), _f32(j_c),
                                       atol=2 ** -6, rtol=2 ** -7)
    assert torch.all(tk[:, :, s + 1:] == 0)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_greedy_ids_match_jax_up_to_near_tie(name):
    jcfg, tcfg, jparams, tparams = _models(name, seed=3)
    prompt = _tokens(jcfg.vocab, (1, 8), seed=4)
    want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg, 12))
    got = tgen.generate(tparams, torch.from_numpy(prompt).long(), tcfg, 12)
    assert tuple(got.shape) == (1, 12)
    assert_greedy_agrees(got.numpy(), want, prompt, jcfg, jparams)
    step = tgen.generate_stepwise(lambda: (tparams, "v1"),
                                  torch.from_numpy(prompt).long(), tcfg, 12)
    assert torch.equal(step, got)


def test_prefill_logits_equal_cacheless_forward():
    _, tcfg, _, tparams = _models("tiny")
    toks = torch.from_numpy(_tokens(tcfg.vocab, (2, 10))).long()
    cache = tgen.init_cache(tcfg, 2, 16, device="cpu")
    logits, _ = tgen._forward_with_cache(tparams, toks, 0, cache, tcfg)
    full = tllama.forward(tparams, toks, tcfg)[:, -1]
    torch.testing.assert_close(logits, full, rtol=0, atol=1e-5)


def test_sampling_is_deterministic_per_generator():
    _, tcfg, _, tparams = _models("tiny")
    prompt = torch.from_numpy(_tokens(tcfg.vocab, (1, 4))).long()

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return tgen.generate(tparams, prompt, tcfg, 6, temperature=1.0,
                             generator=gen)

    assert torch.equal(run(1), run(1))
    with pytest.raises(ValueError, match="Generator"):
        tgen.generate(tparams, prompt, tcfg, 4, temperature=1.0)
    with pytest.raises(ValueError, match="positive"):
        tgen.generate(tparams, prompt, tcfg, 0)


@pytest.mark.parametrize("versions,expected", [
    ({}, ""), ({0: "v1", 1: "v1"}, ""), ({0: "v1", 1: "v1"}, "v1"),
    ({0: "v1", 1: "v2"}, ""), ({0: "v1"}, "v2"), ({0: ""}, ""),
])
def test_ensure_uniform_version_matches_jax(versions, expected):
    def outcome(fn, exc):
        try:
            return fn(versions, expected)
        except exc as e:
            return ("raised", str(e))

    assert (outcome(tgen.ensure_uniform_version, tgen.MixedVersionError)
            == outcome(jgen.ensure_uniform_version, jgen.MixedVersionError))


def test_moe_is_not_ported_yet():
    cfg = tllama.CONFIGS["tiny-moe"]
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.ffn({}, torch.zeros(1, 1, cfg.d_model, dtype=cfg.dtype), cfg)
