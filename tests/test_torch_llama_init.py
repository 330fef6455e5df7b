"""Port parity: ``models/llama.py``'s init and loss surface.

- ``init_params(cfg, 0, "cpu")`` equals the JAX package's
  ``init_params(cfg, jax.random.key(0))`` byte for byte, leaf by leaf and
  in the same tree order, on ``tiny``, ``tiny-moe`` and ``tiny2``; so do
  ``model_keys`` + ``init_layer_params`` for one layer and
  ``init_head_params``.  A config that is not bf16 raises
  ``NotImplementedError`` (the draws are reproduced for bf16 only).
- ``loss_fn`` against the JAX ``loss_fn`` on the same params and tokens.
  Bounds, ``tests/test_torch_sharded.py``'s: within 1e-3 in f32 (the
  bf16 params widened to f32 in both packages), within 0.02 in bf16
  (``tests/test_torch_model.py``'s mean logit bound: the two frameworks
  round bf16 matmuls at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import prng
from distributed_llm_dissemination_tpu_torch.models import serde as tserde

CONFIG_NAMES = ["tiny", "tiny-moe", "tiny2"]
F32_LOSS_TOL = 1e-3
BF16_LOSS_TOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = jllama.init_params(jllama.CONFIGS[name],
                                             jax.random.key(0))
        return cache[name]

    return get


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_same_tree(port, jax_tree):
    got, want = dict(_flat(port)), dict(_flat(jax_tree))
    assert list(got) == list(want)
    for path in got:
        assert tuple(got[path].shape) == tuple(want[path].shape), path
        assert got[path].dtype == torch.bfloat16, path
        assert _bytes(got[path]) == _bytes(want[path]), path


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_init_params_equals_jax_byte_for_byte(name, jax_params):
    params = tllama.init_params(tllama.CONFIGS[name], 0, "cpu")
    _assert_same_tree(params, jax_params(name))


def test_model_keys_layer_and_head_init_equal_jax():
    jcfg, tcfg = jllama.CONFIGS["tiny-moe"], tllama.CONFIGS["tiny-moe"]
    jk_emb, jlayers, jk_out = jllama.model_keys(jcfg, jax.random.key(3))
    k_emb, layers, k_out = tllama.model_keys(tcfg, prng.seed_key(3))
    assert len(layers) == len(jlayers) == tcfg.n_layers
    _assert_same_tree(tllama.init_layer_params(tcfg, layers[2], "cpu"),
                      jllama.init_layer_params(jcfg, jlayers[2]))
    _assert_same_tree(tllama.init_head_params(tcfg, k_emb, k_out, "cpu"),
                      jllama.init_head_params(jcfg, jk_emb, jk_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_non_bf16_config_raises(dtype):
    cfg = dataclasses.replace(tllama.CONFIGS["tiny"], dtype=dtype)
    with pytest.raises(NotImplementedError):
        tllama.init_params(cfg, 0, "cpu")
    for name in ("wq", "ln1"):  # a drawn leaf and a norm alike
        with pytest.raises(NotImplementedError):
            tserde.seeded_leaf(cfg, 0, name, 0, "cpu")


@pytest.mark.parametrize("name", CONFIG_NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_matches_jax(name, dtype, jax_params):
    jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    params = tllama.init_params(tcfg, 0, "cpu")
    jparams = jax_params(name)
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
        jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                         jparams)
        params = {k: ({n: t.float() for n, t in v.items()}
                      if isinstance(v, dict) else v.float())
                  for k, v in params.items()}
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab, (2, 17))
    got = float(tllama.loss_fn(params, torch.as_tensor(tokens), tcfg))
    want = float(jllama.loss_fn(jparams, jnp.asarray(tokens, jnp.int32),
                                jcfg))
    tol = F32_LOSS_TOL if dtype == "float32" else BF16_LOSS_TOL
    assert np.isfinite(got) and abs(got - want) < tol, (got, want)
