"""Port parity: ring attention (``parallel/ring_attention.py``) against the
JAX package's ``ring_attention`` under ``shard_map``.

The same numpy-made q, k, v and output cotangent go through both; the
output and dq, dk, dv are compared over the whole sequence.  JAX runs on
the test process's virtual CPU devices, once with the lax block oracle
and once with the Pallas kernel in interpret mode, as
``tests/test_flash_attention.py`` runs them.  The port runs in one
process for sp = 1 and in sp ``gloo`` processes for sp = 2 and 4
(``torch_dist_worker.spawn_world``: a FileStore rendezvous under the
test's tmp_path, no ports), on the CPU, where each ring step takes
``block_attention``'s plain version.

Tolerances are the JAX tests' own: 5e-4 between two ring
implementations (JAX's bound for the Pallas ring against the lax ring),
2e-3 against a dense causal oracle and its autodiff gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distributed_llm_dissemination_tpu.ops import flash_attention as jfa
from distributed_llm_dissemination_tpu.parallel.compat import shard_map
from distributed_llm_dissemination_tpu.parallel.ring_attention import (
    ring_attention as jring,
)
from distributed_llm_dissemination_tpu_torch.ops import flash_attention as tfa
from distributed_llm_dissemination_tpu_torch.parallel import axes
from distributed_llm_dissemination_tpu_torch.parallel.mesh import make_mesh
from distributed_llm_dissemination_tpu_torch.parallel.ring_attention import (
    ring_attention as tring,
)

from torch_dist_worker import spawn_world

S_LOCAL, HD = 128, 128
RING_TOL = 5e-4   # tests/test_flash_attention.py: Pallas ring vs lax ring
DENSE_TOL = 2e-3  # tests/test_flash_attention.py: ring vs dense autodiff


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, kvh, h, seed):
    rng = np.random.default_rng(seed)
    s = n * S_LOCAL
    return {"q": rng.standard_normal((1, s, h, HD)).astype(np.float32),
            "k": rng.standard_normal((1, s, kvh, HD)).astype(np.float32),
            "v": rng.standard_normal((1, s, kvh, HD)).astype(np.float32),
            "dout": rng.standard_normal((1, s, h, HD)).astype(np.float32)}


def _jax_ring(x, n, pallas):
    """JAX's ring under shard_map on n virtual devices: out, dq, dk, dv."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    f = shard_map(functools.partial(jring, axis="sp", s_local=S_LOCAL),
                  mesh=mesh,
                  in_specs=(P(None, "sp"), P(None, "sp"), P(None, "sp")),
                  out_specs=P(None, "sp"), check_vma=False)
    prev = jfa.FORCE_PALLAS
    jfa.FORCE_PALLAS = pallas
    try:
        out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x[n_]) for n_ in "qkv"))
        grads = vjp(jnp.asarray(x["dout"]))
    finally:
        jfa.FORCE_PALLAS = prev
    return [np.asarray(a) for a in (out, *grads)]


def _dense(x):
    """Dense causal GQA over the whole sequence and its autodiff grads."""
    def attend(q, k, v):
        b, s, h, hd = q.shape
        kvh = k.shape[2]
        qg = q.reshape(b, s, kvh, h // kvh, hd)
        logits = jnp.einsum("bskgh,btkh->bkgst", qg, k) / np.sqrt(hd)
        mask = jnp.arange(s)[:, None] >= jnp.arange(s)[None, :]
        p = jax.nn.softmax(jnp.where(mask, logits, -1e30), axis=-1)
        out = jnp.einsum("bkgst,btkh->bkgsh", p, v)
        return out.transpose(0, 3, 1, 2, 4).reshape(b, s, h, hd)

    out, vjp = jax.vjp(attend, *(jnp.asarray(x[n_]) for n_ in "qkv"))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(x["dout"])))]


def _port_one_rank(x):
    mesh = make_mesh([1], ["sp"])
    q, k, v = (torch.from_numpy(x[n].copy()).requires_grad_() for n in "qkv")
    with axes.manual(mesh):
        out = tring(q, k, v, "sp", S_LOCAL)
        out.backward(torch.from_numpy(x["dout"]))
    return [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
            v.grad.numpy()]


def _port_ranks(tmp_path, x, n):
    ranks = spawn_world(tmp_path, n, {"kind": "ring"}, x)
    assert [int(r["coord/sp"]) for r in ranks] == list(range(n))
    return [np.concatenate([r[key] for r in ranks], axis=1)
            for key in ("out", "dq", "dk", "dv")]


def _assert_all_close(got, want, tol, what):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (what, name)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what}: {name}")


def _check(got, x, n):
    _assert_all_close(got, _jax_ring(x, n, pallas=False), RING_TOL,
                      "vs the JAX ring (lax)")
    _assert_all_close(got, _jax_ring(x, n, pallas=True), RING_TOL,
                      "vs the JAX ring (Pallas interpret)")
    _assert_all_close(got, _dense(x), DENSE_TOL, "vs dense autodiff")


@pytest.mark.parametrize("kvh,h", [(2, 2), (2, 4)])
def test_one_rank_ring_matches_jax(kvh, h):
    x = _inputs(1, kvh, h, seed=h)
    before = tfa.plain_calls
    got = _port_one_rank(x)
    assert tfa.plain_calls == before + 1  # one block, the plain version
    _check(got, x, 1)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("n,kvh,h", [(2, 2, 2), (4, 2, 4)])
def test_gloo_ring_matches_jax(tmp_path, n, kvh, h):
    x = _inputs(n, kvh, h, seed=10 + n)
    _check(_port_ranks(tmp_path, x, n), x, n)


def test_ring_outside_a_manual_program_raises():
    x = _inputs(1, 2, 2, seed=0)
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    with pytest.raises(RuntimeError, match="manual"):
        tring(q, k, v, "sp", S_LOCAL)


def test_ring_attention_argument_selects_the_block_function():
    """``attention`` replaces ``block_attention`` in every ring step (the
    card holds K1 against the plain ring this way)."""
    x = _inputs(1, 2, 4, seed=3)
    calls = []

    def spy(*args):
        calls.append(args[3:])
        return tfa.block_attention_ref(*args)

    mesh = make_mesh([1], ["sp"])
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    with axes.manual(mesh):
        got = tring(q, k, v, "sp", S_LOCAL, attention=spy)
        want = tring(q, k, v, "sp", S_LOCAL)
    assert calls == [(0, 0)]
    assert torch.equal(got, want)
