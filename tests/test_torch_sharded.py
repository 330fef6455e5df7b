"""Port parity: the 5-axis training step (``models/sharded.py``) against
the JAX package's, from the same params (``init_params``, key 0) and the
same tokens (``example_batch``: numpy ``default_rng(0)``).

JAX runs on the test process's virtual CPU devices; the port runs in one
process for a world of 1 and in ``gloo`` processes for larger worlds
(``torch_dist_worker.spawn_world``, a FileStore rendezvous, no ports), on
the CPU.

Tolerances are the JAX tests' own (``tests/test_models.py``): the loss
within 1e-3 on ``tiny`` and 2e-2 on ``tiny-moe``; gradients (and SGD
updates) within 1e-4 of the largest reference value, leaf by leaf, in
f32; AdamW params within 1e-4 of the largest, with eps 1e-3 as JAX's
AdamW test uses (with a first-step eps of 1e-8 the update is ~sign(g)
and reduction-order noise flips signs).  Gradients and updates are
compared in f32 configurations, as JAX's gradient tests do.  In bf16 the
two frameworks round at different places (``tests/test_torch_model.py``:
logits within 0.1, mean 0.02; measured loss gap 0.004 on ``tiny``), so
the bf16 loss is held to that file's mean bound, 0.02.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import sharded as jsh
from distributed_llm_dissemination_tpu.parallel.mesh import make_mesh as jmake_mesh
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.models import sharded as tsh
from distributed_llm_dissemination_tpu_torch.ops import flash_attention as tfa
from distributed_llm_dissemination_tpu_torch.parallel.mesh import make_mesh

from torch_dist_worker import spawn_world

LOSS_TOL = {"tiny": 1e-3, "tiny-moe": 2e-2}  # tests/test_models.py:55
GRAD_REL = 1e-4   # tests/test_models.py: sharded gradients, AdamW
BF16_LOSS_TOL = 0.02  # tests/test_torch_model.py: LOGIT_MEAN_ATOL
ADAM_EPS = 1e-3
SGD_LR = 1.0    # tests/test_models.py's gradient test: (old - new) / lr
ADAM_LR = 1e-2  # tests/test_models.py's AdamW test


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name, f32=True):
    jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _np_params(jcfg):
    return jax.tree.map(np.asarray, jllama.init_params(jcfg,
                                                       jax.random.key(0)))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want, scale):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max()) / (scale + 1e-30)


def _jax_run(jcfg, sizes, np_params):
    """JAX's loss, gradients (of the unsharded loss), SGD step and AdamW
    step on a mesh of ``sizes``, all as full numpy arrays."""
    n = int(np.prod(list(sizes.values())))
    mesh = jmake_mesh([sizes[a] for a in jsh.AXES], jsh.AXES,
                      jax.devices()[:n])
    inputs, targets = jsh.example_batch(jcfg, mesh)
    tokens = jnp.concatenate([np.asarray(inputs),
                              np.asarray(targets)[:, -1:]], axis=1)
    grads = _flat(jax.grad(jllama.loss_fn)(np_params, tokens, jcfg))
    params = jax.tree.map(jnp.asarray, np_params)
    sgd, loss = jsh.build_train_step(jcfg, mesh, lr=SGD_LR)(
        jsh.shard_params(params, mesh, jcfg), inputs, targets)
    params = jsh.shard_params(jax.tree.map(jnp.asarray, np_params), mesh,
                              jcfg)
    adamw, _, _ = jsh.build_adamw_train_step(jcfg, mesh, lr=ADAM_LR,
                                             eps=ADAM_EPS)(
        params, jsh.init_adamw_state(params), inputs, targets)
    return float(loss), grads, _flat(sgd), _flat(adamw)


class _Coords:
    """A rank's place in a mesh of ``sizes``, filled row-major the way JAX
    fills its device array (independent of the port's ``Mesh``)."""

    def __init__(self, sizes, rank):
        self.shape = dict(sizes)
        idx = np.unravel_index(rank, [sizes[a] for a in tsh.AXES])
        self.coords = dict(zip(tsh.AXES, (int(i) for i in idx)))

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


def _check_rank(name, tcfg, res, want, old, coords):
    loss, grads, sgd, adamw = want
    assert abs(float(res["loss"]) - loss) < LOSS_TOL[name], (res["loss"], loss)
    specs = dict(tsh.tree_leaves(tsh.param_specs(tcfg)))
    for path, spec in specs.items():
        key = "/".join(path)
        idx = tsh.shard_slices(old[key].shape, spec, coords)
        ref_g = grads[key][idx]
        scale = float(np.abs(grads[key]).max())
        assert _rel(res["grad/" + key], ref_g, scale) < GRAD_REL, key
        got_g = (old[key][idx] - res["sgd/" + key]) / SGD_LR
        want_g = (old[key][idx] - sgd[key][idx]) / SGD_LR
        assert _rel(got_g, want_g, scale) < GRAD_REL, ("sgd", key)
        assert _rel(res["adamw/" + key], adamw[key][idx],
                    float(np.abs(adamw[key]).max())) < GRAD_REL, ("adamw", key)


@pytest.mark.parametrize("name", ["tiny", "tiny2", "tiny-moe"])
def test_factor_mesh_axes_equals_jax(name):
    for n in range(1, 65):
        assert tsh.factor_mesh_axes(n, tllama.CONFIGS[name]) == \
            jsh.factor_mesh_axes(n, jllama.CONFIGS[name]), n


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_param_specs_cover_every_leaf_as_jax(name):
    jcfg, tcfg = _cfgs(name)
    jspecs = jax.tree.leaves(jsh.param_specs(jcfg),
                             is_leaf=lambda x: isinstance(x, P))
    tspecs = tsh.tree_leaves(tsh.param_specs(tcfg))
    np_params = _np_params(jcfg)
    assert [p for p, _ in tspecs] == [
        tuple(k.split("/")) for k in _flat(np_params)]
    for (path, spec), jspec in zip(tspecs, jspecs):
        assert tuple(spec) == tuple(jspec), path
        if path[0] == "layers":
            assert spec[0] == "pp", path
    shapes = dict(tsh.tree_leaves(tsh.param_shapes(tcfg)))
    for key, a in _flat(np_params).items():
        assert shapes[tuple(key.split("/"))] == a.shape, key


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_one_rank_step_matches_jax(name):
    """World 1: loss, gradients, the SGD and the AdamW step against
    JAX's on its one-device mesh (f32)."""
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg)
    sizes = tsh.factor_mesh_axes(1, tcfg)
    want = _jax_run(jcfg, sizes, np_params)
    mesh = make_mesh([1] * 5, tsh.AXES)
    x, y = tsh.example_batch(tcfg, mesh, device="cpu")

    def fresh():
        return tserde.params_from_numpy(np_params, "cpu")

    res = {}
    loss, grads = tsh.loss_and_grads(tcfg, mesh, fresh(), x, y)
    res["loss"] = loss.numpy()
    paths = [p for p, _ in tsh.tree_leaves(fresh())]
    for path, g in zip(paths, grads):
        res["grad/" + "/".join(path)] = g.numpy()
    sgd, _ = tsh.build_train_step(tcfg, mesh, lr=SGD_LR)(fresh(), x, y)
    params = fresh()
    adamw, opt, _ = tsh.build_adamw_train_step(tcfg, mesh, lr=ADAM_LR,
                                               eps=ADAM_EPS)(
        params, tsh.init_adamw_state(params), x, y)
    assert int(opt["step"]) == 1
    for path, p in tsh.tree_leaves(sgd):
        res["sgd/" + "/".join(path)] = p.numpy()
    for path, p in tsh.tree_leaves(adamw):
        res["adamw/" + "/".join(path)] = p.numpy()
    _check_rank(name, tcfg, res, want, _flat(np_params), _Coords(sizes, 0))


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_one_rank_bf16_loss_matches_jax(name):
    jcfg, tcfg = _cfgs(name, f32=False)
    np_params = _np_params(jcfg)
    jmesh = jsh.make_train_mesh(1, jcfg)
    inputs, targets = jsh.example_batch(jcfg, jmesh)
    _, want = jsh.build_train_step(jcfg, jmesh, lr=0.0)(
        jsh.shard_params(jax.tree.map(jnp.asarray, np_params), jmesh, jcfg),
        inputs, targets)
    mesh = tsh.make_train_mesh(1, tcfg)
    x, y = tsh.example_batch(tcfg, mesh, device="cpu")
    assert np.array_equal(x.numpy(), np.asarray(inputs))
    assert np.array_equal(y.numpy(), np.asarray(targets))
    loss, grads = tsh.loss_and_grads(
        tcfg, mesh, tserde.params_from_numpy(np_params, "cpu"), x, y)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert abs(float(loss) - float(want)) < BF16_LOSS_TOL


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name,sizes", [
    ("tiny", {"dp": 1, "sp": 2, "pp": 1, "ep": 1, "tp": 2}),
    ("tiny", {"dp": 1, "sp": 1, "pp": 2, "ep": 1, "tp": 2}),
    ("tiny-moe", {"dp": 1, "sp": 1, "pp": 1, "ep": 2, "tp": 2}),
], ids=["sp2xtp2", "pp2xtp2", "ep2xtp2"])
def test_gloo_world_step_matches_jax(tmp_path, name, sizes):
    """Four gloo ranks on a mesh shape: each rank's loss, gradients, SGD
    and AdamW params against JAX's step on the same mesh shape (f32)."""
    jcfg, tcfg = _cfgs(name)
    np_params = _np_params(jcfg)
    want = _jax_run(jcfg, sizes, np_params)
    old = _flat(np_params)
    job = {"kind": "step", "config": name, "dtype": "float32",
           "mesh": sizes, "batch": 0, "seq": 0, "sgd_lr": SGD_LR,
           "adam_lr": ADAM_LR, "eps": ADAM_EPS, "remat": True}
    ranks = spawn_world(tmp_path, 4, job, old)
    for rank, res in enumerate(ranks):
        coords = _Coords(sizes, rank)
        assert {a: int(res[f"coord/{a}"]) for a in tsh.AXES} == coords.coords
        _check_rank(name, tcfg, res, want, old, coords)


def test_remat_matches_no_remat():
    """Checkpointing each layer recomputes the same program: identical
    loss and params after an AdamW step, bit for bit."""
    _, tcfg = _cfgs("tiny")
    jcfg, _ = _cfgs("tiny")
    np_params = _np_params(jcfg)
    mesh = make_mesh([1] * 5, tsh.AXES)
    x, y = tsh.example_batch(tcfg, mesh, device="cpu")
    outs = {}
    for remat in (False, True):
        params = tserde.params_from_numpy(np_params, "cpu")
        step = tsh.build_adamw_train_step(tcfg, mesh, lr=1e-2, remat=remat)
        params, _, loss = step(params, tsh.init_adamw_state(params), x, y)
        outs[remat] = (params, float(loss))
    assert outs[False][1] == outs[True][1]
    for (path, a), (_, b) in zip(tsh.tree_leaves(outs[False][0]),
                                 tsh.tree_leaves(outs[True][0])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_adamw_loss_falls_over_five_steps(name):
    """bf16, as JAX's AdamW test: five steps at lr 3e-3 lower the loss,
    the moments stay f32 and shaped like their params, and every step
    goes through the ring's block attention (plain on the CPU)."""
    jcfg, tcfg = _cfgs(name, f32=False)
    mesh = tsh.make_train_mesh(1, tcfg)
    params = tserde.params_from_numpy(_np_params(jcfg), "cpu")
    opt = tsh.init_adamw_state(params)
    step = tsh.build_adamw_train_step(tcfg, mesh, lr=3e-3)
    x, y = tsh.example_batch(tcfg, mesh, device="cpu")
    before = tfa.plain_calls
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert int(opt["step"]) == 5
    # Per step: one block per layer forward, and again in the recompute.
    assert tfa.plain_calls - before == 5 * 2 * tcfg.n_layers
    for (path, p), (_, m) in zip(tsh.tree_leaves(params),
                                 tsh.tree_leaves(opt["m"])):
        assert m.dtype == torch.float32 and m.shape == p.shape, path
        assert p.dtype == torch.bfloat16, path


def test_example_batch_equals_jax_and_shards_over_dp_sp():
    jcfg, tcfg = jllama.CONFIGS["tiny"], tllama.CONFIGS["tiny"]
    jmesh = jsh.make_train_mesh(1, jcfg)
    inputs, targets = jsh.example_batch(jcfg, jmesh, batch=4, seq=16)
    sizes = {"dp": 2, "sp": 2, "pp": 1, "ep": 1, "tp": 1}
    for rank in range(4):
        c = _Coords(sizes, rank)
        rows = slice(c.coords["dp"] * 2, c.coords["dp"] * 2 + 2)
        cols = slice(c.coords["sp"] * 8, c.coords["sp"] * 8 + 8)
        idx = tsh.shard_slices((4, 16), ("dp", "sp"), c)
        assert idx == (rows, cols)
    x, y = tsh.example_batch(tcfg, make_mesh([1] * 5, tsh.AXES), batch=4,
                             seq=16, device="cpu")
    assert np.array_equal(x.numpy(), np.asarray(inputs))
    assert np.array_equal(y.numpy(), np.asarray(targets))


def test_mesh_larger_than_one_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh([1, 2, 1, 1, 1], tsh.AXES)
    mesh = make_mesh([1] * 5, tsh.AXES)
    assert mesh.shape == dict.fromkeys(tsh.AXES, 1)
    assert all(mesh.axis_index(a) == 0 for a in tsh.AXES)


def test_pp_serving_waits_for_the_fabric_slice():
    cfg = tllama.CONFIGS["tiny"]
    mesh = make_mesh([1] * 5, tsh.AXES)
    for build in (lambda: tsh.build_pp_forward(cfg, mesh, "pp"),
                  lambda: tsh.build_pp_decode(cfg, mesh, "pp", 4)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            build()
