"""The port's training-state checkpoint (``models/train_ckpt.py``), the
JAX AdamW state carried across (``serde.train_state_from_numpy``), and
``cli.train -resume`` as a process.

Mirrored from ``tests/test_models.py::test_train_state_checkpoint_
roundtrip_resumes_exactly``: two AdamW steps, save, then the step from
the restored state is bit-identical to the uninterrupted step.  Added:
a checkpoint of another model or mesh raises, the write is atomic (a
failed save leaves the old checkpoint whole), every leaf keeps its dtype,
and the JAX package's AdamW state continues in the port as in JAX (f32,
``tests/test_torch_sharded.py``'s AdamW bound, 1e-4 of the largest param
at lr 1e-2 and eps 1e-3).

``cli.train -device cpu -resume`` runs as a child process (killed in a
``finally``) and continues the saved trajectory with the same losses as
the library; without ``-resume`` it raises ``NotImplementedError`` naming
the fabric slice.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import sharded as jsh
from distributed_llm_dissemination_tpu_torch.cli import train as tcli
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.models import sharded as tsh
from distributed_llm_dissemination_tpu_torch.models import train_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 3e-3  # tests/test_models.py's AdamW training tests


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _start(name="tiny"):
    cfg = tllama.CONFIGS[name]
    mesh = tsh.make_train_mesh(1, cfg)
    np_params = jax.tree.map(np.asarray, jllama.init_params(
        jllama.CONFIGS[name], jax.random.key(0)))
    params = tserde.params_from_numpy(np_params, "cpu")
    return cfg, mesh, params, tsh.init_adamw_state(params)


def _steps(cfg, mesh, params, opt, n):
    step = tsh.build_adamw_train_step(cfg, mesh, lr=LR)
    x, y = tsh.example_batch(cfg, mesh, device="cpu")
    losses = []
    for _ in range(n):
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
    return params, opt, losses


def _clone(tree):
    return tsh.tree_unflatten((p, x.clone()) for p, x in tsh.tree_leaves(tree))


def _assert_same(a, b):
    la, lb = tsh.tree_leaves(a), tsh.tree_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_save_restore_continue_is_bit_identical(tmp_path):
    cfg, mesh, params, opt = _start()
    params, opt, _ = _steps(cfg, mesh, params, opt, 2)
    path = str(tmp_path / "trainstate")
    train_ckpt.save_train_state(path, params, opt, mesh)
    ref_p, ref_o, ref_loss = _steps(cfg, mesh, _clone(params), _clone(opt), 1)
    got_p, got_o = train_ckpt.restore_train_state(path, cfg, mesh, "cpu")
    assert int(got_o["step"]) == 2
    _assert_same(got_p, params)
    _assert_same(got_o, opt)
    got_p, got_o, got_loss = _steps(cfg, mesh, got_p, got_o, 1)
    assert got_loss == ref_loss
    _assert_same(got_p, ref_p)
    _assert_same(got_o, ref_o)


def test_every_leaf_keeps_its_dtype(tmp_path):
    cfg, mesh, params, opt = _start("tiny-moe")
    path = str(tmp_path / "ck")
    train_ckpt.save_train_state(path, params, opt, mesh)
    got_p, got_o = train_ckpt.restore_train_state(path, cfg, mesh, "cpu")
    assert {x.dtype for _, x in tsh.tree_leaves(got_p)} == {torch.bfloat16}
    assert {x.dtype for _, x in tsh.tree_leaves(
        {"m": got_o["m"], "v": got_o["v"]})} == {torch.float32}
    assert got_o["step"].dtype == torch.int32
    assert os.listdir(path) == ["rank00000-of-00001.pt"]


def test_restore_of_another_model_or_mesh_raises(tmp_path):
    cfg, mesh, params, opt = _start()
    path = str(tmp_path / "ck")
    train_ckpt.save_train_state(path, params, opt, mesh)
    for other in ("tiny-moe", "tiny2"):  # other leaves; other shapes
        with pytest.raises(ValueError, match="tiny"):
            train_ckpt.restore_train_state(path, tllama.CONFIGS[other],
                                           mesh, "cpu")
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        train_ckpt.restore_train_state(path, f32, mesh, "cpu")
    src = os.path.join(path, "rank00000-of-00001.pt")
    record = torch.load(src, weights_only=True)
    record["mesh"] = dict(record["mesh"], dp=2)
    torch.save(record, src)
    with pytest.raises(ValueError, match="mesh"):
        train_ckpt.restore_train_state(path, cfg, mesh, "cpu")
    with pytest.raises(ValueError, match="no shard file"):
        train_ckpt.restore_train_state(str(tmp_path / "none"), cfg, mesh,
                                       "cpu")


def test_failed_save_leaves_the_old_checkpoint_whole(tmp_path, monkeypatch):
    cfg, mesh, params, opt = _start()
    path = str(tmp_path / "ck")
    train_ckpt.save_train_state(path, params, opt, mesh)
    params2, opt2, _ = _steps(cfg, mesh, _clone(params), _clone(opt), 1)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(train_ckpt.torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        train_ckpt.save_train_state(path, params2, opt2, mesh)
    monkeypatch.undo()
    got_p, got_o = train_ckpt.restore_train_state(path, cfg, mesh, "cpu")
    _assert_same(got_p, params)
    assert int(got_o["step"]) == 0
    train_ckpt.save_train_state(path, params2, opt2, mesh)  # replaces it
    got_p, got_o = train_ckpt.restore_train_state(path, cfg, mesh, "cpu")
    _assert_same(got_p, params2)
    assert int(got_o["step"]) == 1
    assert sorted(os.listdir(tmp_path)) == ["ck"]


def test_jax_adamw_state_continues_in_the_port():
    """One JAX AdamW step, its (params, m, v, step) carried into the port
    by ``train_state_from_numpy``, then one more step in each (f32)."""
    jcfg = dataclasses.replace(jllama.CONFIGS["tiny"], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.CONFIGS["tiny"], dtype=torch.float32)
    jmesh = jsh.make_train_mesh(1, jcfg)
    step = jsh.build_adamw_train_step(jcfg, jmesh, lr=1e-2, eps=1e-3)
    inputs, targets = jsh.example_batch(jcfg, jmesh)
    params = jsh.shard_params(jllama.init_params(jcfg, jax.random.key(0)),
                              jmesh, jcfg)
    params, opt, _ = step(params, jsh.init_adamw_state(params), inputs,
                          targets)
    np_p, np_o = jax.tree.map(np.asarray, (params, opt))
    tp, to = tserde.train_state_from_numpy(np_p, np_o, "cpu")
    assert int(to["step"]) == 1 and to["step"].dtype == torch.int32
    fresh = tsh.init_adamw_state(tp)
    assert [p for p, _ in tsh.tree_leaves(to)] == \
        [p for p, _ in tsh.tree_leaves(fresh)]
    params, opt, _ = step(params, opt, inputs, targets)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
    mesh = tsh.make_train_mesh(1, tcfg)
    x, y = tsh.example_batch(tcfg, mesh, device="cpu")
    tp, to, _ = tsh.build_adamw_train_step(tcfg, mesh, lr=1e-2, eps=1e-3)(
        tp, to, x, y)
    assert int(to["step"]) == 2
    for path, got in tsh.tree_leaves(tp):
        ref = want["/".join(path)]
        rel = float(np.abs(got.numpy() - ref).max()) / float(
            np.abs(ref).max())
        assert rel < 1e-4, (path, rel)


def _conf(tmp_path, model="tiny"):
    path = tmp_path / "conf.json"
    path.write_text(json.dumps({"Model": model}))
    return str(path)


@pytest.mark.timeout(180)
def test_cli_train_resume_runs_as_a_process(tmp_path):
    cfg, mesh, params, opt = _start()
    params, opt, _ = _steps(cfg, mesh, params, opt, 2)
    ck = str(tmp_path / "ck")
    train_ckpt.save_train_state(ck, params, opt, mesh)
    _, _, want = _steps(cfg, mesh, _clone(params), _clone(opt), 3)
    cmd = [sys.executable, "-m",
           "distributed_llm_dissemination_tpu_torch.cli.train",
           "-f", _conf(tmp_path), "-resume", "-ckpt", ck, "-steps", "3",
           "-lr", str(LR), "-device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["resumed_step"] == 2 and summary["final_step"] == 5
    assert summary["steps"] == 3 and summary["ckpt"] == ck
    assert summary["mesh"] == dict.fromkeys(tsh.AXES, 1)
    assert summary["losses"] == [round(v, 4) for v in want]
    assert summary["train_s"] >= 0
    _, got_o = train_ckpt.restore_train_state(ck, cfg, mesh, "cpu")
    assert int(got_o["step"]) == 5


def test_cli_train_without_resume_waits_for_the_fabric(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tcli.main(["-f", _conf(tmp_path), "-device", "cpu"])
    with pytest.raises(SystemExit, match="-ckpt"):
        tcli.main(["-f", _conf(tmp_path), "-resume", "-device", "cpu"])
    with pytest.raises(SystemExit, match="Model"):
        tcli.main(["-f", _conf(tmp_path, model=""), "-resume", "-ckpt",
                   str(tmp_path / "ck"), "-device", "cpu"])
