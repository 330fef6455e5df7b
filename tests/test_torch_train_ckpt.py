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
the library.  Without ``-resume`` it first disseminates the weights
(``cli.podrun.run_pod``, mode 3) and trains from the dests' delivered
blobs: the assembled params equal the JAX package's
``_params_from_dissemination`` bit for bit on the same topology, and the
losses JAX's within the bf16 bound of ``tests/test_torch_sharded.py``.
In a world of two gloo ranks rank 0 disseminates and broadcasts, and
each rank's shards equal JAX's params sliced by its coordinates.
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
BF16_LOSS_TOL = 0.02  # tests/test_torch_sharded.py: the bf16 loss bound


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
    # Another mesh restores: the same record as a dp = 2 writer's two
    # ranks would hold it (dp splits no leaf).
    src = os.path.join(path, "rank00000-of-00001.pt")
    record = torch.load(src, weights_only=True)
    os.remove(src)
    record["mesh"] = dict(record["mesh"], dp=2)
    for r in range(2):
        torch.save(dict(record, rank=r, world=2),
                   os.path.join(path, f"rank{r:05d}-of-00002.pt"))
    got_p, got_o = train_ckpt.restore_train_state(path, cfg, mesh, "cpu")
    _assert_same(got_p, params)
    _assert_same(got_o, opt)
    # A format-1 record (no specs) restores onto its own mesh only.
    own = dict(record, format=1, mesh=dict(mesh.shape))
    del own["specs"]
    one = str(tmp_path / "format1")
    os.makedirs(one)
    torch.save(own, os.path.join(one, "rank00000-of-00001.pt"))
    _assert_same(train_ckpt.restore_train_state(one, cfg, mesh, "cpu")[0],
                 params)
    torch.save(dict(own, mesh=record["mesh"]),
               os.path.join(one, "rank00000-of-00001.pt"))
    with pytest.raises(ValueError, match="format-1"):
        train_ckpt.restore_train_state(one, cfg, mesh, "cpu")
    # A mesh the config cannot be split over (tiny has 2 kv heads).
    bad = str(tmp_path / "tp3")
    os.makedirs(bad)
    for r in range(3):
        torch.save(dict(record, mesh=dict(mesh.shape, tp=3), rank=r, world=3),
                   os.path.join(bad, f"rank{r:05d}-of-00003.pt"))
    with pytest.raises(ValueError, match="split"):
        train_ckpt.restore_train_state(bad, cfg, mesh, "cpu")
    # A missing rank file.
    os.remove(os.path.join(path, "rank00001-of-00002.pt"))
    with pytest.raises(ValueError, match=r"no shard file for ranks \[1\]"):
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


def _pod_conf(tmp_path, codec=""):
    """``conf/train_tiny_pod.json`` (leader 0 seeds ``tiny``, node 1 is
    assigned every blob, a (2, 4) mesh), optionally under a ModelCodec."""
    with open(os.path.join(REPO, "conf", "train_tiny_pod.json")) as f:
        conf = json.load(f)
    if codec:
        conf["ModelCodec"] = codec
    path = tmp_path / f"pod{codec}.json"
    path.write_text(json.dumps(conf))
    return str(path)


@pytest.fixture
def cli_logs():
    """The CLIs' ``configure`` binds each package's logger to the
    current (captured) stderr: put both back afterwards, so later tests
    never log into a closed capture."""
    from distributed_llm_dissemination_tpu.utils import logging as jlog
    from distributed_llm_dissemination_tpu_torch.utils import logging as tlog

    saved = [(m.log, dict(vars(m.log))) for m in (jlog, tlog)]
    yield
    for logger, attrs in saved:
        vars(logger).update(attrs)


def test_cli_train_without_resume_waits_for_the_fabric(tmp_path, capsys,
                                                       cli_logs):
    """Without ``-resume`` the CLI no longer waits: it disseminates, then
    trains from the delivered weights.  A config without ``Model`` or a
    ``-resume`` without ``-ckpt`` still exits."""
    assert tcli.main(["-f", _pod_conf(tmp_path), "-steps", "1",
                      "-device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["ttd_s"] > 0 and summary["final_step"] == 1
    assert "resumed_step" not in summary and "ckpt" not in summary
    with pytest.raises(SystemExit, match="-ckpt"):
        tcli.main(["-f", _conf(tmp_path), "-resume", "-device", "cpu"])
    with pytest.raises(SystemExit, match="Model"):
        tcli.main(["-f", _conf(tmp_path, model=""), "-resume", "-ckpt",
                   str(tmp_path / "ck"), "-device", "cpu"])


@pytest.mark.timeout(300)
def test_cli_train_without_resume_disseminates_in_a_larger_world(
        tmp_path, cpu_devices):
    """A world of two gloo ranks without ``-resume``: rank 0 disseminates
    (``cli.podrun.run_pod`` on its own device), broadcasts the delivered
    params, and every rank's shards, as training starts, equal the JAX
    package's ``_params_from_dissemination`` on the same topology, sliced
    by the rank's mesh coordinates, bit for bit (a digest of each leaf's
    bytes, ``-params-digest``).  Rank 0 prints the summary with the
    dissemination's timings; both ranks train the step."""
    from distributed_llm_dissemination_tpu.cli import train as jcli
    from distributed_llm_dissemination_tpu.core import config as jcfg
    from torch_dist_worker import spawn_world

    path = _pod_conf(tmp_path)
    jparams, _, _ = jcli._params_from_dissemination(jcfg.read_json(path),
                                                    60.0)
    full = dict(tsh.tree_leaves(tserde.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")))
    cfg = tllama.CONFIGS["tiny"]
    sizes = tsh.factor_mesh_axes(2, cfg)
    assert sizes["tp"] == 2
    specs = dict(tsh.tree_leaves(tsh.param_specs(cfg)))
    work = tmp_path / "world"
    work.mkdir()
    spawn_world(work, 2, {"kind": "train_cli", "argv": [
        "-f", path, "-steps", "1", "-batch", "8", "-seq", "16",
        "-device", "cpu", "-params-digest"]}, {}, timeout=240.0)
    for r in range(2):
        lines = (work / f"rank{r}.log").read_text().splitlines()
        recs = [json.loads(x) for x in lines if x.startswith("{")]
        placed = [x for x in recs
                  if x.get("message") == "training params placed"]
        assert len(placed) == 1, lines[-20:]
        assert placed[0]["rank"] == r and placed[0]["world"] == 2
        view = train_ckpt._Coords(sizes, r)
        want = tcli.params_digests(tsh.tree_unflatten(
            (p, t[tsh.shard_slices(t.shape, specs[p], view)].clone())
            for p, t in full.items()))
        assert placed[0]["digests"] == want, r
        ran = [x for x in recs if x.get("message") == "training ran"]
        assert len(ran) == 1 and len(ran[0]["losses"]) == 1
        summaries = [x for x in recs if "final_step" in x]
        if r == 0:
            assert len(summaries) == 1 and summaries[0]["ttd_s"] > 0
            assert summaries[0]["mesh"] == sizes
            assert summaries[0]["final_step"] == 1
        else:
            assert not summaries


@pytest.mark.parametrize("codec", ["", "int8"])
def test_cli_train_disseminates_then_trains_like_jax(tmp_path, capsys,
                                                    cpu_devices, cli_logs,
                                                    codec):
    """The dissemination half against the JAX package's: on the same
    topology (raw, and under ``ModelCodec`` int8, decoded on the host as
    JAX does) the params assembled from the dests' blobs equal JAX's
    ``_params_from_dissemination`` leaf for leaf, bit for bit; then two
    AdamW steps on the same batch give JAX's losses within the bf16
    bound."""
    from distributed_llm_dissemination_tpu.cli import train as jcli
    from distributed_llm_dissemination_tpu.core import config as jcfg
    from distributed_llm_dissemination_tpu_torch.core import config as tcfg

    path = _pod_conf(tmp_path, codec)
    params, cfg, summary = tcli._params_from_dissemination(
        tcfg.read_json(path), 60.0, "cpu")
    jparams, _, jsummary = jcli._params_from_dissemination(
        jcfg.read_json(path), 60.0)
    assert summary["ttd_s"] > 0 and jsummary["ttd_s"] > 0
    want = dict(tsh.tree_leaves(tserde.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")))
    got = dict(tsh.tree_leaves(params))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t.view(torch.int16), want[name].view(torch.int16)), \
            name
    capsys.readouterr()
    argv = ["-f", path, "-steps", "2", "-batch", "8", "-seq", "16"]
    assert tcli.main(argv + ["-device", "cpu"]) == 0
    losses = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "losses"]
    assert jcli.main(argv) == 0
    jlosses = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "losses"]
    assert len(losses) == len(jlosses) == 2
    for a, b in zip(losses, jlosses):
        assert abs(a - b) < BF16_LOSS_TOL, (losses, jlosses)


# ------------------------------------------------ across meshes, vs JAX


def _jax_state(jcfg, mesh):
    """A seeded ``tiny`` training state on ``mesh``: the params of
    ``init_params(key(0))``, seeded f32 moments and step 3, each leaf
    placed with the train step's sharding; and the same state as numpy
    by path (bf16 leaves as uint16 bits)."""
    from jax.sharding import NamedSharding

    rng = np.random.default_rng(11)
    params = jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.key(0)))
    moments = {m: jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for m in ("m", "v")}
    state = {"params": params, "opt": {**moments,
                                       "step": np.asarray(3, np.int32)}}
    specs = {"params": jsh.param_specs(jcfg),
             "opt": jsh.adamw_state_specs(jcfg)}
    placed = jax.tree.map(
        lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec)),
        state, specs)
    return placed, _flat(state)


def _flat(tree):
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(a)
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


def _gathered(ranks, cfg, full):
    """Each rank's restored local leaves placed at their shards of the
    full shape; every element must be written."""
    out = {}
    specs = dict(tsh.tree_leaves(tsh.param_specs(cfg)))
    for key, ref in full.items():
        got = np.zeros_like(ref)
        seen = np.zeros(ref.shape, bool)
        path = tuple(key.split("/"))
        spec = specs.get(path[2:] if path[0] == "opt" else path[1:], ())
        for r in ranks:
            view = train_ckpt._Coords(
                {a: int(r[f"size/{a}"]) for a in tsh.AXES},
                int(r["rank"]))
            idx = tsh.shard_slices(ref.shape, spec, view)
            got[idx] = r[key]
            seen[idx] = True
        assert seen.all(), key
        out[key] = got
    return out


@pytest.mark.timeout(300)
def test_cross_mesh_restore_matches_jax(tmp_path):
    """A training state saved under a 4-rank mesh (pp 2, tp 2) restores
    under 1 rank and under 2 (tp 2), every leaf equal bit for bit to the
    JAX package's own restore of the same state saved under
    ``make_train_mesh(8)`` (sp 2, pp 2, tp 2) and restored under
    ``make_train_mesh(2)``, gathered."""
    from distributed_llm_dissemination_tpu.models import (
        train_ckpt as jtrain_ckpt,
    )
    from torch_dist_worker import spawn_world

    jcfg = jllama.CONFIGS["tiny"]
    cfg = tllama.CONFIGS["tiny"]
    placed, full = _jax_state(jcfg, jsh.make_train_mesh(8, jcfg))
    jpath = str(tmp_path / "jax_ck")
    jtrain_ckpt.save_train_state(jpath, placed["params"], placed["opt"])
    jp, jo = jtrain_ckpt.restore_train_state(
        jpath, jcfg, jsh.make_train_mesh(2, jcfg))
    want = _flat({"params": jp, "opt": jo})
    assert want.keys() == full.keys()
    for key in full:
        np.testing.assert_array_equal(want[key], full[key])

    ck = str(tmp_path / "port_ck")
    bf16 = [k for k in full if full[k].dtype == np.uint16]
    mesh4 = tsh.factor_mesh_axes(4, cfg)
    assert mesh4 == {"dp": 1, "sp": 1, "pp": 2, "ep": 1, "tp": 2}
    (tmp_path / "save").mkdir()
    spawn_world(tmp_path / "save", 4,
                {"kind": "ckpt_save", "config": "tiny", "mesh": mesh4,
                 "ckpt": ck, "bf16": bf16}, full)
    assert len(os.listdir(ck)) == 4
    # One rank, in process.
    params, opt = train_ckpt.restore_train_state(
        ck, cfg, tsh.make_train_mesh(1, cfg), "cpu")
    one = {"/".join(p): (t.view(torch.int16).numpy().view(np.uint16)
                         if t.dtype == torch.bfloat16 else t.numpy())
           for p, t in tsh.tree_leaves({"params": params, "opt": opt})}
    assert one.keys() == want.keys()
    for key in want:
        assert one[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(one[key], want[key], err_msg=key)
    # Two ranks.
    mesh2 = tsh.factor_mesh_axes(2, cfg)
    (tmp_path / "restore").mkdir()
    ranks = spawn_world(tmp_path / "restore", 2,
                        {"kind": "ckpt_restore", "config": "tiny",
                         "mesh": mesh2, "ckpt": ck}, {})
    for r, res in enumerate(ranks):
        res["rank"] = r
        res.update({f"size/{a}": mesh2[a] for a in tsh.AXES})
    two = _gathered(ranks, cfg, want)
    for key in want:
        np.testing.assert_array_equal(two[key], want[key], err_msg=key)
