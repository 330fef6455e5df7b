"""One rank of a multi-process ``gloo`` world for the port's training tests.

    python tests/torch_dist_worker.py <rank> <world> <store> <job.json>

The rank joins the world through a ``torch.distributed.FileStore`` at
``<store>`` (no ports), runs the job that ``job.json`` names on the CPU
and writes its local results to ``<out>/rank<r>.npz``.  ``spawn_world``
starts the whole world from a test.  Jobs:

- ``ring``: ``parallel.ring_attention`` over an ``sp`` mesh of the whole
  world on this rank's sequence block of the job's q, k, v; the output
  and, for the job's ``dout``, dq, dk, dv;
- ``step``: ``models.sharded`` on the job's mesh for its config and
  params: the loss and every leaf's gradient (``loss_and_grads``), the
  params after one SGD step and, from the same start, after one AdamW
  step.

- ``ckpt_save``: the job's full training state (``params/...``,
  ``opt/m/...``, ``opt/v/...``, ``opt/step``; bf16 leaves as uint16
  bits) sharded over the job's mesh and written with
  ``train_ckpt.save_train_state`` to the job's ``ckpt``;
- ``ckpt_restore``: ``train_ckpt.restore_train_state`` of the job's
  ``ckpt`` onto the job's mesh; every local leaf (bf16 as uint16 bits).
- ``train_cli``: ``cli.train``'s ``main`` with the job's ``argv`` in
  this world (its output and log records go to the rank's log, which the
  test reads); no results beyond the exit.

Each result carries this rank's mesh coordinates (``coord/<axis>``), so
the test can check the row-major fill against its own.  Imports neither
``jax`` nor the JAX package.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from distributed_llm_dissemination_tpu_torch.models import llama, serde  # noqa: E402
from distributed_llm_dissemination_tpu_torch.models import sharded  # noqa: E402
from distributed_llm_dissemination_tpu_torch.parallel import axes  # noqa: E402
from distributed_llm_dissemination_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from distributed_llm_dissemination_tpu_torch.parallel.ring_attention import (  # noqa: E402
    ring_attention)


def _coords(mesh):
    return {f"coord/{a}": np.int64(i) for a, i in mesh.coords.items()}


def run_ring(job, inputs):
    world = dist.get_world_size()
    mesh = make_mesh([world], ["sp"])
    s_local = inputs["q"].shape[1] // world
    rows = slice(mesh.rank * s_local, (mesh.rank + 1) * s_local)
    q, k, v = (torch.from_numpy(inputs[n][:, rows].copy()).requires_grad_()
               for n in ("q", "k", "v"))
    dout = torch.from_numpy(inputs["dout"][:, rows].copy())
    with axes.manual(mesh):
        out = ring_attention(q, k, v, "sp", s_local)
        out.backward(dout)
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(), **_coords(mesh)}


def run_step(job, inputs):
    cfg = llama.CONFIGS[job["config"]]
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, job["dtype"]))
    mesh = make_mesh([job["mesh"][a] for a in sharded.AXES], sharded.AXES)
    full = sharded.tree_unflatten(
        (tuple(k.split("/")), v) for k, v in inputs.items())

    def fresh():
        return sharded.shard_params(serde.params_from_numpy(full, "cpu"),
                                    mesh, cfg)

    batch, seq = job["batch"], job["seq"]
    x, y = sharded.example_batch(cfg, mesh, batch, seq, device="cpu")
    out = dict(_coords(mesh))
    loss, grads = sharded.loss_and_grads(cfg, mesh, fresh(), x, y,
                                         remat=job["remat"])
    out["loss"] = loss.numpy()
    for (path, _), g in zip(sharded.tree_leaves(fresh()), grads):
        out["grad/" + "/".join(path)] = g.numpy()
    params, loss = sharded.build_train_step(
        cfg, mesh, lr=job["sgd_lr"], remat=job["remat"])(fresh(), x, y)
    out["sgd_loss"] = loss.numpy()
    for path, p in sharded.tree_leaves(params):
        out["sgd/" + "/".join(path)] = p.numpy()
    params = fresh()
    opt = sharded.init_adamw_state(params)
    params, opt, loss = sharded.build_adamw_train_step(
        cfg, mesh, lr=job["adam_lr"], eps=job["eps"], remat=job["remat"])(
            params, opt, x, y)
    out["adamw_loss"] = loss.numpy()
    for path, p in sharded.tree_leaves(params):
        out["adamw/" + "/".join(path)] = p.numpy()
    return out


def _torch_leaf(a, bf16):
    t = torch.from_numpy(np.array(a))  # keeps 0-d leaves 0-d
    return t.view(torch.bfloat16) if bf16 else t


def _numpy_leaf(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


def run_ckpt(job, inputs):
    from distributed_llm_dissemination_tpu_torch.models import train_ckpt

    cfg = llama.CONFIGS[job["config"]]
    mesh = make_mesh([job["mesh"][a] for a in sharded.AXES], sharded.AXES)
    out = dict(_coords(mesh))
    if job["kind"] == "ckpt_restore":
        params, opt = train_ckpt.restore_train_state(job["ckpt"], cfg, mesh,
                                                     "cpu")
        state = {"params": params, "opt": opt}
        for path, t in sharded.tree_leaves(state):
            out["/".join(path)] = _numpy_leaf(t)
        return out
    specs = dict(sharded.tree_leaves(sharded.param_specs(cfg)))
    leaves = []
    for key, a in inputs.items():
        path = tuple(key.split("/"))
        full = _torch_leaf(a, key in job["bf16"])
        spec = specs.get(path[2:] if path[0] == "opt" else path[1:], ())
        leaves.append((path, full[sharded.shard_slices(full.shape, spec,
                                                       mesh)].clone()))
    state = sharded.tree_unflatten(leaves)
    train_ckpt.save_train_state(job["ckpt"], state["params"], state["opt"],
                                mesh)
    return out


def run_train_cli(job, inputs):
    from distributed_llm_dissemination_tpu_torch.cli import train

    assert train.main(job["argv"]) == 0
    return {}


def spawn_world(tmp_path, world: int, job: dict, inputs: dict,
                timeout: float = 120.0):
    """Run ``job`` on ``world`` ranks, one process each, rendezvous through
    a FileStore under ``tmp_path``; returns each rank's results.  Every
    child is joined, or killed, before it returns."""
    import pathlib
    import subprocess
    import time

    tmp = pathlib.Path(tmp_path)
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    np.savez(tmp / "inputs.npz", **inputs)
    job = dict(job, inputs=str(tmp / "inputs.npz"), out=str(out_dir))
    (tmp / "job.json").write_text(json.dumps(job))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(world):
            with open(tmp / f"rank{r}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r),
                     str(world), str(tmp / "store"), str(tmp / "job.json")],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        bad = [(r, p.returncode,
                (tmp / f"rank{r}.log").read_text(errors="replace")[-3000:])
               for r, p in enumerate(procs) if p.returncode != 0]
        assert not bad, bad
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(world):
        with np.load(out_dir / f"rank{r}.npz") as data:
            results.append({k: data[k] for k in data.files})
    return results


def main(argv):
    rank, world, store, job_path = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with np.load(job["inputs"]) as data:
            inputs = {k: data[k] for k in data.files}
        out = {"ring": run_ring, "step": run_step, "ckpt_save": run_ckpt,
               "ckpt_restore": run_ckpt,
               "train_cli": run_train_cli}[job["kind"]](job, inputs)
        np.savez(os.path.join(job["out"], f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
