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
        out = {"ring": run_ring, "step": run_step}[job["kind"]](job, inputs)
        np.savez(os.path.join(job["out"], f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
