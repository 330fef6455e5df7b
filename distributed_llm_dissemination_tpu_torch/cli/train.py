"""Dissemination -> training bring-up, as one driveable command.

Port of the JAX package's ``cli/train.py``:

    python -m distributed_llm_dissemination_tpu_torch.cli.train \\
        -f conf.json -steps 20 -ckpt /ckpt/run1 [-resume]

Without ``-resume`` it disseminates the topology's model blobs over the
pod fabric (``cli.podrun.run_pod``, mode 3, single controller), so the
weights land exactly as a deployment's would; assembles the blobs the
dests received (never a seeder's own copy) into params; shards them onto
the 5-axis training mesh and starts fresh AdamW moments.  With
``-resume`` it restores (params, AdamW state) from ``-ckpt``
(``models.train_ckpt``) and skips the dissemination.  Then it runs
``-steps`` AdamW steps of the 5-axis training step (``models.sharded``,
layer rematerialisation, ring attention through K1) on the seeded batch
of ``example_batch``, saves the state to ``-ckpt`` when given, and prints
the summary JSON (the dissemination's timings or ``resumed_step``,
``ckpt``, ``mesh``, ``steps``, ``final_step``, ``losses``, ``train_s``).
The topology's ``Model`` section names the model.

The world is ``torch.distributed``'s: a ``WORLD_SIZE`` above 1 in the
environment (as ``torchrun`` sets it, with ``RANK``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``) initialises the default process group
from it (``cpu:gloo,cuda:nccl`` on cards, after making
``cuda:LOCAL_RANK`` the current card; gloo on the CPU); otherwise the
world is this one process.  ``-device`` picks the device (None = the
CUDA card, ``cuda:LOCAL_RANK`` in a larger world); a machine without a
card raises unless ``-device cpu`` is given.  In a larger world without
``-resume``, rank 0 alone disseminates (the pod addresses its own card:
``-device`` there is its rank's device), then broadcasts every leaf of
the delivered params to every rank on the default group, and each rank
keeps its shard.  Rank 0 prints the summary.

``-params-digest`` logs, on every rank, a ``"training params placed"``
record: the rank's mesh coordinates and a digest of each local shard as
training starts (``utils.integrity.layer_digest``), so a run's shards
can be held against another world's.  The ``"training ran"`` record
gives each rank's step times and, on a card, its peak memory and its
attention launches by kernel and card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..core import config as cfg_mod
from ..utils import logging as ulog
from ..utils.logging import log

def _model_config(name: str):
    from ..models import hf
    from ..models.llama import CONFIGS

    return hf.config_from_name(name) if hf.is_hf(name) else CONFIGS[name]


def _params_from_dissemination(conf, timeout: float, device=None):
    """Run one mode-3 pod dissemination (``cli.podrun.run_pod``) and
    return (params, cfg, timings) assembled on the host from the
    DELIVERED blobs on the dests."""
    from ..models import quant, serde
    from .podrun import run_pod

    mcfg = _model_config(conf.model)
    head_id = serde.head_blob_id(mcfg)
    want = set(range(head_id + 1))
    blobs: dict = {}

    def harvest(_leader, receivers, _placement):
        # Assignees only: a seeder's own copy of a blob proves nothing
        # about delivery -- the training weights must be the ones the
        # dissemination actually landed.
        dests = set(conf.assignment)
        for r in receivers:
            if r.node.my_id not in dests:
                continue
            for bid, src in r.layers.items():
                if bid in want and bid not in blobs:
                    blobs[bid] = bytes(
                        src.inmem_data if src.inmem_data is not None
                        else src.read_bytes())

    t0 = time.monotonic()
    summary = dict(run_pod(conf, mode=3, timeout=timeout,
                           on_delivered=harvest, device=device))
    missing = want - set(blobs)
    if missing:
        raise SystemExit(
            f"dissemination left blobs missing: {sorted(missing)}")
    if conf.model_codec != "raw":
        # A ModelCodec blob decodes on the host to its leaves, whose raw
        # bytes in blob order are the canonical blob.
        raws = {bid: serde._encode(list(quant.decode_blob_host(
                    mcfg, bid, data, conf.model_codec).values()))
                for bid, data in blobs.items()}
        params = serde.params_from_blobs(mcfg, raws)
    else:
        params = serde.params_from_blobs(mcfg, blobs)
    summary["assemble_s"] = round(
        time.monotonic() - t0 - summary.get("ttd_s", 0.0), 3)
    return params, mcfg, summary


def _init_world(device):
    """The world size, after initialising the default process group when
    the environment names more than one rank; and this rank's device."""
    import torch
    import torch.distributed as dist

    from ..utils.device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        dev = torch.device(device or "cuda")
        if dev.type == "cuda":
            # NCCL binds a rank to the current card: this rank's own.
            if dev.index is None:
                dev = torch.device(
                    "cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
            backend = "cpu:gloo,cuda:nccl"
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method="env://")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return world, resolve_device(device)


def _params_from_rank0(conf, timeout: float, device):
    """A world of several ranks: rank 0 disseminates on its own device
    (``_params_from_dissemination``), then every leaf goes from rank 0 to
    every rank with ``torch.distributed.broadcast`` on the default group
    (on ``device``: the card under nccl, the CPU under gloo).  Returns
    (params, cfg, timings) on every rank; the timings are rank 0's."""
    import torch
    import torch.distributed as dist

    from ..models.sharded import tree_leaves, tree_unflatten

    if dist.get_rank() == 0:
        params, mcfg, summary = _params_from_dissemination(conf, timeout,
                                                           device)
        leaves = list(tree_leaves(params))
        meta = [summary, [(path, tuple(t.shape), str(t.dtype).split(".")[-1])
                          for path, t in leaves]]
    else:
        mcfg = _model_config(conf.model)
        meta = [None, None]
    t0 = time.monotonic()
    dist.broadcast_object_list(meta, src=0)
    summary, specs = meta
    if dist.get_rank() == 0:
        tensors = [t.to(device).contiguous() for _, t in leaves]
        del params, leaves
    else:
        tensors = [torch.empty(shape, dtype=getattr(torch, dtype),
                               device=device)
                   for _, shape, dtype in specs]
    for t in tensors:
        # Bytes, not values: every dtype moves alike on gloo and NCCL.
        dist.broadcast(t.reshape(-1).view(torch.uint8), src=0)
    summary = dict(summary, broadcast_s=round(time.monotonic() - t0, 3))
    return (tree_unflatten((path, t) for (path, _, _), t
                           in zip(specs, tensors)), mcfg, summary)


def params_digests(params) -> dict:
    """``{leaf path: digest of its bytes}`` (``utils.integrity``)."""
    import torch

    from ..models.sharded import tree_leaves
    from ..utils import integrity

    return {"/".join(path): integrity.layer_digest(
                t.detach().contiguous().reshape(-1).view(torch.uint8)
                .cpu().numpy())
            for path, t in tree_leaves(params)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("-f", type=str, required=True,
                   help="topology JSON with a Model section")
    p.add_argument("-steps", type=int, default=10)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-batch", type=int, default=0,
                   help="global batch (default: 2*dp)")
    p.add_argument("-seq", type=int, default=0,
                   help="sequence length (default: 8*sp)")
    p.add_argument("-ckpt", type=str, default="",
                   help="save the final (params, opt) state here")
    p.add_argument("-resume", action="store_true",
                   help="restore state from -ckpt instead of "
                        "disseminating; continues the trajectory exactly")
    p.add_argument("-t", type=float, default=600.0,
                   help="dissemination timeout seconds")
    p.add_argument("-device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("-params-digest", action="store_true",
                   help="log a digest of every local parameter shard as "
                        "training starts (\"training params placed\")")
    p.add_argument("-v", action="store_true")
    args = p.parse_args(argv)
    ulog.configure(node="train", verbose=args.v)

    conf = cfg_mod.read_json(args.f)
    if not conf.model:
        raise SystemExit("training needs a Model section in the topology")
    if args.resume and not args.ckpt:
        raise SystemExit("-resume needs -ckpt")

    from ..models.sharded import (
        build_adamw_train_step,
        example_batch,
        factor_mesh_axes,
        init_adamw_state,
        make_train_mesh,
        shard_params,
        tree_leaves,
        tree_unflatten,
    )
    from ..models.train_ckpt import restore_train_state, save_train_state
    from ..utils.device import synchronize

    world, dev = _init_world(args.device)
    if args.resume:
        mcfg = _model_config(conf.model)
        mesh = make_train_mesh(world, mcfg)
        params, opt = restore_train_state(args.ckpt, mcfg, mesh, dev)
        summary: dict = {"resumed_step": int(opt["step"])}
        log.info("training state restored", step=summary["resumed_step"])
    else:
        if world > 1:
            params, mcfg, summary = _params_from_rank0(conf, args.t, dev)
        else:
            params, mcfg, summary = _params_from_dissemination(conf, args.t,
                                                               dev)
        mesh = make_train_mesh(world, mcfg)
        params = tree_unflatten(
            (path, x.to(dev))
            for path, x in tree_leaves(shard_params(params, mesh, mcfg)))
        opt = init_adamw_state(params)

    if args.params_digest:
        log.info("training params placed", rank=mesh.rank, world=world,
                 coords=mesh.coords, digests=params_digests(params))
    step = build_adamw_train_step(mcfg, mesh, lr=args.lr)
    inputs, targets = example_batch(mcfg, mesh, batch=args.batch,
                                    seq=args.seq, device=dev)
    if dev.type == "cuda":
        import torch

        from ..ops import flash_attention

        flash_attention.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    t0 = time.monotonic()
    for _ in range(args.steps):
        t_step = time.monotonic()
        params, opt, loss = step(params, opt, inputs, targets)
        losses.append(round(float(loss), 4))  # waits for the step
        step_s.append(round(time.monotonic() - t_step, 6))
    synchronize(dev)
    train_s = time.monotonic() - t0
    ran = {}
    if dev.type == "cuda":
        ran = dict(peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                   attention_launches_by_kernel=dict(
                       flash_attention.launches_by_kernel),
                   attention_launches_by_device={
                       d: dict(n) for d, n in
                       flash_attention.launches_by_device.items()})
    log.info("training ran", rank=mesh.rank, device=str(dev),
             steps=args.steps, losses=losses, step_s=step_s, **ran)

    if args.ckpt:
        save_train_state(args.ckpt, params, opt, mesh)
        summary["ckpt"] = args.ckpt
    summary.update({
        "mesh": factor_mesh_axes(world, mcfg),
        "steps": args.steps,
        "final_step": int(opt["step"]),
        "losses": losses,
        "step_s": step_s,
        "train_s": round(train_s, 3),
    })
    if mesh.rank == 0:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
