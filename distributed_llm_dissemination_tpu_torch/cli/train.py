"""Training from a saved state, as one driveable command.

Port of the JAX package's ``cli/train.py``:

    python -m distributed_llm_dissemination_tpu_torch.cli.train \\
        -f conf.json -resume -ckpt /ckpt/run1 -steps 20

With ``-resume`` it restores (params, AdamW state) from ``-ckpt``
(``models.train_ckpt``), runs ``-steps`` AdamW steps of the 5-axis
training step (``models.sharded``, layer rematerialisation, ring
attention through K1) on the seeded batch of ``example_batch``, saves the
state back to ``-ckpt`` and prints the summary JSON (``resumed_step``,
``ckpt``, ``mesh``, ``steps``, ``final_step``, ``losses``, ``train_s``).
The topology's ``Model`` section names the model.

The world is ``torch.distributed``'s: a ``WORLD_SIZE`` above 1 in the
environment (as ``torchrun`` sets it, with ``RANK``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``) initialises the default process group
from it; otherwise the world is this one process.  ``-device`` picks the
device (None = the CUDA card, ``cuda:LOCAL_RANK`` in a larger world); a
machine without a card raises unless ``-device cpu`` is given.

Without ``-resume`` the JAX CLI first disseminates the weights over the
pod fabric (``cli/podrun``); that half waits for the device-fabric slice
and raises ``NotImplementedError``.
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

_FABRIC_SLICE = ("training from disseminated weights (cli/podrun over the "
                 "device fabric) is not ported yet (ROADMAP, port Queue 1 "
                 "item 6); -resume -ckpt trains from a saved state")


def _model_config(name: str):
    from ..models import hf
    from ..models.llama import CONFIGS

    return hf.config_from_name(name) if hf.is_hf(name) else CONFIGS[name]


def _init_world(device):
    """The world size, after initialising the default process group when
    the environment names more than one rank; and this rank's device."""
    import torch
    import torch.distributed as dist

    from ..utils.device import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        dev = torch.device(device or "cuda")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return world, resolve_device(device)


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
    p.add_argument("-v", action="store_true")
    args = p.parse_args(argv)
    ulog.configure(node="train", verbose=args.v)

    conf = cfg_mod.read_json(args.f)
    if not conf.model:
        raise SystemExit("training needs a Model section in the topology")
    if args.resume and not args.ckpt:
        raise SystemExit("-resume needs -ckpt")
    if not args.resume:
        raise NotImplementedError(_FABRIC_SLICE)

    from ..models.sharded import (
        build_adamw_train_step,
        example_batch,
        factor_mesh_axes,
        make_train_mesh,
    )
    from ..models.train_ckpt import restore_train_state, save_train_state
    from ..utils.device import synchronize

    world, dev = _init_world(args.device)
    mcfg = _model_config(conf.model)
    mesh = make_train_mesh(world, mcfg)
    params, opt = restore_train_state(args.ckpt, mcfg, mesh, dev)
    summary: dict = {"resumed_step": int(opt["step"])}
    log.info("training state restored", step=summary["resumed_step"])

    step = build_adamw_train_step(mcfg, mesh, lr=args.lr)
    inputs, targets = example_batch(mcfg, mesh, batch=args.batch,
                                    seq=args.seq, device=dev)
    losses = []
    t0 = time.monotonic()
    for _ in range(args.steps):
        params, opt, loss = step(params, opt, inputs, targets)
        losses.append(round(float(loss), 4))
    synchronize(dev)
    train_s = time.monotonic() - t0
    log.info("training ran", steps=args.steps, losses=losses)

    save_train_state(args.ckpt, params, opt, mesh)
    summary["ckpt"] = args.ckpt
    summary.update({
        "mesh": factor_mesh_axes(world, mcfg),
        "steps": args.steps,
        "final_step": int(opt["step"]),
        "losses": losses,
        "train_s": round(train_s, 3),
    })
    if mesh.rank == 0:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
