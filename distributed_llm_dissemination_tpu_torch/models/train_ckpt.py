"""Sharded training-state checkpointing: (params, AdamW state) per rank.

Port of the JAX package's ``models/train_ckpt.py``, which saves with
orbax; the port has no orbax.  A checkpoint is a directory holding one
``torch.save`` file per rank, ``rank<r>-of-<w>.pt``, with that rank's
shards of every leaf (paths as ``tree_leaves`` gives them), the step
counter and the mesh it was written under.

- The write is atomic: every rank writes into ``<path>.tmp``, then rank 0
  renames it to ``path`` (an older checkpoint there is moved aside first
  and removed after).  A crash leaves ``path`` as it was.
- Every leaf keeps its dtype.
- The restore target (structure, local shapes, dtypes) is built from the
  config and the mesh, not trusted from disk; a checkpoint whose mesh,
  structure, shapes or dtypes disagree raises ``ValueError``.  A restore
  therefore needs the mesh the checkpoint was written under.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh
from ..utils.device import resolve_device
from .llama import ModelConfig
from .sharded import (adamw_state_specs, local_shape, param_shapes,
                      tree_leaves, tree_unflatten)

FORMAT = 1


def _file(path: str, mesh: Mesh) -> str:
    return os.path.join(path, f"rank{mesh.rank:05d}-of-{mesh.world:05d}.pt")


def _barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


def _target(cfg: ModelConfig, mesh: Mesh) -> Dict[str, Tuple[tuple, Any]]:
    """``{"params/...": (local shape, dtype), "opt/m/...": ...}``."""
    shapes = dict(tree_leaves(param_shapes(cfg)))
    state_specs = adamw_state_specs(cfg)
    out = {}
    for path, spec in tree_leaves(state_specs["m"]):
        shape = local_shape(shapes[path], spec, mesh)
        out["/".join(("params",) + path)] = (shape, cfg.dtype)
        for moment in ("m", "v"):
            out["/".join(("opt", moment) + path)] = (shape, torch.float32)
    out["opt/step"] = ((), torch.int32)
    return out


def save_train_state(path: str, params, opt_state, mesh: Mesh) -> None:
    """Write this rank's shards of ``{params, opt}`` (module docstring).
    Every rank of ``mesh`` calls it."""
    tmp = path + ".tmp"
    if mesh.rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier(mesh)
    leaves = {"/".join(("params",) + p): x.detach()
              for p, x in tree_leaves(params)}
    leaves.update({"/".join(("opt",) + p): x.detach()
                   for p, x in tree_leaves(opt_state)})
    record = {"format": FORMAT, "mesh": dict(mesh.shape), "rank": mesh.rank,
              "world": mesh.world, "leaves": leaves}
    dst = _file(tmp, mesh)
    torch.save(record, dst + ".part")
    os.replace(dst + ".part", dst)
    _barrier(mesh)
    if mesh.rank == 0:
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier(mesh)


def restore_train_state(path: str, cfg: ModelConfig, mesh: Mesh,
                        device=None):
    """``(params, opt_state)`` of this rank, on ``device`` (None = the CUDA
    card), ready for ``build_adamw_train_step``; raises ``ValueError`` when
    the checkpoint does not match ``cfg`` and ``mesh``."""
    dev = resolve_device(device)
    src = _file(path, mesh)
    if not os.path.exists(src):
        raise ValueError(f"{path}: no shard file for rank {mesh.rank} of "
                         f"{mesh.world}")
    record = torch.load(src, map_location=dev, weights_only=True)
    if record.get("format") != FORMAT or record.get("mesh") != dict(
            mesh.shape):
        raise ValueError(f"{path}: written under mesh {record.get('mesh')} "
                         f"(format {record.get('format')}), restoring onto "
                         f"{dict(mesh.shape)}")
    leaves = record["leaves"]
    want = _target(cfg, mesh)
    if set(leaves) != set(want):
        raise ValueError(f"{path}: leaves {sorted(set(leaves) ^ set(want))} "
                         f"differ from {cfg.name}'s training state")
    for key, (shape, dtype) in want.items():
        got = leaves[key]
        if tuple(got.shape) != tuple(shape) or got.dtype != dtype:
            raise ValueError(f"{path}: {key} is {tuple(got.shape)} "
                             f"{got.dtype}, {cfg.name} needs {tuple(shape)} "
                             f"{dtype}")
    state = tree_unflatten((tuple(k.split("/")), v) for k, v in leaves.items())
    return state["params"], state["opt"]
