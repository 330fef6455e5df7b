"""Sharded training-state checkpointing: (params, AdamW state) per rank.

Port of the JAX package's ``models/train_ckpt.py``, which saves with
orbax; the port has no orbax.  A checkpoint is a directory holding one
``torch.save`` file per rank, ``rank<r>-of-<w>.pt``, with that rank's
shards of every leaf (paths as ``tree_leaves`` gives them), each leaf's
spec, the step counter and the mesh it was written under.

- The write is atomic: every rank writes into ``<path>.tmp``, then rank 0
  renames it to ``path`` (an older checkpoint there is moved aside first
  and removed after).  A crash leaves ``path`` as it was.
- Every leaf keeps its dtype.
- The restore target (structure, local shapes, dtypes) is built from the
  config and the mesh, not trusted from disk; a checkpoint whose
  structure, shapes or dtypes disagree raises ``ValueError``.
- A restore onto another mesh assembles this rank's slice of each leaf
  from the files that hold it, by the writer's mesh and the leaf's spec
  (the JAX package restores "under a different topology" the same way,
  into shardings built from the config).  A format-1 checkpoint, which
  records no specs, restores onto its own mesh only.
"""

from __future__ import annotations

import glob
import math
import os
import re
import shutil
from types import SimpleNamespace
from typing import Dict

import numpy as np

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh
from ..utils.device import resolve_device
from .llama import ModelConfig
from .sharded import (adamw_state_specs, local_shape, param_shapes,
                      param_specs, shard_slices, tree_leaves, tree_unflatten)

FORMAT = 2  # 1: no leaf specs (restores onto its own mesh only)
_RANK_FILE = re.compile(r"rank(\d{5})-of-(\d{5})\.pt$")


def _file(path: str, mesh: Mesh) -> str:
    return os.path.join(path, f"rank{mesh.rank:05d}-of-{mesh.world:05d}.pt")


def _barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


class _Coords:
    """A mesh's axis sizes and one rank's coordinates on them: what
    ``shard_slices`` reads of a ``Mesh``, for a rank of the writer's."""

    def __init__(self, shape: Dict[str, int], rank: int):
        self.shape = dict(shape)
        coords = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = dict(zip(self.shape, (int(c) for c in coords)))

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        return self.coords[name]


def _target(cfg: ModelConfig, mesh: Mesh):
    """``{"params/...": (full shape, spec, local shape, dtype), "opt/m/...":
    ...}``; raises ``ValueError`` when ``mesh`` cannot split ``cfg``."""
    shapes = dict(tree_leaves(param_shapes(cfg)))
    state_specs = adamw_state_specs(cfg)
    out = {}
    for path, spec in tree_leaves(state_specs["m"]):
        full = shapes[path]
        shape = local_shape(full, spec, mesh)
        out["/".join(("params",) + path)] = (full, spec, shape, cfg.dtype)
        for moment in ("m", "v"):
            out["/".join(("opt", moment) + path)] = (full, spec, shape,
                                                     torch.float32)
    out["opt/step"] = ((), (), (), torch.int32)
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
    # The specs follow the tree: they depend on the config only through
    # whether its layers route to experts.
    moe = SimpleNamespace(n_experts=int("router" in params["layers"]))
    specs = {"/".join(("params",) + p): spec
             for p, spec in tree_leaves(param_specs(moe))}
    specs.update({"opt/" + m + k[len("params"):]: spec
                  for k, spec in list(specs.items()) for m in ("m", "v")})
    specs["opt/step"] = ()
    record = {"format": FORMAT, "mesh": dict(mesh.shape), "rank": mesh.rank,
              "world": mesh.world, "specs": specs, "leaves": leaves}
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


def _rank_files(path: str) -> Dict[int, str]:
    """``{rank: file}`` of the checkpoint at ``path``; raises
    ``ValueError`` unless it holds one file for every rank of one world."""
    found = {}
    worlds = set()
    for f in glob.glob(os.path.join(path, "rank*-of-*.pt")):
        m = _RANK_FILE.search(f)
        if m:
            found[int(m.group(1))] = f
            worlds.add(int(m.group(2)))
    if len(worlds) != 1:
        raise ValueError(f"{path}: no shard file for one world "
                         f"(worlds {sorted(worlds)})")
    world = worlds.pop()
    missing = sorted(set(range(world)) - set(found))
    if missing:
        raise ValueError(f"{path}: no shard file for ranks {missing} of "
                         f"{world}")
    return found


def _check_leaves(path: str, cfg: ModelConfig, leaves, want) -> None:
    if set(leaves) != set(want):
        raise ValueError(f"{path}: leaves {sorted(set(leaves) ^ set(want))} "
                         f"differ from {cfg.name}'s training state")
    for key, (shape, dtype) in want.items():
        got = leaves[key]
        if tuple(got.shape) != tuple(shape) or got.dtype != dtype:
            raise ValueError(f"{path}: {key} is {tuple(got.shape)} "
                             f"{got.dtype}, {cfg.name} needs {tuple(shape)} "
                             f"{dtype}")


def _global_slices(full, spec, mesh):
    """A shard's ``[start, stop)`` in the full leaf, per dimension."""
    return [(s.start or 0, n if s.stop is None else s.stop)
            for s, n in zip(shard_slices(full, spec, mesh), full)]


def _overlap(mine, theirs):
    """Where two shards of one leaf meet, as index tuples into each, or
    None when they do not."""
    a_idx, b_idx = [], []
    for (a0, a1), (b0, b1) in zip(mine, theirs):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        a_idx.append(slice(lo - a0, hi - a0))
        b_idx.append(slice(lo - b0, hi - b0))
    return tuple(a_idx), tuple(b_idx)


def restore_train_state(path: str, cfg: ModelConfig, mesh: Mesh,
                        device=None):
    """``(params, opt_state)`` of this rank, on ``device`` (None = the CUDA
    card), ready for ``build_adamw_train_step``, whatever mesh wrote the
    checkpoint (module docstring); raises ``ValueError`` when it does not
    match ``cfg`` or ``mesh`` cannot split ``cfg``."""
    dev = resolve_device(device)
    target = _target(cfg, mesh)
    files = _rank_files(path)
    if len(files) == mesh.world:
        record = torch.load(files[mesh.rank], map_location=dev,
                            weights_only=True)
        if (record.get("format") in (1, FORMAT)
                and record.get("mesh") == dict(mesh.shape)):
            # The writer's mesh: this rank's own file holds its slices.
            _check_leaves(path, cfg, record["leaves"],
                          {k: t[2:] for k, t in target.items()})
            return _unflatten(record["leaves"])
        del record
    # Another mesh: copy this rank's slice of each leaf out of every
    # writer's shard that holds part of it.
    out = {k: torch.empty(t[2], dtype=t[3]) for k, t in target.items()}
    for rank in sorted(files):
        record = torch.load(files[rank], map_location="cpu",
                            weights_only=True)
        stored = record.get("mesh")
        if record.get("format") != FORMAT:
            raise ValueError(f"{path}: a format-{record.get('format')} "
                             f"checkpoint written under mesh {stored} "
                             f"restores onto that mesh only, not "
                             f"{dict(mesh.shape)}")
        if math.prod(stored.values()) != len(files):
            raise ValueError(f"{path}: mesh {stored} needs "
                             f"{math.prod(stored.values())} shard files, "
                             f"the checkpoint has {len(files)}")
        theirs = _Coords(stored, rank)
        specs = {k: tuple(v) for k, v in record["specs"].items()}
        if set(specs) != set(target):
            raise ValueError(f"{path}: leaves "
                             f"{sorted(set(specs) ^ set(target))} differ "
                             f"from {cfg.name}'s training state")
        _check_leaves(path, cfg, record["leaves"], {
            k: (local_shape(t[0], specs[k], theirs), t[3])
            for k, t in target.items()})
        for key, (full, spec, _, _) in target.items():
            hit = _overlap(_global_slices(full, spec, mesh),
                           _global_slices(full, specs[key], theirs))
            if hit is not None:
                out[key][hit[0]] = record["leaves"][key][hit[1]]
    return _unflatten({k: v.to(dev) for k, v in out.items()})


def _unflatten(leaves):
    state = tree_unflatten((tuple(k.split("/")), v) for k, v in leaves.items())
    return state["params"], state["opt"]
