"""Named-axis collectives over a ``parallel.mesh.Mesh``, differentiable.

The JAX package's training step runs as one manual ``shard_map`` program
whose collectives name mesh axes (``models/sharded.py``,
``parallel/ring_attention.py``).  These are their counterparts:

- ``psum(x, axes)``: ``lax.psum`` -- the sum over every rank of this
  rank's slice of each named axis;
- ``ppermute(x, axis, perm)``: ``lax.ppermute`` -- ``perm`` is a list of
  ``(source, destination)`` axis coordinates; a rank that receives
  nothing gets zeros;
- ``all_gather(x, axis)``: ``lax.all_gather`` (untiled) -- every member's
  ``x`` stacked along a new leading dimension, in axis order;
- ``axis_index(axis)``, ``axis_size(axis)``: ``lax.axis_index`` and the
  JAX package's ``parallel/compat.axis_size``.

They run inside ``manual(mesh)``, the counterpart of the ``shard_map``
body: the mesh there names the axes.  On an axis of size 1 each
collective is the identity, as in ``lax``, and touches no process group.

Gradients follow JAX's AD under ``shard_map(..., check_vma=False)``, the
mode the JAX step runs in, so the step's loss-share scheme (each rank's
loss divided by dp*sp*tp*ep) gives the same gradients:

- the transpose of ``psum`` is ``psum`` of the cotangent over the same
  axes (not the identity: with ``check_vma=False`` JAX treats every value
  as varying per device);
- the transpose of ``ppermute`` is ``ppermute`` by the inverse
  permutation;
- the transpose of ``all_gather`` is ``psum_scatter``: the cotangent
  summed over the axis, this member's slice kept.

Each is a ``torch.autograd.Function`` whose backward issues the
collective of its transpose, so every rank must run the same backward.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

Axes = Union[str, Sequence[str]]

_mesh = None  # the mesh of the running manual program


@contextlib.contextmanager
def manual(mesh: Mesh):
    """Run the block as the body of a manual program over ``mesh``: the
    collectives below name its axes.  A plain module global, not a
    thread-local: autograd may run a backward on its own thread, and each
    ``Function`` keeps the mesh it ran under anyway."""
    global _mesh
    prev, _mesh = _mesh, mesh
    try:
        yield mesh
    finally:
        _mesh = prev


def current() -> Mesh:
    if _mesh is None:
        raise RuntimeError("named-axis collectives run inside "
                           "parallel.axes.manual(mesh)")
    return _mesh


def axis_index(axis: str) -> int:
    return current().axis_index(axis)


def axis_size(axis: str) -> int:
    return current().axis_size(axis)


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _live(mesh: Mesh, axes: Iterable[str]) -> List[str]:
    return [a for a in axes if mesh.axis_size(a) > 1]


def _all_reduce(x: torch.Tensor, axes: Sequence[str], mesh: Mesh):
    out = x.contiguous().clone()
    for a in axes:  # one axis at a time: the sum over their product
        dist.all_reduce(out, group=mesh.group(a)[0])
    return out


def _permute(x: torch.Tensor, axis: str, perm, mesh: Mesh) -> torch.Tensor:
    group, members = mesh.group(axis)
    me = mesh.axis_index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me == dst:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, members[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, members[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _gather(x: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis)[0])
    return torch.stack(parts)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return _all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, ctx.mesh), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _permute(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.axis, inverse, ctx.mesh), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _gather(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        summed = _all_reduce(g, [ctx.axis], ctx.mesh)
        return summed[ctx.mesh.axis_index(ctx.axis)], None, None


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """``lax.psum(x, axes)`` (module docstring)."""
    mesh = current()
    live = _live(mesh, _names(axes))
    return _PSum.apply(x, live, mesh) if live else x


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)`` (module docstring)."""
    mesh = current()
    perm = [(int(s), int(d)) for s, d in perm]
    if mesh.axis_size(axis) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, axis, perm, mesh)


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.all_gather(x, axis)``: [axis_size, *x.shape]."""
    mesh = current()
    if mesh.axis_size(axis) == 1:
        return x[None]
    return _AllGather.apply(x, axis, mesh)
