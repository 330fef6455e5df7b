"""Named device meshes, and Assignment → pipeline-stage placement on torch
devices.

Port of the JAX package's ``parallel/mesh.py``.

The mesh half: ``make_mesh(axis_sizes, axis_names)`` builds a ``Mesh``
over ``torch.distributed`` ranks, filled row-major as JAX fills its
device array, with one process group per slice of each axis (the ranks
that differ only in that axis's coordinate).  ``axis_index(name)`` and
``axis_size(name)`` are this rank's coordinate and the axis's length;
``group(name)`` the process group of this rank's slice.  An axis of size
1 needs no group, so one process on one card builds a mesh without
``torch.distributed``; an axis larger than 1 needs an initialised
process group of exactly the mesh's size and raises otherwise.  The
named-axis collectives over these groups are ``parallel/axes.py``.

The placement half: the
``Assignment`` (node → layers) is a pipeline-stage placement map: nodes
are ranked by their minimum assigned layer id, so contiguous layer ranges
land on consecutive stages.  Where the JAX package slices a
``jax.sharding.Mesh`` along its pipeline axis, a stage here is a plain
list of torch devices; with one card there is one stage device list and
every stage maps onto it.  ``stage_mesh`` and ``layer_sharding`` (one
layer replicated over a stage's devices through XLA shardings) wait for
the device-fabric slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import Assignment, LayerID, NodeID
from ..utils.device import resolve_device

_FABRIC_SLICE = ("multi-device stage meshes and layer shardings wait for the "
                 "device-fabric slice (ROADMAP, port Queue 1 item 6)")


class Mesh:
    """Named axes over ``torch.distributed`` ranks (``make_mesh``).
    ``shape`` maps each axis name to its size, in order, as JAX's
    ``Mesh.shape`` does; ``rank``/``world`` are this process's rank and
    the number of ranks (1 and 1 without ``torch.distributed``)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for "
                             f"{len(axis_names)} axis names")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in axis_sizes)))
        need = math.prod(self.shape.values())
        if need == 1:
            self.rank, self.world = 0, 1
        else:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    f"mesh {self.shape} spans {need} ranks: initialise a "
                    f"torch.distributed process group of {need} ranks first")
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            if self.world != need:
                raise ValueError(f"mesh {self.shape} needs {need} ranks, the "
                                 f"process group has {self.world}")
        ranks = np.arange(need).reshape(tuple(self.shape.values()))
        self.coords = {name: int(c) for name, c in zip(
            self.axis_names, np.unravel_index(self.rank, ranks.shape))}
        # One group per slice of each axis larger than 1.  Every rank
        # creates every group, in the same order (new_group's rule).
        self._groups: Dict[str, Tuple[object, List[int]]] = {}
        for i, name in enumerate(self.axis_names):
            if self.shape[name] == 1:
                continue
            for row in np.moveaxis(ranks, i, -1).reshape(-1, self.shape[name]):
                members = [int(r) for r in row]
                group = dist.new_group(members)
                if self.rank in members:
                    self._groups[name] = (group, members)

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def group(self, name: str):
        """``(process group, global ranks by axis coordinate)`` of this
        rank's slice of axis ``name`` (an axis larger than 1)."""
        if name not in self._groups:
            raise ValueError(f"axis {name!r} of size {self.shape[name]} has "
                             f"no process group")
        return self._groups[name]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A ``Mesh`` over the ranks of the default process group (row-major
    fill; module docstring)."""
    return Mesh(axis_sizes, axis_names)


@dataclasses.dataclass
class StagePlacement:
    """Node → (pipeline-stage index, devices) mapping derived from an
    Assignment.  ``stages[s]`` is stage ``s``'s device list."""

    stages: List[List[torch.device]]
    node_to_stage: Dict[NodeID, int]
    layer_to_stage: Dict[LayerID, int]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def stage_devices(self, stage: int) -> List[torch.device]:
        return list(self.stages[stage])

    def devices_for_node(self, node_id: NodeID) -> List[torch.device]:
        return self.stage_devices(self.node_to_stage[node_id])

    def devices_for_layer(self, layer_id: LayerID) -> List[torch.device]:
        return self.stage_devices(self.layer_to_stage[layer_id])

    def stage_mesh(self, stage: int):
        raise NotImplementedError(_FABRIC_SLICE)

    def layer_sharding(self, layer_id: LayerID, spec=None):
        raise NotImplementedError(_FABRIC_SLICE)


def ranked_assignees(assignment: Assignment) -> List[NodeID]:
    """Assignees in pipeline-stage order: ranked by each node's minimum
    assigned layer id, so contiguous layer ranges land on consecutive
    stages."""
    ranked: List[Tuple[int, NodeID]] = sorted(
        (min(layers) if layers else 0, node_id)
        for node_id, layers in assignment.items()
    )
    return [node_id for _, node_id in ranked]


def assignment_to_placement(
    assignment: Assignment,
    devices: Optional[Sequence] = None,
) -> StagePlacement:
    """Map each assigned node to a pipeline stage.

    ``devices``: the stage device list (None = the CUDA card).  One list
    means one stage device list that every assignee's stage maps onto:
    on one card the stages share it, as the JAX package's single-device
    mesh does."""
    devs = [resolve_device(d) for d in (devices if devices is not None
                                         else [None])]
    if len(devs) != 1:
        raise NotImplementedError(_FABRIC_SLICE)
    node_to_stage = {
        node_id: stage
        for stage, node_id in enumerate(ranked_assignees(assignment))
    }
    layer_to_stage = {
        layer_id: node_to_stage[node_id]
        for node_id, layers in assignment.items()
        for layer_id in layers
    }
    stages = [list(devs) for _ in range(max(1, len(node_to_stage)))]
    return StagePlacement(stages=stages, node_to_stage=node_to_stage,
                          layer_to_stage=layer_to_stage)
