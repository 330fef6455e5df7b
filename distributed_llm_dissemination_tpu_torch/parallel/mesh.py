"""Assignment → pipeline-stage placement on torch devices.

Port of the placement half of the JAX package's ``parallel/mesh.py``.  The
``Assignment`` (node → layers) is a pipeline-stage placement map: nodes
are ranked by their minimum assigned layer id, so contiguous layer ranges
land on consecutive stages.  Where the JAX package slices a
``jax.sharding.Mesh`` along its pipeline axis, a stage here is a plain
list of torch devices; with one card there is one stage device list and
every stage maps onto it.

The mesh half (``make_mesh``, ``stage_mesh``, ``layer_sharding``: one
layer replicated over a stage's devices through XLA shardings) waits for
the device-fabric slice and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.types import Assignment, LayerID, NodeID
from ..utils.device import resolve_device

_FABRIC_SLICE = ("multi-device stage meshes and layer shardings wait for the "
                 "device-fabric slice (ROADMAP, port Queue 1 item 12)")


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
