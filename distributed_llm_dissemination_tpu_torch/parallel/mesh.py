"""Named meshes: ranks for training, device slots for the fabric; and
Assignment → pipeline-stage placement.

Port of the JAX package's ``parallel/mesh.py``.

Two meshes live here:

- ``Mesh``: named axes over ``torch.distributed`` ranks, filled row-major
  as JAX fills its device array, with one process group per slice of
  each axis (the ranks that differ only in that axis's coordinate).
  ``axis_index(name)``/``axis_size(name)`` are this rank's coordinate and
  the axis's length; ``group(name)`` the process group of this rank's
  slice.  An axis of size 1 needs no group, so one process on one card
  builds a mesh without ``torch.distributed``.  Training's named-axis
  collectives (``parallel/axes.py``) run over it.
- ``DeviceMesh``: named axes over device SLOTS, the single controller's
  counterpart of JAX's devices.  A ``Slot`` is a mesh position with the
  ``torch.device`` it runs on.  By default slot i runs on card ``i mod
  n_cards`` of the host (``slot_devices``): JAX's row-major fill of
  ``jax.devices()``, except that a mesh with more slots than cards
  repeats cards where JAX raises, so one card still runs every mesh.
  Devices may therefore repeat (every slot is ``cpu`` on the CPU, and
  ``cuda:k`` when pinned to card k), so stage identity is the slot's
  index, never ``torch.device`` equality.  The fabric's collectives
  (``parallel/collectives.py``) move bytes between slots: a copy within
  a card, a peer copy between cards.

``make_mesh(sizes, names)`` builds a rank ``Mesh``;
``make_mesh(sizes, names, devices=...)`` a ``DeviceMesh`` over those
devices (or slots).

The placement half: the ``Assignment`` (node → layers) is a pipeline-stage
placement map.  Nodes are ranked by their minimum assigned layer id, so
contiguous layer ranges land on consecutive stages of the mesh's
pipeline axis; ``fabric_placement`` also gives every non-assignee fabric
participant (seeders, the leader) a stage to contribute from.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import Assignment, LayerID, NodeID
from ..utils.device import resolve_device


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


@dataclasses.dataclass(frozen=True)
class Slot:
    """One position of a ``DeviceMesh``: ``index`` (the slot's identity:
    its flat row-major position, or its owner's rank in a multi-process
    layout), the ``device`` it runs on, and ``process_index``, the rank
    of the process that owns it (0 under a single controller; JAX:
    ``Device.process_index``).  Slots compare by all three, so two slots
    on one device are distinct stage members, as two of JAX's virtual
    devices are."""

    index: int
    device: torch.device
    process_index: int = 0

    def __repr__(self) -> str:
        if self.process_index:
            return f"Slot({self.index}, {self.device}, p{self.process_index})"
        return f"Slot({self.index}, {self.device})"


def P(*names) -> Tuple[Optional[str], ...]:
    """A partition spec: one mesh axis name (or None) per array dimension;
    ``P()`` replicates."""
    return tuple(names)


class DeviceMesh:
    """Named axes over device slots (module docstring).  ``devices`` is the
    numpy object array of ``Slot`` s, as JAX's ``Mesh.devices``;
    ``shape`` maps each axis name to its size, in order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d slot array for "
                             f"{len(self.axis_names)} axis names")
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def slots(self) -> List[Slot]:
        """Every slot, row-major."""
        return list(self.devices.reshape(-1))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_slots(self, axis: str) -> List[List[Slot]]:
        """The slots grouped by their coordinate on ``axis``: entry ``i``
        holds every slot whose ``axis`` coordinate is ``i``."""
        k = self.axis_names.index(axis)
        return [list(np.take(self.devices, [i], axis=k).reshape(-1))
                for i in range(self.shape[axis])]

    def __eq__(self, other) -> bool:
        return (isinstance(other, DeviceMesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.slots == other.slots)

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(self.slots)))

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {self.slots})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a value lives: a mesh's slots plus a partition spec (``P()``
    = one copy per slot).  The counterpart of JAX's ``NamedSharding``."""

    mesh: DeviceMesh
    spec: Tuple[Optional[str], ...] = ()

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None for a in self.spec)


def slot_devices(n_slots: int, n_cards: int,
                 device=None) -> List[torch.device]:
    """Where each of ``n_slots`` mesh slots runs on a host with
    ``n_cards`` CUDA cards (a pure function: no CUDA call).  ``device``
    None or ``"cuda"``: slot i on ``cuda:(i mod n_cards)``, the cards in
    order, repeated when the mesh has more slots than cards; ``"cuda:k"``:
    every slot on card k; ``"cpu"``: every slot on the CPU.  Raises for a
    CUDA slot on a host without a card, or a card the host lacks."""
    device = getattr(device, "device", device)  # a Slot: its device
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cpu":
        return [dev] * n_slots
    if dev is not None and dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n_cards < 1:
        raise RuntimeError(
            "mesh slots on CUDA cards were asked for (device=None means "
            "cuda) but the host has none; pass device='cpu' explicitly "
            "for a CPU run")
    if dev is None or dev.index is None:
        return [torch.device("cuda", i % n_cards) for i in range(n_slots)]
    if dev.index >= n_cards:
        raise ValueError(f"{dev} pinned, but the host has {n_cards} cards")
    return [dev] * n_slots


def device_slots(n: int, device=None) -> List[torch.device]:
    """``n`` slot devices on this host (``slot_devices`` with the host's
    card count): the cards in order for None or ``"cuda"``, one card for
    ``"cuda:k"``, the CPU for ``"cpu"``."""
    dev = getattr(device, "device", device)
    if dev is not None and torch.device(dev).type == "cpu":
        return slot_devices(n, 0, dev)
    resolve_device(dev)  # raises, naming device='cpu', without a card
    return slot_devices(n, torch.cuda.device_count(), dev)


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None):
    """Without ``devices``: a ``Mesh`` over the ranks of the default
    process group.  With ``devices`` (torch devices, device strings or
    ``Slot`` s): a ``DeviceMesh`` over the first prod(axis_sizes) of them,
    filled row-major; plain devices become slots numbered by position."""
    if devices is None:
        return Mesh(axis_sizes, axis_names)
    devices = list(devices)
    need = int(np.prod(axis_sizes))
    if len(devices) < need:
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {need} devices, "
                         f"have {len(devices)}")
    slots = [d if isinstance(d, Slot) else Slot(i, resolve_device(d))
             for i, d in enumerate(devices[:need])]
    arr = np.empty(need, dtype=object)
    arr[:] = slots
    return DeviceMesh(arr.reshape(tuple(axis_sizes)), axis_names)


def mesh_from_conf(conf, devices: Optional[Sequence] = None) -> DeviceMesh:
    """The ``Mesh`` section's slot mesh; ``devices`` default: the host's
    cards in order (``device_slots``)."""
    if devices is None:
        devices = device_slots(int(np.prod(conf.axis_sizes)))
    return make_mesh(conf.axis_sizes, conf.axis_names, devices)


@dataclasses.dataclass
class StagePlacement:
    """Node → (pipeline-stage index, slots) mapping derived from an
    Assignment.  A stage is the mesh sliced at one coordinate of
    ``pipeline_axis``, keeping every other axis."""

    mesh: DeviceMesh
    pipeline_axis: str
    node_to_stage: Dict[NodeID, int]
    layer_to_stage: Dict[LayerID, int]
    _stage_meshes: Dict[int, DeviceMesh] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_stages(self) -> int:
        return self.mesh.shape[self.pipeline_axis]

    def stage_devices(self, stage: int) -> List[Slot]:
        return self.mesh.axis_slots(self.pipeline_axis)[stage]

    def devices_for_node(self, node_id: NodeID) -> List[Slot]:
        return self.stage_devices(self.node_to_stage[node_id])

    def devices_for_layer(self, layer_id: LayerID) -> List[Slot]:
        return self.stage_devices(self.layer_to_stage[layer_id])

    def stage_mesh(self, stage: int) -> DeviceMesh:
        """Sub-mesh of one pipeline stage: the mesh with the pipeline axis
        sliced away, keeping every other axis (a 1-axis mesh keeps its
        axis, one slot long)."""
        cached = self._stage_meshes.get(stage)
        if cached is not None:
            return cached
        k = self.mesh.axis_names.index(self.pipeline_axis)
        devs = np.take(self.mesh.devices, stage, axis=k)
        names = tuple(n for n in self.mesh.axis_names
                      if n != self.pipeline_axis)
        if not names:
            arr = np.empty(1, dtype=object)
            arr[0] = devs.item() if isinstance(devs, np.ndarray) else devs
            devs, names = arr, (self.pipeline_axis,)
        self._stage_meshes[stage] = DeviceMesh(devs, names)
        return self._stage_meshes[stage]

    def layer_sharding(self, layer_id: LayerID, spec=P()) -> Sharding:
        """Where a layer lands: its stage's slots only (default: one copy
        per slot), absent everywhere else."""
        return Sharding(self.stage_mesh(self.layer_to_stage[layer_id]), spec)


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
    assignment: Assignment, mesh=None, pipeline_axis: str = "nodes",
) -> StagePlacement:
    """Map each assigned node to a pipeline stage of ``mesh``.

    ``mesh``: a ``DeviceMesh``; or a list of devices (None = the CUDA
    card): one device gives a 1-axis mesh with one slot per assignee on
    it (the one-card form), several give a 1-axis mesh over them.
    Requires len(assignment) <= mesh.shape[pipeline_axis]."""
    if not isinstance(mesh, DeviceMesh):
        devs = [resolve_device(d) for d in (mesh if mesh is not None
                                             else [None])]
        if len(devs) == 1:
            devs = devs * max(1, len(assignment))
        mesh = make_mesh((len(devs),), (pipeline_axis,), devs)
    n_stages = mesh.shape[pipeline_axis]
    if len(assignment) > n_stages:
        raise ValueError(
            f"assignment has {len(assignment)} nodes but mesh axis "
            f"'{pipeline_axis}' has only {n_stages} stages")
    node_to_stage = {
        node_id: stage
        for stage, node_id in enumerate(ranked_assignees(assignment))
    }
    layer_to_stage = {
        layer_id: node_to_stage[node_id]
        for node_id, layers in assignment.items()
        for layer_id in layers
    }
    return StagePlacement(mesh=mesh, pipeline_axis=pipeline_axis,
                          node_to_stage=node_to_stage,
                          layer_to_stage=layer_to_stage)


def fabric_placement(node_ids, assignment: Assignment, mesh: DeviceMesh,
                     pipeline_axis: str = "nodes") -> StagePlacement:
    """Placement covering EVERY fabric participant, not just assignees:
    a seeder's planned byte range enters the fabric from its own stage's
    slots.  Assignees keep the assignment-derived stage order; the other
    nodes (seeders, the leader) fill the leftover stages in id order, and
    share stages round-robin when there are more of them than free stages
    (with a warning: a multi-host deployment sizes the pipeline axis to
    the cluster)."""
    placement = assignment_to_placement(assignment, mesh, pipeline_axis)
    extras = sorted(set(node_ids) - set(placement.node_to_stage))
    if not extras:
        return placement
    taken = set(placement.node_to_stage.values())
    free = [s for s in range(placement.num_stages) if s not in taken]
    slots = free or list(range(placement.num_stages))
    if len(extras) > len(free):
        warnings.warn(
            f"{len(extras)} non-assignee fabric nodes share "
            f"{len(slots)} stages; size the mesh pipeline axis to the "
            f"cluster for multi-host runs", stacklevel=2)
    for i, node_id in enumerate(extras):
        placement.node_to_stage[node_id] = slots[i % len(slots)]
    return placement
