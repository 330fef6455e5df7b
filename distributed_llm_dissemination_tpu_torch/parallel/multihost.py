"""Multi-controller process groups: ``torch.distributed`` wiring from the
topology.

Port of the JAX package's ``parallel/multihost.py``.  The reference scales
by one OS process per host, wired by the JSON config; each process only
ever talks TCP.  A multi-controller fabric needs one more layer: every
node process joins ONE ``torch.distributed`` process group, so a plan's
participants can enter one collective.  This module derives that wiring
from the same JSON topology (node list order -> rank, the leader's host ->
coordinator), so a node set needs no extra flags: the config that
describes the cluster also forms the group.

- ``derive_layout``: rank = the node's position in the id-sorted node
  list; coordinator = ``Distributed.Coordinator``, else the leader's host
  on port 8476 (the JAX package's rule, unchanged).
- ``rank_device`` / ``choose_backend``: each rank's device, and the
  group's backend, derived on every process alike from the layout and
  the devices.  One process per CUDA device (one per card of a host)
  runs ``nccl``; ranks that share a device (several processes on one
  card) or run on the CPU run ``gloo``.  Never chosen by catching a
  failed NCCL start.
- ``host_aligned_device_order``: the global slot list ordered so each
  pipeline stage's slots belong to the process that runs the node mapped
  to that stage.  A slot's ``process_index`` is its owner's rank.
- ``maybe_initialize`` / ``maybe_shutdown``: join and leave the group.
- ``send_to`` / ``recv_from``: point-to-point moves of a tensor's bytes
  between two ranks, on the default group (the fabric's plans) or on the
  serve group (``serve_group``: one more group of the whole world, made
  at the join, so the pod serve's hand-offs never pair up with a plan's).
  Under gloo a CUDA tensor is staged through host memory (gloo has no
  point-to-point on CUDA tensors); under nccl it moves as it is.

The JAX package's ``honor_jax_platforms`` has no counterpart: the port's
entry points take ``-device`` (default: the CUDA card), which is what the
JAX CLI reads from ``JAX_PLATFORMS``.

Single-host runs (no ``Distributed`` section) are a clean no-op.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Sequence, Tuple

from ..core.config import Config
from ..core.types import NodeID
from ..utils.logging import log
from .spmd_fabric import PLAN_WAIT_S

# JAX's default coordinator port, kept as the default rendezvous port so
# one config serves both packages.
DEFAULT_COORDINATOR_PORT = 8476

# ``Distributed.CpuCollectives`` values the port accepts: the group's
# collectives on CPU tensors (and on devices that ranks share) run on
# gloo, the only such backend torch ships.
CPU_COLLECTIVES = ("", "gloo")



@dataclasses.dataclass
class ProcessLayout:
    """One node-process's place in the node set's process group."""

    coordinator: str
    num_processes: int
    process_id: int


def derive_layout(conf: Config, my_id: NodeID) -> ProcessLayout:
    """Map this node to a process rank (the JAX package's rule): rank =
    the node's position in the id-sorted node list, identical on every
    host; coordinator = ``Distributed.Coordinator``, else the leader
    node's host on ``DEFAULT_COORDINATOR_PORT``."""
    ids = sorted(nc.id for nc in conf.nodes)
    if my_id not in ids:
        raise ValueError(f"node {my_id} not in config nodes {ids}")
    coordinator = ""
    if conf.distributed is not None:
        coordinator = conf.distributed.coordinator
    if not coordinator:
        from ..core.config import get_leader_conf

        leader_addr = get_leader_conf(conf).addr
        host = leader_addr.rsplit(":", 1)[0] if ":" in leader_addr else leader_addr
        coordinator = f"{host or '127.0.0.1'}:{DEFAULT_COORDINATOR_PORT}"
    return ProcessLayout(
        coordinator=coordinator,
        num_processes=len(ids),
        process_id=ids.index(my_id),
    )


def check_cpu_collectives(conf: Config) -> None:
    """Refuse a ``Distributed.CpuCollectives`` the port cannot honour
    (the JAX package passes it to ``jax_cpu_collectives_implementation``;
    torch's CPU collectives are gloo)."""
    if conf.distributed is None:
        return
    want = conf.distributed.cpu_collectives
    if want not in CPU_COLLECTIVES:
        raise ValueError(
            f"Distributed.CpuCollectives={want!r} is not supported: the "
            "PyTorch port runs CPU collectives on gloo (give \"gloo\" or "
            "leave it empty)")


def _host(addr: str) -> str:
    host = addr.rsplit(":", 1)[0] if ":" in addr else addr
    return host or "127.0.0.1"


def local_rank(conf: Config, rank: int) -> Tuple[int, int]:
    """``(position among the ranks on its host, ranks on that host)`` of
    ``rank``: hosts come from the nodes' addresses."""
    nodes = sorted(conf.nodes, key=lambda nc: nc.id)
    host = _host(nodes[rank].addr)
    same = [i for i, nc in enumerate(nodes) if _host(nc.addr) == host]
    return same.index(rank), len(same)


def _cuda_count(cuda_count: Optional[int]) -> int:
    if cuda_count is not None:
        return cuda_count
    import torch

    return torch.cuda.device_count()


def choose_backend(conf: Config, device_type: str,
                   cuda_count: Optional[int] = None) -> str:
    """``nccl`` when every rank has a CUDA device of its own (no host runs
    more node processes than it has cards), else ``gloo`` (CPU ranks, or
    ranks sharing a card: NCCL refuses two ranks on one device).  Derived
    from the config and the host's card count alone, so every process
    chooses alike."""
    if device_type != "cuda":
        return "gloo"
    per_host = max(local_rank(conf, r)[1] for r in range(len(conf.nodes)))
    return "nccl" if per_host <= _cuda_count(cuda_count) else "gloo"


def rank_device(conf: Config, rank: int, device_type: str,
                cuda_count: Optional[int] = None):
    """The device rank ``rank`` runs on: the CPU, or the card at its
    position among its host's ranks (cards shared round-robin when a host
    runs more ranks than it has cards)."""
    import torch

    if device_type != "cuda":
        return torch.device(device_type)
    k, _ = local_rank(conf, rank)
    return torch.device("cuda", k % max(1, _cuda_count(cuda_count)))


def global_slots(conf: Config, device_type: str,
                 cuda_count: Optional[int] = None) -> list:
    """One slot per rank, in rank order: the node set's global device
    list (the JAX package's ``jax.devices()`` of a one-device-per-process
    pod)."""
    from .mesh import Slot

    return [Slot(r, rank_device(conf, r, device_type, cuda_count),
                 process_index=r)
            for r in range(len(conf.nodes))]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def host_aligned_device_order(conf: Config, assignment,
                              devices: Optional[Sequence] = None) -> list:
    """The global device (slot) list reordered so pipeline-stage blocks
    follow node locality: stage i's slots are the ones owned by the
    process that runs the node mapped to stage i (the JAX package's
    rule, line for line).  ``devices``: the global list, each item with a
    ``process_index`` (default: ``global_slots`` on this process's device
    type when a process group is up).

    Requires one pipeline stage's slot count to equal one process's
    (stage <-> process); raises on uneven per-process counts, on a stage
    that spans more or fewer slots than a process owns, and on more
    stages than nodes.  A single process gets the plain list."""
    import numpy as np

    if devices is None:
        devices = _default_devices(conf)
    devices = list(devices)
    if len({d.process_index for d in devices}) <= 1 or conf.mesh is None:
        return devices

    from .mesh import ranked_assignees

    shape = tuple(conf.mesh.axis_sizes)
    names = list(conf.mesh.axis_names)
    k = names.index(conf.mesh.pipeline_axis)
    n_stages = shape[k]
    per_stage = int(np.prod(shape)) // n_stages

    ids = sorted(nc.id for nc in conf.nodes)
    by_proc: Dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    counts = {rank: len(devs) for rank, devs in by_proc.items()}
    if len(set(counts.values())) != 1:
        raise ValueError(
            f"uneven devices per process {counts}: host-aligned stages "
            "need a uniform shape"
        )
    per_proc = next(iter(counts.values()))
    if per_stage != per_proc:
        raise ValueError(
            f"one pipeline stage spans {per_stage} devices but each "
            f"process owns {per_proc}: shape the mesh so one stage == "
            f"one host (mesh {dict(zip(names, shape))}, "
            f"{len(by_proc)} processes)"
        )
    staged = ranked_assignees(assignment)
    stage_nodes = staged + [n for n in ids if n not in set(staged)]
    if n_stages > len(stage_nodes):
        raise ValueError(
            f"mesh has {n_stages} pipeline stages but only "
            f"{len(stage_nodes)} configured nodes to own them"
        )
    blocks = [by_proc[ids.index(node_id)] for node_id in stage_nodes[:n_stages]]
    rest_shape = shape[:k] + shape[k + 1 :]
    arr = np.empty((n_stages, per_stage), dtype=object)
    for s, block in enumerate(blocks):
        arr[s] = block
    arr = np.moveaxis(arr.reshape((n_stages,) + rest_shape), 0, k)
    return list(arr.reshape(-1))


_state = {"backend": None, "device_type": None,
          "serve_group": None}


def _default_devices(conf: Config) -> list:
    import torch.distributed as dist

    from .mesh import Slot

    if not (dist.is_available() and dist.is_initialized()):
        import torch

        dev = torch.device(_state["device_type"] or "cpu")
        return [Slot(0, dev)]
    return global_slots(conf, _state["device_type"] or "cpu")


def backend() -> Optional[str]:
    """The backend this process's group runs (None before a join)."""
    return _state["backend"]


def maybe_initialize(conf: Config, my_id: NodeID, device_type: str = "cpu",
                     timeout: float = PLAN_WAIT_S,
                     cuda_count: Optional[int] = None
                     ) -> Optional[ProcessLayout]:
    """Join the node set's process group when the config asks for one:
    ``torch.distributed.init_process_group(init_method="tcp://<coordinator>",
    rank=, world_size=, timeout=)`` on the derived backend, the timeout a
    plan's wait (a stalled peer fails the plan with
    ``spmd_fabric.PlanFailed`` instead of holding the run for gloo's 30
    minute default).  Returns the
    layout, or None for the single-host case (no ``Distributed`` section,
    or a single-node topology).  Runs before any device use; under nccl
    it first makes ``rank_device`` this process's current card.  Every
    rank then checks that all chose the same backend and device type (one
    gloo all-reduce of a CPU tensor) and raises otherwise; under nccl one
    all-reduce of a CUDA tensor then starts NCCL on every rank, so a
    machine where it cannot start fails here.  Nothing falls back to
    gloo."""
    if conf.distributed is None or len(conf.nodes) < 2:
        return None
    check_cpu_collectives(conf)
    import torch
    import torch.distributed as dist

    layout = derive_layout(conf, my_id)
    chosen = choose_backend(conf, device_type, cuda_count)
    log.info("joining the node set's process group",
             coordinator=layout.coordinator, process_id=layout.process_id,
             num_processes=layout.num_processes, backend=chosen)
    if chosen == "nccl":
        # NCCL binds a rank to the current card: make it this rank's own
        # before the group starts.
        torch.cuda.set_device(rank_device(conf, layout.process_id, "cuda",
                                          cuda_count))
    dist.init_process_group(
        backend="cpu:gloo,cuda:nccl" if chosen == "nccl" else "gloo",
        init_method=f"tcp://{layout.coordinator}",
        rank=layout.process_id, world_size=layout.num_processes,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _state["backend"] = chosen
    _state["device_type"] = device_type
    code = (1 if chosen == "nccl" else 0) * 2 + (device_type == "cuda")
    lo = torch.tensor([code], dtype=torch.int64)
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    if int(lo) != int(hi):
        raise RuntimeError(
            "node processes disagree on the group's backend or device type "
            f"(this rank: {chosen} on {device_type}); give every node the "
            "same -device")
    if chosen == "nccl":
        # Start NCCL now, on every rank alike: a machine where it cannot
        # start (shared memory, peer access) fails here, loudly, before
        # any plan waits on it.
        probe = torch.ones(1, device=torch.cuda.current_device())
        dist.all_reduce(probe)
        if int(probe.item()) != layout.num_processes:
            raise RuntimeError(f"nccl all-reduce gave {probe.item()}, not "
                               f"{layout.num_processes}")
    # The serve's group: a whole-world call, made once by every rank.
    _state["serve_group"] = dist.new_group(
        list(range(layout.num_processes)),
        timeout=datetime.timedelta(seconds=timeout))
    log.info("process group up", backend=chosen, rank=layout.process_id,
             world=layout.num_processes)
    return layout


def serve_group():
    """The pod serve's process group (made at the join): its hand-offs
    run on the serve's own thread, so they must never share a group with
    the fabric's plans."""
    group = _state["serve_group"]
    if group is None:
        raise RuntimeError("no serve group: this process did not join a "
                           "node set's process group")
    return group


class _Moved:
    """A point-to-point move in flight: ``wait()`` finishes it (and, for a
    receive staged through host memory, copies the bytes to the device
    tensor)."""

    def __init__(self, work, host=None, into=None):
        self.work = work
        self.host = host
        self.into = into

    def wait(self) -> None:
        self.work.wait()
        if self.into is not None:
            self.into.copy_(self.host)


def _staged(t) -> bool:
    """A CUDA tensor on a gloo group moves through host memory."""
    return t.is_cuda and _state["backend"] != "nccl"


def send_to(t, dst: int, group=None) -> _Moved:
    """Start sending ``t`` (contiguous) to rank ``dst`` on ``group`` (the
    default group when None); ``wait()`` on the result finishes it."""
    import torch.distributed as dist

    host = t.to("cpu") if _staged(t) else t
    return _Moved(dist.isend(host, dst, group=group), host)


def recv_from(t, src: int, group=None) -> _Moved:
    """Start receiving rank ``src``'s bytes into ``t`` (contiguous) on
    ``group``; ``t`` holds them once ``wait()`` on the result returned."""
    import torch
    import torch.distributed as dist

    if not _staged(t):
        return _Moved(dist.irecv(t, src, group=group))
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return _Moved(dist.irecv(host, src, group=group), host, t)


def maybe_shutdown() -> None:
    """Leave the process group at process exit
    (``destroy_process_group``).  No-op when none was joined; a peer that
    is already gone (the other end of a finished run may close first)
    is only logged."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        dist.destroy_process_group()
        log.info("process group shut down")
    except Exception as e:  # noqa: BLE001 -- exit path must not raise
        log.warn("process group shutdown failed", err=repr(e))
    finally:
        _state["backend"] = None
        _state["serve_group"] = None
