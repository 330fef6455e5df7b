"""Pod-level pipelined serving from disseminated stage weights.

Port of the JAX package's ``runtime/pp_serve.py``, single-controller form.
The Assignment IS a pipeline placement: dissemination lands each stage's
layer slice on that stage's slots and the per-node stage boot
(``runtime/boot.py``) proves the slice usable.  Here the POD serves as one
model:

1. ``assemble_pp_params`` collects each stage's resident per-layer
   params (``BootResult.params``, views of the blobs landed on the
   stage's slot device) in stage order, padded to the deepest stage --
   no weight byte moves -- and decodes the head leaves from whichever
   node received the head blob.
2. ``pod_forward`` runs ``models.sharded.build_pp_forward``: stage by
   stage, the hidden state handed on; ``pod_decode`` the KV-cached greedy
   loop (``build_pp_decode``).  UNEVEN contiguous stage slices serve.
   For experts the forward's routed and computed rows are counted
   (``models.llama.MoeRows``) and read after its synchronisation.

The multi-controller form (``spmd_pod_forward``/``spmd_pod_decode``)
runs in EVERY member process on a ``ServeMsg``: each process holds only
its own stage, runs its layers (``models.sharded.build_stage_forward``/
``build_stage_decode``, K1 on every attention) and hands the hidden state
to the next stage's process; the last stage computes the head and the
greedy id and broadcasts it to every member (``StageLink``), so the
replicated greedy loop cannot diverge.  The head blob must be assigned to
every stage (the JAX package's convention), since a process can only
decode what its own store holds.  The hand-offs are point-to-point moves
of uint8 views on the serve group (``multihost.serve_group``), issued
from the serve's own thread: the fabric's plans run on the default
group, so the two never pair up.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ..utils.device import synchronize
from ..utils.logging import log

def _stage_order(cfg, placement, results) -> Optional[list]:
    """Stage-ordered list of (node, layer params, depth) when the boots
    form a full contiguous partition of the layers (uneven slices are
    fine); None (with a log) otherwise."""
    staged = {n: r for n, r in results.items()
              if r is not None and r.kind == "stage" and r.params is not None}
    if not staged:
        return None
    by_stage = sorted(staged, key=lambda n: placement.node_to_stage[n])
    covered = [lid for n in by_stage for lid in staged[n].layer_ids]
    if covered != list(range(cfg.n_layers)):
        log.info("pod serve skipped: stage boots don't partition the "
                 "layers", covered=covered)
        return None
    return [(n, staged[n].params, len(staged[n].layer_ids))
            for n in by_stage]


def _pad_stack(layers: Dict[str, Any], l_max: int) -> list:
    """A stage's leaves as ``l_max`` per-layer entries: layer i's leaves,
    then ``None`` past the stage's depth (the tail the counts skip).
    Views only: no weight byte moves."""
    from ..models.llama import layer_slice, n_layers_of

    depth = n_layers_of(layers)
    return ([layer_slice(layers, i) for i in range(depth)]
            + [None] * (l_max - depth))


def _head_leaves(cfg, stores, codec: str, device):
    """embed/ln_f/lm_head from whichever node's store holds the head blob
    (decoded on the device when it landed there)."""
    from ..models import serde
    from .boot import decode_head

    head_id = serde.head_blob_id(cfg)
    for _, layers in stores.items():
        src = layers.get(head_id)
        if src is not None:
            return decode_head(cfg, src, codec, device=device)
    return None


def _submesh(placement, stage_idx):
    """The placement's mesh with its pipeline axis cut to ``stage_idx``
    (in that order)."""
    import numpy as np

    from ..parallel.mesh import DeviceMesh

    k = placement.mesh.axis_names.index(placement.pipeline_axis)
    return DeviceMesh(np.take(placement.mesh.devices, stage_idx, axis=k),
                      placement.mesh.axis_names)


def assemble_pp_params(cfg, placement, results: Dict[int, Any],
                       stores: Dict[int, Any], codec: str = "raw"):
    """The pod's pipeline params from the stage boots' resident tensors;
    None when the pod does not form a servable pipeline.  Returns (mesh,
    stages, counts, head): ``mesh`` the sub-mesh of the booted stages,
    ``stages[s]`` stage s's per-layer leaves padded to the deepest stage
    (``_pad_stack``), ``counts`` each stage's real depth."""
    order = _stage_order(cfg, placement, results)
    if order is None:
        return None
    # Serve on the SUB-mesh of exactly the booted stages: a pod fabric
    # maps seeders and the leader onto stages too, holding no slice.
    mesh = _submesh(placement, [placement.node_to_stage[n]
                                for n, _, _ in order])
    first = mesh.axis_slots(placement.pipeline_axis)[0][0]
    head = _head_leaves(cfg, stores, codec, first)
    if head is None:
        log.info("pod serve skipped: no node holds the head blob")
        return None
    l_max = max(depth for _, _, depth in order)
    stages = [_pad_stack(layers, l_max) for _, layers, _ in order]
    counts = [depth for _, _, depth in order]
    return mesh, stages, counts, head


def pod_forward(cfg, placement, results, stores, tokens=None,
                codec: str = "raw", assembled=None, attention=None):
    """One pipelined forward across the pod's stages from the landed
    weights; returns (logits, seconds) or None when not servable.
    ``assembled``: a prior ``assemble_pp_params`` result to reuse."""
    from ..models.llama import MoeRows
    from ..models.sharded import build_pp_forward

    if assembled is None:
        assembled = assemble_pp_params(cfg, placement, results, stores,
                                       codec)
    if assembled is None:
        return None
    mesh, stages, counts, head = assembled
    dev = head["embed"].device
    if tokens is None:
        tokens = torch.zeros((1, 16), dtype=torch.long, device=dev)
    t0 = time.monotonic()
    fwd = build_pp_forward(cfg, mesh, placement.pipeline_axis, attention)
    with MoeRows() as rows:
        logits = fwd(stages, counts, head, tokens)
    synchronize(logits.device)
    dt = time.monotonic() - t0
    rows.report()
    log.info("pod pipelined forward from staged weights",
             stages=mesh.shape[placement.pipeline_axis],
             seconds=round(dt, 3))
    return logits, dt


def pod_decode(cfg, placement, results, stores, max_new: int,
               prompt=None, codec: str = "raw", assembled=None,
               attention=None):
    """Single-controller pod generation: KV-cached greedy decode across
    the stages from the landed weights; (tokens, seconds) or None."""
    from ..models.sharded import build_pp_decode

    if assembled is None:
        assembled = assemble_pp_params(cfg, placement, results, stores,
                                       codec)
    if assembled is None:
        return None
    mesh, stages, counts, head = assembled
    dev = head["embed"].device
    if prompt is None:
        prompt = torch.zeros((1, 16), dtype=torch.long, device=dev)
    t0 = time.monotonic()
    dec = build_pp_decode(cfg, mesh, placement.pipeline_axis, max_new,
                          attention)
    toks = dec(stages, counts, head, prompt)
    synchronize(toks.device)
    dt = time.monotonic() - t0
    log.info("pod decoded tokens from staged weights",
             stages=mesh.shape[placement.pipeline_axis],
             generated=int(toks.shape[1]), seconds=round(dt, 3))
    return toks, dt


class StageLink:
    """One member process's pipeline hand-offs: ``ranks[s]`` is the
    process rank of stage ``s`` and ``stage`` this process's.  Each
    hand-off moves the tensor's bytes (a uint8 view: gloo and NCCL alike
    move any dtype) from one rank to another on the serve group
    (``multihost.send_to``/``recv_from``); ``from_last`` sends the last
    stage's tensor to every other member that way.  One stage: no
    hand-off at all."""

    def __init__(self, ranks, stage: int):
        from ..parallel.multihost import serve_group

        self.ranks = list(ranks)
        self.stage = stage
        self.n_stages = len(self.ranks)
        self.group = serve_group() if self.n_stages > 1 else None

    def _recv(self, buf: torch.Tensor, src_stage: int) -> torch.Tensor:
        from ..parallel.multihost import recv_from

        recv_from(buf.view(-1).view(torch.uint8), self.ranks[src_stage],
                  self.group).wait()
        return buf

    def _send(self, t: torch.Tensor, dst_stage: int) -> None:
        from ..parallel.multihost import send_to

        send_to(t.view(-1).view(torch.uint8), self.ranks[dst_stage],
                self.group).wait()

    def recv_prev(self, buf: torch.Tensor) -> torch.Tensor:
        return self._recv(buf, self.stage - 1)

    def send_next(self, x: torch.Tensor) -> None:
        self._send(x.contiguous(), self.stage + 1)

    def from_last(self, t: torch.Tensor) -> torch.Tensor:
        last = self.n_stages - 1
        t = t.contiguous()
        if self.stage != last:
            return self._recv(t, last)
        for s in range(last):
            self._send(t, s)
        return t


def _spmd_assemble(cfg, placement, members, my_node, stage_params, store,
                   codec: str, member_counts=None):
    """Shared multi-controller assembly: this process's resident stage
    layers (views, no byte moves), its head leaves decoded from its own
    store, and its ``StageLink``.  ``members`` is the pipeline order;
    ``member_counts`` the per-member depths aligned with it (from the
    leader's ServeMsg; default an even n_layers/len(members), the JAX
    package's convention)."""
    from ..models import serde
    from ..models.llama import layer_slice, n_layers_of
    from .boot import decode_head

    head_src = store.get(serde.head_blob_id(cfg))
    if head_src is None:
        raise RuntimeError(
            "multi-controller serving needs the head blob assigned to "
            "every stage; this node's store has none"
        )
    members = list(members)
    if member_counts is None:
        member_counts = [cfg.n_layers // len(members)] * len(members)
    stage = members.index(my_node)
    depth = int(member_counts[stage])
    held = n_layers_of(stage_params)
    if depth != held:
        raise RuntimeError(f"stage {stage} serves {depth} layers but its "
                           f"boot holds {held}")
    layers = [layer_slice(stage_params, i) for i in range(depth)]
    dev = layers[0]["wq"].device
    head = decode_head(cfg, head_src, codec, device=dev)
    ranks = [placement.devices_for_node(n)[0].process_index for n in members]
    return layers, head, StageLink(ranks, stage), dev


def spmd_pod_forward(cfg, placement, members, my_node, stage_params, store,
                     codec: str = "raw", batch: int = 1, seq_len: int = 16,
                     member_counts=None, attention=None):
    """Multi-controller serving: called by EVERY member process on
    ``ServeMsg``.  ``stage_params`` is this process's resident stage params
    (``BootResult.params``); ``store`` its layer store (holds the head
    blob).  Returns (logits, seconds) on members, None on non-members."""
    from ..models.llama import MoeRows
    from ..models.sharded import build_stage_forward

    if my_node not in members:
        return None
    t0 = time.monotonic()
    layers, head, link, dev = _spmd_assemble(
        cfg, placement, members, my_node, stage_params, store, codec,
        member_counts)
    tokens = torch.zeros((batch, seq_len), dtype=torch.long, device=dev)
    with MoeRows() as rows:
        logits = build_stage_forward(cfg, link, attention)(layers, head,
                                                           tokens)
    synchronize(logits.device)
    dt = time.monotonic() - t0
    rows.report()
    log.info("pod pipelined forward from staged weights", spmd=True,
             stages=len(members), seconds=round(dt, 3))
    return logits, dt


def spmd_pod_decode(cfg, placement, members, my_node, stage_params, store,
                    max_new: int, codec: str = "raw", batch: int = 1,
                    prompt_len: int = 16, member_counts=None,
                    attention=None):
    """Multi-controller KV-cached GREEDY decode: every member process runs
    its stage of each step and emits identical token ids.  The prompt is
    the boot prompt (zeros of ``prompt_len`` tokens), deterministic on
    every process.  Returns (tokens [batch, max_new], seconds) on
    members, None on non-members."""
    from ..models.sharded import build_stage_decode

    if my_node not in members:
        return None
    t0 = time.monotonic()
    layers, head, link, dev = _spmd_assemble(
        cfg, placement, members, my_node, stage_params, store, codec,
        member_counts)
    prompt = torch.zeros((batch, prompt_len), dtype=torch.long, device=dev)
    toks = build_stage_decode(cfg, link, max_new, attention)(layers, head,
                                                              prompt)
    synchronize(toks.device)
    dt = time.monotonic() - t0
    log.info("pod decoded tokens from staged weights", spmd=True,
             stages=len(members), generated=int(toks.shape[1]),
             seconds=round(dt, 3))
    return toks, dt
