"""Fully-sharded training step: dp / sp / pp / ep / tp on one mesh.

Port of the JAX package's ``models/sharded.py``.  The JAX step is one
manual ``shard_map`` program with explicit collectives; here each rank of
a ``torch.distributed`` world runs the same per-device function eagerly
under ``parallel.axes.manual(mesh)``, with autograd through the
differentiable named-axis collectives of ``parallel/axes.py``:

- **dp**: batch sharded; gradients psum-reduced over ``dp``.
- **sp**: sequence sharded; ring attention rotates K/V blocks around the
  ``sp`` axis (``parallel/ring_attention.py``, K1 per block).
- **pp**: the stacked layer axis sharded over ``pp``; activations hand
  off stage to stage by ``ppermute``, and the sequential fill leaves the
  logits valid on stage 0 after the wrap-around.
- **ep**: MoE experts sharded over ``ep``, combined by psum.
- **tp**: heads and FFN hidden sharded (Megatron); the row-parallel
  products psum their partial sums; the lm head is vocab-sharded with the
  cross-entropy's log-sum-exp taken across ``tp``.

Parameters are a dict shaped like the JAX package's params (``embed``,
``layers`` stacked, ``ln_f``, ``lm_head``); a spec is a tuple with one
axis name or None per dimension (``param_specs``).  ``shard_params``
slices each rank's shard out of the full params.  The steps update the
params (and the AdamW moments) in place -- the JAX step donates them --
in f32, cast back to each leaf's dtype.  Eager PyTorch with autograd:
``remat=True`` checkpoints each layer
(``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``), so the
backward recomputes its activations, attention included.

Every step function takes ``attention``: None runs K1
(``ops.flash_attention.block_attention``) inside the ring; passing
``block_attention_ref`` runs the same step with the plain version.

``build_pp_forward`` and ``build_pp_decode`` (the JAX package's staged
serving, for ``runtime/pp_serve.py``) wait for the device-fabric slice.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import axes
from ..parallel.axes import all_gather, axis_index, axis_size, ppermute, psum
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.ring_attention import ring_attention
from ..utils.device import resolve_device
from . import serde
from .llama import ModelConfig, lm_head_logits, rms_norm, rope, route_topk

AXES = ("dp", "sp", "pp", "ep", "tp")
Spec = Tuple[Optional[str], ...]
_FABRIC_SLICE = ("pipeline-staged serving over a device mesh waits for the "
                 "device-fabric slice (ROADMAP, port Queue 1 item 6)")


def factor_mesh_axes(n_devices: int, cfg: ModelConfig) -> Dict[str, int]:
    """Split n_devices over (dp, sp, pp, ep, tp) round-robin in priority
    order tp -> pp -> sp -> ep -> dp, one prime factor per axis per round.

    tp must divide n_kv_heads, pp must divide n_layers, ep must divide
    n_experts (dense models keep ep=1); sp and dp are unconstrained."""
    sizes = {a: 1 for a in AXES}

    def accepts(axis: str, f: int) -> bool:
        if axis == "tp":
            return cfg.n_kv_heads % (sizes["tp"] * f) == 0
        if axis == "pp":
            return cfg.n_layers % (sizes["pp"] * f) == 0
        if axis == "ep":
            return cfg.n_experts > 0 and cfg.n_experts % (sizes["ep"] * f) == 0
        return True  # sp, dp unconstrained

    remaining = n_devices
    while remaining > 1:
        # dp accepts anything, so each pass always consumes a factor.
        for axis in ("tp", "pp", "sp", "ep", "dp"):
            if remaining == 1:
                break
            f = next(p for p in range(2, remaining + 1) if remaining % p == 0)
            if accepts(axis, f):
                sizes[axis] *= f
                remaining //= f
    return sizes


def make_train_mesh(n_devices: int, cfg: ModelConfig) -> Mesh:
    sizes = factor_mesh_axes(n_devices, cfg)
    return make_mesh([sizes[a] for a in AXES], AXES)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The spec of each parameter leaf (layer leaves lead with the
    pp-sharded stacked-layer axis)."""
    layers: Dict[str, Spec] = {
        "wq": ("pp", None, "tp"),
        "wk": ("pp", None, "tp"),
        "wv": ("pp", None, "tp"),
        "wo": ("pp", "tp", None),
        "ln1": ("pp", None),
        "ln2": ("pp", None),
    }
    if cfg.n_experts:
        layers.update(
            router=("pp", None, None),
            w1=("pp", "ep", None, "tp"),
            w3=("pp", "ep", None, "tp"),
            w2=("pp", "ep", "tp", None),
        )
    else:
        layers.update(
            w1=("pp", None, "tp"),
            w3=("pp", None, "tp"),
            w2=("pp", "tp", None),
        )
    return {"embed": (), "layers": layers, "ln_f": (), "lm_head": (None, "tp")}


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The full (unsharded) shape of each parameter leaf."""
    return {
        "layers": {name: (cfg.n_layers, *shape)
                   for name, shape in serde.layer_param_specs(cfg)},
        **dict(serde.head_param_specs(cfg)),
    }


def tree_leaves(tree, prefix: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` with dict keys sorted at every level, the order
    ``jax.tree.leaves`` gives the same dicts."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += tree_leaves(tree[key], prefix + (key,))
        return out
    return [(prefix, tree)]


def tree_unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of ``[(path, leaf)]``."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def _flat_specs(cfg: ModelConfig) -> List[Spec]:
    return [spec for _, spec in tree_leaves(param_specs(cfg))]


def shard_slices(shape: Sequence[int], spec: Spec, mesh: Mesh):
    """The index of this rank's shard of a ``shape`` leaf under ``spec``:
    each named dimension cut into ``axis_size`` equal blocks, block
    ``axis_index`` kept."""
    idx = []
    for dim, size in enumerate(shape):
        name = spec[dim] if dim < len(spec) else None
        if name is None:
            idx.append(slice(None))
            continue
        n = mesh.axis_size(name)
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {name}={n}")
        i = mesh.axis_index(name)
        idx.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(idx)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh):
    return tuple(len(range(*s.indices(n)))
                 for s, n in zip(shard_slices(shape, spec, mesh), shape))


def shard_params(params, mesh: Mesh, cfg: ModelConfig):
    """This rank's shard of every leaf (a contiguous copy, so the steps'
    in-place updates never touch the full params)."""
    specs = param_specs(cfg)
    flat = tree_leaves(params)
    flat_specs = dict(tree_leaves(specs))
    if [p for p, _ in flat] != list(flat_specs):
        raise ValueError(f"params {[p for p, _ in flat]} do not match the "
                         f"specs {list(flat_specs)}")
    return tree_unflatten(
        (path, x[shard_slices(x.shape, flat_specs[path], mesh)].clone())
        for path, x in flat)


def _grad_reduce_axes(spec: Spec) -> Tuple[str, ...]:
    """Axes a parameter is replicated over: its gradient psum axes."""
    used = {a for a in spec if a}
    return tuple(a for a in AXES if a not in used)


# ---------------------------------------------------------------- per-device


def _local_layer(cfg: ModelConfig, p, x, q_pos, attention=None):
    """One transformer layer on this rank's shard (manual collectives)."""
    b, s_loc, _ = x.shape
    hd = cfg.head_dim
    h_loc = p["wq"].shape[-1] // hd
    kv_loc = p["wk"].shape[-1] // hd

    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (xn @ p["wq"]).reshape(b, s_loc, h_loc, hd)
    k = (xn @ p["wk"]).reshape(b, s_loc, kv_loc, hd)
    v = (xn @ p["wv"]).reshape(b, s_loc, kv_loc, hd)
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)
    attn = ring_attention(q, k, v, "sp", s_loc, attention)  # sp collective
    o_part = attn.reshape(b, s_loc, h_loc * hd) @ p["wo"]
    x = x + psum(o_part, "tp")  # tp row-parallel reduce

    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        e_loc = p["w1"].shape[0]
        ep_idx = axis_index("ep")
        logits = (xn @ p["router"]).float()
        weights = route_topk(torch.softmax(logits, dim=-1), cfg)
        w_loc = weights[..., ep_idx * e_loc:(ep_idx + 1) * e_loc]
        h1 = torch.einsum("bsd,edf->besf", xn, p["w1"])
        gate = h1 * torch.sigmoid(h1)  # rounds like jax.nn.silu in bf16
        up = torch.einsum("bsd,edf->besf", xn, p["w3"])
        out_part = torch.einsum("besf,efd->besd", gate * up, p["w2"])
        mixed = torch.einsum("besd,bse->bsd", out_part, w_loc.to(x.dtype))
        x = x + psum(mixed, ("ep", "tp"))
    else:
        h1 = xn @ p["w1"]
        gate = h1 * torch.sigmoid(h1)
        down_part = (gate * (xn @ p["w3"])) @ p["w2"]
        x = x + psum(down_part, "tp")
    return x


def _local_loss(cfg: ModelConfig, pp_size: int, params, inputs, targets,
                remat: bool = False, attention=None):
    """This rank's share of the loss: embedding -> pipeline loop ->
    vocab-sharded cross-entropy.  ``inputs``/``targets`` arrive shifted on
    the host, so sequence sharding never straddles the shift.  ``remat``:
    checkpoint each layer, so the backward recomputes its activations."""
    b, s_loc = inputs.shape
    q_pos = axis_index("sp") * s_loc + torch.arange(s_loc,
                                                    device=inputs.device)
    x = params["embed"][inputs]
    layer_fn = functools.partial(_local_layer, cfg, attention=attention)
    if remat:
        layer_fn = functools.partial(checkpoint, layer_fn, use_reentrant=False)
    stacked = params["layers"]
    n_local = stacked["wq"].shape[0]

    def run_stage(h):
        for i in range(n_local):
            h = layer_fn({name: a[i] for name, a in stacked.items()}, h,
                         q_pos)
        return h

    # Sequential pipeline fill: stage s applies its layers at hop s; after
    # pp hops the fully-processed activations have wrapped back to stage 0.
    fwd = [(i, (i + 1) % pp_size) for i in range(pp_size)]
    for _ in range(pp_size):
        x = run_stage(x)
        if pp_size > 1:
            x = ppermute(x, "pp", fwd)

    xn = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_head_logits(xn, params["lm_head"])  # f32 [b, s, v_loc]

    # Cross-entropy over the tp-sharded vocab: the global max (for
    # stabilisation only, no gradient) from the gathered shard maxes; the
    # target logit is owned by exactly one tp member.
    v_loc = logits.shape[-1]
    m = all_gather(logits.detach().amax(dim=-1), "tp").amax(dim=0)
    sumexp = psum(torch.exp(logits - m[..., None]).sum(dim=-1), "tp")
    lse = torch.log(sumexp) + m
    tgt_local = targets - axis_index("tp") * v_loc
    own = (tgt_local >= 0) & (tgt_local < v_loc)
    safe = torch.clamp(tgt_local, 0, v_loc - 1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    tgt_logit = psum(torch.where(own, picked, torch.zeros_like(picked)),
                     "tp")
    nll = (lse - tgt_logit).mean()

    # Only stage 0 holds valid logits; the other stages' paths get zero
    # cotangents through this mask.  The share: the nll is computed on
    # every (tp, ep) member and split across (dp, sp) data shards, so
    # dividing by dp*sp*tp*ep makes the all-axis psum of shares the global
    # mean and each leaf's gradient psum over its replication axes exact.
    denom = (axis_size("dp") * axis_size("sp") * axis_size("tp")
             * axis_size("ep"))
    on_stage0 = torch.tensor(axis_index("pp") == 0, device=nll.device)
    return torch.where(on_stage0, nll, torch.zeros_like(nll)) / denom


def loss_and_grads(cfg: ModelConfig, mesh: Mesh, params, inputs, targets,
                   remat: bool = True, attention=None):
    """The global mean loss (a 0-d f32 tensor, the same on every rank) and
    this rank's gradient of every leaf, in ``tree_leaves`` order, reduced
    over the leaf's replication axes."""
    flat = tree_leaves(params)
    live = [x.detach().requires_grad_() for _, x in flat]
    tree = tree_unflatten(zip((p for p, _ in flat), live))
    with axes.manual(mesh):
        share = _local_loss(cfg, mesh.shape["pp"], tree, inputs, targets,
                            remat, attention)
        grads = torch.autograd.grad(share, live)
        loss = psum(share.detach(), AXES)  # shares sum to the global mean
        grads = [psum(g, red) if (red := _grad_reduce_axes(s)) else g
                 for g, s in zip(grads, _flat_specs(cfg))]
    return loss, grads


def build_train_step(cfg: ModelConfig, mesh: Mesh, lr: float = 1e-3,
                     remat: bool = True, attention=None):
    """``step(params, inputs, targets) -> (params, loss)``: one SGD step
    over the 5-axis mesh, the params updated in place."""

    def step(params, inputs, targets):
        loss, grads = loss_and_grads(cfg, mesh, params, inputs, targets,
                                     remat, attention)
        with torch.no_grad():
            for (_, p), g in zip(tree_leaves(params), grads):
                p.copy_((p.float() - lr * g.float()).to(p.dtype))
        return params, loss

    return step


def init_adamw_state(params):
    """AdamW moments, one (m, v) pair per leaf -- f32 whatever the param
    dtype, shaped like this rank's shard -- and the step counter."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    flat = tree_leaves(params)
    return {
        "m": tree_unflatten((path, zeros(p)) for path, p in flat),
        "v": tree_unflatten((path, zeros(p)) for path, p in flat),
        "step": torch.zeros((), dtype=torch.int32, device=flat[0][1].device),
    }


def adamw_state_specs(cfg: ModelConfig):
    """The specs of ``init_adamw_state``'s tree: moments shard like the
    params; the step counter is replicated."""
    specs = param_specs(cfg)
    return {"m": specs, "v": specs, "step": ()}


def build_adamw_train_step(cfg: ModelConfig, mesh: Mesh, lr: float = 1e-3,
                           betas=(0.9, 0.999), eps: float = 1e-8,
                           weight_decay: float = 0.01, remat: bool = True,
                           attention=None):
    """``step(params, opt_state, inputs, targets) -> (params, opt_state,
    loss)``: AdamW with bias correction and decoupled weight decay, the
    moments sharded like the params; params and moments are updated in
    place, leaf by leaf."""
    b1, b2 = betas

    def step(params, opt_state, inputs, targets):
        loss, grads = loss_and_grads(cfg, mesh, params, inputs, targets,
                                     remat, attention)
        t = int(opt_state["step"]) + 1
        # The bias corrections in f32, as the JAX step computes them.
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        with torch.no_grad():
            leaves = zip(tree_leaves(params), tree_leaves(opt_state["m"]),
                         tree_leaves(opt_state["v"]))
            for i, ((_, p), (_, m), (_, v)) in enumerate(leaves):
                g = grads[i].float()
                grads[i] = None
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * g * g)
                del g
                step_dir = (m / c1) / (torch.sqrt(v / c2) + eps)
                p32 = p.float()
                p.copy_((p32 - lr * (step_dir + weight_decay * p32))
                        .to(p.dtype))
            opt_state["step"].fill_(t)
        return params, opt_state, loss

    return step


def example_batch(cfg: ModelConfig, mesh: Mesh, batch: int = 0, seq: int = 0,
                  device=None):
    """This rank's shard of ``(inputs, targets)``, the global batch shaped
    to divide evenly over (dp, sp): the JAX package's tokens (numpy
    ``default_rng(0)``), on ``device`` (None = the CUDA card)."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    batch = batch or 2 * dp
    seq = seq or 8 * sp
    if batch % dp or seq % sp:
        raise ValueError(f"batch {batch} / seq {seq} do not divide over "
                         f"dp={dp} / sp={sp}")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq + 1), dtype=np.int32)
    dev = resolve_device(device)
    rows = shard_slices((batch, seq), ("dp", "sp"), mesh)
    inputs = torch.from_numpy(tokens[:, :-1][rows].astype(np.int64))
    targets = torch.from_numpy(tokens[:, 1:][rows].astype(np.int64))
    return inputs.to(dev), targets.to(dev)


# ------------------------------------------------------------ pp inference


def build_pp_forward(cfg: ModelConfig, mesh: Mesh, pp_axis: str):
    raise NotImplementedError(_FABRIC_SLICE)


def build_pp_decode(cfg: ModelConfig, mesh: Mesh, pp_axis: str,
                    max_new: int):
    raise NotImplementedError(_FABRIC_SLICE)
