"""Llama-style transformer: the model whose layers get disseminated.

PyTorch port of the JAX package's ``models/llama.py``: the same
``ModelConfig``/``CONFIGS`` (with ``dtype=torch.bfloat16``), the same
params layout (a dict with ``embed``, ``layers`` stacked along a leading
n_layers axis, ``ln_f``, ``lm_head``), and the same numerics where they
decide parity: ``rms_norm`` computes in f32, casts, then multiplies by
``w``; ``rope`` runs in f32 on split halves; the lm head gives f32 logits
from bf16 operands.

Attention goes through ``ops.flash_attention.block_attention`` (the
Hopper kernel on CUDA tensors) and is normalised as ``pv / l`` before the
cast to bf16.  The JAX ``gqa_attention`` casts the probabilities to bf16
before the PV product; the kernel keeps them in f32, so the two agree to
bf16 rounding, not bit for bit.  Every entry point takes an
``attention`` argument, ``None`` meaning ``block_attention``; passing
``block_attention_ref`` runs the same model through the plain version.
The JAX ``gqa_attention`` has no function of its own here: ``attend``
over ``block_attention_ref`` is the plain attention.

A booted model holds its layers per layer instead: each leaf name maps to
a sequence of per-layer tensors, views of the landed blobs
(``runtime/boot.py``).  Every reader takes both forms: layer ``i``'s
leaf is ``layers[name][i]`` either way (``layer_slice``), and
``n_layers_of`` gives the depth.

``init_params(cfg, seed)`` is the JAX ``init_params(cfg, key(seed))``
bit for bit (bf16 configs): the same key splits (``model_keys``) and
threefry draws (``models/prng.py``), one leaf at a time
(``layer_leaf``/``head_leaf``, which ``serde.seeded_leaf`` draws a
single seeded leaf with), the layers stacked as JAX stacks them.

The FFN is dense SwiGLU, or for MoE configs (``n_experts > 0``) a top-k
routed mixture of SwiGLU experts with dense dispatch (``moe_ffn``), as in
the JAX package: every expert computes and the routing weights, ties kept
(``route_topk``), zero out the unrouted pairs.  The expert products are
plain ``torch.einsum``; the JAX package runs them outside any kernel too.
Each layer's expert FFN is the phase ``moe_ffn`` (a ``dld.moe_ffn`` span
under a profiler); inside a ``MoeRows`` block it also tallies, on the
device, the token-expert pairs the router picked and those the dense
dispatch computed.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..ops import flash_attention
from ..utils import trace
from ..utils.device import resolve_device
from . import prng


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 4
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 256
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    # MoE (expert-parallel) variant: 0 experts = dense SwiGLU.
    n_experts: int = 0
    top_k: int = 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def layer_nbytes(self) -> int:
        """Bytes of one transformer layer's params in this dtype -- the
        'LayerSize' the dissemination configs should use."""
        itemsize = self.dtype.itemsize
        d, f, h, kv = self.d_model, self.d_ff, self.n_heads, self.n_kv_heads
        hd = self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.n_experts:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        norms = 2 * d
        return (attn + ffn + norms) * itemsize


# Real Llama-3 family shapes (public architecture constants) + test sizes;
# the same table as the JAX package's.
CONFIGS: Dict[str, ModelConfig] = {
    "tiny": ModelConfig(),
    "tiny-moe": ModelConfig(name="tiny-moe", n_experts=4, top_k=2),
    "tiny2": ModelConfig(
        name="tiny2", vocab=512, d_model=256, n_layers=4,
        n_heads=4, n_kv_heads=2, d_ff=1024,
    ),
    "llama3-8b": ModelConfig(
        name="llama3-8b", vocab=128256, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336,
    ),
    # Flagship at reduced depth: the full 8B layer shape (each layer blob
    # is 416 MiB) with 4 layers.
    "llama3-8b-d4": ModelConfig(
        name="llama3-8b-d4", vocab=128256, d_model=4096, n_layers=4,
        n_heads=32, n_kv_heads=8, d_ff=14336,
    ),
    "llama3-8b-d4v8k": ModelConfig(
        name="llama3-8b-d4v8k", vocab=8192, d_model=4096, n_layers=4,
        n_heads=32, n_kv_heads=8, d_ff=14336,
    ),
    "llama3-70b": ModelConfig(
        name="llama3-70b", vocab=128256, d_model=8192, n_layers=80,
        n_heads=64, n_kv_heads=8, d_ff=28672,
    ),
    "llama3-405b": ModelConfig(
        name="llama3-405b", vocab=128256, d_model=16384, n_layers=126,
        n_heads=128, n_kv_heads=8, d_ff=53248,
    ),
}


# ---------------------------------------------------------------------- init

def _init_leaf(cfg: ModelConfig, name: str, shape, key, device
               ) -> torch.Tensor:
    """One init leaf on ``device``: ones for the norms, else the JAX
    package's ``jax.random.normal(key, shape, dtype) * scale``."""
    if cfg.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"seeded draws are reproduced for bfloat16 only, not {cfg.dtype}")
    dev = resolve_device(device)
    if name.startswith("ln"):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)
    scale = cfg.d_ff ** -0.5 if name == "w2" else cfg.d_model ** -0.5
    return prng.normal_bf16(key, int(np.prod(shape)), scale,
                            dev).reshape(shape)


def model_keys(cfg: ModelConfig, key: prng.Key):
    """The JAX ``model_keys``: ``split(key, 3)`` into the embed, layers
    and lm-head keys, then one key per layer."""
    k_emb, k_layers, k_out = prng.split(key, 3)
    return k_emb, prng.split(k_layers, cfg.n_layers), k_out


def layer_leaf(cfg: ModelConfig, key: prng.Key, name: str,
               device=None) -> torch.Tensor:
    """Leaf ``name`` of ``init_layer_params(cfg, key)``, drawn alone: the
    layer key splits 8 ways and the drawn leaves spend them in order (wq,
    wk, wv, wo, router for MoE, w1, w3, w2); the norms take no key."""
    from .serde import layer_param_specs

    specs = dict(layer_param_specs(cfg))
    drawn = [n for n in specs if not n.startswith("ln")]
    k = prng.split(key, 8)[drawn.index(name)] if name in drawn else None
    return _init_leaf(cfg, name, specs[name], k, device)


def head_leaf(cfg: ModelConfig, k_emb: prng.Key, k_out: prng.Key,
              name: str, device=None) -> torch.Tensor:
    """Leaf ``name`` of ``init_head_params(cfg, k_emb, k_out)``."""
    from .serde import head_param_specs

    shape = dict(head_param_specs(cfg))[name]
    return _init_leaf(cfg, name, shape,
                      {"embed": k_emb, "lm_head": k_out}.get(name), device)


def init_layer_params(cfg: ModelConfig, key: prng.Key, device=None
                      ) -> Dict[str, torch.Tensor]:
    """One transformer layer's weights (the JAX ``init_layer_params``) on
    ``device`` (None = the CUDA card)."""
    from .serde import layer_param_specs

    return {name: layer_leaf(cfg, key, name, device)
            for name, _ in layer_param_specs(cfg)}


def init_head_params(cfg: ModelConfig, k_emb: prng.Key, k_out: prng.Key,
                     device=None) -> Dict[str, torch.Tensor]:
    """The non-layer weights: embed, ln_f, lm_head."""
    from .serde import head_param_specs

    return {name: head_leaf(cfg, k_emb, k_out, name, device)
            for name, _ in head_param_specs(cfg)}


def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Full model params on ``device`` (None = the CUDA card), equal byte
    for byte to the JAX ``init_params(cfg, jax.random.key(seed))``: the
    layer leaves stacked along a leading n_layers axis.  Each layer is
    drawn, copied into its stacked slot and dropped, so the peak is one
    layer above the model."""
    k_emb, layer_keys, k_out = model_keys(cfg, prng.seed_key(seed))
    stacked: Dict[str, torch.Tensor] = {}
    for i, lk in enumerate(layer_keys):
        for name, leaf in init_layer_params(cfg, lk, device).items():
            if name not in stacked:
                stacked[name] = torch.empty((cfg.n_layers, *leaf.shape),
                                            dtype=leaf.dtype,
                                            device=leaf.device)
            stacked[name][i] = leaf
    head = init_head_params(cfg, k_emb, k_out, device)
    return {"embed": head["embed"], "layers": stacked, "ln_f": head["ln_f"],
            "lm_head": head["lm_head"]}


# ------------------------------------------------------------------- blocks

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings in f32 on split halves; x: [b, seq, heads, hd]."""
    hd = x.shape[-1]
    half = torch.arange(0, hd // 2, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -half / (hd // 2))
    angles = positions[:, None].float() * freqs  # [seq, hd/2]
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def qkv_proj(p: Dict[str, torch.Tensor], xn: torch.Tensor,
             positions: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normed hidden state -> rotary-encoded q [b,s,h,hd] and k, v
    [b,s,kvh,hd]; shared by the forward and the KV-cached path."""
    b, s, _ = xn.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (xn @ p["wq"]).reshape(b, s, h, hd)
    k = (xn @ p["wk"]).reshape(b, s, kv, hd)
    v = (xn @ p["wv"]).reshape(b, s, kv, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_off: int,
           attention=None) -> torch.Tensor:
    """Causal GQA attention of q [b, s, h, hd] (global positions q_off..)
    against k, v [b, kvh, t, hd] (positions 0..t-1) through
    ``block_attention``; returns [b, s, h*hd] in q's dtype."""
    fn = flash_attention.block_attention if attention is None else attention
    b, s, h, hd = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, s, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4).contiguous()
    pv, _, l = fn(qg, k, v, q_off, 0)
    out = (pv / l[..., None]).to(q.dtype)  # [b, kvh, g, s, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h * hd)


def heads_major(x: torch.Tensor) -> torch.Tensor:
    """[b, s, kvh, hd] -> contiguous [b, kvh, s, hd] (the kernel's K/V
    layout)."""
    return x.transpose(1, 2).contiguous()


def attention_block(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cfg: ModelConfig, attention=None) -> torch.Tensor:
    """Cache-less causal self-attention over positions 0..s-1."""
    positions = torch.arange(x.shape[1], device=x.device)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_proj(p, xn, positions, cfg)
    out = attend(q, heads_major(k), heads_major(v), 0, attention)
    return x + out @ p["wo"]


def dense_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    h1 = xn @ p["w1"]
    # x * sigmoid(x) with a rounding after each op, as jax.nn.silu does in
    # bf16 (F.silu rounds once and differs by an ulp).
    gate = h1 * torch.sigmoid(h1)
    up = xn @ p["w3"]
    return x + (gate * up) @ p["w2"]


def route_topk(weights: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Keep every routing weight at or above the k-th largest per token
    (ties kept, so more than k may survive) and renormalise, as the JAX
    package's ``route_topk``; a no-op when ``top_k >= n_experts``."""
    if cfg.top_k >= cfg.n_experts:
        return weights
    kth = torch.topk(weights, cfg.top_k, dim=-1).values[..., -1:]
    weights = torch.where(weights >= kth, weights, torch.zeros_like(weights))
    return weights / (weights.sum(-1, keepdim=True) + 1e-9)


class MoeRows:
    """Counts of the expert rows of the forwards run inside the block, on
    the calling thread: ``routed`` token-expert pairs the router picked
    (ties included), summed on each device with no host sync, and
    ``computed`` pairs the expert products ran (every token for every
    expert, under dense dispatch).  ``report()`` reads the device sums
    once, so call it after the forward has synchronised; it adds both to
    the counters ``moe.routed_rows`` and ``moe.computed_rows``."""

    _current = threading.local()

    def __init__(self):
        self.routed: Dict[torch.device, torch.Tensor] = {}
        self.computed = 0

    def __enter__(self) -> "MoeRows":
        self._outer = getattr(MoeRows._current, "rows", None)
        MoeRows._current.rows = self
        return self

    def __exit__(self, *exc) -> None:
        MoeRows._current.rows = self._outer

    @classmethod
    def tally(cls, weights: torch.Tensor) -> None:
        """Add one layer's routing weights [b, s, e] to the open block."""
        rows = getattr(cls._current, "rows", None)
        if rows is None:
            return
        picked = (weights > 0).sum()
        prev = rows.routed.get(weights.device)
        rows.routed[weights.device] = picked if prev is None else prev + picked
        rows.computed += weights.numel()

    def report(self) -> int:
        """Add the block's counts to the counters; returns the routed
        rows."""
        routed = sum(int(t.item()) for t in self.routed.values())
        if self.computed:
            trace.count("moe.routed_rows", routed)
            trace.count("moe.computed_rows", self.computed)
        return routed


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Top-k routed mixture of SwiGLU experts, dense dispatch.  The
    router product rounds in the model dtype before the f32 softmax; the
    routing weights are cast to the model dtype for the mixing product."""
    with trace.phase("moe_ffn"):
        xn = rms_norm(x, p["ln2"], cfg.norm_eps)
        logits = (xn @ p["router"]).float()
        weights = route_topk(torch.softmax(logits, dim=-1), cfg)
        MoeRows.tally(weights)
        h1 = torch.einsum("bsd,edf->besf", xn, p["w1"])
        gate = h1 * torch.sigmoid(h1)  # rounds like jax.nn.silu (dense_ffn)
        up = torch.einsum("bsd,edf->besf", xn, p["w3"])
        expert_out = torch.einsum("besf,efd->besd", gate * up, p["w2"])
        mixed = torch.einsum("besd,bse->bsd", expert_out,
                             weights.to(x.dtype))
        return x + mixed


def ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig) -> torch.Tensor:
    if cfg.n_experts:
        return moe_ffn(p, x, cfg)
    return dense_ffn(p, x, cfg)


def layer_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, attention=None) -> torch.Tensor:
    return ffn(p, attention_block(p, x, cfg, attention), cfg)


def layer_slice(layers: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves from a layer dict, stacked or per layer
    (views)."""
    return {name: a[i] for name, a in layers.items()}


def n_layers_of(layers: Dict[str, Any]) -> int:
    """The depth of a layer dict: the length of its leaves' leading axis
    when stacked, of its per-layer sequences when booted."""
    return len(next(iter(layers.values())))


class _HeadF32(torch.autograd.Function):
    """``torch.mm(x2, w, out_dtype=float32)`` with a gradient: the two
    backward products take the f32 cotangent rounded to the weights'
    2-byte type and accumulate in f32, each result rounded once to its
    operand's type."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g2 = g.to(w.dtype)
        dx = torch.mm(g2, w.t(), out_dtype=torch.float32).to(x2.dtype)
        dw = torch.mm(x2.t(), g2, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def lm_head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 logits of x [..., d] @ w [d, vocab] from bf16 (or f16) operands
    with f32 accumulation.  On CUDA, cuBLAS writes f32 straight from the
    2-byte operands (no f32 copy of the 1 GB lm_head; ``_HeadF32`` gives
    it a gradient for training); on the CPU, where that form does not
    exist, the operands are upcast (exact for bf16 and f16)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and w.dtype != torch.float32:
        out = _HeadF32.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*lead, w.shape[-1])


# ------------------------------------------------------------------ forward

def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            attention=None) -> torch.Tensor:
    """f32 logits [b, s, vocab] for [b, s] integer tokens."""
    x = params["embed"][tokens]
    for i in range(n_layers_of(params["layers"])):
        x = layer_apply(layer_slice(params["layers"], i), x, cfg, attention)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return lm_head_logits(x, params["lm_head"])


def stage_forward(layers: Dict[str, Any], x: torch.Tensor,
                  cfg: ModelConfig, attention=None) -> torch.Tensor:
    """A pipeline stage's layers over activations x [b, s, d]."""
    for i in range(n_layers_of(layers)):
        x = layer_apply(layer_slice(layers, i), x, cfg, attention)
    return x


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            attention=None) -> torch.Tensor:
    """Next-token cross-entropy on f32 logits (the JAX ``loss_fn``): the
    mean over [b, s - 1] positions of -log softmax at the next token."""
    logits = forward(params, tokens[:, :-1], cfg, attention).float()
    logp = torch.log_softmax(logits, dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None])[..., 0].mean()
