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

The FFN is dense SwiGLU, or for MoE configs (``n_experts > 0``) a top-k
routed mixture of SwiGLU experts with dense dispatch (``moe_ffn``), as in
the JAX package: every expert computes and the routing weights, ties kept
(``route_topk``), zero out the unrouted pairs.  The expert products are
plain ``torch.einsum``; the JAX package runs them outside any kernel too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..ops import flash_attention


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


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Top-k routed mixture of SwiGLU experts, dense dispatch.  The
    router product rounds in the model dtype before the f32 softmax; the
    routing weights are cast to the model dtype for the mixing product."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    logits = (xn @ p["router"]).float()
    weights = route_topk(torch.softmax(logits, dim=-1), cfg)
    h1 = torch.einsum("bsd,edf->besf", xn, p["w1"])
    gate = h1 * torch.sigmoid(h1)  # rounds like jax.nn.silu (dense_ffn)
    up = torch.einsum("bsd,edf->besf", xn, p["w3"])
    expert_out = torch.einsum("besf,efd->besd", gate * up, p["w2"])
    mixed = torch.einsum("besd,bse->bsd", expert_out, weights.to(x.dtype))
    return x + mixed


def ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig) -> torch.Tensor:
    if cfg.n_experts:
        return moe_ffn(p, x, cfg)
    return dense_ffn(p, x, cfg)


def layer_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, attention=None) -> torch.Tensor:
    return ffn(p, attention_block(p, x, cfg, attention), cfg)


def layer_slice(stacked: Dict[str, torch.Tensor], i: int
                ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves from the stacked layer dict (views)."""
    return {name: a[i] for name, a in stacked.items()}


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
    for i in range(params["layers"]["wq"].shape[0]):
        x = layer_apply(layer_slice(params["layers"], i), x, cfg, attention)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return lm_head_logits(x, params["lm_head"])


def stage_forward(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, attention=None) -> torch.Tensor:
    """A pipeline stage's layers over activations x [b, s, d]."""
    for i in range(stacked["wq"].shape[0]):
        x = layer_apply(layer_slice(stacked, i), x, cfg, attention)
    return x
