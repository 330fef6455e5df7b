"""Plain float32 PyTorch forward of Mistral-7B and Mixtral-8x7B.

Written from the published descriptions (the Mistral 7B paper and the
``MistralForCausalLM``/``MixtralForCausalLM`` definitions): pre-norm
decoder layers with RMSNorm, grouped-query attention with rotary
embeddings on the two halves of each head (query head ``i`` reads KV
head ``i // (heads / kv_heads)``), a causal softmax scaled by
``head_dim ** -0.5``, and a SwiGLU FFN ``w2(silu(x w1) * (x w3))``; for
Mixtral a router whose softmax picks the top 2 experts per token,
renormalised over those two, and only the picked experts computed.  A
final RMSNorm and an untied output head give the logits.

Departures, all of them choices of the benchmark and not of the models:
the weights are the transposes of the published ``nn.Linear`` weights
(``x @ w``, the blob layout of ``layout.py``), the rotary halves are the
published checkpoints' layout (the port's too), no sliding window (the
prompts are far shorter than Mistral's 4096-token window, and v0.3 has
none), and an expert tied with the k-th is kept, as the port keeps it
(float32 router probabilities of random weights do not tie).

Everything runs in float32 with TF32 off, one layer at a time: each
layer's leaves are fetched, widened and dropped before the next, so the
reference fits beside nothing else on a card.  ``variants`` runs the
same forward again with other numerics in the same pass, as the control:
``"fp8"`` rounds every matrix to float8 e4m3 with one absmax scale per
output channel (per row for the embedding) and every activation entering
a weight product to e4m3 with one scale per token.

Routing.  Top-k routing is discontinuous: a token whose second and third
experts score alike in float32 can pick either under any rounding.  So
the judge (the ``"f32"`` variant) can follow given routes (``routes``: a
boolean ``(b, n, experts)`` mask per layer, the experts the judged run
picked), mixing the picked experts with its own float32 router
probabilities renormalised over them; it then reports how far the picked
experts fall below its own top-k (``routing_margin``: the largest
``p_k - min(p of a picked expert)``, 0 where it would pick the same).

"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence, Union

import torch
import torch.nn.functional as F

from ..layout import Shape

LeafFn = Callable[[int], Dict[str, torch.Tensor]]


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8_round(w: torch.Tensor, axis: int) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one absmax scale per slice along
    ``axis``, back in float32."""
    scale = w.abs().amax(dim=axis, keepdim=True) / FP8_MAX
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


FP8_MAX = 448.0
ROUND = {"fp8": fp8_round}


def _variant(leaves: Dict[str, torch.Tensor], kind: str
             ) -> Dict[str, torch.Tensor]:
    if kind == "f32":
        return leaves
    rnd = ROUND[kind]
    out = {}
    for name, w in leaves.items():
        if w.dim() == 1:
            out[name] = w  # norm weights stay as they are
        elif name == "embed":
            out[name] = rnd(w, -1)
        else:
            out[name] = rnd(w, -2)  # per output channel of x @ w
    return out


def _mm(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fp8":
        x = fp8_round(x, -1)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x: (b, s, heads, hd), positions 0..s-1."""
    hd, s = x.shape[-1], x.shape[1]
    inv = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                  device=x.device) / (hd // 2))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, x, s: Shape, kind: str = "f32"):
    b, n, _ = x.shape
    h, kv, hd = s.n_heads, s.n_kv_heads, s.head_dim
    xn = rms_norm(x, p["ln1"], s.norm_eps)
    q = rope(_mm(xn, p["wq"], kind).view(b, n, h, hd), s.rope_theta)
    k = rope(_mm(xn, p["wk"], kind).view(b, n, kv, hd), s.rope_theta)
    v = _mm(xn, p["wv"], kind).view(b, n, kv, hd)
    rep = h // kv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)
    return x + _mm(out.reshape(b, n, h * hd), p["wo"], kind)


def _swiglu(x, w1, w3, w2, kind):
    return _mm(F.silu(_mm(x, w1, kind)) * _mm(x, w3, kind), w2, kind)


def ffn(p, x, s: Shape, kind: str = "f32", route=None):
    """The FFN; for experts also returns the routing mask used and, when
    ``route`` was given, the routing margin (module docstring)."""
    xn = rms_norm(x, p["ln2"], s.norm_eps)
    if not s.n_experts:
        return x + _swiglu(xn, p["w1"], p["w3"], p["w2"], kind), None, None
    flat = xn.reshape(-1, xn.shape[-1])
    probs = _mm(flat, p["router"], kind).softmax(-1)
    kth = probs.topk(s.top_k, dim=-1).values[:, -1]
    if route is None:
        picked = probs >= kth[:, None]
        margin = None
    else:
        picked = route.reshape(-1, s.n_experts).to(probs.device)
        low = torch.where(picked, probs, torch.ones_like(probs)).amin(-1)
        margin = float((kth - low).clamp(min=0).max())
    w = probs * picked
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(flat)
    for e in range(s.n_experts):
        tok = picked[:, e].nonzero(as_tuple=True)[0]
        if tok.numel():
            ye = _swiglu(flat[tok], p["w1"][e], p["w3"][e], p["w2"][e], kind)
            out.index_add_(0, tok, ye * w[tok, e, None])
    return x + out.view_as(x), picked.view(*x.shape[:2], -1), margin


def forward(s: Shape, layer_leaves: LeafFn, head_leaves: Dict[str, torch.Tensor],
            tokens: torch.Tensor, device, variants: Sequence[str] = ("f32",),
            routes: Union[None, str, Sequence[torch.Tensor]] = None) -> dict:
    """``{"logits": {variant: float32 (b, n, vocab)}, "routing_margin":
    float | None}`` for ``tokens``.  ``layer_leaves(i)`` returns layer
    ``i``'s leaves (any device, the served type); ``head_leaves`` the
    embedding, final norm and head.  ``routes``: None, every variant
    routes itself; a mask per layer, the ``"f32"`` judge follows them; a
    variant's name, the judge follows that variant's own routes."""
    order = sorted(variants, key=lambda k: k == "f32")  # the judge last
    margin = None
    with no_tf32(), torch.no_grad():
        head32 = {k: v.to(device).float() for k, v in head_leaves.items()}
        heads = {kind: _variant(head32, kind) for kind in order}
        del head32
        tok = tokens.to(device)
        xs = {kind: heads[kind]["embed"][tok] for kind in order}
        for i in range(s.n_layers):
            p32 = {k: v.to(device).float() for k, v in layer_leaves(i).items()}
            used = {}
            for kind in order:
                p = _variant(p32, kind)
                route = None
                if kind == "f32" and routes is not None:
                    route = used[routes] if isinstance(routes, str) \
                        else routes[i]
                x = attention(p, xs[kind], s, kind)
                xs[kind], used[kind], m = ffn(p, x, s, kind, route)
                if m is not None:
                    margin = m if margin is None else max(margin, m)
                del p
            del p32
        logits = {kind: _mm(rms_norm(xs[kind], heads[kind]["ln_f"],
                                     s.norm_eps), heads[kind]["lm_head"],
                            kind) for kind in order}
    return {"logits": logits, "routing_margin": margin}


def served_gap(ref_logits: torch.Tensor, served_ids: torch.Tensor
               ) -> torch.Tensor:
    """Per position: how far the reference's logit of the served token lies
    below the reference's best logit (0 where they pick the same)."""
    ref = ref_logits.float()
    picked = ref.gather(-1, served_ids.to(ref.device).long()[..., None])[..., 0]
    return ref.max(-1).values - picked
