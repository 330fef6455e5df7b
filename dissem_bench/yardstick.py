"""Peaks, and the operations and bytes that a piece of work needs.

The published peaks of one NVIDIA H100 SXM (dense, no sparsity), at the
full 700 W power limit.  A share of a roofline or of a peak is the least
time the work needs at these rates, over the time it took: the larger of
operations over peak FLOP/s and bytes over peak bytes/s, counting each
input byte read once and each output byte written once, and for causal
attention only the visible (query, key) pairs.
"""

from __future__ import annotations

from .layout import Shape, layer_specs, model_nbytes

PEAK_FLOPS = 989e12  # bf16
PEAK_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float, cards: int = 1) -> float:
    """Seconds the work needs at the peaks of ``cards`` cards."""
    return max(flops / (PEAK_FLOPS * cards),
               nbytes / (PEAK_BYTES_PER_S * cards))


def prefill_attention_work(b: int, heads: int, kv_heads: int, sq: int,
                           hd: int, itemsize: int = 2):
    """(operations, bytes) of one K1 prefill launch from position 0 over
    ``sq`` query rows (causal, keys = queries): QK^T and PV over the
    visible pairs; q, k and v read once in the served type; the
    unnormalised output and its two f32 row statistics (m, l) written
    once, as the kernel's interface returns them."""
    pairs = sq * (sq + 1) // 2
    flops = 4 * b * heads * pairs * hd
    read = (b * heads * sq * hd + 2 * b * kv_heads * sq * hd) * itemsize
    written = b * heads * sq * (hd + 2) * 4
    return flops, read + written


def forward_flops(s: Shape, tokens: int) -> float:
    """Operations of one forward over ``tokens`` prompt tokens (batch 1):
    every weight product at 2 ops a weight and token, the experts counted
    at ``top_k`` per token, the causal attention, the output head."""
    per_layer = 0
    for name, shape in layer_specs(s):
        if len(shape) < 2 or name == "router":
            continue
        n = 1
        for dim in shape[-2:]:
            n *= dim
        per_layer += n * (s.top_k if s.n_experts and len(shape) == 3 else 1)
    per_layer += s.d_model * s.n_experts  # the router
    attn, _ = prefill_attention_work(1, s.n_heads, s.n_kv_heads, tokens,
                                     s.head_dim)
    return (2 * per_layer * tokens + attn) * s.n_layers \
        + 2 * s.d_model * s.vocab * tokens


def round_least_time(s: Shape, tokens: int, cards: int,
                     seeders_in_hbm: bool) -> float:
    """Least time of one delivery round and its first forward on
    ``cards`` cards: every goal byte written once into a dest's memory
    and read once by the forward, read once more from a seeder's memory
    where the seeders hold it there, and the forward's operations."""
    goal = model_nbytes(s)
    nbytes = goal * (3 if seeders_in_hbm else 2)
    return least_time(forward_flops(s, tokens), nbytes, cards)
