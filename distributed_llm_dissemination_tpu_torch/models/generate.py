"""Autoregressive decoding with a KV cache: the booted engine serves.

PyTorch port of the JAX package's ``models/generate.py``:

- **prefill**: one pass over the prompt that writes every layer's K/V
  into a preallocated cache;
- **decode**: a Python loop of single-token steps (the JAX ``lax.scan``),
  each attending the new query against the whole cache.

Every attention is ``ops.flash_attention.block_attention`` over the full
cache with ``q_off = position`` and ``k_off = 0``: its causal mask is
exactly the JAX mask ``arange(max_len) <= positions``, and the kernel
never loads the cache rows past the position.  The cache is kept as
``[n_layers, b, kvh, max_len, hd]`` -- the kernel's K/V layout -- so a
decode step reads it in place; the JAX package keeps
``[n_layers, b, max_len, kvh, hd]``.

Greedy decoding is argmax; sampling draws from a ``torch.Generator`` and
is not held to JAX's random bits.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..utils.device import resolve_device
from .llama import (
    ModelConfig,
    attend,
    ffn,
    layer_slice,
    lm_head_logits,
    qkv_proj,
    rms_norm,
)

KVCache = Dict[str, torch.Tensor]  # {"k","v"}: [n_layers, b, kvh, max_len, hd]


class MixedVersionError(ValueError):
    """A serving tree was about to assemble from blobs of more than one
    rollout version."""


def ensure_uniform_version(versions: Dict[int, str],
                           expected: str = "") -> str:
    """The live-swap version guard: every blob entering a serving params
    tree must carry the SAME rollout version tag (and, when ``expected``
    is non-empty, exactly that one).  Raises :class:`MixedVersionError`
    otherwise; returns the uniform version."""
    tags = set(versions.values())
    if len(tags) > 1:
        raise MixedVersionError(
            f"refusing to assemble serving params across mixed layer "
            f"versions {sorted(tags)!r}: {dict(sorted(versions.items()))}")
    got = next(iter(tags)) if tags else ""
    if expected and got != expected:
        raise MixedVersionError(
            f"serving params version {got!r} does not match the "
            f"committed version {expected!r}")
    return got


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _layer_with_cache(
    p: Dict[str, torch.Tensor], x: torch.Tensor, start: int,
    k_cache: torch.Tensor, v_cache: torch.Tensor, cfg: ModelConfig,
    attention=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer over ``x`` [b, s, d] at positions ``start..start+s-1``:
    writes this block's K/V into the layer's cache ([b, kvh, max_len,
    hd], in place) at ``start`` and attends against the whole cache.
    Returns (x_out, k_cache, v_cache)."""
    s = x.shape[1]
    positions = torch.arange(start, start + s, device=x.device)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = qkv_proj(p, xn, positions, cfg)
    k_cache[:, :, start : start + s] = k.transpose(1, 2)
    v_cache[:, :, start : start + s] = v.transpose(1, 2)
    out = attend(q, k_cache, v_cache, start, attention)
    x = x + out @ p["wo"]
    return ffn(p, x, cfg), k_cache, v_cache


def _forward_with_cache(params, tokens: torch.Tensor, start: int,
                        cache: KVCache, cfg: ModelConfig, attention=None):
    """Stacked-layer forward that threads the KV cache; returns (f32
    logits for the LAST position [b, vocab], cache)."""
    x = params["embed"][tokens]
    for i in range(cache["k"].shape[0]):
        x, _, _ = _layer_with_cache(layer_slice(params["layers"], i), x,
                                    start, cache["k"][i], cache["v"][i],
                                    cfg, attention)
    x = rms_norm(x[:, -1, :], params["ln_f"], cfg.norm_eps)
    return lm_head_logits(x, params["lm_head"]), cache


def _pick(logits: torch.Tensor, temperature: float,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate_stepwise(
    params_fn: Callable[[], Tuple[Dict[str, Any], str]],
    prompt: torch.Tensor,
    cfg: ModelConfig,
    max_new: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attention=None,
) -> torch.Tensor:
    """Token-at-a-time decoding that RE-READS the serving params before
    every step (the per-token flip granularity): ``params_fn() ->
    (params, version)`` is called once for the prefill and once per
    decode step.  With a constant provider the tokens are exactly
    ``generate``'s."""
    if max_new <= 0:
        raise ValueError(f"max_new must be positive, got {max_new}")
    if temperature > 0 and generator is None:
        raise ValueError("sampling needs a torch.Generator")
    b, p = prompt.shape
    cache = init_cache(cfg, b, p + max_new, device=prompt.device)
    params, _ = params_fn()
    logits, cache = _forward_with_cache(params, prompt, 0, cache, cfg,
                                        attention)
    token = _pick(logits, temperature, generator)
    out = [token]
    for i in range(1, max_new):
        params, _ = params_fn()
        logits, cache = _forward_with_cache(params, token[:, None],
                                            p + i - 1, cache, cfg, attention)
        token = _pick(logits, temperature, generator)
        out.append(token)
    return torch.stack(out, dim=1)


def generate(
    params: Dict[str, Any],
    prompt: torch.Tensor,
    cfg: ModelConfig,
    max_new: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    attention=None,
) -> torch.Tensor:
    """Decode ``max_new`` tokens after ``prompt`` [b, p] (integer ids, on
    the params' device).  temperature 0 = greedy; otherwise softmax
    sampling from ``generator``.  Returns int64 [b, max_new]."""
    return generate_stepwise(lambda: (params, ""), prompt, cfg, max_new,
                             temperature, generator, attention)
