"""Blockwise causal GQA attention: the port of the JAX package's one
Pallas kernel (``ops/flash_attention.py::_attn_kernel``).

``block_attention`` computes one (Q block x KV block) partial attention
with the block's own online-softmax statistics: it returns ``(pv, m, l)``
where ``m``/``l`` are the row max and normaliser and ``pv`` the
unnormalised value sum, all f32.  ``pv / l`` is the attention output;
``merge_partials`` combines blocks (ring attention).

Two implementations of the one function:

- ``block_attention_ref``: plain PyTorch (einsum + where), the twin of
  the JAX package's ``_block_attention_ref``.  It materialises the
  [sq, t] logits.
- the CUDA kernel ``csrc/block_attention.cu`` for Hopper, built with
  ``nvcc`` on first use and called through ``ctypes``
  (``ops/cuda_build.py``).  Its source note gives its bounds and design.

``block_attention`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; ``launches`` counts
the launches, so a run can show which path it took.

The port's model (``models/llama.py``, ``models/generate.py``) runs
every attention through ``block_attention``: the cache-less forward is
the case ``q_off = k_off = 0``, ``t = s``; a KV-cached step attends the
whole cache with ``q_off = position``, ``k_off = 0``.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import cuda_build

NEG_INF = -1e30  # finite: -inf would make (m - m_new) NaN on empty rows
SOURCE = "block_attention.cu"
HEAD_DIMS = (32, 64, 128)  # the kernel's template instances

# Kernel launches since the last reset (a plain count; chip_smoke.py zeroes
# it before driving the main path and reads it after).
launches = 0

_lib = None
_lib_lock = threading.Lock()


def _kernel():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = cuda_build.load(SOURCE)
            fn = lib.block_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 2
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = fn
        return _lib


def _check(qg, k, v) -> None:
    if qg.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"want qg [b,kvh,g,sq,hd] and k, v [b,kvh,t,hd]; got "
            f"{tuple(qg.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, kvh, _, _, hd = qg.shape
    t = k.shape[2]
    if tuple(k.shape) != (b, kvh, t, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match qg {tuple(qg.shape)}")
    if not (qg.dtype == k.dtype == v.dtype) or qg.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"dtypes must all be float32 or bfloat16, got "
                         f"{qg.dtype}, {k.dtype}, {v.dtype}")
    if not (qg.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {qg.device}, "
                         f"{k.device}, {v.device}")
    if not (qg.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("qg, k and v must be contiguous")


def block_attention_ref(qg, k, v, q_off: int, k_off: int):
    """Plain PyTorch version.  qg: [b, kvh, g, sq, hd]; k, v: [b, kvh, t,
    hd]; ``q_off``/``k_off`` are the blocks' global start positions.
    Returns f32 (pv [b,kvh,g,sq,hd], m [b,kvh,g,sq], l [b,kvh,g,sq])."""
    _check(qg, k, v)
    hd = qg.shape[-1]
    sq, t = qg.shape[3], k.shape[2]
    dev = qg.device
    logits = torch.einsum("bkgsh,bkth->bkgst", qg.float(), k.float())
    logits = logits / math.sqrt(hd)
    q_ids = int(q_off) + torch.arange(sq, device=dev)
    k_ids = int(k_off) + torch.arange(t, device=dev)
    causal = q_ids[:, None] >= k_ids[None, :]
    logits = torch.where(causal, logits, torch.full_like(logits, NEG_INF))
    if t == 0:
        m = torch.full(qg.shape[:4], NEG_INF, dtype=torch.float32, device=dev)
    else:
        m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    # A fully masked row has m == NEG_INF and p == 1 everywhere; zero it so
    # (pv, l) are exact partials (the JAX oracle's rule).
    p = torch.where((m > NEG_INF / 2)[..., None], p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    pv = torch.einsum("bkgst,bkth->bkgsh", p, v.float())
    return pv, m, l


def block_attention(qg, k, v, q_off: int, k_off: int):
    """One KV block's partial attention (module docstring).  CPU tensors
    take ``block_attention_ref``; CUDA tensors launch the Hopper kernel
    (hd in ``HEAD_DIMS``), or raise."""
    global launches
    _check(qg, k, v)
    if qg.device.type == "cpu":
        return block_attention_ref(qg, k, v, q_off, k_off)
    if qg.device.type != "cuda":
        raise ValueError(f"unsupported device {qg.device}")
    b, kvh, g, sq, hd = qg.shape
    t = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    fn = _kernel()
    pv = torch.empty(qg.shape, dtype=torch.float32, device=qg.device)
    m = torch.empty(qg.shape[:4], dtype=torch.float32, device=qg.device)
    l = torch.empty_like(m)
    if pv.numel() == 0:
        return pv, m, l
    stream = torch.cuda.current_stream(qg.device).cuda_stream
    err = fn(qg.data_ptr(), k.data_ptr(), v.data_ptr(), pv.data_ptr(),
             m.data_ptr(), l.data_ptr(), b * kvh, g * sq, sq, t, hd,
             int(q_off), int(k_off), math.sqrt(hd),
             int(qg.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"block_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return pv, m, l


def merge_partials(carry, part):
    """Online-softmax merge of a block's (pv, m, l) into the running
    (o, m, l) accumulator -- all f32."""
    o, m, l = carry
    pv, m_blk, l_blk = part
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_blk - m_new)
    l_new = l * alpha + l_blk * beta
    o_new = o * alpha[..., None] + pv * beta[..., None]
    return o_new, m_new, l_new
