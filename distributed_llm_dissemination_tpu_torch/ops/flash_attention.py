"""Blockwise causal GQA attention: the port of the JAX package's one
Pallas kernel (``ops/flash_attention.py::_attn_kernel``).

``block_attention`` computes one (Q block x KV block) partial attention
with the block's own online-softmax statistics: it returns ``(pv, m, l)``
where ``m``/``l`` are the row max and normaliser and ``pv`` the
unnormalised value sum, all f32.  ``pv / l`` is the attention output;
``merge_partials`` combines blocks (ring attention).

One function, a plain version and three Hopper kernels:

- ``block_attention_ref``: plain PyTorch (einsum + where), the twin of
  the JAX package's ``_block_attention_ref``.  It materialises the
  [sq, t] logits.
- ``csrc/attention_decode.cu``: split-KV decode for bf16 calls with at
  most ``DECODE_MAX_ROWS`` query rows per KV head (``g * sq``).  The
  visible keys are cut into chunks (``split_plan``) so the card's SMs all
  work; a second small kernel merges the chunks' partials.
- ``csrc/attention_prefill.cu``: tensor-core prefill (``wgmma`` fed by
  TMA) for every other bf16 call.  It rounds p to bf16 for the PV
  product, which bounds its pv error against the plain version by
  ``2**-9 * l * max|v|`` per row (``BF16_P_REL``).
- ``csrc/block_attention.cu``: the scalar f32 kernel, for f32 inputs.

``kernel_for(sq, g, dtype)`` picks among them; the choice depends on
nothing else.  Each source is built with ``nvcc`` on first use and called
through ``ctypes`` (``ops/cuda_build.py``); its source note gives its
bounds and design.

``block_attention`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the chosen kernel or raises.  ``launches``
counts the calls that launched, and ``launches_by_kernel`` which kernel
served each, so a run can show which path it took.

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
SOURCES = {"decode": "attention_decode.cu",
           "prefill": "attention_prefill.cu",
           "scalar": "block_attention.cu"}
HEAD_DIMS = (32, 64, 128)  # every kernel's template instances
DECODE_MAX_ROWS = 8  # g * sq at or below this takes the decode kernel
SMS = 132  # streaming multiprocessors of an H100 SXM
DECODE_CTAS_PER_SM = 2  # split target: about two decode CTAs per SM
DECODE_CHUNK_ALIGN = 32  # split chunks are whole multiples of this
# bf16 rounding of p in the prefill kernel: |p_bf16 - p| <= 2**-9 * p.
BF16_P_REL = 2.0 ** -9
LOG2E = 1.4426950408889634

# Calls that launched a kernel since the last reset_counts(), in all and
# per kernel (chip_smoke.py zeroes them before driving the main path and
# reads them after).
launches = 0
launches_by_kernel = {name: 0 for name in SOURCES}

_fns = {}
_lib_lock = threading.Lock()
_ONE_PASS_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p])
_ARGTYPES = {
    "decode": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
               + [ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_void_p]),
    "prefill": _ONE_PASS_ARGS,
    "scalar": _ONE_PASS_ARGS,
}
_SYMBOLS = {"decode": "attention_decode_fwd",
            "prefill": "attention_prefill_fwd",
            "scalar": "block_attention_fwd"}


def reset_counts() -> None:
    global launches
    launches = 0
    for name in launches_by_kernel:
        launches_by_kernel[name] = 0


def kernel_for(sq: int, g: int, dtype: torch.dtype) -> str:
    """Which kernel serves a CUDA call: ``"scalar"`` for f32 inputs,
    ``"decode"`` for bf16 with ``g * sq <= DECODE_MAX_ROWS``, else
    ``"prefill"``."""
    if dtype == torch.float32:
        return "scalar"
    return "decode" if g * sq <= DECODE_MAX_ROWS else "prefill"


def visible_keys(sq: int, t: int, q_off: int, k_off: int) -> int:
    """How many leading keys of the block the latest query row can see:
    keys [0, n) are the only ones any row can see."""
    return max(0, min(t, int(q_off) + sq - 1 - int(k_off) + 1))


def split_plan(bh: int, sq: int, t: int, q_off: int, k_off: int):
    """The decode kernel's grid: ``(n_vis, n_split, chunk)``.  Split s
    reads keys ``[s * chunk, min((s + 1) * chunk, n_vis))``; the splits
    cover the visible keys exactly once and none starts past them.  The
    split count aims at ``DECODE_CTAS_PER_SM`` CTAs per SM over the ``bh``
    (batch x KV head) rows of the grid.  With no visible key there is one
    empty split, which reads nothing."""
    n_vis = visible_keys(sq, t, q_off, k_off)
    if n_vis == 0:
        return 0, 1, 0
    want = max(1, -(-DECODE_CTAS_PER_SM * SMS // max(bh, 1)))
    chunk = -(-n_vis // want)
    chunk = -(-chunk // DECODE_CHUNK_ALIGN) * DECODE_CHUNK_ALIGN
    return n_vis, -(-n_vis // chunk), chunk


def _kernel(name: str):
    with _lib_lock:
        if name not in _fns:
            fn = getattr(cuda_build.load(SOURCES[name]), _SYMBOLS[name])
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


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
    take ``block_attention_ref``; CUDA tensors launch the kernel that
    ``kernel_for`` names (hd in ``HEAD_DIMS``), or raise."""
    global launches
    _check(qg, k, v)
    if qg.device.type == "cpu":
        return block_attention_ref(qg, k, v, q_off, k_off)
    if qg.device.type != "cuda":
        raise ValueError(f"unsupported device {qg.device}")
    b, kvh, g, sq, hd = qg.shape
    t = k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernels' {HEAD_DIMS}")
    if any(x.data_ptr() % 16 for x in (qg, k, v)):
        raise ValueError("qg, k and v must start on a 16-byte boundary")
    name = kernel_for(sq, g, qg.dtype)
    fn = _kernel(name)
    bh, rows = b * kvh, g * sq
    n_out = bh * rows
    if name == "decode":
        n_vis, n_split, chunk = split_plan(bh, sq, t, q_off, k_off)
    else:
        n_split = 1
    # One allocation: pv, m, l and, for a split decode, its partials.
    n_part = n_out * n_split if n_split > 1 else 0
    buf = torch.empty(n_out * (hd + 2) + n_part * (hd + 2),
                      dtype=torch.float32, device=qg.device)
    pv = buf[: n_out * hd].view(qg.shape)
    m = buf[n_out * hd : n_out * (hd + 1)].view(qg.shape[:4])
    l = buf[n_out * (hd + 1) : n_out * (hd + 2)].view(qg.shape[:4])
    if n_out == 0:
        return pv, m, l
    stream = torch.cuda.current_stream(qg.device).cuda_stream
    ptrs = (qg.data_ptr(), k.data_ptr(), v.data_ptr(), pv.data_ptr(),
            m.data_ptr(), l.data_ptr())
    if name == "decode":
        part = ptrs[3:]
        if n_part:  # partials follow pv, m, l in the same buffer
            base = buf.data_ptr() + 4 * n_out * (hd + 2)
            part = (base, base + 4 * n_part * hd,
                    base + 4 * n_part * (hd + 1))
        err = fn(*ptrs, *part, bh, rows, sq, t, hd, n_vis, n_split, chunk,
                 int(q_off), int(k_off), LOG2E / math.sqrt(hd), stream)
    elif name == "prefill":
        err = fn(*ptrs, bh, rows, sq, t, hd, int(q_off), int(k_off),
                 LOG2E / math.sqrt(hd), stream)
    else:
        err = fn(*ptrs, bh, rows, sq, t, hd, int(q_off), int(k_off),
                 math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"block_attention {name} kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    launches_by_kernel[name] += 1
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
