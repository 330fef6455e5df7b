"""Ring attention: sequence parallelism over a mesh axis, with the
block-attention kernel (K1) in the role it was written for.

Port of the JAX package's ``parallel/ring_attention.py``
(``ring_attention``, ``_ring_forward``, ``_ring_attention_bwd``).  The
sequence is sharded over an axis (``sp`` in the training step): each rank
keeps its query block and the key/value blocks travel around the ring by
``ppermute``.  Each step computes one (query block x key/value block)
partial ``(pv, m, l)`` at the blocks' global offsets with
``ops.flash_attention.block_attention`` -- the Hopper kernel on CUDA
tensors, the plain version on CPU tensors -- and folds it into the
running output with ``merge_partials``.  Blocks strictly in a row
block's future are skipped, and so is the last rotation, as in JAX.

``RingAttention`` is a ``torch.autograd.Function`` with the JAX package's
custom backward: it saves only this rank's shard ``(qg, kt, vt, out_g,
lse)`` and recomputes ``p = exp(s - lse)`` block by block while dK/dV
accumulators ride the ring with the key/value blocks and arrive home
after n hops.  The JAX backward is einsums, not a Pallas kernel, so this
one is plain ``torch.einsum`` in f32 too.

Numerics.  The JAX forward keeps p in f32 for the PV product (the TPU
kernel and its lax oracle both do); the port's prefill kernel rounds p to
the input type, as the serving model's ``gqa_attention`` does, so on the
card the ring's output carries that rounding (at most
``flash_attention.p_round_bound`` per row of each block) and its
gradients follow from it.  On the CPU the plain version keeps p in f32,
as JAX does.

``attention``: None runs ``block_attention``; passing
``block_attention_ref`` runs the same ring through the plain version
(what a comparison on the card holds the kernel against).
"""

from __future__ import annotations

import math

import torch

from ..ops.flash_attention import NEG_INF, block_attention, merge_partials
from . import axes
from .axes import _permute


def _ring_perm(n: int):
    return [(j, (j + 1) % n) for j in range(n)]


def _rotate(x, axis, n, mesh):
    return _permute(x, axis, _ring_perm(n), mesh) if n > 1 else x


def _ring_forward(q, k, v, axis, s_local, attention, mesh):
    """The forward ring; returns out plus the kernel-layout tensors and
    per-row log-sum-exp the backward needs."""
    fn = block_attention if attention is None else attention
    n, my = mesh.axis_size(axis), mesh.axis_index(axis)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    # [b, s, kvh, g, hd] -> the kernel's layouts, contiguous, done once.
    qg = q.reshape(b, sq, kvh, group, hd).permute(0, 2, 3, 1, 4).contiguous()
    kt = k.transpose(1, 2).contiguous()  # [b, kvh, t, hd]: the ring carry
    vt = v.transpose(1, 2).contiguous()
    q_off = my * s_local
    dev = q.device
    o = torch.zeros((b, kvh, group, sq, hd), dtype=torch.float32, device=dev)
    m = torch.full((b, kvh, group, sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, kvh, group, sq), dtype=torch.float32, device=dev)
    k_blk, v_blk = kt, vt
    for i in range(n):
        src = (my - i) % n  # the block in hand started at rank src
        if src <= my:  # a block strictly in the future contributes nothing
            part = fn(qg, k_blk, v_blk, q_off, src * s_local)
            o, m, l = merge_partials((o, m, l), part)
        if i < n - 1:  # the last rotation's blocks would be discarded
            k_blk = _rotate(k_blk, axis, n, mesh)
            v_blk = _rotate(v_blk, axis, n, mesh)
    l_safe = torch.clamp(l, min=1e-30)
    out_g = o / l_safe[..., None]  # normalised, f32, kernel layout
    lse = m + torch.log(l_safe)
    out = out_g.to(v.dtype).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out, (qg, kt, vt, out_g, lse)


def _ring_backward(axis, s_local, mesh, res, dout):
    """Flash-style ring backward: p recomputed per block from lse; dK/dV
    ride the rotating carry and return home after n hops."""
    qg, kt, vt, out_g, lse = res
    n, my = mesh.axis_size(axis), mesh.axis_index(axis)
    b, kvh, group, sq, hd = qg.shape
    scale = 1.0 / math.sqrt(hd)
    h = kvh * group
    dev = qg.device
    dg = (dout.reshape(b, sq, kvh, group, hd).permute(0, 2, 3, 1, 4)
          .float())
    d_row = torch.einsum("bkgsh,bkgsh->bkgs", dg, out_g)
    q_ids = my * s_local + torch.arange(sq, device=dev)
    qg32 = qg.float()
    k_blk, v_blk = kt, vt
    dk_blk = torch.zeros((b, kvh, s_local, hd), dtype=torch.float32,
                         device=dev)
    dv_blk = torch.zeros_like(dk_blk)
    dq = torch.zeros((b, kvh, group, sq, hd), dtype=torch.float32,
                     device=dev)
    for i in range(n):
        src = (my - i) % n  # the forward's visiting order
        if src <= my:  # a future block has p == 0 for every row
            k32, v32 = k_blk.float(), v_blk.float()
            s = torch.einsum("bkgsh,bkth->bkgst", qg32, k32) * scale
            k_ids = src * s_local + torch.arange(s_local, device=dev)
            causal = q_ids[:, None] >= k_ids[None, :]
            s = torch.where(causal, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lse[..., None])  # masked entries give 0
            del s
            dv_blk = dv_blk + torch.einsum("bkgst,bkgsh->bkth", p, dg)
            dp = torch.einsum("bkgsh,bkth->bkgst", dg, v32)
            ds = p * (dp - d_row[..., None]) * scale
            del p, dp
            dq = dq + torch.einsum("bkgst,bkth->bkgsh", ds, k32)
            dk_blk = dk_blk + torch.einsum("bkgst,bkgsh->bkth", ds, qg32)
            del ds
        if i < n - 1:  # K/V are dead after the last accumulation
            k_blk = _rotate(k_blk, axis, n, mesh)
            v_blk = _rotate(v_blk, axis, n, mesh)
        dk_blk = _rotate(dk_blk, axis, n, mesh)  # dK/dV need all n hops
        dv_blk = _rotate(dv_blk, axis, n, mesh)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(qg.dtype)
    dk = dk_blk.transpose(1, 2).to(kt.dtype)
    dv = dv_blk.transpose(1, 2).to(vt.dtype)
    return dq, dk, dv


class RingAttention(torch.autograd.Function):
    """The ring with its custom backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, s_local, attention, mesh):
        out, res = _ring_forward(q, k, v, axis, s_local, attention, mesh)
        ctx.save_for_backward(*res)
        ctx.axis, ctx.s_local, ctx.mesh = axis, s_local, mesh
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _ring_backward(ctx.axis, ctx.s_local, ctx.mesh,
                                    ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str, s_local: int, attention=None) -> torch.Tensor:
    """Causal GQA ring attention inside ``axes.manual(mesh)``.

    q: [b, s_local, h, hd] -- this rank's query block (heads may be
    tp-sharded; grouping is h // kvh locally).  k, v: [b, s_local, kvh,
    hd] -- this rank's key/value block, rotary-encoded with global
    positions.  Returns [b, s_local, h, hd] in v's dtype."""
    return RingAttention.apply(q, k, v, axis, s_local, attention,
                               axes.current())
