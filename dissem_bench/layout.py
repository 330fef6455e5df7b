"""The model shape and the blob layout, frozen here.

A copy of the layout the port serialises a model into (one blob per
layer, then one head blob), kept in the benchmark so that a change to
the program's layout shows as a failed comparison instead of moving the
yardstick:

- blob ``i < n_layers``: layer ``i``'s leaves in this order, each as
  raw C-order bytes: ``wq (d, h*hd)``, ``wk (d, kv*hd)``, ``wv (d,
  kv*hd)``, ``wo (h*hd, d)``, ``ln1 (d,)``, ``ln2 (d,)``, then for a
  dense FFN ``w1 (d, f)``, ``w3 (d, f)``, ``w2 (f, d)``, for experts
  ``router (d, e)``, ``w1 (e, d, f)``, ``w3 (e, d, f)``, ``w2 (e, f,
  d)``;
- blob ``n_layers`` (the head): ``embed (vocab, d)``, ``ln_f (d,)``,
  ``lm_head (d, vocab)``.

Weights act as ``x @ w`` (the stored matrices are the transposes of the
published checkpoints' ``nn.Linear`` weights).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class Shape:
    """A decoder's sizes as the benchmark reads them from a config file."""

    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_id(self) -> int:
        return self.n_layers

    @property
    def blob_ids(self) -> List[int]:
        return list(range(self.n_layers + 1))


def layer_specs(s: Shape) -> List[Spec]:
    d, f, h, kv, hd = s.d_model, s.d_ff, s.n_heads, s.n_kv_heads, s.head_dim
    specs: List[Spec] = [("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                         ("wv", (d, kv * hd)), ("wo", (h * hd, d)),
                         ("ln1", (d,)), ("ln2", (d,))]
    if s.n_experts:
        e = s.n_experts
        specs += [("router", (d, e)), ("w1", (e, d, f)), ("w3", (e, d, f)),
                  ("w2", (e, f, d))]
    else:
        specs += [("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d))]
    return specs


def head_specs(s: Shape) -> List[Spec]:
    return [("embed", (s.vocab, s.d_model)), ("ln_f", (s.d_model,)),
            ("lm_head", (s.d_model, s.vocab))]


def blob_specs(s: Shape, blob_id: int) -> List[Spec]:
    return head_specs(s) if blob_id == s.head_id else layer_specs(s)


def offsets(specs: List[Spec]) -> Dict[str, Tuple[int, int]]:
    """Each leaf's [start, end) in elements of the blob."""
    out, pos = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        out[name] = (pos, pos + n)
        pos += n
    return out


def blob_elems(s: Shape, blob_id: int) -> int:
    return sum(math.prod(shape) for _, shape in blob_specs(s, blob_id))


def blob_nbytes(s: Shape, blob_id: int) -> int:
    return blob_elems(s, blob_id) * s.dtype.itemsize


def model_nbytes(s: Shape) -> int:
    return sum(blob_nbytes(s, b) for b in s.blob_ids)


def leaves(s: Shape, blob_id: int, blob_u8: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """The leaves of one blob as dtype views of its bytes (no copy)."""
    flat = blob_u8.view(s.dtype)
    if flat.numel() != blob_elems(s, blob_id):
        raise ValueError(f"blob {blob_id}: {flat.numel()} elements, layout "
                         f"has {blob_elems(s, blob_id)}")
    return {name: flat[a:b].view(shape) for (name, shape), (a, b) in
            zip(blob_specs(s, blob_id),
                offsets(blob_specs(s, blob_id)).values())}
