"""Weights and prompts from ``--seed``, made by the benchmark itself.

A holder's blobs are drawn on its device by one ``torch.Generator`` there,
in the type they are served in: the holder's layer blobs are rows of one
tensor, and each leaf is one ``normal_`` call over that leaf's columns of
every row (ten calls for the layers, three for the head).  Matrices are
N(0, 1/fan_in); the norms' weights N(1, 0.05^2), so that a norm that is
skipped or misapplied shows in the logits.  The same seed and the same
traffic give the same bytes; the port's own seeded draws are not used.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import layout
from .layout import Shape

NORM_STD = 0.05
_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def mix(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from the run's seed and some salt."""
    x = int(seed) & (2 ** 64 - 1)
    for s in salt:
        x = (x * _MIX[0] + (int(s) + 1) * _MIX[1]) % 2 ** 64
        x ^= x >> 31
    return x % 2 ** 63


def _fill(rows: torch.Tensor, specs, fan_in, g: torch.Generator) -> None:
    for (name, shape), (a, b) in zip(specs, layout.offsets(specs).values()):
        cols = rows[:, a:b]
        if name.startswith("ln"):
            cols.normal_(1.0, NORM_STD, generator=g)
        else:
            cols.normal_(0.0, fan_in(name, shape) ** -0.5, generator=g)


def _fan_in(name: str, shape) -> int:
    if name == "embed":
        return shape[1]
    return shape[-2]


def make_blobs(shape: Shape, blob_ids: List[int], seed: int, salt: int,
               device) -> Dict[int, torch.Tensor]:
    """``{blob_id: 1-D uint8 tensor}`` on ``device`` for ``blob_ids``.
    The layer blobs are views of one ``(n, elems)`` tensor."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, salt))
    out: Dict[int, torch.Tensor] = {}
    layers = [b for b in blob_ids if b != shape.head_id]
    if layers:
        specs = layout.layer_specs(shape)
        rows = torch.empty((len(layers), layout.blob_elems(shape, 0)),
                           dtype=shape.dtype, device=device)
        _fill(rows, specs, _fan_in, g)
        for i, b in enumerate(layers):
            out[b] = rows[i].view(torch.uint8)
    if shape.head_id in blob_ids:
        specs = layout.head_specs(shape)
        row = torch.empty((1, layout.blob_elems(shape, shape.head_id)),
                          dtype=shape.dtype, device=device)
        _fill(row, specs, _fan_in, g)
        out[shape.head_id] = row[0].view(torch.uint8)
    return out


def prompt(shape: Shape, seed: int, round_index: int, tokens: int
           ) -> torch.Tensor:
    """Round ``round_index``'s prompt ids ``(1, tokens)`` on the CPU; the
    warm-up round is index -1."""
    g = torch.Generator()
    g.manual_seed(mix(seed, 1 << 20, round_index + 1))
    return torch.randint(0, shape.vocab, (1, tokens), generator=g)
