"""Model params <-> disseminable layer blobs.

PyTorch port of the JAX package's ``models/serde.py``; the blob format is
byte-identical:

- Blob ``i`` for ``0 <= i < n_layers`` is layer ``i``'s weights -- each
  leaf in the fixed ``layer_param_specs`` order, as raw C-order bytes of
  ``cfg.dtype``.
- Blob ``head_blob_id(cfg) == n_layers`` holds ``embed``, ``ln_f``,
  ``lm_head`` (same encoding).

Two decode paths, bit-identical by construction:

- **host**: CPU tensors over the blob bytes (``_split_blob``);
- **device**: a blob already on the device as a 1-D ``torch.uint8``
  tensor is reinterpreted in place (``decode_device``): each leaf is a
  ``.view(cfg.dtype)`` of its byte slice, no copy and no kernel.  The JAX
  package needs a widening program here (``_bytes_to_wide``) to dodge a
  TPU tiled-layout padding; a CUDA tensor has no such layout.  A dtype
  view needs the slice's byte offset to be a multiple of the itemsize,
  which raw leaves always satisfy (every leaf is a whole number of
  elements).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .llama import ModelConfig, init_head_params, init_layer_params

Spec = Tuple[str, Tuple[int, ...]]


def layer_param_specs(cfg: ModelConfig) -> List[Spec]:
    """(name, shape) of one layer's leaves, in canonical blob order."""
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs: List[Spec] = [
        ("wq", (d, h * hd)),
        ("wk", (d, kv * hd)),
        ("wv", (d, kv * hd)),
        ("wo", (h * hd, d)),
        ("ln1", (d,)),
        ("ln2", (d,)),
    ]
    if cfg.n_experts:
        e = cfg.n_experts
        specs += [
            ("router", (d, e)),
            ("w1", (e, d, f)),
            ("w3", (e, d, f)),
            ("w2", (e, f, d)),
        ]
    else:
        specs += [("w1", (d, f)), ("w3", (d, f)), ("w2", (f, d))]
    return specs


def head_param_specs(cfg: ModelConfig) -> List[Spec]:
    """(name, shape) of the non-layer leaves, in canonical blob order."""
    return [
        ("embed", (cfg.vocab, cfg.d_model)),
        ("ln_f", (cfg.d_model,)),
        ("lm_head", (cfg.d_model, cfg.vocab)),
    ]


def head_blob_id(cfg: ModelConfig) -> int:
    """The blob id carrying embed/ln_f/lm_head: one past the layers."""
    return cfg.n_layers


def blob_specs(cfg: ModelConfig, blob_id: int) -> List[Spec]:
    return (head_param_specs(cfg) if blob_id == head_blob_id(cfg)
            else layer_param_specs(cfg))


def blob_nbytes(cfg: ModelConfig, blob_id: int) -> int:
    """Exact byte size of a blob (== cfg.layer_nbytes() for layer blobs)."""
    return (sum(int(np.prod(s)) for _, s in blob_specs(cfg, blob_id))
            * cfg.dtype.itemsize)


def _leaf_bytes(a) -> bytes:
    """A leaf's raw C-order bytes (torch tensor on any device, or numpy)."""
    if isinstance(a, torch.Tensor):
        flat = a.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).cpu().numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _encode(leaves: Sequence[Any]) -> bytes:
    return b"".join(_leaf_bytes(a) for a in leaves)


def blobs_from_params(cfg: ModelConfig, params: Dict[str, Any]) -> Dict[int, bytes]:
    """Serialise a full params dict into its dissemination blobs."""
    layers = params["layers"]
    specs = layer_param_specs(cfg)
    blobs: Dict[int, bytes] = {}
    for i in range(cfg.n_layers):
        blobs[i] = _encode([layers[name][i] for name, _ in specs])
    blobs[head_blob_id(cfg)] = _encode(
        [params[name] for name, _ in head_param_specs(cfg)])
    return blobs


def _host_u8(data) -> torch.Tensor:
    """A 1-D uint8 CPU tensor over a host byte buffer: zero-copy for a
    writable buffer, one copy for a read-only one (``bytes``), which a
    tensor may not alias."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    if not buf.flags.writeable:
        buf = buf.copy()
    return torch.from_numpy(buf)


def decode_device(blob_u8: torch.Tensor, specs: Sequence[Spec],
                  dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """One 1-D uint8 blob tensor -> {name: leaf}, each leaf a dtype view of
    its byte slice (same device, no copy).  Raises if the blob's size
    does not match the specs."""
    if blob_u8.dim() != 1 or blob_u8.dtype != torch.uint8:
        raise ValueError("blob must be a 1-D uint8 tensor")
    item = dtype.itemsize
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in specs:
        n = int(np.prod(shape)) * item
        out[name] = blob_u8[off : off + n].view(dtype).reshape(shape)
        off += n
    if off != blob_u8.shape[0]:
        raise ValueError(f"blob size {blob_u8.shape[0]} != expected {off}")
    return out


def _split_blob(cfg: ModelConfig, data, specs: List[Spec]
                ) -> Dict[str, torch.Tensor]:
    """Host path: CPU tensors of one blob's leaves."""
    return decode_device(_host_u8(data), specs, cfg.dtype)


def params_from_blobs(cfg: ModelConfig, blobs: Dict[int, Any]) -> Dict[str, Any]:
    """Host path: the full params dict from all blobs (CPU tensors)."""
    missing = [i for i in range(cfg.n_layers + 1) if i not in blobs]
    if missing:
        raise ValueError(f"missing blobs for full model: {missing}")
    head = head_from_blob(cfg, blobs[head_blob_id(cfg)])
    return {
        "embed": head["embed"],
        "layers": stacked_from_blobs(cfg, blobs, range(cfg.n_layers)),
        "ln_f": head["ln_f"],
        "lm_head": head["lm_head"],
    }


def head_from_blob(cfg: ModelConfig, data) -> Dict[str, torch.Tensor]:
    """Host path: embed/ln_f/lm_head over the head blob's bytes."""
    return _split_blob(cfg, data, head_param_specs(cfg))


def stacked_from_blobs(cfg: ModelConfig, blobs: Dict[int, Any],
                       layer_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Host path: stacked params for a contiguous subset of layers."""
    specs = layer_param_specs(cfg)
    per_layer = [_split_blob(cfg, blobs[i], specs) for i in layer_ids]
    return {name: torch.stack([lp[name] for lp in per_layer])
            for name, _ in specs}


def seeded_blob(cfg: ModelConfig, blob_id: int, seed: int = 0,
                device=None) -> bytes:
    """Fabricate ONE blob of a seeded model without materialising the
    rest: the blob's leaves are drawn from a ``torch.Generator`` seeded by
    ``(seed, blob_id)`` on ``device`` (None = the CUDA card), with the
    shapes, scales and draw order of the JAX package's
    ``init_layer_params``/``init_head_params``.

    The bytes differ from the JAX package's ``seeded_blob`` (threefry):
    a port seeder and a JAX seeder fabricate different weights from the
    same seed.  Port seeders agree with each other only on one device
    type: a CUDA generator and a CPU generator draw different bytes from
    the same seed, so a seeder with a card and one without disagree."""
    dev = resolve_device(device)
    if not 0 <= blob_id <= head_blob_id(cfg):
        raise ValueError(f"blob {blob_id} out of range for {cfg.name}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1_000_003 + blob_id)
    if blob_id == head_blob_id(cfg):
        leaves = init_head_params(cfg, gen, dev)
    else:
        leaves = init_layer_params(cfg, gen, dev)
    return _encode([leaves[name] for name, _ in blob_specs(cfg, blob_id)])


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (what JAX hands out): torch.from_numpy
        # refuses it, so move the bits as uint16 and view them back.
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(np_params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A JAX params pytree as numpy arrays -> the port's dict of tensors on
    ``device`` (None = the CUDA card), with the same structure (``embed``,
    ``layers`` stacked, ``ln_f``, ``lm_head``) and bit-identical values."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor_from_numpy(x).to(dev)

    return conv(np_params)
