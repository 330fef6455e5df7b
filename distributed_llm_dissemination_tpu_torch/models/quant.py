"""Codec-dispatch facade between the boot and the blob decoders.

Port of the JAX package's ``models/quant.py`` facade (``:478-560``) for
the raw codec.  The boot (``runtime/boot.py``) and the streaming stager
(``runtime/stream_boot.py``) reach the decoders only through these calls,
so adding a codec touches this module only.  The int8/int4 codecs and
their entropy forms are not ported yet: naming one raises
``NotImplementedError`` pointing at the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from . import serde
from .llama import ModelConfig
from .serde import head_blob_id, head_param_specs, layer_param_specs

CODECS = ("raw", "int8", "int4", "int8e", "int4e")
# Entropy wire forms over the quantized bases (the JAX package's
# ``models/entropy.py``); named here so config validation can refuse them
# as canonical forms exactly as the JAX package does.
ENTROPY_CODECS = {"int8e": "int8", "int4e": "int4"}


def _require_raw(codec: str) -> None:
    if codec == "raw":
        return
    if codec in CODECS:
        raise NotImplementedError(
            f"codec {codec!r} is not ported yet (ROADMAP, port Queue 2: "
            f"K2 int8 / K3 int4 dequant kernels)")
    raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")


def blob_nbytes_codec(cfg: ModelConfig, blob_id: int, codec: str) -> int:
    """Exact wire size of a blob under ``codec``."""
    _require_raw(codec)
    return serde.blob_nbytes(cfg, blob_id)


def encode_blob(cfg: ModelConfig, blob_id: int, raw: bytes,
                codec: str) -> bytes:
    """A raw blob's wire form under ``codec`` (raw: the bytes as given)."""
    _require_raw(codec)
    return raw


def device_decode_jit(codec: str, donate: bool = False):
    """THE device-decode callable for ``codec``:
    ``f(blobs_u8_tuple, specs_tuple, dtype) -> {name: (n, *shape)}``.
    For raw blobs a one-blob call returns dtype views of the blob (no
    copy); n blobs stack (one copy).  ``donate`` is accepted for the
    JAX package's signature and changes nothing: the caller releases a
    consumed blob by dropping its reference."""
    _require_raw(codec)

    def decode(blobs_u8, specs, dtype) -> Dict[str, torch.Tensor]:
        per_blob = [serde.decode_device(b, specs, dtype) for b in blobs_u8]
        if len(per_blob) == 1:
            return {name: a.unsqueeze(0) for name, a in per_blob[0].items()}
        return {name: torch.stack([lp[name] for lp in per_blob])
                for name, _ in specs}

    return decode


def decode_blob_host(cfg: ModelConfig, blob_id: int, data,
                     codec: str) -> Dict[str, torch.Tensor]:
    """Host path: decode one wire blob into {name: cfg.dtype CPU tensor}."""
    _require_raw(codec)
    return serde._split_blob(cfg, data, serde.blob_specs(cfg, blob_id))


def decode_to_raw(cfg: ModelConfig, blob_id: int, data, codec: str) -> bytes:
    """The canonical raw blob bytes of a wire-codec blob."""
    _require_raw(codec)
    return bytes(data)


def stacked_from_blobs_host(cfg: ModelConfig, blobs: Dict[int, Any],
                            layer_ids: Sequence[int], codec: str
                            ) -> Dict[str, torch.Tensor]:
    """Host path: stacked layer params from wire blobs under ``codec``."""
    _require_raw(codec)
    return serde.stacked_from_blobs(cfg, blobs, layer_ids)


def head_from_blob_host(cfg: ModelConfig, data, codec: str):
    """Host path: head leaves from the wire head blob under ``codec``."""
    return decode_blob_host(cfg, head_blob_id(cfg), data, codec)


def stacked_from_device(cfg: ModelConfig, blob_arrays: Sequence[torch.Tensor],
                        codec: str, donate: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Device path: stacked layer params from device-resident wire blobs."""
    return device_decode_jit(codec, donate)(
        tuple(blob_arrays), tuple(layer_param_specs(cfg)), cfg.dtype)


def head_from_device(cfg: ModelConfig, blob_u8: torch.Tensor, codec: str,
                     donate: bool = False) -> Dict[str, torch.Tensor]:
    """Device path: head leaves from the device-resident wire head blob."""
    decoded = device_decode_jit(codec, donate)(
        (blob_u8,), tuple(head_param_specs(cfg)), cfg.dtype)
    return {name: arr[0] for name, arr in decoded.items()}
