"""Quantized transfer codecs: shrink the bytes a layer costs on the wire.

Port of the JAX package's ``models/quant.py``.  The wire formats are the
same bytes in both packages (leaves in ``serde``'s canonical order):

- **int8** (~0.50x bf16): per leaf, ``rows`` f32 scales then
  ``rows x cols`` int8 values, a leaf of shape ``(..., cols)`` flattened to
  ``(rows, cols)`` -- per-row symmetric absmax scaling, ``x_hat = q *
  scale``.
- **int4** (~0.27x bf16): per leaf, ``rows x groups`` f32 scales (groups
  of 128 columns where 128 divides ``cols``, else one per row) then
  ``rows x cols/2`` packed bytes; byte ``j`` of a row holds column ``j``'s
  nibble (low) and column ``j + cols/2``'s (high).  Leaves that cannot
  pack (1-D norm gains, odd columns) ride raw inside the blob.
- **int8e** / **int4e**: the base form run through the DLE1 block coder
  (``models/entropy.py``); their size depends on the bytes.

Encoding is deterministic round-to-nearest on the host, with numpy, in
the JAX package's order of operations, so independent seeders -- JAX or
port -- agree byte for byte.  The JAX package reads bf16 through
``ml_dtypes``; the port needs no such package: a bf16 value's f32 is its
16 bits shifted up (``_leaf_f32``), which is exact.

Decoding goes through ``ops/dequant.py``: a blob on the CPU takes the
plain PyTorch version, a blob on the CUDA device the hand-written kernel
(K2 for int8, K3 for int4), one launch per blob, each leaf written
straight into its output.  Either way every element is ``float(q) *
scale`` in f32 rounded once to ``cfg.dtype`` -- bit-identical to the JAX
package's host and device decodes.  Entropy forms have no device decode:
they unwrap on the host first (``host_unwrap``).

Codec choice is carried by the topology config (``ModelCodec``) next to
``Model``/``ModelSeed``: every node derives identical blob sizes from
(model, codec) alone.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import dequant
from . import serde
from .llama import ModelConfig
from .serde import (Spec, blob_specs, head_blob_id, head_param_specs,
                    layer_param_specs)

CODECS = ("raw", "int8", "int4", "int8e", "int4e")
# Entropy wire forms (models/entropy.py): the quantized base form run
# through the DLE1 block coder.  Sizes are data-dependent -- the codec
# plane prices them by encoding (``WireCodecPlane.ensure_sized``) -- and
# decode is host-first (``host_unwrap``), then the base codec's paths.
ENTROPY_CODECS = {"int8e": "int8", "int4e": "int4"}
_SCALE_DT = np.float32
_QMAX = 127.0
_QMAX4 = 7.0
_GROUP4 = 128  # int4 scale-group width


def _rows_cols(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 1:
        return 1, shape[0]
    return int(np.prod(shape[:-1])), shape[-1]


def _q4_layout(shape: Tuple[int, ...], itemsize: int):
    """One leaf's int4 wire layout: ``("raw", nbytes)`` for leaves that
    can't pack (1-D norm gains, odd columns), else
    ``("q4", rows, cols, groups)`` with groups of ``cols // groups``
    columns sharing one f32 scale."""
    rows, cols = _rows_cols(shape)
    if len(shape) == 1 or cols % 2:
        return ("raw", rows * cols * itemsize)
    g = _GROUP4 if cols % _GROUP4 == 0 else cols
    return ("q4", rows, cols, cols // g)


def _q4_leaf_nbytes(layout) -> int:
    if layout[0] == "raw":
        return layout[1]
    _, rows, cols, groups = layout
    return rows * groups * _SCALE_DT().itemsize + rows * (cols // 2)


def leaf_table(codec: str, specs: Sequence[Spec],
               dtype: torch.dtype) -> List[dequant.Leaf]:
    """The ``int8``/``int4`` wire layout of a blob of ``specs`` leaves in
    ``dtype``: one ``ops.dequant.Leaf`` per leaf, in blob order.  The int4
    layout depends on ``dtype`` (raw leaves ride in it), so an f32 and a
    bf16 model of the same shapes give different blobs."""
    if codec not in ("int8", "int4"):
        raise ValueError(f"no leaf table for codec {codec!r}")
    table, off = [], 0
    for name, shape in specs:
        rows, cols = _rows_cols(shape)
        if codec == "int8":
            n = rows * _SCALE_DT().itemsize + rows * cols
            leaf = dequant.Leaf(name, tuple(shape), "q8", off, n, rows, cols, 1)
        else:
            layout = _q4_layout(shape, dtype.itemsize)
            n = _q4_leaf_nbytes(layout)
            groups = 0 if layout[0] == "raw" else layout[3]
            leaf = dequant.Leaf(name, tuple(shape), layout[0], off, n, rows,
                                cols, groups)
        table.append(leaf)
        off += n
    return table


def blob_nbytes_codec(cfg: ModelConfig, blob_id: int, codec: str) -> int:
    """Exact wire size of a blob under ``codec``.  Entropy forms raise:
    their size depends on the bytes, not just (model, codec) -- callers
    price them through the codec plane's true-size cache."""
    if codec == "raw":
        return serde.blob_nbytes(cfg, blob_id)
    if codec in ENTROPY_CODECS:
        raise ValueError(
            f"codec {codec!r} is data-dependent; size it by encoding "
            "(WireCodecPlane.ensure_sized), not from the model config")
    if codec not in ("int8", "int4"):
        raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")
    return sum(leaf.nbytes for leaf in
               leaf_table(codec, blob_specs(cfg, blob_id), cfg.dtype))


def _leaf_f32(buf: np.ndarray, off: int, count: int,
              dtype: torch.dtype) -> np.ndarray:
    """``count`` elements of ``dtype`` at byte ``off`` of ``buf``, as f32
    (exact: a bf16 value is the top half of its f32)."""
    if dtype == torch.bfloat16:
        u16 = buf[off:off + 2 * count].view(np.uint16)
        return (u16.astype(np.uint32) << 16).view(np.float32)
    if dtype == torch.float32:
        return buf[off:off + 4 * count].view(np.float32).astype(np.float32)
    raise ValueError(f"quantized codecs take bfloat16 or float32, not {dtype}")


def encode_specs(specs: Sequence[Spec], dtype: torch.dtype, raw,
                 codec: str) -> bytes:
    """Encode a raw blob of ``specs`` leaves in ``dtype`` into its
    ``int8``/``int4`` wire form (``encode_blob`` for a model's blob)."""
    if codec not in ("int8", "int4"):
        raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")
    buf = np.frombuffer(memoryview(raw), dtype=np.uint8)
    itemsize = dtype.itemsize
    parts: List[bytes] = []
    off = 0
    for _, shape in specs:
        rows, cols = _rows_cols(shape)
        n = rows * cols * itemsize
        if codec == "int8":
            x = _leaf_f32(buf, off, rows * cols, dtype).reshape(rows, cols)
            off += n
            scale = np.abs(x).max(axis=1) / _QMAX
            scale = np.where(scale > 0, scale, 1.0).astype(_SCALE_DT)
            q = np.clip(np.rint(x / scale[:, None]), -_QMAX,
                        _QMAX).astype(np.int8)
            parts.append(scale.tobytes())
            parts.append(q.tobytes())
            continue
        layout = _q4_layout(shape, itemsize)
        if layout[0] == "raw":
            parts.append(buf[off:off + n].tobytes())
            off += n
            continue
        _, rows, cols, groups = layout
        g = cols // groups
        x = _leaf_f32(buf, off, rows * cols, dtype).reshape(rows, cols)
        off += n
        scale = np.abs(x).reshape(rows, groups, g).max(axis=2) / _QMAX4
        scale = np.where(scale > 0, scale, 1.0).astype(_SCALE_DT)
        q = np.clip(
            np.rint(x.reshape(rows, groups, g) / scale[:, :, None]),
            -_QMAX4, _QMAX4,
        ).astype(np.int8).reshape(rows, cols)
        c2 = cols // 2
        packed = (((q[:, :c2] + 8) & 0xF)
                  | (((q[:, c2:] + 8) & 0xF) << 4)).astype(np.uint8)
        parts.append(scale.tobytes())
        parts.append(packed.tobytes())
    if off != len(buf):
        raise ValueError(f"raw blob size {len(buf)} != expected {off}")
    return b"".join(parts)


def encode_blob(cfg: ModelConfig, blob_id: int, raw: bytes,
                codec: str) -> bytes:
    """Encode a raw (cfg.dtype) blob into its wire form under ``codec``."""
    if codec == "raw":
        return raw
    if codec in ENTROPY_CODECS:
        from . import entropy

        return entropy.encode(
            encode_blob(cfg, blob_id, raw, ENTROPY_CODECS[codec]))
    return encode_specs(blob_specs(cfg, blob_id), cfg.dtype, raw, codec)


def decode_specs(blob: torch.Tensor, specs: Sequence[Spec],
                 dtype: torch.dtype, codec: str) -> Dict[str, torch.Tensor]:
    """One ``int8``/``int4`` wire blob (a 1-D uint8 tensor) -> {name: leaf
    of ``dtype``} on the blob's device, through ``ops.dequant``."""
    table = leaf_table(codec, specs, dtype)
    out = {leaf.name: torch.empty(leaf.shape, dtype=dtype, device=blob.device)
           for leaf in table}
    dequant.dequant(codec, blob, table, [out[leaf.name] for leaf in table])
    return out


def decode_blob_host(cfg: ModelConfig, blob_id: int, data,
                     codec: str) -> Dict[str, torch.Tensor]:
    """Host path: decode one wire blob into {name: cfg.dtype CPU tensor}."""
    specs = blob_specs(cfg, blob_id)
    if codec == "raw":
        return serde._split_blob(cfg, data, specs)
    if codec in ENTROPY_CODECS:
        from . import entropy

        return decode_blob_host(cfg, blob_id, entropy.decode(data),
                                ENTROPY_CODECS[codec])
    if codec not in ("int8", "int4"):
        raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")
    return decode_specs(serde._host_u8(data), specs, cfg.dtype, codec)


def decode_to_raw(cfg: ModelConfig, blob_id: int, data, codec: str) -> bytes:
    """The canonical raw blob bytes of a wire-codec blob: host decode, then
    the leaves concatenated in ``serde``'s spec order (the receiver's
    normalization path; lossy by the quantization the operator chose)."""
    if codec == "raw":
        return bytes(data)
    decoded = decode_blob_host(cfg, blob_id, data, codec)
    return b"".join(serde._leaf_bytes(decoded[name])
                    for name, _ in blob_specs(cfg, blob_id))


def host_unwrap(codec: str, data) -> Tuple[str, Any]:
    """Peel an entropy wire form back to its quantized base on the host.
    Returns ``(base_codec, base_bytes)`` -- identity for every other
    codec -- so device-path callers can keep their dispatch unchanged."""
    base = ENTROPY_CODECS.get(codec)
    if base is None:
        return codec, data
    from . import entropy

    return base, entropy.decode(data)


def device_decode_jit(codec: str, donate: bool = False):
    """THE device-decode callable for ``codec``:
    ``f(blobs_u8_tuple, specs_tuple, dtype) -> {name: (n, *shape)}``.
    Raw blobs become dtype views of their bytes (one blob: no copy; n
    blobs stack).  int8/int4 blobs launch K2/K3 once each, every leaf
    written into slot ``i`` of its preallocated ``(n, *shape)`` output.
    Entropy forms raise: they unwrap on the host first.  ``donate`` is
    accepted for the JAX package's signature and changes nothing: the
    caller releases a consumed blob by dropping its reference."""
    if codec in ENTROPY_CODECS:
        raise ValueError(
            f"codec {codec!r} has no device decode program -- entropy "
            "forms unwrap on the host first (host_unwrap), then the base "
            "codec's decode applies")
    if codec == "raw":
        def decode(blobs_u8, specs, dtype) -> Dict[str, torch.Tensor]:
            per_blob = [serde.decode_device(b, specs, dtype) for b in blobs_u8]
            if len(per_blob) == 1:
                return {name: a.unsqueeze(0)
                        for name, a in per_blob[0].items()}
            return {name: torch.stack([lp[name] for lp in per_blob])
                    for name, _ in specs}

        return decode
    if codec not in ("int8", "int4"):
        raise ValueError(f"unknown codec {codec!r}; known: {CODECS}")

    def decode_quant(blobs_u8, specs, dtype) -> Dict[str, torch.Tensor]:
        table = leaf_table(codec, specs, dtype)
        dev = blobs_u8[0].device
        out = {leaf.name: torch.empty((len(blobs_u8), *leaf.shape),
                                      dtype=dtype, device=dev)
               for leaf in table}
        for i, blob in enumerate(blobs_u8):
            dequant.dequant(codec, blob, table,
                            [out[leaf.name][i] for leaf in table])
        return out

    return decode_quant


def stacked_from_blobs_host(cfg: ModelConfig, blobs: Dict[int, Any],
                            layer_ids: Sequence[int], codec: str
                            ) -> Dict[str, torch.Tensor]:
    """Host path: stacked layer params from wire blobs under ``codec``."""
    if codec == "raw":
        return serde.stacked_from_blobs(cfg, blobs, layer_ids)
    per_layer = [decode_blob_host(cfg, lid, blobs[lid], codec)
                 for lid in layer_ids]
    return {name: torch.stack([lp[name] for lp in per_layer])
            for name, _ in layer_param_specs(cfg)}


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


def codec_bench(cfg: Optional[ModelConfig] = None, blob_id: int = 0,
                device=None) -> dict:
    """Micro-bench the wire codecs on this host and ``device`` (None = the
    CUDA card): the measured basis of the codec-choice threshold
    (``DLD_CODEC_MIN_RATE``).  Returns {codec: {encoded_bytes, ratio,
    encode_gbps, decode_host_gbps, decode_device_gbps}} over one seeded
    blob of ``cfg`` (default: "tiny2"); rates are raw GB per second,
    unrounded.
    The device row decodes a blob already on ``device``: K2/K3 on the
    card, their plain versions on the CPU; an entropy form's row is its
    boot path (host unwrap, then the base decode)."""
    import time

    from ..utils.device import resolve_device, synchronize
    from . import entropy

    if cfg is None:
        from .llama import CONFIGS

        cfg = CONFIGS["tiny2"]
    dev = resolve_device(device)
    raw = serde.seeded_blob(cfg, blob_id, 0, device=dev)
    specs = tuple(blob_specs(cfg, blob_id))

    def rate(fn, nbytes: int) -> float:
        fn()  # warm (kernel library, allocator)
        t0 = time.monotonic()
        n = 0
        while time.monotonic() - t0 < 0.2:
            fn()
            n += 1
        dt = time.monotonic() - t0
        return nbytes * n / max(dt, 1e-9) / 1e9

    def to_dev(b):
        return serde._host_u8(b).to(dev)

    out: dict = {"raw_bytes": len(raw)}
    for codec in ("int8", "int4", "int8e", "int4e"):
        enc = encode_blob(cfg, blob_id, raw, codec)
        if codec in ENTROPY_CODECS:
            def dev_decode(e=enc, c=codec):
                b, bb = host_unwrap(c, e)
                device_decode_jit(b)((to_dev(bb),), specs, cfg.dtype)
                synchronize(dev)
        else:
            arr = to_dev(enc)

            def dev_decode(a=arr, c=codec):
                device_decode_jit(c)((a,), specs, cfg.dtype)
                synchronize(dev)

        out[codec] = {
            "encoded_bytes": len(enc),
            "ratio": len(raw) / len(enc),
            "encode_gbps": rate(
                lambda c=codec: encode_blob(cfg, blob_id, raw, c), len(raw)),
            "decode_host_gbps": rate(
                lambda c=codec, e=enc: decode_blob_host(cfg, blob_id, e, c),
                len(raw)),
            "decode_device_gbps": rate(dev_decode, len(raw)),
        }

    # Content-delta form over a ~1%-perturbed v2 of the same blob (the
    # rollout shape the delta codec exists for).  No device row: deltas
    # reconstruct to raw on the host before the ack.
    rng = np.random.default_rng(1)
    v2 = np.frombuffer(raw, np.uint8).copy()
    touched = rng.choice(len(v2), size=max(1, len(v2) // 100), replace=False)
    v2[touched] ^= rng.integers(1, 256, size=len(touched)).astype(np.uint8)
    v2b = v2.tobytes()
    denc = entropy.delta_encode(v2b, raw)
    out["delta"] = {
        "encoded_bytes": len(denc),
        "ratio": len(raw) / len(denc),
        "encode_gbps": rate(lambda: entropy.delta_encode(v2b, raw), len(raw)),
        "decode_host_gbps": rate(lambda: entropy.delta_decode(denc, raw),
                                 len(raw)),
        "decode_device_gbps": 0.0,
    }
    return out
