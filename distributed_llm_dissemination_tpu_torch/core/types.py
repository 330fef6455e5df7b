"""Core identifier and layer-store types.

Copy of the JAX package's ``core/types.py`` layer-store vocabulary
(``LayerLocation``, ``SourceType``, ``LayerMeta``, ``LayerSrc``).  The one
change: a layer staged on the accelerator holds a 1-D ``torch.uint8``
tensor on its CUDA device in ``LayerSrc.device_array`` (location ``HBM``),
where the JAX package holds a ``jax.Array``.  The shard, codec and
assignment helpers wait for the control-plane slice.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, Optional

NodeID = int
LayerID = int
ShardSpec = str  # "" (full layer) or "1/N@K"
WireCodec = str  # "" (canonical bytes) or "int8" / "int4"


class LayerLocation(enum.IntEnum):
    """Where a layer currently lives.  ``HBM``: materialised as a device
    tensor on the accelerator (here a CUDA device)."""

    INMEM = 0
    DISK = 1
    CLIENT = 2
    HBM = 3


class SourceType(enum.IntEnum):
    """Class of a layer's origin, keying per-source rate limits."""

    CLIENT = 0
    DISK = 1
    MEM = 2


@dataclasses.dataclass
class LayerMeta:
    """Per-layer metadata.  ``data_size`` is the layer's byte size;
    ``shard``/``version``/``codec`` qualify which bytes, which rollout
    version and which wire form a row refers to ("" = full, unversioned,
    canonical) -- omitted-at-default on the wire."""

    location: LayerLocation = LayerLocation.INMEM
    limit_rate: int = 0  # bytes/sec; 0 = unlimited
    source_type: SourceType = SourceType.MEM
    data_size: int = 0  # bytes; 0 = unknown
    shard: ShardSpec = ""  # "" = full layer
    version: str = ""  # "" = unversioned (pre-swap)
    codec: WireCodec = ""  # "" = canonical bytes (pre-codec)

    def to_json(self) -> dict:
        out = {
            "Location": int(self.location),
            "LimitRate": self.limit_rate,
            "SourceType": int(self.source_type),
            "DataSize": self.data_size,
        }
        if self.shard:
            out["Shard"] = str(self.shard)
        if self.version:
            out["Version"] = str(self.version)
        if self.codec:
            out["Codec"] = str(self.codec)
        return out

    @classmethod
    def from_json(cls, d: dict) -> "LayerMeta":
        return cls(
            location=LayerLocation(d.get("Location", 0)),
            limit_rate=int(d.get("LimitRate", 0)),
            source_type=SourceType(d.get("SourceType", 0)),
            data_size=int(d.get("DataSize", 0)),
            shard=str(d.get("Shard", "")),
            version=str(d.get("Version", "")),
            codec=str(d.get("Codec", "")),
        )


LayerIDs = Dict[LayerID, LayerMeta]


@dataclasses.dataclass
class LayerSrc:
    """A layer's storage record.

    Exactly one of ``inmem_data`` / ``fp`` / client-location describes where
    the bytes are; ``device_array`` is the accelerator copy -- a 1-D
    ``torch.uint8`` tensor on the CUDA device once the layer is staged,
    with ``meta.location == LayerLocation.HBM``."""

    inmem_data: Optional[bytearray] = None
    fp: str = ""  # file path when on disk
    data_size: int = 0
    offset: int = 0
    meta: LayerMeta = dataclasses.field(default_factory=LayerMeta)
    device_array: object = None
    # Guards the one-time device->host materialisation of ensure_host_bytes.
    _host_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    upload_failed: bool = dataclasses.field(
        default=False, repr=False, compare=False
    )
    placed_token: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _host_resident(self) -> bool:
        """Host bytes available?  True for INMEM, and for HBM-staged layers
        whose host buffer was retained."""
        return (
            self.meta.location in (LayerLocation.INMEM, LayerLocation.HBM)
            and self.inmem_data is not None
        )

    def read_bytes(self) -> bytes:
        """This record's own bytes (a received fragment's buffer, or a full
        in-RAM layer)."""
        if self._host_resident():
            return bytes(self.inmem_data)
        return self.read_range()

    def read_range(self) -> bytes:
        """The byte range ``[offset, offset+data_size)`` of this store."""
        return self.read_span(0, self.data_size)

    def read_span(self, off: int, size: int) -> bytes:
        """The byte range ``[offset+off, offset+off+size)`` of this store
        (RAM slice, file seek+read, or a device fetch)."""
        base = self.offset + off
        if self._host_resident():
            return bytes(memoryview(self.inmem_data)[base : base + size])
        if self.meta.location == LayerLocation.DISK and self.fp:
            with open(self.fp, "rb") as f:
                f.seek(base)
                return f.read(size)
        if self.ensure_host_bytes():
            return bytes(memoryview(self.inmem_data)[base : base + size])
        raise ValueError(
            f"layer has no host-readable bytes (location={self.meta.location!r})"
        )

    def ensure_host_bytes(self) -> bool:
        """Materialise a host copy of a device-only layer from its device
        tensor -- one device->host fetch, cached in ``inmem_data`` and
        once-guarded.  Returns whether host bytes are now available."""
        if self.inmem_data is not None:
            return True
        if self.device_array is None:
            return False
        with self._host_lock:
            if self.inmem_data is None:
                self.inmem_data = bytearray(
                    self.device_array.cpu().numpy().tobytes())
        return True


LayersSrc = Dict[LayerID, LayerSrc]
