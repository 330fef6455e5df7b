"""Core identifier and layer-store types.

Copy of the JAX package's ``core/types.py``: a *layer* is an opaque byte
blob that may live in host RAM, on disk, at an external client process, or
in device memory.  The one change: a layer staged on the accelerator holds
a 1-D ``torch.uint8`` tensor on its CUDA device in
``LayerSrc.device_array`` (location ``HBM``), where the JAX package holds a
``jax.Array``.  The *Assignment* (node → layers it must end up holding)
doubles as the stage placement for the model that boots after
dissemination.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Optional, Set, Tuple

# Reference: distributor/node.go:128-129 — uint identifiers.
NodeID = int
LayerID = int

# ---------------------------------------------------------------------------
# Shard specs (docs/sharding.md)
#
# A delivery target is (layer, shard spec): the spec names a DETERMINISTIC
# byte-range slice of the layer, so every plane — planner, wire, digest
# stamp, ack — can derive the same [offset, offset+size) from the spec and
# the layer's total size alone.  Grammar: ``"1/N@K"`` = slice K (0-based)
# of the layer split into N floor-bounded equal ranges (boundary i sits at
# ``i * total // N`` — the same split rule as the transport's stripe
# offsets, so shard edges are stable under any total).  ``""`` = the whole
# layer (the pre-sharding vocabulary; every legacy peer speaks it).
# ---------------------------------------------------------------------------

ShardSpec = str  # "" (full layer) or "1/N@K"


def parse_shard_spec(spec: ShardSpec) -> Optional[Tuple[int, int]]:
    """``"1/N@K"`` → ``(N, K)``; ``""`` → None (full layer).  Raises
    ``ValueError`` on malformed or out-of-range specs — a typo'd spec
    must fail at the plane that first reads it, not deliver the wrong
    byte range."""
    if not spec:
        return None
    try:
        frac, idx = spec.split("@", 1)
        num, den = frac.split("/", 1)
        n, k, one = int(den), int(idx), int(num)
    except (ValueError, AttributeError):
        raise ValueError(f"malformed shard spec {spec!r} (want '1/N@K')")
    if one != 1 or n < 1 or not 0 <= k < n:
        raise ValueError(f"shard spec {spec!r} out of range (want 1/N@K "
                         f"with 0 <= K < N)")
    return n, k


def shard_range(spec: ShardSpec, total: int) -> Tuple[int, int]:
    """The spec's byte range ``(offset, size)`` of a ``total``-byte
    layer.  Floor-bounded equal split: slice K covers
    ``[K*total//N, (K+1)*total//N)``."""
    parsed = parse_shard_spec(spec)
    if parsed is None:
        return 0, total
    n, k = parsed
    start = k * total // n
    end = (k + 1) * total // n
    return start, end - start


def shard_fraction(spec: ShardSpec) -> float:
    """The spec's share of the layer (1.0 = full)."""
    parsed = parse_shard_spec(spec)
    return 1.0 if parsed is None else 1.0 / parsed[0]


def shard_covers(held: ShardSpec, want: ShardSpec) -> bool:
    """Whether a holder of shard ``held`` provably holds every byte of
    shard ``want``, for ANY layer total.  ``""`` (full layer) covers
    everything.  Cross-multiplied rational bounds: range(N, K) =
    [K*T/N, (K+1)*T/N), and floor() preserves the ordering of the
    rational endpoints, so K1/N1 <= K2/N2 and (K1+1)/N1 >= (K2+1)/N2
    imply byte-range containment at every T."""
    h = parse_shard_spec(held)
    if h is None:
        return True
    w = parse_shard_spec(want)
    if w is None:
        return False  # a shard never covers the full layer
    n1, k1 = h
    n2, k2 = w
    return k1 * n2 <= k2 * n1 and (k1 + 1) * n2 >= (k2 + 1) * n1


def shard_specs_for(n: int) -> List[ShardSpec]:
    """The N specs of an N-way split — what a planner targeting a dest
    mesh of N shards (one per PartitionSpec slot along the sharded axis)
    hands out, one per participant."""
    if n <= 1:
        return [""] if n == 1 else []
    return [f"1/{n}@{k}" for k in range(n)]


# ---------------------------------------------------------------------------
# Wire codecs (docs/codec.md)
#
# A transfer may ship a layer in a quantized wire form (``models/quant.py``:
# int8 ~0.50x, int4 ~0.27x of the canonical bytes).  The codec is an
# IDENTITY property of the bytes, not a transport detail: a holding tagged
# ``codec="int8"`` holds the int8-encoded form — a different byte string
# with a different digest — and can only ever satisfy (or re-seed) a target
# planned at that same codec.  ``""`` = the canonical (raw) form.
# ---------------------------------------------------------------------------

WireCodec = str  # "" (canonical bytes) or "int8" / "int4"


def codec_accepts(held: WireCodec, want: WireCodec) -> bool:
    """Whether a holding in wire-codec form ``held`` satisfies a target
    planned at codec ``want``.  Canonical bytes (``""``) satisfy every
    target — raw is the lossless superset any codec can be derived from
    — while a quantized holding satisfies ONLY a target planned at
    exactly that codec: int8 bytes can never complete a raw (or int4)
    demand, which is the "a quantized copy cannot ack as a raw one"
    invariant (docs/codec.md)."""
    return not held or held == want


def codec_capability(codec: WireCodec) -> WireCodec:
    """The CAPABILITY a codec string demands of an encoder.  Most codec
    ids are their own capability; parameterized forms carry their
    parameter after a colon — ``"delta:<base_digest_hex>"`` needs a
    sender with the generic ``"delta"`` capability (announced in
    ``AnnounceMsg.Codecs``) — so every "can this node encode it?" check
    compares the prefix, never the full string (docs/codec.md)."""
    return codec.split(":", 1)[0] if codec else codec


def delta_base_digest(codec: WireCodec) -> str:
    """The base digest a ``"delta:<hex>"`` codec string names, or ``""``
    for every non-delta codec.  The base rides INSIDE the codec string —
    one vocabulary through stamps, caches, sizes, and NACK coordinates —
    so there is no separate base field to skew against the choice."""
    if codec.startswith("delta:"):
        return codec.split(":", 1)[1]
    return ""

# Reference: distributor/node.go:132 — a set of node IDs.
NodeIDs = Set[NodeID]

# Reference: distributor/client.go:10 — clients use the max uint as their ID.
# Python ints are unbounded; pick the Go MaxUint64 for wire compatibility.
CLIENT_ID: NodeID = (1 << 64) - 1


class LayerLocation(enum.IntEnum):
    """Where a layer currently lives (distributor/node.go:182-189).

    ``HBM`` is new: the layer has been materialized as a device tensor on
    the accelerator — the terminal state for this framework's data plane, whereas the
    reference's terminal state is host RAM (``InmemLayer``).
    """

    INMEM = 0
    DISK = 1
    CLIENT = 2
    HBM = 3


class SourceType(enum.IntEnum):
    """Class of a layer's origin, keying per-source rate limits
    (distributor/node.go:192-198)."""

    CLIENT = 0
    DISK = 1
    MEM = 2


@dataclasses.dataclass
class LayerMeta:
    """Per-layer metadata (distributor/node.go:134-138).

    ``data_size`` is an extension over the reference: announce messages
    carry each layer's size so a mode-3 leader can schedule layers it does
    not itself hold (the reference's announce drops sizes, so its flow
    solver zero-sizes peer-only layers).

    ``shard`` (docs/sharding.md): the shard spec this entry refers to.
    In an *assignment*, the target — the dest must end up holding that
    byte range; in a *status/announce* row, the holding — the node holds
    ONLY that range (``data_size`` stays the FULL layer size; the spec
    qualifies which bytes of it are real).  ``""`` = the whole layer.
    Omitted-at-default on the wire (legacy peers never see the key).

    ``version`` (docs/swap.md): the model-rollout version this entry
    belongs to.  In an *assignment*, the target version — only a
    holding tagged with the SAME version satisfies it (a stale
    unversioned copy of a reused layer id can never complete a v2
    rollout pair); in a *status/announce* row, the version the holder
    verified the bytes under.  ``""`` = the pre-swap vocabulary (every
    legacy peer); omitted-at-default on the wire.

    ``codec`` (docs/codec.md): the wire-codec form of the bytes.  In an
    *assignment*, the codec the leader CHOSE for this transfer (the
    dest will receive — and is satisfied by — the encoded form); in a
    *status/announce* row, the form the holder actually holds
    (``data_size`` is then the ENCODED byte count — the bytes that
    exist and can be range-served).  ``""`` = canonical bytes (every
    pre-codec peer); omitted-at-default on the wire."""

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


# Reference: distributor/node.go:141 — map[LayerID]LayerMeta, a set with
# metadata.  JSON keys are strings, mirroring Go's map encoding.
LayerIDs = Dict[LayerID, LayerMeta]


def layer_ids_to_json(layers: LayerIDs) -> dict:
    return {str(lid): meta.to_json() for lid, meta in layers.items()}


def layer_ids_from_json(d: dict) -> LayerIDs:
    return {int(lid): LayerMeta.from_json(meta) for lid, meta in d.items()}


@dataclasses.dataclass
class LayerSrc:
    """A layer's storage record (distributor/node.go:200-211).

    Exactly one of ``inmem_data`` / ``fp`` / client-location describes where
    the bytes are; ``device_array`` is the device extension — once a
    layer has been staged into HBM it is a 1-D uint8 CUDA tensor and ``meta.location``
    is ``LayerLocation.HBM``.
    """

    inmem_data: Optional[bytearray] = None
    fp: str = ""  # file path when on disk
    data_size: int = 0
    offset: int = 0
    meta: LayerMeta = dataclasses.field(default_factory=LayerMeta)
    # The layer materialized on device (1-D uint8 tensor), if staged.
    device_array: object = None
    # Guards the one-time device→host materialization of ensure_host_bytes.
    _host_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # Set by the fabric upload cache when a whole-layer device_put failed
    # for this record — later plans then stick to range uploads instead of
    # re-reading a multi-GiB layer just to fail the same allocation again.
    upload_failed: bool = dataclasses.field(
        default=False, repr=False, compare=False
    )
    # Zero-copy receive: the transport landed this fragment's bytes
    # DIRECTLY in the destination's reassembly buffer (TcpTransport
    # ``layer_sink``).  ``inmem_data`` is then None and this carries the
    # already-held coverage claim token the fragment handler must commit
    # — the bytes were never materialized anywhere else.
    placed_token: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _host_resident(self) -> bool:
        """Host bytes available?  True for INMEM, and for HBM-staged layers
        whose host buffer was retained (staging keeps ``inmem_data``, so an
        HBM layer can still be *served* to peers over the host transport)."""
        return (
            self.meta.location in (LayerLocation.INMEM, LayerLocation.HBM)
            and self.inmem_data is not None
        )

    def read_bytes(self) -> bytes:
        """This record's own bytes (a received fragment's buffer, or a full
        in-RAM layer).  For slicing a *source* store by offset/data_size use
        ``read_range`` — the two differ only for INMEM records, where this
        returns the whole buffer."""
        if self._host_resident():
            return bytes(self.inmem_data)
        return self.read_range()

    def read_range(self) -> bytes:
        """The byte range ``[offset, offset+data_size)`` of this source
        store — what a transport actually puts on the wire.  ``offset``
        indexes into the full layer (RAM buffer or file)."""
        return self.read_span(0, self.data_size)

    def read_span(self, off: int, size: int) -> bytes:
        """The byte range ``[offset+off, offset+off+size)`` of this
        source store — the one place that knows every backing kind's
        range semantics (RAM slice, file seek+read, HBM fetch).  Only the
        requested span touches host RAM for disk-backed stores; HBM-only
        stores materialize once via ``ensure_host_bytes``."""
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
        """Materialize a host copy of an HBM-only layer (e.g. delivered
        over the pod fabric, where no host copy ever existed) from its
        device array — one device→host fetch, cached in ``inmem_data`` so
        re-serving the layer to peers or assembling it at boot doesn't
        re-fetch.  Returns whether host bytes are now available.  The
        fetch is once-guarded: concurrent callers (e.g. two flow jobs for
        the same layer on the handler pool) must not each pull a
        multi-GiB transfer and spike host RAM."""
        if self.inmem_data is not None:
            return True
        if self.device_array is None:
            return False
        with self._host_lock:
            if self.inmem_data is None:
                self.inmem_data = bytearray(
                    self.device_array.cpu().numpy().tobytes())
        return True


# Reference: distributor/node.go:166 — node's layer store.
LayersSrc = Dict[LayerID, LayerSrc]

# Reference: distributor/node.go:174-176 — the goal state (node → layers it
# must hold) and the leader's live view of who holds what.
Assignment = Dict[NodeID, LayerIDs]
Status = Dict[NodeID, LayerIDs]


def assignment_to_json(a: Assignment) -> dict:
    return {str(nid): layer_ids_to_json(layers) for nid, layers in a.items()}


def assignment_from_json(d: dict) -> Assignment:
    return {int(nid): layer_ids_from_json(layers) for nid, layers in d.items()}


@dataclasses.dataclass
class RoutingInfo:
    """Next-hop entry (distributor/node.go:168-171)."""

    next_hop: NodeID
    remaining_hops: int = 1


def delivered(meta: LayerMeta) -> bool:
    """Whether a layer counts as delivered for assignment satisfaction.

    The reference requires ``InmemLayer`` (distributor/node.go:435-446);
    this build additionally accepts HBM, which is strictly "more
    delivered" — the bytes are already on the accelerator.

    NOTE: location only.  A sharded target's satisfaction additionally
    requires the held shard to COVER the assigned one — use
    :func:`satisfies` wherever an assignment meta is being checked
    against a status meta.
    """
    return meta.location in (LayerLocation.INMEM, LayerLocation.HBM)


def satisfies(held: Optional[LayerMeta], want: LayerMeta) -> bool:
    """Whether a status entry ``held`` satisfies the assignment target
    ``want``: delivered-grade location AND the held shard covers the
    wanted one (a shard-holder never satisfies a full-layer target;
    docs/sharding.md) AND the version matches (docs/swap.md).

    Version semantics mirror shard coverage: a VERSIONED target is met
    only by a holding verified under exactly that version, while an
    UNVERSIONED target ("" — every pre-swap job) accepts any verified
    holding of the id, versioned or not — a later push/repair job over
    already-swapped layer ids must not wedge on the tag (the digest
    plane, not the tag, governs content).

    Codec semantics (docs/codec.md) are STRICT the other way: the
    target's codec is the leader's chosen wire form for the pair, and a
    quantized holding satisfies only that exact codec (canonical bytes
    satisfy everything) — int8 bytes must never complete a raw demand."""
    return (held is not None and delivered(held)
            and shard_covers(held.shard, want.shard)
            and (not want.version or held.version == want.version)
            and codec_accepts(held.codec, want.codec))
