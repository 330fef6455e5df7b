"""End-to-end payload integrity primitives (docs/integrity.md).

The dissemination path moves physical-size layers through sockets, stripe
regrouping, zero-copy placement, a crash-durable journal, and device
staging — and historically never checksummed a byte anywhere: one flipped
bit silently booted a corrupted model.  This module is the shared
vocabulary of the integrity plane:

- **Per-fragment checksum** (``fragment_checksum``): an advisory
  checksum stamped on every layer frame (``transport/messages.
  LayerHeader``), verified by the receiving transport BEFORE the
  fragment is delivered — a bad frame is dropped and NACKed
  (``LayerNackMsg``), never committed to interval accounting, the
  journal, or a device buffer.  The algorithm is picked by measurement
  (``hash_bench`` on the running host; TTD_MATRIX.md records it):
  xxh3-64 when the ``xxhash`` extension is importable — it is the only
  candidate that tracks the wire rate here (~6x stdlib ``zlib.crc32``)
  — falling back to crc32 otherwise.  Negotiation is per frame,
  omitted-field style: the header carries ``Xxh3`` or ``Crc``, and the
  receiver verifies whichever is present (a receiver without ``xxhash``
  treats an xxh3-stamped frame as unstamped — advisory, never a drop).
- **Per-layer digest** (``layer_digest``): a digest of the whole layer,
  announced by every holder, collected by the leader, and stamped to
  each assignee (``LayerDigestsMsg``).  The end-to-end backstop:
  receivers verify a completed layer against it before acking/staging,
  and a mismatch re-opens the covered intervals instead of acking.
  Digest strings are self-describing (``xxh3:<hex>`` / bare hex =
  blake2b-128), so both algorithms interoperate: xxh3-128 is the
  default where available — the threat model is CORRUPTION (wire, DMA,
  disk rot), against which 128 random-collision bits are equivalent and
  ~11x cheaper on this host than blake2b (``hash_bench``); set
  ``DLD_DIGEST_ALGO=blake2b`` where the model includes adversarial
  substitution and a cryptographic identity is worth the measured cost.

Both checks are wire-compatible (omitted-field style) and individually
gated: ``DLD_WIRE_CRC=0`` / ``DLD_LAYER_DIGESTS=0`` disable them.
Verification *cost* accounting uses ``time.thread_time`` (CPU seconds,
not preemption-inflated wall spans) — on a contended host a wall-clock
span around a hash mostly measures the scheduler.
"""

from __future__ import annotations

import hashlib
import os
import time
import zlib
from typing import List, Optional, Tuple

from . import threads, trace

try:  # hot-path accelerator; every check below falls back to stdlib
    import xxhash as _xxhash
except ImportError:  # pragma: no cover - container-dependent
    _xxhash = None

# blake2b truncated to 128 bits: collision-resistant far past this
# system's layer counts, and half the hex bytes on the control plane.
DIGEST_SIZE = 16

_DIGEST_CHUNK = 8 << 20  # streaming-digest read granularity

# A holder's layers are hashed on the digest pool only where there are
# two or more and their bytes reach this: handing a layer to a worker
# costs tens of microseconds, well under 1% of hashing 64 MiB (about
# 12 ms at one thread's 5.3 GB/s).  Smaller holdings hash inline.
POOLED_STAMP_MIN_BYTES = 64 << 20

# The wall time in which any holder's stamp hash ran, on any thread.
_stamp_busy = trace.Busy("integrity_digest_stamp_busy")


def wire_crc_enabled() -> bool:
    """Per-fragment wire CRC (default ON; ``DLD_WIRE_CRC=0`` disables)."""
    return os.environ.get("DLD_WIRE_CRC", "1") != "0"


def digests_enabled() -> bool:
    """Per-layer blake2b digests (default ON; ``DLD_LAYER_DIGESTS=0``
    disables — the wire CRC still guards individual fragments)."""
    return os.environ.get("DLD_LAYER_DIGESTS", "1") != "0"


def fragment_crc(view) -> int:
    """crc32 of a fragment payload (bytes/bytearray/memoryview).
    zlib.crc32 runs in C with the GIL released for large buffers, so
    concurrent stripe receivers really verify in parallel."""
    return zlib.crc32(view) & 0xFFFFFFFF


def fragment_checksum(view) -> Tuple[str, int]:
    """The checksum a SENDER stamps on a frame: ``("xxh3", v)`` when the
    ``xxhash`` extension is importable, else ``("crc32", v)``.  Both C
    implementations release the GIL for large buffers, so concurrent
    stripe receivers really verify in parallel — and xxh3 sustains ~6x
    the crc32 rate on this host (``hash_bench``), which is what keeps
    the per-stripe check off the wire's critical path."""
    if _xxhash is not None:
        return "xxh3", _xxhash.xxh3_64_intdigest(view)
    return "crc32", zlib.crc32(view) & 0xFFFFFFFF


def checksum_of(view, algo: str) -> Optional[int]:
    """Compute the named fragment checksum, or None when this host
    can't (xxh3 stamp, no ``xxhash`` here — the check is advisory, so
    an unverifiable stamp reads as unstamped, never as corrupt)."""
    if algo == "crc32":
        return zlib.crc32(view) & 0xFFFFFFFF
    if algo == "xxh3" and _xxhash is not None:
        return _xxhash.xxh3_64_intdigest(view)
    return None


def verify_stamp(view, crc: Optional[int] = None,
                 xxh3: Optional[int] = None) -> Optional[bool]:
    """Verify a frame payload against its stamped checksum, preferring
    the xxh3 stamp when this host can compute it.  Returns None when the
    frame is EFFECTIVELY unstamped — no stamp at all, or an xxh3 stamp
    with no ``xxhash`` here (advisory: unverifiable never reads as
    corrupt) — else whether the payload matches."""
    if xxh3 is not None and _xxhash is not None:
        return _xxhash.xxh3_64_intdigest(view) == xxh3
    if crc is not None:
        return (zlib.crc32(view) & 0xFFFFFFFF) == crc
    return None


def file_checksum(path: str, offset: int, size: int) -> Tuple[str, int]:
    """Streaming ``fragment_checksum`` of a file range — what a DISK
    sender stamps (one warm page-cache sweep; the body itself still
    leaves via kernel ``sendfile``)."""
    if _xxhash is None:
        return "crc32", file_crc(path, offset, size)
    h = _xxhash.xxh3_64()
    with open(path, "rb") as f:
        f.seek(offset)
        left = size
        while left > 0:
            chunk = f.read(min(_DIGEST_CHUNK, left))
            if not chunk:
                raise ValueError(f"short read checksumming {path}")
            h.update(chunk)
            left -= len(chunk)
    return "xxh3", h.intdigest()


def file_crc(path: str, offset: int, size: int) -> int:
    """Chunked crc32 of a file range — the disk-body variant of
    ``fragment_crc`` (one warm page-cache sweep; senders still ship the
    bytes via kernel ``sendfile``)."""
    crc = 0
    with open(path, "rb") as f:
        f.seek(offset)
        left = size
        while left > 0:
            chunk = f.read(min(_DIGEST_CHUNK, left))
            if not chunk:
                raise ValueError(f"short read computing crc of {path}")
            crc = zlib.crc32(chunk, crc)
            left -= len(chunk)
    return crc & 0xFFFFFFFF


def digest_algo() -> str:
    """The layer-digest algorithm this process STAMPS (verification is
    driven by the stamp's own prefix, so mixed clusters interoperate).
    Default: xxh3-128 where available — against the corruption threat
    model its 128 collision bits are equivalent to blake2b's at ~11x
    less CPU on this host (``hash_bench``); ``DLD_DIGEST_ALGO=blake2b``
    buys a cryptographic identity where adversarial substitution is in
    scope (TTD_MATRIX.md records the measured cost of each)."""
    algo = os.environ.get("DLD_DIGEST_ALGO", "").strip().lower()
    if algo in ("blake2b", "xxh3"):
        if algo == "xxh3" and _xxhash is None:
            return "blake2b"
        return algo
    return "xxh3" if _xxhash is not None else "blake2b"


def _digest_hasher(algo: str):
    if algo == "xxh3":
        if _xxhash is None:
            raise ValueError("xxh3 digest stamped but xxhash is not "
                             "importable on this host")
        return _xxhash.xxh3_128()
    return hashlib.blake2b(digest_size=DIGEST_SIZE)


def layer_digest(data, algo: Optional[str] = None) -> str:
    """Self-describing hex digest of a full layer's bytes:
    ``xxh3:<hex>`` for xxh3-128, bare hex for blake2b-128 (the
    pre-negotiation format, so old stamps still verify)."""
    algo = algo or digest_algo()
    h = _digest_hasher(algo)
    h.update(data)
    hx = h.hexdigest()
    return f"xxh3:{hx}" if algo == "xxh3" else hx


def stamp_algo(stamp: str) -> str:
    """The algorithm a self-describing digest stamp was made with.
    Digests from holders with different capabilities (one has the
    ``xxhash`` extension, one doesn't) differ as STRINGS over identical
    bytes — conflict detection must only compare same-algorithm
    stamps."""
    return "xxh3" if stamp.startswith("xxh3:") else "blake2b"


def digest_check(data, expected: str) -> Tuple[Optional[bool], float, str]:
    """Verify ``data`` against a stamped digest using the STAMP's own
    algorithm (self-describing prefix — a blake2b stamp must never be
    "verified" with local xxh3).  THE one home of the stamp-format
    policy; every verifier (ack gate, boot, resume) routes through it.
    Returns ``(ok, thread_seconds, got)``: ``ok`` is None for an
    unverifiable stamp (xxh3 with no xxhash here — advisory, never
    read as corrupt), else whether the bytes match; ``thread_seconds``
    is the hash's CPU cost (``time.thread_time``) for the callers'
    trace buckets; ``got`` is the computed digest ("" when skipped)."""
    algo = "xxh3" if expected.startswith("xxh3:") else "blake2b"
    if algo == "xxh3" and _xxhash is None:
        return None, 0.0, ""
    t0 = time.thread_time()
    got = layer_digest(data, algo=algo)
    return got == expected, time.thread_time() - t0, got


def digest_matches(data, expected: str) -> bool:
    """Verify ``data`` against a stamped digest, using the STAMP's own
    algorithm (prefix); an unverifiable stamp (xxh3 with no xxhash
    here) is advisory-skipped as True, never read as corrupt."""
    ok, _, _ = digest_check(data, expected)
    return ok is not False


def report_corrupt_frame(on_corrupt, src_id, layer_id, offset: int,
                         size: int, total: int, reason: str,
                         stripe: str = "", silent: bool = False,
                         dest_id=None) -> None:
    """THE shared drop-report for both transports: one log wording (the
    ttd harness greps it), one counter scheme, one ``on_corrupt`` firing
    discipline — so inmem- and tcp-backed runs account corruption
    identically.  ``silent`` counts+logs without firing the hook (the
    regroup path reports the whole span itself).  ``dest_id``: the
    dropping transport's bound node id, so the drop also lands on the
    (src, dest) link of the telemetry flight recorder."""
    from .logging import log
    from . import telemetry, trace

    extra = {"stripe": stripe} if stripe else {}
    log.error("corrupt layer fragment dropped", layerID=layer_id,
              offset=offset, size=size, reason=reason, **extra)
    if reason == "stale":
        trace.count("integrity.stale_prune")
    else:
        trace.count("integrity.crc_drop")
        trace.count("integrity.crc_drop_bytes", size)
        telemetry.link_add(src_id, dest_id, crc_drops=1,
                           crc_drop_bytes=size)
    if silent:
        return
    fire_on_corrupt(on_corrupt, src_id, layer_id, offset, size, total,
                    reason)


def fire_on_corrupt(on_corrupt, src_id, layer_id, offset: int, size: int,
                    total: int, reason: str) -> None:
    """The one ``on_corrupt`` firing discipline: a raising hook must
    never wedge a receive path.  Used by ``report_corrupt_frame`` and by
    the stripe-regroup span report (which logs/counts per stripe but
    NACKs the whole logical span, so it fires the hook directly)."""
    if on_corrupt is None:
        return
    from .logging import log
    try:
        on_corrupt(src_id, layer_id, offset, size, total, reason)
    except Exception as e:  # noqa: BLE001 — reporting must not wedge rx
        log.error("on_corrupt hook failed", err=repr(e))


def digest_file_range(path: str, offset: int, size: int,
                      algo: Optional[str] = None) -> str:
    """Streaming layer digest over ``[offset, offset+size)`` of a file —
    disk-held layers digest without materializing the layer in RAM."""
    algo = algo or digest_algo()
    h = _digest_hasher(algo)
    with open(path, "rb") as f:
        f.seek(offset)
        left = size
        while left > 0:
            chunk = f.read(min(_DIGEST_CHUNK, left))
            if not chunk:
                raise ValueError(
                    f"short read digesting {path}: {left} bytes missing")
            h.update(chunk)
            left -= len(chunk)
    hx = h.hexdigest()
    return f"xxh3:{hx}" if algo == "xxh3" else hx


def digest_layer_src(src) -> Optional[str]:
    """Digest of a ``core.types.LayerSrc``'s full layer bytes, or None
    when the bytes aren't locally readable (CLIENT-held layers — the
    external client's bytes are outside this process).  Disk layers
    digest by streaming the file range; HBM-only layers materialize their
    one cached host copy first (``ensure_host_bytes``).  Holders digest
    their layers this way to announce and stamp them, each layer whole
    on the thread that calls this: the hash's time is added to the
    ``integrity_digest_stamp`` phase (summed over threads) and to
    ``integrity_digest_stamp_busy`` (the union over threads), and the
    layer's bytes are counted on ``integrity.digest_stamp_bytes``."""
    with _stamp_busy, trace.phase("integrity_digest_stamp"):
        digest = _digest_layer_src(src)
    if digest is not None:
        trace.count("integrity.digest_stamp_bytes", src.data_size)
    return digest


def digest_layer_srcs(srcs) -> List[Optional[str]]:
    """:func:`digest_layer_src` of each of ``srcs``, in order; None for a
    layer whose bytes are unreadable or whose read fails.  Two or more
    layers of at least :data:`POOLED_STAMP_MIN_BYTES` in all are hashed
    concurrently on ``threads.digest_pool()``, one layer to a worker,
    while the caller waits in the ``integrity_digest_stamp_wait``
    phase; fewer bytes are hashed inline.  Either way each digest is
    the one thread's hash of the whole layer.  The bytes hashed on the
    pool are counted on ``integrity.digest_stamp_pooled_bytes``."""
    srcs = list(srcs)
    if not srcs:
        return []
    if (len(srcs) < 2
            or sum(s.data_size for s in srcs) < POOLED_STAMP_MIN_BYTES):
        trace.count("integrity.digest_stamp_pooled_bytes", 0)
        return [_stamp_or_none(s) for s in srcs]
    out: List[Optional[str]] = [None] * len(srcs)

    def stamp(i):
        out[i] = _stamp_or_none(srcs[i])

    pool = threads.digest_pool()
    with trace.phase("integrity_digest_stamp_wait"):
        tasks = [pool.submit(stamp, i) for i in range(len(srcs))]
        for t in tasks:
            t.wait()
    for t in tasks:
        if t.error is not None:
            raise t.error
    trace.count("integrity.digest_stamp_pooled_bytes",
                sum(s.data_size for s, d in zip(srcs, out) if d is not None))
    return out


def _stamp_or_none(src) -> Optional[str]:
    try:
        return digest_layer_src(src)
    except (OSError, ValueError):
        return None


def _digest_layer_src(src) -> Optional[str]:
    from ..core.types import LayerLocation

    loc = src.meta.location
    if loc == LayerLocation.CLIENT:
        return None
    try:
        if src.inmem_data is not None:
            base = src.offset
            return layer_digest(
                memoryview(src.inmem_data)[base : base + src.data_size])
        if loc == LayerLocation.DISK and src.fp:
            return digest_file_range(src.fp, src.offset, src.data_size)
        if src.ensure_host_bytes():
            base = src.offset
            return layer_digest(
                memoryview(src.inmem_data)[base : base + src.data_size])
    except (OSError, ValueError):
        return None
    return None


def digest_layer_src_range(src, off: int, size: int) -> Optional[str]:
    """Digest of the byte range ``[off, off+size)`` of a LayerSrc — the
    per-RANGE digest the sharded-delivery plane stamps so a shard
    verifies without holding the full layer (docs/sharding.md).  Same
    readability rules as :func:`digest_layer_src`; None when the bytes
    aren't locally readable."""
    from ..core.types import LayerLocation

    loc = src.meta.location
    if loc == LayerLocation.CLIENT:
        return None
    try:
        if src.inmem_data is not None:
            base = src.offset + off
            return layer_digest(memoryview(src.inmem_data)[base:base + size])
        if loc == LayerLocation.DISK and src.fp:
            return digest_file_range(src.fp, src.offset + off, size)
        if src.ensure_host_bytes():
            base = src.offset + off
            return layer_digest(memoryview(src.inmem_data)[base:base + size])
    except (OSError, ValueError):
        return None
    return None


def hash_bench(nbytes: int = 64 << 20) -> dict:
    """Micro-bench the candidate integrity hashes on THIS host — the
    measured justification for the per-fragment and per-layer algorithm
    choices (TTD_MATRIX.md records the numbers, and ``digest_algo`` /
    ``fragment_checksum`` encode the conclusion).  Returns {name: GB/s};
    xxh3 entries are 0.0 when the extension isn't importable."""
    buf = memoryview(bytearray(os.urandom(1 << 20)) * (nbytes >> 20))

    def rate(fn) -> float:
        fn(buf[: 1 << 20])  # warm
        t0 = time.monotonic()
        fn(buf)
        dt = time.monotonic() - t0
        return round(len(buf) / max(dt, 1e-9) / 1e9, 2)

    out = {
        "bytes": len(buf),
        "crc32_gbps": rate(lambda b: zlib.crc32(b)),
        "adler32_gbps": rate(lambda b: zlib.adler32(b)),
        "blake2b_gbps": rate(
            lambda b: hashlib.blake2b(b, digest_size=DIGEST_SIZE).digest()),
        "sha256_gbps": rate(lambda b: hashlib.sha256(b).digest()),
        "xxh3_64_gbps": 0.0,
        "xxh3_128_gbps": 0.0,
    }
    if _xxhash is not None:
        out["xxh3_64_gbps"] = rate(lambda b: _xxhash.xxh3_64_intdigest(b))
        out["xxh3_128_gbps"] = rate(
            lambda b: _xxhash.xxh3_128_hexdigest(b))
    out["fragment_algo"] = fragment_checksum(buf[:16])[0]
    out["digest_algo"] = digest_algo()
    return out
