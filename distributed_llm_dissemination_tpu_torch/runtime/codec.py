"""The negotiated wire-codec plane (docs/codec.md).

``models/quant.py`` defines the codecs (deterministic int8/int4 encodings
of a model blob); this module is the RUNTIME half every node role shares:

- **capability**: what codecs this process can encode/decode — announced
  to the leader (``AnnounceMsg.codecs``), consulted when the leader
  chooses a codec per (dest, layer) transfer;
- **sender service**: the bounded encoded-form cache.  A raw holder
  commanded to ship (or NACK-retransmit) a layer at codec ``c`` encodes
  ONCE and serves every byte range — flow fragments, stripe splits,
  retransmits — from the cached encoded blob, so the encoded byte space
  is stable across re-sends (a re-encoded range must be byte-identical,
  which quant's deterministic round-to-nearest guarantees, but caching
  also keeps the encode cost off every retransmit);
- **identity**: the codec-qualified digest of a layer's encoded form,
  cached per (layer, codec) — what the leader stamps so a quantized
  copy verifies (and acks) under its OWN byte identity, never raw's.

Everything degrades to raw: a plane that can't encode a layer (size
mismatch — dummy bytes, not model blobs), a dest that never advertised
the codec, or a missing model config all leave the transfer canonical.

Copy of the JAX package's ``runtime/codec.py``; its lazy imports reach
this package's ``models/quant.py`` and ``models/entropy.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.types import (
    LayerID,
    LayerLocation,
    LayerMeta,
    LayerSrc,
    codec_capability,
    delta_base_digest,
)
from ..utils import integrity, trace
from ..utils.logging import log

# Links whose modeled bottleneck rate (bytes/s) is at or below this ship
# quantized when a WireCodec is configured; faster links stay raw — at
# NIC rates the wire is cheaper than the encode/decode pass (measure on
# the running host with quant.codec_bench; TTD_MATRIX records it).
CODEC_MIN_RATE_DEFAULT = 64 << 20  # 64 MiB/s

# The entropy forms' threshold: the DLE1 pass costs an extra host
# byte-walk both ways, so they only pay on links at least as slow as
# the plain quantized forms' crossover (codec_bench measures the real
# rates on the running container).
ENTROPY_MIN_RATE_DEFAULT = CODEC_MIN_RATE_DEFAULT

# The content-delta threshold: XOR + DLE1 runs at GB/s and the byte win
# on a lightly-perturbed v2 is order-of-magnitude, so delta pays on much
# faster links than whole-form quantization does.
DELTA_MIN_RATE_DEFAULT = 256 << 20  # 256 MiB/s

# Sender-side encoded-form cache budget (bytes).  One entry per
# (layer, codec) actively being served; eviction is LRU.
CODEC_CACHE_BYTES_DEFAULT = 1 << 30

# The whole-form codec ids this plane can announce, choose, and serve.
# "delta" is the announced CAPABILITY behind the parameterized
# "delta:<base_digest_hex>" codec strings a leader actually stamps
# (core/types.codec_capability).
WHOLE_FORM_CODECS = ("int8", "int4", "int8e", "int4e")
ENTROPY_FORMS = ("int8e", "int4e")


class WireCodecPlane:
    """Per-process wire-codec capability + encoded-form cache."""

    def __init__(self, cfg, model_codec: str = "raw",
                 wire_codec: str = "raw"):
        """``cfg``: the run's ``models.llama.ModelConfig`` (blob layouts
        — encoded sizes derive from it).  ``model_codec``: the canonical
        form the run's blobs are fabricated in; wire codecs only apply
        over raw canonicals (core/config.py refuses the combination at
        parse time, this just re-checks).  ``wire_codec``: the codec
        this run ALLOWS on slow links ("raw" = the plane is
        capability-only: this node can decode/serve codecs a leader
        chooses, but a leader built with it never chooses one)."""
        self.cfg = cfg
        self.model_codec = model_codec
        self.wire_codec = wire_codec if model_codec == "raw" else "raw"
        self._lock = threading.Lock()
        self._cache: Dict[Tuple[LayerID, str], bytes] = {}
        self._cache_bytes = 0
        self._digests: Dict[Tuple[LayerID, str], str] = {}
        # True encoded sizes for DATA-DEPENDENT forms (entropy, delta):
        # (lid, codec) -> len(encoded).  Model-derivable codecs never
        # land here — ``nbytes`` computes them from the config.
        self._sizes: Dict[Tuple[LayerID, str], int] = {}
        # digest -> LayerSrc of locally VERIFIED canonical bytes, wired
        # by the owning role (leader: its goal digests + store;
        # receiver: its content store).  The delta encode/decode base
        # lookup — None means this process can neither produce nor
        # price delta forms.
        self.base_resolver = None
        self.min_rate = self._env_rate(
            "DLD_CODEC_MIN_RATE", CODEC_MIN_RATE_DEFAULT)
        self.entropy_min_rate = self._env_rate(
            "DLD_ENTROPY_MIN_RATE", ENTROPY_MIN_RATE_DEFAULT)
        self.delta_min_rate = self._env_rate(
            "DLD_DELTA_MIN_RATE", DELTA_MIN_RATE_DEFAULT)
        self.cache_budget = self._env_rate(
            "DLD_CODEC_CACHE_BYTES", CODEC_CACHE_BYTES_DEFAULT)

    @staticmethod
    def _env_rate(name: str, default: int) -> int:
        try:
            return int(os.environ.get(name, str(default)))
        except ValueError:
            return default

    # ------------------------------------------------------------ capability

    @property
    def enabled(self) -> bool:
        """Whether this run may CHOOSE quantized transfers (leader
        side).  Capability (decode/serve) is independent — see
        :meth:`decode_codecs`."""
        return (self.wire_codec in WHOLE_FORM_CODECS
                and self.model_codec == "raw"
                and os.environ.get("DLD_WIRE_CODEC", "1") != "0")

    @property
    def delta_enabled(self) -> bool:
        """Whether this run may CHOOSE content-delta transfers (leader
        side).  On by default — a delta is only ever chosen when the
        dest PROVABLY holds the base, so there is no cold-start
        regression to opt out of — env-gated for operators who want the
        old behavior (``DLD_DELTA_CODEC=0``)."""
        return (self.model_codec == "raw"
                and os.environ.get("DLD_WIRE_CODEC", "1") != "0"
                and os.environ.get("DLD_DELTA_CODEC", "1") != "0")

    def decode_codecs(self) -> List[str]:
        """The codecs this process can DECODE (and encode — quantized
        forms need quant + the model config; "delta" is the generic
        capability behind ``"delta:<hex>"`` strings and needs only the
        entropy coder + a verified base), announced to the leader.
        Empty when the canonical form isn't raw (a decoded int8-of-int8
        blob would be meaningless) or the plane is env-disabled."""
        if (self.model_codec != "raw"
                or os.environ.get("DLD_WIRE_CODEC", "1") == "0"):
            return []
        return list(WHOLE_FORM_CODECS) + ["delta"]

    def min_rate_for(self, codec: str) -> int:
        """The negotiation threshold for ``codec``'s family: a pair only
        ships this form when its modeled bottleneck is at or below the
        family's measured crossover (quant.codec_bench)."""
        cap = codec_capability(codec)
        if cap == "delta":
            return self.delta_min_rate
        if cap in ENTROPY_FORMS:
            return self.entropy_min_rate
        return self.min_rate

    # --------------------------------------------------------------- sizing

    def nbytes(self, lid: LayerID, codec: str) -> Optional[int]:
        """Exact wire size of layer ``lid`` under ``codec``, or None
        when it isn't knowable here: ids outside the model's blob range,
        and DATA-DEPENDENT forms (entropy, delta) that haven't been
        sized by an actual encode yet (:meth:`ensure_sized`) — callers
        seeing None keep the transfer raw."""
        if not codec or codec == "raw":
            return self.decoded_nbytes(lid)
        with self._lock:
            sized = self._sizes.get((lid, codec))
        if sized is not None:
            return sized
        if self.cfg is None:
            return None
        from ..models import quant, serde

        if lid > serde.head_blob_id(self.cfg):
            return None
        try:
            return quant.blob_nbytes_codec(self.cfg, lid, codec)
        except (ValueError, KeyError):
            return None

    def ensure_sized(self, lid: LayerID, layer: Optional[LayerSrc],
                     codec: str) -> Optional[int]:
        """The TRUE wire size of ``lid`` under ``codec``, encoding the
        held ``layer`` once (cached — both the bytes and the size) when
        the size is data-dependent.  This is how the solver prices
        entropy/delta pairs at their real encoded size instead of a
        guess; None = can't encode here, the pair must not ship this
        form."""
        n = self.nbytes(lid, codec)
        if n is not None or layer is None:
            return n
        enc = self._encoded_bytes(lid, layer, codec)
        return len(enc) if enc is not None else None

    def decoded_nbytes(self, lid: LayerID) -> Optional[int]:
        """The canonical (raw) byte count of layer ``lid`` — what a
        quantized delivery decodes back into.  None when no model config
        is attached (synthetic layers: raw size is the holding's own)."""
        if self.cfg is None:
            return None
        from ..models import quant, serde

        if lid > serde.head_blob_id(self.cfg):
            return None
        try:
            return quant.blob_nbytes_codec(self.cfg, lid, "raw")
        except (ValueError, KeyError):
            return None

    # ------------------------------------------------------- encoded serving

    def encoded_src(self, lid: LayerID, layer: LayerSrc,
                    codec: str) -> Optional[LayerSrc]:
        """A ``LayerSrc`` over the ENCODED form of a raw holding —
        cached, so flow fragments, stripes, and NACK retransmits all
        read byte ranges of ONE stable encoded blob.  None when the
        layer can't encode (wrong size for the model's blob layout, or
        unreadable bytes) — the caller must refuse, loudly, rather than
        ship raw bytes a dest will account in encoded space."""
        enc = self._encoded_bytes(lid, layer, codec)
        if enc is None:
            return None
        return LayerSrc(
            inmem_data=enc, data_size=len(enc), offset=0,
            meta=LayerMeta(location=LayerLocation.INMEM,
                           limit_rate=layer.meta.limit_rate,
                           source_type=layer.meta.source_type,
                           codec=codec),
        )

    def _encoded_bytes(self, lid: LayerID, layer: LayerSrc,
                       codec: str) -> Optional[bytearray]:
        cap = codec_capability(codec)
        delta = cap == "delta"
        raw_size = self.decoded_nbytes(lid)
        if not delta:
            # Whole-form codecs need the model's blob layout; entropy
            # forms are sized by this very encode, the rest up front.
            if raw_size is None:
                return None
            if cap not in ENTROPY_FORMS and self.nbytes(lid, codec) is None:
                return None
        if getattr(layer.meta, "codec", ""):
            return None  # only canonical bytes encode
        key = (lid, codec)
        # One canonical content per layer id per process (the layer
        # store holds one record per id), so (lid, codec) keys the
        # cache; the deterministic encode makes every producer agree.
        # Delta strings carry their base digest, so a re-based choice
        # is simply a different key.
        with self._lock:
            enc = self._cache.get(key)
            if enc is not None:
                self._cache[key] = self._cache.pop(key)  # LRU touch
                return enc
        try:
            raw = layer.read_range()
        except (OSError, ValueError) as e:
            log.error("wire-codec encode: layer bytes unreadable",
                      layerID=lid, err=repr(e))
            return None
        if not delta and len(raw) != raw_size:
            log.error("wire-codec encode refused: holding is not a "
                      "model blob (size mismatch)", layerID=lid,
                      have=len(raw), want=raw_size)
            return None

        t0 = time.monotonic()
        if delta:
            enc = self._delta_bytes(lid, raw, codec)
            if enc is None:
                return None
        else:
            from ..models import quant

            enc = bytearray(quant.encode_blob(self.cfg, lid, raw, codec))
        dt = time.monotonic() - t0
        trace.count("codec.encoded_blobs")
        trace.count("codec.encoded_bytes", len(enc))
        trace.add_phase("codec_encode", dt)
        log.info("layer encoded for wire codec", layerID=lid, codec=codec,
                 raw_bytes=len(raw), encoded_bytes=len(enc),
                 encode_ms=round(dt * 1000, 1))
        with self._lock:
            self._sizes[key] = len(enc)
            if key not in self._cache:
                self._cache[key] = enc
                self._cache_bytes += len(enc)
                while (self._cache_bytes > self.cache_budget
                       and len(self._cache) > 1):
                    old_key = next(iter(self._cache))
                    if old_key == key:
                        break
                    self._cache_bytes -= len(self._cache.pop(old_key))
            return self._cache[key]

    # ----------------------------------------------------------------- delta

    def resolve_base(self, digest: str) -> Optional[LayerSrc]:
        """The locally VERIFIED canonical bytes hashing to ``digest``,
        via the role-wired ``base_resolver`` — None when this process
        can't vouch for any such holding (delta encode/decode refused,
        loudly, by the callers)."""
        resolver = self.base_resolver
        if resolver is None or not digest:
            return None
        try:
            return resolver(digest)
        except Exception as e:  # noqa: BLE001 — a resolver bug degrades
            log.error("delta base resolver failed", digest=digest,
                      err=repr(e))  # to raw, never crashes the plane
            return None

    def _delta_bytes(self, lid: LayerID, raw,
                     codec: str) -> Optional[bytearray]:
        """Encode ``raw`` against the base the codec string names.  The
        sender must hold a VERIFIED copy of the base — encoding against
        unverified bytes would ship a well-formed delta that
        reconstructs garbage (caught by the full-form digest, but only
        after burning the transfer)."""
        from ..models import entropy

        base_digest = delta_base_digest(codec)
        base = self.resolve_base(base_digest)
        if base is None:
            log.warn("delta encode refused: base not held/verified "
                     "here", layerID=lid, base=base_digest)
            return None
        try:
            base_raw = base.read_range()
        except (OSError, ValueError) as e:
            log.error("delta encode: base bytes unreadable",
                      layerID=lid, base=base_digest, err=repr(e))
            return None
        if len(base_raw) != len(raw):
            log.warn("delta encode refused: base length mismatch",
                     layerID=lid, base=base_digest,
                     base_bytes=len(base_raw), layer_bytes=len(raw))
            return None
        return bytearray(entropy.delta_encode(raw, base_raw))

    def delta_reconstruct(self, lid: LayerID, data,
                          codec: str) -> Optional[bytes]:
        """Receiver side: full raw bytes from a delivered delta stream —
        the base comes from THIS node's verified holdings (the leader
        only stamps a delta when the dest provably holds the base, so a
        miss here means local state regressed; None sends the pair back
        for a raw replan)."""
        from ..models import entropy

        base_digest = delta_base_digest(codec)
        base = self.resolve_base(base_digest)
        if base is None:
            log.warn("delta reconstruct refused: base not held here",
                     layerID=lid, base=base_digest)
            return None
        try:
            base_raw = base.read_range()
            out = entropy.delta_decode(data, base_raw)
        except (OSError, ValueError) as e:
            log.error("delta reconstruct failed", layerID=lid,
                      base=base_digest, err=repr(e))
            return None
        trace.count("codec.delta_reconstructed")
        return out

    # -------------------------------------------------------------- identity

    def encoded_digest(self, lid: LayerID, layer: LayerSrc,
                       codec: str) -> Optional[str]:
        """The codec-qualified digest the leader stamps for a quantized
        transfer: the digest of exactly the encoded bytes, cached per
        (layer, codec).  None when the layer can't encode here — the
        pair then stays raw (docs/codec.md, honest limits)."""
        key = (lid, codec)
        with self._lock:
            d = self._digests.get(key)
        if d is not None:
            return d
        enc = self._encoded_bytes(lid, layer, codec)
        if enc is None:
            return None
        d = integrity.layer_digest(memoryview(enc))
        with self._lock:
            self._digests[key] = d
        return d
