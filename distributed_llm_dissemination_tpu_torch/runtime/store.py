"""Content-addressed layer store (docs/service.md).

Layers are keyed by their digest stamp (``xxh3:<hex>`` /
blake2b hex — ``utils.integrity.layer_digest``), which turns the layer
store into a content store: a v2 rollout whose layer 103 hashes the same
as the v1 layer 3 a node already holds resolves LOCALLY — zero wire
bytes — and a repaired node refills from whichever CURRENT holder is
nearest/fastest, not the original seeder.

Two small classes, two sides of the same key:

- :class:`ContentStore` — the NODE half: digest → locally held layer
  ids.  Populated wherever this process provably knows a layer's bytes
  hash to a digest (its own announce-time hash, an ack-gate verify);
  consulted when the leader's digest stamp names an ASSIGNED layer this
  node doesn't hold — a digest hit aliases the held bytes under the new
  layer id and acks instantly.
- :class:`ContentIndex` — the LEADER half: digest → (node, layer)
  holders, rebuilt from announces (authoritative per node) and extended
  by acks (the leader stamped the digest, so a delivered copy provably
  carries it).  The planner skips shipping a (dest, layer) pair whose
  digest the dest already holds under ANY layer id — the dest's own
  resolve-and-ack completes the pair.

Shard scoping (docs/sharding.md): every entry is keyed by
``(digest, shard, codec)`` — a SHARD holding's digest is the digest of
its byte RANGE, verified over exactly those bytes, so it can only ever
vouch for (and alias to) a target with the SAME range.  A full-layer
query (``shard=""``) never matches a shard-vouched entry: a
shard-holder can never ack a full-layer pair.

Codec scoping (docs/codec.md): the third key component is the
wire-codec form.  A quantized holding's digest is the digest of the
ENCODED bytes — a different byte string than the canonical layer — so
it vouches only under ``(digest, shard, codec)``: a raw query can never
match an int8-vouched entry, and a quantized copy can never
alias-complete (or be planned as already-holding) a raw pair.

Digest trust model: both sides only index digests that were locally
verified (node) or announced/stamped through the integrity plane
(leader) — the same trust the digest verification gate already places
in those sources (docs/integrity.md).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..core.types import LayerID, NodeID

# The (digest, shard, codec) content key; shard "" = the whole layer,
# codec "" = canonical bytes.
ContentKey = Tuple[str, str, str]


class ContentStore:
    """(digest, shard, codec) → layer ids this node holds with those
    exact bytes over exactly that range in exactly that form."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_key: Dict[ContentKey, Set[LayerID]] = {}
        self._by_layer: Dict[LayerID, ContentKey] = {}

    def index(self, lid: LayerID, digest: str, shard: str = "",
              codec: str = "") -> None:
        if not digest:
            return
        key = (str(digest), str(shard), str(codec))
        with self._lock:
            old = self._by_layer.get(lid)
            if old == key:
                return
            if old is not None:
                ids = self._by_key.get(old)
                if ids is not None:
                    ids.discard(lid)
                    if not ids:
                        del self._by_key[old]
            self._by_layer[lid] = key
            self._by_key.setdefault(key, set()).add(lid)

    def forget(self, lid: LayerID) -> None:
        """Drop a layer (demoted as corrupt, evicted): its bytes can no
        longer vouch for the digest."""
        with self._lock:
            key = self._by_layer.pop(lid, None)
            if key is not None:
                ids = self._by_key.get(key)
                if ids is not None:
                    ids.discard(lid)
                    if not ids:
                        del self._by_key[key]

    def lookup(self, digest: str, shard: str = "",
               codec: str = "") -> Optional[LayerID]:
        """A local layer id holding these bytes over this exact range
        in this exact form (lowest id for determinism), or None.  A
        full-layer raw lookup only matches full-layer raw holdings."""
        with self._lock:
            ids = self._by_key.get((str(digest), str(shard), str(codec)))
            return min(ids) if ids else None

    def digest_of(self, lid: LayerID) -> Optional[str]:
        with self._lock:
            key = self._by_layer.get(lid)
            return key[0] if key is not None else None

    def shard_of(self, lid: LayerID) -> Optional[str]:
        with self._lock:
            key = self._by_layer.get(lid)
            return key[1] if key is not None else None

    def codec_of(self, lid: LayerID) -> Optional[str]:
        with self._lock:
            key = self._by_layer.get(lid)
            return key[2] if key is not None else None

    def size(self) -> int:
        with self._lock:
            return len(self._by_layer)


class ContentIndex:
    """Leader-side (digest, shard, codec) → holders map.

    An announce is the node's authoritative inventory, so
    :meth:`reset_node` replaces that node's contribution wholesale
    (a restarted node no longer vouches for its dead incarnation's
    bytes); an ack extends it (the delivered copy verified against the
    stamped digest before acking)."""

    def __init__(self):
        self._lock = threading.Lock()
        # node -> {layer: (digest, shard, codec)}; digest->holders is
        # derived.
        self._node_layers: Dict[NodeID, Dict[LayerID, ContentKey]] = {}

    def reset_node(self, node: NodeID,
                   digests: Optional[Dict[LayerID, str]] = None) -> None:
        """Replace a node's vouching with its announce-time FULL-layer
        canonical digests (shard and codec holdings announce no layer
        digest — a range or encoded-form hash as a layer digest would
        poison the stamp collection)."""
        with self._lock:
            if digests:
                self._node_layers[node] = {
                    int(l): (str(d), "", "") for l, d in digests.items()}
            else:
                self._node_layers.pop(node, None)

    def add(self, node: NodeID, lid: LayerID, digest: Optional[str],
            shard: str = "", codec: str = "") -> None:
        if not digest:
            return
        with self._lock:
            self._node_layers.setdefault(node, {})[lid] = (
                str(digest), str(shard), str(codec))

    def drop_node(self, node: NodeID) -> None:
        with self._lock:
            self._node_layers.pop(node, None)

    def node_has(self, node: NodeID, digest: str, shard: str = "",
                 codec: str = "") -> bool:
        """Whether ``node`` provably holds bytes hashing to ``digest``
        over exactly ``shard``'s range in exactly ``codec``'s form,
        under ANY layer id.  A full-layer raw query never matches a
        shard- or codec-vouched holding."""
        if not digest:
            return False
        key = (str(digest), str(shard), str(codec))
        with self._lock:
            return key in (self._node_layers.get(node) or {}).values()

    def node_digests(self, node: NodeID) -> Dict[LayerID, str]:
        """``node``'s FULL-layer canonical holdings: {layer: digest}
        (shard- and codec-vouched entries excluded) — the delta base
        CANDIDATE set: any of these digests names bytes the dest can
        provably reconstruct against (docs/codec.md)."""
        with self._lock:
            return {lid: k[0]
                    for lid, k in (self._node_layers.get(node)
                                   or {}).items()
                    if not k[1] and not k[2]}

    def holders(self, digest: str, shard: str = "",
                codec: str = "") -> List[Tuple[NodeID, LayerID]]:
        """Every (node, layer) currently vouched for (digest, shard,
        codec), sorted."""
        key = (str(digest), str(shard), str(codec))
        out: List[Tuple[NodeID, LayerID]] = []
        with self._lock:
            for node in sorted(self._node_layers):
                for lid, k in sorted(self._node_layers[node].items()):
                    if k == key:
                        out.append((node, lid))
        return out
