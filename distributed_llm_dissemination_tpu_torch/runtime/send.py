"""Shared layer-send paths used by leaders and receivers.

Re-design of the reference's send helpers: ``sendLayer``
(``distributor/node.go:354-373``), ``fetchFromClient``
(node.go:1345-1351), and the flow-job executor ``handleFlowRetransmit``
(node.go:1592-1643).

Copy of the JAX package's ``runtime/send.py``: the host sends carry over
unchanged; the device-fabric sender half (``contribute_device_plan`` and
its full-layer upload cache) raises ``NotImplementedError`` until the
fabric slice.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional, Tuple

from ..core.types import (
    CLIENT_ID,
    LayerID,
    LayerLocation,
    LayerMeta,
    LayerSrc,
    LayersSrc,
    NodeID,
    shard_range,
)
from ..transport.messages import ClientReqMsg, FlowRetransmitMsg, LayerMsg
from ..utils import telemetry, threads, trace
from ..utils.logging import log
from ..utils.rate import TokenBucket
from .node import Node

# Flow jobs are sent as sub-fragments of at most this many bytes (the
# reference streams a job as one blob, node.go:1592-1607).  Bounded
# fragments give receivers incremental progress: each one advances the
# interval accounting and the durable checkpoint journal, so a transfer
# killed mid-job loses at most one fragment, not the whole job.
FLOW_FRAGMENT_BYTES = int(os.environ.get("DLD_FLOW_FRAGMENT_BYTES",
                                         str(16 << 20)))


def _fragment_bytes(rate: int) -> int:
    """Fragment size for one flow job.  Jobs whose commanded rate the
    transport will STRIPE (unlimited, or a budget-scale allotment —
    tcp.STRIPE_PACED_MIN_RATE) use STRIPE_COUNT-times larger fragments:
    each stripe is delivered/journaled/device-ingested as its own
    fragment, so the progress granularity receivers see stays
    ~FLOW_FRAGMENT_BYTES while the larger fragment amortizes the
    per-fragment barrier (all of a fragment's stripes land before the
    next fragment starts).  Slow modeled sources never stripe, so they
    keep the exact 16 MiB loss/progress granularity."""
    from ..transport.tcp import STRIPE_COUNT, STRIPE_PACED_MIN_RATE

    if rate == 0 or rate >= STRIPE_PACED_MIN_RATE:
        return FLOW_FRAGMENT_BYTES * max(1, STRIPE_COUNT)
    return FLOW_FRAGMENT_BYTES


def _codec_view(layer: LayerSrc, layer_id: LayerID, codec: str,
                codecs) -> Optional[LayerSrc]:
    """The LayerSrc a transfer at wire-codec ``codec`` reads its bytes
    — and byte SPACE — from (docs/codec.md): the holding itself when it
    already is that encoded form (encoded bytes forward verbatim, no
    decode/re-encode round trip), the cached encoded form of a
    canonical holding otherwise (``codecs`` is the node's
    ``WireCodecPlane``).  None = this holder cannot produce those exact
    bytes (wrong encoded form, or no encode capability) — the caller
    must refuse loudly rather than ship bytes the dest will account in
    a different byte space."""
    if not codec:
        return layer
    held = getattr(layer.meta, "codec", "")
    if held == codec:
        return layer
    if held or codecs is None:
        return None
    return codecs.encoded_src(layer_id, layer, codec)


def send_layer(node: Node, dest: NodeID, layer_id: LayerID, layer: LayerSrc,
               job_id: str = "", shard: str = "", codec: str = "",
               codecs=None, span_parent: str = "",
               wire_range: Optional[tuple] = None) -> None:
    """Send one full layer to ``dest``; client-held layers are fetched via
    the pipe mechanism instead (node.go:354-365).  ``job_id`` tags the
    frames with the admitted dissemination job they serve ("" = the base
    run) so link telemetry splits per job (docs/service.md).

    ``shard`` (docs/sharding.md): send only that shard spec's byte
    range of the layer, as a byte-range fragment (``total_size`` stays
    the full layer size, so the dest's interval accounting speaks
    absolute layer coordinates) — the whole-layer path for modes 0-2
    honoring a sharded target.  Client-held layers can't range-serve
    and fall back to the full-layer pipe fetch (over-delivery is safe).

    ``codec`` (docs/codec.md): ship the layer's ENCODED form — the
    wire total (and any shard range) then lives in encoded byte space,
    and the frames carry the codec tag.  Client-held layers can't
    encode-serve; they fall back to the raw pipe fetch (the dest's
    digest gate treats the raw bytes as a raw delivery — raw satisfies
    every target).

    ``wire_range`` (docs/hierarchy.md): send only ``(offset, size)`` of
    the wire byte space — the chain stripe seed path, where the
    sub-leader ships each stripe to its head member and the rest of the
    range arrives via member relays.  Offsets index the view the
    shard/codec tags describe, and the frames still carry those tags so
    downstream accounting stays in the stamped byte space."""
    if layer.meta.location == LayerLocation.CLIENT:
        log.debug("loading layer from client", layer=layer_id)
        fetch_from_client(node, layer_id, dest)
        return
    view = _codec_view(layer, layer_id, codec, codecs)
    if view is None:
        log.error("cannot serve layer at commanded wire codec",
                  layerID=layer_id, codec=codec,
                  held=getattr(layer.meta, "codec", ""))
        return
    if codec:
        trace.count("codec.wire_sends")
    # Pair-lifecycle span (docs/observability.md): the send begins NOW
    # — the frames carry the advisory id (+ the parent tag for
    # sub-leader fan-out children) for cross-node correlation.
    span = telemetry.span_id(dest, layer_id)
    telemetry.span_event(span, "dispatched", node=node.my_id,
                         src=node.my_id, dest=dest, layer=layer_id,
                         job=job_id, codec=codec, shard=shard,
                         parent=span_parent)
    if wire_range is not None:
        off, size = int(wire_range[0]), int(wire_range[1])
        size = min(size, max(0, view.data_size - off))
        if size <= 0:
            log.error("wire range outside the layer's byte space; dropped",
                      layerID=layer_id, offset=wire_range[0],
                      size=wire_range[1], layer_size=view.data_size)
            return
        sub = _sub_layer_src(view, _sendable_location(view), off, size,
                             layer.meta.limit_rate)
        node.transport.send(
            dest, LayerMsg(node.my_id, layer_id, sub, view.data_size,
                           job_id=job_id, shard=shard, codec=codec,
                           span_id=span, span_parent=span_parent)
        )
        return
    if shard:
        off, size = shard_range(shard, view.data_size)
        sub = _sub_layer_src(view, _sendable_location(view), off, size,
                             layer.meta.limit_rate)
        trace.count("shard.range_sends")
        node.transport.send(
            dest, LayerMsg(node.my_id, layer_id, sub, view.data_size,
                           job_id=job_id, shard=shard, codec=codec,
                           span_id=span, span_parent=span_parent)
        )
        return
    node.transport.send(
        dest, LayerMsg(node.my_id, layer_id, view, view.data_size,
                       job_id=job_id, codec=codec,
                       span_id=span, span_parent=span_parent)
    )


def fetch_from_client(node: Node, layer_id: LayerID, dest: NodeID) -> None:
    """Register a cut-through pipe (layer → dest) and ask the external
    client to stream the layer (node.go:367-373)."""
    log.debug("ask the client to send the layer", layerID=layer_id)
    node.transport.register_pipe(layer_id, dest)
    node.transport.send(CLIENT_ID, ClientReqMsg(node.my_id, layer_id, False))


def _sendable_location(layer: LayerSrc) -> LayerLocation:
    """The location a range-send should read from.  An HBM-staged layer
    serves like INMEM: from its retained host buffer, or — for
    fabric-delivered layers that never had one — from a host copy
    materialized off the device array (one cached fetch)."""
    loc = layer.meta.location
    if loc == LayerLocation.HBM and layer.ensure_host_bytes():
        loc = LayerLocation.INMEM
    return loc


def _sub_layer_src(layer: LayerSrc, send_loc: LayerLocation, offset: int,
                   size: int, rate: int) -> LayerSrc:
    """A byte-range view of a held layer for (re)transmission — the ONE
    construction shared by flow sends and NACK retransmits, so the two
    paths can't drift.  ``LayerSrc.offset`` doubles as the read position
    in the backing store AND the wire fragment offset; held layers are
    always constructed with ``offset == 0`` (core/config.py), which
    keeps the two roles coincident."""
    return LayerSrc(
        inmem_data=layer.inmem_data, fp=layer.fp, data_size=size,
        offset=layer.offset + offset,
        meta=LayerMeta(location=send_loc, limit_rate=rate,
                       source_type=layer.meta.source_type),
    )


class RevokeRegistry:
    """Sender-side preemption revoke (docs/service.md): the leader's
    ``JobRevokeMsg`` names a demoted job's (dest, layer) pairs whose
    queued sends should not burn the reclaimed link budget.  Entries
    are CONSUMED on first match (the re-plan that triggered the revoke
    re-dispatches the same pair at the demoted rate — the fresh command
    must not be eaten too) and TTL-bounded (a revocation whose send
    already finished must not linger to eat a future command).

    Generation keying closes the wrong-eat race the TTL alone left
    open: a revoke carries the plan generation it fenced, a dispatched
    command carries the generation of the solve that produced it, and
    an entry eats ONLY commands stamped at or below its generation — a
    revoke applied late at a slow sender can no longer eat the
    re-plan's fresh command for the same (job, dest, layer).  ``gen=0``
    on both sides preserves the legacy (TTL-only) behavior."""

    TTL_S = 30.0

    def __init__(self):
        self._lock = threading.Lock()
        # (job, dest, layer) -> (wall time, revoked plan generation)
        self._revoked: Dict[tuple, Tuple[float, int]] = {}

    def add(self, job_id: str, pairs, gen: int = 0) -> int:
        import time

        now = time.time()
        with self._lock:
            for dest, lid in pairs:
                key = (str(job_id), int(dest), int(lid))
                old = self._revoked.get(key)
                # A newer revoke's generation wins; never let a stale
                # re-delivery LOWER the fence.
                g = max(int(gen), old[1] if old else 0)
                self._revoked[key] = (now, g)
            return len(self._revoked)

    def consume(self, job_id: str, dest: NodeID, lid: LayerID,
                gen: int = 0) -> bool:
        """True when (job, dest, layer) is revoked for this command's
        plan generation; a match spends the entry.  A command from a
        NEWER generation than the revoke survives — and leaves the
        entry ARMED, because the stale command it fences may still be
        queued (or mid-fragments) behind this one; popping here would
        disarm the revoke before its target ever checked (TTL bounds
        the entry if that command never arrives)."""
        import time

        if not job_id:
            return False  # base-run sends are never revoked
        key = (str(job_id), int(dest), int(lid))
        now = time.time()
        with self._lock:
            rec = self._revoked.get(key)
            if rec is None:
                return False
            t, revoked_gen = rec
            if now - t > self.TTL_S:
                del self._revoked[key]
                return False  # expired: treat as never revoked
            if int(gen) > revoked_gen:
                # The command postdates the revoke's plan: it is the
                # re-dispatch the revoke made room for — let it run.
                return False
            del self._revoked[key]
            return True


class NackRetransmitter:
    """Bounded-retry byte-range retransmit service for ``LayerNackMsg``
    (docs/integrity.md) — the sender half of the integrity plane, shared
    by every node that serves layers (leaders of all four modes and
    retransmit-capable receivers).

    A receiver whose transport dropped a corrupt fragment NACKs the
    range; this re-sends exactly ``[offset, offset+size)`` of the named
    layer as ONE logical send (the transport re-stripes large ranges
    itself, so a regrouping plain receiver still sees one whole
    message).  Retries are bounded per (dest, layer, offset): a
    persistently corrupt path — bad RAM on the source, a broken NIC —
    must surface as a loud failure for the crash/re-plan machinery, not
    a silent retransmit livelock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[tuple, int] = {}
        # Read at construction like the other integrity knobs
        # (DLD_GAP_NACK_S, DLD_WIRE_CRC, ...), not at import time.
        self.LIMIT = int(os.environ.get("DLD_NACK_RETRY_LIMIT", "6"))

    def admit(self, dest: NodeID, layer_id: LayerID, offset: int,
              size: int = 0) -> int:
        """Count one retransmit attempt for (dest, layer, offset) and
        return the attempt number, or 0 when the bounded budget is
        exhausted.  ONE budget shared by every serving path on this
        node (completed-holding retransmits and in-flight partial-range
        relay serves), so a range can't double its retries by being
        servable two ways."""
        key = (dest, layer_id, offset)
        with self._lock:
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
        if n > self.LIMIT:
            log.error("NACK retry budget exhausted; giving up on range "
                      "(crash detection / re-announce must recover it)",
                      dest=dest, layerID=layer_id,
                      offset=offset, size=size, tries=n)
            trace.count("integrity.nack_suppressed")
            return 0
        return n

    def handle(self, node: Node, layers: LayersSrc, lock: threading.Lock,
               msg, codecs=None) -> bool:
        """Serve one NACK; True when the range was re-sent.  A NACK
        carrying a wire codec (docs/codec.md) names a range of the
        ENCODED blob: it is served from the same-codec holding (or the
        cached encoded form of a canonical one, ``codecs``) so the
        retransmitted bytes are byte-identical to the originals —
        NACK/retransmit recovery runs entirely in encoded space."""
        n = self.admit(msg.src_id, msg.layer_id, msg.offset, msg.size)
        if not n:
            return False
        with lock:
            layer = layers.get(msg.layer_id)
        if layer is None:
            log.error("NACK for a layer this node doesn't hold",
                      layerID=msg.layer_id, dest=msg.src_id)
            return False
        if layer.meta.location == LayerLocation.CLIENT:
            log.error("NACK for a client-held layer; cannot range-serve "
                      "it from here", layerID=msg.layer_id)
            return False
        codec = getattr(msg, "codec", "")
        view = _codec_view(layer, msg.layer_id, codec, codecs)
        if view is None:
            log.error("NACK names a wire codec this holder cannot serve",
                      layerID=msg.layer_id, codec=codec,
                      held=getattr(layer.meta, "codec", ""))
            return False
        send_loc = _sendable_location(view)
        size = min(msg.size, max(0, view.data_size - msg.offset))
        if size <= 0:
            log.error("NACK names an out-of-range span", layerID=msg.layer_id,
                      offset=msg.offset, size=msg.size,
                      layer_size=view.data_size)
            return False
        if layer.meta.shard:
            # A SHARD holder's buffer is only real inside its shard's
            # range — serving bytes outside it would retransmit garbage
            # as verified-looking frames (docs/sharding.md).  For a
            # codec shard-holding the range lives in encoded space, the
            # same space the holding's buffer is real in.
            s0, sz = shard_range(layer.meta.shard, view.data_size)
            if msg.offset < s0 or msg.offset + size > s0 + sz:
                log.error("NACK names bytes outside this holder's shard; "
                          "cannot range-serve them from here",
                          layerID=msg.layer_id, offset=msg.offset,
                          size=size, shard=layer.meta.shard)
                return False
        node.add_node(msg.src_id)
        # Retransmits honor the holder's modeled source rate — a NACK
        # must not let a rate-limited seeder exceed what its source
        # could physically serve.
        sub = _sub_layer_src(view, send_loc, msg.offset, size,
                             layer.meta.limit_rate)
        log.warn("NACK retransmit", layerID=msg.layer_id, dest=msg.src_id,
                 offset=msg.offset, bytes=size, reason=msg.reason,
                 attempt=n, codec=codec or None)
        trace.count("integrity.retransmit_frags")
        trace.count("integrity.retransmit_bytes", size)
        telemetry.link_add(node.my_id, msg.src_id,
                           retransmit_frames=1, retransmit_bytes=size)
        node.transport.send(
            msg.src_id,
            LayerMsg(node.my_id, msg.layer_id, sub, view.data_size,
                     codec=codec,
                     # Tag only: a retransmit serves the pair's EXISTING
                     # span — re-recording "dispatched" here would
                     # falsely shift the span's wire window.
                     span_id=telemetry.span_id(msg.src_id, msg.layer_id)),
        )
        return True


_FABRIC_SLICE = ("the device fabric (DevicePlanMsg plans, the seeder-side "
                 "full-layer upload cache) is not ported yet (ROADMAP, port "
                 "Queue 1 item 12)")


def release_upload_cache() -> None:
    """Nodes call this on startup to release the fabric upload cache's
    device copies.  This package has no fabric yet, so nothing is ever
    cached: a no-op."""


def reopen_upload_cache() -> None:
    """Re-arm upload retention for a new distribution cycle (no-op: no
    fabric, no cache)."""


def contribute_device_plan(
    node: Node, layers: LayersSrc, lock: threading.Lock, fabric, placement,
    msg,
) -> None:
    """The pod-fabric sender half of the JAX package (publish this node's
    byte ranges of a device plan onto its own stage devices)."""
    raise NotImplementedError(_FABRIC_SLICE)


def handle_flow_retransmit(
    node: Node,
    layers: LayersSrc,
    lock: threading.Lock,
    fetch_fn: Callable[[LayerID, NodeID], None],
    msg: FlowRetransmitMsg,
    revokes: "Optional[RevokeRegistry]" = None,
    codecs=None,
) -> None:
    """Execute one flow job: send ``[offset, offset+data_size)`` of a layer
    to the dest at the commanded rate (node.go:1592-1643).

    ``revokes``: the sender's preemption-revoke registry.  A queued job
    whose (job, dest, layer) the leader revoked before it started is
    dropped whole (counted on ``jobs.revoked_pairs``); a revocation
    landing mid-job stops the remaining fragments — either way the
    re-plan that issued the revoke re-dispatches the pair at the
    demoted tier's budget.

    ``codecs`` (docs/codec.md): the sender's wire-codec plane.  A job
    carrying a codec indexes the ENCODED blob — the commanded byte
    range, every emitted fragment, and the wire total all live in
    encoded space, read from the cached encoded form (or a same-codec
    holding verbatim).  A holder that can't produce those bytes refuses
    loudly (the leader's arc filter should never have picked it).

    The ClientLayer branch simulates a rate-limited fetch from the node's
    own external client, then loops the partial layer back into the node's
    own delivery queue — the reference does the same (node.go:1610-1635)
    but would nil-panic there because client-layer records carry no data
    (cmd/config.go:187-198); here missing bytes are zero-filled."""
    with lock:
        layer = layers.get(msg.layer_id)
    if layer is None:
        log.error("no layer for flow job", layerID=msg.layer_id)
        return
    if (revokes is not None
            and revokes.consume(msg.job_id, msg.dest_id, msg.layer_id,
                                gen=getattr(msg, "gen", 0))):
        trace.count("jobs.revoked_pairs")
        log.warn("queued flow send revoked by preemption; dropped",
                 layerID=msg.layer_id, dest=msg.dest_id, job=msg.job_id)
        return
    node.add_node(msg.dest_id)

    codec = getattr(msg, "codec", "")
    view = layer
    if codec and layer.meta.location != LayerLocation.CLIENT:
        view = _codec_view(layer, msg.layer_id, codec, codecs)
        if view is None:
            log.error("flow job commands a wire codec this holder "
                      "cannot serve", layerID=msg.layer_id, codec=codec,
                      held=getattr(layer.meta, "codec", ""))
            return
        trace.count("codec.wire_sends")

    send_loc = _sendable_location(view)
    if send_loc in (LayerLocation.INMEM, LayerLocation.DISK):
        # Pair-lifecycle span (docs/observability.md): the command left
        # the sender's queue NOW — planned→dispatched is the queueing
        # attribution the critical-path walk charges to this sender.
        span = telemetry.span_id(msg.dest_id, msg.layer_id)
        telemetry.span_event(span, "dispatched", node=node.my_id,
                             src=node.my_id, dest=msg.dest_id,
                             layer=msg.layer_id, job=msg.job_id,
                             codec=codec, bytes=msg.data_size)
        frag_bytes = _fragment_bytes(msg.rate)
        sent = 0
        while sent < msg.data_size:
            if (sent > 0 and revokes is not None
                    and revokes.consume(msg.job_id, msg.dest_id,
                                        msg.layer_id,
                                        gen=getattr(msg, "gen", 0))):
                trace.count("jobs.revoked_pairs")
                log.warn("in-flight flow send revoked mid-job; stopping",
                         layerID=msg.layer_id, dest=msg.dest_id,
                         job=msg.job_id, sent=sent)
                return
            n = min(frag_bytes, msg.data_size - sent)
            partial = _sub_layer_src(view, send_loc, msg.offset + sent, n,
                                     msg.rate)
            node.transport.send(
                msg.dest_id,
                LayerMsg(node.my_id, msg.layer_id, partial, view.data_size,
                         job_id=msg.job_id, codec=codec, span_id=span),
            )
            sent += n
    elif layer.meta.location == LayerLocation.CLIENT:
        def _simulate_client_fetch() -> None:
            if layer.inmem_data is not None:
                data = bytearray(
                    memoryview(layer.inmem_data)[msg.offset : msg.offset + msg.data_size]
                )
            else:
                data = bytearray(msg.data_size)
            TokenBucket(msg.rate).wait_n(len(data))
            partial = LayerSrc(
                inmem_data=data,
                data_size=msg.data_size,
                offset=msg.offset,
                meta=LayerMeta(location=LayerLocation.INMEM),
            )
            node.transport.deliver().put(
                LayerMsg(node.my_id, msg.layer_id, partial, layer.data_size,
                         job_id=msg.job_id)
            )

        # A per-transfer data-plane task: rides the bounded tx pool
        # (utils/threads.py) — simulated client fetches must not imply
        # a thread each any more than real sends do.
        threads.tx_pool().submit(_simulate_client_fetch)
    else:
        log.error("unknown location", layerID=msg.layer_id)
