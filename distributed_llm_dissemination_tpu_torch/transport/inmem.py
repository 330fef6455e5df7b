"""Process-local fake transport for protocol tests.

Re-design of the reference's ``InmemoryTransport``
(``distributor/transport.go:494-631``): messages land
straight in peers' delivery queues via a global addr→transport registry, so
multi-node protocol logic runs in one process with no sockets.  Unlike the
reference's fake, this one also honors layer semantics: a ``LayerMsg`` is
materialized to in-RAM bytes on delivery (what the TCP receive path does)
and registered pipes relay the layer onward — so the client/relay paths are
testable in-process too.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

from ..core.types import LayerID, LayerLocation, LayerMeta, LayerSrc, NodeID
from ..utils import integrity, telemetry, trace
from ..utils.logging import log
from .base import AddrRegistry, Transport
from .messages import LayerMsg, Message

# Global registry: addr -> transport instance (transport.go:507-511).
_registry: Dict[str, "InmemTransport"] = {}
_registry_lock = threading.Lock()


def reset_registry() -> None:
    """Test helper: forget all registered transports."""
    with _registry_lock:
        _registry.clear()


class InmemTransport(Transport):
    def __init__(
        self,
        addr: str,
        buf_size: int = 1024,
        addr_registry: Optional[AddrRegistry] = None,
        is_client: bool = False,
    ):
        self.addr = addr
        self.addr_registry: AddrRegistry = dict(addr_registry or {})
        self.is_client = is_client
        self._queue: "queue.Queue[Message]" = queue.Queue(maxsize=buf_size)
        self._pipes: Dict[LayerID, NodeID] = {}
        self._lock = threading.Lock()
        self._closed = False
        # Integrity hooks, mirroring TcpTransport (docs/integrity.md):
        # ``recv_tamper(info, view) -> bool`` is the TEST-ONLY fault hook
        # (transport/faults.py) run on landed bytes BEFORE verification
        # (False = inject a drop); ``on_corrupt(src_id, layer_id, offset,
        # size, total_size, reason)`` fires when a frame is dropped for a
        # failed check — the receiver runtime NACKs the source from it.
        self.recv_tamper = None
        self.on_corrupt = None
        # Telemetry identity (utils/telemetry.py): bound by
        # runtime.node.Node; None = record nothing.
        self.node_id = None
        with _registry_lock:
            _registry[addr] = self

    # -- internal -----------------------------------------------------------

    def _resolve(self, dest_id: NodeID) -> "InmemTransport":
        addr = self.addr_registry.get(dest_id, str(dest_id))
        with _registry_lock:
            peer = _registry.get(addr)
        if peer is None:
            raise ConnectionError(f"peer {addr} not found")
        return peer

    def _deliver_local(self, message: Message) -> None:
        if isinstance(message, LayerMsg):
            self._receive_layer(message)
        else:
            self._queue.put(message)

    def _receive_layer(self, message: LayerMsg) -> None:
        """Mimic the TCP receive path: materialize the byte range to RAM,
        verify the payload's advisory CRC (dropping + reporting corrupt
        frames exactly like the wire transport), relay through a
        registered pipe if one exists, then deliver."""
        src = message.layer_src
        # Materialize exactly the [offset, offset+data_size) range, like the
        # TCP wire does; the landed fragment keeps the offset so a mode-3
        # receiver can reassemble it into place.
        data = bytearray(src.read_range())
        # The "wire" checksum: sender-stamped when present, else the
        # bytes as sent (computed BEFORE the fault hook below —
        # in-process there is no real wire, so this IS the sender-side
        # stamp).  xxh3-64 where available, crc32 otherwise, exactly
        # like the TCP sender (``integrity.fragment_checksum``).  With
        # no tamper hook installed nothing can touch the bytearray
        # between stamp and verify, so the self-stamp would be two
        # tautological hash passes per frame — skip it; an inbound
        # sender stamp is still verified either way.
        crc, xxh3 = message.crc, message.xxh3
        if (crc is None and xxh3 is None and self.recv_tamper is not None
                and integrity.wire_crc_enabled()):
            algo, value = integrity.fragment_checksum(data)
            if algo == "xxh3":
                xxh3 = value
            else:
                crc = value
        if not self._frame_ok(message, data, crc, xxh3):
            return
        # The verified frame lands on the (src, me) link of the flight
        # recorder — in-process there is no wire to wait on, so only
        # bytes/frames are filed (verify time is filed by _frame_ok).
        telemetry.link_add(message.src_id, self.node_id,
                           job=message.job_id,
                           rx_bytes=len(data), rx_frames=1)
        landed = LayerSrc(
            inmem_data=data,
            data_size=len(data),
            offset=src.offset,
            meta=LayerMeta(location=LayerLocation.INMEM),
        )
        relayed = LayerMsg(
            src_id=message.src_id,
            layer_id=message.layer_id,
            layer_src=landed,
            total_size=message.total_size,
            crc=crc,
            xxh3=xxh3,
            job_id=message.job_id,
            shard=message.shard,
            codec=message.codec,
            span_id=message.span_id,
            span_parent=message.span_parent,
        )
        with self._lock:
            pipe_dest = self._pipes.pop(message.layer_id, None)
        if pipe_dest is not None:
            # Cut-through relay (transport.go:144-196): forward while
            # "receiving".  In-process this is just a second delivery.
            try:
                self._resolve(pipe_dest)._deliver_local(relayed)
            except ConnectionError as e:
                log.error("failed to relay layer", layer=message.layer_id, err=e)
        self._queue.put(relayed)

    def _frame_ok(self, message: LayerMsg, data: bytearray,
                  crc, xxh3) -> bool:
        """Fault hook + checksum verification for one landed frame;
        False means the frame was dropped (and reported via
        ``on_corrupt``, through the reporter shared with the TCP
        transport)."""
        import time as _time

        src = message.layer_src
        reason = None
        tamper = self.recv_tamper
        if tamper is not None:
            info = {"src": message.src_id, "layer": message.layer_id,
                    "offset": src.offset, "size": len(data),
                    "total": message.total_size}
            try:
                if tamper(info, memoryview(data)) is False:
                    reason = "drop"
            except Exception as e:  # noqa: BLE001 — test hook must not wedge rx
                log.error("recv_tamper hook failed", err=repr(e))
        if reason is None and integrity.wire_crc_enabled():
            t0 = _time.thread_time()
            ok = integrity.verify_stamp(data, crc=crc, xxh3=xxh3)
            if ok is not None:
                dt = _time.thread_time() - t0
                trace.add_phase("integrity_crc_recv", dt)
                telemetry.link_add(message.src_id, self.node_id,
                                   verify_s=dt)
                if not ok:
                    reason = "crc"
        if reason is None:
            return True
        integrity.report_corrupt_frame(
            self.on_corrupt, message.src_id, message.layer_id,
            src.offset, len(data), message.total_size, reason,
            dest_id=self.node_id)
        return False

    # -- Transport API ------------------------------------------------------

    def send(self, dest_id: NodeID, message: Message) -> None:
        self._resolve(dest_id)._deliver_local(message)
        if isinstance(message, LayerMsg):
            telemetry.link_add(message.src_id, dest_id,
                               job=message.job_id,
                               tx_bytes=message.layer_src.data_size,
                               tx_frames=1)

    def broadcast(self, message: Message) -> None:
        with _registry_lock:
            peers = [t for a, t in _registry.items() if a != self.addr]
        for peer in peers:
            peer._deliver_local(message)

    def register_pipe(self, layer_id: LayerID, dest_id: NodeID) -> None:
        with self._lock:
            if layer_id in self._pipes:
                raise ValueError("pipe already registered")
            self._pipes[layer_id] = dest_id

    def deliver(self) -> "queue.Queue[Message]":
        return self._queue

    def get_address(self) -> str:
        return self.addr

    def close(self) -> None:
        with _registry_lock:
            _registry.pop(self.addr, None)
        self._closed = True
