"""Node identity core + message-loop plumbing.

Re-design of the reference's ``N`` struct and per-node goroutine fan-out
(``distributor/node.go:17-126, 271-287``): every node owns a
transport, a leader pointer, and a (1-hop, forward-provisioned) routing
table; incoming messages are drained from the transport's delivery queue by
one loop thread and dispatched to handlers on a small pool so long layer
transfers never block control traffic.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Type

from ..core.types import NodeID, RoutingInfo
from ..transport.base import Transport
from ..utils import telemetry
from ..utils.logging import log


class Node:
    """Identity + leader pointer + routing table (node.go:35-126)."""

    def __init__(self, my_id: NodeID, leader_id: NodeID, transport: Transport):
        self.my_id = my_id
        self.leader_id = leader_id
        self.transport = transport
        # Bind this node's identity onto the transport so its per-frame
        # accounting can file rx bytes under a (src, MY id) link in the
        # telemetry flight recorder (utils/telemetry.py) — the transport
        # otherwise only knows addresses.  Advisory: a transport used
        # without a Node (raw tests) records nothing rather than
        # misfiling bytes.
        try:
            transport.node_id = my_id
        except AttributeError:  # a wrapper may proxy it read-only
            pass
        self.routing_table: Dict[NodeID, RoutingInfo] = {}
        self._lock = threading.Lock()
        if my_id != leader_id:
            self.add_node(leader_id)

    def get_next_hop(self, goal: NodeID) -> NodeID:
        with self._lock:
            info = self.routing_table.get(goal)
        if info is None:
            raise KeyError(f"no routing entry for {goal}")
        return info.next_hop

    def add_node(self, goal: NodeID) -> None:
        self.add_routing_table(goal, goal, 1)

    def add_routing_table(
        self, goal: NodeID, next_hop: NodeID, remaining_hops: int = 1
    ) -> None:
        with self._lock:
            self.routing_table[goal] = RoutingInfo(next_hop, remaining_hops)

    def update_leader(self, leader_id: NodeID) -> None:
        with self._lock:
            if leader_id not in self.routing_table:
                raise KeyError("routing entry for the specified leader does not exist")
            self.leader_id = leader_id


class MessageLoop:
    """Drains a transport's delivery queue and dispatches by message type.

    The reference runs one goroutine per node reading ``Deliver()`` and
    spawns a goroutine per message (node.go:271-287); here a single loop
    thread feeds a bounded pool, which gives the same never-block-control
    property with tamer thread counts.
    """

    def __init__(self, transport: Transport,
                 max_workers: Optional[int] = None):
        if max_workers is None:
            # Fleet-scale knob: an N-node in-process harness (the inmem
            # fan-out rows) would otherwise lazily grow N x 16 handler
            # threads.
            try:
                max_workers = int(os.environ.get("DLD_MSGLOOP_WORKERS",
                                                 "16"))
            except ValueError:
                max_workers = 16
        self._transport = transport
        self._handlers: Dict[Type, Callable] = {}
        self._stop = threading.Event()
        # Control-plane threads carry stable names (utils/threads.py
        # census buckets them by prefix; docs/observability.md).
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="ctl-worker")
        self._thread: Optional[threading.Thread] = None

    def register(self, msg_cls: Type, handler: Callable) -> None:
        self._handlers[msg_cls] = handler

    def register_keep(self, msg_cls: Type, handler: Callable) -> None:
        """Register only when no handler exists for the type.  A standby
        promoted to leader shares the WORKER's already-running loop
        (two loops draining one transport queue would steal each other's
        messages), and its leader-side registrations must fill the
        control-plane gaps (announce/ack/heartbeat/...) without
        clobbering the worker's data-plane handlers (layer reassembly,
        flow jobs) — see runtime/failover.py."""
        self._handlers.setdefault(msg_cls, handler)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="msgloop")
        self._thread.start()

    def _run(self) -> None:
        q = self._transport.deliver()
        # Per-seat control-traffic accounting: the fan-out rows compare
        # how many control messages the ROOT handled flat vs
        # hierarchically (docs/hierarchy.md) — keyed by the transport's
        # bound node id so co-resident inmem nodes don't pool into one
        # counter.  The id is bound before start() in every real path
        # and invariant for the loop's lifetime: resolve the counter
        # key ONCE, off the per-message hot path.
        node_id = getattr(self._transport, "node_id", None)
        handled_key = (f"ctrl.handled.{node_id}"
                       if node_id is not None else None)
        while not self._stop.is_set():
            try:
                msg = q.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._stop.is_set():
                # stop() landed while this get was blocked: the message
                # belongs to whichever loop drains the queue next (a
                # client closed on a transport another loop now owns).
                q.put(msg)
                break
            if handled_key is not None:
                telemetry.count(handled_key)
            handler = self._handlers.get(type(msg))
            if handler is None:
                log.debug("unhandled message", kind=type(msg).__name__)
                continue
            self.submit(handler, msg)

    def submit(self, fn: Callable, *args) -> None:
        """Run ``fn(*args)`` on the pool, tolerating a concurrent
        ``stop()`` (work arriving mid-shutdown is dropped, not raised)."""
        try:
            self._pool.submit(self._safe, fn, *args)
        except RuntimeError:
            if not self._stop.is_set():
                raise

    @staticmethod
    def _safe(handler: Callable, *args) -> None:
        try:
            handler(*args)
        except Exception as e:  # noqa: BLE001 — a handler crash must not kill the loop
            log.error("handler failed", fn=getattr(handler, "__name__", "?"),
                      err=repr(e))

    def stop(self) -> None:
        self._stop.set()
        self._pool.shutdown(wait=False)
