"""Failure detection: heartbeats + timeout-based crash detection.

The reference declares failure handling and leaves it TODO — ``crash(n
node)`` is an empty interface stub (``distributor/
node.go:218-220``) and there are no timeouts or retries anywhere.  This
module fills that gap:

- :class:`HeartbeatSender` — a receiver-side thread beaconing
  ``HeartbeatMsg`` to the leader on a fixed interval.
- :class:`FailureDetector` — a leader-side monitor; any message from a
  node refreshes its lease (heartbeats just guarantee traffic during long
  silences), and a node silent past the timeout is declared crashed, once,
  via the leader's ``crash()`` hook.

Both are opt-in (interval/timeout 0 disables them), preserving exact
reference behavior by default.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..core.types import NodeID
from ..transport.base import Transport
from ..transport.messages import HeartbeatMsg
from ..utils.logging import log


class HeartbeatSender:
    """Beacons ``HeartbeatMsg(my_id)`` to the leader every ``interval``
    seconds until stopped.  Send failures are logged, not raised — a
    temporarily unreachable leader must not kill the beacon."""

    def __init__(
        self,
        transport: Transport,
        my_id: NodeID,
        leader_id: NodeID,
        interval: float,
        leader_fn: Optional[Callable[[], NodeID]] = None,
    ):
        """``leader_fn``: live leader lookup, re-read every beat — after
        an epoch-fenced failover (docs/failover.md) the beacon must
        follow the NEW leader, not keep feeding a dead seat's queue."""
        self._transport = transport
        self._my_id = my_id
        self._leader_fn = leader_fn if leader_fn is not None else (
            lambda: leader_id)
        self._interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-{self._my_id}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._transport.send(self._leader_fn(),
                                     HeartbeatMsg(self._my_id))
            except (OSError, KeyError) as e:
                log.warn("heartbeat send failed", err=repr(e))

    def stop(self) -> None:
        self._stop.set()


class FailureDetector:
    """Leader-side liveness monitor.

    ``touch(node_id)`` refreshes a node's lease (call it for *every*
    message received from the node); a monitor thread scans every
    ``timeout / 4`` seconds and reports nodes silent for longer than
    ``timeout`` to ``on_crash``, exactly once per node.
    """

    def __init__(self, timeout: float, on_crash: Callable[[NodeID], None]):
        self._timeout = timeout
        self._on_crash = on_crash
        self._last_seen: Dict[NodeID, float] = {}
        self._dead: "set[NodeID]" = set()
        # Cleanly-departed nodes (elastic membership, docs/membership.md):
        # unlike forget(), a removed node's in-flight heartbeats must not
        # re-arm a lease — a drained node that then exits would be
        # declared crashed by the very beacon it sent while draining.
        self._removed: "set[NodeID]" = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        """Start (or RESTART) the monitor.  Restartable on purpose: a
        stood-down sub-leader whose group re-forms (docs/membership.md)
        re-arms member liveness on the same detector instance.  A
        restart during the stop window arms a FRESH stop event — the
        prior thread captured the old one and exits on its own, so a
        re-arm can never be silently swallowed by a still-draining
        monitor."""
        if self._timeout <= 0:
            return
        with self._lock:
            if (self._thread is not None and self._thread.is_alive()
                    and not self._stop.is_set()):
                return  # already monitoring
            if self._stop.is_set():
                self._stop = threading.Event()
            thread = threading.Thread(target=self._run,
                                      args=(self._stop,), daemon=True,
                                      name="detector")
            self._thread = thread
        thread.start()

    def touch(self, node_id: NodeID) -> None:
        with self._lock:
            if node_id not in self._dead and node_id not in self._removed:
                self._last_seen[node_id] = time.monotonic()

    def forget(self, node_id: NodeID) -> None:
        """Stop monitoring a node (e.g. after its assignment was dropped)."""
        with self._lock:
            self._last_seen.pop(node_id, None)

    def silent_ages(self) -> Dict[NodeID, float]:
        """Seconds of silence per monitored (not dead/removed) node —
        the autonomy engine's death-suspicion signal: a node silent for
        a large fraction of ``timeout`` gets its unique holdings
        proactively re-homed BEFORE the crash path fires
        (docs/autonomy.md).  Read-only; never mutates leases."""
        now = time.monotonic()
        with self._lock:
            return {n: max(0.0, now - t)
                    for n, t in self._last_seen.items()}

    @property
    def timeout(self) -> float:
        return self._timeout

    def remove(self, node_id: NodeID) -> None:
        """Permanently stop monitoring a cleanly-departed node: the
        lease is dropped AND later touches (straggler heartbeats, a
        queued announce) are ignored until :meth:`revive` — a clean
        leave can never race a false ``crash()``."""
        with self._lock:
            self._last_seen.pop(node_id, None)
            self._removed.add(node_id)

    def revive(self, node_id: NodeID) -> None:
        """Re-admit a declared-dead node (a restarted process announcing
        again) and restart its lease.  If the announce was actually a stale
        queued message, the fresh lease simply expires again."""
        with self._lock:
            self._dead.discard(node_id)
            self._removed.discard(node_id)
            self._last_seen[node_id] = time.monotonic()

    def _run(self, stop: threading.Event) -> None:
        scan = self._timeout / 4
        while not stop.wait(scan):
            now = time.monotonic()
            with self._lock:
                expired = [
                    nid
                    for nid, seen in self._last_seen.items()
                    if now - seen > self._timeout
                ]
                for nid in expired:
                    del self._last_seen[nid]
                    self._dead.add(nid)
            for nid in expired:
                log.error("node declared crashed", node=nid,
                          timeout_s=self._timeout)
                try:
                    self._on_crash(nid)
                except Exception as e:  # noqa: BLE001 — keep monitoring
                    log.error("crash handler failed", node=nid, err=repr(e))

    def is_dead(self, node_id: NodeID) -> bool:
        with self._lock:
            return node_id in self._dead

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
