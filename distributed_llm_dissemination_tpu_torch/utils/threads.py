"""Bounded data-plane worker pools + the process thread census.

The data plane used to spawn a bare ``threading.Thread`` per accepted
connection, per stripe, and per simulated client fetch — so connection
count implied thread count, and a 1000-node fan-out meant a thousand
stacks per seeder.  This module is the ONE place data-plane concurrency
comes from now:

- :class:`WorkerPool` — a fixed-ceiling pool of named daemon workers
  (``<name>-<k>``) fed by an unbounded task queue.  Workers spawn
  lazily up to the ceiling and then persist; excess tasks queue, so K
  concurrent transfers use ``min(K, size)`` threads, never K.
- :func:`rx_pool` / :func:`tx_pool` — the process-wide pools serving
  layer-body receives (``transport/tcp.py``'s readiness loop hands
  ready connections here) and concurrent stripe sends.  They are
  SEPARATE pools on purpose: an in-process loopback test can otherwise
  fill every slot with sends blocked on a receiver that needs a slot
  to drain them — a classic one-pool deadlock.
- :func:`digest_pool` — the process-wide pool the holders' digest
  stamp hashes its layers on (``utils/integrity.digest_layer_srcs``)
  and the fabric sender copies pageable uploads into a card's pinned
  ring on (``runtime/send._staged_copy``), one worker per CPU the
  process may run on: hashing and copying are bound by the host's
  memory bandwidth, not by one core.
- :func:`census` — live thread counts bucketed by plane (data /
  control / other) from thread NAMES, surfaced as ``threads_*`` gauges
  in metric reports and the run report (docs/observability.md).  The
  static drift check (tests/test_threads.py) pins every remaining bare
  ``threading.Thread(`` site, so new spawns must either route through
  a pool here or be explicitly allowlisted with a stable name.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Dict, Optional

# One pool's worker ceiling.  Small on purpose: these threads do
# syscall-bound socket work, and the receive path's control traffic is
# handled inline by the readiness loop (transport/tcp.py) — only layer
# BODIES occupy a slot.  Env-tunable per deployment.
DEFAULT_POOL_SIZE = max(2, int(os.environ.get("DLD_DATA_THREADS", "8")))

# Thread-name prefixes per plane, the census's classification table.
# Data plane: pool workers + the transport readiness loop.  Control
# plane: every named long-lived protocol/bookkeeping thread.  Anything
# unnamed (or Python's own threads) counts as "other" — the census is
# a gauge, not an allowlist; the drift check is the allowlist.
#
# The data plane's names carry a "torch-" prefix the JAX package's do
# not: where both packages run in one process (mixed-cluster tests), each
# census and each pool ceiling counts only its own package's pools.
DATA_PREFIXES = ("torch-data-rx", "torch-data-tx", "torch-data-digest",
                 "torch-tcp-evloop")
CONTROL_PREFIXES = (
    "msgloop", "ctl-worker", "detector", "heartbeat-", "metrics-",
    "leader-lease", "lease-", "replicate-", "plan-watchdog",
    "plan-window", "layer-digests", "swap-", "boot-", "gap-nack",
    "subleader-", "fault-pump", "fabric-", "spmd-", "serve",
    "genreq-", "telemetry-watch", "lp-warm", "tcp-stripe-sweep",
)


class _Task:
    """A submitted unit of work; ``wait()`` blocks until it ran (the
    exception, if any, re-raises in the waiter — stripe sends need the
    first error back on the dispatching thread)."""

    __slots__ = ("fn", "args", "_done", "error")

    def __init__(self, fn: Callable, args: tuple):
        self.fn = fn
        self.args = args
        self._done = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.fn(*self.args)
        except BaseException as e:  # noqa: BLE001 — surfaced to wait()
            self.error = e
        finally:
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class WorkerPool:
    """Fixed-ceiling named worker pool.  Threads spawn lazily (a pool
    that never sees work costs nothing) up to ``size`` and then
    persist; the task queue is unbounded, so ``submit`` never blocks
    the caller — excess concurrency serializes instead of spawning."""

    def __init__(self, size: int, name: str):
        self.size = max(1, int(size))
        self.name = name
        self._q: "queue.Queue[_Task]" = queue.Queue()
        self._lock = threading.Lock()
        self._spawned = 0
        self._idle = 0
        self._pending = 0  # submitted, not yet dequeued by a worker

    def submit(self, fn: Callable, *args) -> _Task:
        task = _Task(fn, args)
        with self._lock:
            self._pending += 1
            # Spawn while queued work exceeds genuinely idle workers
            # and the ceiling has room.  An "idle" worker that is
            # already committed to an earlier task makes this
            # over-spawn by at most one — bounded by the ceiling and
            # strictly better than a racing submit serializing behind
            # a long transfer with ceiling headroom unused.
            spawn = (self._pending > self._idle
                     and self._spawned < self.size)
            if spawn:
                self._spawned += 1
                worker_id = self._spawned - 1
        self._q.put(task)
        if spawn:
            threading.Thread(
                target=self._work, daemon=True,
                name=f"{self.name}-{worker_id}",
            ).start()
        return task

    def run_all(self, calls) -> None:
        """Run ``(fn, *args)`` tuples concurrently: all but the first
        go to the pool, the first runs on the CALLING thread, and while
        waiting the caller HELPS — it steals queued tasks and runs them
        inline.  The help loop is what makes nested pool use safe: a
        pool worker whose own task fans into ``run_all`` (a striped
        send inside a pooled fan-out send) never parks a worker slot
        waiting on work that needs a free worker — every waiter IS a
        worker, so the pool can saturate but never deadlock.
        Re-raises the first failure after every call finished."""
        calls = list(calls)
        if not calls:
            return
        tasks = [self.submit(fn, *args) for fn, *args in calls[1:]]
        first = _Task(calls[0][0], tuple(calls[0][1:]))
        first.run()
        for t in tasks:
            while not t.wait(0):
                try:
                    stolen = self._q.get_nowait()
                except queue.Empty:
                    t.wait(0.02)
                    continue
                with self._lock:
                    self._pending -= 1
                stolen.run()
        for t in [first] + tasks:
            if t.error is not None:
                raise t.error

    def _work(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            try:
                task = self._q.get()
            finally:
                with self._lock:
                    self._idle -= 1
                    self._pending -= 1
            task.run()
            # An idle worker must not pin its last task: a finished
            # transfer's bound method holds its transport, the receiver
            # behind its sink and, through it, the staged device tensors.
            del task


_rx: Optional[WorkerPool] = None
_tx: Optional[WorkerPool] = None
_digest: Optional[WorkerPool] = None
_pools_lock = threading.Lock()


def rx_pool() -> WorkerPool:
    """The process-wide receive pool: transport readiness loops hand
    layer-body reads here."""
    global _rx
    with _pools_lock:
        if _rx is None:
            _rx = WorkerPool(DEFAULT_POOL_SIZE, "torch-data-rx")
        return _rx


def tx_pool() -> WorkerPool:
    """The process-wide send pool: concurrent stripe sends (and other
    per-transfer send work) run here."""
    global _tx
    with _pools_lock:
        if _tx is None:
            _tx = WorkerPool(DEFAULT_POOL_SIZE, "torch-data-tx")
        return _tx


def usable_cpus() -> int:
    """The CPUs this process may run on: its affinity mask, or the
    machine's count where the platform has no mask."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def digest_pool() -> WorkerPool:
    """The process-wide digest pool, one worker per usable CPU: the
    digest stamp's hashes and the fabric sender's staging copies.  Its
    workers spawn as tasks queue, so hashing n layers takes
    ``min(n, usable_cpus())`` of them."""
    global _digest
    with _pools_lock:
        if _digest is None:
            _digest = WorkerPool(usable_cpus(), "torch-data-digest")
        return _digest


def data_thread_ceiling() -> int:
    """The hard ceiling on data-plane threads this process can reach:
    the socket pools' worker budgets, one readiness-loop thread and the
    digest pool's workers.  Live data threads never exceed this,
    whatever the connection or layer count."""
    return 2 * DEFAULT_POOL_SIZE + 1 + usable_cpus()


def census() -> Dict[str, int]:
    """Live thread counts by plane, classified by thread name."""
    out = {"data": 0, "control": 0, "other": 0}
    for t in threading.enumerate():
        name = t.name or ""
        if name.startswith(DATA_PREFIXES):
            out["data"] += 1
        elif name.startswith(CONTROL_PREFIXES):
            out["control"] += 1
        else:
            out["other"] += 1
    return out


def publish_census() -> Dict[str, int]:
    """File the census as ``threads_<plane>`` telemetry gauges (the
    metric reporters call this just before snapshotting, so the run
    report's threads-by-plane table is per node)."""
    from . import telemetry

    counts = census()
    for plane, n in counts.items():
        telemetry.gauge(f"threads_{plane}", n)
    return counts
