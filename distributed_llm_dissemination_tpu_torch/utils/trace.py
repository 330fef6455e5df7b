"""In-process span, phase and counter instrumentation.

Copy of the JAX package's ``utils/trace.py`` writer API (``span``,
``add_phase``/``phase``, ``count``) with its own storage: a
:class:`Registry` object instead of the run-scoped telemetry registry,
which this slice does not port.  ``reset_run`` clears it between runs.
"""

from __future__ import annotations

import contextlib
import threading
import time

from .logging import log


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a block and log it as a completion record with
    ``duration_ms`` (logged with ``error`` set when the block raises)."""
    t0 = time.monotonic()
    try:
        yield
    except BaseException as e:
        log.error(name, duration_ms=round((time.monotonic() - t0) * 1000, 3),
                  error=repr(e), **fields)
        raise
    else:
        log.info(name, duration_ms=round((time.monotonic() - t0) * 1000, 3),
                 **fields)


class Registry:
    """Summed phase seconds and event counts, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._phases: dict = {}  # name -> [seconds, samples]
        self._counters: dict = {}

    def add_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            rec = self._phases.setdefault(name, [0.0, 0])
            rec[0] += seconds
            rec[1] += 1

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def phase_totals(self) -> dict:
        with self._lock:
            return {k: {"ms": v[0] * 1000, "n": v[1]}
                    for k, v in self._phases.items()}

    def counter_totals(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._lock:
            self._phases.clear()
            self._counters.clear()


_default = Registry()


def add_phase(name: str, seconds: float) -> None:
    """Accumulate ``seconds`` into the named phase bucket."""
    _default.add_phase(name, seconds)


@contextlib.contextmanager
def phase(name: str):
    """Time a block into the named phase bucket (recorded even when the
    block raises)."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        add_phase(name, time.monotonic() - t0)


def phase_totals() -> dict:
    """``{name: {"ms": summed_milliseconds, "n": samples}}`` so far."""
    return _default.phase_totals()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the named event counter."""
    _default.count(name, n)


def counter_totals() -> dict:
    """``{name: total}`` so far."""
    return _default.counter_totals()


def reset_run() -> None:
    """Clear all phase buckets and counters — the between-runs reset."""
    _default.reset()
