"""In-process span instrumentation over the structured log stream.

The reference profiles exclusively through timestamped logs
(``distributor/node.go:1168-1186`` et al.); ``span``
standardizes that idiom: a context manager that logs completion with a
``duration_ms`` field, which ``cli/trace.py`` renders as a timeline
slice.  Zero infrastructure — the logs stay the single source of truth,
merged across hosts by ``cli/collect_logs.py`` exactly like the
reference's jq pipeline.

Under ``torch.profiler`` the same spans and phases also land in the
profiler's trace, on the device activity's clock: each is entered as
``record_function(f"dld.{name}")`` on a thread the profiler records, so
one name runs from the trace to the phase totals.  With no profiler
running that costs one check per block and nothing more.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

from .logging import log


_profiler_enabled = None  # torch's per-thread check, once torch is loaded


def _annotation(name: str):
    """``torch.profiler.record_function(f"dld.{name}")``, entered, when a
    profiler records the calling thread; else None.  Never imports
    torch: with torch not loaded no profiler can be running."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        _profiler_enabled = torch._C._autograd._profiler_enabled
    if not _profiler_enabled():
        return None
    rf = sys.modules["torch"].profiler.record_function(f"dld.{name}")
    rf.__enter__()
    return rf


def _close(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a block and log it as a trace-friendly completion record::

        with span("stage layer", layerID=3):
            ...

    emits ``{"message": "stage layer", "layerID": 3, "duration_ms": ...}``.
    The record is logged even when the block raises (with ``error`` set),
    so traces show failed work instead of omitting it.
    """
    rf = _annotation(name)
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
    finally:
        _close(rf)


# ----------------------------------------------------------- phase markers
#
# Cheap in-process phase accounting for the device-fabric plane: the
# per-plan pipeline (compile / upload / collective / splice) runs across
# handler threads and async device queues, so wall-clock spans alone
# can't attribute where a TTD went.  Timed sections call ``add_phase``
# (or use the ``phase`` context manager); harnesses read the summed
# totals via ``phase_totals`` — podrun folds them into its summary line,
# and ``cli/ttd_matrix.py`` renders the fabric row's phase-breakdown
# table from them.  Sums are thread-time: concurrent phases overlap, so
# totals may exceed the run's wall clock (the tables say so).
#
# STORAGE lives in the run-scoped ``utils/telemetry.py`` registry now —
# these functions are the stable writer API (every instrumented call
# site keeps ``trace.add_phase``/``trace.count``), but the sums are no
# longer process-global module state: ``telemetry.reset_run()`` clears
# them between runs (the tests' autouse fixture, a promoted standby, a
# harness's per-trial reset), and ``telemetry.snapshot()`` ships them in
# MetricsReportMsg / RUN_REPORT.  ``reset_run`` is re-exported here for
# writers that already import ``trace``.

# TTFT buckets (the boot pipeline): written by
# ``runtime/stream_boot.py``; ``chip_smoke.py`` reports the first.
# - ``boot_stream_stage``        per-blob streamed decode/upload seconds
# - ``boot_stream_in_wire``      the subset that ran before startup —
#                                stage-overlap-achieved

from . import telemetry as _telemetry  # noqa: E402  (storage backend)


def add_phase(name: str, seconds: float) -> None:
    """Accumulate ``seconds`` into the named phase bucket."""
    _telemetry.add_phase(name, seconds)


@contextlib.contextmanager
def phase(name: str):
    """Time a block into the named phase bucket (recorded even when the
    block raises — failed work is still attributable work); under a
    profiler the block is also the span ``dld.<name>``."""
    rf = _annotation(name)
    t0 = time.monotonic()
    try:
        yield
    finally:
        add_phase(name, time.monotonic() - t0)
        _close(rf)


class Steps:
    """Consecutive phases of one thread with no time between them:
    ``next(name)`` ends the open phase and opens ``name``, ``close()``
    ends the last (a no-op once closed)."""

    def __init__(self):
        self._open = None

    def next(self, name: str) -> None:
        self.close()
        self._open = phase(name)
        self._open.__enter__()

    def close(self) -> None:
        cm, self._open = self._open, None
        if cm is not None:
            cm.__exit__(None, None, None)


class Busy:
    """The union of the blocks run under it, on any thread, timed into
    the phase bucket ``name``: the first block to open starts the clock,
    the last to close adds the time since.  Where ``phase`` sums thread
    time, concurrent blocks here count once."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._open = 0
        self._since = 0.0

    def __enter__(self) -> "Busy":
        with self._lock:
            if self._open == 0:
                self._since = time.monotonic()
            self._open += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._lock:
            self._open -= 1
            dt = time.monotonic() - self._since if self._open == 0 else None
        if dt is not None:
            add_phase(self.name, dt)


def phase_totals() -> dict:
    """``{name: {"ms": summed_milliseconds, "n": samples}}`` so far."""
    return _telemetry.default().phase_totals()


def reset_phases() -> None:
    _telemetry.default().reset_phases()


# ------------------------------------------------------------ event counters
#
# Integrity-plane accounting (docs/integrity.md): how many fragments were
# dropped for a bad CRC, how many NACKs went out, how many bytes were
# retransmitted, how many digests mismatched.  Same shape as the phase
# buckets — in-process sums the harness reads at the end of a run — but
# counting EVENTS, not seconds.  Writers: transport/tcp.py,
# transport/inmem.py, runtime/receiver.py, runtime/send.py.  Stored in
# the run-scoped telemetry registry (see the phase-marker note above).


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the named event counter."""
    _telemetry.count(name, n)


def counter_totals() -> dict:
    """``{name: total}`` so far."""
    return _telemetry.default().counter_totals()


def reset_counters() -> None:
    _telemetry.default().reset_counters()


def reset_run() -> None:
    """Clear ALL run-scoped accounting (phases, counters, gauges,
    histograms, per-link flight recorder) — the between-runs reset."""
    _telemetry.reset_run()
