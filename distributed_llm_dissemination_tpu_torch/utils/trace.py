"""In-process span instrumentation over the structured log stream.

The reference profiles exclusively through timestamped logs
(``distributor/node.go:1168-1186`` et al.); ``span``
standardizes that idiom: a context manager that logs completion with a
``duration_ms`` field, which ``cli/trace.py`` renders as a timeline
slice.  Zero infrastructure — the logs stay the single source of truth,
merged across hosts by ``cli/collect_logs.py`` exactly like the
reference's jq pipeline.
"""

from __future__ import annotations

import contextlib
import time

from .logging import log


@contextlib.contextmanager
def span(name: str, **fields):
    """Time a block and log it as a trace-friendly completion record::

        with span("stage layer", layerID=3):
            ...

    emits ``{"message": "stage layer", "layerID": 3, "duration_ms": ...}``.
    The record is logged even when the block raises (with ``error`` set),
    so traces show failed work instead of omitting it.
    """
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

# TTFT buckets (the boot pipeline): writers in
# ``runtime/receiver.py`` and ``runtime/stream_boot.py``; the
# ``cli/ttd_matrix.py`` physical row renders them as the TTFT breakdown.
# - ``boot_precompile``          hint-time XLA compile seconds (total)
# - ``boot_precompile_in_wire``  the subset that finished BEFORE startup
#                                — compile-overlap-achieved
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
    block raises — failed work is still attributable work)."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        add_phase(name, time.monotonic() - t0)


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
