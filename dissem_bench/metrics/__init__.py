"""One reader per per-layer metric: ``<name>.py`` defines ``read(run)``,
which returns the metric's value, or None where the run has nothing to
read for it (the metric is then left out of the result).

``run`` carries the cell's ``shape``, ``tokens``, ``cards`` and
``chips``, the window's rounds (``rounds``: each round's host clocks,
the port's counter and phase totals, ``solve_ms``), the set-up's copy
probe (``probe_gbps``) and, in a traced run, the first round's device
trace (``trace``, ``window``: a ``devtrace.Trace`` and the round's span
in microseconds)."""

from __future__ import annotations

import statistics


def mean(values):
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def phase_ms(run, phase: str):
    """Mean per round of one of the port's phase totals (ms summed over
    threads); None where no round recorded the phase."""
    if not any(phase in r["phases"] for r in run.rounds):
        return None
    return mean(phase_total_ms(r, phase) for r in run.rounds)


def phase_total_ms(rnd, phase: str) -> float:
    return float(rnd["phases"].get(phase, {}).get("ms", 0.0))
