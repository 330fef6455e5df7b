"""Bounded exponential backoff with deterministic jitter.

Transport send paths retry transient failures (a dialing peer that
hasn't bound its listener yet, a pooled connection whose peer restarted,
a briefly-partitioned leader) before surfacing ``OSError`` to the
protocol layer.  The retry cadence matters twice over:

- **Exponential + capped**: a dead peer must cost a bounded, cheap probe
  sequence — not a tight dial loop that burns CPU exactly when the
  cluster is already degraded.
- **Jittered**: every worker loses the leader at the SAME instant during
  a failover, so un-jittered retries stampede the successor in lockstep.
  The jitter here is *deterministic* — derived from (seed, attempt) by a
  Weyl-style integer hash, no ``random`` — so a failing chaos run
  replays its exact retry timeline from the seed (the same property
  ``transport/faults.py`` guarantees for the fault schedule itself).
"""

from __future__ import annotations

import time
from typing import Iterator

# Knuth's multiplicative hash constant (2^32 / phi), for the jitter mix.
_MIX = 2654435761


def jitter_frac(seed: int, attempt: int) -> float:
    """Deterministic jitter fraction in [0, 1) for one (seed, attempt)."""
    h = (seed * _MIX + attempt * 40503 + 0x9E3779B9) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * _MIX) & 0xFFFFFFFF
    return (h >> 8) / float(1 << 24)


class Backoff:
    """A bounded exponential backoff schedule.

    ``delays()`` yields ``retries`` sleep durations: attempt k's base is
    ``base * factor**k`` capped at ``max_delay``, scaled into
    ``[1/2, 1) * base_k`` by the deterministic jitter.  Total worst-case
    wall is therefore bounded by ``sum(min(base * factor**k, max_delay))``
    — callers with their own deadline (the TCP dial window) additionally
    clamp each sleep to the time remaining.
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 max_delay: float = 2.0, retries: int = 4, seed: int = 0):
        self.base = base
        self.factor = factor
        self.max_delay = max_delay
        self.retries = retries
        self.seed = seed

    def delays(self) -> Iterator[float]:
        for attempt in range(self.retries):
            raw = min(self.base * (self.factor ** attempt), self.max_delay)
            yield raw * (0.5 + 0.5 * jitter_frac(self.seed, attempt))

    def run(self, fn, retry_on=(OSError,), deadline: float = 0.0,
            sleep=time.sleep):
        """Call ``fn`` until it returns, retrying ``retry_on`` failures
        through the delay schedule; the last failure re-raises.  A
        nonzero ``deadline`` (monotonic timestamp) stops retrying — and
        clamps each sleep — once reached."""
        last = None
        for i, delay in enumerate([0.0] + list(self.delays())):
            if delay:
                if deadline and time.monotonic() >= deadline:
                    break
                if deadline:
                    delay = min(delay, max(0.0, deadline - time.monotonic()))
                sleep(delay)
            try:
                return fn()
            except retry_on as e:  # noqa: PERF203 — retry loop
                last = e
        raise last
