"""Token-bucket rate limiter for paced byte streams.

Equivalent of golang.org/x/time/rate as used by the reference's transport
(``distributor/transport.go:407-424``): in-memory layer
sends are chunked (256 KiB bucket) and each chunk waits for tokens so a
transfer never exceeds its source's configured bytes/sec.
"""

from __future__ import annotations

import threading
import time

# Reference uses a 256 KiB burst bucket (distributor/transport.go:409).
DEFAULT_BURST = 256 * 1024

# One bucket quantum must represent at least this much wall time of
# traffic: time.sleep's OS granularity is ~1 ms, so a fixed 256 KiB
# bucket silently caps ANY commanded rate at ~burst/1ms (~256 MB/s) —
# a 10 GB/s ICI-class budget would ship at 1/40th of it.  Scaling the
# burst UP for fast rates keeps the pacing overhead bounded while
# leaving slow rates (where 256 KiB already spans many ms) at exact
# reference-parity burst semantics.
MIN_QUANTUM_S = 0.005


def effective_burst(rate: float, burst: int = DEFAULT_BURST) -> int:
    if rate <= 0:
        return burst
    return max(int(burst), int(rate * MIN_QUANTUM_S))


class TokenBucket:
    """Thread-safe token bucket: ``wait_n(n)`` blocks until n tokens exist.

    ``rate`` is tokens (bytes) per second; ``rate <= 0`` means unlimited.
    """

    def __init__(self, rate: float, burst: int = DEFAULT_BURST):
        self.rate = float(rate)
        # burst must be positive when limited, or wait_n's chunking spins;
        # fast rates scale it so sleep granularity can't cap throughput.
        self.burst = (max(1, effective_burst(rate, burst))
                      if rate > 0 else 0)
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def wait_n(self, n: int) -> None:
        if self.rate <= 0:
            return
        if n > self.burst:
            # Split oversized requests into burst-sized waits.
            remaining = n
            while remaining > 0:
                chunk = min(remaining, self.burst)
                self.wait_n(chunk)
                remaining -= chunk
            return
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    float(self.burst), self._tokens + (now - self._last) * self.rate
                )
                self._last = now
                if self._tokens >= n:
                    self._tokens -= n
                    return
                deficit = n - self._tokens
            time.sleep(deficit / self.rate)


class PacedWriter:
    """Wrap a write callable so bytes flow at most at ``rate`` B/s, in
    bucket-sized chunks (transport.go:407-424)."""

    def __init__(self, write, rate: float, burst: int = DEFAULT_BURST):
        self._write = write
        self._bucket = TokenBucket(rate, burst)
        self._chunk = self._bucket.burst if rate > 0 else 1 << 20

    def write(self, data: bytes) -> int:
        view = memoryview(data)
        sent = 0
        while sent < len(view):
            chunk = view[sent : sent + self._chunk]
            self._bucket.wait_n(len(chunk))
            self._write(chunk)
            sent += len(chunk)
        return sent
