"""Reduction of a ``torch.profiler`` trace (the exported Chrome trace).

Device activity is every kernel, copy and memset the trace records, by
the card it ran on; the host side is the benchmark's own spans
(``bench.*`` annotations) around its calls into the port.  Times in the
trace are microseconds; everything returned here is in seconds.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


class Trace:
    def __init__(self, events: List[dict]):
        self.events = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in self.events
                       if e.get("cat") in DEVICE_CATS
                       and "device" in (e.get("args") or {})]
        self.spans = [e for e in self.events
                      if e.get("cat") == "user_annotation"
                      and str(e.get("name", "")).startswith(SPAN_PREFIX)]

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def span(self, name: str) -> Optional[Tuple[float, float]]:
        """[start, end) in us of the first span called ``name``."""
        for e in self.spans:
            if e["name"] == name:
                return e["ts"], e["ts"] + e["dur"]
        return None

    def _intervals(self, dev: int, t0: float, t1: float):
        iv = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                    for e in self.device if e["args"]["device"] == dev)
        merged: List[List[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self, dev: int, t0: float, t1: float) -> float:
        return sum(b - a for a, b in self._intervals(dev, t0, t1)) / 1e6

    def idle_gaps(self, dev: int, t0: float, t1: float):
        """(start, end) in us of each stretch with no device activity."""
        gaps, pos = [], t0
        for a, b in self._intervals(dev, t0, t1):
            if a > pos:
                gaps.append((pos, a))
            pos = max(pos, b)
        if pos < t1:
            gaps.append((pos, t1))
        return gaps

    def host_label(self, t: float) -> str:
        """The innermost benchmark span open at ``t`` (microseconds)."""
        open_ = [e for e in self.spans if e["ts"] <= t < e["ts"] + e["dur"]]
        if not open_:
            return "outside the benchmark's spans"
        return min(open_, key=lambda e: e["dur"])["name"]

    def device_ops(self, t0: float, t1: float, top: int = 10):
        """[name, seconds] of the device operations that took most time."""
        by: Dict[str, float] = {}
        for e in self.device:
            if t0 <= e["ts"] < t1:
                name = str(e["name"])[:160]
                by[name] = by.get(name, 0.0) + e["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def copy_rate(self, substr: str, t0: float, t1: float):
        """(bytes, seconds) of the copies whose name holds ``substr``
        (``"HtoD"``, ``"PtoP"``) in [t0, t1): their bytes, and the time in
        which at least one of them ran, on any card."""
        evs = [e for e in self.device if e.get("cat") == "gpu_memcpy"
               and substr in str(e["name"]) and t0 <= e["ts"] < t1]
        nbytes = sum(int(e["args"].get("bytes", 0)) for e in evs)
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs)
        total, end = 0.0, float("-inf")
        for a, b in iv:
            if b > end:
                total += b - max(a, end)
                end = b
        return nbytes, total / 1e6

    def kernels(self, substr: str, t0: float, t1: float) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"
                and substr in str(e["name"]) and t0 <= e["ts"] < t1]
