"""Byte-range interval accounting.

The reference's mode-3 receiver counts received *sizes* and acks when the
sum reaches the layer total (the reference's ``distributor/node.go:
1542-1566``) — duplicated or overlapping fragments would ack a layer full
of holes.  Tracking the union of covered ``[start, end)`` intervals makes
reassembly idempotent, which is what allows the failure detector to
re-plan in-flight layers (duplicates are harmless) and resumable
transfers to report precise missing ranges.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]  # [start, end)


def insert(intervals: List[Interval], start: int, end: int) -> List[Interval]:
    """Union ``[start, end)`` into a sorted list of disjoint intervals."""
    if start >= end:
        return intervals
    out: List[Interval] = []
    i, n = 0, len(intervals)
    while i < n and intervals[i][1] < start:
        out.append(intervals[i])
        i += 1
    while i < n and intervals[i][0] <= end:
        start = min(start, intervals[i][0])
        end = max(end, intervals[i][1])
        i += 1
    out.append((start, end))
    out.extend(intervals[i:])
    return out


def covered(intervals: List[Interval]) -> int:
    """Total bytes covered by a disjoint interval list."""
    return sum(e - s for s, e in intervals)


def uncovered(
    intervals: List[Interval], start: int, end: int
) -> List[Interval]:
    """Subranges of ``[start, end)`` NOT covered by the (sorted, disjoint)
    interval list — what a duplicate-tolerant writer still has to land."""
    out: List[Interval] = []
    pos = start
    for s, e in intervals:
        if e <= pos:
            continue
        if s >= end:
            break
        if s > pos:
            out.append((pos, min(s, end)))
        pos = max(pos, min(e, end))
        if pos >= end:
            break
    if pos < end:
        out.append((pos, end))
    return out


def remove(intervals: List[Interval], start: int, end: int) -> List[Interval]:
    """Subtract ``[start, end)`` from a sorted disjoint interval list —
    the rollback of a failed write claim."""
    if start >= end:
        return intervals
    out: List[Interval] = []
    for s, e in intervals:
        if e <= start or s >= end:
            out.append((s, e))
            continue
        if s < start:
            out.append((s, start))
        if e > end:
            out.append((end, e))
    return out


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Ranges covered by BOTH sorted disjoint interval lists — what a
    resume may trust when the journal's coverage and the disk bytes'
    verified ranges disagree (checkpoint CRC hardening)."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(intervals: List[Interval], total: int) -> List[Interval]:
    """The gaps: ranges of ``[0, total)`` NOT covered — the byte ranges a
    resumed transfer still needs."""
    gaps: List[Interval] = []
    pos = 0
    for s, e in intervals:
        if s > pos:
            gaps.append((pos, s))
        pos = max(pos, e)
    if pos < total:
        gaps.append((pos, total))
    return gaps


class ClaimedCoverage:
    """Claim/commit coverage accounting for out-of-lock byte movement.

    THE shared discipline of the incremental device ingest
    (``parallel/ingest.ShardedLayerIngest``) and the mode-3 receiver's
    fragment assembly (``runtime/receiver``): a writer CLAIMS its
    still-uncovered subranges (reserving them so concurrent duplicates
    never copy twice), moves the bytes outside the caller's lock, then
    COMMITS — or ABORTS, rolling the reservation back so failed copies
    are never reported as landed bytes.  ``committed()`` is the honest
    view (covered minus in-flight claims); ``complete()`` is the
    promotion/finalize gate (full coverage, nothing in flight).

    NOT itself thread-safe: callers mutate it under their own lock — the
    point is precisely that the byte movement happens OUTSIDE that lock,
    bracketed by claim/commit.

    Tokens are PROCESS-unique (one shared counter), not per-instance:
    claim tokens travel outside their coverage object (a transport
    sink's placed fragments carry them through the delivery queue), and
    a receiver replaced on a live transport (declared-dead revival) can
    drain a predecessor's queued tokens — per-instance counters would
    let such a foreign token collide with a live claim and commit bytes
    that never landed.  A foreign token now pops nothing, ever.
    """

    __slots__ = ("_covered", "_inflight")

    _TOKENS = itertools.count()  # process-unique: see docstring

    def __init__(self, covered: Optional[List[Interval]] = None):
        self._covered: List[Interval] = list(covered or [])
        self._inflight: Dict[int, List[Interval]] = {}

    def claim(self, start: int, end: int):
        """Reserve the uncovered subranges of ``[start, end)``.  Returns
        ``(token, ranges)``; ``(None, [])`` when fully covered already (a
        duplicate — nothing to move)."""
        ranges = uncovered(self._covered, start, end)
        if not ranges:
            return None, []
        for lo, hi in ranges:
            self._covered = insert(self._covered, lo, hi)
        tok = next(ClaimedCoverage._TOKENS)
        self._inflight[tok] = ranges
        return tok, ranges

    def commit(self, tok: Optional[int]) -> None:
        if tok is not None:
            self._inflight.pop(tok, None)

    def abort(self, tok: Optional[int]) -> None:
        """Roll a failed claim's reservation back out of the coverage."""
        if tok is None:
            return
        for lo, hi in self._inflight.pop(tok, ()):
            self._covered = remove(self._covered, lo, hi)

    def covered_bytes(self) -> int:
        return covered(self._covered)

    def idle(self) -> bool:
        return not self._inflight

    def complete(self, total: int) -> bool:
        return not self._inflight and covered(self._covered) >= total

    def complete_range(self, start: int, end: int) -> bool:
        """Promotion gate for a SHARDED target (docs/sharding.md): the
        range ``[start, end)`` is fully covered and nothing is in
        flight — coverage outside the range is irrelevant."""
        return not self._inflight and not uncovered(self._covered,
                                                    start, end)

    def committed(self) -> List[Interval]:
        """Covered ranges whose bytes REALLY landed (in-flight claims
        excluded) — what salvage/announce/seed may read."""
        out = list(self._covered)
        for ranges in self._inflight.values():
            for lo, hi in ranges:
                out = remove(out, lo, hi)
        return out
