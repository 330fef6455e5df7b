"""Transfer checkpoint/resume: crash-durable partial-layer progress.

The reference has no checkpointing; its nearest machinery is layer files
on disk (``cmd/config.go:133-157``) and the mode-3
receiver's (non-durable) incremental byte accounting
(``distributor/node.go:1542-1554``).  Here every received fragment is
also written at its offset into ``<dir>/<layer_id>.part`` with the
covered intervals journaled in ``<dir>/<layer_id>.meta.json``; a
restarted receiver reloads its partial buffers, announces the covered
ranges, and the mode-3 leader schedules **only the gaps** — a crash
costs at most the fragments in flight, not the transfer.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..core.types import LayerID
from ..utils import integrity, intervals, trace
from ..utils.logging import log

# layer -> (buffer, covered intervals, total size)
PartialState = Dict[LayerID, Tuple[bytearray, List[Tuple[int, int]], int]]


class LayerCheckpointStore:
    """Durable fragment journal for one receiver.

    ``write_fragment`` is crash-ordered: bytes land in the ``.part`` file
    before the meta journal records them as covered, so a crash between
    the two writes only *under*-reports progress (the range is re-sent,
    which interval reassembly absorbs) — never the fatal inverse.  Both
    writes are fsync'd, so the ordering holds across host power loss, not
    just process crashes: the journal can never claim bytes the disk lost.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _part(self, layer_id: LayerID) -> str:
        return os.path.join(self.dir, f"{layer_id}.part")

    def _meta(self, layer_id: LayerID) -> str:
        return os.path.join(self.dir, f"{layer_id}.meta.json")

    def write_bytes(
        self, layer_id: LayerID, offset: int, data: bytes, total: int
    ) -> None:
        """Persist one fragment's bytes into the ``.part`` file, fsync'd —
        data durable before any journal update covers it.  Safe for
        concurrent writers: O_CREAT|O_RDWR never truncates (a racing
        'w+b'-style create would zero a sibling's already-fsync'd range),
        and the grow-only ftruncate is idempotent."""
        fd = os.open(self._part(layer_id), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            if os.fstat(fd).st_size < total:
                os.ftruncate(fd, total)  # extend-only: never destroys data
            # Loop to completion: a single pwrite caps at ~2 GiB on Linux,
            # and a silently short write would let write_meta journal bytes
            # the file holds as zeros.
            view = memoryview(data)
            written = 0
            while written < len(view):
                written += os.pwrite(fd, view[written:], offset + written)
            os.fsync(fd)
        finally:
            os.close(fd)

    def write_meta(
        self,
        layer_id: LayerID,
        covered: List[Tuple[int, int]],
        total: int,
        frag_crcs: Optional[List[Tuple[int, int, int]]] = None,
    ) -> None:
        """Journal the durably-covered ranges.  Callers must pass only
        ranges whose ``write_bytes`` has already returned — the journal can
        never claim bytes the disk might not hold (a racing older snapshot
        landing later only under-reports, which re-sending absorbs).  The
        tmp name is per-writer (pid + thread), so concurrent journalers of
        one layer never truncate each other's half-written JSON.

        ``frag_crcs``: per-journaled-fragment ``(offset, length, crc32)``
        records (integrity hardening, docs/integrity.md) — ``load``
        re-reads each range from the ``.part`` file and verifies it, so
        a corrupted disk (bit rot, torn write the fsync ordering can't
        see, foreign truncation) can never resume as "covered": bad
        ranges fall out of the restored coverage and are re-fetched."""
        tmp = (f"{self._meta(layer_id)}.{os.getpid()}"
               f".{threading.get_ident()}.tmp")
        doc = {"Total": total, "Covered": [list(iv) for iv in covered]}
        if frag_crcs:
            doc["FragCrcs"] = [[int(o), int(n), int(c)]
                               for o, n, c in frag_crcs]
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta(layer_id))  # atomic journal update

    def write_fragment(
        self,
        layer_id: LayerID,
        offset: int,
        data: bytes,
        covered: List[Tuple[int, int]],
        total: int,
        frag_crcs: Optional[List[Tuple[int, int, int]]] = None,
    ) -> None:
        """Persist one fragment + coverage (single-writer convenience;
        concurrent writers must use write_bytes + write_meta with a
        durable-only coverage union)."""
        self.write_bytes(layer_id, offset, data, total)
        self.write_meta(layer_id, covered, total, frag_crcs=frag_crcs)

    def complete(self, layer_id: LayerID) -> None:
        """Drop checkpoint state for a fully assembled layer."""
        for path in (self._part(layer_id), self._meta(layer_id)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def load(self) -> PartialState:
        """Restore all partial layers recorded in this directory."""
        state: PartialState = {}
        if not os.path.isdir(self.dir):
            return state
        for name in sorted(os.listdir(self.dir)):
            # Meta tmp files are per-writer named, so ones orphaned by a
            # crash never self-overwrite; load() runs before any journaler
            # exists, making this the one safe point to sweep them.
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.dir, name))
                except OSError:
                    pass
                continue
            if not name.endswith(".meta.json"):
                continue
            try:
                layer_id = int(name.split(".", 1)[0])
            except ValueError:
                log.warn("ignoring foreign file in checkpoint dir", file=name)
                continue
            try:
                with open(self._meta(layer_id)) as f:
                    meta = json.load(f)
                total = int(meta["Total"])
                covered = [(int(s), int(e)) for s, e in meta["Covered"]]
                frag_crcs = [(int(o), int(n), int(c))
                             for o, n, c in meta.get("FragCrcs") or []]
                with open(self._part(layer_id), "rb") as f:
                    buf = bytearray(total)
                    for s, e in covered:
                        f.seek(s)
                        chunk = f.read(e - s)
                        if len(chunk) != e - s and not frag_crcs:
                            # Truncated .part (disk full, partial copy):
                            # a short slice assignment would silently
                            # SHRINK the buffer — corrupt restore.  With
                            # CRCs the verify pass below demotes what
                            # the short read left unfilled to missing.
                            raise ValueError(
                                f"part file truncated: wanted [{s}, {e})"
                            )
                        buf[s:s + len(chunk)] = chunk
                if frag_crcs:
                    # Verify from the restored bytes — disk is read ONCE
                    # (physical-size resumes were paying a doubled read).
                    covered = self._verify_ranges(
                        layer_id, buf, covered, frag_crcs)
            except (OSError, ValueError, KeyError) as e:
                log.warn("dropping unreadable checkpoint", layer=layer_id,
                         err=repr(e))
                self.complete(layer_id)  # clear the corrupt pair
                continue
            state[layer_id] = (buf, covered, total)
            log.info("restored partial layer from checkpoint",
                     layer=layer_id, covered_bytes=intervals.covered(covered),
                     total=total)
        return state

    @staticmethod
    def _verify_ranges(layer_id, buf, covered, frag_crcs):
        """Resume verification: check every journaled fragment range's
        recorded crc32 against the restored bytes; the restored coverage
        is the journal's coverage INTERSECTED with the union of ranges
        that verified — tampered/rotted disk bytes fall back to
        "missing" (re-fetched by the resumed plan) instead of resuming
        as covered.  A range outside the filled coverage (torn meta,
        truncated ``.part``) hashes unfilled zeroes and so demotes the
        same way."""
        ok_union: List[Tuple[int, int]] = []
        bad = 0
        view = memoryview(buf)
        for off, n, crc in frag_crcs:
            if (off + n <= len(buf)
                    and integrity.fragment_crc(view[off:off + n]) == crc):
                ok_union = intervals.insert(ok_union, off, off + n)
            else:
                bad += 1
                log.error("checkpoint range failed CRC on resume; "
                          "re-opening it", layer=layer_id, offset=off,
                          size=n)
                trace.count("integrity.journal_bad_range")
                trace.count("integrity.journal_bad_bytes", n)
        verified = intervals.intersect(covered, ok_union)
        if bad:
            log.warn("journal resume dropped corrupt ranges",
                     layer=layer_id, bad_ranges=bad,
                     kept_bytes=intervals.covered(verified),
                     journaled_bytes=intervals.covered(covered))
        return verified


def map_through_gaps(
    gaps: List[Tuple[int, int]], offset: int, size: int
) -> List[Tuple[int, int]]:
    """Translate a job span over *remaining* bytes into real byte ranges.

    When a layer is partially delivered, the flow solver plans over its
    remaining size R; a per-sender job tiles ``[offset, offset+size)`` of
    that compacted space.  This maps the span back through the gap list
    (the uncovered ranges, in order) to absolute (offset, size) pairs —
    possibly several, when the span crosses a gap boundary.
    """
    out: List[Tuple[int, int]] = []
    pos = 0  # position in compacted remaining-space
    for s, e in gaps:
        glen = e - s
        lo = max(offset, pos)
        hi = min(offset + size, pos + glen)
        if lo < hi:
            out.append((s + (lo - pos), hi - lo))
        pos += glen
        if pos >= offset + size:
            break
    return out
