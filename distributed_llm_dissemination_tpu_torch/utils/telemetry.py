"""Run-scoped telemetry: the cluster's flight recorder (docs/observability.md).

Every perf and robustness bar so far was judged by reading process-local
sums at run end and guessing at cross-node attribution.  This module is
the one registry behind all of that accounting, with three properties the
old ``utils/trace.py`` globals lacked:

- **Run-scoped**: ``reset_run()`` clears everything (phases, counters,
  gauges, histograms, links), so back-to-back runs in one process —
  tests, a promoted standby, the future multi-job service — never
  inherit each other's totals.  ``snapshot()`` is a cheap consistent
  copy; a report is "the run so far", and deltas are snapshots diffed by
  the consumer.
- **Per-link flight recorder**: every (src, dest) node pair accumulates
  bytes, frames, stripe occupancy, CRC drops, NACKs, retransmit bytes,
  and stall attribution (wire-wait vs verify vs placement vs
  decode/stage seconds).  Writers are the transports (wire-level frames)
  and the receiver runtime (committed delivered bytes — the byte-exact
  number a run report reconciles against the goal state).
- **Always-on and cheap**: a dict update under one lock per frame-scale
  event (frames are MiB-scale, so the accounting is noise — measured in
  TTD_MATRIX.md's telemetry-overhead row).  ``DLD_TELEMETRY=0`` disables
  the LINK recorder and histograms (the overhead A/B knob); phase
  buckets and event counters stay on — pre-existing harness tables
  depend on them.

The registry feeds three consumers: ``MetricsReportMsg`` (periodic
node → leader shipping, ``runtime/receiver.MetricsReporter``), the
leader's cluster table (``runtime/leader.py``), and the one-command run
report (``cli/report.py``).
"""

from __future__ import annotations

import collections
import os
import secrets
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

# Process identity for snapshot folding: every snapshot carries this
# token, and ``fold_counters`` counts ONE snapshot per distinct token.
# Nodes sharing a process (podrun, the in-process harnesses, tests)
# share ONE registry, so their per-node reports are cumulative views of
# the SAME counters — summing them would multiply every cluster total
# by the co-resident node count.  One-process-per-node deployments get
# distinct tokens and the plain sum.
PROC_TOKEN = f"{os.getpid():x}-{secrets.token_hex(4)}"

# Fixed histogram bucket upper bounds, in milliseconds (the last bucket
# is unbounded).  Power-of-4 spacing spans one frame's syscall (~1 ms)
# to a wedged multi-minute stall in 9 buckets — coarse on purpose: the
# histograms attribute hangs to a phase, they don't profile kernels.
HIST_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0)

# Per-link field ownership: each field is written by exactly ONE end of
# the link (rx-ish fields by the dest's process, tx-ish by the src's),
# so the leader's cluster fold can union two nodes' reports of the same
# link without double-counting (runtime/leader.py, cli/report.py).
LINK_RX_FIELDS = frozenset((
    "rx_bytes", "rx_frames", "rx_stripe_frames", "rx_placed_frames",
    "delivered_bytes", "crc_drops", "crc_drop_bytes", "nacks",
    "wire_s", "verify_s", "place_s", "stage_s",
))
LINK_TX_FIELDS = frozenset((
    "tx_bytes", "tx_frames", "tx_stripe_frames",
    "retransmit_frames", "retransmit_bytes",
))
LINK_FIELDS = LINK_RX_FIELDS | LINK_TX_FIELDS


def _links_enabled() -> bool:
    """The always-on link recorder's kill switch (``DLD_TELEMETRY=0``) —
    exists for the overhead A/B row in TTD_MATRIX.md, read per call so
    tests can flip it without re-importing."""
    return os.environ.get("DLD_TELEMETRY", "1") != "0"


# ------------------------------------------------- pair lifecycle spans

# The causal span vocabulary (docs/observability.md): every delivery
# pair's lifecycle is a chain of these phases, recorded where each
# transition actually happens — ``planned``/``acked`` at the leader,
# ``dispatched`` at the sender, ``first_byte``/``wire_complete``/
# ``verified``/``staged`` at the dest, ``flipped`` at a swap/rollout
# replica.  ``utils/critical_path.py`` walks the chain; the tier-1
# static drift check pins each name to a live ``span_event`` call site,
# so a renamed phase can't silently vanish from the critical-path walk.
SPAN_PHASES: Tuple[str, ...] = (
    "planned", "dispatched", "first_byte", "wire_complete",
    "verified", "staged", "acked", "flipped")


def spans_enabled() -> bool:
    """Span recording's own kill switch (``DLD_SPANS=0`` — the overhead
    A/B knob) on top of the telemetry master switch: spans are part of
    the flight recorder, so ``DLD_TELEMETRY=0`` silences them too."""
    return (os.environ.get("DLD_SPANS", "1") != "0") and _links_enabled()


def span_ring_size() -> int:
    """Bounded span ring capacity per registry (``DLD_SPAN_RING``).
    Oldest events drop first — the honest limit docs/observability.md
    records; ``telemetry.spans_dropped`` counts every drop."""
    try:
        return max(64, int(os.environ.get("DLD_SPAN_RING", "4096")))
    except ValueError:
        return 4096


def span_id(dest, layer) -> str:
    """The deterministic span id of one delivery pair, ``"dest.layer"``.
    Every participant — the planning leader, the commanded sender, the
    receiving dest — can mint it from what it already knows, so span
    correlation works even when the advisory wire tag (``SpanId`` on
    LayerHeader/AckMsg) was dropped by a legacy peer.  Qualified pairs
    (shard/codec/version) share the pair's span and carry the
    qualifiers as event fields — one (dest, layer) is one delivery
    story."""
    return f"{int(dest)}.{int(layer)}"


class Telemetry:
    """One run's metric state.  All methods are thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        # name -> [sum_s, n]  (the trace.py phase buckets live here now)
        self._phases: Dict[str, list] = {}
        # name -> {"buckets": [..], "sum_ms": float, "n": int}
        self._hists: Dict[str, dict] = {}
        # (src, dest, job) -> {field: number}.  job "" is the base link
        # row (every field files there); a non-empty job ADDITIONALLY
        # files on its own row, so per-job splits are an additive view
        # of the base totals, never a replacement (docs/service.md).
        self._links: Dict[Tuple[int, int, str], Dict[str, float]] = {}
        # Pair-lifecycle span events (docs/observability.md): a bounded
        # ring of {"span", "phase", "t_ms", "node", ...} dicts.  Sized
        # lazily at first event so tests can flip DLD_SPAN_RING.
        self._spans: Optional[collections.deque] = None

    # ------------------------------------------------------------ scalars

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def add_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            rec = self._phases.get(name)
            if rec is None:
                rec = self._phases[name] = [0.0, 0]
            rec[0] += seconds
            rec[1] += 1

    def observe_ms(self, name: str, ms: float) -> None:
        """One fixed-bucket histogram sample (milliseconds)."""
        if not _links_enabled():
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = {
                    "buckets": [0] * (len(HIST_BUCKETS_MS) + 1),
                    "sum_ms": 0.0, "n": 0}
            idx = 0
            for idx, bound in enumerate(HIST_BUCKETS_MS):
                if ms <= bound:
                    break
            else:
                idx = len(HIST_BUCKETS_MS)
            h["buckets"][idx] += 1
            h["sum_ms"] += ms
            h["n"] += 1

    # -------------------------------------------------------------- spans

    def span_event(self, span: str, phase: str, node=None,
                   **fields) -> None:
        """Record one pair-lifecycle span transition (docs/
        observability.md).  ``span`` is the pair's span id
        (``span_id(dest, layer)`` — or a sub-leader fan-out child's);
        ``phase`` one of ``SPAN_PHASES``; ``node`` the seat where the
        transition happened; extra fields (src, dest, layer, job,
        bytes, codec, shard, version, parent) are attached verbatim.
        Bounded: the ring drops oldest (``telemetry.spans_dropped``
        counts), so a long service run degrades to a recent window
        instead of growing without bound."""
        if not spans_enabled():
            return
        ev = {"span": str(span), "phase": str(phase),
              "t_ms": round(_time.time() * 1000.0, 3)}
        if node is not None:
            ev["node"] = int(node)
        for k, v in fields.items():
            if v or v == 0 and k in ("src", "dest", "layer"):
                ev[k] = v
        with self._lock:
            ring = self._spans
            if ring is None:
                ring = self._spans = collections.deque(
                    maxlen=span_ring_size())
            if len(ring) == ring.maxlen:
                self._counters["telemetry.spans_dropped"] = (
                    self._counters.get("telemetry.spans_dropped", 0) + 1)
            ring.append(ev)

    def span_events(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in (self._spans or ())]

    # -------------------------------------------------------------- links

    def link_add(self, src, dest, job: str = "", **fields) -> None:
        """Accumulate numeric fields onto the (src, dest) link.  Unknown
        src/dest (a transport without a bound node id) records nothing —
        an unattributable byte is better dropped than misfiled.

        ``job``: the dissemination-job tag riding the frame
        (docs/service.md).  Tagged fields file on the BASE (src, dest)
        row as always — cluster totals and the byte-exact delivered
        reconciliation are unchanged — and additionally on the
        (src, dest, job) row, serialized ``"src->dest#job"`` in
        snapshots, so overlapping jobs' bytes split instead of pooling
        into one undifferentiated counter."""
        if src is None or dest is None or not _links_enabled():
            return
        keys = [(int(src), int(dest), "")]
        if job:
            keys.append((int(src), int(dest), str(job)))
        with self._lock:
            for key in keys:
                link = self._links.get(key)
                if link is None:
                    link = self._links[key] = {}
                for name, v in fields.items():
                    if v:
                        link[name] = link.get(name, 0) + v

    # ---------------------------------------------------------- snapshots

    def snapshot(self) -> dict:
        """A consistent copy of the run so far — JSON-ready (link keys
        serialized ``"src->dest"``, seconds rounded)."""
        with self._lock:
            return {
                "proc": PROC_TOKEN,
                "counters": dict(self._counters),
                "gauges": {k: round(v, 3)
                           for k, v in self._gauges.items()},
                "phases": {name: {"ms": round(s * 1000, 1), "n": n}
                           for name, (s, n) in sorted(self._phases.items())},
                "hists": {name: {"buckets": list(h["buckets"]),
                                 "sum_ms": round(h["sum_ms"], 1),
                                 "n": h["n"]}
                          for name, h in sorted(self._hists.items())},
                "links": {
                    (f"{s}->{d}#{j}" if j else f"{s}->{d}"): {
                        k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in sorted(fields.items())}
                    for (s, d, j), fields in sorted(self._links.items())
                },
                "spans": [dict(ev) for ev in (self._spans or ())],
            }

    def counter_totals(self) -> dict:
        with self._lock:
            return dict(sorted(self._counters.items()))

    def phase_totals(self) -> dict:
        with self._lock:
            return {name: {"ms": round(s * 1000, 1), "n": n}
                    for name, (s, n) in sorted(self._phases.items())}

    # -------------------------------------------------------------- reset

    def reset_run(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._phases.clear()
            self._hists.clear()
            self._links.clear()
            self._spans = None

    def reset_phases(self) -> None:
        with self._lock:
            self._phases.clear()

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()


# The process default registry.  One per process on purpose: a process
# IS a node, and run scoping comes from reset_run() between runs (the
# tests' autouse fixture, a harness's per-trial reset) — not from
# threading registries through every call site.
_default = Telemetry()


def default() -> Telemetry:
    return _default


def count(name: str, n: int = 1) -> None:
    _default.count(name, n)


def gauge(name: str, value: float) -> None:
    _default.gauge(name, value)


def add_phase(name: str, seconds: float) -> None:
    _default.add_phase(name, seconds)


def observe_ms(name: str, ms: float) -> None:
    _default.observe_ms(name, ms)


def link_add(src, dest, **fields) -> None:
    _default.link_add(src, dest, **fields)


def span_event(span: str, phase: str, node=None, **fields) -> None:
    _default.span_event(span, phase, node=node, **fields)


def span_events() -> List[dict]:
    return _default.span_events()


def snapshot() -> dict:
    return _default.snapshot()


def reset_run() -> None:
    _default.reset_run()


def enabled() -> bool:
    return _links_enabled()


# -------------------------------------------------- histogram analysis


def percentile_from_hist(hist: Optional[dict], q: float) -> Optional[float]:
    """Estimate the ``q``-quantile (0 < q <= 1) of a fixed-bucket
    histogram (``{"buckets": [...], "n": int}``) as the UPPER bound of
    the bucket where the cumulative count crosses ``q * n`` —
    deliberately conservative (never under-reports a latency), which is
    the right bias for an SLO guard (docs/rollout.md).  The last bucket
    is unbounded: a quantile landing there returns ``inf``.  Returns
    None for an empty/absent histogram (no samples = no verdict)."""
    if not hist:
        return None
    buckets = list(hist.get("buckets") or [])
    n = int(hist.get("n", 0)) or sum(int(b) for b in buckets)
    if n <= 0 or not buckets:
        return None
    want = q * n
    seen = 0
    for idx, count in enumerate(buckets):
        seen += int(count)
        if seen >= want:
            if idx < len(HIST_BUCKETS_MS):
                return float(HIST_BUCKETS_MS[idx])
            return float("inf")
    return float("inf")


def hist_delta(now: Optional[dict], base: Optional[dict]) -> dict:
    """Bucket-wise ``now - base`` of two cumulative fixed-bucket
    histograms — the soak-window view the SLO guard evaluates
    (docs/rollout.md).  A missing ``base`` means the window starts at
    zero; counts are floored at 0 so a registry reset mid-window reads
    as a fresh window, never a negative one."""
    now = now or {}
    base = base or {}
    nb = list(now.get("buckets") or [])
    bb = list(base.get("buckets") or [])
    bb += [0] * (len(nb) - len(bb))
    buckets = [max(0, int(a) - int(b)) for a, b in zip(nb, bb)]
    return {
        "buckets": buckets,
        "sum_ms": max(0.0, float(now.get("sum_ms", 0.0))
                      - float(base.get("sum_ms", 0.0))),
        "n": max(0, int(now.get("n", 0)) - int(base.get("n", 0))),
    }


# ------------------------------------------------------- cluster folding


def fold_links(reports: Dict[int, dict],
               local: Optional[dict] = None) -> Dict[str, dict]:
    """Merge per-node snapshots' link tables into one cluster view.

    Each (src, dest) link is reported by up to two nodes — the dest owns
    the rx-ish fields, the src the tx-ish fields (LINK_*_FIELDS) — so
    the fold takes each field from the endpoint that owns it; a field
    reported by a non-owner (shouldn't happen) is kept only when the
    owner never reported.  ``local``: the folding process's own
    snapshot, merged like any node's report."""
    out: Dict[str, dict] = {}

    def merge(node_id, snap) -> None:
        for key, fields in (snap.get("links") or {}).items():
            base, _, job = key.partition("#")
            try:
                src_s, dest_s = base.split("->", 1)
                src, dest = int(src_s), int(dest_s)
            except ValueError:
                continue
            row = out.setdefault(key, {"src": src, "dest": dest})
            if job:
                row["job"] = job
            for name, v in fields.items():
                owner = (dest if name in LINK_RX_FIELDS
                         else src if name in LINK_TX_FIELDS else None)
                if owner is None or owner == node_id or name not in row:
                    row[name] = v

    for node_id, snap in sorted(reports.items()):
        merge(node_id, snap)
    if local is not None:
        merge(None, local)  # owner unknown: fill gaps only
    return out


def _freshest_per_proc(reports: Dict[int, dict],
                       local: Optional[dict]) -> List[dict]:
    """The ONE snapshot per process token (``PROC_TOKEN``) every
    cluster fold dedups by: co-resident nodes report cumulative views
    of the same shared registry, so per process the FRESHEST snapshot
    wins (max ``t_wall_ms``; a ``local`` live read beats any shipped
    report from the same process).  Legacy reports without a token
    count per node, the pre-token behavior."""
    by_proc: Dict[object, dict] = {}

    def admit(key, snap, force=False):
        prior = by_proc.get(key)
        if (force or prior is None
                or snap.get("t_wall_ms", 0) >= prior.get("t_wall_ms", 0)):
            by_proc[key] = snap

    for node_id, snap in sorted(reports.items()):
        admit(snap.get("proc") or ("node", node_id), snap)
    if local is not None:
        admit(local.get("proc") or ("local",), local, force=True)
    return list(by_proc.values())


def fold_counters(reports: Dict[int, dict],
                  local: Optional[dict] = None) -> Dict[str, int]:
    """Sum event counters into cluster totals over one snapshot per
    process (``_freshest_per_proc`` — summing co-resident views would
    multiply every total by the node count)."""
    out: Dict[str, int] = {}
    for snap in _freshest_per_proc(reports, local):
        for name, v in (snap.get("counters") or {}).items():
            out[name] = out.get(name, 0) + int(v)
    return dict(sorted(out.items()))


def fold_spans(reports: Dict[int, dict],
               local: Optional[dict] = None) -> List[dict]:
    """Merge per-node snapshots' span-event rings into one cluster
    timeline over one snapshot per process (``_freshest_per_proc`` —
    co-resident nodes report the same shared ring, so concatenating
    them would duplicate every event).  Events sort by wall time;
    correlation across nodes is the span id itself
    (docs/observability.md)."""
    out: List[dict] = []
    for snap in _freshest_per_proc(reports, local):
        out.extend(dict(ev) for ev in (snap.get("spans") or ()))
    out.sort(key=lambda ev: ev.get("t_ms", 0.0))
    return out


# ---------------------------------------------- live fleet health timeline


def metrics_interval() -> float:
    """The MetricsReportMsg period (``DLD_METRICS_INTERVAL_S``, default
    2 s; 0 disables shipping) — the ONE parse the reporter thread and
    the health plane's in-flight age gate both read."""
    try:
        return float(os.environ.get("DLD_METRICS_INTERVAL_S", "2.0"))
    except ValueError:
        return 2.0


def straggler_threshold() -> float:
    """Achieved/modeled link-rate fraction below which a transferring
    link counts as straggling (``DLD_STRAGGLER_FRAC``)."""
    try:
        return float(os.environ.get("DLD_STRAGGLER_FRAC", "0.5"))
    except ValueError:
        return 0.5


def straggler_sustain() -> int:
    """Consecutive breaching metrics intervals before a straggler event
    fires (``DLD_STRAGGLER_N``; default 1 — onset within one
    interval)."""
    try:
        return max(1, int(os.environ.get("DLD_STRAGGLER_N", "1")))
    except ValueError:
        return 1


def health_ring_size() -> int:
    """Bounded interval-series / event ring capacity
    (``DLD_HEALTH_RING``); oldest drop first."""
    try:
        return max(16, int(os.environ.get("DLD_HEALTH_RING", "512")))
    except ValueError:
        return 512


class HealthTimeline:
    """The leader-side live fleet health derivation (docs/
    observability.md): per-interval DELTAS of each node's cumulative
    ``MetricsReportMsg`` snapshots, folded into a bounded ring of
    time-series — per-link throughput, stall split, NACK/CRC-drop rate,
    per-node serve p99 (the ``Hists`` of ``MetricsReportMsg``) — plus first-class STRAGGLER
    events: a link whose achieved rate sustains below
    ``straggler_threshold()`` × its modeled rate while a transfer is
    actually in flight is flagged with an onset timestamp, un-flagged
    when it recovers.  All methods thread-safe; state is plain dicts so
    it replicates through ``ControlDeltaMsg`` and a promoted standby
    keeps the picture."""

    def __init__(self):
        self._lock = threading.Lock()
        self._prev: Dict[int, dict] = {}       # node -> last snapshot
        self._series = collections.deque(maxlen=health_ring_size())
        self._events = collections.deque(maxlen=health_ring_size())
        self._breach: Dict[str, int] = {}      # link key -> consecutive
        self._flagged: Dict[str, float] = {}   # link key -> onset t_ms
        self._seen: set = set()                # ingest dedup keys

    # ------------------------------------------------------------ intake

    def observe(self, node_id: int, snap: dict,
                modeled_rate_fn=None, expected_srcs=()) -> List[dict]:
        """Fold one node's cumulative snapshot; returns NEW events.

        Links are scored from the DEST's report only (the rx-owner of
        ``delivered_bytes`` — co-resident registries would otherwise
        double-count) and only against base rows (per-job rows are an
        additive split).  ``modeled_rate_fn(src, dest)`` returns the
        modeled link rate in bytes/s, or 0 to skip scoring — the mode-3
        leader returns 0 for links with no in-flight pair, so a
        completed burst is never mis-read as a straggler.

        ``expected_srcs``: sources the caller KNOWS have in-flight
        pairs to this dest — a link so stalled its FIRST byte never
        landed has no snapshot row at all, and would otherwise be
        invisible to scoring (found hand-driving a whole-layer frame
        through a throttled link: the frame completes or nothing does).
        Absent rows for expected sources score as zero-rate
        intervals."""
        t_now = float(snap.get("t_wall_ms") or 0.0)
        new_events: List[dict] = []
        with self._lock:
            prev = self._prev.get(int(node_id))
            self._prev[int(node_id)] = snap
            if prev is None:
                return []
            dt = (t_now - float(prev.get("t_wall_ms") or 0.0)) / 1000.0
            if dt <= 0:
                return []
            links: Dict[str, dict] = {}

            def score(key, src, dest, rec, d_bytes):
                modeled = 0
                if modeled_rate_fn is not None:
                    try:
                        modeled = int(modeled_rate_fn(src, dest) or 0)
                    except Exception:  # noqa: BLE001 — advisory
                        modeled = 0
                if modeled <= 0:
                    # Unscored (no model, or nothing in flight any
                    # more): the breach streak AND the flag end here —
                    # a later transfer's breaches must not inherit this
                    # one's count, a flag held past its transfer would
                    # suppress the next transfer's straggler event, and
                    # a much-later recovery would carry a stale onset.
                    # The straggler event itself stays in the ring —
                    # that is the history; the flag is only "currently
                    # judged slow".
                    self._breach.pop(key, None)
                    self._flagged.pop(key, None)
                    return
                # Scored whenever a judged transfer is in flight —
                # INCLUDING a zero-delta interval: 0 B/s on a link the
                # model says should be moving is the worst straggler,
                # not an exempt one.
                frac = (d_bytes / dt) / modeled
                rec["modeled_bps"] = modeled
                rec["frac"] = round(frac, 4)
                if frac < straggler_threshold():
                    n = self._breach.get(key, 0) + 1
                    self._breach[key] = n
                    if (n >= straggler_sustain()
                            and key not in self._flagged):
                        ev = {"t_ms": round(t_now, 1),
                              "kind": "straggler_link",
                              "link": key, "src": src, "dest": dest,
                              "achieved_bps": rec["bps"],
                              "modeled_bps": modeled,
                              "frac": rec["frac"],
                              "intervals": n}
                        self._flagged[key] = ev["t_ms"]
                        self._events.append(ev)
                        new_events.append(dict(ev))
                else:
                    # Carry the recovered-from streak length and the
                    # measured ratio on the recovery event too, so
                    # policies (and RUN_REPORT readers) threshold on
                    # data, not just the event name (docs/autonomy.md).
                    streak = self._breach.pop(key, None) or 0
                    if key in self._flagged:
                        ev = {"t_ms": round(t_now, 1),
                              "kind": "link_recovered", "link": key,
                              "src": src, "dest": dest,
                              "achieved_bps": rec["bps"],
                              "modeled_bps": modeled,
                              "frac": rec["frac"],
                              "intervals": int(streak),
                              "onset_t_ms": self._flagged.pop(key)}
                        self._events.append(ev)
                        new_events.append(dict(ev))

            for key, row in (snap.get("links") or {}).items():
                base, _, job = key.partition("#")
                if job:
                    continue
                try:
                    src_s, dest_s = base.split("->", 1)
                    src, dest = int(src_s), int(dest_s)
                except ValueError:
                    continue
                if dest != int(node_id):
                    continue  # rx fields are owned by the dest's report
                prow = (prev.get("links") or {}).get(key) or {}

                def delta(name):
                    return max(0.0, float(row.get(name) or 0)
                               - float(prow.get(name) or 0))

                d_bytes = delta("delivered_bytes")
                rec = {"bps": round(d_bytes / dt, 1),
                       "delivered": int(d_bytes),
                       "nacks": int(delta("nacks")),
                       "crc_drops": int(delta("crc_drops")),
                       "wire_s": round(delta("wire_s"), 4),
                       "verify_s": round(delta("verify_s"), 4),
                       "place_s": round(delta("place_s"), 4)}
                links[key] = rec
                score(key, src, dest, rec, d_bytes)
            # Links the caller expects in flight but whose FIRST byte
            # never landed (no snapshot row): score them as zero-rate
            # intervals — the fully-dark link must be the first flag,
            # not the one blind spot.
            for src in expected_srcs or ():
                key = f"{int(src)}->{int(node_id)}"
                if key in links:
                    continue
                rec = {"bps": 0.0, "delivered": 0, "absent": True}
                links[key] = rec
                score(key, int(src), int(node_id), rec, 0.0)
            # Per-node serve p99 off the cumulative hists' window delta
            # (the rollout SLO plumbing, reused — docs/rollout.md).
            serve_p99 = None
            for name, h in (snap.get("hists") or {}).items():
                if not name.startswith("serve.latency_ms"):
                    continue
                d = hist_delta(h, (prev.get("hists") or {}).get(name))
                p99 = percentile_from_hist(d, 0.99)
                if p99 is not None:
                    serve_p99 = (p99 if serve_p99 is None
                                 else max(serve_p99, p99))
            interval = {"t_ms": round(t_now, 1), "node": int(node_id),
                        "dt_s": round(dt, 3), "links": links}
            if serve_p99 is not None:
                interval["serve_p99_ms"] = serve_p99
            self._series.append(interval)
        return new_events

    def ingest(self, events) -> List[dict]:
        """Adopt foreign events verbatim (a replicated shadow's ring at
        takeover, or an advisory ``MetricsReportMsg.health`` section),
        deduplicated by (t_ms, kind, link)."""
        fresh: List[dict] = []
        with self._lock:
            if len(self._seen) > 8 * health_ring_size():
                # Bound the dedup memory like every other health
                # structure; a cleared set only risks re-appending an
                # event already rotated out of the bounded ring.
                self._seen.clear()
            for ev in events or ():
                key = (ev.get("t_ms"), ev.get("kind"), ev.get("link"))
                if key in self._seen:
                    continue
                self._seen.add(key)
                self._events.append(dict(ev))
                link = str(ev.get("link") or "")
                if ev.get("kind") == "straggler_link" and link:
                    self._flagged.setdefault(link,
                                             float(ev.get("t_ms") or 0))
                elif ev.get("kind") == "link_recovered" and link:
                    # Replay the recovery too: an adopted ring whose
                    # link already healed must not stay marked flagged
                    # (a later healthy interval would emit a spurious
                    # duplicate recovery with the stale onset).
                    self._flagged.pop(link, None)
                fresh.append(dict(ev))
        return fresh

    # ----------------------------------------------------------- export

    def events(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in self._events]

    def snapshot(self, series_tail: int = 32) -> dict:
        """JSON-ready view: the full event ring + the series tail (the
        live ``-watch`` window; RUN_REPORT embeds the same shape)."""
        with self._lock:
            series = list(self._series)[-max(0, int(series_tail)):]
            return {"events": [dict(ev) for ev in self._events],
                    "intervals": [dict(iv) for iv in series],
                    "flagged": dict(self._flagged)}
