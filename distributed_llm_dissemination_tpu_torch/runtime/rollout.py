"""SLO-guarded fleet rollout pipeline (docs/rollout.md).

The zero-downtime swap (``runtime/swap.py``) flips a whole fleet at once — correct, but
the last place one bad checkpoint can take down every serving replica
simultaneously.  This module is the leader half of the staged
alternative: a ``kind="rollout"`` job expands into ORDERED WAVES
(canary → 1% → 25% → 100%), each wave a ``kind="swap"`` job over its
declared replica subset, chained so that

- the next wave's **dissemination overlaps** the current wave's serving
  and soak (the MPMD-pipeline pattern: the network never idles while
  the fleet soaks),
- a wave **commits** (flips its replicas to v2) only after the previous
  wave's soak verdict PASSED,
- after each wave's flip, an **SLO guard** evaluates the telemetry
  plane's per-replica p99 serve latency and failure counters over the
  soak window against the declared SLO — a breach auto-PAUSES the
  pipeline and rolls the breached wave BACK to v1 through the swap
  plane's first-class abort path (``SwapCommitMsg(abort, revert)``:
  the replicas restore their retained pre-flip tree), while earlier
  committed-and-finalized waves keep serving v2,
- a PASSED wave is **finalized** (``SwapCommitMsg(finalize)``): the
  replicas release the retained pre-flip tree — the rollback window is
  over.

A/B serving rides the existing version vocabulary: flipped waves serve
v2, unflipped waves serve v1, and the leader owns a **traffic-split
knob** (``split``: the fraction of eligible traffic a router should aim
at the v2 pool during soak) exposed — with the derived v1/v2 pools —
through ``RolloutCtlMsg`` and the rollout table.  The knob is
advisory-by-design: requests flow client → replica directly, so the
leader publishes routing intent rather than proxying bytes
(docs/rollout.md, honest limits).

Failover: every record mutation replicates (ControlDeltaMsg kind
``rollout`` + the snapshot's ``Rollouts`` section), so a promoted
standby resumes a half-finished rollout MID-WAVE: disseminating waves
ride the resumed job plane, committing waves ride the re-driven swap
fence, and a soaking wave re-baselines and re-soaks its FULL window at
the new leader (the guard stays armed; the cost is a longer soak, never
a skipped one).

Locking: ``RolloutDriver._lock`` is a LEAF lock — no leader method is
ever called while holding it (the leader's snapshot path acquires it
UNDER the leader lock, so the reverse order would deadlock)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..core.types import Assignment, LayerMeta
from ..utils import telemetry, trace
from ..utils.logging import log

# Wave lifecycle.
W_PENDING = "pending"            # declared, job not yet submitted
W_DISSEMINATING = "disseminating"  # swap job rolling (v2 on the wire)
W_STAGED = "staged"              # every replica staged+verified; held
W_COMMITTING = "committing"      # commit fence issued; flips in flight
W_SOAKING = "soaking"            # all replicas flipped; SLO window open
W_PASSED = "passed"              # verdict PASS; finalized (v1 released)
W_FAILED = "failed"              # SLO breach; rolled back to v1
W_ABORTED = "aborted"            # wave job degraded (crash mid-wave)

# Rollout lifecycle.
RUNNING = "running"
PAUSED = "paused"
DONE = "done"

_TERMINAL_WAVES = (W_PASSED, W_FAILED, W_ABORTED)

DEFAULT_SOAK_S = 2.0
DEFAULT_SPLIT = 0.5


def wave_version(version: str, wave: int) -> str:
    """The wave-qualified fence version: one swap record per wave, all
    delivering the same base ``version``'s bytes."""
    return f"{version}#w{wave}"


def base_version(version: str) -> str:
    return version.split("#", 1)[0]


def parse_slo(slo: Optional[dict]) -> dict:
    """Normalize a declared SLO.  ``p99_ms`` 0 disables the latency
    bar; ``max_failures`` is the count of errored answers a replica may
    produce inside one soak window (0 = any failure breaches);
    ``soak_s`` is the per-wave observation window.

    The guard reads p99 off fixed histogram bucket UPPER bounds
    (utils/telemetry.HIST_BUCKETS_MS), so a breach fires exactly when
    the true p99 exceeds the largest bucket bound <= the declared
    threshold — ``effective_p99_ms`` records that bound so the
    enforcement granularity is disclosed at admission and in every
    breach verdict instead of silently rounding the operator's number
    down (docs/rollout.md)."""
    slo = slo or {}

    def pick(*names, default=0.0):
        for n in names:
            if n in slo:
                return float(slo[n])
        return float(default)

    p99 = pick("P99Ms", "p99_ms")
    return {
        "p99_ms": p99,
        "effective_p99_ms": effective_p99_bound(p99),
        "max_failures": int(pick("MaxFailures", "max_failures")),
        "soak_s": pick("SoakS", "soak_s", default=DEFAULT_SOAK_S),
    }


def effective_p99_bound(p99_ms: float) -> float:
    """The largest histogram bucket bound <= the declared threshold:
    the latency the guard actually enforces at.  A threshold below the
    smallest bucket bound enforces at 0 (any sample breaches); 0 stays
    0 (latency bar disabled)."""
    if p99_ms <= 0:
        return 0.0
    return max((b for b in telemetry.HIST_BUCKETS_MS if b <= p99_ms),
               default=0.0)


def serve_view(metrics_row: Optional[dict], node: int) -> dict:
    """Extract one replica's cumulative serve telemetry from its
    metrics snapshot: the per-node latency histogram + request/failure
    counters (utils/telemetry.py vocabulary, stamped per node id
    because co-resident nodes share a registry)."""
    snap = metrics_row or {}
    counters = snap.get("counters") or {}
    return {
        "hist": dict((snap.get("hists") or {}).get(
            f"serve.latency_ms.n{node}") or {}),
        "requests": int(counters.get(f"serve.requests.n{node}", 0)),
        "failures": int(counters.get(f"serve.failures.n{node}", 0)),
    }


def slo_verdict(base: dict, now: dict, slo: dict) -> dict:
    """One replica's soak-window verdict: the cumulative views diffed,
    p99 read conservatively off the bucket bounds.  A window with no
    samples is ``no_data`` — recorded loudly, counted as pass (the
    guard must not wedge a rollout on lost telemetry; docs/rollout.md
    owns the limit)."""
    delta = telemetry.hist_delta(now.get("hist"), base.get("hist"))
    p99 = telemetry.percentile_from_hist(delta, 0.99)
    failures = max(0, now.get("failures", 0) - base.get("failures", 0))
    requests = max(0, now.get("requests", 0) - base.get("requests", 0))
    out = {"requests": requests, "failures": failures,
           "p99_ms": (round(p99, 1) if p99 not in (None, float("inf"))
                      else p99)}
    if requests <= 0 and p99 is None:
        out["verdict"] = "no_data"
        return out
    breaches = []
    if slo["p99_ms"] > 0 and p99 is not None and p99 > slo["p99_ms"]:
        eff = slo.get("effective_p99_ms", slo["p99_ms"])
        breaches.append(
            f"p99 {p99}ms > {slo['p99_ms']}ms"
            + (f" (enforced at bucket bound {eff}ms)"
               if eff != slo["p99_ms"] else ""))
    if failures > slo["max_failures"]:
        breaches.append(f"failures {failures} > {slo['max_failures']}")
    out["verdict"] = "breach" if breaches else "pass"
    if breaches:
        out["breaches"] = breaches
    return out


class RolloutDriver:
    """The leader's rollout-pipeline state machine.  All mutation goes
    through leader-thread callbacks (job completion, fence confirms,
    soak timers); the records replicate on every transition."""

    def __init__(self, leader):
        self.leader = leader
        self._lock = threading.Lock()  # LEAF lock: no leader calls under it
        self._recs: Dict[str, dict] = {}
        self._by_wave_version: Dict[str, tuple] = {}  # wv -> (rid, idx)
        # Leader-local soak bookkeeping (never replicated: a promoted
        # leader re-baselines and re-soaks).
        self._baselines: Dict[tuple, Dict[int, dict]] = {}
        self._soak_tokens: Dict[tuple, int] = {}

    # ------------------------------------------------------------ admission

    def admit(self, rollout_id: str, assignment: Assignment,
              waves: Optional[List[List[int]]], version: str,
              swap_base: int, priority: int = 0,
              digests: Optional[dict] = None, slo: Optional[dict] = None,
              split: float = -1.0) -> dict:
        """Expand one ``kind="rollout"`` submission into its wave plan
        and start wave 0's dissemination.  Idempotent per rollout id.
        Raises ValueError on an unusable declaration — the submit
        handler answers the error (the serving invariant)."""
        if not version:
            raise ValueError("a rollout needs a Version")
        if swap_base < 0:
            raise ValueError("a rollout needs a SwapBase")
        dests = sorted(int(d) for d in assignment)
        if not dests:
            raise ValueError("a rollout needs a non-empty Assignment")
        if waves:
            waves = [sorted(int(n) for n in w) for w in waves if w]
            named = [n for w in waves for n in w]
            if len(named) != len(set(named)):
                raise ValueError("rollout waves must be disjoint")
            unknown = set(named) - set(dests)
            if unknown:
                raise ValueError(
                    f"rollout waves name non-assignment replicas: "
                    f"{sorted(unknown)}")
            missing = set(dests) - set(named)
            if missing:
                # Unwaved assignees ride one trailing wave: every
                # declared dest ends up covered, canary-first.
                waves = waves + [sorted(missing)]
        else:
            # Default plan: one replica per wave, canary-style.
            waves = [[d] for d in dests]
        layer_ids = sorted({int(lid) for row in assignment.values()
                            for lid in row})
        if not layer_ids:
            raise ValueError("a rollout needs target layers")
        with self._lock:
            prior = self._recs.get(rollout_id)
            if prior is not None:
                return self._summary_locked(rollout_id)
            # A version's wave fence names (v#wN) are the swap plane's
            # identity: two rollouts sharing one would cross-wire each
            # other's flip confirms and verdicts.  One rollout per
            # version, ever — a retry rides resume(), not a re-submit.
            for rid2, r2 in self._recs.items():
                if r2["version"] == version:
                    raise ValueError(
                        f"version {version!r} is already claimed by "
                        f"rollout {rid2!r}; pick a new version name")
            rec = {
                "rollout_id": str(rollout_id),
                "version": str(version),
                "swap_base": int(swap_base),
                "priority": int(priority),
                "digests": {int(l): str(d)
                            for l, d in (digests or {}).items()},
                "layer_ids": layer_ids,
                "waves": waves,
                "wave_states": [W_PENDING] * len(waves),
                "retries": [0] * len(waves),
                "state": RUNNING,
                "paused_reason": "",
                # An EXPLICIT 0.0 is honored (no eligible v2 traffic
                # during soak); only the -1 unset sentinel defaults.
                "split": float(split) if split >= 0 else DEFAULT_SPLIT,
                "slo": parse_slo(slo),
                "verdicts": {},
                "admit_ms": time.time() * 1000.0,
            }
            self._recs[rollout_id] = rec
            for i in range(len(waves)):
                self._by_wave_version[wave_version(version, i)] = (
                    rollout_id, i)
        trace.count("rollout.admitted")
        log.info("rollout admitted: staged waves armed",
                 rollout=rollout_id, version=version,
                 waves=waves, slo=rec["slo"], split=rec["split"])
        if rec["slo"]["p99_ms"] > 0 and (rec["slo"]["effective_p99_ms"]
                                         != rec["slo"]["p99_ms"]):
            log.warn("declared p99 threshold is not a histogram bucket "
                     "bound; the guard enforces at the bound below it",
                     rollout=rollout_id,
                     declared_p99_ms=rec["slo"]["p99_ms"],
                     effective_p99_ms=rec["slo"]["effective_p99_ms"])
        self._replicate(rollout_id)
        self._submit_wave(rollout_id, 0)
        return self.summary(rollout_id)

    # --------------------------------------------------------- wave driving

    def _submit_wave(self, rid: str, idx: int) -> None:
        """Submit wave ``idx``'s swap job (dissemination starts; the
        commit is HELD until the pipeline releases it)."""
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None or idx >= len(rec["waves"]):
                return
            if rec["wave_states"][idx] not in (W_PENDING, W_FAILED,
                                               W_ABORTED):
                return
            retry = rec["retries"][idx]
            rec["wave_states"][idx] = W_DISSEMINATING
            wv = wave_version(rec["version"], idx)
            dests = list(rec["waves"][idx])
            target = {d: {lid: LayerMeta() for lid in rec["layer_ids"]}
                      for d in dests}
            jid = (f"{rid}:w{idx}" if retry == 0
                   else f"{rid}:w{idx}.r{retry}")
            priority = rec["priority"]
            digests = dict(rec["digests"])
            swap_base = rec["swap_base"]
        trace.count("rollout.wave_submitted")
        log.info("rollout wave disseminating", rollout=rid, wave=idx,
                 job=jid, dests=dests)
        self._replicate(rid)
        # The hold marker tells _register_swap this swap's commit
        # belongs to the pipeline, not the job-completion path.
        self.leader._swap_holds[wv] = rid
        self.leader.submit_job(jid, target, priority=priority,
                               kind="swap", digests=digests,
                               version=wv, swap_base=swap_base)

    def on_wave_staged(self, wv: str) -> None:
        """A wave's swap job completed cleanly (every replica staged +
        verified, zero drops): commit it if the pipeline says it is
        this wave's turn, else hold."""
        with self._lock:
            key = self._by_wave_version.get(wv)
            if key is None:
                return
            rid, idx = key
            rec = self._recs.get(rid)
            if rec is None:
                return
            if rec["wave_states"][idx] == W_DISSEMINATING:
                rec["wave_states"][idx] = W_STAGED
            commit = self._should_commit_locked(rec, idx)
            if commit:
                rec["wave_states"][idx] = W_COMMITTING
        log.info("rollout wave staged on every replica", rollout=rid,
                 wave=idx, committing=commit)
        self._replicate(rid)
        if commit:
            self._commit_wave(rid, idx)

    def _should_commit_locked(self, rec: dict, idx: int) -> bool:
        if rec["state"] != RUNNING:
            return False
        if rec["wave_states"][idx] not in (W_STAGED,):
            return False
        return idx == 0 or rec["wave_states"][idx - 1] == W_PASSED

    def _commit_wave(self, rid: str, idx: int) -> None:
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return
            if (rec["state"] != RUNNING
                    or rec["wave_states"][idx] != W_COMMITTING):
                # A pause (operator or breach) landed between the
                # caller's locked check and here: flipping now would
                # commit a wave AFTER the operator was told no further
                # waves commit.  Back to held-staged — the next resume
                # re-commits it through _should_commit_locked.
                if rec["wave_states"][idx] == W_COMMITTING:
                    rec["wave_states"][idx] = W_STAGED
                paused = True
            else:
                paused = False
            wv = wave_version(rec["version"], idx)
            nxt = idx + 1 if idx + 1 < len(rec["waves"]) else None
            if nxt is not None and rec["wave_states"][nxt] != W_PENDING:
                nxt = None
        if paused:
            log.warn("rollout wave commit withheld: pipeline paused "
                     "under the fence; wave back to held-staged",
                     rollout=rid, wave=idx)
            self._replicate(rid)
            return
        trace.count("rollout.wave_committed")
        log.info("rollout wave committing: flip fence issued",
                 rollout=rid, wave=idx)
        self.leader._commit_swap(wv)
        # Pipeline overlap (the MPMD pattern): the NEXT wave's
        # dissemination starts the moment this wave's commit is on the
        # wire — v2 bytes move while this wave flips and soaks.
        if nxt is not None:
            self._submit_wave(rid, nxt)

    def on_wave_flipped(self, wv: str) -> None:
        """Every replica of a committed wave confirmed its flip: open
        the SLO soak window."""
        with self._lock:
            key = self._by_wave_version.get(wv)
            if key is None:
                return
            rid, idx = key
            rec = self._recs.get(rid)
            if rec is None or rec["wave_states"][idx] != W_COMMITTING:
                return
            rec["wave_states"][idx] = W_SOAKING
            soak_s = rec["slo"]["soak_s"]
            dests = list(rec["waves"][idx])
            token = self._soak_tokens.get((rid, idx), 0) + 1
            self._soak_tokens[(rid, idx)] = token
        log.info("rollout wave flipped fleet-wide; soak window open",
                 rollout=rid, wave=idx, soak_s=soak_s)
        self._replicate(rid)
        self._baseline_wave(rid, idx, dests)
        timer = threading.Timer(soak_s, self._evaluate,
                                args=(rid, idx, token))
        timer.daemon = True
        timer.start()

    def _metrics_row(self, node: int) -> dict:
        with self.leader._lock:
            return dict(self.leader.cluster_metrics.get(node) or {})

    def _quarantined(self) -> set:
        """The policy engine's serve-rotation mask (docs/autonomy.md);
        empty when no engine is armed (or on a pre-policy leader)."""
        getter = getattr(self.leader, "serve_quarantined", None)
        return set(getter()) if getter is not None else set()

    def _baseline_wave(self, rid: str, idx: int, dests) -> None:
        # A quarantined replica's latency is exactly what the policy
        # engine flagged — baselining on it would poison the SLO
        # verdicts for the whole wave (docs/autonomy.md).
        quarantined = self._quarantined()
        views = {d: serve_view(self._metrics_row(d), d) for d in dests
                 if d not in quarantined}
        with self._lock:
            self._baselines[(rid, idx)] = views

    # ------------------------------------------------------------ SLO guard

    def _evaluate(self, rid: str, idx: int, token: int) -> None:
        """The soak window closed: per-replica verdicts against the
        declared SLO.  PASS finalizes the wave and advances the
        pipeline; BREACH pauses the pipeline and rolls the wave back."""
        if self.leader._closed():
            return
        # Freshness: wait for one report round RECEIVED AFTER the soak
        # window closed, so the verdict sees the window's tail instead
        # of a snapshot that predates it (a stale view would read as
        # no_data and silently pass a breaching wave).  Bounded: a dead
        # reporter degrades this to a loud best-effort, never a wedge.
        try:
            self.leader.await_metrics(newer_than=time.monotonic(),
                                      timeout=3.0)
        except Exception:  # noqa: BLE001 — advisory freshness only
            pass
        with self._lock:
            rec = self._recs.get(rid)
            if (rec is None or rec["wave_states"][idx] != W_SOAKING
                    or self._soak_tokens.get((rid, idx)) != token):
                return
            dests = list(rec["waves"][idx])
            slo = dict(rec["slo"])
            baseline = self._baselines.get((rid, idx)) or {}
        # Quarantined replicas get no verdict: the policy engine
        # already flagged them, and counting their latency here would
        # conflate "this WAVE regressed" with "this REPLICA is sick"
        # (docs/autonomy.md).
        quarantined = self._quarantined()
        dests = [d for d in dests if d not in quarantined]
        replicas = {}
        breached = []
        for d in dests:
            v = slo_verdict(baseline.get(d) or {},
                            serve_view(self._metrics_row(d), d), slo)
            replicas[d] = v
            if v["verdict"] == "breach":
                breached.append(d)
        verdict = {
            "wave": idx,
            "verdict": "breach" if breached else "pass",
            "replicas": {str(d): v for d, v in replicas.items()},
            "t_ms": time.time() * 1000.0,
        }
        if any(v["verdict"] == "no_data" for v in replicas.values()):
            verdict["no_data"] = sorted(
                d for d, v in replicas.items()
                if v["verdict"] == "no_data")
            log.warn("SLO guard saw no serve traffic on some replicas "
                     "this soak window; counted as pass, recorded",
                     rollout=rid, wave=idx, replicas=verdict["no_data"])
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None or rec["wave_states"][idx] != W_SOAKING:
                return
            rec["verdicts"][str(idx)] = verdict
            if breached:
                rec["wave_states"][idx] = W_FAILED
                rec["state"] = PAUSED
                rec["paused_reason"] = (
                    f"wave {idx} SLO breach on replicas {breached}")
                wv = wave_version(rec["version"], idx)
            else:
                rec["wave_states"][idx] = W_PASSED
        if breached:
            trace.count("rollout.slo_breach")
            trace.count("rollout.paused")
            log.error("rollout wave BREACHED its SLO: pipeline paused, "
                      "wave rolling back to the pre-flip version",
                      rollout=rid, wave=idx, replicas=breached,
                      verdict=verdict["replicas"])
            self._replicate(rid)
            # First-class rollback through the swap abort path: the
            # replicas restore their retained pre-flip tree.
            self.leader._abort_swap(
                wv, f"rollout {rid} wave {idx} SLO breach",
                revert=True)
            return
        trace.count("rollout.wave_passed")
        log.info("rollout wave passed its SLO soak; finalizing",
                 rollout=rid, wave=idx, verdict=verdict["replicas"])
        self._replicate(rid)
        self._finalize_wave(rid, idx)
        self._advance(rid, idx)

    def _finalize_wave(self, rid: str, idx: int) -> None:
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return
            wv = wave_version(rec["version"], idx)
        self.leader._swap_send_round(wv, finalize=True)

    def _advance(self, rid: str, idx: int) -> None:
        """Wave ``idx`` passed: release the next wave's hold (commit it
        if already staged; submit it if it never started), or complete
        the rollout."""
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None or rec["state"] not in (RUNNING, PAUSED):
                return
            nxt = idx + 1
            if nxt >= len(rec["waves"]):
                # The terminal edge runs even PAUSED: completion
                # commits nothing, and without it a rollout whose last
                # wave passed mid-pause would report "running" forever
                # (resume would find no wave left to drive).
                rec["state"] = DONE
                done = True
                action = None
            elif rec["state"] != RUNNING:
                return  # paused: no further waves commit or submit
            else:
                done = False
                st = rec["wave_states"][nxt]
                if st == W_STAGED:
                    rec["wave_states"][nxt] = W_COMMITTING
                    action = "commit"
                elif st == W_PENDING:
                    action = "submit"
                elif st in (W_FAILED, W_ABORTED):
                    # The next wave died while THIS one was still
                    # soaking (its dissemination overlapped); this
                    # pass is the pipeline's hand-off, so retry it
                    # here — nothing later would.
                    rec["retries"][nxt] += 1
                    rec["wave_states"][nxt] = W_PENDING
                    action = "submit"
                else:
                    action = None  # disseminating: commits when staged
        if done:
            trace.count("rollout.done")
            log.info("rollout complete: every wave serving the new "
                     "version", rollout=rid)
            self._prune_done(rid)
            self._replicate(rid)
            return
        self._replicate(rid)
        if action == "commit":
            self._commit_wave(rid, nxt)
        elif action == "submit":
            self._submit_wave(rid, nxt)

    def _prune_done(self, rid: str) -> None:
        """A rollout reached DONE: release its per-wave pipeline
        bookkeeping.  The hold markers especially must not outlive the
        pipeline — a later plain swap whose version happens to collide
        with a wave fence key would otherwise register HELD and never
        flip.  The record itself stays for ``-rollouts`` history."""
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return
            for i in range(len(rec["waves"])):
                wv = wave_version(rec["version"], i)
                self.leader._swap_holds.pop(wv, None)
                self._baselines.pop((rid, i), None)
                self._soak_tokens.pop((rid, i), None)

    def on_replica_crashed(self, node: int) -> None:
        """A serving replica died while its wave was mid-flip or
        SOAKING.  Without this hook the dead replica's empty soak
        window reads ``no_data`` → pass, and the pipeline ships the
        very v2 that may have killed it fleet-wide — a canary that
        CRASHES is the strongest possible breach.  The wave fails, the
        pipeline pauses, and the surviving wave replicas revert to
        their retained pre-flip tree."""
        actions = []
        with self._lock:
            for rid in sorted(self._recs):
                rec = self._recs[rid]
                for idx, dests in enumerate(rec["waves"]):
                    if (node not in dests
                            or rec["wave_states"][idx]
                            not in (W_COMMITTING, W_SOAKING)):
                        continue
                    rec["wave_states"][idx] = W_FAILED
                    if rec["state"] == RUNNING:
                        rec["state"] = PAUSED
                    rec["paused_reason"] = (
                        f"wave {idx} replica {node} crashed mid-wave")
                    actions.append(
                        (rid, idx, wave_version(rec["version"], idx)))
        for rid, idx, wv in actions:
            trace.count("rollout.replica_crashed")
            trace.count("rollout.paused")
            log.error("rollout wave replica CRASHED mid-flip/soak; "
                      "pipeline paused, survivors reverting",
                      rollout=rid, wave=idx, replica=node)
            self._replicate(rid)
            self.leader._abort_swap(
                wv, f"rollout {rid} wave {idx}: replica {node} "
                "crashed", revert=True)

    def on_wave_aborted(self, wv: str, reason: str) -> None:
        """A wave's swap aborted outside the guard's own rollback (a
        replica crashed mid-wave, a staging digest gave up): the wave
        is failed and the pipeline pauses — operator resume retries."""
        with self._lock:
            key = self._by_wave_version.get(wv)
            if key is None:
                return
            rid, idx = key
            rec = self._recs.get(rid)
            if rec is None:
                return
            if rec["wave_states"][idx] in (W_FAILED, W_ABORTED):
                return  # the guard's own rollback already recorded it
            rec["wave_states"][idx] = W_ABORTED
            if rec["state"] == RUNNING:
                rec["state"] = PAUSED
                rec["paused_reason"] = (
                    f"wave {idx} aborted: {reason}")
        trace.count("rollout.wave_aborted")
        trace.count("rollout.paused")
        log.error("rollout wave aborted; pipeline paused",
                  rollout=rid, wave=idx, reason=reason)
        self._replicate(rid)

    # ------------------------------------------------------- operator verbs

    def pause(self, rid: str) -> str:
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return f"unknown rollout {rid!r}"
            if rec["state"] == DONE:
                return f"rollout {rid!r} already complete"
            rec["state"] = PAUSED
            rec["paused_reason"] = "operator pause"
        trace.count("rollout.paused")
        log.warn("rollout paused by operator", rollout=rid)
        self._replicate(rid)
        return ""

    def resume(self, rid: str) -> str:
        """Re-arm a paused pipeline.  A failed/aborted wave is
        re-submitted as a retry job (the swap plane's retry-after-abort
        path redelivers the released v2 set); a held staged wave whose
        predecessor passed commits."""
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return f"unknown rollout {rid!r}"
            if rec["state"] != PAUSED:
                return f"rollout {rid!r} is not paused ({rec['state']})"
            rec["state"] = RUNNING
            rec["paused_reason"] = ""
            actions = []
            for i, st in enumerate(rec["wave_states"]):
                if st in (W_FAILED, W_ABORTED):
                    rec["retries"][i] += 1
                    rec["wave_states"][i] = W_PENDING
                    actions.append(("submit", i))
                    break
                if st == W_STAGED and self._should_commit_locked(rec, i):
                    rec["wave_states"][i] = W_COMMITTING
                    actions.append(("commit", i))
                    break
                if st == W_PENDING:
                    if i == 0 or rec["wave_states"][i - 1] == W_PASSED:
                        actions.append(("submit", i))
                    break
            if not actions and all(st == W_PASSED
                                   for st in rec["wave_states"]):
                # Every wave passed while the pipeline sat paused (the
                # last soak's verdict landed post-pause): the rollout
                # is COMPLETE, not "running" with nothing to drive it.
                rec["state"] = DONE
                completed = True
            else:
                completed = False
        if completed:
            trace.count("rollout.done")
            log.info("rollout resumed into completion: every wave "
                     "already passed", rollout=rid)
            self._prune_done(rid)
            self._replicate(rid)
            return ""
        trace.count("rollout.resumed")
        log.info("rollout resumed by operator", rollout=rid,
                 actions=actions)
        self._replicate(rid)
        for verb, i in actions:
            if verb == "submit":
                self._submit_wave(rid, i)
            else:
                self._commit_wave(rid, i)
        return ""

    def set_split(self, rid: str, split: float) -> str:
        if not 0.0 <= split <= 1.0:
            return f"split must be in [0, 1], got {split}"
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return f"unknown rollout {rid!r}"
            rec["split"] = float(split)
        log.info("rollout traffic split set", rollout=rid, split=split)
        self._replicate(rid)
        return ""

    # ------------------------------------------------------------- queries

    def _traffic_locked(self, rec: dict) -> dict:
        """The A/B pools the split knob routes between: replicas of
        flipped waves serve v2, everyone else v1 (a FAILED wave rolled
        back, so its replicas are v1 again).  Policy-quarantined
        replicas (docs/autonomy.md) are masked OUT of both pools and
        surfaced under their own key — traffic routes around a
        breacher, operators still see it."""
        quarantined = self._quarantined()
        v2 = []
        v1 = []
        for i, dests in enumerate(rec["waves"]):
            st = rec["wave_states"][i]
            pool = v2 if st in (W_COMMITTING, W_SOAKING, W_PASSED) else v1
            pool.extend(d for d in dests if d not in quarantined)
        return {"split": rec["split"], "v2": sorted(v2), "v1": sorted(v1),
                "quarantined": sorted(quarantined)}

    def _summary_locked(self, rid: str) -> dict:
        rec = self._recs[rid]
        return {
            "RolloutID": rec["rollout_id"],
            "Version": rec["version"],
            "State": rec["state"],
            "PausedReason": rec["paused_reason"],
            "Waves": [list(w) for w in rec["waves"]],
            "WaveStates": list(rec["wave_states"]),
            "Wave": self._current_wave_locked(rec),
            "Split": rec["split"],
            "SLO": dict(rec["slo"]),
            "Verdicts": {k: dict(v) for k, v in rec["verdicts"].items()},
            "Traffic": self._traffic_locked(rec),
        }

    @staticmethod
    def _current_wave_locked(rec: dict) -> int:
        """The frontier wave index: the first wave not yet terminal
        (== len(waves) when every wave passed)."""
        for i, st in enumerate(rec["wave_states"]):
            if st != W_PASSED:
                return i
        return len(rec["waves"])

    def summary(self, rid: str) -> dict:
        with self._lock:
            if rid not in self._recs:
                return {}
            return self._summary_locked(rid)

    def table(self) -> Dict[str, dict]:
        with self._lock:
            return {rid: self._summary_locked(rid)
                    for rid in sorted(self._recs)}

    def traffic_table(self, rid: str) -> dict:
        with self._lock:
            rec = self._recs.get(rid)
            return self._traffic_locked(rec) if rec is not None else {}

    # ---------------------------------------------------------- replication

    def record_json(self, rid: str) -> dict:
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return {}
            return {
                "RolloutID": rec["rollout_id"],
                "Version": rec["version"],
                "SwapBase": rec["swap_base"],
                "Priority": rec["priority"],
                "Digests": {str(l): d
                            for l, d in rec["digests"].items()},
                "LayerIDs": list(rec["layer_ids"]),
                "Waves": [list(w) for w in rec["waves"]],
                "WaveStates": list(rec["wave_states"]),
                "Retries": list(rec["retries"]),
                "State": rec["state"],
                "PausedReason": rec["paused_reason"],
                "Split": rec["split"],
                "SLO": dict(rec["slo"]),
                "Verdicts": {k: dict(v)
                             for k, v in rec["verdicts"].items()},
                "AdmitMs": rec["admit_ms"],
            }

    def _replicate(self, rid: str) -> None:
        data = self.record_json(rid)
        if data:
            self.leader._replicate("rollout", **data)

    def to_json(self) -> Dict[str, dict]:
        with self._lock:
            rids = sorted(self._recs)
        return {rid: self.record_json(rid) for rid in rids}

    def load(self, records: Dict[str, dict]) -> None:
        """Restore replicated records (takeover).  Malformed records
        are skipped loudly — one corrupt delta must not sink the other
        rollouts' recovery."""
        for rid, data in sorted((records or {}).items()):
            try:
                waves = [[int(n) for n in w]
                         for w in data.get("Waves") or []]
                rec = {
                    "rollout_id": str(data.get("RolloutID", rid)),
                    "version": str(data["Version"]),
                    "swap_base": int(data.get("SwapBase", -1)),
                    "priority": int(data.get("Priority", 0)),
                    "digests": {int(l): str(d) for l, d in
                                (data.get("Digests") or {}).items()},
                    "layer_ids": [int(l)
                                  for l in data.get("LayerIDs") or []],
                    "waves": waves,
                    "wave_states": [
                        str(s) for s in data.get("WaveStates") or []]
                    or [W_PENDING] * len(waves),
                    "retries": [int(r) for r in data.get("Retries") or []]
                    or [0] * len(waves),
                    "state": str(data.get("State", RUNNING)),
                    "paused_reason": str(data.get("PausedReason", "")),
                    "split": float(data.get("Split", DEFAULT_SPLIT)),
                    "slo": parse_slo(data.get("SLO")),
                    "verdicts": {str(k): dict(v) for k, v in
                                 (data.get("Verdicts") or {}).items()},
                    "admit_ms": float(data.get("AdmitMs", 0.0)),
                }
            except (KeyError, ValueError, TypeError) as e:
                log.error("unloadable replicated rollout record; "
                          "skipped", rollout=rid, err=repr(e))
                continue
            with self._lock:
                self._recs[rec["rollout_id"]] = rec
                for i in range(len(rec["waves"])):
                    wv = wave_version(rec["version"], i)
                    self._by_wave_version[wv] = (rec["rollout_id"], i)
            # The hold markers must survive the takeover: a retry
            # re-submission of any wave must register HELD.  A DONE
            # rollout's were pruned at completion — keep them pruned.
            if rec["state"] != DONE:
                for i in range(len(rec["waves"])):
                    self.leader._swap_holds[
                        wave_version(rec["version"], i)] = rec["rollout_id"]

    def resume_all(self) -> None:
        """Takeover re-drive (docs/rollout.md): pick every adopted
        rollout up MID-WAVE.  Disseminating waves ride the resumed job
        plane; a committing wave's fence was re-driven by
        ``_resume_swaps`` (confirms will open the soak); a SOAKING wave
        re-baselines and re-soaks its full window HERE — the guard
        stays armed across the takeover."""
        with self._lock:
            rids = sorted(self._recs)
        for rid in rids:
            actions = []
            with self._lock:
                rec = self._recs[rid]
                if rec["state"] not in (RUNNING,):
                    continue
                for i, st in enumerate(rec["wave_states"]):
                    if st in (W_SOAKING, W_COMMITTING):
                        # Reopen the window: flip-confirm state was
                        # adopted, but the old leader's baseline died
                        # with it.  Full re-soak, never a skipped one.
                        rec["wave_states"][i] = W_COMMITTING
                        actions.append(("resoak", i))
                    elif st == W_STAGED and self._should_commit_locked(
                            rec, i):
                        rec["wave_states"][i] = W_COMMITTING
                        actions.append(("commit", i))
                    elif st == W_PENDING and (
                            i == 0 or rec["wave_states"][i - 1]
                            == W_PASSED):
                        actions.append(("submit", i))
                        break
            for verb, i in actions:
                log.info("resuming adopted rollout mid-wave",
                         rollout=rid, wave=i, action=verb)
                if verb == "submit":
                    self._submit_wave(rid, i)
                elif verb == "commit":
                    self._commit_wave(rid, i)
                else:  # resoak: the committed fence re-send is already
                    # on the wire (_resume_swaps); when every replica
                    # re-confirms, on_wave_flipped reopens the window.
                    with self._lock:
                        rec = self._recs.get(rid)
                        if rec is None:
                            continue
                        wv = wave_version(rec["version"], i)
                    # A fully-confirmed adopted fence re-sends to no
                    # one (everyone confirmed pre-kill): synthesize the
                    # flip edge so the soak reopens regardless.
                    with self.leader._lock:
                        srec = self.leader._swaps.get(wv)
                        all_confirmed = (
                            srec is not None
                            and set(srec["dests"])
                            <= set(srec["confirmed"]))
                    if all_confirmed:
                        self.on_wave_flipped(wv)
            if actions:
                self._replicate(rid)
