"""Multi-job dissemination: the leader's admitted-job table (docs/service.md).

The paper's system measures ONE delivery; a production service under
continuous rollouts admits many — a v2 version push, a node-repair
refill, an A/B variant — all sharing the same links.  This module is the
job plane's bookkeeping half: :class:`Job` records what a submitted job
wants (a target ``Assignment``, a priority, optional content digests for
delta resolution), :class:`JobManager` tracks every admitted job's
remaining (dest, layer) demand and credits acks against ALL jobs that
want the pair (two overlapping jobs are satisfied by one delivery).

The solving half lives in ``sched.flow.solve_joint``: all active jobs'
remaining demands become one flow problem per priority tier, higher
tiers consuming link budget first — a high-priority job preempts by
reclaiming capacity at the next re-plan, it never kills in-flight bytes
(receivers tolerate the superseded deliveries).

Everything here is leader-process state; replication to standbys rides
``ControlDeltaMsg`` kind ``job``/``job_done`` plus the snapshot's
``Jobs`` section (``runtime/failover.py``), so a promoted standby
resumes every admitted job, not just one run.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Set, Tuple

from ..core.types import (
    Assignment,
    LayerID,
    NodeID,
    Status,
    codec_accepts,
    delivered,
    layer_ids_from_json,
    layer_ids_to_json,
    satisfies,
    shard_covers,
)
from ..utils.logging import log

# Job lifecycle: admitted jobs are ACTIVE until their remaining pair set
# empties (every demand delivered, content-resolved, or dropped with a
# crashed dest), then DONE.  There is no "failed": a job whose dest died
# completes with ``dropped_pairs`` > 0 — visible, not silent.
ACTIVE = "active"
DONE = "done"


@dataclasses.dataclass
class Job:
    """One admitted dissemination job.

    ``assignment`` is the job's goal state (dest → layers it must end up
    holding) — the same vocabulary as the constructor's single-run
    assignment, which is exactly the point: a job IS a scoped
    ``update()``.  ``digests`` optionally names each layer's content
    (``xxh3:<hex>`` — the integrity plane's stamp format) so the content store can
    resolve unchanged layers without wire bytes (docs/service.md).
    ``priority``: higher preempts — it is planned in an earlier flow
    tier, consuming link budget first.  ``kind`` is an advisory label
    ("push" | "repair" | "ab" | ...) for operators and reports."""

    job_id: str
    assignment: Assignment
    priority: int = 0
    kind: str = "push"
    digests: Dict[LayerID, str] = dataclasses.field(default_factory=dict)
    state: str = ACTIVE
    # Rollout version (docs/swap.md): a ``kind="swap"`` job's v2 tag —
    # stamped onto every target meta at admission, so only deliveries
    # verified under this version complete its pairs.  ``swap_base``:
    # blob-id base of the v2 set (v2 id = swap_base + model slot).
    version: str = ""
    swap_base: int = -1
    # True when the job was cancelled (swap abort, operator action):
    # its undelivered pairs moved to ``dropped_pairs`` — visibly
    # degraded, never silently "done".
    cancelled: bool = False
    # Sender node ids this job must NOT pull from (the repair-refill
    # politeness policy: spare the busy origin seeder when current
    # holders can serve).  Advisory: deliverability wins — the solver
    # falls back to all sources, loudly, if avoidance starves the job.
    avoid_sources: Set[NodeID] = dataclasses.field(default_factory=set)
    remaining: Set[Tuple[NodeID, LayerID]] = dataclasses.field(
        default_factory=set)
    total_pairs: int = 0
    resolved_at_admit: int = 0  # pairs already satisfied when admitted
    dropped_pairs: int = 0      # pairs lost to crashed dests
    admit_ms: float = 0.0       # submitter wall clock (advisory)
    # Submitter identity (docs/service.md, quotas): the token-derived
    # identity the job was admitted under — per-submitter quota and
    # rate-limit accounting keys on it.  "" = pre-quota record.
    submitter: str = ""

    def summary(self) -> dict:
        """JSON-ready status row (JobStatusMsg / -jobs / run report)."""
        out = {
            "JobID": self.job_id,
            "State": self.state,
            "Priority": self.priority,
            "Kind": self.kind,
            "TotalPairs": self.total_pairs,
            "RemainingPairs": len(self.remaining),
            "ResolvedAtAdmit": self.resolved_at_admit,
            "DroppedPairs": self.dropped_pairs,
            "Dests": sorted(self.assignment),
        }
        if self.version:
            out["Version"] = self.version
        if self.cancelled:
            out["Cancelled"] = True
        return out


def merge_assignments(base: Assignment, others) -> Assignment:
    """Union of goal states: every (dest, layer) any of them wants.
    Base metas win on conflicts (they carry the run's source modeling);
    the result is a NEW nested dict — mutating it never aliases a job's
    own target.

    Shard widening (docs/sharding.md): when two wants name DIFFERENT
    shards of one (dest, layer) and neither covers the other, the
    merged target widens to the full layer — a single spec can't name
    the union, and over-delivery is safe where under-delivery wedges a
    job."""
    out: Assignment = {n: dict(r) for n, r in base.items()}
    for extra in others:
        for dest, lids in extra.items():
            row = out.setdefault(dest, {})
            for lid, meta in lids.items():
                held = row.get(lid)
                if held is None:
                    row[lid] = meta
                    continue
                h, w = getattr(held, "shard", ""), getattr(meta, "shard", "")
                if shard_covers(h, w):
                    continue  # existing target already covers this want
                if shard_covers(w, h):
                    row[lid] = dataclasses.replace(held, shard=w)
                else:
                    row[lid] = dataclasses.replace(held, shard="")
    return out


class JobManager:
    """The leader's admitted-job table.  Thread-safe; never calls back
    into leader code (so it can be used under or outside the leader's
    own lock without ordering hazards)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs: Dict[str, Job] = {}

    # ------------------------------------------------------------ admission

    def admit(self, job: Job, status: Status) -> Job:
        """Admit (or idempotently re-admit) a job: its remaining demand
        is the target minus what ``status`` already shows delivered.  A
        re-submitted job_id returns the EXISTING record unchanged — the
        submit path is safe to retry."""
        with self._lock:
            prior = self._jobs.get(job.job_id)
            if prior is not None:
                return prior
            pairs = {(dest, lid)
                     for dest, lids in job.assignment.items()
                     for lid in lids}
            job.total_pairs = len(pairs)
            job.remaining = set()
            for dest, lid in pairs:
                held = status.get(dest, {}).get(lid)
                if satisfies(held, job.assignment[dest][lid]):
                    job.resolved_at_admit += 1
                else:
                    job.remaining.add((dest, lid))
            if not job.remaining:
                job.state = DONE
            self._jobs[job.job_id] = job
            return job

    # ----------------------------------------------------------- accounting

    def on_ack(self, dest: NodeID, lid: LayerID,
               shard: str = "", version: str = "",
               codec: str = "") -> List[str]:
        """Credit one delivered (dest, layer) pair against every active
        job that wants it; returns the job ids the ack completed.
        ``shard``: the delivered shard spec ("" = whole layer) — a
        shard ack only credits jobs whose target shard it COVERS, so a
        shard-holder can never complete a full-layer demand
        (docs/sharding.md).  ``version``: the delivered rollout version
        — a VERSIONED pair is only credited by an ack carrying the
        SAME tag (docs/swap.md: a stale unversioned copy can never
        complete a swap job's demand), while an unversioned pair
        accepts any verified delivery of the id (mirroring
        ``satisfies``: a post-swap push job must not wedge on the
        tag).  ``codec``: the delivered wire-codec form — a quantized
        delivery credits only pairs PLANNED at that codec (the leader
        stamps its codec choices onto job targets via
        :meth:`apply_codecs`); canonical bytes credit everything
        (docs/codec.md)."""
        finished: List[str] = []
        with self._lock:
            for job in self._jobs.values():
                if job.state != ACTIVE or (dest, lid) not in job.remaining:
                    continue
                want = job.assignment.get(dest, {}).get(lid)
                want_shard = getattr(want, "shard", "") if want else ""
                want_version = getattr(want, "version", "") if want else ""
                want_codec = getattr(want, "codec", "") if want else ""
                if not shard_covers(shard, want_shard):
                    continue
                if want_version and version != want_version:
                    continue
                if not codec_accepts(codec, want_codec):
                    continue
                job.remaining.discard((dest, lid))
                if not job.remaining:
                    job.state = DONE
                    finished.append(job.job_id)
        return finished

    def cancel(self, job_id: str) -> bool:
        """Cancel an active job (a swap abort, docs/swap.md): its
        undelivered pairs move to ``dropped_pairs`` — the job completes
        VISIBLY degraded — and the merged goal shrinks at the next
        recompute.  Returns whether the call changed anything."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state != ACTIVE:
                return False
            job.dropped_pairs += len(job.remaining)
            job.remaining = set()
            job.state = DONE
            job.cancelled = True
            return True

    def drop_dest(self, dest: NodeID) -> Tuple[List[str], List[str]]:
        """A dest was declared crashed: its pairs can never land.  Drop
        them from every active job (counted — a job completed by drops
        is visibly degraded, never silently 'done').  Returns
        ``(affected, finished)`` job ids: every job the drop MUTATED
        (the leader re-replicates those records — a standby restoring
        admit-time remaining sets would otherwise resurrect
        undeliverable pairs at takeover) and the subset the drop
        completed."""
        affected: List[str] = []
        finished: List[str] = []
        with self._lock:
            for job in self._jobs.values():
                if job.state != ACTIVE:
                    continue
                dead = {p for p in job.remaining if p[0] == dest}
                if not dead and dest not in job.assignment:
                    continue
                job.remaining -= dead
                job.dropped_pairs += len(dead)
                job.assignment.pop(dest, None)
                affected.append(job.job_id)
                if not job.remaining:
                    job.state = DONE
                    finished.append(job.job_id)
        return affected, finished

    def credit_status(self, status: Status) -> List[str]:
        """Reconcile against a status table (takeover: replicated job
        deltas are best-effort, so a lost ack must not strand a pair the
        adopted status already shows delivered)."""
        finished: List[str] = []
        with self._lock:
            for job in self._jobs.values():
                if job.state != ACTIVE:
                    continue
                for dest, lid in list(job.remaining):
                    held = status.get(dest, {}).get(lid)
                    want = job.assignment.get(dest, {}).get(lid)
                    if (held is not None
                            and (satisfies(held, want) if want is not None
                                 else delivered(held))):
                        job.remaining.discard((dest, lid))
                if not job.remaining:
                    job.state = DONE
                    finished.append(job.job_id)
        return finished

    def apply_codecs(self, choices: Dict[Tuple[NodeID, LayerID], str]
                     ) -> None:
        """Stamp the leader's wire-codec choices onto active jobs'
        target metas (docs/codec.md): job targets are codec-agnostic at
        submission, but ack crediting and takeover reconciliation both
        compare against the target meta — without the stamp, a
        quantized delivery the leader itself planned would never credit
        the job.  ``choices``: {(dest, layer): codec} ("" reverts a
        pair to canonical)."""
        if not choices:
            return
        with self._lock:
            for job in self._jobs.values():
                if job.state != ACTIVE:
                    continue
                for dest, lids in job.assignment.items():
                    for lid, meta in lids.items():
                        codec = choices.get((dest, lid))
                        if (codec is not None
                                and getattr(meta, "codec", "") != codec):
                            lids[lid] = dataclasses.replace(
                                meta, codec=codec)

    def active_count_for(self, submitter: str) -> int:
        """How many ACTIVE jobs this submitter identity currently owns
        — the per-submitter quota's denominator (docs/service.md)."""
        with self._lock:
            return sum(1 for j in self._jobs.values()
                       if j.state == ACTIVE and j.submitter == submitter)

    # -------------------------------------------------------------- queries

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def has_active(self) -> bool:
        with self._lock:
            return any(j.state == ACTIVE for j in self._jobs.values())

    def owner_of(self, dest: NodeID, lid: LayerID
                 ) -> Optional[Tuple[int, str]]:
        """(priority, job_id) of the highest-priority active job wanting
        the pair (job-id tiebreak for determinism), or None when no job
        claims it — the pair belongs to the base single-run goal."""
        best: Optional[Tuple[int, str]] = None
        with self._lock:
            for job in self._jobs.values():
                if job.state != ACTIVE or (dest, lid) not in job.remaining:
                    continue
                cand = (job.priority, job.job_id)
                if (best is None or cand[0] > best[0]
                        or (cand[0] == best[0] and cand[1] < best[1])):
                    best = cand
        return best

    def merged_assignment(self, base: Assignment) -> Assignment:
        """The effective cluster goal: base run ∪ every active job."""
        with self._lock:
            extras = [j.assignment for j in self._jobs.values()
                      if j.state == ACTIVE]
        return merge_assignments(base, extras)

    def progress_pairs(self) -> Dict[str, dict]:
        """Per-job remaining (dest, layer) pairs + totals — the raw
        material of the leader's ``-watch`` live progress lines (docs/
        observability.md): the leader sizes the pairs into bytes and
        stamps the tier-pacing ETA."""
        with self._lock:
            return {jid: {"state": job.state,
                          "remaining": sorted(job.remaining),
                          "total_pairs": job.total_pairs,
                          "priority": job.priority, "kind": job.kind}
                    for jid, job in self._jobs.items()}

    def table(self) -> Dict[str, dict]:
        with self._lock:
            return {jid: self._jobs[jid].summary()
                    for jid in sorted(self._jobs)}

    # ---------------------------------------------------------- replication

    def record(self, job_id: str) -> dict:
        """One job's full replication record (ControlDeltaMsg ``job``)."""
        with self._lock:
            job = self._jobs[job_id]
            return {
                "JobID": job.job_id,
                "Priority": job.priority,
                "Kind": job.kind,
                "State": job.state,
                "Assignment": {
                    str(n): layer_ids_to_json(r)
                    for n, r in job.assignment.items()},
                "Digests": {str(l): d for l, d in job.digests.items()},
                "Avoid": sorted(job.avoid_sources),
                "Remaining": sorted([d, l] for d, l in job.remaining),
                "TotalPairs": job.total_pairs,
                "ResolvedAtAdmit": job.resolved_at_admit,
                "DroppedPairs": job.dropped_pairs,
                "AdmitMs": job.admit_ms,
                "Version": job.version,
                "SwapBase": job.swap_base,
                "Cancelled": job.cancelled,
                "Submitter": job.submitter,
            }

    def to_json(self) -> Dict[str, dict]:
        with self._lock:
            ids = sorted(self._jobs)
        return {jid: self.record(jid) for jid in ids}

    @staticmethod
    def job_from_record(rec: dict) -> Job:
        return Job(
            job_id=str(rec["JobID"]),
            assignment={int(n): layer_ids_from_json(r or {})
                        for n, r in (rec.get("Assignment") or {}).items()},
            priority=int(rec.get("Priority", 0)),
            kind=str(rec.get("Kind", "push")),
            digests={int(l): str(d)
                     for l, d in (rec.get("Digests") or {}).items()},
            state=str(rec.get("State", ACTIVE)),
            avoid_sources={int(n) for n in rec.get("Avoid") or []},
            remaining={(int(d), int(l))
                       for d, l in (rec.get("Remaining") or [])},
            total_pairs=int(rec.get("TotalPairs", 0)),
            resolved_at_admit=int(rec.get("ResolvedAtAdmit", 0)),
            dropped_pairs=int(rec.get("DroppedPairs", 0)),
            admit_ms=float(rec.get("AdmitMs", 0.0)),
            version=str(rec.get("Version", "")),
            swap_base=int(rec.get("SwapBase", -1)),
            cancelled=bool(rec.get("Cancelled", False)),
            submitter=str(rec.get("Submitter", "")),
        )

    def load(self, records: Dict[str, dict]) -> None:
        """Restore the table from replicated records (takeover).  A
        malformed record is skipped loudly — one corrupt delta must not
        sink the other jobs' recovery."""
        with self._lock:
            for jid, rec in sorted((records or {}).items()):
                try:
                    self._jobs[str(jid)] = self.job_from_record(rec)
                except (KeyError, ValueError, TypeError) as e:
                    log.error("unloadable replicated job record; skipped",
                              job=jid, err=repr(e))
