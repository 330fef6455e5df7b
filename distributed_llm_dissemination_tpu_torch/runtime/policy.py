"""Closed-loop fleet autonomy: the leader-side policy engine (docs/autonomy.md).

Every sensor and every actuator the platform grew
already exists — the health timeline flags straggler links, per-replica
serve p99 rides the metrics plane, joins/drains/repairs/rollouts are
all leader chokepoints — but an operator still connects them.  This
module closes the loop: declarative rules (the config ``Policies``
block) are evaluated against the already-folded cluster signals on
every metrics interval, and fire the SAME internal chokepoints the CLI
verbs use.  Nothing here invents a new actuator; the engine is a
disciplined operator that never sleeps.

The four rule kinds (the full signal→action table is docs/autonomy.md):

- ``grow_on_serve_pressure``: a serving replica whose interval p99
  sustains above the bar for ``Sustain`` consecutive intervals gets its
  replica set grown — a join+refill job copies its holdings onto a
  placeable spare (``membership.spares``), origin avoided.
- ``replan_straggler``: a ``straggler_link`` health event demotes that
  link's modeled rate in the flow solver's inputs and re-plans — the
  solver prices alternatives and routes in-flight pairs around the slow
  path.  ``link_recovered`` lifts the demotion (hysteresis: only after
  the recovery event, never mid-flap).
- ``quarantine_breacher``: ``Breaches`` consecutive SLO-breaching
  intervals quarantine the replica from serving rotation — the
  leader-side serve-rotation mask honored by the rollout A/B split and
  soak baselining.  Quarantine is a mask, not a prune: the replica's
  bytes stay planned and its lease stays live.
- ``rehome_on_loss``: a node silent for ``SuspectFrac`` of the failure
  timeout gets its unique holdings proactively re-homed BEFORE the
  crash path fires — the repair job races the detector, so a real
  death costs re-sent bytes already moving instead of starting cold.
  (A planned drain re-homes synchronously through the membership
  plane's own chokepoint and needs no rule.)

Every decision — fired, skipped, or completed — is a first-class
audited record; the engine's whole state (armed rules, cooldowns,
quarantine mask, in-flight actions, audit ring) REPLACE-replicates via
``ControlDeltaMsg`` kind ``policy`` + the snapshot's ``Policy`` section
so a promoted standby inherits armed rules and completes in-flight
actions at the bumped epoch instead of double-firing or dropping them.
Every fired action stamps a ``policy:<id>`` span so RUN_REPORT
attributes what the fleet did to itself and why.

Kill-switches (docs/autonomy.md): ``DLD_POLICY=0`` (env, hard — the
engine stops acting immediately, mid-action included; in-flight JOBS
keep moving because the job plane owns them, but no new action fires)
and the token-gated ``PolicyCtlMsg`` disable verb (soft — rules keep
sensing so streaks/cooldowns stay warm, actions hold).

Lock discipline: the engine lock is LEAF-most, same rule as
``RolloutDriver`` — no leader/membership/job call is ever made while
holding it.  Decisions are computed under the lock and EXECUTED
outside it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..utils import telemetry, trace
from ..utils.logging import log
from .rollout import serve_view

# The action vocabulary: every audited record's "Action" field is one
# of these, and the tier-1 static drift check pins each to a live
# execution site in this module and a row in docs/autonomy.md — the
# audit trail can never silently diverge from what the engine can do.
POLICY_ACTIONS = ("grow", "replan", "quarantine", "rehome")

AUDIT_RING = 128

# Rule grammar: each Policies entry is {"Rule": <kind>, ...params}.
# _RULE_PARAMS maps kind -> {param: (validator, default)}; admission
# refuses unknown kinds, unknown params, and out-of-range values
# LOUDLY (ValueError) — a bad rule must fail at config parse, never at
# fire time (docs/autonomy.md).


def _pos(x):
    v = float(x)
    if v <= 0:
        raise ValueError("must be > 0")
    return v


def _nonneg(x):
    v = float(x)
    if v < 0:
        raise ValueError("must be >= 0")
    return v


def _count(x):
    v = int(x)
    if v < 1:
        raise ValueError("must be >= 1")
    return v


def _nonneg_int(x):
    v = int(x)
    if v < 0:
        raise ValueError("must be >= 0")
    return v


def _frac(x):
    v = float(x)
    if not 0 < v <= 1:
        raise ValueError("must be in (0, 1]")
    return v


def _open_frac(x):
    v = float(x)
    if not 0 < v < 1:
        raise ValueError("must be in (0, 1)")
    return v


_RULE_PARAMS: Dict[str, Dict[str, tuple]] = {
    "grow_on_serve_pressure": {
        "P99Ms": (_pos, None),          # required: the latency bar
        "Sustain": (_count, 2),         # consecutive breaching intervals
        "CooldownS": (_nonneg, 30.0),
        "MaxGrows": (_nonneg_int, 1),   # grows per replica (0 = unlimited)
    },
    "replan_straggler": {
        "FloorFrac": (_frac, 0.1),      # demotion floor vs modeled rate
        "CooldownS": (_nonneg, 10.0),
        "LiftOnRecovery": (bool, True),
    },
    "quarantine_breacher": {
        "P99Ms": (_pos, None),          # required: the latency bar
        "Breaches": (_count, 2),        # consecutive breaching intervals
        "CooldownS": (_nonneg, 60.0),
    },
    "rehome_on_loss": {
        "SuspectFrac": (_open_frac, 0.5),  # of the failure timeout
        "CooldownS": (_nonneg, 30.0),
    },
}

_REQUIRED = {kind: {p for p, (_, d) in params.items() if d is None}
             for kind, params in _RULE_PARAMS.items()}


def validate_policies(raw) -> List[dict]:
    """Admission-time validation: raw config ``Policies`` list →
    normalized rule dicts (defaults filled, numbers coerced).  Raises
    ``ValueError`` naming the offending rule index and reason — a bad
    rule is refused LOUDLY at config parse, never deferred to fire
    time."""
    if raw is None:
        return []
    if not isinstance(raw, (list, tuple)):
        raise ValueError("Policies must be a list of rule objects")
    out: List[dict] = []
    for i, entry in enumerate(raw):
        where = f"Policies[{i}]"
        if not isinstance(entry, dict):
            raise ValueError(f"{where}: not an object")
        kind = entry.get("Rule")
        if kind not in _RULE_PARAMS:
            raise ValueError(
                f"{where}: unknown rule {kind!r} "
                f"(known: {sorted(_RULE_PARAMS)})")
        params = _RULE_PARAMS[kind]
        unknown = set(entry) - set(params) - {"Rule"}
        if unknown:
            raise ValueError(
                f"{where} ({kind}): unknown params {sorted(unknown)}")
        missing = _REQUIRED[kind] - set(entry)
        if missing:
            raise ValueError(
                f"{where} ({kind}): missing required {sorted(missing)}")
        rule = {"Rule": kind}
        for p, (conv, dflt) in params.items():
            if p in entry:
                try:
                    rule[p] = conv(entry[p])
                except (TypeError, ValueError) as e:
                    raise ValueError(f"{where} ({kind}).{p}: {e}")
            else:
                rule[p] = dflt
        out.append(rule)
    return out


def env_enabled() -> bool:
    """The hard kill-switch: ``DLD_POLICY`` unset/1/on = armed; 0/false/
    off = manual mode, checked on EVERY tick so flipping the env var
    mid-run drops the fleet to manual at the next interval."""
    return os.environ.get("DLD_POLICY", "1").lower() not in (
        "0", "false", "off")


class PolicyEngine:
    """The leader's autonomy state machine.  All sensing enters through
    :meth:`tick` (the metrics-interval callback); all acting leaves
    through the leader's own chokepoints (``submit_job``,
    ``policy_demote_link``, the serve-rotation mask read back via
    ``quarantined()``)."""

    def __init__(self, leader):
        self.leader = leader
        self._lock = threading.Lock()  # LEAF lock: no leader calls under it
        self._rules: List[dict] = []
        self._enabled = True           # the soft (operator) switch
        self._seq = 0
        self._cooldowns: Dict[str, float] = {}   # "rule|target" -> mono t
        self._streaks: Dict[str, int] = {}       # "rule|target" -> count
        self._quarantined: Set[int] = set()
        self._demoted: Dict[str, dict] = {}      # "s->d" -> {"Bps", "Frac"}
        self._inflight: Dict[str, dict] = {}     # action id -> record
        self._grown: Dict[str, int] = {}         # target node -> grow count
        self._audit: List[dict] = []
        self._last_serve: Dict[int, dict] = {}   # node -> serve_view snap

    # --------------------------------------------------------------- arming

    def arm(self, policies) -> List[dict]:
        """Install validated rules (idempotent REPLACE) and replicate.
        Raises ValueError on a bad block — admission, not fire time."""
        rules = validate_policies(policies)
        with self._lock:
            self._rules = rules
        if rules:
            log.info("policy rules armed",
                     rules=[r["Rule"] for r in rules])
        self._publish()
        return rules

    def set_enabled(self, on: bool) -> None:
        """The soft switch (PolicyCtlMsg enable/disable — token-gated
        at the leader handler).  Sensing continues either way; actions
        hold while disabled."""
        with self._lock:
            self._enabled = bool(on)
        log.warn("policy actioning " + ("ENABLED" if on else
                                        "DISABLED (manual mode)"))
        self._publish()

    def active(self) -> bool:
        with self._lock:
            armed = bool(self._rules) and self._enabled
        return armed and env_enabled()

    def quarantined(self) -> Set[int]:
        """The serve-rotation mask (docs/autonomy.md): replicas the A/B
        split and rollout soak baselining must route around."""
        with self._lock:
            return set(self._quarantined)

    def demotions(self) -> Dict[Tuple[int, int], int]:
        """Installed link demotions as the flow solver's
        ``link_demotions`` input: (src, dest) -> modeled bytes/s."""
        with self._lock:
            out = {}
            for key, rec in self._demoted.items():
                s, _, d = key.partition("->")
                out[(int(s), int(d))] = int(rec["Bps"])
            return out

    # -------------------------------------------------------------- sensing

    def tick(self, node_id: int, snap: dict, events) -> None:
        """One metrics interval: fold this reporter's serve signals,
        react to new health events, sweep suspicion and in-flight
        actions.  Called on the leader's message loop with NO leader
        lock held."""
        with self._lock:
            if not self._rules:
                return
        self._complete_inflight()
        acting = self.active()
        decisions: List[dict] = []
        with self._lock:
            now = time.monotonic()
            for rule in self._rules:
                kind = rule["Rule"]
                if kind in ("grow_on_serve_pressure",
                            "quarantine_breacher"):
                    d = self._sense_serve_locked(rule, node_id, snap, now)
                    if d:
                        decisions.append(d)
                elif kind == "replan_straggler":
                    decisions.extend(self._sense_links_locked(
                        rule, events or (), now))
                elif kind == "rehome_on_loss":
                    pass  # swept below, outside the per-report sensing
            # Serve-view snapshot advances exactly once per report,
            # AFTER every serve-keyed rule diffed against the old one.
            view = serve_view(snap, int(node_id))
            if view["requests"] or view["hist"]:
                self._last_serve[int(node_id)] = view
        decisions.extend(self._sense_loss())
        if not acting:
            # Manual mode (env or operator switch): streaks/cooldowns
            # stayed warm above, but nothing fires — each held decision
            # is audited as such so the kill-switch leaves a trail.
            for dec in decisions:
                self._audit_add(dict(dec, Outcome="held_manual"))
            if decisions:
                self._publish()
            return
        for dec in decisions:
            self._execute(dec)

    def _sense_serve_locked(self, rule: dict, node: int, snap: dict,
                            now: float) -> Optional[dict]:
        """Interval p99 vs the rule's bar for ONE serving replica; a
        sustained breach streak crosses the rule's threshold into a
        grow or quarantine decision.  Lock held."""
        node = int(node)
        view = serve_view(snap, node)
        prev = self._last_serve.get(node)
        if prev is None:
            return None
        d_req = view["requests"] - prev["requests"]
        delta = telemetry.hist_delta(view["hist"], prev["hist"])
        p99 = telemetry.percentile_from_hist(delta, 0.99)
        if d_req <= 0 and p99 is None:
            return None  # not serving this interval: no verdict
        kind = rule["Rule"]
        key = f"{kind}|{node}"
        breach = p99 is not None and p99 > rule["P99Ms"]
        if not breach:
            self._streaks.pop(key, None)
            return None
        streak = self._streaks.get(key, 0) + 1
        self._streaks[key] = streak
        bar = rule["Sustain"] if kind == "grow_on_serve_pressure" \
            else rule["Breaches"]
        if streak < bar:
            return None
        if self._cooldowns.get(key, 0.0) > now:
            return None
        if kind == "quarantine_breacher" and node in self._quarantined:
            return None
        if kind == "grow_on_serve_pressure":
            cap = rule["MaxGrows"]
            if cap and self._grown.get(str(node), 0) >= cap:
                return None
        self._cooldowns[key] = now + rule["CooldownS"]
        self._streaks.pop(key, None)
        action = ("grow" if kind == "grow_on_serve_pressure"
                  else "quarantine")
        return {"Action": action, "Rule": kind, "Target": node,
                "Reason": f"p99 {p99}ms > {rule['P99Ms']}ms "
                          f"sustained {streak} intervals"}

    def _sense_links_locked(self, rule: dict, events,
                            now: float) -> List[dict]:
        """``straggler_link`` → demote+replan decision, debounced by the
        rule cooldown (a flapping link is re-planned once, not toggled
        every interval); ``link_recovered`` → lift decision.  Lock
        held."""
        out: List[dict] = []
        for ev in events:
            kind = ev.get("kind")
            link = str(ev.get("link") or "")
            if not link:
                continue
            key = f"replan_straggler|{link}"
            if kind == "straggler_link":
                if link in self._demoted:
                    continue  # already routed around — flap absorbed
                if self._cooldowns.get(key, 0.0) > now:
                    continue
                self._cooldowns[key] = now + rule["CooldownS"]
                modeled = int(ev.get("modeled_bps") or 0)
                achieved = int(ev.get("achieved_bps") or 0)
                floor = int(modeled * rule["FloorFrac"])
                bps = max(achieved, floor, 1)
                out.append({
                    "Action": "replan", "Rule": rule["Rule"],
                    "Target": link, "Bps": bps,
                    "Reason": f"straggler frac={ev.get('frac')} "
                              f"intervals={ev.get('intervals')}; "
                              f"demote {modeled}->{bps} B/s"})
            elif kind == "link_recovered" and rule["LiftOnRecovery"]:
                if link not in self._demoted:
                    continue
                # Lift is NOT cooled down (recovery is the hysteresis:
                # the health plane only emits it after the measured rate
                # held above threshold), but the re-demote of a flapping
                # link IS, via the straggler branch above.
                out.append({
                    "Action": "replan", "Rule": rule["Rule"],
                    "Target": link, "Lift": True,
                    "Reason": f"recovered frac={ev.get('frac')} after "
                              f"{ev.get('intervals')} breach intervals"})
        return out

    def _sense_loss(self) -> List[dict]:
        """Death suspicion: nodes silent for ``SuspectFrac`` of the
        failure timeout get a proactive re-home decision.  Reads the
        detector WITHOUT the engine lock (leaf discipline), then takes
        it only to stamp cooldowns."""
        with self._lock:
            rule = next((r for r in self._rules
                         if r["Rule"] == "rehome_on_loss"), None)
        if rule is None:
            return []
        det = getattr(self.leader, "detector", None)
        if det is None or det.timeout <= 0:
            return []
        bar = rule["SuspectFrac"] * det.timeout
        ages = det.silent_ages()
        me = self.leader.node.my_id
        out: List[dict] = []
        with self._lock:
            now = time.monotonic()
            for node, age in ages.items():
                if age < bar or int(node) == int(me):
                    continue
                key = f"rehome_on_loss|{node}"
                if self._cooldowns.get(key, 0.0) > now:
                    continue
                self._cooldowns[key] = now + rule["CooldownS"]
                out.append({
                    "Action": "rehome", "Rule": rule["Rule"],
                    "Target": int(node),
                    "Reason": f"silent {age:.1f}s > "
                              f"{rule['SuspectFrac']:.2f}x timeout "
                              f"({det.timeout:.1f}s)"})
        return out

    # --------------------------------------------------------------- acting

    def _execute(self, dec: dict) -> None:
        """Fire one decision through the leader's chokepoints.  Engine
        lock NOT held around any leader call."""
        with self._lock:
            self._seq += 1
            action_id = f"{dec['Action']}-{self._seq}"
        rec = dict(dec, ID=action_id, Epoch=int(self.leader.epoch))
        span = f"policy:{action_id}"
        telemetry.span_event(span, "planned", node=self.leader.node.my_id,
                             action=dec["Action"], rule=dec["Rule"],
                             target=str(dec["Target"]),
                             reason=dec["Reason"])
        trace.count(f"policy.action_{dec['Action']}")
        log.warn("policy action", **{k.lower(): v for k, v in rec.items()})
        done, detail = self._fire(rec)
        rec["Detail"] = detail
        if done:
            rec["Outcome"] = "done"
            telemetry.span_event(span, "acked",
                                 node=self.leader.node.my_id,
                                 detail=detail)
            self._audit_add(rec)
        elif rec.get("Job"):
            rec["Outcome"] = "inflight"
            with self._lock:
                self._inflight[action_id] = rec
            self._audit_add(dict(rec))
        else:
            rec["Outcome"] = "skipped"
            telemetry.span_event(span, "acked",
                                 node=self.leader.node.my_id,
                                 detail=detail, skipped=True)
            self._audit_add(rec)
        self._publish()

    def _fire(self, rec: dict):
        """Dispatch one action record to its actuator.  Returns
        (completed_now, detail); a job-backed action completes later in
        :meth:`_complete_inflight`."""
        action = rec["Action"]
        if action == "quarantine":
            with self._lock:
                self._quarantined.add(int(rec["Target"]))
            # The mask is read by the rollout driver's pool derivation
            # and soak baselining on their next evaluation — no push
            # needed (docs/autonomy.md).
            return True, "serve-rotation mask set"
        if action == "replan":
            s, _, d = str(rec["Target"]).partition("->")
            demote = getattr(self.leader, "policy_demote_link", None)
            if demote is None:
                return True, "no link model in this mode (noop)"
            if rec.get("Lift"):
                with self._lock:
                    self._demoted.pop(str(rec["Target"]), None)
                self.leader.policy_lift_link(int(s), int(d))
                return True, "demotion lifted, re-planned"
            with self._lock:
                self._demoted[str(rec["Target"])] = {
                    "Bps": int(rec["Bps"])}
            demote(int(s), int(d), int(rec["Bps"]))
            return True, f"link demoted to {rec['Bps']} B/s, re-planned"
        if action == "grow":
            jid = self.leader.policy_grow(int(rec["Target"]),
                                          rec["ID"])
            if not jid:
                return True, "no placeable spare (skipped)"
            with self._lock:
                key = str(rec["Target"])
                self._grown[key] = self._grown.get(key, 0) + 1
            rec["Job"] = jid
            return False, f"join+refill {jid} submitted"
        if action == "rehome":
            jid = self.leader.policy_rehome(int(rec["Target"]),
                                            rec["ID"])
            if not jid:
                return True, "no unique holdings at risk (skipped)"
            rec["Job"] = jid
            return False, f"repair {jid} submitted"
        return True, f"unknown action {action!r} (noop)"

    def _complete_inflight(self) -> None:
        """Close out job-backed actions whose job finished — the span's
        terminal phase stamps HERE, so RUN_REPORT shows when the fleet's
        own action landed, not just when it was decided."""
        with self._lock:
            pending = [(aid, rec.get("Job"))
                       for aid, rec in self._inflight.items()]
        if not pending:
            return
        closed = []
        for aid, jid in pending:
            job = self.leader.jobs.get(jid) if jid else None
            if job is not None and job.state == "done":
                closed.append((aid, jid, job.dropped_pairs))
        if not closed:
            return
        for aid, jid, dropped in closed:
            with self._lock:
                rec = self._inflight.pop(aid, None)
            if rec is None:
                continue
            rec["Outcome"] = "done" if not dropped else "done_degraded"
            telemetry.span_event(f"policy:{aid}", "acked",
                                 node=self.leader.node.my_id,
                                 job=jid, dropped=int(dropped))
            log.info("policy action completed", id=aid, job=jid)
            self._audit_add(rec)
        self._publish()

    # ------------------------------------------------- replication/failover

    def _audit_add(self, rec: dict) -> None:
        rec = dict(rec, TMs=round(time.time() * 1000.0, 1))
        with self._lock:
            self._audit.append(rec)
            del self._audit[:-AUDIT_RING]

    def to_json(self) -> dict:
        """Full engine state, REPLACE semantics (kind ``policy`` +
        snapshot ``Policy`` section).  Cooldowns ship as REMAINING
        seconds — monotonic clocks don't replicate; the successor
        re-arms them against its own clock (a small skew costs at most
        one early/late fire, never a double)."""
        with self._lock:
            now = time.monotonic()
            return {
                "Enabled": bool(self._enabled),
                "Rules": [dict(r) for r in self._rules],
                "Cooldowns": {k: round(max(0.0, t - now), 3)
                              for k, t in self._cooldowns.items()
                              if t > now},
                "Streaks": dict(self._streaks),
                "Quarantined": sorted(self._quarantined),
                "Demoted": {k: dict(v) for k, v in self._demoted.items()},
                "Inflight": {k: dict(v)
                             for k, v in self._inflight.items()},
                "Grown": dict(self._grown),
                "Seq": int(self._seq),
                "Audit": [dict(a) for a in self._audit[-16:]],
            }

    def load(self, d: dict) -> None:
        """Restore from a replicated snapshot/delta (standby side, and
        ``adopt_shadow`` on the promoted leader)."""
        d = d or {}
        with self._lock:
            now = time.monotonic()
            self._enabled = bool(d.get("Enabled", True))
            try:
                self._rules = validate_policies(d.get("Rules"))
            except ValueError:
                # A replicated rule the OLD leader validated must not
                # brick the successor on vocabulary skew: drop it
                # loudly, keep the rest of the state.
                log.error("replicated policy rules failed validation; "
                          "dropping rules, keeping state")
                self._rules = []
            self._cooldowns = {str(k): now + float(v)
                               for k, v in (d.get("Cooldowns") or
                                            {}).items()}
            self._streaks = {str(k): int(v)
                             for k, v in (d.get("Streaks") or {}).items()}
            self._quarantined = {int(n)
                                 for n in d.get("Quarantined") or ()}
            self._demoted = {str(k): dict(v) for k, v in
                             (d.get("Demoted") or {}).items()}
            self._inflight = {str(k): dict(v) for k, v in
                              (d.get("Inflight") or {}).items()}
            self._grown = {str(k): int(v)
                           for k, v in (d.get("Grown") or {}).items()}
            self._seq = int(d.get("Seq", 0))
            self._audit = [dict(a) for a in d.get("Audit") or ()]

    def resume_from_takeover(self) -> None:
        """Promoted-leader resume (leader.resume_from_takeover): re-apply
        the inherited demotions/mask idempotently and COMPLETE in-flight
        actions at the bumped epoch — an action whose job already rode
        the replicated job table resumes through the job plane (no
        double fire); one whose job record never made it is re-submitted
        through the same chokepoint it originally used."""
        with self._lock:
            demoted = {k: dict(v) for k, v in self._demoted.items()}
            inflight = [dict(rec) for rec in self._inflight.values()]
        demote = getattr(self.leader, "policy_demote_link", None)
        for key, rec in demoted.items():
            if demote is None:
                break
            s, _, d = key.partition("->")
            demote(int(s), int(d), int(rec["Bps"]))
        for rec in inflight:
            jid = rec.get("Job")
            if jid and self.leader.jobs.get(jid) is not None:
                continue  # the job plane carries it — resumed, not re-fired
            aid = rec.get("ID", "?")
            log.warn("re-submitting policy action lost in failover",
                     id=aid, job=jid)
            action, target = rec.get("Action"), rec.get("Target")
            new_jid = ""
            if action == "grow":
                new_jid = self.leader.policy_grow(int(target), aid)
            elif action == "rehome":
                new_jid = self.leader.policy_rehome(int(target), aid)
            with self._lock:
                if aid in self._inflight:
                    if new_jid:
                        self._inflight[aid]["Job"] = new_jid
                        self._inflight[aid]["Epoch"] = int(
                            self.leader.epoch)
                    else:
                        self._inflight.pop(aid, None)
        if demoted or inflight:
            self._audit_add({"Action": "resume", "Rule": "-",
                             "Target": "-", "Outcome": "done",
                             "Reason": f"takeover: {len(demoted)} "
                                       f"demotions re-applied, "
                                       f"{len(inflight)} actions "
                                       f"inherited",
                             "Epoch": int(self.leader.epoch)})
        self._publish()

    def _publish(self) -> None:
        """Replicate the full state (REPLACE) — called after every
        mutation, outside the engine lock."""
        try:
            self.leader._replicate("policy", **self.to_json())
        except Exception as e:  # noqa: BLE001 — replication is advisory
            log.warn("policy state replication failed", err=repr(e))

    def table(self) -> dict:
        """The -policies verb's reply payload: the replicated state plus
        the live switches, JSON-clean."""
        out = self.to_json()
        out["EnvEnabled"] = env_enabled()
        out["Active"] = self.active()
        return out
