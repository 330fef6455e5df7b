"""Elastic membership: the cluster roster as a replicated, epoch-fenced
state machine (docs/membership.md).

Until this module, the topology was a config constant: every node the
run would ever speak to was named before the first announce, and a node
that appeared or disappeared mid-run was either invisible or a crash.
A fleet autoscales.  :class:`MembershipTable` is the leader's
authoritative roster — who is in the cluster, in what state, admitted
under which epoch, reachable at what address — with exactly the
lifecycle the three membership verbs need:

- **join**: an unconfigured node announces itself (``JoinMsg``) and is
  admitted as ``JOINING`` — a delivery DEST immediately, but quarantined
  as a SOURCE until its announced holdings digest-verify against the
  leader's stamps (``verified``); verification flips it ``ACTIVE``.
- **drain**: a planned departure moves ``ACTIVE → DRAINING`` while the
  leader re-homes the drainer's unique holdings onto survivors, then
  ``DRAINING → LEFT`` atomically with its removal from the failure
  detector, lease recipients, and announce gating — a clean leave never
  fires the crash path.
- **cold-boot** is join plus content: the joiner's announce carries its
  local shard set (checkpointed partials + digests), so the planner
  ships only the complement — mostly from current peer holders.

Epoch fencing vs zombie rejoiners: every record remembers the leader
epoch it was admitted under and a per-seat ``generation`` counter.  A
node that LEFT stays left — its late announces, acks, and heartbeats
are fenced (the leader consults :meth:`is_left`) until it re-joins,
which mints a FRESH generation at the CURRENT epoch.  The whole table
replicates to standbys (``ControlDeltaMsg`` kind ``"membership"`` +
the snapshot's ``Membership`` section), so a promoted leader resumes
admission and in-flight drains instead of rediscovering the fleet.

The table never calls back into leader code (same contract as
``sched.jobs.JobManager``): it is bookkeeping the leader mutates under
its own locking discipline, safe to snapshot from any thread.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

from ..core.types import NodeID

# Member lifecycle states.  JOINING is a dest-only probation (announced
# holdings are not yet trusted as transfer sources); ACTIVE is full
# citizenship; DRAINING is a departure in progress (still a SOURCE for
# its own re-home transfers, never new demand); LEFT is terminal for
# the generation — only a fresh join resurrects the seat.
JOINING = "joining"
ACTIVE = "active"
DRAINING = "draining"
LEFT = "left"


class MemberRecord:
    """One seat's membership row."""

    __slots__ = ("node_id", "state", "addr", "epoch", "generation",
                 "verified")

    def __init__(self, node_id: NodeID, state: str = ACTIVE,
                 addr: str = "", epoch: int = -1, generation: int = 0,
                 verified: bool = True):
        self.node_id = int(node_id)
        self.state = str(state)
        self.addr = str(addr)
        self.epoch = int(epoch)
        self.generation = int(generation)
        self.verified = bool(verified)

    def to_json(self) -> dict:
        out: dict = {"State": self.state}
        if self.addr:
            out["Addr"] = self.addr
        if self.epoch >= 0:
            out["Epoch"] = self.epoch
        if self.generation:
            out["Gen"] = self.generation
        if not self.verified:
            out["Unverified"] = True
        return out

    @classmethod
    def from_json(cls, node_id: NodeID, d: dict) -> "MemberRecord":
        return cls(node_id, str(d.get("State", ACTIVE)),
                   str(d.get("Addr", "")), int(d.get("Epoch", -1)),
                   int(d.get("Gen", 0)),
                   not bool(d.get("Unverified", False)))


class MembershipTable:
    """The leader's replicated cluster roster.  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._members: Dict[NodeID, MemberRecord] = {}

    # ------------------------------------------------------------- seeding

    def seed(self, node_ids, epoch: int = -1) -> None:
        """Configured seats are ACTIVE and source-verified from the
        start: the config is the operator's trust statement, exactly
        the trust the pre-membership planner already placed in it."""
        with self._lock:
            for n in node_ids:
                self._members.setdefault(
                    int(n), MemberRecord(int(n), ACTIVE, epoch=epoch))

    # --------------------------------------------------------------- verbs

    def admit(self, node: NodeID, addr: str = "",
              epoch: int = -1) -> MemberRecord:
        """Admit a joiner (idempotent for a live seat; a LEFT seat —
        the zombie-rejoiner case — re-admits as a FRESH generation at
        the caller's current epoch, so nothing its dead generation did
        is trusted)."""
        node = int(node)
        with self._lock:
            rec = self._members.get(node)
            if rec is not None and rec.state != LEFT:
                if addr:
                    rec.addr = str(addr)
                return rec
            gen = rec.generation + 1 if rec is not None else 0
            rec = MemberRecord(node, JOINING, addr=addr, epoch=epoch,
                               generation=gen, verified=False)
            self._members[node] = rec
            return rec

    def verify_source(self, node: NodeID) -> bool:
        """The joiner's announced holdings digest-verified: it may now
        be planned as a SOURCE.  Returns whether anything changed."""
        with self._lock:
            rec = self._members.get(int(node))
            if rec is None or rec.state == LEFT:
                return False
            changed = not rec.verified or rec.state == JOINING
            rec.verified = True
            if rec.state == JOINING:
                rec.state = ACTIVE
            return changed

    def start_drain(self, node: NodeID) -> bool:
        """ACTIVE/JOINING → DRAINING.  False when the seat is unknown
        or already left (the caller answers the requester either way)."""
        with self._lock:
            rec = self._members.get(int(node))
            if rec is None or rec.state == LEFT:
                return False
            if rec.state == DRAINING:
                return False
            rec.state = DRAINING
            return True

    def complete_drain(self, node: NodeID) -> bool:
        """DRAINING → LEFT, exactly once."""
        with self._lock:
            rec = self._members.get(int(node))
            if rec is None or rec.state != DRAINING:
                return False
            rec.state = LEFT
            return True

    def mark_left(self, node: NodeID) -> None:
        """Record a terminal departure without the drain protocol (a
        crash the caller wants fenced like a leave)."""
        with self._lock:
            rec = self._members.get(int(node))
            if rec is not None:
                rec.state = LEFT

    def forget(self, node: NodeID) -> None:
        with self._lock:
            self._members.pop(int(node), None)

    # ------------------------------------------------------------- queries

    def state_of(self, node: NodeID) -> Optional[str]:
        with self._lock:
            rec = self._members.get(int(node))
            return rec.state if rec is not None else None

    def is_left(self, node: NodeID) -> bool:
        return self.state_of(node) == LEFT

    def is_draining(self, node: NodeID) -> bool:
        return self.state_of(node) == DRAINING

    def generation_of(self, node: NodeID) -> int:
        with self._lock:
            rec = self._members.get(int(node))
            return rec.generation if rec is not None else 0

    def addr_of(self, node: NodeID) -> str:
        with self._lock:
            rec = self._members.get(int(node))
            return rec.addr if rec is not None else ""

    def unverified_sources(self) -> Set[NodeID]:
        """Seats whose announced holdings must NOT be planned as
        transfer sources (joining probation, or a failed verify)."""
        with self._lock:
            return {n for n, rec in self._members.items()
                    if rec.state != LEFT and not rec.verified}

    def live(self) -> Set[NodeID]:
        """Every seat that has not LEFT (draining counts: it still
        sources its own re-home transfers)."""
        with self._lock:
            return {n for n, rec in self._members.items()
                    if rec.state != LEFT}

    def placeable(self) -> Set[NodeID]:
        """Seats eligible to RECEIVE new demand (re-homed holdings,
        joiner refills): live, not on their way out."""
        with self._lock:
            return {n for n, rec in self._members.items()
                    if rec.state in (ACTIVE, JOINING)}

    def spares(self, busy) -> List[NodeID]:
        """Placeable seats NOT in ``busy`` — the candidate pool the
        autonomy engine's grow rule places a replica refill onto
        (docs/autonomy.md).  Sorted for deterministic policy choice;
        ACTIVE (verified) seats order before still-JOINING ones so a
        grow lands on settled capacity when any exists."""
        busy = set(int(b) for b in busy)
        with self._lock:
            pool = [(0 if rec.state == ACTIVE else 1, n)
                    for n, rec in self._members.items()
                    if rec.state in (ACTIVE, JOINING) and n not in busy]
        return [n for _, n in sorted(pool)]

    def draining(self) -> List[NodeID]:
        with self._lock:
            return sorted(n for n, rec in self._members.items()
                          if rec.state == DRAINING)

    def joining(self) -> List[NodeID]:
        with self._lock:
            return sorted(n for n, rec in self._members.items()
                          if rec.state == JOINING)

    def addrs(self) -> Dict[NodeID, str]:
        """Every known (node, addr) — a promoted leader installs them
        into its transport registry so adopted joiners stay dialable."""
        with self._lock:
            return {n: rec.addr for n, rec in self._members.items()
                    if rec.addr and rec.state != LEFT}

    # --------------------------------------------------------- replication

    def to_json(self) -> Dict[str, dict]:
        with self._lock:
            return {str(n): rec.to_json()
                    for n, rec in sorted(self._members.items())}

    def load(self, records: Dict[str, dict]) -> None:
        """Restore from a replicated snapshot/delta (REPLACE — the
        delta always carries the leader's full current table, so a
        revoked membership is exactly an absent row)."""
        with self._lock:
            self._members = {
                int(n): MemberRecord.from_json(int(n), dict(rec or {}))
                for n, rec in (records or {}).items()}

    def size(self) -> int:
        with self._lock:
            return len(self._members)
