"""Deterministic fault-injection transport (docs/integrity.md).

``FaultyTransport`` wraps any concrete ``Transport`` and injects a
SEEDED, fully deterministic schedule of faults — the machinery that
*proves* the integrity plane instead of trusting it:

- **corrupt** (inbound layer frames): flips a payload byte below the
  CRC check, via the wrapped transport's ``recv_tamper`` hook — exactly
  where real wire/DMA corruption lands.  The transport must detect it
  (advisory CRC), drop the frame, and NACK the source.
- **drop** (inbound layer frames): discards the landed frame through the
  same hook (the transport treats it like a CRC failure: claim rolled
  back, NACK sent) — modeling a frame that arrived damaged beyond
  reading.  Inbound drops of CONTROL messages (e.g. SPMD ``DevicePlanMsg``
  by seq — the ported ``-test-drop-plan-seqs`` path) really vanish: their
  loss-recovery is the gap-report/watchdog machinery, not a NACK.
- **dup** (outbound): sends the message twice — reassembly and re-ack
  paths must absorb it.
- **delay** (outbound): sleeps before sending — reordering pressure.
- **reset** (outbound): raises ``ConnectionError`` to the caller —
  the path under test must survive a peer reset at send time.

Determinism: every rule matches message events in arrival order and
fires on every ``every``-th match with a phase derived from ``seed`` —
no randomness, so a failing chaos run replays bit-for-bit from its seed.

Construction-gated like the old ``-test-drop-plan-seqs``: a
production process never wraps its transport, so no environment variable
can inject faults into a real run.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional, Tuple

from ..core.types import LayerID, NodeID
from ..utils.logging import log
from .base import Transport
from .messages import DevicePlanMsg, LayerMsg, Message, MsgType


@dataclasses.dataclass
class FaultRule:
    """One deterministic fault: WHAT to do, WHERE (out = this node's
    sends, in = this node's receive path), WHICH messages match, and
    WHEN to fire (every Nth match, at most ``times`` times).

    Two TIME-SCHEDULED kinds ride the same record (docs/failover.md —
    leader-kill and split-brain tests must be seeded, not sleep-based):
    ``partition`` (bidirectional drop between this node and ``dest``
    during [t_start, t_end), both directions, all message types) and
    ``kill`` (hard-stop this node's whole transport at ``t_start``:
    sends raise, inbound vanishes).  Both are evaluated against the
    clock started at FaultyTransport construction, so a spec replays
    the same failure timeline every run."""

    kind: str  # "corrupt" | "drop" | "dup" | "delay" | "reset"
    #          | "partition" | "kill" | "join" | "leave"
    direction: str = "out"  # "out" (send-side) | "in" (receive-side)
    # Matchers; None = wildcard.
    msg_type: Optional[MsgType] = None
    layer: Optional[LayerID] = None
    src: Optional[NodeID] = None  # message src_id ("in" rules)
    dest: Optional[NodeID] = None  # send destination ("out" rules)
    offset_lo: int = 0  # fragment-range matchers ("in" layer rules):
    offset_hi: int = 1 << 62  # match frames overlapping [lo, hi)
    seq: Optional[int] = None  # DevicePlanMsg seq matcher
    # Firing schedule.
    every: int = 1  # fire on every Nth match...
    times: int = 0  # ...at most this many times (0 = unlimited)
    # Action parameters.
    delay_s: float = 0.0  # "delay"
    rate: int = 0  # "slow": bytes/second for the injected link limit
    flip_at: int = 0  # "corrupt": byte index within the fragment
    flip_mask: int = 0xFF  # "corrupt": XOR mask (non-zero)
    # Time schedule ("partition"/"kill"): seconds since transport
    # construction.  t_end None = forever.
    t_start: float = 0.0
    t_end: Optional[float] = None
    # Mutable counters (per-rule; FaultyTransport guards with its lock).
    matches: int = dataclasses.field(default=0, repr=False)
    fired: int = dataclasses.field(default=0, repr=False)

    def _matches_common(self, mtype, layer, seq) -> bool:
        if self.msg_type is not None and mtype != self.msg_type:
            return False
        if self.layer is not None and layer != self.layer:
            return False
        if self.seq is not None and seq != self.seq:
            return False
        return True

    def should_fire(self, phase: int) -> bool:
        """Advance the match counter; True when this match is a firing
        one.  Caller has already checked the matchers."""
        self.matches += 1
        if self.times and self.fired >= self.times:
            return False
        if (self.matches - 1) % max(1, self.every) != phase % max(
                1, self.every):
            return False
        self.fired += 1
        return True


def rules_from_spec(spec: str) -> Tuple[int, List[FaultRule]]:
    """Parse the CLI's compact fault spec into rules.  Grammar:
    comma-separated ``key=value`` pairs —

    - ``seed=N``: deterministic phase for every periodic rule
    - ``corrupt=N`` / ``dropin=N``: corrupt/drop every Nth INBOUND layer
      frame (0 = off)
    - ``drop=N`` / ``dup=N`` / ``reset=N``: every Nth OUTBOUND layer send
    - ``delay=N:MS``: delay every Nth outbound layer send by MS ms
    - ``times=K``: cap each generated rule at K firings (0 = unlimited)
    - ``drop-plan-seqs=a;b;c``: drop the FIRST inbound delivery of the
      named SPMD plan seqs (the ported ``-test-drop-plan-seqs``)
    - ``resetany=N``: like ``reset`` but matching EVERY outbound message
      type (control included) — the leader-routed requeue path's test
      hook
    - ``partition=P[@T1[-T2]]``: bidirectional drop between this node
      and node P during [T1, T2) seconds after construction (defaults:
      T1=0, T2=forever) — seeded split-brain, not sleep-based
    - ``kill_after=T``: hard-stop this node's transport T seconds after
      construction (sends raise ``ConnectionError``, inbound vanishes)
      — the deterministic leader-kill switch
    - ``join=T``: elastic-membership churn schedule (docs/membership.md)
      — this node is DARK (sends raise, inbound vanishes: it does not
      exist yet) until T seconds after construction, then comes alive;
      the harness reads ``FaultyTransport.join_at`` and fires the
      seat's ``join()`` at that moment — a seeded late-join, not a
      sleep in test code
    - ``leave=T``: the departure half of the churn schedule — purely an
      exposed timestamp (``FaultyTransport.leave_at``): the harness
      initiates the node's graceful DRAIN at T.  The transport itself
      stays healthy (a drain is planned, not a fault); pair with
      ``kill_after`` to model a crash-leave instead
    - ``slow=RATE[@P]``: rate-limit this node's outbound LAYER sends to
      peer P (all peers when omitted) to RATE bytes/second via a token
      bucket — the deterministic straggler-link injection the live-swap
      chaos case needs (a replica whose v2 staging lags the fleet while
      v1 keeps serving, docs/swap.md)
    - ``slowserve=MS[:N]``: delay every Nth (default: every) outbound
      GENERATE_RESP by MS ms — the deterministic BAD-WAVE injection of
      the rollout pipeline (docs/rollout.md): a wave's replicas answer
      slowly enough to breach the declared p99 SLO, without dropping a
      single request
    - ``flap=P@T1-T2[:N]``: a FLAPPING link to peer P — the [T1, T2)
      window splits into N (default 3) equal up/down cycles, each
      cycle's first half DOWN (a partition to P) and second half up.
      Purely sugar over ``partition``: the parser emits N partition
      rules with deterministic windows, so a flap replays bit-for-bit
      like every time-scheduled fault.  The autonomy chaos case
      (docs/autonomy.md) uses it to prove a flapping link is
      quarantined/demoted ONCE, not toggled every interval

    e.g. ``seed=7,corrupt=9,dropin=13,dup=11,times=8``.  Returns
    ``(seed, rules)`` — hand both to ``FaultyTransport``."""
    seed = 0
    times = 0
    pending = []  # (factory taking (seed, times))
    for part in [p.strip() for p in spec.split(",") if p.strip()]:
        key, _, val = part.partition("=")
        key = key.strip().lower()
        val = val.strip()
        if key == "seed":
            seed = int(val)
            continue
        if key == "times":
            times = int(val)
            continue
        if key == "partition":
            peer, _, window = val.partition("@")
            t1s, _, t2s = window.partition("-")
            t1 = float(t1s) if t1s else 0.0
            t2 = float(t2s) if t2s else None
            pending.append(lambda sd, tm, p=int(peer), a=t1, b=t2:
                           FaultRule("partition", "out", dest=p,
                                     t_start=a, t_end=b))
            continue
        if key == "flap":
            peer, _, rest = val.partition("@")
            window, _, n_s = rest.partition(":")
            t1s, _, t2s = window.partition("-")
            if not t2s:
                raise ValueError(
                    "flap needs a bounded window: flap=P@T1-T2[:N]")
            t1, t2 = float(t1s or 0.0), float(t2s)
            cycles = int(n_s or 3)
            if cycles < 1 or t2 <= t1:
                raise ValueError(f"bad flap window/cycles: {val!r}")
            # N down/up cycles of equal width: cycle i is DOWN for
            # [t1 + 2iW, t1 + (2i+1)W), up for the next W.
            w = (t2 - t1) / (2 * cycles)
            for i in range(cycles):
                a = t1 + 2 * i * w
                pending.append(lambda sd, tm, p=int(peer), a=a, b=a + w:
                               FaultRule("partition", "out", dest=p,
                                         t_start=a, t_end=b))
            continue
        if key == "kill_after":
            pending.append(lambda sd, tm, t=float(val):
                           FaultRule("kill", "out", t_start=t))
            continue
        if key == "join":
            pending.append(lambda sd, tm, t=float(val):
                           FaultRule("join", "out", t_start=t))
            continue
        if key == "leave":
            pending.append(lambda sd, tm, t=float(val):
                           FaultRule("leave", "out", t_start=t))
            continue
        if key == "slow":
            rate_s, _, peer = val.partition("@")
            pending.append(lambda sd, tm, r=int(rate_s),
                           p=(int(peer) if peer else None):
                           FaultRule("slow", "out",
                                     msg_type=MsgType.LAYER,
                                     dest=p, rate=r))
            continue
        if key == "slowserve":
            ms_s, _, n_s = val.partition(":")
            pending.append(lambda sd, tm, ms=float(ms_s),
                           n=int(n_s or 1): FaultRule(
                "delay", "out", msg_type=MsgType.GENERATE_RESP,
                every=n, times=tm, delay_s=ms / 1000.0))
            continue
        if key == "resetany":
            n = int(val)
            if n > 0:
                pending.append(lambda sd, tm, n=n: FaultRule(
                    "reset", "out", every=n, times=tm))
            continue
        if key == "drop-plan-seqs":
            for s in [x for x in val.split(";") if x.strip()]:
                pending.append(lambda sd, tm, s=int(s): FaultRule(
                    "drop", "in", msg_type=MsgType.DEVICE_PLAN,
                    seq=s, times=1))
            continue
        if key == "delay":
            n, _, ms = val.partition(":")
            if int(n) > 0:
                pending.append(lambda sd, tm, n=int(n),
                               ms=float(ms or 1.0): FaultRule(
                    "delay", "out", msg_type=MsgType.LAYER, every=n,
                    times=tm, delay_s=ms / 1000.0))
            continue
        if key in ("corrupt", "dropin", "drop", "dup", "reset"):
            n = int(val)
            if n <= 0:
                continue
            kind = {"dropin": "drop"}.get(key, key)
            direction = "in" if key in ("corrupt", "dropin") else "out"
            pending.append(lambda sd, tm, k=kind, d=direction, n=n:
                           FaultRule(k, d, msg_type=MsgType.LAYER,
                                     every=n, times=tm))
            continue
        raise ValueError(f"unknown fault spec key: {key!r}")
    return seed, [f(seed, times) for f in pending]


class FaultyTransport(Transport):
    """A seeded fault-injecting wrapper over any concrete transport.

    Send-side ("out") rules intercept ``send``/``broadcast``; inbound
    LAYER rules install a ``recv_tamper`` hook on the wrapped transport
    (so corruption lands BELOW the CRC check, exactly like the wire);
    inbound CONTROL rules run on a pump thread between the inner
    delivery queue and this transport's own — a dropped control message
    really vanishes.  Everything else (pipes, sinks, corruption
    reporting, addressing) delegates to the wrapped transport, so
    receivers wire their hooks through this wrapper unchanged."""

    def __init__(self, inner: Transport, rules=(), seed: int = 0):
        from ..utils.rate import TokenBucket

        self.inner = inner
        self.rules: List[FaultRule] = [
            r for r in rules
            if r.kind not in ("partition", "kill", "slow", "join",
                              "leave")]
        self.seed = seed
        self._lock = threading.Lock()
        self.stats = {"corrupt": 0, "drop": 0, "dup": 0, "delay": 0,
                      "reset": 0, "partition": 0, "kill": 0, "slow": 0,
                      "join": 0}
        # slow=RATE@P: a persistent per-link rate limit (token bucket),
        # not an every-Nth rule — the injected straggler link.
        self._slow = [(r.dest, TokenBucket(r.rate)) for r in rules
                      if r.kind == "slow" and r.rate > 0]
        self._q: "queue.Queue[Message]" = queue.Queue()
        self._stop = threading.Event()
        # Time-scheduled faults (docs/failover.md): the clock starts NOW,
        # so a spec's partition windows and kill time replay identically
        # run to run.
        self._t0 = time.monotonic()
        self._partitions = [(r.dest, r.t_start, r.t_end) for r in rules
                            if r.kind == "partition"]
        kills = [r.t_start for r in rules if r.kind == "kill"]
        self._kill_at = min(kills) if kills else None
        # Churn schedule (docs/membership.md): the node is DARK before
        # join_at (it does not exist yet); leave_at is purely an
        # exposed timestamp the harness drains the node at.  Both are
        # seconds since construction, like every time-scheduled fault.
        joins = [r.t_start for r in rules if r.kind == "join"]
        self.join_at = min(joins) if joins else None
        leaves = [r.t_start for r in rules if r.kind == "leave"]
        self.leave_at = min(leaves) if leaves else None
        need_tamper = (
            any(r.direction == "in" and r.msg_type in (None, MsgType.LAYER)
                for r in self.rules)
            or self._partitions or self._kill_at is not None
            or self.join_at is not None)
        if need_tamper:
            if hasattr(inner, "recv_tamper"):
                inner.recv_tamper = self._tamper
            else:
                log.warn("inner transport has no recv_tamper hook; "
                         "inbound layer faults will not fire")
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="fault-pump")
        self._pump.start()

    # ------------------------------------------------- time-scheduled faults

    def _killed(self) -> bool:
        return (self._kill_at is not None
                and time.monotonic() - self._t0 >= self._kill_at)

    def _dark(self) -> bool:
        """True before the join schedule says this node exists
        (docs/membership.md): sends raise, inbound vanishes — a seeded
        late joiner, invisible until its moment."""
        return (self.join_at is not None
                and time.monotonic() - self._t0 < self.join_at)

    def seconds_until_join(self):
        """Remaining dark time (None = no join schedule): the harness
        sleeps this long, then fires the seat's ``join()``."""
        if self.join_at is None:
            return None
        return max(0.0, self._t0 + self.join_at - time.monotonic())

    def seconds_until_leave(self):
        """Remaining time to the scheduled graceful drain (None = no
        leave schedule)."""
        if self.leave_at is None:
            return None
        return max(0.0, self._t0 + self.leave_at - time.monotonic())

    def _partitioned(self, peer) -> bool:
        """Whether traffic between this node and ``peer`` is currently
        inside an active partition window."""
        if peer is None or not self._partitions:
            return False
        now = time.monotonic() - self._t0
        for p, t1, t2 in self._partitions:
            if p == peer and now >= t1 and (t2 is None or now < t2):
                return True
        return False

    # ------------------------------------------------------------ matching

    def _fire(self, kind: str, direction: str, mtype, layer=None,
              seq=None, dest=None, src=None, offset=None,
              size=None) -> Optional[FaultRule]:
        """The first rule of ``kind``/``direction`` matching this event
        that elects to fire (counters advance under the lock)."""
        with self._lock:
            for r in self.rules:
                if r.kind != kind or r.direction != direction:
                    continue
                if not r._matches_common(mtype, layer, seq):
                    continue
                if direction == "out" and r.dest is not None and dest != r.dest:
                    continue
                if direction == "in" and r.src is not None and src != r.src:
                    continue
                if offset is not None and size is not None:
                    if offset + size <= r.offset_lo or offset >= r.offset_hi:
                        continue
                if r.should_fire(self.seed):
                    self.stats[kind] = self.stats.get(kind, 0) + 1
                    return r
        return None

    # ------------------------------------------------------------- inbound

    def _tamper(self, info: dict, view) -> bool:
        """The wrapped transport's receive-path hook: corrupt or drop a
        landed layer frame BEFORE its CRC verification.  Returning False
        injects a drop (the transport treats it exactly like a CRC
        failure: rollback + NACK)."""
        layer = info.get("layer")
        src = info.get("src")
        off = info.get("offset", 0)
        size = info.get("size", len(view))
        if self._killed():
            with self._lock:
                self.stats["kill"] += 1
            return False  # hard-stopped transport: nothing lands
        if self._dark():
            with self._lock:
                self.stats["join"] += 1
            return False  # not joined yet: nothing lands
        if self._partitioned(src):
            with self._lock:
                self.stats["partition"] += 1
            log.warn("FAULT: partition dropping inbound layer frame",
                     layerID=layer, src=src)
            return False
        if self._fire("drop", "in", MsgType.LAYER, layer=layer, src=src,
                      offset=off, size=size) is not None:
            log.warn("FAULT: dropping inbound layer frame", layerID=layer,
                     offset=off, size=size)
            return False
        rule = self._fire("corrupt", "in", MsgType.LAYER, layer=layer,
                          src=src, offset=off, size=size)
        if rule is not None and len(view) > 0:
            at = rule.flip_at % len(view)
            view[at] = view[at] ^ (rule.flip_mask or 0xFF)
            log.warn("FAULT: corrupted inbound layer frame", layerID=layer,
                     offset=off, size=size, at=at)
        return True

    def _pump_loop(self) -> None:
        inner_q = self.inner.deliver()
        while not self._stop.is_set():
            try:
                msg = inner_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._killed():
                with self._lock:
                    self.stats["kill"] += 1
                continue  # hard-stopped: inbound vanishes
            if self._dark():
                with self._lock:
                    self.stats["join"] += 1
                continue  # not joined yet: inbound vanishes
            if not isinstance(msg, LayerMsg):
                src = getattr(msg, "src_id", None)
                if self._partitioned(src):
                    with self._lock:
                        self.stats["partition"] += 1
                    log.warn("FAULT: partition dropping inbound control "
                             "message", kind=type(msg).__name__, src=src)
                    continue
                mtype = getattr(msg, "msg_type", None)
                seq = (msg.seq if isinstance(msg, DevicePlanMsg) else None)
                if self._fire("drop", "in", mtype, seq=seq,
                              src=src) is not None:
                    log.warn("FAULT: dropping inbound control message",
                             kind=type(msg).__name__, seq=seq)
                    continue
            self._q.put(msg)

    # ----------------------------------------------------------- transport

    def send(self, dest_id: NodeID, message: Message) -> None:
        mtype = getattr(message, "msg_type", None)
        layer = getattr(message, "layer_id", None)
        seq = (message.seq if isinstance(message, DevicePlanMsg) else None)
        if self._killed():
            with self._lock:
                self.stats["kill"] += 1
            raise ConnectionError("injected fault: transport killed")
        if self._dark():
            with self._lock:
                self.stats["join"] += 1
            raise ConnectionError("injected fault: node not joined yet")
        if self._partitioned(dest_id):
            with self._lock:
                self.stats["partition"] += 1
            log.warn("FAULT: partition dropping outbound message",
                     kind=type(message).__name__, dest=dest_id)
            return
        if self._fire("drop", "out", mtype, layer=layer, seq=seq,
                      dest=dest_id) is not None:
            log.warn("FAULT: dropping outbound message",
                     kind=type(message).__name__, dest=dest_id)
            return
        if self._fire("reset", "out", mtype, layer=layer, seq=seq,
                      dest=dest_id) is not None:
            log.warn("FAULT: injecting connection reset on send",
                     kind=type(message).__name__, dest=dest_id)
            raise ConnectionError("injected fault: peer reset")
        rule = self._fire("delay", "out", mtype, layer=layer, seq=seq,
                          dest=dest_id)
        if rule is not None:
            time.sleep(rule.delay_s)
        if self._slow and isinstance(message, LayerMsg):
            size = getattr(message.layer_src, "data_size", 0)
            for peer, bucket in self._slow:
                if peer is None or peer == dest_id:
                    with self._lock:
                        self.stats["slow"] += 1
                    bucket.wait_n(size)
        self.inner.send(dest_id, message)
        if self._fire("dup", "out", mtype, layer=layer, seq=seq,
                      dest=dest_id) is not None:
            log.warn("FAULT: duplicating outbound message",
                     kind=type(message).__name__, dest=dest_id)
            self.inner.send(dest_id, message)

    def broadcast(self, message: Message) -> None:
        # Broadcasts bypass per-dest out rules on purpose: they carry
        # run-wide control (startup, serve) whose loss has no protocol
        # recovery; targeted faults go through send().
        self.inner.broadcast(message)

    def register_pipe(self, layer_id: LayerID, dest_id: NodeID) -> None:
        self.inner.register_pipe(layer_id, dest_id)

    def deliver(self) -> "queue.Queue[Message]":
        return self._q

    def get_address(self) -> str:
        return self.inner.get_address()

    def close(self) -> None:
        self._stop.set()
        self.inner.close()

    # Hook pass-throughs: receivers set these on "the transport" without
    # caring whether it is wrapped.
    @property
    def layer_sink(self):
        return getattr(self.inner, "layer_sink", None)

    @layer_sink.setter
    def layer_sink(self, fn) -> None:
        self.inner.layer_sink = fn

    @property
    def on_corrupt(self):
        return getattr(self.inner, "on_corrupt", None)

    @on_corrupt.setter
    def on_corrupt(self, fn) -> None:
        self.inner.on_corrupt = fn

    @property
    def addr_registry(self):
        return self.inner.addr_registry

    @property
    def node_id(self):
        return getattr(self.inner, "node_id", None)

    @node_id.setter
    def node_id(self, value) -> None:
        # The INNER transport does the per-frame telemetry accounting
        # (utils/telemetry.py), so the node identity must land there.
        self.inner.node_id = value
