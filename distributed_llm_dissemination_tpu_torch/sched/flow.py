"""Max-flow optimal dissemination scheduler (mode 3's brain).

Re-design of the reference's flow solver
(``distributor/flow.go``): model dissemination as a
time-parameterized max-flow problem over a six-level graph

    source → sender → per-sender source-class ("client") → layer → receiver → sink

with capacities scaled by a candidate completion time ``t``:
``src→sender`` = sender NIC bandwidth × t; ``sender→class`` = that source
class's rate limit × t; ``class→layer`` = ∞; ``layer→receiver`` = layer
size; ``receiver→sink`` = receiver NIC bandwidth × t.  Exponential search
finds a feasible ``t``, binary search minimizes it, and the residual flows
on the class→layer edges decompose into per-sender byte-range jobs
(offset + size) — the multi-sender split of one layer
(flow.go:146-218).

Deviations from the reference, on purpose:
- A sender whose source class has rate limit 0 ("unlimited") gets its NIC
  bandwidth as the class capacity instead of a zero-capacity (unusable)
  edge.
- The completion-time search runs in MILLISECONDS (the reference searches
  integer seconds, flow.go:155-187, so every sub-second plan is padded to
  1 s and its jobs paced ~1000× too slow — a v5e-pod-scale dissemination
  targeting <10 s can't live with 1 s granularity).  Capacities are
  ``rate × t // 1000`` — floor keeps them integral and monotone in t, so
  the exponential+binary search is unchanged in shape.

TPU topology (``PodTopology``): the reference models only per-node NIC
bandwidth (flow.go:221-270) — adequate for a flat datacenter LAN, wrong
for a multi-slice pod where intra-slice bytes ride ICI but cross-slice
bytes share a thin DCN path.  The per-(A,B) DCN capacity is a BUNDLE
constraint over the (sender→dest) arcs crossing that slice pair, which a
plain single-commodity flow graph cannot carry exactly (flow through a
shared edge loses its (sender, layer) labels).  Two solvers:

- **Exact (scipy present)**: the schedule at candidate time ``t`` is a
  small LP — one variable per admissible (sender-class, layer, dest)
  arc, per-class/per-NIC/per-demand/per-DCN-pair row constraints,
  maximize delivered bytes (HiGHS).  The usual exponential+binary time
  search runs over LP feasibility; the final solution rounds to an
  exact byte tiling.
- **Fallback (no scipy)**: the graph grows one capacity edge per
  ordered slice pair (``xin(A,B) → xout(A,B)``); cross-slice flow routes
  through it, and after max-flow the pair's aggregate flow is
  re-attributed along true holdings by a transportation max-flow.  The
  relaxation can pick unattributable flows on adversarial holdings —
  then the solver logs and replans flat (NIC-only) rather than emit an
  invalid tiling.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..core.types import (
    Assignment,
    LayerID,
    NodeID,
    Status,
    codec_accepts,
    shard_covers,
    shard_range,
)
from ..utils import trace
from ..utils.logging import log

_INF = 1 << 62

# Completion time is searched in milliseconds; rates stay bytes/second.
TIME_SCALE = 1000


def rate_for(data_size: int, t_ms: int) -> int:
    """Bytes/second pacing budget for ``data_size`` over ``t_ms``."""
    return data_size * TIME_SCALE // max(1, t_ms)


def pick_salvage_source(status: Status, layer_id: LayerID,
                        exclude=frozenset(),
                        need_shard: str = "",
                        need_codec: str = "",
                        encoders=frozenset()) -> Optional[NodeID]:
    """The surviving holder a dest should re-fetch a dead source's
    unsent byte ranges from (runtime/leader range salvage,
    docs/failover.md): fastest modeled source rate first (0 =
    unlimited), lowest node id as the deterministic tiebreak.  Client-
    held copies can't serve byte-range NACK retransmits, so they never
    qualify; neither does a shard-holder whose shard doesn't cover the
    range being salvaged (``need_shard`` — "" means the whole layer is
    needed, so only full holders qualify).  ``need_codec``
    (docs/codec.md): the transfer's wire-codec form — a holder
    qualifies only when it holds that exact encoded form, or holds
    canonical bytes AND can encode (a member of ``encoders``): the
    salvage ranges index the encoded blob, and a holder that can't
    reproduce those exact bytes would serve garbage as verified-looking
    frames.  None = no qualified survivor — the caller falls back to a
    whole-layer re-plan."""
    from ..core.types import LayerLocation

    best: Optional[NodeID] = None
    best_rate = -1
    for nid in sorted(status):
        if nid in exclude:
            continue
        meta = status[nid].get(layer_id)
        if meta is None or meta.location == LayerLocation.CLIENT:
            continue
        if not shard_covers(meta.shard, need_shard):
            continue
        held_codec = getattr(meta, "codec", "")
        if held_codec:
            if held_codec != need_codec:
                continue
        elif need_codec and nid not in encoders:
            continue
        rate = meta.limit_rate if meta.limit_rate != 0 else _INF
        if rate > best_rate:
            best, best_rate = nid, rate
    return best


def pod_shard_demands(
    assignment: Assignment,
    pods: Dict[int, List[NodeID]],
    prior: Optional[Dict[Tuple[LayerID, NodeID], str]] = None,
) -> Dict[Tuple[LayerID, NodeID], str]:
    """Fabric-assisted pod delivery's demand transform (docs/fabric.md):
    price ONE shard-sized ingress demand per pod host instead of a full
    raw layer per replica.

    For every pod whose members ALL want layer ``L`` as a plain full
    target (no shard/version — a codec choice is preserved: the shard
    then slices the ENCODED blob, and ``codec_sizes`` prices it), each
    member's target becomes its ``1/R@k`` slice (rank = position among
    the pod's wanting members, sorted by node id), so the pod's total
    NIC ingress for the layer is ~model_bytes (x codec ratio) instead
    of model_bytes x R — the remaining R-1 copies materialize over ICI
    (``parallel.collectives.gather_byte_shards``).  Members whose
    codec CHOICES disagree for a layer are never pod-sliced: the
    slices must all index ONE wire byte space, or the gather would
    splice mismatched encodings.

    VERSION-qualified pairs (swap/rollout waves, docs/rollout.md) ride
    the transform like any other full target when the pod's wanting
    members all carry the SAME version for the layer — the slices then
    reconstruct one version's bytes, and the shard×codec digest
    machinery (encoded range stamps) applies unchanged.  A pod whose
    members want DIFFERENT versions of one layer id is refused loudly
    (``pod.mixed_version_layers`` counter): its slices would splice two
    checkpoints into one gathered blob, so those members keep whole-
    layer targets instead.  Pre-SHARDED pairs still never re-slice.

    ``prior``: the pod pairs of an earlier transform this re-plan must
    keep VERBATIM (mid-flight partials live in those specs' byte
    ranges; membership churn degrades pairs explicitly, never by a
    silent re-shard).  Mutates nothing: returns the full pod-pair map
    {(layer, dest): spec} (prior ∪ new) — the caller stamps the specs
    onto its own assignment metas."""
    prior = prior or {}
    pod_pairs: Dict[Tuple[LayerID, NodeID], str] = dict(prior)
    for pid in sorted(pods):
        members = sorted(pods[pid])
        layers = sorted({lid for m in members
                         for lid in (assignment.get(m) or {})})
        for lid in layers:
            if any((lid, m) in prior for m in members):
                continue  # already transformed; specs must stay stable
            wanting = []
            codecs = set()
            versions = set()
            for m in members:
                meta = (assignment.get(m) or {}).get(lid)
                if meta is None:
                    continue
                if meta.shard:
                    wanting = []
                    break  # pre-sharded pair: the pod must not re-slice
                codecs.add(getattr(meta, "codec", ""))
                versions.add(getattr(meta, "version", ""))
                wanting.append(m)
            if len(versions) > 1:
                # Mixed versions of one layer id inside one pod: the
                # R slices would splice two checkpoints into one
                # gathered blob.  Refuse the transform — loudly — and
                # leave these members on whole-layer targets.
                trace.count("pod.mixed_version_layers")
                log.warn("pod layer not shard-planned: members want "
                         "mixed versions", pod=pid, layerID=lid,
                         versions=sorted(versions))
                continue
            if len(wanting) < 2 or len(codecs) > 1:
                continue  # nothing to amortize, or mixed byte spaces
            n = len(wanting)
            for k, m in enumerate(wanting):
                pod_pairs[(lid, m)] = f"1/{n}@{k}"
    return pod_pairs


def group_stripe_ranges(base: int, size: int,
                        stripes: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal stripe ranges over ``[base, base+size)`` —
    the same floor-cut construction as the transport's striping, so
    a chain stripe's boundaries line up with how fragments already land
    (docs/hierarchy.md).  Degenerate inputs collapse safely: at most
    ``size`` stripes, at least one."""
    if size <= 0:
        return []
    k = max(1, min(int(stripes), size))
    cuts = [base + (size * i) // k for i in range(k + 1)]
    return [(cuts[i], cuts[i + 1])
            for i in range(k) if cuts[i + 1] > cuts[i]]


def chain_forward_roles(
    members: List[NodeID], base: int, size: int, stripes: int,
) -> Tuple[List[Tuple[NodeID, Tuple[int, int]]],
           Dict[NodeID, List[Tuple[int, int, NodeID]]]]:
    """K-striped pipelined broadcast over ``members`` (arXiv:2408.13356's
    bandwidth-optimal construction, docs/hierarchy.md): stripe ``k``
    roots at member ``k % R`` and rides a rotated ring, so with K ≥ R
    every member heads ~K/R stripes, tails ~K/R, and forwards the rest —
    per-member egress ≈ (R−1)/R × ``size`` and the source (sub-leader)
    sends each byte exactly once.

    Returns ``(heads, roles)``: ``heads`` = the source's seed sends,
    one ``(member, (lo, hi))`` per stripe; ``roles`` = ``{member:
    [(lo, hi, next_member), ...]}`` forward hops (non-tail positions
    only).  Byte offsets are in the transfer's WIRE space — the caller
    passes the encoded blob size for codec pairs and the shard range
    for sharded ones, so chains compose with both."""
    ms = [int(m) for m in members]
    r = len(ms)
    heads: List[Tuple[NodeID, Tuple[int, int]]] = []
    roles: Dict[NodeID, List[Tuple[int, int, NodeID]]] = {m: [] for m in ms}
    if not ms:
        return heads, roles
    for k, (lo, hi) in enumerate(group_stripe_ranges(base, size, stripes)):
        chain = [ms[(k + i) % r] for i in range(r)]
        heads.append((chain[0], (lo, hi)))
        for up, down in zip(chain, chain[1:]):
            roles[up].append((lo, hi, down))
    return heads, roles


@dataclasses.dataclass(frozen=True)
class PodTopology:
    """Multi-slice pod shape for the flow solve.

    ``slice_of``: node → slice index (a slice = one ICI domain, e.g. a
    v5e-32 slice; nodes of one slice exchange bytes over ICI).
    ``dcn_bw``: bytes/s available to EACH ordered slice pair over the
    data-center network (the thin path the solver must route around).
    Per-node rates (NIC or ``Mesh.IciBW``) still cap the endpoints.

    ``slice_shape`` + ``ici_link_bw`` (SURVEY §7 hard part):
    model each slice's INTERIOR as a torus of per-link capacities
    instead of one scalar per-node rate.  A slice's members (sorted by
    node id) occupy torus coordinates row-major into ``slice_shape``;
    an intra-slice transfer consumes ``ici_link_bw`` capacity on every
    directed link of its dimension-ordered (shorter-wrap, ties upward)
    route.  The exact LP carries one bundle constraint per directed
    link, so a plan provably spreads across links — a sender whose
    route shares a hot link gets fewer bytes (the reference's flat
    model, flow.go:221-270, cannot see this).  Cross-slice arcs are
    capped by the DCN pair edge only (their intra-slice hops to the
    egress are not modeled)."""

    slice_of: Tuple[Tuple[NodeID, int], ...]  # sorted (node, slice) pairs
    dcn_bw: int
    slice_shape: Tuple[int, ...] = ()
    ici_link_bw: int = 0

    @classmethod
    def make(cls, slice_of: Dict[NodeID, int], dcn_bw: int,
             slice_shape=(), ici_link_bw: int = 0) -> "PodTopology":
        topo = cls(tuple(sorted(slice_of.items())), dcn_bw,
                   tuple(int(s) for s in slice_shape), int(ici_link_bw))
        if topo.torus_modeled():
            cells = 1
            for s in topo.slice_shape:
                if s <= 0:
                    raise ValueError(f"bad slice_shape {topo.slice_shape}")
                cells *= s
            counts: Dict[int, int] = {}
            for _, sl in topo.slice_of:
                counts[sl] = counts.get(sl, 0) + 1
            for sl, n in counts.items():
                if n > cells:
                    raise ValueError(
                        f"slice {sl} has {n} nodes but slice_shape "
                        f"{topo.slice_shape} holds only {cells}")
        return topo

    def slices(self) -> Dict[NodeID, int]:
        return dict(self.slice_of)

    def torus_modeled(self) -> bool:
        return bool(self.slice_shape) and self.ici_link_bw > 0

    def _coord(self, node: NodeID) -> Tuple[int, Tuple[int, ...]]:
        """(slice, torus coordinates) of a node: its rank among the
        slice's sorted members, row-major into ``slice_shape``."""
        by_slice: Dict[int, List[NodeID]] = {}
        for n, sl in self.slice_of:
            by_slice.setdefault(sl, []).append(n)
        sl = dict(self.slice_of)[node]
        rank = by_slice[sl].index(node)  # slice_of is sorted
        coord = []
        for dim in reversed(self.slice_shape):
            coord.append(rank % dim)
            rank //= dim
        return sl, tuple(reversed(coord))

    def ici_path(self, sender: NodeID, dest: NodeID) -> Tuple:
        """Directed torus links of the sender→dest route (dimension
        order; per dimension the shorter wrap direction, ties upward).
        Link key: ``(slice, from_flat, to_flat)``.  Empty when the
        torus isn't modeled, endpoints differ in slice, either endpoint
        is unmapped, or sender == dest."""
        if not self.torus_modeled() or sender == dest:
            return ()
        mapping = dict(self.slice_of)
        if sender not in mapping or dest not in mapping:
            return ()
        sl_a, a = self._coord(sender)
        sl_b, b = self._coord(dest)
        if sl_a != sl_b:
            return ()

        def flat(c: Tuple[int, ...]) -> int:
            out = 0
            for v, dim in zip(c, self.slice_shape):
                out = out * dim + v
            return out

        links = []
        cur = list(a)
        for axis, dim in enumerate(self.slice_shape):
            delta = (b[axis] - cur[axis]) % dim
            step = 1 if delta * 2 <= dim else -1
            hops = delta if step == 1 else dim - delta
            for _ in range(hops):
                frm = flat(tuple(cur))
                cur[axis] = (cur[axis] + step) % dim
                links.append((sl_a, frm, flat(tuple(cur))))
        return tuple(links)


@dataclasses.dataclass
class FlowJob:
    """One partial-layer send command (flow.go:30-39), extended with the
    destination — the reference supports only one dest per layer
    (node.go:1078); carrying the dest on the job lifts that.

    ``job_id`` tags the admitted dissemination job this send serves
    (docs/service.md; "" = the base single-run goal) — it rides the
    dispatch command onto the wire so link telemetry can split per
    job."""

    sender_id: NodeID
    layer_id: LayerID
    data_size: int
    offset: int
    dest_id: NodeID  # required: dispatch trusts it unconditionally
    job_id: str = ""


# sender -> its jobs
FlowJobsMap = Dict[NodeID, List[FlowJob]]


# The preemption floor: a lower priority tier keeps at least 1/16 of
# every node's bandwidth even when higher tiers booked it all — weighted
# preemption, not absolute starvation, so every admitted job always gets
# a feasible (if slow) plan and completes without waiting for a
# completion-triggered re-plan that mode 3 doesn't have.
PREEMPT_FLOOR_SHIFT = 4


def solve_joint(
    demands,
    status: Status,
    layer_sizes: Dict[LayerID, int],
    node_network_bw: Dict[NodeID, int],
    remaining: Optional[Dict[Tuple[LayerID, NodeID], int]] = None,
    topology: Optional["PodTopology"] = None,
    graph_factory=None,
    codec_sizes: Optional[Dict[Tuple[LayerID, str], int]] = None,
    node_codecs: Optional[Dict[NodeID, frozenset]] = None,
    base_holders: Optional[Dict[str, frozenset]] = None,
    link_demotions: Optional[Dict[Tuple[NodeID, NodeID], int]] = None,
) -> Tuple[Dict[int, int], FlowJobsMap]:
    """All active jobs' remaining demands as ONE flow problem per
    priority tier (docs/service.md) — the multi-job generalization of a
    single ``FlowGraph.get_job_assignment`` call.

    ``demands``: ``[(priority, job_id, assignment), ...]`` or
    ``[(priority, job_id, assignment, avoid_sources), ...]`` — each
    entry one job's remaining (dest → layers) demand; ``avoid_sources``
    (a set of node ids) excludes those nodes as SENDERS for this job's
    tier (the repair-refill policy: spare the busy origin seeder when
    current holders can serve), falling back to all sources — loudly —
    if avoidance leaves the tier undeliverable.

    Tiers solve in DESCENDING priority order; each tier sees the node
    bandwidths minus the rates already committed to higher tiers
    (bytes/t of the tier's own plan) — floored at 1/2^4 of each node's
    bandwidth (``PREEMPT_FLOOR_SHIFT``), so a high-priority job preempts
    by reclaiming link budget at the re-plan while lower tiers are
    slowed, never starved.  EQUAL priorities (with equal avoid sets)
    merge into one graph — the max-flow's fair share over the common
    links is the measured capacity split between them.  A (dest,
    layer/shard) pair two jobs both want is planned ONCE — within a
    tier AND across tiers (a lower tier never re-ships bytes a higher
    tier already planned this solve when the planned shard covers its
    target; the ack credits every job wanting the pair) — attributed to
    the first-planning tier's lexically-first job id and counted on
    ``jobs.deduped_pairs``.

    Returns ``({priority: tier_min_time_ms}, jobs)`` with every emitted
    ``FlowJob`` tagged by its owning job id.  Multiple avoid-groups at
    one priority report the group max under that priority key."""
    factory = graph_factory if graph_factory is not None else FlowGraph
    remaining = remaining or {}
    tiers: Dict[Tuple[int, Tuple[NodeID, ...]],
                List[Tuple[str, Assignment]]] = {}
    for entry in demands:
        prio, jid, asg = entry[0], entry[1], entry[2]
        avoid = tuple(sorted(entry[3])) if len(entry) > 3 and entry[3] \
            else ()
        tiers.setdefault((int(prio), avoid), []).append((str(jid), asg))
    from ..utils import trace

    used_rate: Dict[NodeID, int] = {}
    out_jobs: FlowJobsMap = {}
    t_by_prio: Dict[int, int] = {}
    # (layer, dest) -> (shard spec, codec) already planned by a HIGHER
    # tier this solve: the cross-tier in-flight dedup (docs/service.md
    # "remaining openings") — one delivery satisfies every job wanting
    # the pair.  Codec-qualified: a pair planned quantized never dedups
    # a raw want (different bytes — docs/codec.md); in practice all
    # tiers read one meta per (dest, layer) from the merged goal, so
    # the qualifier is a guard, not a divergence source.
    planned_pairs: Dict[Tuple[LayerID, NodeID], Tuple[str, str]] = {}
    # Descending priority; within one priority, the un-avoiding group
    # first (deterministic).
    for prio, avoid in sorted(tiers, key=lambda k: (-k[0], k[1])):
        merged: Assignment = {}
        owner: Dict[Tuple[LayerID, NodeID], str] = {}
        for jid, asg in sorted(tiers[(prio, avoid)], key=lambda x: x[0]):
            for dest, lids in asg.items():
                row = merged.setdefault(dest, {})
                for lid, meta in lids.items():
                    spec = getattr(meta, "shard", "")
                    codec = getattr(meta, "codec", "")
                    prior = planned_pairs.get((lid, dest))
                    if (prior is not None and shard_covers(prior[0], spec)
                            and codec_accepts(prior[1], codec)):
                        # A higher tier already ships (>=) these bytes
                        # to this dest; the ack will credit this job
                        # too — planning it again would be duplicate
                        # in-flight wire bytes.
                        trace.count("jobs.deduped_pairs")
                        log.info("cross-tier dedup: pair already "
                                 "planned by a higher tier this solve",
                                 layerID=lid, dest=dest, job=jid)
                        continue
                    held = row.get(lid)
                    if held is None:
                        row[lid] = meta
                        owner[(lid, dest)] = jid
                    elif shard_covers(getattr(held, "shard", ""), spec):
                        trace.count("jobs.deduped_pairs")
                    elif shard_covers(spec, getattr(held, "shard", "")):
                        # The wider target subsumes the narrower one.
                        row[lid] = meta
                    else:
                        # Two jobs want DISJOINT shards of one (dest,
                        # layer): a single spec can't name the union, so
                        # widen to the full layer — over-delivery is
                        # safe, under-delivery wedges a job.
                        row[lid] = dataclasses.replace(meta, shard="")
        if not merged:
            continue
        bw_res = {n: max(bw - used_rate.get(n, 0),
                         bw >> PREEMPT_FLOOR_SHIFT)
                  for n, bw in node_network_bw.items()}
        rem = {(lid, dest): v for (lid, dest), v in remaining.items()
               if lid in merged.get(dest, {})}

        def _pair_bytes(lid: LayerID, dest: NodeID, meta) -> int:
            v = rem.get((lid, dest))
            if v is not None:
                return v
            codec = getattr(meta, "codec", "")
            total = ((codec_sizes or {}).get((lid, codec))
                     if codec else None)
            if total is None:
                total = layer_sizes.get(lid, 0)
            spec = getattr(meta, "shard", "")
            return shard_range(spec, total)[1] if spec else total

        required = sum(
            _pair_bytes(lid, dest, meta)
            for dest, lids in merged.items() for lid, meta in lids.items())
        status_view = status
        if avoid:
            status_view = {n: row for n, row in status.items()
                           if n not in set(avoid)}
        graph = factory(merged, status_view, layer_sizes, bw_res,
                        remaining=rem, topology=topology,
                        codec_sizes=codec_sizes, node_codecs=node_codecs,
                        base_holders=base_holders,
                        link_demotions=link_demotions)
        t, jobs = graph.get_job_assignment()
        planned = sum(j.data_size for jl in jobs.values() for j in jl)
        if avoid and planned < required:
            # Avoidance starved the tier (the spared seeder was the
            # only holder of something): deliverability beats the
            # politeness policy — replan over every source, loudly.
            log.warn("avoid_sources left a tier undeliverable; "
                     "replanning over all sources", priority=prio,
                     avoided=list(avoid), planned=planned,
                     required=required)
            graph = factory(merged, status, layer_sizes, bw_res,
                            remaining=rem, topology=topology,
                            codec_sizes=codec_sizes,
                            node_codecs=node_codecs,
                            base_holders=base_holders,
                            link_demotions=link_demotions)
            t, jobs = graph.get_job_assignment()
        t_by_prio[prio] = max(t_by_prio.get(prio, 0), t)
        per_dest: Dict[NodeID, int] = {}
        for sender, job_list in jobs.items():
            sent = 0
            for job in job_list:
                job.job_id = owner.get((job.layer_id, job.dest_id), "")
                out_jobs.setdefault(sender, []).append(job)
                sent += job.data_size
                per_dest[job.dest_id] = (per_dest.get(job.dest_id, 0)
                                         + job.data_size)
            if t > 0:
                # This tier's plan consumes sender NIC at bytes/t for
                # its duration; the next (lower) tier plans over the
                # residue — the preemption mechanism.
                used_rate[sender] = (used_rate.get(sender, 0)
                                     + sent * TIME_SCALE // max(1, t))
        if t > 0:
            for dest, nbytes in per_dest.items():
                used_rate[dest] = (used_rate.get(dest, 0)
                                   + nbytes * TIME_SCALE // max(1, t))
        # Record this tier's planned pairs (shard- and codec-qualified)
        # so LOWER tiers dedup against them instead of re-shipping
        # in-flight bytes.  First (highest) tier's spec stands — the
        # dedup test is coverage, not equality.
        for dest, lids in merged.items():
            for lid, meta in lids.items():
                planned_pairs.setdefault(
                    (lid, dest), (getattr(meta, "shard", ""),
                                  getattr(meta, "codec", "")))
        log.info("joint tier solved", priority=prio, min_time_ms=t,
                 jobs=sorted({jid for jid, _ in tiers[(prio, avoid)]}),
                 avoided=list(avoid))
    return t_by_prio, out_jobs


def _search_min_time(feasible, lo: int = 1):
    """Smallest feasible t >= lo (exponential doubling + binary search —
    the reference's search shape, flow.go:155-187, shared by the flat,
    relaxed-seed, and LP paths so they can't drift).  Returns (t, True),
    or (t_stop, False) when nothing up to ~_INF/2 is feasible — the
    caller degrades immediately instead of binary-searching a range the
    doubling already proved infeasible."""
    t = max(1, lo)
    while not feasible(t):
        if t > _INF // 2:
            return t, False
        t *= 2
    lo_b, hi, best = max(1, lo), t, t
    while lo_b <= hi:
        mid = (lo_b + hi) // 2
        if feasible(mid):
            best = min(best, mid)
            hi = mid - 1
        else:
            lo_b = mid + 1
    return best, True


def _have_lp() -> bool:
    try:
        from scipy.optimize import linprog  # noqa: F401
    except Exception:  # noqa: BLE001 — scipy is optional
        return False
    return True


_warmed = False


def warm_lp() -> None:
    """Pre-initialize the LP solver stack off the critical path.

    The first ``linprog`` call in a process pays ~2 s of one-time cost
    (scipy.optimize import machinery + HiGHS initialization); the warm
    solve is ~75 ms.  A mode-3 leader with a ``PodTopology`` calls this
    from a daemon thread at startup, so by the time receivers have
    announced and the real solve runs, the cost has overlapped with
    fabrication/dial/announce instead of landing inside TTD.
    Idempotent and safe to call from any thread (the work is behind
    Python's import lock + a module flag)."""
    global _warmed
    if _warmed or not _have_lp():
        return
    try:
        from scipy.optimize import linprog
        from scipy.sparse import csr_matrix

        a = csr_matrix(([1.0], ([0], [0])), shape=(1, 1))
        linprog([-1.0], A_ub=a, b_ub=[1.0], bounds=(0, None),
                method="highs")
        _warmed = True
    except Exception as e:  # noqa: BLE001 — warmup is advisory
        log.warn("LP warmup failed; first topology solve runs cold",
                 err=repr(e))


def _transport(supplies, demands, admissible):
    """Tiny transportation max-flow: split ``supplies`` (key, amount)
    onto ``demands`` (key, amount) along ``admissible(sup_key, dem_key)``
    arcs.  Returns [(sup_key, dem_key, amount), ...] saturating every
    supply, or None if the arcs can't absorb the totals (a Hall
    violation).  Deterministic: Edmonds–Karp over sorted inputs."""
    ns, nd = len(supplies), len(demands)
    n = ns + nd + 2
    src, sink = n - 2, n - 1
    cap = [[0] * n for _ in range(n)]
    for i, (_, amt) in enumerate(supplies):
        cap[src][i] = amt
    for j, (_, amt) in enumerate(demands):
        cap[ns + j][sink] = amt
    for i, (skey, _) in enumerate(supplies):
        for j, (dkey, _) in enumerate(demands):
            if admissible(skey, dkey):
                cap[i][ns + j] = _INF
    total = sum(amt for _, amt in supplies)
    pushed = 0
    while True:
        parent = [-1] * n
        parent[src] = src
        q = deque([src])
        while q:
            u = q.popleft()
            for v in range(n):
                if parent[v] < 0 and cap[u][v] > 0:
                    parent[v] = u
                    q.append(v)
        if parent[sink] < 0:
            break
        path_flow = _INF
        v = sink
        while v != src:
            path_flow = min(path_flow, cap[parent[v]][v])
            v = parent[v]
        pushed += path_flow
        v = sink
        while v != src:
            cap[parent[v]][v] -= path_flow
            cap[v][parent[v]] += path_flow
            v = parent[v]
    if pushed < total:
        return None
    out = []
    for i, (skey, _) in enumerate(supplies):
        for j, (dkey, _) in enumerate(demands):
            f = cap[ns + j][i]  # reverse residual = assigned amount
            if f > 0:
                out.append((skey, dkey, f))
    return out


@dataclasses.dataclass(frozen=True)
class _V:
    """Flow-graph vertex key (flow.go:23-28).  Unlike the reference, a
    "layer" vertex is per (layer, dest) pair — that is what lets one
    layer be scheduled to multiple receivers (each needing its own full
    copy) while per-sender flows stay attributable.

    For the topology vertices ``xin``/``xout`` (the two halves of one
    slice-pair DCN capacity edge), ``node_id`` carries the source slice
    and ``layer_id`` the dest slice."""

    kind: str  # source | sender | class | layer | receiver | xin | xout | sink
    node_id: NodeID = 0  # sender/receiver id; for "layer": the dest
    layer_id: LayerID = 0
    source_type: int = 0


class FlowGraph:
    """Edmonds–Karp over an adjacency matrix, rebuilt per candidate time
    (flow.go:43-144, 221-353).  Vertex indexing is deterministic (sorted
    iteration) so schedules are reproducible across runs."""

    def __init__(
        self,
        assignment: Assignment,
        status: Status,
        layer_sizes: Dict[LayerID, int],
        node_network_bw: Dict[NodeID, int],
        remaining: Optional[Dict[Tuple[LayerID, NodeID], int]] = None,
        topology: Optional[PodTopology] = None,
        codec_sizes: Optional[Dict[Tuple[LayerID, str], int]] = None,
        node_codecs: Optional[Dict[NodeID, frozenset]] = None,
        base_holders: Optional[Dict[str, frozenset]] = None,
        link_demotions: Optional[Dict[Tuple[NodeID, NodeID], int]] = None,
    ):
        """``remaining``: optional per-(layer, dest) byte overrides — a
        resumed dest needs only its gap bytes, not the full layer.
        ``topology``: multi-slice shape; cross-slice flow then shares the
        per-pair DCN capacity edges (module docstring).

        Wire codecs (docs/codec.md): a pair whose assignment meta names
        a codec is sized by its ENCODED bytes — ``codec_sizes`` maps
        (layer, codec) to the exact wire size (quant.blob_nbytes_codec)
        — which is the demand-side formulation of "a quantized copy's
        effective link capacity is bandwidth x (raw/encoded)": moving E
        encoded bytes at link rate B takes E/B = raw/(B x ratio)
        seconds, so budgets, predictions, and tier preemption all
        shrink by the compression ratio with the link model untouched.
        ``node_codecs`` maps sender → the codecs it can ENCODE; arc
        admissibility (``_arc_ok``) then guarantees a quantized pair is
        only ever planned from a same-codec holder (encoded bytes serve
        verbatim) or a raw holder that can encode — and a quantized
        HOLDER is never planned as a source for a raw (or
        other-codec) pair.

        ``base_holders`` (content-delta pairs, docs/codec.md): base
        digest hex → the senders PROVABLY holding verified canonical
        bytes with that digest.  A ``"delta:<hex>"`` pair is only
        admissible from a sender that holds BOTH the base and the delta
        capability — a sender with the capability but not the base
        would have nothing to encode against.

        ``link_demotions`` (closed-loop autonomy, docs/autonomy.md):
        (src, dest) → demoted modeled bytes/s for links the health
        plane flagged as straggling — the solver then prices the slow
        path at its MEASURED rate instead of the declared one and
        routes around it whenever an alternative holder wins.  Honest
        limit: the demotion caps each (sender, layer, dest) arc, not
        the aggregate of all layers crossing the link — multiple
        concurrent layers on one demoted link can together exceed the
        demoted rate (the declared per-node NIC budget still bounds
        them)."""
        self.assignment = assignment
        self.layer_sizes = layer_sizes
        self.node_network_bw = node_network_bw
        self.remaining = remaining or {}
        self.topology = topology
        self.codec_sizes = codec_sizes or {}
        self.node_codecs = node_codecs or {}
        self.base_holders = base_holders or {}
        self.link_demotions = {
            (int(s), int(d)): int(bps)
            for (s, d), bps in (link_demotions or {}).items() if bps > 0}
        self._slice: Dict[NodeID, int] = (
            topology.slices() if topology is not None else {}
        )
        self._torus = (topology is not None and topology.torus_modeled())

        # (layer, dest) pairs to deliver; dests_of inverts them so sender
        # edges can fan a held layer out to every receiver that wants it.
        self.pairs = sorted(
            (lid, dest)
            for dest, layers in assignment.items()
            for lid in layers
        )
        self.dests_of: Dict[LayerID, List[NodeID]] = {}
        for lid, dest in self.pairs:
            self.dests_of.setdefault(lid, []).append(dest)

        # Sharded targets (docs/sharding.md): each pair's target shard
        # spec, read from the assignment meta.  Demands size by SHARD
        # bytes (``_pair_size``) and decompose starting at the shard's
        # base offset (``seed_pair_offsets``), so mode-3 budgets,
        # predictions, and tier preemption all shrink to the shard
        # fraction.  Shard-HOLDING status rows are filtered out of the
        # sender side unless their shard covers every requested shard of
        # that layer — a 1/8 holder can serve a matching 1/8 target but
        # must never be planned as a full-layer source.
        self._pair_shard: Dict[Tuple[LayerID, NodeID], str] = {}
        # (layer, dest) -> the pair's chosen wire codec (docs/codec.md);
        # absent = canonical bytes.
        self._pair_codec: Dict[Tuple[LayerID, NodeID], str] = {}
        for dest, layers in assignment.items():
            for lid, meta in layers.items():
                spec = getattr(meta, "shard", "")
                if spec:
                    self._pair_shard[(lid, dest)] = spec
                codec = getattr(meta, "codec", "")
                if codec:
                    self._pair_codec[(lid, dest)] = codec
        self.status = status = self._filter_shard_senders(status)

        self.idx: Dict[_V, int] = {}

        def add(v: _V) -> None:
            if v not in self.idx:
                self.idx[v] = len(self.idx)

        add(_V("source"))
        for node_id in sorted(status):
            add(_V("sender", node_id=node_id))
        for node_id in sorted(status):
            for st in sorted({int(m.source_type) for m in status[node_id].values()}):
                add(_V("class", node_id=node_id, source_type=st))
        for layer_id, dest in self.pairs:
            add(_V("layer", layer_id=layer_id, node_id=dest))
        for node_id in sorted(assignment):
            add(_V("receiver", node_id=node_id))
        # One split capacity edge per ordered slice pair that some
        # scheduled (sender, dest) crosses.
        self.x_pairs: List[Tuple[int, int]] = []
        if topology is not None:
            crossed = set()
            for node_id, layer_metas in status.items():
                for layer_id in layer_metas:
                    for dest in self.dests_of.get(layer_id, ()):
                        if self._cross(node_id, dest):
                            crossed.add((self._slice[node_id],
                                         self._slice[dest]))
            self.x_pairs = sorted(crossed)
            for a, b in self.x_pairs:
                add(_V("xin", node_id=a, layer_id=b))
                add(_V("xout", node_id=a, layer_id=b))
        add(_V("sink"))

        self.n = len(self.idx)
        # The O(n^2) matrix is only needed by the Python solver; allocated
        # lazily in _build so NativeFlowGraph never pays for it.
        self.cap: Optional[List[List[int]]] = None

    # ----------------------------------------------------------- shard specs

    def _filter_shard_senders(self, status: Status) -> Status:
        """A status view safe to plan senders from: a SHARD-holding row
        entry stays only when its shard covers every requested shard of
        that layer (then any planned range for the layer is within the
        holder's real bytes).  Full holdings always stay.  The filter
        copies only rows it changes — the common unsharded cluster plans
        over the caller's dicts untouched."""
        if not any(getattr(m, "shard", "")
                   for row in status.values() for m in row.values()):
            return status
        out: Status = {}
        for node_id, row in status.items():
            keep = {}
            for lid, meta in row.items():
                if meta.shard and not all(
                    shard_covers(meta.shard,
                                 self._pair_shard.get((lid, d), ""))
                    for d in self.dests_of.get(lid, ())
                ):
                    continue
                keep[lid] = meta
            out[node_id] = keep if len(keep) != len(row) else row
        return out

    def _pair_total(self, layer_id: LayerID, dest: NodeID) -> int:
        """The pair's transfer-space total: the ENCODED byte count for a
        codec pair (its offsets, shard ranges, and interval accounting
        all live in encoded space — docs/codec.md), the canonical layer
        size otherwise."""
        codec = self._pair_codec.get((layer_id, dest))
        if codec:
            enc = self.codec_sizes.get((layer_id, codec))
            if enc is not None:
                return enc
        return self.layer_sizes[layer_id]

    def _pair_base(self, layer_id: LayerID, dest: NodeID) -> int:
        """Absolute byte offset the pair's delivery starts at: the shard
        base for sharded targets (in the pair's transfer space), 0
        otherwise."""
        spec = self._pair_shard.get((layer_id, dest))
        if not spec:
            return 0
        return shard_range(spec, self._pair_total(layer_id, dest))[0]

    def _arc_ok(self, sender: NodeID, meta, layer_id: LayerID,
                dest: NodeID) -> bool:
        """Whether ``sender``'s holding may serve THIS (layer, dest)
        pair (docs/codec.md).  A quantized holding serves only pairs
        planned at exactly its codec (the encoded bytes forward
        verbatim — this is what lets a quantized copy re-seed other
        dests with no decode/re-encode round trip), and NEVER a raw
        pair; a canonical holding serves raw pairs always and quantized
        pairs only when the sender can encode — and is NOT client-held
        (the client pipe streams raw bytes the node never touches, so
        it can't encode regardless of the node's own capability)."""
        want = self._pair_codec.get((layer_id, dest), "")
        held = getattr(meta, "codec", "")
        if held:
            return held == want
        if want:
            from ..core.types import (
                LayerLocation,
                codec_capability,
                delta_base_digest,
            )

            if meta.location == LayerLocation.CLIENT:
                return False
            if codec_capability(want) not in self.node_codecs.get(
                    sender, ()):
                return False
            base = delta_base_digest(want)
            if base and sender not in self.base_holders.get(base, ()):
                return False  # delta needs the base held, verified, HERE
            return True
        return True

    def seed_pair_offsets(self) -> Dict[Tuple[LayerID, NodeID], int]:
        """Initial per-pair byte offsets for job decomposition.  Pairs
        with a ``remaining`` override decompose in remaining-space (the
        caller remaps them through its gap list — leader resume path);
        all others decompose in absolute layer space, starting at the
        shard base for sharded targets."""
        return {
            (lid, dest): self._pair_base(lid, dest)
            for lid, dest in self.pairs
            if (lid, dest) not in self.remaining
            and self._pair_shard.get((lid, dest))
        }

    # ------------------------------------------------------------- capacities

    def _cross(self, sender: NodeID, dest: NodeID) -> bool:
        """Whether sender→dest traffic crosses slices (rides the DCN).
        Nodes without a slice mapping are unconstrained (treated local)."""
        a = self._slice.get(sender)
        b = self._slice.get(dest)
        return a is not None and b is not None and a != b

    def _class_capacity(self, node_id: NodeID, limit_rate: int, t: int) -> int:
        """Bytes deliverable by this source class in ``t`` ms."""
        if limit_rate > 0:
            return limit_rate * t // TIME_SCALE
        # Unlimited source class: NIC bandwidth is the real ceiling.
        return self.node_network_bw.get(node_id, 0) * t // TIME_SCALE

    def _pair_size(self, layer_id: LayerID, dest: NodeID) -> int:
        """Bytes still needed by ``dest`` for ``layer_id``: a resume
        override if the caller gave one, else the target SHARD's bytes
        (docs/sharding.md) of the pair's transfer-space total — the
        ENCODED size for a codec pair (docs/codec.md), so a quantized
        transfer books 1/ratio of the link budget a raw one would."""
        override = self.remaining.get((layer_id, dest))
        if override is not None:
            return override
        total = self._pair_total(layer_id, dest)
        spec = self._pair_shard.get((layer_id, dest))
        if spec:
            return shard_range(spec, total)[1]
        return total

    def _build(self, t: int) -> None:
        """(Re)build edge capacities for candidate time t (flow.go:221-270)."""
        if self.cap is None:
            self.cap = [[0] * self.n for _ in range(self.n)]
        else:
            for row in self.cap:
                for j in range(self.n):
                    row[j] = 0
        src = self.idx[_V("source")]
        sink = self.idx[_V("sink")]

        for node_id, layer_metas in self.status.items():
            sender = self.idx[_V("sender", node_id=node_id)]
            self.cap[src][sender] = (
                self.node_network_bw.get(node_id, 0) * t // TIME_SCALE
            )
            for layer_id, meta in layer_metas.items():
                dests = self.dests_of.get(layer_id, ())
                if not dests:
                    continue
                cls = self.idx[
                    _V("class", node_id=node_id,
                       source_type=int(meta.source_type))
                ]
                # Rates are a property of the source class (reference
                # config.go:26); if per-layer metadata disagrees, take
                # the max so the rule is deterministic (not dict-order).
                self.cap[sender][cls] = max(
                    self.cap[sender][cls],
                    self._class_capacity(node_id, meta.limit_rate, t),
                )
                for dest in dests:
                    if not self._arc_ok(node_id, meta, layer_id, dest):
                        continue  # codec-inadmissible sender (docs/codec.md)
                    layer = self.idx[
                        _V("layer", layer_id=layer_id, node_id=dest)
                    ]
                    if self._cross(node_id, dest):
                        # Cross-slice: through the pair's DCN edge.
                        a, b = self._slice[node_id], self._slice[dest]
                        xin = self.idx[_V("xin", node_id=a, layer_id=b)]
                        xout = self.idx[_V("xout", node_id=a, layer_id=b)]
                        self.cap[cls][xin] = _INF
                        self.cap[xout][layer] = _INF
                    else:
                        demoted = self.link_demotions.get(
                            (node_id, dest))
                        # A health-flagged straggler link is priced at
                        # its demoted measured rate, not _INF — the
                        # max-flow then routes around it whenever any
                        # alternative holder wins (docs/autonomy.md).
                        self.cap[cls][layer] = (
                            demoted * t // TIME_SCALE
                            if demoted else _INF)
        for a, b in self.x_pairs:
            xin = self.idx[_V("xin", node_id=a, layer_id=b)]
            xout = self.idx[_V("xout", node_id=a, layer_id=b)]
            self.cap[xin][xout] = self.topology.dcn_bw * t // TIME_SCALE

        for node_id, layer_ids in self.assignment.items():
            receiver = self.idx[_V("receiver", node_id=node_id)]
            for layer_id in layer_ids:
                layer = self.idx[_V("layer", layer_id=layer_id, node_id=node_id)]
                self.cap[layer][receiver] = self._pair_size(layer_id, node_id)
            self.cap[receiver][sink] = (
                self.node_network_bw.get(node_id, 0) * t // TIME_SCALE
            )

    # --------------------------------------------------------------- max-flow

    def _bfs(self, src: int, sink: int) -> Tuple[List[int], bool]:
        parent = [0] * self.n
        visited = [False] * self.n
        visited[src] = True
        q = deque([src])
        while q:
            u = q.popleft()
            row = self.cap[u]
            for v in range(self.n):
                if not visited[v] and row[v] > 0:
                    visited[v] = True
                    parent[v] = u
                    if v == sink:
                        return parent, True
                    q.append(v)
        return parent, False

    def max_flow(self, t: int) -> int:
        """Edmonds–Karp on the residual matrix for candidate time t
        (flow.go:319-353)."""
        self._build(t)
        src = self.idx[_V("source")]
        sink = self.idx[_V("sink")]
        total = 0
        while True:
            parent, ok = self._bfs(src, sink)
            if not ok:
                return total
            path_flow = _INF
            v = sink
            while v != src:
                path_flow = min(path_flow, self.cap[parent[v]][v])
                v = parent[v]
            total += path_flow
            v = sink
            while v != src:
                self.cap[parent[v]][v] -= path_flow
                self.cap[v][parent[v]] += path_flow
                v = parent[v]

    # ----------------------------------------------------- cross attribution

    def _attribute_cross(
        self,
    ) -> Optional[Dict[Tuple[NodeID, int, LayerID, NodeID], int]]:
        """Re-attribute the cross-slice flow of the LAST ``max_flow`` run
        to holdings-valid (sender-class → (layer, dest)) arcs.

        The relaxed pair vertices aggregate flow, so the residuals only
        say how much each class pushed INTO a pair edge and how much each
        (layer, dest) drew OUT of it; a small transportation max-flow per
        pair re-splits those totals along arcs a sender actually holds.
        Returns {(sender, source_type, layer, dest): bytes}, or None when
        some pair's flow cannot be absorbed by true holdings — the caller
        must then treat the candidate time as infeasible."""
        out: Dict[Tuple[NodeID, int, LayerID, NodeID], int] = {}
        for a, b in self.x_pairs:
            xin = self.idx[_V("xin", node_id=a, layer_id=b)]
            xout = self.idx[_V("xout", node_id=a, layer_id=b)]
            supplies: List[Tuple[Tuple[NodeID, int], int]] = []
            for node_id in sorted(self.status):
                if self._slice.get(node_id) != a:
                    continue
                for st in sorted({int(m.source_type)
                                  for m in self.status[node_id].values()}):
                    cls = self.idx[_V("class", node_id=node_id,
                                      source_type=st)]
                    f = self.cap[xin][cls]  # reverse residual = flow
                    if f > 0:
                        supplies.append(((node_id, st), f))
            demands: List[Tuple[Tuple[LayerID, NodeID], int]] = []
            for lid, dest in self.pairs:
                if self._slice.get(dest) != b:
                    continue
                layer = self.idx[_V("layer", layer_id=lid, node_id=dest)]
                f = self.cap[layer][xout]
                if f > 0:
                    demands.append(((lid, dest), f))

            def holds(sup: Tuple[NodeID, int],
                      dem: Tuple[LayerID, NodeID]) -> bool:
                node_id, st = sup
                lid, dem_dest = dem
                meta = self.status.get(node_id, {}).get(lid)
                return (meta is not None and int(meta.source_type) == st
                        and self._arc_ok(node_id, meta, lid, dem_dest))

            split = _transport(supplies, demands, holds)
            if split is None:
                return None
            for (node_id, st), (lid, dest), nbytes in split:
                key = (node_id, st, lid, dest)
                out[key] = out.get(key, 0) + nbytes
        return out

    # ------------------------------------------------------- LP (topology)

    def _lp_arcs(self) -> List[Tuple[NodeID, int, LayerID, NodeID]]:
        """Admissible (sender, source_type, layer, dest) arcs, sorted."""
        arcs = []
        for node_id in sorted(self.status):
            for layer_id in sorted(self.status[node_id]):
                meta = self.status[node_id][layer_id]
                for dest in self.dests_of.get(layer_id, ()):
                    if not self._arc_ok(node_id, meta, layer_id, dest):
                        continue
                    arcs.append(
                        (node_id, int(meta.source_type), layer_id, dest))
        return arcs

    def _lp_schedule(
        self, t: int
    ) -> Optional[Dict[Tuple[NodeID, int, LayerID, NodeID], int]]:
        """Exact topology-aware schedule at candidate time ``t`` (module
        docstring): returns integral per-arc bytes meeting every demand,
        or None when ``t`` is infeasible."""
        from scipy.optimize import linprog
        from scipy.sparse import csr_matrix

        arcs = self._lp_arcs()
        required = sum(self._pair_size(lid, d) for lid, d in self.pairs)
        if required == 0:
            return {}
        if not arcs:
            return None
        groups: Dict[Tuple, List[int]] = {}
        for i, (s, st, lid, d) in enumerate(arcs):
            groups.setdefault(("class", s, st), []).append(i)
            groups.setdefault(("snic", s), []).append(i)
            groups.setdefault(("rnic", d), []).append(i)
            groups.setdefault(("pair", lid, d), []).append(i)
            if self._cross(s, d):
                groups.setdefault(
                    ("dcn", self._slice[s], self._slice[d]), []).append(i)
            elif self._torus and s != d:
                # Intra-slice: the arc consumes capacity on EVERY
                # directed torus link of its DOR route — one bundle
                # row per link, so arcs sharing a hot link share its
                # budget and the optimum spreads across links.
                for link in self.topology.ici_path(s, d):
                    groups.setdefault(("ici",) + link, []).append(i)
        rows, cols, caps = [], [], []
        for r, (key, idxs) in enumerate(sorted(groups.items())):
            kind = key[0]
            if kind == "class":
                _, s, st = key
                # EXACTLY _build's rule (line-for-line semantics): only
                # layers that still have dests contribute, disagreeing
                # metadata takes the max CAPACITY (deterministic, not
                # announcement-order; rate 0 means NIC-bound).  Matching
                # _build keeps the relaxed max-flow a true bound for the
                # LP — a delivered (dest-less) layer's rate must not leak
                # into the class cap of either solver.
                cap = max(self._class_capacity(s, m.limit_rate, t)
                          for lid, m in self.status[s].items()
                          if int(m.source_type) == st
                          and self.dests_of.get(lid))
            elif kind == "snic" or kind == "rnic":
                cap = self.node_network_bw.get(key[1], 0) * t // TIME_SCALE
            elif kind == "pair":
                cap = self._pair_size(key[1], key[2])
            elif kind == "ici":
                cap = self.topology.ici_link_bw * t // TIME_SCALE
            else:  # dcn
                cap = self.topology.dcn_bw * t // TIME_SCALE
            for i in idxs:
                rows.append(r)
                cols.append(i)
            caps.append(cap)
        a_ub = csr_matrix(([1.0] * len(rows), (rows, cols)),
                          shape=(len(caps), len(arcs)))
        res = linprog([-1.0] * len(arcs), A_ub=a_ub, b_ub=caps,
                      bounds=(0, None), method="highs")
        if not res.success or -res.fun + 0.5 < required:
            return None
        # Round to an exact integral tiling: per (layer, dest), floor each
        # arc and hand the remainder to the largest fractional parts
        # (deterministic tie-break by arc order).  Caps are pacing rates,
        # not hard walls — the ≤#arcs rounding slack is immaterial.
        out: Dict[Tuple[NodeID, int, LayerID, NodeID], int] = {}
        for lid, dest in self.pairs:
            idxs = groups[("pair", lid, dest)]
            vals = [(i, float(res.x[i])) for i in idxs]
            floors = {i: int(v) for i, v in vals}
            short = self._pair_size(lid, dest) - sum(floors.values())
            order = sorted(vals, key=lambda iv: (-(iv[1] - int(iv[1])), iv[0]))
            for i, _ in order:
                if short <= 0:
                    break
                floors[i] += 1
                short -= 1
            if short > 0:
                return None  # numerically infeasible despite LP success
            for i, nbytes in floors.items():
                if nbytes > 0:
                    out[arcs[i]] = nbytes
        return out

    def _flat_replan(self, why: str) -> Tuple[int, FlowJobsMap]:
        """Last-resort degrade: plan without the topology (the flat path
        also handles partial deliverability by decomposing whatever flow
        exists instead of starving every pair).  ``type(self)`` keeps a
        NativeFlowGraph's degrade on the C++ Dinic."""
        log.error("topology solve degraded to flat replan", why=why)
        flat = type(self)(self.assignment, self.status, self.layer_sizes,
                          self.node_network_bw, remaining=self.remaining,
                          codec_sizes=self.codec_sizes,
                          node_codecs=self.node_codecs,
                          base_holders=self.base_holders)
        return flat.get_job_assignment()

    @staticmethod
    def _emit_jobs(
        items, jobs: FlowJobsMap,
        pair_offset: Dict[Tuple[LayerID, NodeID], int],
    ) -> None:
        """Append (sender, layer, dest, bytes) contributions as FlowJobs,
        continuing each (layer, dest)'s running byte offset."""
        for sender_id, layer_id, dest, nbytes in items:
            offset = pair_offset.get((layer_id, dest), 0)
            jobs.setdefault(sender_id, []).append(
                FlowJob(sender_id, layer_id, nbytes, offset, dest)
            )
            pair_offset[(layer_id, dest)] = offset + nbytes

    def _relaxed_bound(self, required: int) -> Tuple[int, bool]:
        """Minimum t at which the RELAXED graph (topology pair edges
        shared, holdings labels dropped) routes ``required`` bytes.
        ``self.cap`` is left holding the residuals of whatever probe ran
        LAST — which the binary search does NOT guarantee to be the
        returned t — so callers that decompose flows must re-run
        ``max_flow(t)`` first (``get_job_assignment`` does).
        ``NativeFlowGraph`` overrides this with the C++ Dinic search,
        which never touches ``self.cap`` at all."""
        return _search_min_time(lambda t: self.max_flow(t) >= required)

    def _lp_job_assignment(self, seed: Optional[int] = None
                           ) -> Tuple[int, FlowJobsMap]:
        """Time search + decomposition over the exact LP (topology mode).
        ``seed``: a known relaxed lower bound (the caller already ran the
        relaxed search); None recomputes it."""
        sched: Dict = {}

        def feasible(t: int) -> bool:
            nonlocal sched
            s = self._lp_schedule(t)
            if s is None:
                return False
            sched = s
            return True

        # Seed the LP search from the RELAXED max-flow bound: the
        # relaxation only loosens constraints (same class/NIC caps, the
        # holdings structure dropped at the pair vertices), so its
        # minimum time is a valid lower bound for the LP — starting
        # there skips the small candidates (each a wasted LP solve) and
        # keeps leader planning latency out of the TTD.
        required = sum(self._pair_size(lid, d) for lid, d in self.pairs)
        if seed is None:
            t_lb, relaxed_ok = self._relaxed_bound(required)
            if not relaxed_ok:
                # Even the relaxation can't deliver everything; the flat
                # solver still schedules every deliverable byte.
                return self._flat_replan("no feasible t under the relaxation")
        else:
            t_lb = seed
        t, ok = _search_min_time(feasible, lo=t_lb)
        if not ok:
            return self._flat_replan("no feasible t under the LP")
        # The search's last solve may not have been at t; re-solve once
        # so the emitted schedule is exactly the optimum's.
        if not feasible(t):
            return self._flat_replan("LP optimum became infeasible")
        best = sched

        jobs: FlowJobsMap = {}
        pair_offset = self.seed_pair_offsets()
        self._emit_jobs(
            ((s, lid, d, n) for (s, _st, lid, d), n in sorted(best.items())),
            jobs, pair_offset,
        )
        log.info("job assignment calculated (topology LP)", min_time_ms=t)
        return t, jobs

    # ------------------------------------------------------------ scheduling

    def get_job_assignment(self) -> Tuple[int, FlowJobsMap]:
        """Minimum feasible completion time (MILLISECONDS) + per-sender
        byte-range jobs (flow.go:146-218, at 1000× finer granularity).

        Topology instances run ATTRIBUTION-FIRST: the relaxed search's
        minimum time is a lower bound for the exact problem, so when the
        transportation re-split lands the cross-slice flow on true
        holdings, that plan achieves the bound and IS optimal — no LP
        needed.  The LP runs only when attribution fails (adversarial
        holdings), which keeps scipy's ~2 s one-time initialization off
        the common path entirely (it still warms in the background,
        ``warm_lp``).

        EXCEPT when per-link torus ICI is modeled: the relaxation (and
        attribution) know nothing of link bundles, so a successful
        attribution no longer implies feasibility — those instances go
        straight to the LP, seeded by the relaxed bound.  Without scipy,
        link constraints degrade (loudly) to the per-node model."""
        required = sum(self._pair_size(lid, dest) for lid, dest in self.pairs)

        # Pure max-flow feasibility only: it is monotone in t (capacities
        # scale with t), which the binary search requires.  Whether the
        # particular EK-chosen flow re-attributes along true holdings is
        # NOT monotone, so attribution is checked once at the final t.
        t, ok = self._relaxed_bound(required)
        if not ok:
            # Undeliverable pair(s): decompose the partial flow at the
            # search ceiling — every deliverable byte still schedules.
            log.error("t_upper not found")

        if self._torus and ok:
            if _have_lp():
                return self._lp_job_assignment(seed=t)
            log.warn("torus ICI links configured but scipy is "
                     "unavailable; planning without per-link constraints")

        self.max_flow(t)  # leave residuals for decomposition
        cross = self._attribute_cross() if self.x_pairs else {}
        if cross is None:
            # The relaxation chose an unattributable flow (module
            # docstring): the exact LP recovers a holdings-valid optimum
            # when available; otherwise replan flat rather than emit an
            # invalid tiling.
            if ok and _have_lp():
                return self._lp_job_assignment(seed=t)
            return self._flat_replan(
                f"cross-slice attribution failed at t={t}")

        jobs: FlowJobsMap = {}
        pair_offset = self.seed_pair_offsets()
        for sender_id in sorted(self.status):
            for layer_id in sorted(self.status[sender_id]):
                meta = self.status[sender_id][layer_id]
                cls = self.idx[
                    _V("class", node_id=sender_id, source_type=int(meta.source_type))
                ]
                for dest in self.dests_of.get(layer_id, ()):
                    layer = self.idx[_V("layer", layer_id=layer_id, node_id=dest)]
                    # Residual reverse edge layer→class equals the flow
                    # pushed class→layer: the bytes this sender
                    # contributes toward (layer, dest).
                    flow = self.cap[layer][cls]
                    if flow > 0:
                        self._emit_jobs([(sender_id, layer_id, dest, flow)],
                                        jobs, pair_offset)

        # Cross-slice contributions continue each (layer, dest)'s offsets
        # after the intra-slice ones (deterministic order).
        self._emit_jobs(
            ((s, lid, d, n) for (s, _st, lid, d), n in sorted(cross.items())),
            jobs, pair_offset,
        )

        log.info("job assignment calculated (topology)" if self.x_pairs
                 else "job assignment calculated", min_time_ms=t)
        return t, jobs
