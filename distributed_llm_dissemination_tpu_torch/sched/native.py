"""Native-accelerated mode-3 scheduler: same flow model, C++ core.

Builds the identical six-level graph as :class:`~..sched.flow.FlowGraph`
(source → sender → source-class → layer → receiver → sink, reference
flow.go:55-144) but expresses it as an edge list whose capacities are
affine in the candidate completion time ``t`` and hands the whole
exponential+binary time search to the Dinic solver in
``native/flow_solver.cc``.  One C call replaces ~2·log2(t) Python
Edmonds–Karp runs — the leader-side scheduling hot path at pod scale.

``make_flow_graph`` picks the native path when the library is available
and falls back to the pure-Python :class:`FlowGraph` otherwise; both
return the same minimum time and a valid byte-range decomposition (the
exact per-sender split may differ — any max flow is an optimal plan).
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Tuple

from ..core.types import Assignment, LayerID, NodeID, Status
from ..native import load_flow_solver
from ..utils.logging import log
from .flow import TIME_SCALE, FlowGraph, FlowJob, FlowJobsMap, _INF, _V


class NativeFlowGraph(FlowGraph):
    """FlowGraph whose search + max-flow run in the native library.

    Vertex indexing is inherited (deterministic, sorted); only the solver
    differs.  Falls back to the parent's pure-Python path if the library
    can't be loaded at call time.
    """

    def _edge_list(self) -> Tuple[List[int], List[int], List[int], List[int],
                                  Dict[Tuple[NodeID, LayerID, NodeID], int]]:
        """Edges as (u, v, cap_const, cap_per_t) arrays, plus the map from
        (sender, layer, dest) to its class→layer edge index — the edges
        whose flow is read back as that sender's byte contribution toward
        that (layer, dest) pair (flow.go:193-211)."""
        eu: List[int] = []
        ev: List[int] = []
        const: List[int] = []
        per_t: List[int] = []
        contrib: Dict[Tuple[NodeID, LayerID, NodeID], int] = {}
        class_edge: Dict[Tuple[int, int], int] = {}
        seen: set = set()  # dedup for the topology's shared INF edges

        src = self.idx[_V("source")]
        sink = self.idx[_V("sink")]

        for node_id in sorted(self.status):
            sender = self.idx[_V("sender", node_id=node_id)]
            eu.append(src)
            ev.append(sender)
            const.append(0)
            per_t.append(self.node_network_bw.get(node_id, 0))
            for layer_id in sorted(self.status[node_id]):
                dests = self.dests_of.get(layer_id, ())
                if not dests:
                    continue
                meta = self.status[node_id][layer_id]
                cls = self.idx[
                    _V("class", node_id=node_id, source_type=int(meta.source_type))
                ]
                # Class-edge rate: max across the class's layers, matching
                # FlowGraph._build (rates belong to the source class).
                # _class_capacity at t=TIME_SCALE (one full second of ms)
                # is exactly the per-second rate.
                rate = self._class_capacity(node_id, meta.limit_rate, TIME_SCALE)
                if (sender, cls) not in class_edge:
                    class_edge[(sender, cls)] = len(eu)
                    eu.append(sender)
                    ev.append(cls)
                    const.append(0)
                    per_t.append(rate)
                else:
                    i = class_edge[(sender, cls)]
                    per_t[i] = max(per_t[i], rate)
                for dest in dests:
                    if not self._arc_ok(node_id, meta, layer_id, dest):
                        continue  # codec-inadmissible sender (docs/codec.md)
                    layer = self.idx[
                        _V("layer", layer_id=layer_id, node_id=dest)
                    ]
                    if self._cross(node_id, dest):
                        # Topology: cross-slice arcs route through the
                        # pair's shared xin→xout DCN edge, mirroring
                        # FlowGraph._build — the relaxation (labels
                        # dropped at the pair vertex) is identical, so
                        # the native min time IS the Python bound.  No
                        # contrib entry: cross flow is attributed by the
                        # caller (LP or transportation re-split), never
                        # read off these edges.
                        a = self._slice[node_id]
                        b = self._slice[dest]
                        xin = self.idx[_V("xin", node_id=a, layer_id=b)]
                        xout = self.idx[_V("xout", node_id=a, layer_id=b)]
                        for u, v in ((cls, xin), (xout, layer)):
                            if (u, v) not in seen:
                                seen.add((u, v))
                                eu.append(u)
                                ev.append(v)
                                const.append(_INF)
                                per_t.append(0)
                    else:
                        contrib[(node_id, layer_id, dest)] = len(eu)
                        eu.append(cls)
                        ev.append(layer)
                        # A health-demoted straggler link is priced at
                        # its measured rate instead of _INF, mirroring
                        # FlowGraph._build (docs/autonomy.md).
                        demoted = self.link_demotions.get(
                            (node_id, dest))
                        if demoted:
                            const.append(0)
                            per_t.append(demoted)
                        else:
                            const.append(_INF)
                            per_t.append(0)
        for a, b in self.x_pairs:
            eu.append(self.idx[_V("xin", node_id=a, layer_id=b)])
            ev.append(self.idx[_V("xout", node_id=a, layer_id=b)])
            const.append(0)
            per_t.append(self.topology.dcn_bw)

        for node_id in sorted(self.assignment):
            receiver = self.idx[_V("receiver", node_id=node_id)]
            for layer_id in sorted(self.assignment[node_id]):
                layer = self.idx[_V("layer", layer_id=layer_id, node_id=node_id)]
                eu.append(layer)
                ev.append(receiver)
                const.append(self._pair_size(layer_id, node_id))
                per_t.append(0)
            eu.append(receiver)
            ev.append(sink)
            const.append(0)
            per_t.append(self.node_network_bw.get(node_id, 0))

        return eu, ev, const, per_t, contrib

    def _relaxed_bound(self, required: int) -> Tuple[int, bool]:
        """The C++ Dinic search over the (topology-aware) relaxed graph:
        one C call instead of ~2·log2(t) Python Edmonds–Karp runs.  Does
        NOT populate ``self.cap`` residuals — callers that decompose
        flows re-run ``max_flow`` at the returned t (one Python solve at
        a known time, not a search)."""
        lib = load_flow_solver()
        if lib is None:
            return super()._relaxed_bound(required)
        eu, ev, const, per_t, _ = self._edge_list()
        m = len(eu)
        achieved = ctypes.c_int64(0)
        t = lib.flow_min_time_schedule(
            self.n, m, (ctypes.c_int32 * m)(*eu), (ctypes.c_int32 * m)(*ev),
            (ctypes.c_int64 * m)(*const), (ctypes.c_int64 * m)(*per_t),
            self.idx[_V("source")], self.idx[_V("sink")],
            required, TIME_SCALE, (ctypes.c_int64 * m)(),
            ctypes.byref(achieved),
        )
        return t, achieved.value >= required

    def get_job_assignment(self) -> Tuple[int, FlowJobsMap]:
        lib = load_flow_solver()
        if lib is None or self.topology is not None:
            # Topology planning stays in the parent (LP for exactness,
            # transportation re-attribution otherwise) — but its relaxed
            # time searches ride the native solver via _relaxed_bound.
            return super().get_job_assignment()

        required = sum(self._pair_size(lid, dest) for lid, dest in self.pairs)
        eu, ev, const, per_t, contrib = self._edge_list()
        m = len(eu)
        a_eu = (ctypes.c_int32 * m)(*eu)
        a_ev = (ctypes.c_int32 * m)(*ev)
        a_const = (ctypes.c_int64 * m)(*const)
        a_per_t = (ctypes.c_int64 * m)(*per_t)
        flows = (ctypes.c_int64 * m)()
        achieved = ctypes.c_int64(0)

        t0 = time.monotonic()
        t = lib.flow_min_time_schedule(
            self.n, m, a_eu, a_ev, a_const, a_per_t,
            self.idx[_V("source")], self.idx[_V("sink")],
            required, TIME_SCALE, flows, ctypes.byref(achieved),
        )
        if achieved.value < required:
            log.error("flow schedule infeasible",
                      required=required, achieved=achieved.value)

        jobs: FlowJobsMap = {}
        # Sharded targets decompose from their shard's base offset
        # (resume-override pairs stay in remaining-space; the leader
        # remaps those) — same seeding as the Python decompositions.
        pair_offset: Dict[Tuple[LayerID, NodeID], int] = (
            self.seed_pair_offsets())
        for sender_id in sorted(self.status):
            for layer_id in sorted(self.status[sender_id]):
                for dest in self.dests_of.get(layer_id, ()):
                    edge = contrib.get((sender_id, layer_id, dest))
                    if edge is None:
                        continue
                    flow = flows[edge]
                    if flow > 0:
                        offset = pair_offset.get((layer_id, dest), 0)
                        jobs.setdefault(sender_id, []).append(
                            FlowJob(sender_id, layer_id, flow, offset, dest)
                        )
                        pair_offset[(layer_id, dest)] = offset + flow

        log.info(
            "job assignment calculated (native)",
            min_time_ms=t,
            solver_ms=round((time.monotonic() - t0) * 1000, 3),
        )
        return t, jobs


def make_flow_graph(
    assignment: Assignment,
    status: Status,
    layer_sizes: Dict[LayerID, int],
    node_network_bw: Dict[NodeID, int],
    remaining=None,
    topology=None,
    codec_sizes=None,
    node_codecs=None,
    base_holders=None,
    link_demotions=None,
) -> FlowGraph:
    """The fastest available mode-3 scheduler for this environment.

    With a ``PodTopology``, planning itself stays in the Python solver
    (the LP carries the holdings structure the relaxed graph drops) but
    every relaxed time search — the LP's seed bound and the no-scipy
    fallback's search — runs in the C++ Dinic, which now carries the
    per-pair DCN ``xin``/``xout`` edges.  Wire-codec pairs
    (``codec_sizes``/``node_codecs``, docs/codec.md) size and
    arc-filter identically on both paths — the predicates live on the
    shared base class."""
    cls = FlowGraph if load_flow_solver() is None else NativeFlowGraph
    return cls(assignment, status, layer_sizes, node_network_bw,
               remaining=remaining, topology=topology,
               codec_sizes=codec_sizes, node_codecs=node_codecs,
               base_holders=base_holders, link_demotions=link_demotions)
