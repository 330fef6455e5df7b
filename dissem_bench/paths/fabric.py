"""The single-controller pod over the device fabric, one round at a time.

A round is one ``cli.podrun.run_pod`` of the traffic's topology: the
mode-3 leader plans each blob from the seeders that hold it, the seeders
publish their byte ranges onto their own slots (uploading host bytes, or
slicing a copy already in device memory), each dest ingests its stage's
blobs device to device, boots its stage, and the pod runs one pipelined
forward of the round's prompt.  The seeders' holdings are made once from
the seed (``weights.make_blobs``) and handed to every round as
``initial_layers``; nothing else of a round survives into the next: the
harness drops what it kept of the dests, releases and re-arms the port's
upload cache and resets the port's trace and telemetry totals first.

The harness times the round on its own clock, from outside the port:

- ``time_to_serve_s``: its call of ``run_pod`` until ``run_pod`` enters
  ``on_delivered`` (after the pod's forward returned);
- ``ttd_s``: the leader's start queue handing out its assignment until
  its ready queue does (the interval ``run_pod`` reports as TTD), read
  through a subclass of the mode's leader whose queues note the time;
- ``boot_s``: ready until the boot queue reports every stage booted;
- ``forward_s``: the pod's forward (``pp_serve.pod_forward``, which
  synchronises), through a wrapper that also keeps its logits and the
  head leaves it served with: the served tokens the comparison judges
  are that forward's own.  For experts the
  wrapper also keeps the experts each layer of that forward picked (the
  mask ``models.llama.route_topk`` returns), which the reference follows.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from .. import layout, spec, weights

COMPARE_CHUNK = 256 << 20  # bytes per slice of a byte comparison
PROBE_BYTES = 1 << 30  # the cross-card copy probe
HOST_COPY_THREADS = 4  # set-up's device-to-host copies of the blobs


def _record(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class _Noted:
    """A leader's queue whose ``get`` on the calling thread notes the time
    it returned, and moves the benchmark's host span along."""

    def __init__(self, q, marks: Dict[str, float], key: str, spans):
        self._q, self._marks, self._key, self._spans = q, marks, key, spans

    def get(self, *a, **k):
        out = self._q.get(*a, **k)
        if self._key not in self._marks:
            self._marks[self._key] = time.monotonic()
            self._spans(self._key)
        return out

    def __getattr__(self, name):
        return getattr(self._q, name)


def _timed_leader(base, marks, spans):
    class TimedLeader(base):
        def start_distribution(self):
            return _Noted(super().start_distribution(), marks, "started",
                          spans)

        def ready(self):
            return _Noted(super().ready(), marks, "ready", spans)

        def boot_ready(self):
            return _Noted(super().boot_ready(), marks, "booted", spans)

    TimedLeader.__name__ = base.__name__
    return TimedLeader


class _SpanChain:
    """The host spans between the leader's queues: ``bench.deliver`` from
    the start to ready, ``bench.boot`` from ready to every stage booted."""

    NEXT = {"started": "bench.deliver", "ready": "bench.boot", "booted": None}

    def __init__(self, on: bool):
        self.on, self.open = on, None

    def __call__(self, key: str) -> None:
        if not self.on:
            return
        self.close()
        name = self.NEXT[key]
        if name:
            self.open = torch.profiler.record_function(name)
            self.open.__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def _bytes_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Two 1-D uint8 tensors equal byte for byte; ``b``'s slices move to
    ``a``'s device a chunk at a time."""
    if a.numel() != b.numel():
        return False
    for lo in range(0, a.numel(), COMPARE_CHUNK):
        hi = min(a.numel(), lo + COMPARE_CHUNK)
        if not torch.equal(a[lo:hi], b[lo:hi].to(a.device)):
            return False
    return True


def _copy_gbps(src_dev, dst_dev) -> float:
    src = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=src_dev)
    dst = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=dst_dev)
    best = float("inf")
    for i in range(4):
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        t0 = time.monotonic()
        dst.copy_(src)
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        if i:  # the first copy enables peer access and warms up
            best = min(best, time.monotonic() - t0)
    return PROBE_BYTES / best / 1e9


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _leaf_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
            and _bytes_equal(_u8(got), _u8(want)))


class Runner:
    def __init__(self, cell: spec.Cell, seed: int, device=None):
        from distributed_llm_dissemination_tpu_torch.core import config

        self.cell, self.seed = cell, seed
        self.shape, self.traffic = cell.shape, cell.traffic
        spec.port_config(self.shape)
        t = self.traffic
        if t.get("codec", "raw") != "raw" or int(t.get("batch", 1)) != 1:
            raise ValueError("the fabric path hands the seeders raw blobs and "
                             "run_pod serves one prompt: codec raw, batch 1")
        self.device = device if device is not None else t.get("device")
        self.mode = int(t["mode"])
        self.holders = {int(h["node"]): h for h in t["holders"]}
        self.stages = {int(s["node"]): s for s in t["stages"]}
        self.leader = int(t["leader"])
        self.conf = config.Config.from_json(self._conf_dict())
        self.node_dev = self._node_devices()
        self.seeders_in_hbm = any(h["where"] == "hbm"
                                  for h in self.holders.values())
        self.probe_gbps: Optional[float] = None
        self.blobs: Dict[int, torch.Tensor] = {}  # the harness's copy
        self.holdings: Dict[int, Dict[int, Any]] = {}
        self._retained: Optional[dict] = None  # by dest id, and "head"
        self._baseline: Dict[int, int] = {}

    # ---------------------------------------------------------------- set-up

    def _conf_dict(self) -> dict:
        t, s = self.traffic, self.shape
        nic = t["nic_bytes_per_s"]

        def node(i, bw, held=()):
            return {"Id": i, "Addr": str(i), "NetworkBW": int(bw),
                    "IsLeader": i == self.leader,
                    "InitialLayers": ({"2": {str(b): {"LayerSize":
                                      layout.blob_nbytes(s, b)}
                                             for b in held}} if held else {})}

        nodes = [node(self.leader, nic["seeder"])]
        nodes += [node(i, nic["seeder"], spec.holder_blobs(h, s))
                  for i, h in sorted(self.holders.items())]
        nodes += [node(i, nic["dest"]) for i in sorted(self.stages)]
        return {"Model": s.name, "ModelSeed": 0, "Nodes": nodes,
                "Assignment": {str(i): {str(b): {} for b in
                                        spec.holder_blobs(st, s)}
                               for i, st in self.stages.items()},
                "Mesh": {"AxisNames": ["nodes"], "AxisSizes": [len(nodes)],
                         "PipelineAxis": "nodes", "Fabric": True}}

    def _node_devices(self) -> Dict[int, torch.device]:
        """Each node's device as ``run_pod`` will place it (the same
        calls), checked against the traffic's cards on a CUDA host."""
        from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
            device_slots, fabric_placement, mesh_from_conf)

        m = self.conf.mesh
        n = 1
        for size in m.axis_sizes:
            n *= int(size)
        mesh = mesh_from_conf(m, device_slots(n, self.device))
        placement = fabric_placement([nc.id for nc in self.conf.nodes],
                                     self.conf.assignment, mesh,
                                     m.pipeline_axis)
        devs = {i: torch.device(placement.devices_for_node(i)[0].device)
                for i in placement.node_to_stage}
        want = self.traffic.get("cards")
        if want and all(d.type == "cuda" for d in devs.values()):
            got = {str(i): d.index for i, d in devs.items()}
            if got != {str(k): int(v) for k, v in want.items()}:
                raise RuntimeError(f"placement put the nodes on cards {got}, "
                                   f"the traffic names {want}")
        return devs

    @property
    def upload_limits(self):
        """(least, most) bytes a round uploads from host memory: every
        byte of the blobs the stages need from host holders, at least;
        and where no holder is in host memory, none at all (most None:
        no most)."""
        s = self.shape
        goal = {b for st in self.stages.values()
                for b in spec.holder_blobs(st, s)}
        host = {b for h in self.holders.values() if h["where"] == "host"
                for b in spec.holder_blobs(h, s)}
        least = sum(layout.blob_nbytes(s, b) for b in goal & host)
        return least, (0 if not host else None)

    @property
    def cards(self) -> List[int]:
        return sorted({d.index for d in self.node_dev.values()
                       if d.type == "cuda"})

    def setup(self) -> None:
        """Make each holder's blobs on its node's device.  A host holder
        keeps a pageable host copy only; a device holder keeps the device
        copy and a host mirror, the state its first announce leaves in
        every later round (the port hashes a holding's host bytes to
        announce it, and caches a device-only holding's host copy), made
        here once with one copy per blob."""
        from concurrent.futures import ThreadPoolExecutor

        from distributed_llm_dissemination_tpu_torch.core.types import (
            LayerLocation, LayerMeta, LayerSrc, SourceType)

        s = self.shape
        made = {}
        for i, h in sorted(self.holders.items()):
            for b, t in weights.make_blobs(s, spec.holder_blobs(h, s),
                                           self.seed, salt=i,
                                           device=self.node_dev[i]).items():
                made[b] = (i, t)

        def to_host(item):
            b, (i, t) = item
            host = bytearray(t.numel())
            torch.frombuffer(host, dtype=torch.uint8).copy_(t)
            return b, i, t, host

        with ThreadPoolExecutor(HOST_COPY_THREADS) as pool:
            copies = list(pool.map(to_host, sorted(made.items())))
        for b, i, t, host in copies:
            if self.holders[i]["where"] == "host":
                self.blobs[b] = torch.frombuffer(host, dtype=torch.uint8)
                src = LayerSrc(inmem_data=host, data_size=len(host),
                               meta=LayerMeta(location=LayerLocation.INMEM,
                                              source_type=SourceType.MEM))
            else:
                self.blobs[b] = t
                src = LayerSrc(inmem_data=host, device_array=t,
                               data_size=len(host),
                               meta=LayerMeta(location=LayerLocation.HBM,
                                              source_type=SourceType.MEM))
            self.holdings.setdefault(i, {})[b] = src
        del made, copies, t  # the host holders' device copies go
        self._probe()
        self.mark_baseline()

    def _probe(self) -> None:
        """The ceiling of the cross-card moves: for each (seeder card,
        dest card) pair that the assignment moves blobs over, the best of
        three 1 GiB copies after one that warms up, each pair alone;
        ``probe_gbps`` is their sum, since the pairs' links carry their
        moves at the same time (cells whose seeders hold device copies on
        other cards only)."""
        s = self.shape
        pairs = sorted({
            (self.node_dev[h], self.node_dev[d])
            for h, he in self.holders.items() if he["where"] == "hbm"
            for d, de in self.stages.items()
            if set(spec.holder_blobs(he, s)) & set(spec.holder_blobs(de, s))
            and self.node_dev[h].type == "cuda"
            and self.node_dev[h] != self.node_dev[d]}, key=str)
        if pairs:
            self.probe_gbps = sum(_copy_gbps(a, b) for a, b in pairs)

    def mark_baseline(self) -> None:
        """What the cards hold with no round alive: the holdings, and what
        the process keeps for good once a round has run (library
        workspaces).  ``release`` reports against it."""
        self._retained = None
        gc.collect()
        for k in self.cards:
            torch.cuda.synchronize(k)
            self._baseline[k] = torch.cuda.memory_allocated(k)

    # ----------------------------------------------------------------- round

    def release(self) -> Dict[int, int]:
        """Drop what the last round left; returns each card's allocated
        bytes above the set-up's baseline afterwards (0 when nothing of
        the round is left)."""
        self._retained = None
        gc.collect()
        return {k: torch.cuda.memory_allocated(k) - self._baseline[k]
                for k in self.cards}

    def round(self, prompt: torch.Tensor, traced: bool = False) -> dict:
        from distributed_llm_dissemination_tpu_torch.cli import podrun
        from distributed_llm_dissemination_tpu_torch.models import llama
        from distributed_llm_dissemination_tpu_torch.runtime import (
            pp_serve, send)
        from distributed_llm_dissemination_tpu_torch.utils import (
            telemetry, trace)

        left = self.release()
        send.release_upload_cache()
        send.reopen_upload_cache()
        telemetry.reset_run()
        trace.reset_run()

        marks: Dict[str, float] = {}
        out: Dict[str, Any] = {}
        chain = _SpanChain(traced)
        real_forward = pp_serve.pod_forward
        leader_cls = podrun._LEADERS[self.mode]
        recv_cls = podrun._RECEIVERS[self.mode]
        own_announce = recv_cls.__dict__.get("announce")
        announce = recv_cls.announce
        real_route = llama.route_topk
        routes: List[torch.Tensor] = []

        def route(weights_, cfg):
            w = real_route(weights_, cfg)
            routes.append(w > 0)
            return w

        def forward(*a, **k):
            if self.shape.n_experts:
                llama.route_topk = route
            t0 = time.monotonic()
            try:
                with _record("bench.pod_forward", traced):
                    res = real_forward(*a, **k)
            finally:
                llama.route_topk = real_route
            marks["forward_s"] = time.monotonic() - t0
            if res is not None:
                out["logits"] = res[0]
            if k.get("assembled") is not None:
                out["head"] = k["assembled"][3]
            return res

        def traced_announce(node_self):
            with _record("bench.announce", True):
                return announce(node_self)

        def on_delivered(leader, receivers, placement):
            marks["served"] = time.monotonic()
            with _record("bench.on_delivered", traced):
                logits = out.pop("logits", None)
                out["ids"] = (None if logits is None
                              else logits.argmax(-1).cpu())
                out["routes"] = [m.cpu() for m in routes]
                del logits
                out["counters"] = trace.counter_totals()
                out["phases"] = trace.phase_totals()
                out["solve_ms"] = getattr(leader, "solve_ms", None)
                self._retained = self._keep(receivers)
                self._retained["head"] = out.pop("head", None)

        pp_serve.pod_forward = forward
        podrun._LEADERS[self.mode] = _timed_leader(leader_cls, marks, chain)
        if traced:
            recv_cls.announce = traced_announce
        threads = set(threading.enumerate())
        t0 = time.monotonic()
        try:
            with _record("bench.run_pod", traced):
                summary = podrun.run_pod(
                    self.conf, mode=self.mode, timeout=600, gen=0,
                    on_delivered=on_delivered, device=self.device,
                    prompt=prompt[0].tolist(),
                    initial_layers={i: dict(r)
                                    for i, r in self.holdings.items()})
        finally:
            chain.close()
            pp_serve.pod_forward = real_forward
            podrun._LEADERS[self.mode] = leader_cls
            if traced:
                if own_announce is None:
                    del recv_cls.announce
                else:
                    recv_cls.announce = own_announce
        t_end = time.monotonic()
        stray = [t.name for t in threading.enumerate()
                 if t not in threads and t.is_alive()
                 and not t.name.startswith("torch-data-")]
        if "served" not in marks:
            raise RuntimeError(f"round did not serve: {summary}")
        return {
            "time_to_serve_s": marks["served"] - t0,
            "ttd_s": marks["ready"] - marks["started"],
            "boot_s": marks["booted"] - marks["ready"],
            "forward_s": marks.get("forward_s"),
            "round_s": t_end - t0,
            "solve_ms": out.get("solve_ms"),
            "counters": out.get("counters", {}),
            "phases": out.get("phases", {}),
            "ids": out.get("ids"),
            "routes": out.get("routes", []),
            "left_on_card": left,
            "stray_threads": stray,
        }

    def _keep(self, receivers) -> Dict[int, dict]:
        """The dests' landed blobs and booted stage leaves, kept until the
        next round starts (the last round's are judged after the window)."""
        kept = {}
        for r in receivers:
            i = r.node.my_id
            if i not in self.stages:
                continue
            res = r.boot_result
            kept[i] = {
                "blobs": {b: getattr(r.layers.get(b), "device_array", None)
                          for b in spec.holder_blobs(self.stages[i],
                                                     self.shape)},
                "params": None if res is None else res.params,
                "layer_ids": [] if res is None else list(res.layer_ids),
                "kind": None if res is None else res.kind,
            }
        return kept

    # ----------------------------------------------------------- comparison

    def check_delivery(self) -> Dict[str, int]:
        """The last round's dests against the blobs handed to the seeders:
        ``blobs_mismatched`` counts assigned blobs missing, off the dest's
        device, or differing in any byte; ``leaves_mismatched`` the booted
        stage leaves, and the head leaves the pod served with, that differ
        from the handed blobs' leaves or lie off their stage's card."""
        s = self.shape
        retained = self._retained or {}
        blobs_bad = leaves_bad = 0
        for i, st in sorted(self.stages.items()):
            kept = retained.get(i)
            want = spec.holder_blobs(st, s)
            layer_ids = [b for b in want if b != s.head_id]
            n_leaves = len(layout.layer_specs(s)) * len(layer_ids)
            if kept is None:
                blobs_bad += len(want)
                leaves_bad += n_leaves
                continue
            for b in want:
                arr = kept["blobs"].get(b)
                if (arr is None or torch.device(arr.device) != self.node_dev[i]
                        or not _bytes_equal(_u8(arr), self.blobs[b])):
                    blobs_bad += 1
            params = kept["params"]
            if (params is None or kept["kind"] != "stage"
                    or kept["layer_ids"] != layer_ids):
                leaves_bad += n_leaves
                continue
            for j, b in enumerate(layer_ids):
                want_leaves = layout.leaves(s, b, self.blobs[b])
                for name, leaf in want_leaves.items():
                    got = params[name][j]
                    if not _leaf_equal(got, leaf):
                        leaves_bad += 1
        head = retained.get("head") or {}
        head_dev = next(self.node_dev[i] for i, st in self.stages.items()
                        if st.get("head"))
        for name, leaf in layout.leaves(s, s.head_id,
                                        self.blobs[s.head_id]).items():
            got = head.get(name)
            if (got is None or torch.device(got.device) != head_dev
                    or not _leaf_equal(got, leaf)):
                leaves_bad += 1
        return {"blobs_mismatched": blobs_bad,
                "leaves_mismatched": leaves_bad}

    def reference_inputs(self):
        """The handed blobs' leaves for the reference, and its device (the
        first dest's)."""
        s = self.shape
        dev = self.node_dev[min(self.stages)]

        def layer_leaves(i):
            return layout.leaves(s, i, self.blobs[i])

        return layer_leaves, layout.leaves(s, s.head_id,
                                           self.blobs[s.head_id]), dev

    def close(self) -> None:
        self._retained = None
        self.holdings.clear()
        self.blobs.clear()
        gc.collect()
