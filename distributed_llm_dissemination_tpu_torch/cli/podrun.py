"""Single-controller pod driver: one process, whole mesh, fabric data plane.

Port of the JAX package's ``cli/podrun.py``.  One process hosts ALL the
topology's nodes (control plane on the in-memory transport), maps each
node to a pipeline stage of the configured slot mesh
(``parallel.mesh.fabric_placement``), and lets
every scheduled layer transfer ride the device fabric
(``parallel/fabric.py``): seeders upload their planned byte ranges to
their own stage's slot, destinations ingest them device to device.  No
layer byte touches the transport.

    python -m distributed_llm_dissemination_tpu_torch.cli.podrun \\
        -f conf.json -m 3 [-gen N] [-device cpu]

Prints the reference's "Time to deliver" and one machine-readable JSON
summary line.  With a ``Model`` in the config the assignees boot their
stages from the delivered blobs, the pod serves one pipelined forward
(``runtime.pp_serve.pod_forward``) and, with ``-gen N``, decodes N greedy
tokens across the stages (``pod_decode``).

Without ``-device`` the mesh's slots take the host's CUDA cards in order
(slot i on card ``i mod n_cards``, ``parallel.mesh.slot_devices``), so
stages on different cards hand their bytes over as peer copies; it
raises on a host without a card.  ``-device cuda:k`` pins every slot to
card k, ``-device cpu`` runs on the CPU.  Each node fabricates its
seeded layers on its own slot's device.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Dict

from ..core import config as cfg
from ..runtime import (
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    LeaderNode,
    Node,
    PullRetransmitLeaderNode,
    ReceiverNode,
    RetransmitLeaderNode,
    RetransmitReceiverNode,
)
from ..transport.inmem import InmemTransport
from ..utils import logging as ulog
from ..utils import trace as utrace

_LEADERS = {
    0: LeaderNode,
    1: RetransmitLeaderNode,
    2: PullRetransmitLeaderNode,
    3: FlowRetransmitLeaderNode,
}
_RECEIVERS = {
    0: ReceiverNode,
    1: RetransmitReceiverNode,
    2: RetransmitReceiverNode,
    3: FlowRetransmitReceiverNode,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="podrun", description=__doc__,
                                prefix_chars="-")
    p.add_argument("-f", type=str, required=True,
                   help="filename of topology JSON file (Mesh section "
                        "required; Fabric implied)")
    p.add_argument("-m", type=int, default=3, choices=[0, 1, 2, 3],
                   help="0: naive, 1: retransmit, 2: pull, 3: max-flow")
    p.add_argument("-boot", type=str, default="",
                   help="model config name: boot the model from the "
                        "fabric-delivered blobs and report TTFT")
    p.add_argument("-gen", type=int, default=0,
                   help="after a servable pipeline boot, greedy-decode "
                        "this many tokens across the pod (KV-cached)")
    p.add_argument("-device", type=str, default=None,
                   help="pin every mesh slot to this device ('cuda:k', or "
                        "'cpu' for a CPU run; default: slot i on the "
                        "host's CUDA card i mod n_cards)")
    p.add_argument("-report", type=str, default="",
                   help="write RUN_REPORT.{json,md} at this path/prefix "
                        "when the run completes (cli/report.py)")
    p.add_argument("-v", action="store_true", help="output debug messages")
    return p


def fabric_bandwidths(conf: cfg.Config) -> Dict[int, int]:
    """Per-node bandwidths for the mode-3 flow solve on a fabric: with
    ``Mesh.IciBW`` every node plans against that device-plane capacity
    (the NIC is not in the path; per-source LimitRates still cap
    seeders), else the configured NetworkBW."""
    ici = conf.mesh.ici_bw if conf.mesh is not None else 0
    return {nc.id: (ici if ici > 0 else nc.network_bw) for nc in conf.nodes}


def run_pod(conf: cfg.Config, mode: int = 3, boot: str = "",
            timeout: float = 600.0, gen: int = 0, on_delivered=None,
            report: str = "", device=None, prompt=None,
            initial_layers=None) -> Dict[str, float]:
    """Drive one full pod dissemination; returns the timing summary.

    ``device``: where the mesh slots run: None (or ``"cuda"``) = the
    host's cards in order, slot i on card ``i mod n_cards``;
    ``"cuda:k"`` or ``"cpu"`` pins every slot there.
    ``prompt``: token ids for the pod's forward and decode (default 16
    zeros, the boot prompt).  ``initial_layers``: ``{node_id: layers}``
    stores used instead of fabricating those nodes' initial layers from
    the config (a harness that already holds the seeded blobs).
    ``on_delivered(leader, receivers, placement)`` runs after serving,
    before any node closes."""
    if conf.mesh is None:
        raise SystemExit("podrun needs a Mesh section in the config")
    # The round's steps, back to back on this thread up to
    # ``on_delivered``, each a ``pod_*`` phase (and under a profiler a
    # ``dld.pod_*`` span).
    steps = utrace.Steps()
    started = set(threading.enumerate())
    leader = None
    receivers = []
    transports: Dict[int, InmemTransport] = {}
    try:
        steps.next("pod_build")
        import torch

        from ..parallel.fabric import FabricPlane
        from ..parallel.mesh import (device_slots, fabric_placement,
                                     mesh_from_conf)

        n_slots = 1
        for size in conf.mesh.axis_sizes:
            n_slots *= int(size)
        slot_devs = device_slots(n_slots, device)
        mesh = mesh_from_conf(conf.mesh, slot_devs)
        node_ids = [nc.id for nc in conf.nodes]
        placement = fabric_placement(node_ids, conf.assignment, mesh,
                                     conf.mesh.pipeline_axis)
        # Each node's own device: its stage's first slot's.
        node_dev = {n: placement.devices_for_node(n)[0].device
                    for n in node_ids}
        dev_name = (str(slot_devs[0]) if len(set(slot_devs)) == 1
                    else slot_devs[0].type)
        fabric = FabricPlane()
        ulog.log.info("pod fabric up", device=dev_name,
                      mesh={n: s for n, s in zip(conf.mesh.axis_names,
                                                 conf.mesh.axis_sizes)},
                      stages={str(n): s
                              for n, s in placement.node_to_stage.items()},
                      node_devices={str(n): str(d)
                                    for n, d in node_dev.items()})

        registry = {i: str(i) for i in node_ids}
        transports.update((nc.id, InmemTransport(str(nc.id),
                                                 addr_registry=registry))
                          for nc in conf.nodes)
        leader_conf = cfg.get_leader_conf(conf)
        from .main import boot_config  # same validation as the per-node CLI

        boot_cfg = boot_config(boot or conf.model)
        initial_layers = initial_layers or {}

        for nc in conf.nodes:
            if nc.id in initial_layers:
                layers = initial_layers[nc.id]
            else:
                layers = cfg.create_layers(nc, save_disk=False,
                                           model=conf.model,
                                           model_seed=conf.model_seed,
                                           model_codec=conf.model_codec,
                                           device=node_dev[nc.id])
            node = Node(nc.id, leader_conf.id, transports[nc.id])
            if nc.id == leader_conf.id:
                kwargs = dict(expected_nodes=set(node_ids),
                              fabric=fabric, placement=placement)
                if mode == 3:
                    leader = _LEADERS[3](node, layers, conf.assignment,
                                         fabric_bandwidths(conf),
                                         topology=conf.mesh.topology(),
                                         **kwargs)
                else:
                    leader = _LEADERS[mode](node, layers, conf.assignment,
                                            **kwargs)
                leader.boot_enabled = boot_cfg is not None
            else:
                # Only assignees boot (their stage of the pipeline); a
                # seeder's full copy is not served here.
                assigned = nc.id in conf.assignment
                receivers.append(_RECEIVERS[mode](
                    node, layers, fabric=fabric, placement=placement,
                    boot_cfg=boot_cfg if assigned else None,
                    boot_codec=conf.model_codec,
                ))
        steps.next("pod_announce")
        for r in receivers:
            r.announce()
        steps.next("pod_start")
        leader.start_distribution().get(timeout=timeout)
        steps.next("pod_deliver")
        t0 = time.monotonic()
        leader.ready().get(timeout=timeout)
        ttd = time.monotonic() - t0
        steps.next("pod_boot")
        ulog.log.info("Time to deliver", seconds=round(ttd, 6))
        print(f"Time to deliver: {ttd:.6f}s", flush=True)
        # Program reuse + phase attribution for THIS dissemination,
        # sampled at ready (before any boot).
        from ..parallel import plan_cache
        from ..utils import telemetry as utelemetry

        plan_cache.log_stats()
        tel_snap = utelemetry.snapshot()
        summary = {"mode": mode, "ttd_s": round(ttd, 6),
                   "nodes": len(node_ids), "fabric": True,
                   "device": dev_name,
                   "collective_cache": plan_cache.stats(),
                   "plan_phases": utrace.phase_totals(),
                   "telemetry": {"counters": tel_snap.get("counters"),
                                 "hists": tel_snap.get("hists")}}
        pred_ms = getattr(leader, "predicted_ttd_ms", 0)
        if pred_ms:
            summary["predicted_s"] = round(pred_ms / 1000.0, 6)
            summary["solve_ms"] = round(getattr(leader, "solve_ms", 0.0), 3)
        if boot_cfg is not None:
            booted = leader.boot_ready().get(timeout=timeout)
            ttft = time.monotonic() - t0
            ulog.log.info("Time to first token", seconds=round(ttft, 6))
            print(f"Time to first token: {ttft:.6f}s", flush=True)
            summary["ttft_s"] = round(ttft, 6)
            summary["boot_nodes"] = len(booted)
            # When the stage boots partition the model, the POD serves as
            # one pipelined model from the landed weights (pp_serve).
            from ..runtime.pp_serve import assemble_pp_params, pod_forward

            steps.next("pod_assemble")
            # The pod is its booted stages: the head comes from the stage
            # it landed on, never from a seeder's host copy.
            results = {r.node.my_id: r.boot_result for r in receivers}
            stores = {r.node.my_id: r.layers for r in receivers
                      if r.node.my_id in conf.assignment}
            assembled = assemble_pp_params(boot_cfg, placement, results,
                                           stores, conf.model_codec)
            steps.next("pod_forward")
            tokens = None
            if prompt is not None and assembled is not None:
                tokens = torch.as_tensor(prompt, dtype=torch.long).reshape(
                    1, -1).to(assembled[3]["embed"].device)
            served = pod_forward(boot_cfg, placement, results, stores,
                                 tokens=tokens, codec=conf.model_codec,
                                 assembled=assembled)
            if served is not None:
                _, pod_s = served
                summary["pod_forward_s"] = round(pod_s, 6)
                print(f"Pod pipelined forward: {pod_s:.6f}s", flush=True)
            if served is not None and gen > 0:
                from ..runtime.pp_serve import pod_decode

                steps.next("pod_decode")
                dec = pod_decode(boot_cfg, placement, results, stores,
                                 max_new=gen, prompt=tokens,
                                 codec=conf.model_codec,
                                 assembled=assembled)
                if dec is not None:
                    toks, dec_s = dec
                    summary["pod_decode_s"] = round(dec_s, 6)
                    summary["tokens"] = [int(t) for t in toks[0].tolist()]
                    print(f"Pod decoded {toks.shape[1]} tokens: "
                          f"{summary['tokens']}", flush=True)
        steps.close()
        if on_delivered is not None:
            on_delivered(leader, receivers, placement)
        if report:
            from . import report as report_mod

            rep = report_mod.build_from_leader(
                leader, ttd_s=ttd, ttft_s=summary.get("ttft_s"))
            paths = report_mod.write_report(rep, report)
            summary["run_report"] = paths["provenance"]
            print(f"Run report: {paths['json']} "
                  f"(provenance {paths['provenance']})", flush=True)
        print(json.dumps(summary), flush=True)
        return summary
    finally:
        steps.close()
        if leader is not None:
            leader.close()
        for r in receivers:
            r.close()
        for t in transports.values():
            t.close()
        _join_run_threads(started)


def _join_run_threads(started, timeout_s: float = 30.0) -> None:
    """Wait for the threads the run started (message loops, the plan
    window, boot stagers) to end.  ``close()`` only signals them; a
    process that exits while one is still inside a CUDA call aborts at
    interpreter teardown ("terminate called without an active
    exception").  The transport's process-wide data threads outlive the
    run and are not waited for."""
    from ..utils.threads import DATA_PREFIXES

    deadline = time.monotonic() + timeout_s
    for t in threading.enumerate():
        if t not in started and not t.name.startswith(DATA_PREFIXES):
            t.join(max(0.0, deadline - time.monotonic()))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ulog.configure(node="pod", verbose=args.v)
    conf = cfg.read_json(args.f)
    run_pod(conf, mode=args.m, boot=args.boot, gen=max(0, args.gen),
            report=args.report, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
