"""Process entry point: reference-compatible CLI.

Port of the JAX package's ``cli/main.py`` (a re-design of the reference's
``cmd/main.go``): same flags (``-id -f -s -m -l -c -v``,
cmd/main.go:15-21, and the extensions), same JSON config, same role
dispatch (leader / receiver / external client), same "Time to deliver"
measurement printed from the leader.  Run one process per node:

    python -m distributed_llm_dissemination_tpu_torch.cli.main -id 0 -f conf.json -m 1
    python -m distributed_llm_dissemination_tpu_torch.cli.main -id 1 -f conf.json -m 1
    python -m distributed_llm_dissemination_tpu_torch.cli.main -id 2 -f conf.json -c

An external client shares the node ID it is attached to (``-c`` selects the
client role for that ID, cmd/main.go:69-91).

Where the JAX CLI picks its platform from ``JAX_PLATFORMS``, this one takes
``-device``: seeded fabrication, ``-hbm`` staging, boot and serving run on
the CUDA card unless ``-device cpu`` is given, and a node that needs a
device on a machine without a card raises.  ``-hbm`` stages through the
placement (``parallel.mesh.assignment_to_placement``) on a slot mesh of
this process's device: the ``Mesh`` section's, else one slot per
assignee.  A ``Distributed`` section makes every node process join one
``torch.distributed`` process group before any device use
(``parallel/multihost.py``: gloo when processes share a card or run on
the CPU, nccl with one card each); with ``Mesh.Fabric`` the layer bytes
then move between the processes as collectives
(``parallel/spmd_fabric.py``) and a pipeline Assignment serves across
them on ``ServeMsg``.  ``Mesh.Fabric`` without a ``Distributed`` section
exits: ``cli.podrun`` drives the single-controller fabric.  ``hf:<dir>``
models read their checkpoint with ``models/hf.py``, which needs neither
``safetensors`` nor ``ml_dtypes``.
"""

from __future__ import annotations

import argparse
from typing import Optional
import os
import sys
import time

from ..core import config as cfg
from ..core.types import CLIENT_ID
from ..runtime import (
    Client,
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    LeaderNode,
    Node,
    PullRetransmitLeaderNode,
    ReceiverNode,
    RetransmitLeaderNode,
    RetransmitReceiverNode,
)
from ..transport import TcpTransport
from ..utils import logging as ulog

def build_parser() -> argparse.ArgumentParser:
    # Single-dash long flags, matching the Go CLI (cmd/main.go:15-21).
    p = argparse.ArgumentParser(
        prog="distributor", description=__doc__, prefix_chars="-"
    )
    p.add_argument("-id", type=int, required=True, help="my ID")
    p.add_argument("-f", type=str, required=True,
                   help="filename of topology JSON file")
    p.add_argument("-s", type=str, default="",
                   help="path of storing layers (empty: keep layers in RAM)")
    p.add_argument("-m", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0: naive, 1: retransmit, 2: pull, 3: max-flow")
    p.add_argument("-l", action="store_true",
                   help="create layer files and exit")
    p.add_argument("-c", action="store_true", help="if the process is client")
    p.add_argument("-v", action="store_true", help="output debug messages")
    # Extensions beyond the reference flag set (failure handling is its
    # TODO, node.go:218-220); both default off = exact reference behavior.
    p.add_argument("-ft", type=float, default=0.0,
                   help="leader: seconds of node silence before declaring "
                        "it crashed and re-planning (0: off)")
    p.add_argument("-hb", type=float, default=0.0,
                   help="receiver: heartbeat interval seconds (use ~ft/4; "
                        "0: off)")
    p.add_argument("-ckpt", type=str, default="",
                   help="receiver (mode 3): directory for durable partial-"
                        "layer checkpoints; a restarted receiver resumes "
                        "and only the missing byte ranges are re-sent")
    p.add_argument("-hbm", action="store_true",
                   help="receiver: stage each delivered layer into device "
                        "memory (a tensor on -device) before acking")
    p.add_argument("-device", type=str, default=None,
                   help="torch device for seeded fabrication, -hbm "
                        "staging, boot and serving (default: the CUDA "
                        "card, and an error when there is none; 'cpu' "
                        "runs them on the CPU)")
    p.add_argument("-boot", type=str, default="",
                   help="model config name (models.llama.CONFIGS), "
                        "hf:<checkpoint-dir>, or 'none': receivers boot the "
                        "model from the delivered layer blobs on startup; "
                        "the leader waits for every assignee's boot and "
                        "prints Time to first token (give the flag to both "
                        "roles).  A float16 checkpoint disseminates but "
                        "does not boot yet")
    p.add_argument("-gen", type=int, default=0,
                   help="receiver: after a full boot, greedily decode this "
                        "many tokens with the KV-cached serving loop "
                        "(models/generate.py) and log them — dissemination "
                        "ends at emitted tokens")
    p.add_argument("-bw", type=float, default=3600.0,
                   help="boot-wait bound in seconds: how long the leader "
                        "waits for missing boot reports (then exits 1) and "
                        "a receiver drains its own in-flight boot before "
                        "exiting; size to the slowest expected boot")
    p.add_argument("-test-drop-plan-seqs", type=str, default="",
                   help="TEST ONLY: comma-separated SPMD plan seqs whose "
                        "first delivery this process drops (fault "
                        "injection for the gap-recovery tests).  "
                        "Implemented by wrapping the transport in the "
                        "deterministic fault-injection layer "
                        "(transport/faults.py); armed exclusively by this "
                        "flag — environment variables cannot enable it")
    p.add_argument("-test-faults", type=str, default="",
                   help="TEST ONLY: deterministic fault-injection spec "
                        "for this process's transport "
                        "(transport/faults.rules_from_spec), e.g. "
                        "'seed=7,corrupt=9,dropin=13,dup=11,times=8' — "
                        "corrupt/drop inbound layer frames below the CRC "
                        "check, dup/delay/reset outbound sends.  The "
                        "integrity plane (docs/integrity.md) must recover "
                        "byte-exactly; armed exclusively by this flag")
    p.add_argument("-serve", type=float, default=0.0,
                   help="receiver: after a successful boot, stay alive "
                        "this many seconds answering GenerateReqMsg "
                        "inference requests (cli.genreq) from the "
                        "resident params; 0 = exit after boot as before")
    p.add_argument("-report", type=str, default="",
                   help="write RUN_REPORT.{json,md} at this path/prefix "
                        "when the run completes (cli/report.py): TTD/"
                        "TTFT, the per-(src,dest) link flight-recorder "
                        "table, integrity/failover event counts, clock "
                        "offsets, provenance hash.  Leader flag; a "
                        "receiver that assumed leadership mid-run "
                        "honors it too, so a failover run still yields "
                        "a report")
    p.add_argument("-watch", type=float, default=0.0,
                   help="leader: log the folded cluster telemetry table "
                        "('cluster telemetry' records) every N seconds "
                        "mid-run — the live where-is-every-byte status "
                        "hook (0: off; one dump always fires at "
                        "delivery)")
    p.add_argument("-lease", type=float, default=1.0,
                   help="control-plane HA (docs/failover.md; only active "
                        "when the config declares Standbys): the leader's "
                        "lease beacon interval in seconds; standbys "
                        "declare it dead after ~3x this (staggered by "
                        "succession rank) and take over")
    # Dissemination service plane (docs/service.md): the leader as a
    # long-lived multi-job daemon, plus the submitter/query tools.
    p.add_argument("-daemon", type=float, default=0.0,
                   help="leader: after the initial goal completes, stay "
                        "alive this many seconds as a dissemination "
                        "service accepting job submissions (-submit) — "
                        "version pushes, repair refills, A/B variants — "
                        "scheduled as one shared-capacity flow problem "
                        "with priorities (0: exit after the run as "
                        "before)")
    p.add_argument("-submit", type=str, default="",
                   help="submit one dissemination job to the running "
                        "leader daemon and exit: a JSON file (or inline "
                        "JSON) with JobID, Assignment ({dest: [layer "
                        "ids]} or nested metas), optional Priority "
                        "(higher preempts), Kind (push|repair|ab), and "
                        "Digests ({layer: 'xxh3:<hex>'} — content keys "
                        "for delta resolution).  Run from an idle seat: "
                        "-id must not collide with a live node process")
    p.add_argument("-jobs", action="store_true",
                   help="query the running leader daemon's admitted-job "
                        "table (states, remaining pairs, priorities) as "
                        "JSON on stdout and exit; same seat rules as "
                        "-submit")
    # Elastic membership (docs/membership.md): the operator verbs.
    p.add_argument("-join", action="store_true",
                   help="receiver: this seat is NOT part of the running "
                        "cluster's goal — send a JoinMsg to the leader "
                        "first (admitted as a dest immediately, as a "
                        "source once its holdings digest-verify), then "
                        "run the normal receiver loop.  The seat still "
                        "needs a topology entry for its own address")
    p.add_argument("-drain", type=int, default=-1, metavar="NODE",
                   help="one-shot operator tool: ask the running leader "
                        "to DRAIN node NODE — its unique holdings are "
                        "re-homed onto survivors before it is released "
                        "— print the answer, exit.  Run from an idle "
                        "seat like -submit/-jobs")
    # SLO-guarded rollout pipeline (docs/rollout.md): submit a rollout
    # via -submit (Kind "rollout" + Waves/SLO/Split in the spec); these
    # are the operator control verbs.
    p.add_argument("-rollouts", action="store_true",
                   help="query the running leader's rollout-pipeline "
                        "table (wave states, SLO verdicts, traffic "
                        "split, v1/v2 pools) as JSON and exit; same "
                        "seat rules as -jobs")
    p.add_argument("-rollout-pause", type=str, default="", metavar="ID",
                   help="pause rollout ID: no further waves commit "
                        "(in-flight dissemination and soaks finish)")
    p.add_argument("-rollout-resume", type=str, default="",
                   metavar="ID",
                   help="resume paused rollout ID: a rolled-back wave "
                        "is re-disseminated as a retry")
    p.add_argument("-rollout-split", type=str, default="",
                   metavar="ID:FRACTION",
                   help="set rollout ID's traffic-split knob (the "
                        "fraction of eligible traffic routed at v2 "
                        "replicas during soak), e.g. canary-v2:0.25")
    # Closed-loop autonomy (docs/autonomy.md): the policy engine's
    # operator verbs — query is open, enable/disable ride the
    # DLD_JOB_TOKEN admission gate like every other fleet mutation.
    p.add_argument("-policies", action="store_true",
                   help="query the running leader's policy engine "
                        "(armed rules, cooldowns, quarantine mask, "
                        "in-flight actions, audit tail) as JSON and "
                        "exit; same seat rules as -jobs")
    p.add_argument("-policy-enable", action="store_true",
                   help="re-enable automatic policy actioning on the "
                        "running leader (token-gated via DLD_JOB_TOKEN)")
    p.add_argument("-policy-disable", action="store_true",
                   help="drop the running leader's policy engine to "
                        "MANUAL: rules keep sensing (streaks/cooldowns "
                        "stay warm) but no action fires (token-gated "
                        "via DLD_JOB_TOKEN)")
    return p


def validate_boot_choice(args, conf) -> None:
    """`-boot <name>` naming a model different from the config's Model is
    a config error: the disseminated bytes are sized/laid out (and codec-
    encoded, conf.model_codec) for the config's model, so booting another
    one can only fail later as a swallowed boot error.  Fail fast at
    argument validation instead (like the -gen checks).  `-boot none`
    (opt out of booting) always passes."""
    if (args.boot and args.boot != "none" and conf.model
            and args.boot != conf.model):
        raise SystemExit(
            f"-boot {args.boot!r} names a different model than the "
            f"config's Model {conf.model!r}: the layer bytes on the wire "
            f"are the config model's; drop -boot or fix the config"
        )


def _resolve_model_config(name: str):
    """THE model-name resolution (CONFIGS entry or ``hf:<dir>``) —
    shared by the boot path and the wire-codec plane so a new naming
    scheme can't silently reach one and miss the other.  Raises
    KeyError/OSError/ValueError for unresolvable names; callers own the
    error policy (boot fails fast, the codec plane degrades to None)."""
    from ..models import hf

    if hf.is_hf(name):
        # A Hugging Face Llama checkpoint directory (models/hf.py).
        return hf.config_from_name(name)
    from ..models.llama import CONFIGS

    return CONFIGS[name]


def boot_config(name: str):
    if not name or name == "none":
        # "-boot none" opts a boot-capable topology (a Model section) out
        # of booting: dissemination-only runs, e.g. wire benchmarks.
        return None
    try:
        return _resolve_model_config(name)
    except KeyError:
        from ..models.llama import CONFIGS

        raise SystemExit(
            f"unknown -boot model {name!r}; known: {sorted(CONFIGS)}, "
            "none, hf:<checkpoint-dir>"
        )
    except (OSError, ValueError) as e:
        raise SystemExit(f"bad hf checkpoint for -boot {name!r}: {e}")


def build_codec_plane(conf: cfg.Config):
    """The node's wire-codec plane (docs/codec.md): built for every
    role of a model run — leaders use it to CHOOSE quantized transfers
    (conf.wire_codec governs), receivers to advertise decode capability
    and encode-serve as senders.  None for model-less topologies (codec
    sizes derive from the blob layouts)."""
    if not conf.model:
        return None
    from ..runtime.codec import WireCodecPlane

    try:
        mcfg = _resolve_model_config(conf.model)
    except (OSError, ValueError, KeyError) as e:
        ulog.log.warn("wire-codec plane unavailable for this model",
                      model=conf.model, err=repr(e))
        return None
    return WireCodecPlane(mcfg, model_codec=conf.model_codec,
                          wire_codec=conf.wire_codec)


def _parse_job_spec(raw: str) -> dict:
    """A -submit spec: a JSON file path, or inline JSON.  Assignment
    values may be layer-id LISTS (shorthand; default metas) or nested
    ``{layer: meta}`` maps (the wire shape)."""
    import json

    from ..core.types import LayerMeta

    text = raw
    if os.path.exists(raw):
        with open(raw) as f:
            text = f.read()
    try:
        spec = json.loads(text)
    except ValueError as e:
        raise SystemExit(f"-submit spec is neither a file nor JSON: {e}")
    if not spec.get("JobID"):
        raise SystemExit("-submit spec needs a JobID")
    asg_raw = spec.get("Assignment") or {}
    if not asg_raw:
        raise SystemExit("-submit spec needs a non-empty Assignment")
    try:
        assignment = {}
        for dest, lids in asg_raw.items():
            if isinstance(lids, dict):
                assignment[int(dest)] = {
                    int(l): LayerMeta.from_json(m or {})
                    for l, m in lids.items()}
            else:
                assignment[int(dest)] = {int(l): LayerMeta()
                                         for l in lids}
        spec["Assignment"] = assignment
        spec["Digests"] = {int(l): str(d)
                           for l, d in (spec.get("Digests") or {}).items()}
        spec["Avoid"] = [int(n) for n in spec.get("Avoid") or []]
    except (TypeError, ValueError) as e:
        raise SystemExit(
            f"-submit spec has non-integer node/layer keys: {e}")
    try:
        # Rollout pipeline (docs/rollout.md): the wave plan + SLO +
        # split ride a Kind "rollout" spec through the same submit.
        spec["Waves"] = [[int(n) for n in w]
                         for w in spec.get("Waves") or []]
        spec["SLO"] = dict(spec.get("SLO") or {})
        # -1 = unset (the rollout default); an explicit 0.0 is honored.
        spec["Split"] = float(spec.get("Split", -1.0))
    except (TypeError, ValueError) as e:
        raise SystemExit(
            f"-submit spec has a malformed Waves/SLO/Split field: {e}")
    return spec


def _oneshot_leader_rpc(args, conf: cfg.Config, reply_cls, make_msg,
                        timeout: float, timeout_error: str):
    """The one-shot operator-tool scaffolding shared by -submit/-jobs/
    -drain: bind this idle seat's address, send one request to the
    leader (``make_msg(leader_id)``), await one ``reply_cls`` reply.
    Returns the reply, or None after ``timeout`` (the caller prints
    ``timeout_error``).  Like cli.genreq, -id must name a topology seat
    NOT also running cli.main (the reply multiplexes on the seat's
    address)."""
    import json
    import queue as _queue

    from ..runtime.node import MessageLoop

    node_conf = cfg.get_node_conf(conf, args.id)
    leader_id = cfg.get_leader_conf(conf).id
    if args.id == leader_id:
        raise SystemExit("one-shot tools must run from a non-leader "
                         "seat (the leader process owns that address)")
    transport = TcpTransport(node_conf.addr,
                             addr_registry={nc.id: nc.addr
                                            for nc in conf.nodes})
    loop = MessageLoop(transport)
    replies: "_queue.Queue" = _queue.Queue()
    loop.register(reply_cls, replies.put)
    loop.start()
    try:
        transport.send(leader_id, make_msg(leader_id))
        try:
            return replies.get(timeout=timeout)
        except _queue.Empty:
            print(json.dumps({"error": timeout_error}))
            return None
    finally:
        loop.stop()
        transport.close()


def run_jobtool(args, conf: cfg.Config) -> int:
    """The -submit / -jobs one-shot tools (docs/service.md): send the
    request to the leader daemon, print its JobStatusMsg reply as
    JSON, exit."""
    import json

    from ..transport.messages import JobStatusMsg, JobSubmitMsg

    def make_msg(leader_id):
        if args.submit:
            spec = _parse_job_spec(args.submit)
            return JobSubmitMsg(
                args.id, str(spec["JobID"]), spec["Assignment"],
                priority=int(spec.get("Priority", 0)),
                kind=str(spec.get("Kind", "push")),
                digests=spec["Digests"], avoid=spec["Avoid"],
                version=str(spec.get("Version", "")),
                swap_base=int(spec.get("SwapBase", -1)),
                # Admission control (docs/service.md): a token-armed
                # leader daemon rejects unauthenticated submits; the
                # operator exports the same secret on both sides.
                auth=os.environ.get("DLD_JOB_TOKEN", ""),
                waves=spec["Waves"], slo=spec["SLO"],
                split=spec["Split"])
        return JobStatusMsg(args.id, query=True)

    resp = _oneshot_leader_rpc(
        args, conf, JobStatusMsg, make_msg, timeout=30.0,
        timeout_error="no reply from the leader daemon (is it running "
                      "with -daemon?)")
    if resp is None:
        return 1
    out = {"leader_epoch": resp.epoch, "jobs": resp.jobs}
    if resp.error:
        out["error"] = resp.error
    print(json.dumps(out, indent=1, sort_keys=True))
    return 1 if resp.error else 0


def run_rollouttool(args, conf: cfg.Config) -> int:
    """The rollout-pipeline operator verbs (docs/rollout.md): query /
    pause / resume / set-split against the running leader, print its
    RolloutCtlMsg reply (the full rollout table) as JSON, exit."""
    import json

    from ..transport.messages import RolloutCtlMsg

    # One mutating verb per invocation: the leader's verb chain
    # executes exactly one, so combined flags would silently drop (or
    # worse, mis-target) the rest — refuse up front.
    if sum(map(bool, (args.rollout_pause, args.rollout_resume,
                      args.rollout_split))) > 1:
        raise SystemExit("pick ONE of -rollout-pause / -rollout-resume"
                         " / -rollout-split per invocation")
    rid, split = "", -1.0
    if args.rollout_split:
        rid, _, frac = args.rollout_split.rpartition(":")
        if not rid:
            raise SystemExit("-rollout-split wants ID:FRACTION")
        try:
            split = float(frac)
        except ValueError:
            raise SystemExit(f"-rollout-split fraction is not a "
                             f"number: {frac!r}")
    elif args.rollout_pause:
        rid = args.rollout_pause
    elif args.rollout_resume:
        rid = args.rollout_resume

    resp = _oneshot_leader_rpc(
        args, conf, RolloutCtlMsg,
        lambda leader_id: RolloutCtlMsg(
            args.id, rollout_id=rid, query=args.rollouts,
            pause=bool(args.rollout_pause),
            resume=bool(args.rollout_resume), split=split,
            # Mutating verbs ride the job-token admission gate
            # (docs/service.md): the operator exports the same secret.
            auth=os.environ.get("DLD_JOB_TOKEN", "")),
        timeout=30.0,
        timeout_error="no rollout answer from the leader (is it "
                      "running?)")
    if resp is None:
        return 1
    out = {"leader_epoch": resp.epoch, "rollouts": resp.table}
    if resp.error:
        out["error"] = resp.error
    print(json.dumps(out, indent=1, sort_keys=True))
    return 1 if resp.error else 0


def run_policytool(args, conf: cfg.Config) -> int:
    """The autonomy operator verbs (docs/autonomy.md): query the policy
    engine's table / enable / disable automatic actioning against the
    running leader, print its PolicyCtlMsg reply as JSON, exit."""
    import json

    from ..transport.messages import PolicyCtlMsg

    # One mutating verb per invocation, same refusal as the rollout
    # verbs — the leader executes exactly one.
    if args.policy_enable and args.policy_disable:
        raise SystemExit("pick ONE of -policy-enable / -policy-disable "
                         "per invocation")

    resp = _oneshot_leader_rpc(
        args, conf, PolicyCtlMsg,
        lambda leader_id: PolicyCtlMsg(
            args.id, query=args.policies,
            enable=bool(args.policy_enable),
            disable=bool(args.policy_disable),
            # Mutating verbs ride the job-token admission gate
            # (docs/service.md): the operator exports the same secret.
            auth=os.environ.get("DLD_JOB_TOKEN", "")),
        timeout=30.0,
        timeout_error="no policy answer from the leader (is it "
                      "running?)")
    if resp is None:
        return 1
    out = {"leader_epoch": resp.epoch, "policies": resp.table}
    if resp.error:
        out["error"] = resp.error
    print(json.dumps(out, indent=1, sort_keys=True))
    return 1 if resp.error else 0


def run_draintool(args, conf: cfg.Config) -> int:
    """The -drain NODE one-shot (docs/membership.md): ask the leader to
    drain the named node, print its DONE (or refusal) answer as JSON,
    exit."""
    import json

    from ..transport.messages import DrainMsg

    resp = _oneshot_leader_rpc(
        args, conf, DrainMsg,
        lambda leader_id: DrainMsg(args.id, node=args.drain),
        timeout=120.0,
        timeout_error="no drain answer from the leader (is it "
                      "running?)")
    if resp is None:
        return 1
    out = {"node": resp.node, "done": resp.done,
           "leader_epoch": resp.epoch}
    if resp.error:
        out["error"] = resp.error
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0 if resp.done else 1


def run_client(args, conf: cfg.Config) -> int:
    """External-client role: serve layers to the node with my ID
    (cmd/main.go:69-91, 217-220)."""
    client_conf = cfg.get_client_conf(conf, args.id)
    node_conf = cfg.get_node_conf(conf, args.id)
    transport = TcpTransport(
        client_conf.addr,
        addr_registry={node_conf.id: node_conf.addr},
        is_client=True,
    )
    layers = {
        lid: cfg.create_client_layer(lid, conf.layer_size, rate)
        for lid, rate in client_conf.layers_rate_limit.items()
    }
    Client(args.id, transport, layers)
    ulog.log.info("client ready", addr=client_conf.addr)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0


def resolve_groups(conf: cfg.Config, mode: Optional[int] = None):
    """The config's ``Groups`` section → the resolved group table
    (docs/hierarchy.md), or None for flat control.  One resolution
    shared by the leader (planner + dispatch), the member seats (their
    control parent is the sub-leader), and the sub-leader seats (they
    attach a SubLeaderController) — and therefore the ONE place the
    mode-3 requirement is enforced: EVERY role must refuse a
    mis-moded hierarchical config, or members re-point at a
    sub-leader that will never plan and hang instead of erroring."""
    if conf.groups is None:
        return None
    if mode is not None and mode != 3:
        raise SystemExit(
            "Groups (hierarchical control, docs/hierarchy.md) requires "
            f"mode 3; got mode {mode}")
    from ..runtime.hierarchy import groups_from_config

    leader_id = cfg.get_leader_conf(conf).id
    return groups_from_config(conf.groups, [nc.id for nc in conf.nodes],
                              leader_id) or None


def resolve_pods(conf: cfg.Config, mode: Optional[int] = None):
    """The config's ``Pods`` section → ``{pod_id: [members]}`` for the
    mode-3 leader (fabric-assisted pod delivery, docs/fabric.md), or
    None.  Config-time validation (disjoint, known ids) already ran in
    ``Config.from_json``; the leader seat is re-checked at leader
    construction."""
    if conf.pods is None:
        return None
    if mode is not None and mode != 3:
        raise SystemExit(
            "Pods (fabric-assisted pod delivery, docs/fabric.md) "
            f"requires mode 3; got mode {mode}")
    return {pid: list(members) for pid, members in enumerate(conf.pods)}


def run_leader(args, conf: cfg.Config, node: Node, layers,
               device=None) -> int:
    """Leader role: constructor per mode, then drive the TTD timer
    (cmd/main.go:149-181).  ``device``: this process's device (its fabric
    slot under a ``Distributed`` section)."""
    assignment = conf.assignment
    # Wait for every configured node to announce, seeders included, so the
    # schedule sees all sources (the reference waits only for assignees and
    # races seeder announcements).  IDLE SEATS — nodes seeding nothing
    # (neither initial layers nor an attached external client), assigned
    # nothing — are excluded: they can't affect the schedule, and they may
    # not run cli.main at all (e.g. a cli.genreq requester seat that only
    # needs a dialable address in the topology).
    client_nodes = {cc.id for cc in conf.clients}
    expected = {
        nc.id for nc in conf.nodes
        if nc.is_leader
        or nc.id in assignment
        or nc.id in client_nodes
        or any((nc.initial_layers or {}).values())
    }
    ft = args.ft
    fabric, placement = build_spmd_fabric(args, conf, device)
    common = dict(expected_nodes=expected, failure_timeout=ft,
                  fabric=fabric, placement=placement,
                  codecs=build_codec_plane(conf))
    if conf.standbys:
        # Control-plane HA (docs/failover.md): replicate control state
        # to the declared standbys, beacon the lease, fence by epoch.
        common.update(standbys=list(conf.standbys),
                      lease_interval=max(args.lease, 0.05), epoch=0)
    groups = resolve_groups(conf, args.m)
    pods = resolve_pods(conf, args.m)
    if args.m == 0:
        leader = LeaderNode(node, layers, assignment, **common)
    elif args.m == 1:
        leader = RetransmitLeaderNode(node, layers, assignment, **common)
    elif args.m == 2:
        leader = PullRetransmitLeaderNode(node, layers, assignment, **common)
    else:
        bw = {nc.id: nc.network_bw for nc in conf.nodes}
        topo = conf.mesh.topology() if conf.mesh is not None else None
        if groups is not None:
            from ..runtime import HierarchicalFlowLeaderNode

            leader = HierarchicalFlowLeaderNode(
                node, layers, assignment, bw, groups=groups,
                topology=topo, pods=pods, **common)
        else:
            leader = FlowRetransmitLeaderNode(node, layers, assignment, bw,
                                              topology=topo, pods=pods,
                                              **common)

    # One flag governs the run: the leader's decision rides StartupMsg,
    # so receivers can never boot (or skip) against the leader's wait.
    validate_boot_choice(args, conf)
    leader.boot_enabled = boot_config(args.boot or conf.model) is not None
    # Pod serving decodes -gen tokens (rides the ServeMsg): the leader's
    # flag governs the whole pod, like the boot decision.
    leader.serve_generate = max(0, args.gen)
    # Closed-loop autonomy (docs/autonomy.md): arm the config's
    # validated Policies block.  A bad block already failed LOUDLY at
    # config parse (core/config.py → policy.validate_policies).
    if conf.policies:
        leader.policy.arm(conf.policies)

    print(
        f"launching leader...\n[addr: {node.transport.get_address()}, "
        f"id: {args.id}, filename: {args.f}, storagePath: {args.s}, mode: {args.m}]",
        flush=True,
    )
    if args.watch > 0:
        # Mid-run status hook: the folded cluster table lands in the
        # log stream every interval (daemon — dies with the process).
        import threading as _threading

        def _watch_loop():
            while True:
                time.sleep(args.watch)
                try:
                    leader.log_cluster_metrics()
                except Exception as e:  # noqa: BLE001 — advisory hook
                    ulog.log.debug("cluster metrics watch failed",
                                   err=repr(e))

        _threading.Thread(target=_watch_loop, daemon=True,
                          name="telemetry-watch").start()

    ttft = None
    t_ready_mono = None

    def write_run_report(ttd_s):
        """RUN_REPORT.{json,md} from the leader's folded cluster
        telemetry — written on every exit path that has a TTD, so a
        failed boot still leaves the evidence behind.  First the
        leader's own summary for harnesses reading its log: its trace
        counters (the ``fallback.*`` host-path routes) and the link
        table of the bytes it moved over the transport."""
        from ..utils import telemetry, trace

        ulog.log.info("leader summary", counters=trace.counter_totals(),
                      links=telemetry.snapshot().get("links", {}))
        if not args.report:
            return
        from . import report as report_mod

        # Freshness gate: receivers flush a final snapshot on startup;
        # wait (bounded) until every known node's report post-dates the
        # ready event so a fast run's report carries completion totals.
        if t_ready_mono is not None:
            leader.await_metrics(newer_than=t_ready_mono)
        # One more dump with the final fold, so OFFLINE reconstruction
        # from this process's log gets completion totals too.
        leader.log_cluster_metrics()
        try:
            rep = report_mod.build_from_leader(leader, ttd_s=ttd_s,
                                               ttft_s=ttft)
            paths = report_mod.write_report(rep, args.report)
        except OSError as e:
            ulog.log.error("run report write failed", err=repr(e))
            return
        ulog.log.info("run report written", **paths)
        print(f"Run report: {paths['json']} "
              f"(provenance {paths['provenance']})", flush=True)

    leader.start_distribution().get()
    t0 = time.monotonic()
    leader.ready().get()
    t_ready_mono = time.monotonic()
    ttd = t_ready_mono - t0
    ulog.log.info("Time to deliver", seconds=round(ttd, 6))
    print(f"Time to deliver: {ttd:.6f}s", flush=True)
    pred_ms = getattr(leader, "predicted_ttd_ms", 0)
    if pred_ms:
        # Mode 3 plan fidelity: the solver's min-time next to achieved
        # TTD.
        solve_ms = getattr(leader, "solve_ms", 0.0)
        ulog.log.info("Predicted time to deliver",
                      seconds=round(pred_ms / 1000.0, 6),
                      solve_ms=round(solve_ms, 3))
        print(f"Predicted time to deliver: {pred_ms / 1000.0:.6f}s "
              f"(solve {solve_ms:.3f}ms)", flush=True)
    if leader.boot_enabled:
        # Receivers boot their model from the delivered blobs and report
        # back; TTFT = timer start → last boot report (includes TTD).
        # Bounded: failed boots now report (kind "failed") and crashes
        # shrink the wait, but a hard-killed dest with failure detection
        # off (-ft 0) still can't unblock it — exit loudly instead of
        # hanging the whole deployment.
        import queue as _queue

        try:
            booted = leader.boot_ready().get(timeout=args.bw)
        except _queue.Empty:
            ulog.log.error("boot wait timed out; missing reports",
                           booted=sorted(leader.boots_seen()))
            print(f"Boot wait timed out after {args.bw:g}s", flush=True)
            write_run_report(ttd)
            return 1
        ttft = time.monotonic() - t0
        kinds = leader.boot_kinds()
        ulog.log.info("Time to first token", seconds=round(ttft, 6),
                      nodes={str(n): round(s, 3) for n, s in booted.items()},
                      kinds={str(n): k for n, k in kinds.items()})
        print(f"Time to first token: {ttft:.6f}s", flush=True)
        failed = sorted(n for n, k in kinds.items()
                        if k in ("failed", "crashed"))
        if failed:
            print(f"Boot FAILED on nodes {failed}", flush=True)
            write_run_report(ttd)
            return 1
    if args.daemon > 0:
        # Dissemination service (docs/service.md): stay alive as a
        # long-lived daemon accepting -submit jobs; each completed job
        # cycle re-fires ready() and logs the admitted-job table.
        import json as _json
        import queue as _queue

        print(f"daemon: accepting job submissions for {args.daemon:g}s",
              flush=True)
        deadline = time.monotonic() + args.daemon
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                goal = leader.ready().get(timeout=min(1.0, left))
            except _queue.Empty:
                continue
            ulog.log.info("job cycle complete", dests=sorted(goal),
                          jobs=leader.jobs.table())
            print(f"jobs: {_json.dumps(leader.jobs.table(), sort_keys=True)}",
                  flush=True)
        t_ready_mono = time.monotonic()  # freshness-gate the final report
    write_run_report(ttd)
    return 0


def build_placement(args, conf: cfg.Config, device):
    """The Assignment → pipeline-stage placement when HBM staging is on,
    the placement through which each delivered fragment lands on the
    device as it arrives (without one, a layer is staged in bulk once
    complete).  A ``Mesh`` section gives its slot mesh, every slot on
    this process's ``device``; without one, every stage is a slot on
    ``device``."""
    if not args.hbm:
        return None
    from ..parallel.mesh import assignment_to_placement, mesh_from_conf

    if conf.mesh is not None:
        n = 1
        for size in conf.mesh.axis_sizes:
            n *= int(size)
        placement = assignment_to_placement(
            conf.assignment, mesh_from_conf(conf.mesh, [device] * n),
            conf.mesh.pipeline_axis)
    else:
        placement = assignment_to_placement(conf.assignment, [device])
    ulog.log.info(
        "device placement", device=str(device),
        mesh=dict(placement.mesh.shape),
        stages={str(n): s for n, s in placement.node_to_stage.items()},
    )
    return placement


def build_spmd_fabric(args, conf: cfg.Config, device):
    """(fabric, placement) for a Mesh.Fabric + Distributed topology: the
    multi-controller fabric (``parallel/spmd_fabric.py``) over the host-
    aligned slots of the process group, with a placement covering EVERY
    node (seeders upload through their own stages).  Returns (None, None)
    when the config doesn't ask for it."""
    if conf.mesh is None or not conf.mesh.fabric:
        return None, None
    from ..parallel import multihost
    from ..parallel.mesh import fabric_placement, mesh_from_conf
    from ..parallel.spmd_fabric import SpmdFabric

    mesh = mesh_from_conf(
        conf.mesh, multihost.host_aligned_device_order(conf, conf.assignment)
    )
    placement = fabric_placement(
        [nc.id for nc in conf.nodes], conf.assignment, mesh,
        conf.mesh.pipeline_axis,
    )
    fabric = SpmdFabric(
        placement, args.id,
        gap_timeout=float(os.environ.get("DLD_SPMD_GAP_TIMEOUT", "60")),
        device=device,
    )
    ulog.log.info(
        "spmd fabric up", backend=multihost.backend(), device=str(device),
        stages={str(n): s for n, s in placement.node_to_stage.items()},
    )
    return fabric, placement


def run_receiver(args, conf: cfg.Config, node: Node, layers,
                 device=None) -> int:
    """Receiver role (cmd/main.go:183-215).  ``device``: where staging,
    boot and serving run."""
    fabric, placement = build_spmd_fabric(args, conf, device)
    if fabric is None:
        placement = build_placement(args, conf, device)
    # A config with a Model section is boot-capable: receivers boot by
    # default so the leader's boot wait can't hang on a missing flag.
    validate_boot_choice(args, conf)
    boot_cfg = boot_config(args.boot or conf.model)
    if args.gen < 0:
        raise SystemExit(f"-gen must be >= 0, got {args.gen}")
    if args.gen > 0 and boot_cfg is None:
        raise SystemExit(
            "-gen needs a bootable model: give -boot <name> or a config "
            "with a Model section"
        )
    codec = conf.model_codec
    common = dict(heartbeat_interval=args.hb, stage_hbm=args.hbm,
                  placement=placement, boot_cfg=boot_cfg, boot_codec=codec,
                  fabric=fabric, boot_generate=args.gen,
                  codecs=build_codec_plane(conf), device=device)
    if args.m == 0:
        receiver = ReceiverNode(node, layers, args.s or ".", **common)
    elif args.m in (1, 2):
        receiver = RetransmitReceiverNode(node, layers, args.s or ".",
                                          **common)
    else:
        receiver = FlowRetransmitReceiverNode(node, layers, args.s or ".",
                                              checkpoint_dir=args.ckpt,
                                              **common)
    # Announce-carried NIC rate (docs/membership.md): this seat's own
    # configured rate rides its announce, so a leader admitting it as a
    # JOINER models the real link instead of pinning the most
    # conservative configured value.
    try:
        receiver.nic_bw = int(cfg.get_node_conf(conf, args.id).network_bw
                              or 0)
    except (AttributeError, ValueError, KeyError):
        pass

    groups = resolve_groups(conf, args.m)
    sub_ctl = None
    if groups is not None:
        for gid, rec in groups.items():
            if rec["leader"] == args.id:
                # This seat owns a group (docs/hierarchy.md): attach
                # the sub-leader controller on the already-running loop
                # — member announces/acks/heartbeats/metrics fold here.
                from ..runtime import SubLeaderController

                sub_ctl = SubLeaderController(
                    receiver, gid, rec["members"],
                    member_timeout=args.ft)
                ulog.log.info("sub-leader controller armed", group=gid,
                              members=rec["members"])
                break

    standby_ctl = None
    if args.id in conf.standbys:
        # This seat is in the leader succession: shadow the control
        # state and take over (at a bumped, fenced epoch) if the
        # leader's lease expires (docs/failover.md).
        from ..runtime import StandbyController

        bw = {nc.id: nc.network_bw for nc in conf.nodes}
        standby_ctl = StandbyController(
            receiver, rank=conf.standbys.index(args.id),
            lease_timeout=max(args.lease, 0.05) * 3,
            standbys=list(conf.standbys), mode=args.m,
            node_network_bw=bw, failure_timeout=args.ft,
            lease_interval=max(args.lease, 0.05),
        )
        ulog.log.info("standby controller armed",
                      rank=conf.standbys.index(args.id),
                      succession=conf.standbys)

    print(
        f"launching receiver...\n[addr: {node.transport.get_address()}, "
        f"id: {args.id}, filename: {args.f}, storagePath: {args.s}, mode: {args.m}]",
        flush=True,
    )
    # Elastic membership (docs/membership.md): an explicit -join seat —
    # or one whose seeded churn schedule (-test-faults join=T) says it
    # appears late — JOINS the running cluster instead of announcing as
    # a configured member.
    join_wait = getattr(node.transport, "seconds_until_join",
                        lambda: None)()
    if args.join or join_wait is not None:
        if join_wait:
            ulog.log.info("churn schedule: dark until join",
                          seconds=round(join_wait, 3))
            time.sleep(join_wait)
        if not receiver.join():
            ulog.log.error("join was never admitted; exiting")
            return 1
        print("joined", flush=True)
    else:
        receiver.announce()
    leave_wait = getattr(node.transport, "seconds_until_leave",
                         lambda: None)()
    if leave_wait is not None:
        # The seeded departure: drain gracefully at the scheduled
        # moment, then release the startup wait so the process exits
        # cleanly (a drained seat never receives a StartupMsg).
        import threading as _threading

        def _scheduled_leave():
            time.sleep(leave_wait)
            ok = receiver.request_drain()
            ulog.log.info("scheduled drain finished", ok=ok)
            print(f"drained (ok={ok})", flush=True)
            receiver.release_ready()

        _threading.Thread(target=_scheduled_leave, daemon=True,
                          name="churn-leave").start()
    receiver.ready().get()
    if standby_ctl is not None and standby_ctl.promoted.is_set():
        # This process took over mid-run: it IS the leader now — report
        # the recovery like a leader would report TTD.
        leader = standby_ctl.leader
        ulog.log.info("this process assumed leadership during the run",
                      epoch=leader.epoch)
        print(f"assumed leadership (epoch {leader.epoch})", flush=True)
        if args.report:
            # The dead leader can't write its RUN_REPORT; the adopted
            # one can — its cluster table was replicated before the
            # takeover and refreshed by every node's cumulative reports
            # since (TTD is the dead leader's clock and stays unset).
            from . import report as report_mod

            try:
                rep = report_mod.build_from_leader(leader)
                paths = report_mod.write_report(rep, args.report)
                ulog.log.info("run report written by adopted leader",
                              **paths)
                print(f"Run report: {paths['json']} "
                      f"(provenance {paths['provenance']})", flush=True)
            except OSError as e:
                ulog.log.error("run report write failed", err=repr(e))
    if sub_ctl is not None:
        # A one-shot sub-leader must not exit before its members' final
        # telemetry flushes folded upward (docs/hierarchy.md).
        sub_ctl.drain()
    ulog.log.info("received startup: ready")
    print("ready", flush=True)
    if receiver.expect_serve:
        # Multi-controller serving: a ServeMsg follows startup; stay
        # alive to enter the pod-wide pipelined forward (pp_serve).
        # Two clocks on purpose.  The first spans EVERY member's stage
        # boot (the leader dispatches ServeMsg — or an explicit cancel —
        # only after the last BootReadyMsg), so it is generous; it is a
        # backstop against a dead leader, not the normal release path.
        # The second covers the collective itself — exiting
        # mid-collective would crash the healthy members.
        import queue as _queue

        if not receiver.serve_started.wait(timeout=1800.0):
            ulog.log.error("expected ServeMsg never arrived")
        else:
            try:
                receiver.serve_done().get(timeout=3600.0)
            except _queue.Empty:
                ulog.log.error("pod serve never completed")
    # A started boot runs on daemon threads: exiting now would kill it
    # silently and strand the leader's TTFT wait on the missing report.
    if not receiver.wait_boot_drain(timeout=args.bw):
        ulog.log.error("boot still running at exit timeout; leaving")
    if args.serve > 0 and receiver.boot_result is not None:
        # Inference window: the booted engine answers GenerateReqMsg
        # (cli.genreq) from its resident params until the window closes.
        ulog.log.info("serving generation requests",
                      window_s=args.serve)
        print(f"serving for {args.serve:g}s", flush=True)
        time.sleep(args.serve)
    if args.daemon > 0:
        # Dissemination service (docs/service.md): the leader daemon
        # keeps admitting jobs, so this seat keeps receiving (and
        # serving) layers — its message loop stays live for the window.
        ulog.log.info("daemon window: serving dissemination jobs",
                      window_s=args.daemon)
        print(f"daemon: serving jobs for {args.daemon:g}s", flush=True)
        time.sleep(args.daemon)
    # What this process did, for harnesses reading its log: its trace
    # counters (staging routes, fallbacks), its per-link byte table and
    # the attention kernels it launched (warm-up, boot and every served
    # request; CPU tensors take the plain version and launch none).  A
    # node with no device ran no attention and never loads torch.
    from ..utils import telemetry, trace

    attention = dict(attention_launches=0, attention_launches_by_kernel={},
                     attention_launches_by_device={},
                     attention_plain_calls=0)
    if device is not None:
        from ..ops import flash_attention

        attention = dict(attention_launches=flash_attention.launches,
                         attention_launches_by_kernel=dict(
                             flash_attention.launches_by_kernel),
                         attention_launches_by_device={
                             d: dict(n) for d, n in
                             flash_attention.launches_by_device.items()},
                         attention_plain_calls=flash_attention.plain_calls)
    ulog.log.info("receiver summary", counters=trace.counter_totals(),
                  links=telemetry.snapshot().get("links", {}), **attention)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ulog.configure(node=str(args.id), verbose=args.v)
    conf = cfg.read_json(args.f)

    if args.submit or args.jobs:
        # One-shot service tools: no fabrication, no role loop — talk
        # to the running leader daemon and exit (docs/service.md).
        return run_jobtool(args, conf)

    if (args.rollouts or args.rollout_pause or args.rollout_resume
            or args.rollout_split):
        # One-shot rollout-pipeline tools (docs/rollout.md).
        return run_rollouttool(args, conf)

    if args.policies or args.policy_enable or args.policy_disable:
        # One-shot autonomy tools (docs/autonomy.md).
        return run_policytool(args, conf)

    if args.drain >= 0:
        # One-shot membership tool (docs/membership.md): ask the leader
        # to drain the named node and report its answer.
        return run_draintool(args, conf)

    if args.c:
        return run_client(args, conf)

    if (conf.mesh is not None and conf.mesh.fabric
            and conf.distributed is None):
        # One OS process per node cannot share an in-process FabricPlane;
        # refusing beats silently running the TCP data plane the config
        # opted out of.  Checked BEFORE any distributed init: joining the
        # process group blocks on every rank, and a doomed run must fail
        # fast instead.  WITH a Distributed section the processes join one
        # process group and the multi-controller fabric
        # (parallel/spmd_fabric.py) carries the layer bytes instead.
        raise SystemExit(
            "config has Mesh.Fabric=true but no Distributed section: the "
            "in-process pod-fabric data plane runs all nodes under one "
            "controller — use "
            "`python -m distributed_llm_dissemination_tpu_torch.cli.podrun "
            f"-f {args.f} -m {args.m}`, add a Distributed section for the "
            "multi-controller SPMD fabric, or drop the Fabric flag to run "
            "per-node processes over TCP"
        )

    # The device, resolved once for the roles that touch one: seeded
    # fabrication, staging, boot, serving, and every node of a
    # Distributed section (each is a rank with a device).  None = the
    # CUDA card, which raises on a machine without one.
    device = None
    if (conf.model or args.hbm or boot_config(args.boot) is not None
            or conf.distributed is not None):
        import torch

        from ..utils.device import resolve_device

        want = torch.device(args.device or "cuda")
        if want.type == "cuda" and not torch.cuda.is_available():
            resolve_device(args.device)  # raises, naming -device cpu
        layout = None
        if conf.distributed is not None:
            # Join the node set's process group BEFORE any device use
            # (gated on the config section, so pure-TCP nodes never pay
            # for it; external clients never join: they returned above).
            from ..parallel.multihost import maybe_initialize, rank_device

            layout = maybe_initialize(conf, args.id, want.type)
        if layout is not None and want.type == "cuda" and want.index is None:
            # One rank, one card where the host has enough; else the
            # ranks share its cards (multihost.rank_device).
            want = rank_device(conf, layout.process_id, "cuda")
            torch.cuda.set_device(want)
        device = resolve_device(want if want.type == "cuda" else args.device)

    node_conf = cfg.get_node_conf(conf, args.id)
    if (args.m == 3 and node_conf.is_leader and conf.mesh is not None
            and conf.mesh.topology() is not None):
        # Adversarial-holdings topology solves need the exact LP; its
        # ~2 s one-time scipy/HiGHS initialization starts here — the
        # earliest possible moment — so it overlaps fabrication and the
        # announce round-trips instead of the TTD clock.  (The common
        # attribution-first path never touches scipy at all.)
        import threading as _threading

        from ..sched.flow import warm_lp

        _threading.Thread(target=warm_lp, name="lp-warm",
                          daemon=True).start()
    try:
        my_client_conf = cfg.get_client_conf(conf, args.id)
    except ValueError:
        my_client_conf = None
        ulog.log.info("external client not found in config")

    save_disk = bool(args.s)

    def fabricate():
        layers = cfg.create_layers(node_conf, save_disk, args.s or ".",
                                   model=conf.model,
                                   model_seed=conf.model_seed,
                                   model_codec=conf.model_codec,
                                   device=device)
        if my_client_conf is not None:
            cfg.add_client_layers(my_client_conf, conf.layer_size, layers)
        return layers

    if args.l:
        fabricate()
        ulog.log.info("layer set up")
        return 0

    addr_registry = {nc.id: nc.addr for nc in conf.nodes}
    if my_client_conf is not None:
        addr_registry[CLIENT_ID] = my_client_conf.addr

    # Bind the port BEFORE fabricating: seeding physical-size blobs takes
    # minutes, and a leader that only listens afterwards forces every
    # receiver (whose dial retry budget is ~10 s) to be spawned against a
    # polled port.  The transport's delivery queue simply buffers any
    # announces that arrive while fabrication runs.
    transport = TcpTransport(node_conf.addr, addr_registry=addr_registry)
    # TEST-ONLY deterministic fault injection (transport/faults.py):
    # armed exclusively by explicit flags — construction-gated, so no
    # environment variable can inject faults into a production run.
    fault_spec = args.test_faults or ""
    if args.test_drop_plan_seqs.strip():
        seqs = ";".join(s.strip()
                        for s in args.test_drop_plan_seqs.split(",")
                        if s.strip())
        fault_spec = (fault_spec + "," if fault_spec else "") + \
            f"drop-plan-seqs={seqs}"
    if fault_spec:
        from ..transport.faults import FaultyTransport, rules_from_spec

        seed, rules = rules_from_spec(fault_spec)
        transport = FaultyTransport(transport, rules, seed=seed)
        ulog.log.warn("TEST fault injection armed", spec=fault_spec)
    try:
        layers = fabricate()
        # Hierarchical control (docs/hierarchy.md): a grouped member's
        # control parent is its SUB-LEADER — announces, acks,
        # heartbeats, and metric reports all fold there; the root only
        # ever sees the group aggregate.
        parent = cfg.get_leader_conf(conf).id
        groups = resolve_groups(conf, args.m)
        if groups is not None:
            for rec in groups.values():
                if args.id in rec["members"] and args.id != rec["leader"]:
                    parent = rec["leader"]
                    break
        node = Node(args.id, parent, transport)
        if node_conf.is_leader:
            return run_leader(args, conf, node, layers, device)
        return run_receiver(args, conf, node, layers, device)
    finally:
        transport.close()
        if device is not None and device.type == "cuda":
            import torch

            ulog.log.info("device memory", device=str(device),
                          peak_allocated_bytes=torch.cuda.max_memory_allocated(
                              device))
        if conf.distributed is not None:
            # Orderly teardown of the process group before the
            # interpreter exits.
            from ..parallel.multihost import maybe_shutdown

            maybe_shutdown()


if __name__ == "__main__":
    sys.exit(main())
