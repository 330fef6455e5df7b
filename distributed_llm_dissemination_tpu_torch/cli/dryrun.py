"""The port's multi-device dry run: one training step, one dissemination
round, one device-fabric round, each checked.

Port of the JAX package's ``__graft_entry__.py``:

    python -m distributed_llm_dissemination_tpu_torch.cli.dryrun -n N \\
        [-device cpu] [-config tiny]

- ``entry(device, config)`` returns ``(fn, args)``: the forward of
  ``config`` (the flagship ``llama3-8b-d4`` by default) on
  ``llama.init_params(cfg, 0)`` with zero tokens ``[1, 128]``.
- ``dryrun_train`` (a): one AdamW + remat step of ``tiny-moe`` on
  ``models.sharded.make_train_mesh(n)``, in a world of n processes, one
  per rank (``torch.distributed``: nccl with one card per rank, or gloo
  on the CPU through a ``FileStore``); a world of one runs in the calling
  process.  Params come from ``llama.init_params(cfg, 0)``.
- ``dryrun_dissemination`` (b): a mode-3 round over the in-memory
  transport onto an n-slot ``pp x tp`` mesh (pp = 2 when n is even) with
  the uneven 3/1 cut, every blob staged on its stage's slots and each
  stage booted; then the loss from the landed tensors, and the pod's
  pipelined forward and greedy decode held against ``generate`` (with
  one stage, the full boot's decode).
- ``dryrun_fabric`` (c): int8 wire blobs through the device fabric on a
  2-slice ``PodTopology``, leader 0 and seeder 1 each holding half, cold
  dest 2 booting with on-device dequant; no ``LayerMsg`` may cross the
  transport.
- ``dryrun_multichip(n)`` runs (a), (b) and (c); each prints one JSON
  line (``dryrun_train``, ``dryrun_dissemination``, ``dryrun_fabric``)
  and ``main`` prints ``dryrun_entry`` after them.  A failed check raises
  (``main`` exits non-zero); nothing carries on past it.

Everything runs on the CUDA cards unless ``device="cpu"`` (``-device
cpu``) is given: without a card it raises, and fewer cards than n is an
error.  Mesh slot i runs on card i (``parallel.mesh.device_slots``); on
the CPU every slot is the CPU, as the JAX package's virtual devices are.
Each part reports the K1 (attention) and K2/K3 (dequant) launches it
made, by kernel and by card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

TRAIN_CONFIG = "tiny-moe"  # MoE, so the ep axis is real when n gives it
TRAIN_LR = 1e-3
TRAIN_TIMEOUT_S = 600.0  # the world of ranks, start-up included
ROUND_TIMEOUT_S = 600.0  # each wait of a dissemination round
DECODE_NEW = 3  # greedy tokens of the pod decode
# Each node's modelled NIC, B/s: far above what the in-memory transport
# carries, so the plan never paces a send.  (The JAX dry run models 10**9,
# which would pace a full-width round to about 1 GB/s.)
NIC = 1 << 40
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _require(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def _emit(part: str, rec: dict) -> None:
    print(json.dumps({"part": part, **rec}), flush=True)


def _config(name: str):
    from ..models.llama import CONFIGS

    return CONFIGS[name]


def _check_world(n: int, device) -> None:
    """Raise unless ``device`` can run n mesh slots or ranks: the CPU (any
    n), or at least n CUDA cards (None or ``"cuda"``; ``"cuda:k"`` only
    for n = 1)."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)  # raises without a card
    if dev.type == "cuda":
        if n > 1 and device not in (None, "cuda"):
            raise ValueError(f"n = {n} runs on the cards in order; "
                             f"got device={device!r}")
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"the dry run at n = {n} needs {n} cards; "
                               f"this host has {torch.cuda.device_count()}")


def _counts() -> dict:
    """The kernel wrappers' launch counts now."""
    from ..ops import dequant as dq
    from ..ops import flash_attention as fa

    return {"attention": dict(fa.launches_by_kernel),
            "attention_by_device": {d: dict(n) for d, n in
                                    fa.launches_by_device.items()},
            "attention_plain": fa.plain_calls,
            "dequant": dict(dq.launches_by_kernel),
            "dequant_by_device": {d: dict(n) for d, n in
                                  dq.launches_by_device.items()},
            "dequant_plain": dict(dq.plain_calls)}


def _since(before: dict) -> dict:
    """The launches made since ``before`` (a ``_counts()``), with the
    cards and kernels that made none left out of the per-card tables."""
    after = _counts()

    def diff(a, b):
        return {k: v - b.get(k, 0) for k, v in a.items()}

    out = {"attention_plain": after["attention_plain"]
           - before["attention_plain"]}
    for key in ("attention", "dequant", "dequant_plain"):
        out[key] = diff(after[key], before[key])
    for key in ("attention_by_device", "dequant_by_device"):
        per_dev = {d: {k: v for k, v in diff(per, before[key].get(d, {}))
                       .items() if v}
                   for d, per in after[key].items()}
        out[key] = {d: per for d, per in per_dev.items() if per}
    return out


@contextlib.contextmanager
def _keep_staged():
    """Boots keep each staged blob's tensor (``DLD_BOOT_DONATE=0``), so
    the landed bytes can be checked after the boot."""
    prev = os.environ.get("DLD_BOOT_DONATE")
    os.environ["DLD_BOOT_DONATE"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("DLD_BOOT_DONATE", None)
        else:
            os.environ["DLD_BOOT_DONATE"] = prev


def _exact_on_slots(arr, data) -> set:
    """Check that every replica of the landed tensor ``arr`` (a
    ``SlotTensor``) holds ``data`` byte for byte; returns the replicas'
    devices."""
    import torch

    from ..models.serde import _host_u8

    want = _host_u8(data)
    devs = {s.device for s in arr.slots}
    for dev in devs:
        rep = arr.replica(dev)
        _require(rep is not None and rep.dtype == torch.uint8
                 and torch.equal(rep, want.to(dev)),
                 f"landed bytes differ on {dev}")
    return {str(d) for d in devs}


def _mesh(n: int, pp: int, device):
    from ..parallel.mesh import device_slots, make_mesh

    return make_mesh((pp, n // pp), ("pp", "tp"), device_slots(n, device))


# ----------------------------------------------------------------- entry


def entry(device=None, config: str = "llama3-8b-d4"):
    """``(fn, (params, tokens))``: the forward of ``config`` on
    ``init_params(cfg, 0)`` and zero tokens ``[1, 128]``, on ``device``
    (None = the CUDA card)."""
    import torch

    from ..models.llama import forward, init_params
    from ..utils.device import resolve_device

    cfg = _config(config)
    dev = resolve_device(device)
    params = init_params(cfg, 0, dev)
    tokens = torch.zeros((1, 128), dtype=torch.long, device=dev)

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


# -------------------------------------------------------------- (a) train


def train_step(n: int, device) -> dict:
    """This rank's part of one AdamW + remat step of ``tiny-moe`` on
    ``make_train_mesh(n)`` (the default process group is n ranks, or
    absent for n = 1)."""
    from ..models.llama import init_params
    from ..models.sharded import (
        build_adamw_train_step,
        example_batch,
        factor_mesh_axes,
        init_adamw_state,
        make_train_mesh,
        shard_params,
    )
    from ..utils.device import resolve_device, synchronize

    cfg = _config(TRAIN_CONFIG)
    dev = resolve_device(device)
    axes = factor_mesh_axes(n, cfg)
    mesh = make_train_mesh(n, cfg)
    params = shard_params(init_params(cfg, 0, dev), mesh, cfg)
    opt = init_adamw_state(params)
    step = build_adamw_train_step(cfg, mesh, lr=TRAIN_LR, remat=True)
    inputs, targets = example_batch(cfg, mesh, device=dev)
    before = _counts()
    t0 = time.monotonic()
    params, opt, loss = step(params, opt, inputs, targets)
    synchronize(dev)
    step_s = time.monotonic() - t0
    loss = float(loss)
    _require(loss == loss and loss < 1e4, f"non-finite loss: {loss}")
    _require(int(opt["step"]) == 1, f"opt step {int(opt['step'])}")
    launches = _since(before)
    return {"rank": mesh.rank, "coords": mesh.coords, "device": str(dev),
            "mesh": axes, "loss": loss, "step": int(opt["step"]),
            "step_s": step_s, "attention": launches["attention"],
            "attention_by_device": launches["attention_by_device"],
            "attention_plain": launches["attention_plain"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_train(n: int, device=None, workdir=None) -> dict:
    """(a): ``train_step`` in a world of n ranks, one process each
    (``python -m ...cli.dryrun -train-rank r``, with ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``): on the cards rank r runs on card r under
    nccl, meeting at ``MASTER_ADDR``/``MASTER_PORT``; on the CPU under
    gloo through a ``FileStore`` in ``workdir``.  n = 1 runs in this
    process.  Every child is joined, or killed, before it returns; a
    child that fails raises with its log's tail.  ``workdir`` (default:
    a temporary directory, removed after) keeps each rank's log and
    result."""
    import shutil

    import torch

    _check_world(n, device)
    cpu = torch.device(device or "cuda").type == "cpu"
    t_world = time.monotonic()
    if n == 1:
        ranks = [train_step(1, device)]
    else:
        tmp = workdir is None
        work = tempfile.mkdtemp(prefix="dld-dryrun-") if tmp else str(workdir)
        os.makedirs(work, exist_ok=True)
        env = dict(os.environ, WORLD_SIZE=str(n),
                   PYTHONPATH=os.pathsep.join(
                       [REPO] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        argv = [sys.executable, "-m",
                "distributed_llm_dissemination_tpu_torch.cli.dryrun",
                "-n", str(n), "-workdir", work]
        if cpu:
            store = os.path.join(work, "store")
            if os.path.exists(store):
                os.remove(store)
            argv += ["-device", "cpu", "-store", store]
            env["OMP_NUM_THREADS"] = "1"
        else:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        procs = []
        try:
            for r in range(n):
                with open(os.path.join(work, f"rank{r}.log"), "wb") as log:
                    procs.append(subprocess.Popen(
                        argv + ["-train-rank", str(r)],
                        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                        stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
            # Until every rank is done, one fails (its peers would wait on
            # it in a collective) or the deadline passes.
            deadline = time.monotonic() + TRAIN_TIMEOUT_S
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.poll() != 0]
            if bad:
                r = next((r for r in bad if procs[r].poll() is not None),
                         bad[0])
                with open(os.path.join(work, f"rank{r}.log"),
                          errors="replace") as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(
                    f"dry-run ranks {bad} failed or still ran after "
                    f"{TRAIN_TIMEOUT_S} s; rank {r} (exit "
                    f"{procs[r].poll()}):\n{tail}")
            ranks = []
            for r in range(n):
                with open(os.path.join(work, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if tmp:
                shutil.rmtree(work, ignore_errors=True)
    losses = {r["loss"] for r in ranks}
    _require(len(losses) == 1, f"ranks disagree on the loss: {losses}")
    rec = {"n": n, "config": TRAIN_CONFIG, "mesh": ranks[0]["mesh"],
           "loss": ranks[0]["loss"], "step": ranks[0]["step"],
           "step_s": [r["step_s"] for r in ranks],
           "wall_s": time.monotonic() - t_world,
           "devices": [r["device"] for r in ranks],
           "attention": {k: sum(r["attention"][k] for r in ranks)
                         for k in ranks[0]["attention"]},
           "attention_by_rank": [r["attention"] for r in ranks],
           "attention_by_device": [r["attention_by_device"] for r in ranks],
           "attention_plain": sum(r["attention_plain"] for r in ranks)}
    _emit("dryrun_train", rec)
    return rec


def _train_rank(args) -> int:
    """One rank of ``dryrun_train``'s world; writes its result to
    ``<workdir>/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from .train import _init_world

    rank = int(os.environ["RANK"])
    if args.store:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(args.store,
                                                             args.n),
                                rank=rank, world_size=args.n)
    try:
        world, dev = _init_world(args.device)
        _require(world == args.n, f"world of {world}, not {args.n}")
        rec = train_step(world, dev)
        path = os.path.join(args.workdir, f"rank{rank}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# ------------------------------------------------------- (b) dissemination


def _landed_params(cfg, landed, dev):
    """Model params on ``dev`` from the landed uint8 blob tensors."""
    import torch

    from ..models import serde

    def on(arr):
        rep = arr.replica(dev)
        return rep if rep is not None else arr.replica(arr.slots[0]).to(dev)

    specs = serde.layer_param_specs(cfg)
    per = [serde.decode_device(on(landed[i]), specs, cfg.dtype)
           for i in range(cfg.n_layers)]
    head = serde.decode_device(on(landed[serde.head_blob_id(cfg)]),
                               serde.head_param_specs(cfg), cfg.dtype)
    return {"embed": head["embed"],
            "layers": {name: torch.stack([p[name] for p in per])
                       for name, _ in specs},
            "ln_f": head["ln_f"], "lm_head": head["lm_head"]}


def _holdings(blobs, bids):
    from ..core.types import LayerLocation, LayerMeta, LayerSrc, SourceType

    return {bid: LayerSrc(inmem_data=blobs[bid], data_size=len(blobs[bid]),
                          meta=LayerMeta(location=LayerLocation.INMEM,
                                         source_type=SourceType.MEM))
            for bid in bids}


def _warm(receiver) -> list:
    """The entries each of a receiver's boot warm-ups compiled."""
    return [rec["compiled"] for rec, _ in receiver.precompile_records]


def dryrun_dissemination(n: int, device=None, config="tiny",
                         blobs=None) -> dict:
    """(b), the JAX ``_dryrun_dissemination``: leader 0 holds every seeded
    blob of ``config`` (``blobs``: prebuilt seed-0 blobs), a mode-3 round
    over the in-memory transport delivers them onto an n-slot ``pp x tp``
    mesh (pp = 2 when n is even: node 1 takes the first 3 layers, node 2
    the rest and the head; else node 1 takes all), every blob staged on
    its stage's slots and each stage booted.  Checked: every blob in
    device memory on its stage's slots, each replica byte-exact; the loss
    of ``(2, 17)`` zero tokens from the landed tensors finite; with two
    stages the pod's pipelined forward and its greedy decode of 16 zero
    tokens equal to ``generate`` on the landed params, with one stage the
    full boot's decode."""
    import torch

    from ..core.types import LayerLocation, LayerMeta
    from ..models import serde
    from ..models.generate import generate
    from ..models.llama import loss_fn
    from ..parallel.mesh import assignment_to_placement
    from ..runtime import FlowRetransmitLeaderNode, FlowRetransmitReceiverNode
    from ..runtime import Node
    from ..runtime.pp_serve import assemble_pp_params, pod_decode, pod_forward
    from ..transport.inmem import InmemTransport, reset_registry
    from ..utils.device import synchronize
    from .podrun import _join_run_threads

    _check_world(n, device)
    cfg = _config(config)
    head_id = serde.head_blob_id(cfg)
    pp = 2 if n >= 2 and n % 2 == 0 else 1
    mesh = _mesh(n, pp, device)
    if blobs is None:
        blobs = {bid: serde.seeded_blob(cfg, bid, 0, mesh.slots[0].device)
                 for bid in range(head_id + 1)}
    cut = min(3, cfg.n_layers - 1)
    if pp == 2:
        assignment = {
            1: {bid: LayerMeta() for bid in range(cut)},
            2: {bid: LayerMeta() for bid in range(cut, head_id + 1)},
        }
    else:  # one stage: one assignee boots the full model
        assignment = {1: {bid: LayerMeta() for bid in range(head_id + 1)}}
    dest_ids = sorted(assignment)
    n_nodes = 1 + len(dest_ids)
    placement = assignment_to_placement(assignment, mesh, "pp")

    started = set(threading.enumerate())
    before = _counts()
    reset_registry()
    ts = {i: InmemTransport(str(i),
                            addr_registry={j: str(j) for j in range(n_nodes)})
          for i in range(n_nodes)}
    leader = receivers = None
    try:
        with _keep_staged():
            leader = FlowRetransmitLeaderNode(
                Node(0, 0, ts[0]), _holdings(blobs, blobs), assignment,
                {i: NIC for i in range(n_nodes)},
                expected_nodes=set(dest_ids))
            receivers = [FlowRetransmitReceiverNode(
                Node(i, 0, ts[i]), {}, stage_hbm=True, placement=placement,
                boot_cfg=cfg) for i in dest_ids]
            for r in receivers:
                r.announce()
            leader.start_distribution().get(timeout=ROUND_TIMEOUT_S)
            t0 = time.monotonic()
            leader.ready().get(timeout=ROUND_TIMEOUT_S)
            ttd = time.monotonic() - t0
            booted = leader.boot_ready().get(timeout=ROUND_TIMEOUT_S)
            for r in receivers:  # every warm-up's launches are in
                _require(r._precompile_done.wait(ROUND_TIMEOUT_S),
                         f"node {r.node.my_id}'s warm-up still running")
        predicted_s = leader.predicted_ttd_ms / 1e3
        solve_ms = leader.solve_ms

        # Every blob in device memory on ITS stage's slots, byte-exact.
        slots = {}
        for node_id, r in zip(dest_ids, receivers):
            for bid in assignment[node_id]:
                src = r.layers[bid]
                _require(src.meta.location == LayerLocation.HBM,
                         f"blob {bid} at node {node_id} not in device memory")
                arr = src.device_array
                stage = set(placement.devices_for_layer(bid))
                _require(arr.devices() == stage,
                         f"blob {bid} on {arr.devices()}, not its stage's "
                         f"slots {stage}")
                slots[bid] = sorted(_exact_on_slots(arr, blobs[bid]))

        # The loss from the LANDED tensors, on the first slot's device.
        dev = mesh.slots[0].device
        landed = {bid: src.device_array for r in receivers
                  for bid, src in r.layers.items()}
        params = _landed_params(cfg, landed, dev)
        del landed
        loss = float(loss_fn(params, torch.zeros((2, 17), dtype=torch.long,
                                                 device=dev), cfg))
        _require(loss == loss and loss < 1e4, f"non-finite loss: {loss}")
        kinds = {n_: r.boot_result.kind for n_, r in zip(dest_ids, receivers)}
        results = {n_: r.boot_result for n_, r in zip(dest_ids, receivers)}
        prompt = torch.zeros((1, 16), dtype=torch.long, device=dev)
        pod_s = None
        if pp == 2:
            # The POD serves as one model from the staged weights: one
            # forward and a KV-cached greedy decode on the uneven cut.
            stores = {n_: r.layers for n_, r in zip(dest_ids, receivers)}
            depths = [len(results[n_].layer_ids) for n_ in dest_ids]
            _require(depths == [cut, cfg.n_layers - cut],
                     f"stage depths {depths}")
            assembled = assemble_pp_params(cfg, placement, results, stores)
            served = pod_forward(cfg, placement, results, stores,
                                 assembled=assembled)
            _require(served is not None, "pod serve declined a 2-stage run")
            logits, pod_s = served
            _require(logits.shape[-1] == cfg.vocab
                     and bool(torch.isfinite(logits).all()),
                     f"pod logits {tuple(logits.shape)}")
            dec = pod_decode(cfg, placement, results, stores,
                             max_new=DECODE_NEW, assembled=assembled)
            _require(dec is not None, "pod decode declined a 2-stage run")
            toks, dec_s = dec
            del assembled, logits
        else:
            # One stage: the full boot serves its resident params.
            res = results[dest_ids[0]]
            _require(res.kind == "full", f"boot kind {res.kind}")
            t1 = time.monotonic()
            toks = generate(res.params, prompt, cfg, DECODE_NEW)
            synchronize(toks.device)
            dec_s = time.monotonic() - t1
        want = generate(params, prompt, cfg, DECODE_NEW)
        _require(torch.equal(toks.cpu(), want.cpu()),
                 f"decode {toks.tolist()} diverged from generate "
                 f"{want.tolist()}")
        tokens = [int(t) for t in toks[0].tolist()]
        del params, toks, want, results
        warm = {str(r.node.my_id): _warm(r) for r in receivers}
    finally:
        if leader is not None:
            leader.close()
        for r in receivers or ():
            r.close()
        for t in ts.values():
            t.close()
        reset_registry()
        _join_run_threads(started)
    rec = {"n": n, "config": cfg.name, "mode": 3, "stages": pp,
           "mesh": {"pp": pp, "tp": n // pp}, "ttd_s": ttd,
           "predicted_s": predicted_s, "solve_ms": solve_ms,
           "boots": {str(k): v for k, v in kinds.items()},
           "boot_s": {str(k): v for k, v in booted.items()},
           "loss_from_landed": loss, "pod_forward_s": pod_s,
           "pod_decode_s": dec_s, "decode_new": DECODE_NEW,
           "tokens": tokens, "landed_exact": len(slots),
           "blob_devices": {str(b): d for b, d in sorted(slots.items())},
           "node_devices": {str(i): sorted({str(s.device) for s in
                                            placement.devices_for_node(i)})
                            for i in dest_ids},
           "warm": warm, **_since(before)}
    _emit("dryrun_dissemination", rec)
    return rec


# ------------------------------------------------------------ (c) fabric


def dryrun_fabric(n: int, device=None, config="tiny", wire=None) -> dict:
    """(c), the JAX ``_dryrun_fabric``: ``config``'s seeded blobs in the
    int8 wire form (``quant.encode_blob``; ``wire``: prebuilt seed-0 wire
    blobs), leader 0 holding the first half and seeder 1 the rest, cold
    dest 2 assigned every blob and booting with ``boot_codec="int8"``;
    ``fabric_placement`` on a ``pp x tp`` mesh (pp = min(3, n), reduced
    until it divides n), a 2-slice ``PodTopology`` (seeders on slice 0,
    the dest on slice 1).  A spy on every transport counts ``LayerMsg``.
    Checked: none crossed the transport; every blob in device memory on
    dest 2's slots, each replica byte-exact; a full boot."""
    from ..core.types import LayerLocation, LayerMeta
    from ..models import quant, serde
    from ..parallel.fabric import FabricPlane
    from ..parallel.mesh import fabric_placement
    from ..runtime import FlowRetransmitLeaderNode, FlowRetransmitReceiverNode
    from ..runtime import Node
    from ..sched.flow import PodTopology
    from ..transport.inmem import InmemTransport, reset_registry
    from ..transport.messages import LayerMsg
    from .podrun import _join_run_threads

    _check_world(n, device)
    cfg = _config(config)
    head_id = serde.head_blob_id(cfg)
    pp = min(3, n)
    while n % pp:
        pp -= 1
    mesh = _mesh(n, pp, device)
    if wire is None:
        wire = {bid: quant.encode_blob(
                    cfg, bid, serde.seeded_blob(cfg, bid, 0,
                                                mesh.slots[0].device), "int8")
                for bid in range(head_id + 1)}
    assignment = {2: {bid: LayerMeta() for bid in range(head_id + 1)}}
    node_ids = [0, 1, 2]
    placement = fabric_placement(node_ids, assignment, mesh, "pp")
    fabric = FabricPlane()

    started = set(threading.enumerate())
    before = _counts()
    reset_registry()
    ts = {i: InmemTransport(str(i),
                            addr_registry={j: str(j) for j in node_ids})
          for i in node_ids}
    layer_msgs = []
    for t in ts.values():
        orig = t.send

        def spy(dest, msg, _orig=orig):
            if isinstance(msg, LayerMsg):
                layer_msgs.append(msg.layer_id)
            _orig(dest, msg)

        t.send = spy
    cut = (head_id + 1) // 2
    # The seeders sit on slice 0, the cold dest on slice 1: every transfer
    # crosses the DCN, so the topology-aware planner runs end to end.
    topo = PodTopology.make({0: 0, 1: 0, 2: 1}, dcn_bw=10 ** 9)
    leader = receivers = None
    try:
        with _keep_staged():
            leader = FlowRetransmitLeaderNode(
                Node(0, 0, ts[0]), _holdings(wire, range(cut)), assignment,
                {i: NIC for i in node_ids}, expected_nodes={1, 2},
                fabric=fabric, placement=placement, topology=topo)
            receivers = [
                FlowRetransmitReceiverNode(
                    Node(1, 0, ts[1]),
                    _holdings(wire, range(cut, head_id + 1)),
                    fabric=fabric, placement=placement),
                FlowRetransmitReceiverNode(
                    Node(2, 0, ts[2]), {}, fabric=fabric, placement=placement,
                    boot_cfg=cfg, boot_codec="int8"),
            ]
            for r in receivers:
                r.announce()
            leader.start_distribution().get(timeout=ROUND_TIMEOUT_S)
            t0 = time.monotonic()
            leader.ready().get(timeout=ROUND_TIMEOUT_S)
            ttd = time.monotonic() - t0
            booted = leader.boot_ready().get(timeout=ROUND_TIMEOUT_S)
            for r in receivers:  # every warm-up's launches are in
                _require(r._precompile_done.wait(ROUND_TIMEOUT_S),
                         f"node {r.node.my_id}'s warm-up still running")
        predicted_s = leader.predicted_ttd_ms / 1e3
        solve_ms = leader.solve_ms

        dest = receivers[-1]
        slots = {}
        for bid in range(head_id + 1):
            src = dest.layers[bid]
            _require(src.meta.location == LayerLocation.HBM,
                     f"blob {bid} not in device memory at dest 2")
            arr = src.device_array
            _require(arr.devices() == set(placement.devices_for_node(2)),
                     f"blob {bid} on {arr.devices()}, not dest 2's slots "
                     f"{placement.devices_for_node(2)}")
            slots[bid] = sorted(_exact_on_slots(arr, wire[bid]))
        _require(not layer_msgs, f"{len(layer_msgs)} LayerMsg crossed the "
                                 "transport in fabric mode")
        res = dest.boot_result
        _require(res is not None and res.kind == "full",
                 f"dest 2 boot {res and res.kind}")
        kind, via = res.kind, res.via
        warm = {"2": _warm(dest)}
    finally:
        if leader is not None:
            leader.close()
        for r in receivers or ():
            r.close()
        for t in ts.values():
            t.close()
        reset_registry()
        _join_run_threads(started)
    rec = {"n": n, "config": cfg.name, "mode": 3, "stages": pp,
           "mesh": {"pp": pp, "tp": n // pp}, "codec": "int8",
           "topology": "2-slice", "ttd_s": ttd,
           "predicted_s": predicted_s, "solve_ms": solve_ms,
           "layer_msgs_on_transport": len(layer_msgs),
           "wire_bytes": sum(len(b) for b in wire.values()),
           "boot_s": booted[2], "kind": kind, "via": via,
           "landed_exact": len(slots),
           "blob_devices": {str(b): d for b, d in sorted(slots.items())},
           "node_devices": {str(i): sorted({str(s.device) for s in
                                            placement.devices_for_node(i)})
                            for i in node_ids},
           "warm": warm, **_since(before)}
    _emit("dryrun_fabric", rec)
    return rec


def dryrun_multichip(n: int, device=None, config="tiny", blobs=None,
                     wire=None, workdir=None) -> dict:
    """(a), (b) and (c) in order (the JAX ``dryrun_multichip``): one
    training step in a world of n ranks, then the dissemination and
    fabric rounds of ``config`` on an n-slot mesh.  ``blobs``/``wire``:
    prebuilt seed-0 raw and int8 wire blobs of ``config``."""
    return {"train": dryrun_train(n, device, workdir),
            "dissemination": dryrun_dissemination(n, device, config, blobs),
            "fabric": dryrun_fabric(n, device, config, wire)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dryrun")
    p.add_argument("-n", type=int, default=1,
                   help="mesh slots and training ranks (cards on a GPU host)")
    p.add_argument("-device", type=str, default=None,
                   help="torch device (default: the CUDA cards)")
    p.add_argument("-config", type=str, default="tiny",
                   help="model of the rounds and of the entry forward")
    p.add_argument("-workdir", type=str, default=None,
                   help="the training ranks' logs and results")
    p.add_argument("-train-rank", type=int, default=None,
                   help=argparse.SUPPRESS)  # one rank of dryrun_train
    p.add_argument("-store", type=str, default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.train_rank is not None:
        return _train_rank(args)
    dryrun_multichip(args.n, args.device, args.config, workdir=args.workdir)
    fn, fargs = entry(args.device, args.config)
    logits = fn(*fargs)
    import torch

    _require(bool(torch.isfinite(logits).all()), "non-finite entry logits")
    _emit("dryrun_entry", {"config": args.config,
                           "logits_shape": list(logits.shape)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
