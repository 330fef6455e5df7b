"""JSON topology config, schema-compatible with the reference.

Copy of the JAX package's ``core/config.py`` (same schema, same parse
rules).  Its lazy model imports reach this package's ``models/``: seeded
blobs come from ``serde.seeded_blob`` on ``create_layers``' ``device``, and
an ``hf:`` model or a non-raw codec raises ``NotImplementedError`` until
those modules are ported.

Mirrors ``cmd/config.go:14-45``: one JSON file holds the
node list (addr, leader bit, NIC bandwidth, per-source rate limits, initial
layer placement with per-layer sizes), external clients, the target
``Assignment``, and a default ``LayerSize``.  TPU extension: an optional
``Mesh`` section describing the device mesh the Assignment maps onto
(axis names/sizes, which axis is the pipeline axis) so dissemination can
land layers directly in HBM with pipeline-stage placement.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from .types import (
    Assignment,
    LayerID,
    LayerMeta,
    LayerLocation,
    LayerSrc,
    LayersSrc,
    NodeID,
    SourceType,
    assignment_from_json,
)


def _jget(d: dict, key: str, default=None):
    """Go-style JSON field lookup: exact key first, then case-insensitive
    (encoding/json unmarshal semantics — the reference's own config.json
    uses ``Id`` against a struct field ``ID``)."""
    if key in d:
        return d[key]
    lk = key.lower()
    for k, v in d.items():
        if k.lower() == lk:
            return v
    return default


@dataclasses.dataclass
class MeshConf:
    """TPU extension: device-mesh description for the HBM data plane."""

    axis_names: List[str] = dataclasses.field(default_factory=lambda: ["nodes"])
    axis_sizes: List[int] = dataclasses.field(default_factory=lambda: [1])
    pipeline_axis: str = "nodes"
    # Pod fabric: all nodes are stages of ONE device mesh, and scheduled
    # layer transfers move as device traffic (ICI) instead of TCP streams
    # (parallel/fabric.py); TCP carries only the control plane.  Run with
    # cli.podrun (single controller addresses the whole mesh).
    fabric: bool = False
    # Per-stage ICI ingress/egress capacity, bytes/s.  When set on a
    # fabric config, the mode-3 flow solver plans against it instead of
    # the nodes' NIC NetworkBW — the plan governs the device plane, where
    # the NIC is not in the path (SURVEY §7: "rate limiting on ICI").
    # Per-source LimitRates still cap seeders (host→HBM or disk reads
    # remain the source-side bottleneck).  0 = plan with NetworkBW.
    ici_bw: int = 0
    # Multi-slice pods: node id -> slice index ("Slices": {"0": 0, ...}).
    # Nodes on the same slice exchange bytes over ICI; nodes on different
    # slices share the DCN.  The mode-3 solver then adds one DcnBW-capped
    # edge per ordered slice pair (sched/flow.PodTopology) — the reference
    # models only flat per-node NICs (flow.go:221-270).  Empty = one slice.
    slices: Dict[int, int] = dataclasses.field(default_factory=dict)
    dcn_bw: int = 0  # bytes/s per ordered slice pair; 0 = no DCN modeling
    # Per-slice torus interior (SURVEY §7 hard part): each slice's
    # members (sorted by id, row-major) sit on a torus of this shape,
    # and every directed torus link carries IciLinkBW bytes/s.  The
    # mode-3 solver then budgets each intra-slice transfer's
    # dimension-ordered route per LINK — multi-sender plans spread
    # across links, not just nodes.  Empty shape / 0 = unmodeled.
    slice_shape: List[int] = dataclasses.field(default_factory=list)
    ici_link_bw: int = 0

    @classmethod
    def from_json(cls, d: dict) -> "MeshConf":
        return cls(
            axis_names=list(_jget(d, "AxisNames", ["nodes"])),
            axis_sizes=[int(s) for s in _jget(d, "AxisSizes", [1])],
            pipeline_axis=_jget(d, "PipelineAxis", "nodes"),
            fabric=bool(_jget(d, "Fabric", False)),
            ici_bw=int(_jget(d, "IciBW", 0)),
            slices={int(k): int(v)
                    for k, v in (_jget(d, "Slices", {}) or {}).items()},
            dcn_bw=int(_jget(d, "DcnBW", 0)),
            slice_shape=[int(s) for s in _jget(d, "SliceShape", []) or []],
            ici_link_bw=int(_jget(d, "IciLinkBW", 0)),
        )

    def topology(self):
        """The solver-facing ``PodTopology`` (None when nothing beyond
        flat per-node rates is modeled: no DCN pairs AND no torus)."""
        if not self.slices:
            return None
        torus = bool(self.slice_shape) and self.ici_link_bw > 0
        if self.dcn_bw <= 0 and not torus:
            return None
        from ..sched.flow import PodTopology

        return PodTopology.make(self.slices, self.dcn_bw,
                                slice_shape=self.slice_shape,
                                ici_link_bw=self.ici_link_bw)


@dataclasses.dataclass
class DistributedConf:
    """TPU extension: multi-host mesh formation (parallel/multihost.py).

    Present (even empty ``{}``) = every node-process joins one pod-wide
    JAX runtime via ``jax.distributed.initialize`` before any device use;
    absent = single-host, no initialization.  ``coordinator`` defaults to
    the leader node's host on JAX's default port; ``cpu_collectives``
    ("gloo") enables cross-process collectives on CPU backends (the
    2-process smoke deployment) and is ignored on TPU."""

    coordinator: str = ""
    cpu_collectives: str = ""

    @classmethod
    def from_json(cls, d: dict) -> "DistributedConf":
        return cls(
            coordinator=_jget(d, "Coordinator", "") or "",
            cpu_collectives=_jget(d, "CpuCollectives", "") or "",
        )


@dataclasses.dataclass
class NodeConf:
    """Per-node config (cmd/config.go:21-28)."""

    id: NodeID
    addr: str
    network_bw: int = 0  # NIC bandwidth, bytes/sec
    is_leader: bool = False
    # SourceType -> rate limit (bytes/sec)  (cmd/config.go:26)
    sources: Dict[SourceType, int] = dataclasses.field(default_factory=dict)
    # SourceType -> {LayerID -> layer size}  (cmd/config.go:30-36)
    initial_layers: Dict[SourceType, Dict[LayerID, int]] = dataclasses.field(
        default_factory=dict
    )

    @classmethod
    def from_json(cls, d: dict) -> "NodeConf":
        sources = {
            SourceType(int(k)): int(v)
            for k, v in (_jget(d, "Sources") or {}).items()
        }
        initial: Dict[SourceType, Dict[LayerID, int]] = {}
        for st, by_layer in (_jget(d, "InitialLayers") or {}).items():
            initial[SourceType(int(st))] = {
                int(lid): int(_jget(lc or {}, "LayerSize", 0))
                for lid, lc in by_layer.items()
            }
        return cls(
            id=int(_jget(d, "ID", 0) or 0),
            addr=_jget(d, "Addr", ""),
            network_bw=int(_jget(d, "NetworkBW", 0)),
            is_leader=bool(_jget(d, "IsLeader", False)),
            sources=sources,
            initial_layers=initial,
        )


@dataclasses.dataclass
class ClientConf:
    """External weight-source config (cmd/config.go:41-45).

    ``layers_rate_limit`` maps LayerID -> bytes/sec serving rate (the JSON
    key is ``Layers``, as in the reference).
    """

    id: NodeID
    addr: str
    layers_rate_limit: Dict[LayerID, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_json(cls, d: dict) -> "ClientConf":
        return cls(
            id=int(_jget(d, "ID", 0) or 0),
            addr=_jget(d, "Addr", ""),
            layers_rate_limit={
                int(k): int(v) for k, v in (_jget(d, "Layers") or {}).items()
            },
        )


@dataclasses.dataclass
class Config:
    """Top-level config (cmd/config.go:14-19) + TPU mesh extension."""

    nodes: List[NodeConf] = dataclasses.field(default_factory=list)
    clients: List[ClientConf] = dataclasses.field(default_factory=list)
    assignment: Assignment = dataclasses.field(default_factory=dict)
    layer_size: int = 0
    mesh: Optional[MeshConf] = None
    distributed: Optional[DistributedConf] = None
    # TPU extension: when set (a models.llama.CONFIGS name), seeders
    # fabricate REAL model weight blobs (deterministic from ModelSeed)
    # instead of dummy zero bytes, so the disseminated layers can boot an
    # inference engine after delivery (-boot).
    model: str = ""
    model_seed: int = 0
    # Transfer codec for the fabricated blobs ("raw" | "int8" | "int4"):
    # int8 halves the bytes every schedule ships, int4 quarters them
    # (models/quant.py); receivers dequantize after landing, on-device
    # when ingest staged to HBM.
    model_codec: str = "raw"
    # NEGOTIATED per-transfer wire codec (docs/codec.md): when set, the
    # leader may ship individual (dest, layer) transfers in this
    # quantized form over SLOW links (bottleneck rate below
    # DLD_CODEC_MIN_RATE) while fast links keep shipping canonical
    # bytes — the flow solver sizes each pair by its encoded bytes, so
    # a quantized copy's effective link capacity is
    # bandwidth x (raw/encoded).  Requires ModelCodec == "raw" (the
    # canonical form must be the raw dtype blob; double quantization is
    # refused at parse time) and a Model (codec sizes derive from it).
    wire_codec: str = "raw"
    # Control-plane HA (docs/failover.md): ordered leader-succession
    # list.  Non-empty arms state replication + lease fencing — the
    # leader streams control deltas to these nodes and beacons its
    # lease; on leader death the lowest-ranked live standby takes over
    # at a bumped epoch.  Standby ids must name receiver seats.
    standbys: List[NodeID] = dataclasses.field(default_factory=list)
    # Hierarchical control (docs/hierarchy.md), mode 3 only: either an
    # auto-partition request ``{"Size": K}`` (0 = ~sqrt(N) groups) over
    # every non-root seat, or an explicit list of ``{"Leader": id,
    # "Members": [...]}`` declarations.  Grouped members point their
    # control plane at their sub-leader; the root plans over group
    # ingress nodes.  None = flat control (the legacy plane).
    groups: Optional[object] = None
    # Fabric-assisted pod delivery (docs/fabric.md), mode 3 only: a
    # list of member-id lists — each inner list one POD of dests
    # sharing an ICI domain.  A layer every member of a pod wants ships
    # as ONE 1/R shard per host over the NIC (possibly quantized under
    # WireCodec) and the full tree materializes over the on-mesh
    # gather, so pod NIC ingress is O(model_bytes), not
    # O(model_bytes x replicas).  None = no pod delivery.
    pods: Optional[List[List[NodeID]]] = None
    # Closed-loop autonomy (docs/autonomy.md): declarative policy rules
    # the leader-side engine evaluates against the folded cluster
    # signals every metrics interval — ``[{"Rule": <kind>, ...params},
    # ...]``, validated LOUDLY at parse time (runtime/policy.py owns
    # the grammar).  None/[] = manual fleet (no engine armed).  The
    # ``DLD_POLICY`` env kill-switch drops an armed fleet back to
    # manual without a config change.
    policies: Optional[List[dict]] = None

    @classmethod
    def from_json(cls, d: dict) -> "Config":
        conf = cls(
            nodes=[NodeConf.from_json(n) for n in _jget(d, "Nodes") or []],
            clients=[ClientConf.from_json(c) for c in _jget(d, "Clients") or []],
            assignment=assignment_from_json(_jget(d, "Assignment") or {}),
            layer_size=int(_jget(d, "LayerSize", 0)),
            mesh=MeshConf.from_json(_jget(d, "Mesh")) if _jget(d, "Mesh") else None,
            distributed=(DistributedConf.from_json(_jget(d, "Distributed"))
                         if _jget(d, "Distributed") is not None else None),
            model=_jget(d, "Model", "") or "",
            model_seed=int(_jget(d, "ModelSeed", 0)),
            model_codec=_validated_codec(_jget(d, "ModelCodec", "raw") or "raw"),
            wire_codec=_validated_codec(_jget(d, "WireCodec", "raw") or "raw"),
            standbys=[int(s) for s in _jget(d, "Standbys") or []],
            groups=_jget(d, "Groups"),
            pods=([[int(m) for m in pod] for pod in _jget(d, "Pods")]
                  if _jget(d, "Pods") is not None else None),
            policies=(list(_jget(d, "Policies"))
                      if _jget(d, "Policies") is not None else None),
        )
        if conf.policies is not None:
            # A bad rule must be refused at ADMISSION (config parse),
            # never at fire time — the engine owns the grammar
            # (lazy import: policy pulls runtime modules pure-config
            # users never need).
            from ..runtime.policy import validate_policies

            conf.policies = validate_policies(conf.policies)
        if conf.groups is not None and not isinstance(conf.groups,
                                                      (dict, list)):
            raise ValueError(
                "Groups must be {'Size': K} or a list of "
                "{'Leader': id, 'Members': [...]} declarations")
        if conf.pods is not None:
            known = {nc.id for nc in conf.nodes}
            seen: set = set()
            for pod in conf.pods:
                if len(pod) < 2:
                    raise ValueError("each Pods entry needs >= 2 members")
                for m in pod:
                    if m not in known:
                        raise ValueError(f"Pods names unknown node {m}")
                    if m in seen:
                        raise ValueError(
                            f"node {m} appears in more than one pod")
                    seen.add(m)
        if conf.model_codec != "raw":
            # Entropy forms are WIRE-only: the canonical held form must
            # boot through the codec jits, and the byte-domain DLE1
            # coder has no device program (models/entropy.py) — refuse
            # at parse time, not mid-boot.
            from ..models.quant import ENTROPY_CODECS

            if conf.model_codec in ENTROPY_CODECS:
                raise ValueError(
                    f"ModelCodec {conf.model_codec!r} is a wire-only "
                    "entropy form; use it as WireCodec over raw "
                    "canonicals instead")
        if conf.wire_codec != "raw":
            # Fail at PARSE time like an unknown codec: a wire codec
            # re-encodes the CANONICAL blob, so the canonical form must
            # be the raw dtype (double quantization silently degrades
            # weights twice) and a model must name the blob layouts.
            if conf.model_codec != "raw":
                raise ValueError(
                    f"WireCodec {conf.wire_codec!r} requires ModelCodec "
                    f"'raw' (got {conf.model_codec!r}): wire codecs "
                    "re-encode the canonical raw blobs per transfer")
            if not conf.model:
                raise ValueError(
                    f"WireCodec {conf.wire_codec!r} requires a Model "
                    "(encoded sizes derive from the blob layouts)")
        return conf


def _validated_codec(codec: str) -> str:
    """Reject unknown codecs AT PARSE TIME: a destination node holds no
    layers, so a typo'd codec would otherwise only surface after
    dissemination as a swallowed boot failure — a distributed hang on the
    leader's boot wait instead of an immediate config error."""
    if codec == "raw":  # default: don't pull jax into pure-TCP nodes
        return codec
    from ..models.quant import CODECS  # lazy for the same reason

    if codec not in CODECS:
        raise ValueError(f"unknown ModelCodec {codec!r}; known: {CODECS}")
    return codec


def read_json(path: str) -> Config:
    """Load a topology config file (cmd/config.go:48-62)."""
    with open(path, "r") as f:
        return Config.from_json(json.load(f))


def get_leader_conf(conf: Config) -> NodeConf:
    """First node with IsLeader set (cmd/config.go:64-72)."""
    for nc in conf.nodes:
        if nc.is_leader:
            return nc
    raise ValueError("no leader found")


def get_node_conf(conf: Config, node: NodeID) -> NodeConf:
    for nc in conf.nodes:
        if nc.id == node:
            return nc
    raise ValueError(f"no node found: {node}")


def get_client_conf(conf: Config, node: NodeID) -> ClientConf:
    for cc in conf.clients:
        if cc.id == node:
            return cc
    raise ValueError(f"no client found: {node}")


# ---------------------------------------------------------------------------
# Dummy-layer fabrication (cmd/config.go:94-198)
# ---------------------------------------------------------------------------


def create_layers(
    my_conf: NodeConf,
    save_disk: bool,
    storage_path: str = ".",
    model: str = "",
    model_seed: int = 0,
    model_codec: str = "raw",
    device=None,
) -> LayersSrc:
    """Fabricate this node's initial layers (cmd/config.go:94-117).

    ``SourceType`` is a *rate class* keying the per-source limit, not a
    storage location: layers are fabricated in RAM unless ``save_disk``
    (the reference's ``-s`` flag) forces disk-backed files.

    ``model``: a ``models.llama.CONFIGS`` name — layers are then REAL
    weight blobs (``serde.seeded_blob``, deterministic from ``model_seed``,
    drawn on ``device``: None = the CUDA card) the delivered model boots
    from, instead of the reference's dummy zero bytes; the blob's true size
    overrides the configured LayerSize."""
    blob_fn = None
    if model:
        from ..models.quant import encode_blob

        if model.startswith("hf:"):
            raise NotImplementedError(
                f"model {model!r}: Hugging Face checkpoints are not ported "
                "yet (ROADMAP, port Queue 1 item 6)")
        from ..models.llama import CONFIGS
        from ..models.serde import seeded_blob

        mcfg = CONFIGS[model]
        raw_fn = lambda lid: seeded_blob(  # noqa: E731
            mcfg, lid, model_seed, device=device)

        def blob_fn(lid):
            return encode_blob(mcfg, lid, raw_fn(lid), model_codec)
    layers: LayersSrc = {}
    for source_type, by_layer in my_conf.initial_layers.items():
        for layer_id, size in by_layer.items():
            size = max(0, size)
            blob = blob_fn(layer_id) if blob_fn is not None else None
            if blob is not None:
                size = len(blob)
            if save_disk:
                src = create_disk_layer(my_conf.id, layer_id, size,
                                        storage_path, content=blob)
            else:
                src = create_inmem_layer(layer_id, size, content=blob)
            src.data_size = size
            src.meta.limit_rate = my_conf.sources.get(source_type, 0)
            src.meta.source_type = source_type
            layers[layer_id] = src
    return layers


def add_client_layers(
    client_conf: ClientConf, layer_size: int, layers: LayersSrc
) -> LayersSrc:
    """Record layers served by this node's external client
    (cmd/config.go:119-131); layers already in RAM/disk win."""
    for layer_id, limit_rate in client_conf.layers_rate_limit.items():
        if layer_id in layers:
            continue
        layers[layer_id] = create_client_layer_info(layer_id, layer_size, limit_rate)
    return layers


def create_disk_layer(
    my_id: NodeID, layer_id: LayerID, layer_size: int, storage_path: str,
    content: Optional[bytes] = None,
) -> LayerSrc:
    """Write a layer file ``layers/<nodeID>/<layerID>.layer``
    (cmd/config.go:133-157); dummy zeros unless real ``content`` given."""
    d = os.path.join(storage_path, "layers", str(my_id))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{layer_id}.layer")
    if not os.path.exists(path) or os.path.getsize(path) != layer_size:
        # A size mismatch is ALWAYS refabricated, dummy bytes included: a
        # stale file from an earlier topology under the same storage path
        # would otherwise be served as this layer — the sender then
        # streams fewer bytes than it announced and the dest waits
        # forever on coverage that can't complete.
        with open(path, "wb") as f:
            f.write(content if content is not None else b"\x00" * layer_size)
    return LayerSrc(
        inmem_data=None,
        fp=path,
        data_size=layer_size,
        offset=0,
        meta=LayerMeta(location=LayerLocation.DISK, source_type=SourceType.DISK),
    )


def create_inmem_layer(
    layer_id: LayerID, layer_size: int, content: Optional[bytes] = None
) -> LayerSrc:
    """In-RAM layer (cmd/config.go:159-171): dummy zeros, or real bytes."""
    return LayerSrc(
        inmem_data=bytearray(content) if content is not None
        else bytearray(layer_size),
        fp="",
        data_size=layer_size,
        offset=0,
        meta=LayerMeta(location=LayerLocation.INMEM, source_type=SourceType.MEM),
    )


def create_client_layer(layer_id: LayerID, layer_size: int, limit_rate: int) -> LayerSrc:
    """A layer held *at the client process itself* (cmd/config.go:174-184)."""
    src = create_inmem_layer(layer_id, layer_size)
    src.meta = LayerMeta(
        location=LayerLocation.INMEM,
        limit_rate=limit_rate,
        source_type=SourceType.CLIENT,
    )
    return src


def create_client_layer_info(
    layer_id: LayerID, layer_size: int, limit_rate: int
) -> LayerSrc:
    """The *node's record* of a layer that lives at its external client
    (cmd/config.go:187-198)."""
    return LayerSrc(
        inmem_data=None,
        fp="",
        data_size=layer_size,
        offset=0,
        meta=LayerMeta(
            location=LayerLocation.CLIENT,
            limit_rate=limit_rate,
            source_type=SourceType.CLIENT,
        ),
    )
