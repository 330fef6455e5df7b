"""Model boot from disseminated bytes: the startup hook, made real.

Port of the JAX package's ``runtime/boot.py``: a receiver assembles its
delivered layer blobs into ``models.llama`` params on the device and
runs the first forward, so dissemination ends at a serving model and the
time to first token (TTFT) can be reported next to the time to deliver.

Two boot shapes, chosen by what the node holds:

- **full**: every layer plus the head blob -- the whole model boots and
  produces logits (and, with ``generate_tokens``, serves);
- **stage**: a contiguous slice of layers (a pipeline stage) -- its
  params run over dummy activations.

Both hold their layers per layer: ``params[name][j]`` is leaf ``name`` of
the ``j``-th held layer, and nothing is stacked.  Assembly prefers blobs
already on the device (``LayerSrc.device_array``, a 1-D uint8 CUDA
tensor), so the bytes never return to the host: a raw blob's leaves are
dtype views of the landed wire bytes (``models/serde.decode_device``), so
a stage takes no device memory beyond its landed blobs; an int8/int4 blob
decodes through the dequant kernels (``ops/dequant.py``, one launch and
one decoded copy per blob).  Host-held blobs are decoded and stacked on
the host and go up once per leaf, each layer a view of the upload.  The
counters ``boot.stage_bytes`` and ``boot.stage_copied_bytes`` give the
layer bytes a boot assembled and those it wrote to new device memory
rather than viewed in place.  The DLE1
layer of an entropy form has no device decode: it unwraps on the host and
the base form goes back to the device for its kernel (the JAX package
decodes such a blob wholly on the host).
"Donation" is reference release: a consumed blob's ``device_array`` is
set to ``None`` (``blob_donate_ok``) and its memory lives on only as
long as the leaves that view it.

``precompile_boot`` is the counterpart of the JAX package's boot-hint
warm-up: PyTorch runs eagerly, so instead of XLA compiles it pays the
first-call set-up the cold boot would otherwise pay after startup (the
attention kernels' libraries and the boot codec's dequant library built
and loaded, each kernel instance the boot and serving will launch launched
once, the cuBLAS handle created).
The JAX package's persistent compilation cache (``ensure_compile_cache``)
has no counterpart.  A boot runs on one device, its stage's first slot's:
slots that share it (every slot of a mesh on one card) share the stage's
params, one copy, not one per slot.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import torch

from ..core.types import LayerLocation, LayerMeta, LayerSrc, LayersSrc
from ..models import llama, quant, serde
from ..models.generate import generate
from ..ops import dequant, flash_attention
from ..utils import env as env_util
from ..utils import integrity, trace
from ..utils.device import resolve_device, synchronize
from ..utils.logging import log


@dataclasses.dataclass
class BootResult:
    kind: str  # "full" | "stage"
    seconds: float  # wall time: blob assembly + first forward (TTFT)
    layer_ids: Sequence[int]
    logits: Any = None  # full boots only
    activations: Any = None  # stage boots only
    tokens: Any = None  # full boots with generate_tokens > 0
    # The assembled params stay resident: the product of the
    # dissemination (full: the whole dict, its "layers" per layer; stage:
    # the per-layer leaves, {name: [layer 0's, layer 1's, ...]}).
    params: Any = None
    via: str = ""  # how the layers were assembled (also logged)


def blob_donate_ok(src) -> bool:
    """Whether the boot may release this blob's device copy.  Policy
    (``utils.env.boot_donate_mode``): off = never; force = always; auto =
    only when a host copy survives (later readers fall back to
    ``inmem_data``) and the blob lives on a CUDA device -- a CPU "device"
    tensor may alias the very host buffer (zero-copy adoption)."""
    mode = env_util.boot_donate_mode()
    if mode == "off":
        return False
    arr = getattr(src, "device_array", None)
    if arr is None:
        return False
    if mode == "force":
        return True
    if src.inmem_data is None:
        return False
    return arr.device.type != "cpu"


def classify_held_blobs(cfg, held_ids) -> tuple:
    """The boot's view of a held blob-id set: ``(layer_ids, full)``.
    Raises ValueError for sets no boot shape accepts (no layers, or a
    non-contiguous slice)."""
    head_id = serde.head_blob_id(cfg)
    held = sorted(b for b in set(held_ids) if b <= head_id)
    layer_ids = [b for b in held if b < head_id]
    if not layer_ids:
        raise ValueError(f"no model layer blobs among held layers {held}")
    if layer_ids != list(range(layer_ids[0], layer_ids[0] + len(layer_ids))):
        raise ValueError(f"held layer blobs are not contiguous: {layer_ids}")
    full = set(held) >= set(range(head_id + 1))
    return layer_ids, full


def device_blob(src) -> Optional[torch.Tensor]:
    """The layer's device-resident 1-D uint8 tensor, when ingest staged
    one."""
    arr = getattr(src, "device_array", None)
    if (isinstance(arr, torch.Tensor) and arr.dtype == torch.uint8
            and arr.dim() == 1):
        return arr
    return None


def verify_blob_digest(blob_id: int, src, digest_lookup,
                       digest_verified) -> None:
    """Integrity backstop at the boot boundary: verify a blob's HOST bytes
    against its expected layer digest before any decode.  Skips blobs the
    ack gate already verified (``digest_verified``), blobs without a known
    digest, and device-only blobs.  Raises ``ValueError`` on mismatch."""
    if digest_lookup is None:
        return
    if digest_verified is not None and blob_id in digest_verified:
        return
    expected = digest_lookup(blob_id)
    if expected is None or src.inmem_data is None:
        return
    ok, dt, got = integrity.digest_check(
        memoryview(src.inmem_data)[src.offset : src.offset + src.data_size],
        expected)
    if ok is None:
        return  # xxh3 stamp, no xxhash here: advisory skip
    trace.add_phase("integrity_digest", dt)
    if not ok:
        trace.count("integrity.digest_mismatch")
        raise ValueError(
            f"blob {blob_id} failed its boot-time digest check "
            f"(expected {expected}, got {got})")
    if digest_verified is not None:
        digest_verified.add(blob_id)


def _host_bytes(src):
    return src.inmem_data if src.inmem_data is not None else src.read_bytes()


def _unstacked(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One blob's staged leaves without their length-1 axis (views)."""
    return {name: a[0] for name, a in leaves.items()}


def views_blob(leaves: Dict[str, torch.Tensor], blob) -> bool:
    """Whether every leaf is a view of ``blob``'s memory: staged in place,
    nothing written to new device memory."""
    if blob is None:
        return False
    ptr = blob.untyped_storage().data_ptr()
    return all(a.untyped_storage().data_ptr() == ptr for a in leaves.values())


def stage_blob_leaves(cfg, blob_id: int, src, codec: str = "raw",
                      device=None) -> Dict[str, torch.Tensor]:
    """ONE blob's share of the boot: its decoded leaves on ``device``,
    each with a leading length-1 axis (the boot takes entry 0, a view).
    The shared per-blob staging of the streaming stager and the boot's
    infill.  Device blobs decode on the device (``quant.device_decode_jit``:
    dtype views for raw, the dequant kernels for int8/int4) and are
    released when ``blob_donate_ok``; an entropy form's device blob
    unwraps on the host and its base form decodes on the device
    (``_unwrapped_on_device``); host blobs decode on the host and are
    copied to the device."""
    specs = tuple(serde.blob_specs(cfg, blob_id))
    arr = device_blob(src)
    if arr is not None:
        donate = blob_donate_ok(src)
        if codec in quant.ENTROPY_CODECS:
            codec, arr = _unwrapped_on_device(codec, arr)
        leaves = quant.device_decode_jit(codec)((arr,), specs, cfg.dtype)
        if donate:
            src.device_array = None
        return leaves
    dev = resolve_device(device)
    host = quant.decode_blob_host(cfg, blob_id, _host_bytes(src), codec)
    return {name: host[name][None].to(dev) for name, _ in specs}


def _unwrapped_on_device(codec: str, arr: torch.Tensor):
    """An entropy form's device blob peeled to its quantized base:
    ``(base codec, base blob on arr's device)``.  The DLE1 pass has no
    device decode, so only it runs on the host; the base form goes back
    to the device for its kernel (K2/K3)."""
    base, data = quant.host_unwrap(codec, arr.cpu().numpy())
    return base, serde._host_u8(data).to(arr.device)


def decode_head(cfg, src, codec: str = "raw", donate: bool = False,
                device=None) -> Dict[str, torch.Tensor]:
    """embed/ln_f/lm_head leaves from a head-blob ``LayerSrc`` on
    ``device``: decoded on the device when the blob is resident there (an
    entropy form unwrapped on the host first, as ``stage_blob_leaves``
    does), else a host decode copied over.  ``donate``: release the
    record's device copy (its host copy serves later readers)."""
    dev = device_blob(src)
    if dev is not None:
        if codec in quant.ENTROPY_CODECS:
            codec, dev = _unwrapped_on_device(codec, dev)
        out = quant.head_from_device(cfg, dev, codec, donate=donate)
        if donate:
            src.device_array = None
        return out
    target = resolve_device(device)
    host = quant.head_from_blob_host(cfg, _host_bytes(src), codec)
    return {name: a.to(target) for name, a in host.items()}


def decode_after_boot(cfg, res: BootResult, n: int, tokens=None,
                      attention=None):
    """Greedy-decode ``n`` tokens from a FULL boot's resident params (the
    KV-cached serving loop, ``models/generate.py``); records
    ``res.tokens``.  Kept out of the TTFT clock: serving time, not boot
    time."""
    if n <= 0:
        return None
    if res.kind != "full" or res.params is None:
        log.warn("decode skipped: -gen needs a FULL boot (this node "
                 "booted a pipeline stage)", kind=res.kind, requested=n)
        return None
    dev = res.params["embed"].device
    t_gen = time.monotonic()
    if tokens is None:
        tokens = torch.zeros((1, 16), dtype=torch.long, device=dev)
    toks = generate(res.params, tokens, cfg, max_new=n, attention=attention)
    synchronize(dev)
    res.tokens = toks
    log.info("decoded tokens after boot", generated=int(toks.shape[1]),
             decode_ms=round((time.monotonic() - t_gen) * 1000, 1))
    return toks


# The boot's first forward runs over this many dummy tokens (see
# ``boot_from_layers``); ``precompile_boot`` warms the same shape.
BOOT_TOKENS = 16


def precompile_boot(
    cfg,
    blob_ids: Sequence[int],
    device=None,
    codec: str = "raw",
) -> dict:
    """Warm the boot of the held set ``blob_ids`` BEFORE the bytes arrive
    (a receiver starts it on ``BootHintMsg``, at distribution start), so
    the boot after startup pays no first-call set-up.

    On ``device`` (None = the CUDA card) it loads the three attention
    kernel libraries (``ops/cuda_build``: built with ``nvcc`` on first
    use), launches once each kernel instance that ``kernel_for`` picks for
    ``cfg``'s prefill (the boot's ``BOOT_TOKENS``-token forward) and
    decode (one token) shapes, and creates the cuBLAS handle with one
    ``cfg.dtype`` product of the layer's shape.  For an int8/int4
    ``codec`` it also loads that codec's dequant library and decodes one
    small blob with it (raw blobs decode to dtype views, which need no
    warm-up).  On the CPU the same calls take the plain paths.  Returns
    ``{"compiled": [...], "launches": {kernel: n}}`` naming what was
    warmed; a codec with no device decode raises.  A held set no boot
    shape accepts warms nothing."""
    try:
        classify_held_blobs(cfg, blob_ids)
    except ValueError:
        return {"compiled": [], "launches": {}}
    dev = resolve_device(device)
    quant.device_decode_jit(codec)  # raises for a codec without one
    compiled = []
    if dev.type == "cuda":
        for name, source in flash_attention.SOURCES.items():
            flash_attention._kernel(name)
            compiled.append(f"library:{source}")
    before = dict(flash_attention.launches_by_kernel)
    launches = {}
    if codec in dequant.KINDS:
        if dev.type == "cuda":
            dequant._kernel(codec)
            compiled.append(f"library:{dequant.SOURCE}")
        table = quant.leaf_table(codec, (("warm", (2, 2 * dequant.RUN)),),
                                 cfg.dtype)
        blob = torch.zeros(sum(leaf.nbytes for leaf in table),
                           dtype=torch.uint8, device=dev)
        outs = [torch.empty(leaf.shape, dtype=cfg.dtype, device=dev)
                for leaf in table]
        # The wrapper's own count of this call's launches, not the global
        # count: the streaming stager may launch the same kernel meanwhile.
        n = dequant.dequant(codec, blob, table, outs)
        if n:
            launches[f"dequant_{codec}"] = n
        compiled.append(f"dequant:{codec}")
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // kvh
    for sq in (BOOT_TOKENS, 1):
        qg = torch.zeros((1, kvh, g, sq, hd), dtype=cfg.dtype, device=dev)
        kv = torch.zeros((1, kvh, sq, hd), dtype=cfg.dtype, device=dev)
        flash_attention.block_attention(qg, kv, kv, 0, 0)
        compiled.append(f"attention:{flash_attention.kernel_for(sq, g, cfg.dtype)}"
                        f":sq={sq}:hd={hd}")
    x = torch.zeros((BOOT_TOKENS, cfg.d_model), dtype=cfg.dtype, device=dev)
    w = torch.zeros((cfg.d_model, cfg.d_model), dtype=cfg.dtype, device=dev)
    torch.mm(x, w)
    compiled.append(f"matmul:{BOOT_TOKENS}x{cfg.d_model}x{cfg.d_model}")
    synchronize(dev)
    launches.update({k: flash_attention.launches_by_kernel[k] - before[k]
                     for k in before
                     if flash_attention.launches_by_kernel[k] != before[k]})
    return {"compiled": compiled, "launches": launches}


def _normalized(cfg, layers: LayersSrc, lids: Sequence[int]) -> LayersSrc:
    """``layers`` with the wire-codec holdings ``lids`` replaced by their
    canonical raw bytes (a host decode, ``quant.decode_to_raw``); a local
    overlay -- the receiver's store keeps the encoded holdings it serves."""
    if not lids:
        return layers
    layers = dict(layers)
    for lid in lids:
        src = layers[lid]
        raw = quant.decode_to_raw(cfg, lid, src.read_bytes(), src.meta.codec)
        layers[lid] = LayerSrc(inmem_data=bytearray(raw), data_size=len(raw),
                               meta=LayerMeta(location=LayerLocation.INMEM))
    log.info("normalized wire-codec blobs for bulk assembly", blobs=list(lids))
    return layers


def boot_from_layers(
    cfg,
    layers: LayersSrc,
    device=None,
    tokens=None,
    codec: str = "raw",
    generate_tokens: int = 0,
    stager=None,
    digest_lookup=None,
    digest_verified=None,
    attention=None,
) -> BootResult:
    """Assemble delivered blobs into model params on ``device`` (None =
    the CUDA card) and run one forward.

    ``layers``: the receiver's store after dissemination.  ``codec``: the
    transfer codec of the blobs.
    ``stager``: a ``runtime.stream_boot.StreamingBootStager`` that has been
    staging blobs as they arrived; its per-layer leaves are the boot's as
    they are, and the boot infills any blob it missed -- bit-identical to
    the bulk paths in any completion order.  ``attention``: None = the
    block-attention kernel; ``block_attention_ref`` runs the plain
    version.  Returns a BootResult whose ``seconds`` is the time from
    blob assembly to the first forward's logits being ready on the
    device (TTFT)."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    head_id = serde.head_blob_id(cfg)
    layer_ids, full = classify_held_blobs(cfg, layers)

    if digest_lookup is not None:
        for lid in sorted(set(layer_ids) | ({head_id} & set(layers))):
            verify_blob_digest(lid, layers[lid], digest_lookup,
                               digest_verified)

    # Wire-codec holdings delivered under a codec other than the run's:
    # the stager decoded those it staged under their own codec; any that
    # reach the infill or bulk paths are normalised to canonical raw bytes
    # on the host first, so those paths see one codec.
    held = layer_ids + ([head_id] if head_id in layers else [])
    streamed: Dict[int, dict] = {}
    stream_wait_s = 0.0
    if stager is not None:
        t_w = time.monotonic()
        streamed = stager.collect(held)
        stream_wait_s = time.monotonic() - t_w
    mixed = [lid for lid in held
             if layers[lid].meta.codec and layers[lid].meta.codec != codec]
    layers = _normalized(cfg, layers,
                         [lid for lid in mixed if lid not in streamed])

    # Assembly, one entry of leaves per layer and no concatenation:
    # streamed per-layer leaves as staged (infilling any the stager
    # missed); otherwise device blobs decode blob by blob (raw: views in
    # place); otherwise host blobs decode on the host and go up once per
    # leaf.  ``in_place``: the layers whose leaves view their landed blob.
    per_layer = None
    in_place: Dict[int, bool] = {}
    via = ""

    def staged(lid):
        """The stager's per-blob staging, run here, noting whether the
        leaves view the landed blob."""
        blob = device_blob(layers[lid])
        leaves = stage_blob_leaves(cfg, lid, layers[lid], codec=codec,
                                   device=dev)
        in_place[lid] = views_blob(leaves, blob)
        return leaves

    if streamed:
        try:
            missing = [lid for lid in layer_ids if lid not in streamed]
            in_place = {lid: stager.staged_in_place(lid) for lid in streamed}
            for lid in missing:  # infill: blobs the stager missed
                streamed[lid] = staged(lid)
            per_layer = [_unstacked(streamed[lid]) for lid in layer_ids]
            for lid in held:
                if lid in streamed and blob_donate_ok(layers[lid]):
                    layers[lid].device_array = None
            via = ("streamed per-layer" if not missing
                   else f"streamed per-layer (+{len(missing)} infilled)")
        except Exception as e:  # noqa: BLE001 -- bulk assembly still works
            trace.count("fallback.stream_assembly_bulk")
            log.warn("streamed assembly failed; bulk assembly instead",
                     err=repr(e))
            per_layer = None
            in_place = {}
            layers = _normalized(cfg, layers, [lid for lid in mixed
                                               if layers[lid].meta.codec])
    if per_layer is None and all(device_blob(layers[lid]) is not None
                                 for lid in layer_ids):
        donate = all(blob_donate_ok(layers[lid]) for lid in layer_ids)
        per_layer = [_unstacked(staged(lid)) for lid in layer_ids]
        via = ("device bitcast" if codec == "raw"
               else f"device {codec} dequant")
        if donate:
            via += " (donated)"
    elif per_layer is None:
        blobs = {lid: _host_bytes(layers[lid]) for lid in layer_ids}
        host = quant.stacked_from_blobs_host(cfg, blobs, layer_ids, codec)
        up = {name: a.to(dev) for name, a in host.items()}
        per_layer = [{name: a[j] for name, a in up.items()}
                     for j in range(len(layer_ids))]
        via = "host assembly"
    layer_params = {name: [lp[name] for lp in per_layer]
                    for name, _ in serde.layer_param_specs(cfg)}
    trace.count("boot.stage_bytes",
                sum(a.nbytes for lp in per_layer for a in lp.values()))
    trace.count("boot.stage_copied_bytes",
                sum(a.nbytes for lid, lp in zip(layer_ids, per_layer)
                    if not in_place.get(lid) for a in lp.values()))

    if full:
        if head_id in streamed:
            head = _unstacked(streamed[head_id])
        else:
            head = decode_head(cfg, layers[head_id], codec,
                               donate=blob_donate_ok(layers[head_id]),
                               device=dev)
        params = {
            "embed": head["embed"],
            "layers": layer_params,
            "ln_f": head["ln_f"],
            "lm_head": head["lm_head"],
        }
        if tokens is None:
            tokens = torch.zeros((1, BOOT_TOKENS), dtype=torch.long,
                                 device=dev)
        logits = llama.forward(params, tokens, cfg, attention)
        synchronize(dev)
        # TTFT stops HERE: the decode below is serving time.
        dt = time.monotonic() - t0
        log.info("model booted from disseminated layers", kind="full",
                 layers=len(layer_ids), via=via, ttft_ms=round(dt * 1000, 1),
                 stream_wait_ms=round(stream_wait_s * 1000, 1))
        res = BootResult("full", dt, layer_ids, logits=logits,
                         params=params, via=via)
        decode_after_boot(cfg, res, generate_tokens, tokens=tokens,
                          attention=attention)
        return res

    x = torch.zeros((1, 16, cfg.d_model), dtype=cfg.dtype, device=dev)
    acts = llama.stage_forward(layer_params, x, cfg, attention)
    synchronize(dev)
    dt = time.monotonic() - t0
    log.info("pipeline stage booted from disseminated layers", kind="stage",
             layers=len(layer_ids), via=via, ttft_ms=round(dt * 1000, 1),
             stream_wait_ms=round(stream_wait_s * 1000, 1))
    return BootResult("stage", dt, layer_ids, activations=acts,
                      params=layer_params, via=via)
