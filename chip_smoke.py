#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--config llama3-8b-d4] [--prompt 128] [--gen 32]
                          [--long-prompt 2048] [--seed 0]

Phases, one JSON line each (any failure exits non-zero; no phase is
caught):

1. env: the card, torch/CUDA versions, and the build of every kernel
   source under ``distributed_llm_dissemination_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together).
2. kernel vs plain: each block-attention kernel (split-KV decode,
   tensor-core prefill, scalar f32) against its plain PyTorch version and
   an f64 oracle on every case shape it accepts, then the serving shapes
   of a ``--prompt`` and of a ``--long-prompt`` serve.  Device times of
   the kernel, the plain version and one library call
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   come from CUDA-graph replay of many calls, beside the least time the
   card could take (``bound_ms``); ``host_us_per_call`` is what a call
   costs the host.
3. main path at ``--config``: seeded blobs fabricated into host memory,
   delivered as shuffled 8-way byte-range fragments (plus a duplicate)
   from 4 writer threads into ``ShardedLayerIngest``; each finished blob
   goes to a ``StreamingBootStager``; then ``boot_from_layers`` boots and
   generates ``--gen`` tokens.  The attention launch counts, in all and
   per kernel, are zeroed just before and read just after.  Then warm
   serving times, and a warm ``--long-prompt`` serve.
4. on-card parity: the boot's logits and 16 greedy tokens again with the
   attention forced through the plain version on the same tensors.
5. profile: device time by kernel, each attention kernel's time per call,
   attention's share of device time and the device's idle share over a
   warm ``generate`` call at each prompt length (``torch.profiler``).
6. dissemination: phase 3's model is freed, then a mode-3 round of the
   port's control plane over loopback TCP delivers the same blobs into
   the card's memory: leader 0 and seeder 1 hold every blob (sharing one
   host copy), a max-flow plan splits the bytes between them, cold dest 2
   reassembles, verifies digests, ingests each layer fragment by fragment
   into HBM, stages and boots, then answers ``REQUESTS`` greedy
   ``GenerateReqMsg`` requests for phase 3's prompt from a requester
   seat.  Checked: every blob on the card byte-exact via incremental
   ingest, no fallback fired, both seeders sent bytes, the warm-up ran
   before startup, a full boot, served ids equal to phase 3's, and the
   attention launches of the phase equal what the warm-up, the boot and
   the requests must launch, by kernel.  The round runs twice: with the
   host's integrity algorithms (xxh3 where ``xxhash`` imports), then as
   on a host without ``xxhash`` (crc32 frames, blake2b-128 digests).

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` prints them, and, last, the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import queue
import random
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
CSRC = "distributed_llm_dissemination_tpu_torch/csrc/"
KERNEL_REPLACES = "distributed_llm_dissemination_tpu/ops/flash_attention.py:128"
# Kernel name -> the CUDA kernels (profiler names) it launches.
DEVICE_KERNELS = {"decode": ("decode_split_kernel", "decode_merge_kernel"),
                  "prefill": ("prefill_wgmma_kernel",),
                  "scalar": ("block_attention_kernel",)}
PARTS = 8  # fragments per blob, as bench.py
WRITERS = 4
REPEATS = 5  # warm serving samples
LONG_REPEATS = 3  # warm long-prompt serving samples
TIMING = "CUDA-graph replay, mean device ms per call"
REQUESTS = 3  # served requests in the dissemination phase
# NIC model of the dissemination round: far above what loopback carries,
# so the plan never paces a send; the dest's is twice a seeder's so the
# max-flow plan needs both seeders (with equal NICs one already meets its
# bound and the plan names only one).
SEEDER_NIC = 1 << 40
DEST_NIC = 1 << 41


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing

@functools.cache
def _warm_stream():
    """The one side stream every ``time_graph`` warms up on.  PyTorch keeps
    a cuBLAS workspace for each stream that ran a product until the process
    ends, so a stream per call would leave over 1 GiB allocated after
    phase 2."""
    import torch

    return torch.cuda.Stream()


def time_graph(fn, calls: int = 10, replays: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: ``calls`` calls are
    captured into one CUDA graph and the graph is replayed ``replays``
    times between two CUDA events, so the host's cost per call is not in
    the number (it would be, timing back-to-back eager calls)."""
    import torch

    side = _warm_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (enqueue only, no sync)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def attention_bound(b, kvh, g, sq, t, hd, q_off, k_off, dtype_name):
    """Least time for one block_attention call: the larger of the bytes
    it must move (q, the K/V rows some query can see, outputs) over the
    HBM rate and the operations its visible (query, key) pairs need over
    the peak rate for the input type.  Returns (ms, "bytes"|"operations",
    flops, bytes)."""
    item = 2 if dtype_name == "bfloat16" else 4
    pairs = 0
    for r in range(sq):
        pairs += max(0, min(t, q_off + r - k_off + 1))
    keys = max(0, min(t, q_off + sq - 1 - k_off + 1))
    heads = b * kvh * g
    flops = 4 * hd * pairs * heads
    nbytes = (heads * sq * hd * item + 2 * b * kvh * keys * hd * item
              + heads * sq * (hd + 2) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def oracle_f64(qg, k, v, q_off, k_off):
    """Unnormalised causal attention (pv, m, l) in float64."""
    import torch

    q64, k64, v64 = qg.double(), k.double(), v.double()
    sq, t, hd = qg.shape[3], k.shape[2], qg.shape[4]
    s = torch.einsum("bkgsh,bkth->bkgst", q64, k64) / math.sqrt(hd)
    vis = ((q_off + torch.arange(sq, device=qg.device))[:, None]
           >= (k_off + torch.arange(t, device=qg.device))[None, :])
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    m = s.amax(-1) if t else torch.full(qg.shape[:4], -1e30, device=qg.device,
                                        dtype=torch.float64)
    p = torch.where((m > -5e29)[..., None], torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(-1)
    return torch.einsum("bkgst,bkth->bkgsh", p, v64), m, l


def library_fn(qg, k, v, q_off, k_off):
    """One PyTorch call computing the normalised output (yardstick).  The
    mask is built here, outside the returned call, so a timing of the
    call times ``scaled_dot_product_attention`` alone."""
    import torch
    import torch.nn.functional as F

    b, kvh, g, sq, hd = qg.shape
    q = qg.reshape(b, kvh * g, sq, hd)
    if q_off == k_off == 0 and sq == k.shape[2]:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    vis = ((q_off + torch.arange(sq, device=qg.device))[:, None]
           >= (k_off + torch.arange(k.shape[2], device=qg.device))[None, :])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=vis,
                                                  enable_gqa=True)


def _row_max_err(a, b):
    return (a.double() - b.double()).abs().amax(-1)


def attention_case(fa, b, kvh, g, sq, t, hd, q_off, k_off, dtype, seed,
                   calls=10, host=False):
    """Phase-2 record for one shape: which kernel served it, its errors
    against the plain version and the f64 oracle (checked), and the three
    device times beside the bound."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    qg, k, v = rnd(b, kvh, g, sq, hd), rnd(b, kvh, t, hd), rnd(b, kvh, t, hd)
    name = fa.kernel_for(sq, g, dtype)
    before = dict(fa.launches_by_kernel)
    got = fa.block_attention(qg, k, v, q_off, k_off)
    torch.cuda.synchronize()
    check(fa.launches_by_kernel[name] == before[name] + 1,
          f"{name} kernel launch not counted")
    plain = fa.block_attention_ref(qg, k, v, q_off, k_off)
    oracle = oracle_f64(qg, k, v, q_off, k_off)
    # Tolerances.  m: 1e-4 (f32 rounding of a max).  l and pv: sums of up
    # to t f32 terms of size <= 1 in another order, tol * max(1, max l).
    # pv of the prefill kernel also carries its bf16 rounding of p, at
    # most BF16_P_REL * l * max|v| per row (ops/flash_attention.py).
    tol = 2e-3 if t > 1024 else 1e-3
    lmax = max(1.0, float(plain[2].abs().max()))
    pv_bound = torch.full_like(plain[2], tol * lmax, dtype=torch.float64)
    if name == "prefill" and t:
        pv_bound = pv_bound + (fa.BF16_P_REL * oracle[2]
                               * float(v.float().abs().max()))
    err_plain = [float(_row_max_err(got[0], plain[0]).max()),
                 float((got[1] - plain[1]).abs().max()),
                 float((got[2] - plain[2]).abs().max())]
    # Against the f64 oracle, m only where a key is visible: -1e30 itself
    # rounds differently in f32 and f64.
    seen = oracle[1] > -5e29
    err_oracle = [float(_row_max_err(got[0], oracle[0]).max()),
                  float((got[1].double() - oracle[1])[seen].abs().max()
                        if bool(seen.any()) else 0.0),
                  float((got[2].double() - oracle[2]).abs().max())]
    pv_ratio = float(torch.maximum(
        _row_max_err(got[0], plain[0]) / pv_bound,
        _row_max_err(got[0], oracle[0]) / pv_bound).max())
    live = got[2] > 0
    lib_err, library_ms = None, None
    if bool(live.all()):
        lib = library_fn(qg, k, v, q_off, k_off)
        out = got[0] / got[2][..., None]
        ref = lib()
        lib_err = float((out.reshape(ref.shape) - ref.float()).abs().max())
        library_ms = time_graph(lib, calls)
    dtype_name = str(dtype).split(".")[-1]
    bound_ms, bound_by, flops, nbytes = attention_bound(
        b, kvh, g, sq, t, hd, q_off, k_off, dtype_name)
    ms = time_graph(lambda: fa.block_attention(qg, k, v, q_off, k_off), calls)
    plain_ms = time_graph(
        lambda: fa.block_attention_ref(qg, k, v, q_off, k_off), calls)
    rec = {
        "kernel": name,
        "shape": {"b": b, "kvh": kvh, "g": g, "sq": sq, "t": t, "hd": hd,
                  "q_off": q_off, "k_off": k_off, "dtype": dtype_name},
        "max_abs_err_vs_plain": dict(zip(("pv", "m", "l"), err_plain)),
        "max_abs_err_vs_f64": dict(zip(("pv", "m", "l"), err_oracle)),
        "pv_err_over_bound": pv_ratio,
        "max_abs_err_library_vs_kernel_normalised": lib_err,
        "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "timing": TIMING,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes,
    }
    if host:
        rec["host_us_per_call"] = host_us_per_call(
            lambda: fa.block_attention(qg, k, v, q_off, k_off))
    check(err_plain[1] <= 1e-4 and err_oracle[1] <= 1e-4,
          f"m disagrees {rec}")
    check(pv_ratio <= 1.0, f"pv disagrees {rec}")
    check(err_plain[2] <= tol * lmax and err_oracle[2] <= tol * lmax,
          f"l disagrees {rec}")
    return rec


# ------------------------------------------------------------------ phases

def phase_env(cuda_build, fa):
    import torch

    card = nvidia_smi()
    sources = list(fa.SOURCES.values())
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(cuda_build.build, sources))
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         build_wall_s=time.monotonic() - t0,
         builds={s: {"library": str(p.name), "nvcc_s": sec,
                     "ptxas": [ln.split("info    : ")[-1] for ln in
                               report.splitlines() if "registers" in ln]}
                 for s, (p, sec, report) in zip(sources, built)})
    return card


def serving_shapes(cfg, prompt: int, gen: int):
    """The main path's block_attention calls: (count, sq, t, q_off)."""
    L, P, G = cfg.n_layers, prompt, gen
    shapes = [(L, P, P, 0),            # boot's first forward (TTFT)
              (L, P, P + G, 0)]        # serving prefill against the cache
    shapes += [(L, 1, P + G, P + i - 1) for i in range(1, G)]  # decode
    return shapes


def _new_tally():
    return {"n": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0.0,
            "max_pv_err_over_bound": 0.0}


def _add(tally, rec, n):
    tally["n"] += n
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        tally[key] += n * (rec[key] or 0.0)
    if rec["bound_by"] == "bytes":
        tally["bytes_ms"] += n * rec["bound_ms"]
    tally["max_abs_err"] = max(tally["max_abs_err"],
                               *rec["max_abs_err_vs_plain"].values())
    tally["max_pv_err_over_bound"] = max(tally["max_pv_err_over_bound"],
                                         rec["pv_err_over_bound"])


def _per_launch(tally):
    """Per-launch means of a tally (launch-count weighted)."""
    n = tally["n"]
    if not n:
        return None
    return {"launches": n, "ms": tally["ms"] / n,
            "plain_ms": tally["plain_ms"] / n,
            "bound_ms": tally["bound_ms"] / n,
            "bound_by": ("bytes" if tally["bytes_ms"] * 2 >= tally["bound_ms"]
                         else "operations"),
            "library_ms": tally["library_ms"] / n,
            "max_abs_err": tally["max_abs_err"],
            "max_pv_err_over_bound": tally["max_pv_err_over_bound"]}


def serving_mix(fa, cfg, prompt, gen, seed0):
    """Every serving shape of one (prompt, gen) serve, timed and checked,
    tallied per kernel and weighted by its launch count."""
    import torch

    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    shapes = serving_shapes(cfg, prompt, gen)
    tallies = {name: _new_tally() for name in fa.SOURCES}
    for j, (n, sq, t, q_off) in enumerate(shapes):
        rec = attention_case(fa, 1, kvh, g, sq, t, hd, q_off, 0,
                             torch.bfloat16, seed=seed0 + j,
                             host=j in (1, len(shapes) - 1))
        if j < 3 or j == len(shapes) - 1:
            emit("kernel_case", serving_prompt=prompt, launches=n, **rec)
        _add(tallies[rec["kernel"]], rec, n)
    return {name: _per_launch(tl) for name, tl in tallies.items()}


def phase_kernel(fa, cfg, prompt, gen, long_prompt):
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    jax_offsets = ((0, 0), (256, 0), (0, 256), (128, 0))
    cases = [(1, 2, 2, 256, 256, 128, qo, ko, f32) for qo, ko in jax_offsets]
    cases += [(1, 2, 2, 100, 2049, 32, 2000, 0, f32),          # hd 32, ragged
              (1, 2, 2, 77, 300, 64, 250, 0, f32)]             # hd 64, ragged
    cases += [                                                  # decode kernel
        (1, kvh, g, 1, 160, hd, 159, 0, bf16),
        (1, kvh, g, 1, 2048, hd, 2047, 0, bf16),
        (1, kvh, g, 1, 333, hd, 200, 0, bf16),                  # ragged t
        (1, kvh, g, 1, 160, hd, 10, 100, bf16),                 # nothing visible
        (1, kvh, g, 1, 0, hd, 0, 0, bf16),                      # empty block
        (1, 2, 4, 2, 300, 64, 250, 0, bf16),                    # hd 64, sq 2
        (1, 2, 8, 1, 1000, 32, 999, 0, bf16),                   # hd 32, g 8
    ]
    cases += [(1, 2, 2, 256, 256, 128, qo, ko, bf16) for qo, ko in jax_offsets]
    cases += [                                                  # prefill kernel
        (1, 2, 2, 77, 300, 64, 250, 0, bf16),                   # hd 64, ragged
        (1, 2, 2, 100, 77, 32, 40, 0, bf16),                    # hd 32, ragged
        (1, 2, 2, 64, 0, 64, 0, 0, bf16),                       # empty block
        (1, kvh, g, 2048, 2048, hd, 0, 0, bf16),                # s = 2048
    ]
    by_kernel = {name: _new_tally() for name in fa.SOURCES}
    for i, case in enumerate(cases):
        rec = attention_case(fa, *case, seed=i,
                             calls=4 if case[3] * case[4] > 1 << 20 else 10)
        emit("kernel_case", **rec)
        _add(by_kernel[rec["kernel"]], rec, 1)
    for name, tally in by_kernel.items():
        check(tally["n"] > 0, f"no phase-2 case for the {name} kernel")
    mixes = {f"prompt{p}": serving_mix(fa, cfg, p, gen, seed0)
             for p, seed0 in ((prompt, 100), (long_prompt, 200))}
    emit("kernel_mixes", gen=gen, timing=TIMING, mixes=mixes)
    return {name: _per_launch(tl) for name, tl in by_kernel.items()}, mixes


def fabricate(cfg, serde, seed):
    """Seeded blobs, made on the card and copied into host memory."""
    t0 = time.monotonic()
    blobs = {i: bytearray(serde.seeded_blob(cfg, i, seed=seed))
             for i in range(serde.head_blob_id(cfg) + 1)}
    return blobs, time.monotonic() - t0


def bulk_gbps(blobs):
    """One plain ``.to("cuda")`` per blob of the same host bytes."""
    import torch

    total, secs = 0, 0.0
    for b in blobs.values():
        src = torch.frombuffer(b, dtype=torch.uint8)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        dst = src.to("cuda")
        torch.cuda.synchronize()
        secs += time.monotonic() - t0
        total += len(b)
        del dst
    return total / secs / 1e9


def deliver(cfg, blobs, stager, seed):
    """Fragments of every blob from WRITERS threads into one ingest per
    blob; a finished blob becomes an HBM LayerSrc and goes to the
    stager.  Returns (layers, seconds, fragments written)."""
    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc)
    from distributed_llm_dissemination_tpu_torch.ops.reassembly import (
        split_offsets)
    from distributed_llm_dissemination_tpu_torch.parallel.ingest import (
        ShardedLayerIngest)
    from distributed_llm_dissemination_tpu_torch.parallel.mover import (
        WeightMover)

    rng = random.Random(seed)
    mover = WeightMover()
    ingests = {lid: ShardedLayerIngest(len(b), mover=mover)
               for lid, b in blobs.items()}
    work: "queue.Queue" = queue.Queue()
    remaining = {}
    for lid in sorted(blobs):
        frags = list(split_offsets(len(blobs[lid]), PARTS))
        rng.shuffle(frags)
        frags.insert(rng.randrange(1, len(frags)), frags[0])  # a duplicate
        remaining[lid] = len(frags)
        for off, size in frags:
            work.put((lid, off, size))
    layers, errors = {}, []
    lock = threading.Lock()

    def writer():
        while True:
            try:
                lid, off, size = work.get_nowait()
            except queue.Empty:
                return
            try:
                ingests[lid].write(off, memoryview(blobs[lid])[off : off + size])
                with lock:
                    remaining[lid] -= 1
                    last = remaining[lid] == 0
                if last:
                    arr = ingests[lid].finalize()
                    src = LayerSrc(
                        inmem_data=blobs[lid], data_size=len(blobs[lid]),
                        meta=LayerMeta(location=LayerLocation.HBM,
                                       data_size=len(blobs[lid])),
                        device_array=arr)
                    with lock:
                        layers[lid] = src
                    stager.submit(lid, src)
            except Exception as e:  # noqa: BLE001 -- re-raised after join
                errors.append(e)
                return

    t0 = time.monotonic()
    threads = [threading.Thread(target=writer, name=f"writer-{i}")
               for i in range(WRITERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.monotonic() - t0
    if errors:
        raise errors[0]
    check(sorted(layers) == sorted(blobs), "not every blob finalized")
    return layers, secs, sum(PARTS + 1 for _ in blobs)


def staged_bytes_exact(cfg, serde, stager, blobs):
    import torch

    staged = stager.collect(sorted(blobs))
    check(sorted(staged) == sorted(blobs), f"staged {sorted(staged)}")
    for lid, leaves in staged.items():
        flat = torch.cat([leaves[name].reshape(-1).view(torch.uint8)
                          for name, _ in serde.blob_specs(cfg, lid)])
        host = torch.frombuffer(blobs[lid], dtype=torch.uint8).to("cuda")
        check(torch.equal(flat, host), f"blob {lid} not byte-exact")
    return len(staged)


def phase_main(cfg, args, fa):
    import torch

    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        boot_from_layers)
    from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
        StreamingBootStager)

    blobs, fab_s = fabricate(cfg, serde, args.seed)
    fab = {"blobs": blobs}
    total = sum(len(b) for b in blobs.values())
    bulk = bulk_gbps(blobs)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (1, args.prompt), generator=gen,
                           device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stager = StreamingBootStager(cfg)

    fa.reset_counts()  # the main path's counts start here
    layers, ingest_s, n_frags = deliver(cfg, blobs, stager, args.seed)
    exact = staged_bytes_exact(cfg, serde, stager, blobs)
    t0 = time.monotonic()
    res = boot_from_layers(cfg, layers, stager=stager, tokens=prompt,
                           generate_tokens=args.gen)
    boot_wall = time.monotonic() - t0
    launches = fa.launches  # ...and are read here
    by_kernel = dict(fa.launches_by_kernel)
    stager.close()

    g = cfg.n_heads // cfg.n_kv_heads
    want = {name: 0 for name in fa.SOURCES}
    for n, sq, *_ in serving_shapes(cfg, args.prompt, args.gen):
        want[fa.kernel_for(sq, g, cfg.dtype)] += n
    check(res.via == "streamed per-layer", f"via {res.via!r}")
    check(launches > 0, "the main path launched no attention kernel")
    check(launches == sum(want.values()),
          f"launches {launches} != {sum(want.values())}")
    check(by_kernel == want, f"launches by kernel {by_kernel} != {want}")
    for name, n in want.items():
        check(n == 0 or by_kernel[name] > 0,
              f"the main path never launched the {name} kernel")
    check(tuple(res.tokens.shape) == (1, args.gen), "token shape")
    check(bool(torch.isfinite(res.logits).all()), "non-finite logits")
    check(tuple(res.logits.shape) == (1, args.prompt, cfg.vocab),
          "logit shape")

    # Warm serving times (outside the counted run): REPEATS samples each
    # of a prefill-only call and a full --gen call.
    prefill, per_token = warm_serve(cfg, res.params, prompt, args.gen,
                                    REPEATS)
    emit("main", config=cfg.name, blobs=len(blobs), bytes=total,
         fabricate_s=fab_s, fragments=n_frags, writers=WRITERS,
         ingest_s=ingest_s, ingest_gbps=total / ingest_s / 1e9,
         bulk_to_cuda_gbps=bulk,
         link_fraction=(total / ingest_s / 1e9) / bulk,
         staged_byte_exact=exact, via=res.via, ttft_s=res.seconds,
         boot_and_serve_wall_s=boot_wall,
         serve_ms_per_token_cold=(boot_wall - res.seconds) / args.gen * 1e3,
         warm_samples=REPEATS,
         warm_prefill_ms_median=statistics.median(prefill),
         warm_prefill_ms_min_max=[prefill[0], prefill[-1]],
         warm_decode_ms_per_token_median=statistics.median(per_token),
         warm_decode_ms_per_token_min_max=[per_token[0], per_token[-1]],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         attention_launches=launches, attention_launches_by_kernel=by_kernel,
         tokens=res.tokens[0].tolist())
    fab["tokens"] = res.tokens[0].tolist()
    fab["serve_ms"] = {"prefill": statistics.median(prefill),
                       "per_token": statistics.median(per_token)}
    return res, prompt, by_kernel, fab


def warm_serve(cfg, params, prompt, gen, repeats):
    """Sorted warm ms of ``repeats`` prefill-only calls, and sorted decode
    ms per token of ``repeats`` full ``gen``-token calls."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)

    def serve_ms(n):
        torch.cuda.synchronize()
        t = time.monotonic()
        generate(params, prompt, cfg, n)
        torch.cuda.synchronize()
        return (time.monotonic() - t) * 1e3

    serve_ms(2)
    prefill = sorted(serve_ms(1) for _ in range(repeats))
    full = sorted(serve_ms(gen) for _ in range(repeats))
    per_token = sorted((f - statistics.median(prefill)) / (gen - 1)
                       for f in full)
    return prefill, per_token


def phase_long_serve(cfg, args, res):
    """A warm serve of a --long-prompt prompt on the booted params: the
    shape at which attention costs the most."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import llama

    gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    prompt = torch.randint(0, cfg.vocab, (1, args.long_prompt),
                           generator=gen, device="cuda")
    logits = llama.forward(res.params, prompt, cfg)
    check(bool(torch.isfinite(logits).all()), "non-finite long-prompt logits")
    check(tuple(logits.shape) == (1, args.long_prompt, cfg.vocab),
          "long-prompt logit shape")
    del logits
    prefill, per_token = warm_serve(cfg, res.params, prompt, args.gen,
                                    LONG_REPEATS)
    emit("long_serve", prompt=args.long_prompt, gen=args.gen,
         warm_samples=LONG_REPEATS,
         warm_prefill_ms_median=statistics.median(prefill),
         warm_prefill_ms_min_max=[prefill[0], prefill[-1]],
         warm_decode_ms_per_token_median=statistics.median(per_token),
         warm_decode_ms_per_token_min_max=[per_token[0], per_token[-1]],
         logits_finite=True)
    return prompt


def phase_parity(cfg, res, prompt, fa):
    import torch

    from distributed_llm_dissemination_tpu_torch.models import llama
    from distributed_llm_dissemination_tpu_torch.models.generate import generate

    plain = llama.forward(res.params, prompt, cfg,
                          attention=fa.block_attention_ref)
    diff = float((plain - res.logits).abs().max())
    n = min(16, res.tokens.shape[1])
    plain_ids = generate(res.params, prompt, cfg, n,
                         attention=fa.block_attention_ref)[0].tolist()
    kernel_ids = res.tokens[0, :n].tolist()
    # The plain run's top-1/top-2 margin at each step.
    margins = []
    for i in range(n):
        ids = torch.tensor([plain_ids[:i]], device=prompt.device,
                           dtype=prompt.dtype)
        lg = llama.forward(res.params, torch.cat([prompt, ids], 1), cfg,
                           attention=fa.block_attention_ref)[0, -1]
        top = torch.topk(lg, 2).values
        margins.append(float(top[0] - top[1]))
    upto = next((i for i, m in enumerate(margins) if m < diff), n)
    agree = next((i for i in range(n) if plain_ids[i] != kernel_ids[i]), n)
    emit("parity", max_abs_logit_diff=diff, plain_ids=plain_ids,
         kernel_ids=kernel_ids, first_near_tie=upto, agree_prefix=agree,
         margins=margins)
    # bf16 hidden states: a kernel that agrees with the plain version to
    # f32 rounding moves logits by bf16 roundings, far below 2% of the
    # largest logit.
    scale = float(plain.abs().max())
    check(diff <= 0.02 * scale, f"kernel and plain logits differ by {diff} "
          f"(largest logit {scale})")
    check(kernel_ids[:upto] == plain_ids[:upto],
          f"greedy ids differ before the first near-tie ({upto})")


def phase_profile(cfg, res, prompt, label):
    """Where a warm serving call spends the card's time: torch.profiler
    over ``generate`` of 9 tokens (prefill + 8 decode steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_llm_dissemination_tpu_torch.models.generate import generate

    generate(res.params, prompt, cfg, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        generate(res.params, prompt, cfg, 9)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # Kernels only: a CPU op's device time repeats its kernels' time.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    attention = {}
    for name, kernels in DEVICE_KERNELS.items():
        hits = [e for e in events if any(k in e.key for k in kernels)]
        if hits:
            ms = sum(e.self_device_time_total for e in hits) / 1e3
            attention[name] = {
                "device_ms": ms,
                "cuda_kernels": {e.key[:60]: {
                    "launches": e.count,
                    "device_ms": e.self_device_time_total / 1e3}
                    for e in hits},
                "device_ms_per_call": ms / max(e.count for e in hits)}
    attention_ms = sum(a["device_ms"] for a in attention.values())
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    emit("profile", what=f"generate(prompt of {prompt.shape[1]}, 9 tokens), "
         "warm, under the profiler", label=label, wall_ms=wall_ms,
         device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if wall_ms else None,
         attention=attention, attention_device_ms=attention_ms,
         attention_share_of_busy=attention_ms / busy_ms if busy_ms else None,
         top=[{"name": e.key[:80], "device_ms": e.self_device_time_total / 1e3,
               "calls": e.count} for e in top])


def loopback_gbps(total: int = 1 << 30, streams: int = 4) -> float:
    """Raw TCP loopback GB/s: ``streams`` plain sockets carry ``total``
    bytes together (``sendall`` of one buffer, ``recv_into`` a reused
    one).  The yardstick of the round's wire: the same hop without the
    transport's framing, checksums, reassembly and device ingest."""
    import socket

    chunk, per = 16 << 20, total // streams
    payload = memoryview(bytearray(chunk))
    srv = socket.create_server(("127.0.0.1", 0), backlog=streams)
    port = srv.getsockname()[1]

    def receive():
        conn, _ = srv.accept()
        buf = memoryview(bytearray(chunk))
        left = per
        while left:
            n = conn.recv_into(buf[:min(chunk, left)])
            check(n > 0, "loopback probe: peer closed early")
            left -= n
        conn.close()

    def send():
        with socket.create_connection(("127.0.0.1", port)) as conn:
            left = per
            while left:
                n = min(chunk, left)
                conn.sendall(payload[:n])
                left -= n

    threads = ([threading.Thread(target=receive) for _ in range(streams)]
               + [threading.Thread(target=send) for _ in range(streams)])
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.monotonic() - t0
    srv.close()
    return per * streams / secs / 1e9


def _expected_round_launches(fa, cfg, args, warm):
    """The attention launches of the dissemination phase, by kernel: the
    dest's warm-up (its record), the boot's first forward and, per
    request, a prefill and ``gen - 1`` decode steps."""
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        BOOT_TOKENS)

    g = cfg.n_heads // cfg.n_kv_heads
    L = cfg.n_layers
    want = {name: warm.get(name, 0) for name in fa.SOURCES}
    want[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += L
    want[fa.kernel_for(args.prompt, g, cfg.dtype)] += REQUESTS * L
    want[fa.kernel_for(1, g, cfg.dtype)] += REQUESTS * (args.gen - 1) * L
    return want


def _join_round_threads(before, timeout_s: float = 30.0) -> None:
    """Wait for the threads a round started (message loops, heartbeats,
    serve threads) to end.  ``close()`` only signals them, and each holds
    its node, so until they end the round's tensors stay allocated.  The
    transport's process-wide data threads (``threads.DATA_PREFIXES``)
    outlive every round and are not waited for."""
    from distributed_llm_dissemination_tpu_torch.utils.threads import (
        DATA_PREFIXES)

    deadline = time.monotonic() + timeout_s
    for t in threading.enumerate():
        if t not in before and not t.name.startswith(DATA_PREFIXES):
            t.join(max(0.0, deadline - time.monotonic()))


def phase_dissemination(cfg, args, fa, fab, prompt, without_xxhash=False):
    """One mode-3 round (module docstring, phase 6).  ``without_xxhash``:
    every node of the round runs as on a host without the ``xxhash``
    extension (crc32 frame checksums, blake2b-128 layer digests)."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc, SourceType)
    from distributed_llm_dissemination_tpu_torch.native import (
        load_flow_solver)
    from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
        assignment_to_placement)
    from distributed_llm_dissemination_tpu_torch.runtime import (
        FlowRetransmitLeaderNode, FlowRetransmitReceiverNode, Node)
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester)
    from distributed_llm_dissemination_tpu_torch.transport.tcp import (
        TcpTransport)
    from distributed_llm_dissemination_tpu_torch.utils import (
        integrity, telemetry, trace)

    host_xxhash = integrity._xxhash
    if without_xxhash:
        integrity._xxhash = None
    blobs = fab["blobs"]
    ids = sorted(blobs)
    total = sum(len(b) for b in blobs.values())

    def holdings():
        # Leader and seeder share one host copy of each blob.
        return {lid: LayerSrc(inmem_data=blobs[lid], data_size=len(blobs[lid]),
                              meta=LayerMeta(location=LayerLocation.INMEM,
                                             source_type=SourceType.MEM))
                for lid in ids}

    assignment = {2: {lid: LayerMeta() for lid in ids}}
    placement = assignment_to_placement(assignment)  # one card, one stage
    nic = {0: SEEDER_NIC, 1: SEEDER_NIC, 2: DEST_NIC}
    # The boot keeps each staged blob's tensor referenced (its leaves view
    # the same memory), so the byte check below reads what was staged.
    os.environ["DLD_BOOT_DONATE"] = "0"
    ts = {i: TcpTransport("127.0.0.1:0") for i in range(4)}
    for t in ts.values():
        t.addr_registry.update({i: u.addr for i, u in ts.items()})
    solver = "native (C++)" if load_flow_solver() is not None else "python"
    gc.collect()  # an earlier round's nodes and tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    threads_before = set(threading.enumerate())
    trace.reset_run()
    fa.reset_counts()  # the round's counts start here
    t_phase = time.monotonic()
    leader = FlowRetransmitLeaderNode(Node(0, 0, ts[0]), holdings(),
                                      assignment, nic, expected_nodes={1, 2})
    seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), holdings())
    dest = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {}, stage_hbm=True,
                                      placement=placement, boot_cfg=cfg)
    requester = GenRequester(ts[3], my_id=3)
    try:
        seeder.announce()
        dest.announce()
        leader.start_distribution().get(timeout=300)
        t0 = time.monotonic()
        leader.ready().get(timeout=600)
        t_startup = time.monotonic()
        booted = leader.boot_ready().get(timeout=600)
        t_boot = time.monotonic()
        served, latency = [], []
        for _ in range(REQUESTS):
            t_req = time.monotonic()
            served.append(requester.request(2, prompt[0].tolist(), args.gen,
                                            timeout=300))
            latency.append(time.monotonic() - t_req)
        launches = dict(fa.launches_by_kernel)  # ...and are read here
        wall = time.monotonic() - t_phase
        counters = trace.counter_totals()
        phases = trace.phase_totals()
        links = telemetry.snapshot().get("links", {})

        res = dest.boot_result
        for lid in ids:
            src = dest.layers[lid]
            arr = src.device_array
            check(src.meta.location == LayerLocation.HBM,
                  f"blob {lid} at {src.meta.location!r}, not HBM")
            check(isinstance(arr, torch.Tensor) and arr.is_cuda,
                  f"blob {lid} is not a CUDA tensor")
            host = torch.frombuffer(blobs[lid], dtype=torch.uint8).to("cuda")
            check(torch.equal(arr, host), f"blob {lid} not byte-exact")
            del host
        via_ingest = counters.get("hbm_staged.incremental_ingest", 0)
        check(via_ingest == len(ids),
              f"{via_ingest} of {len(ids)} staged via incremental ingest")
        fallbacks = {k: v for k, v in counters.items()
                     if k.startswith("fallback.")}
        check(not any(fallbacks.values()), f"fallbacks fired: {fallbacks}")
        sent = {src: links.get(f"{src}->2", {}).get("tx_bytes", 0)
                for src in (0, 1)}
        check(all(sent.values()), f"a seeder sent nothing: {sent}")
        check(sum(sent.values()) >= total, f"sent {sent} < {total} bytes")
        warm = dest.precompile_records
        check(len(warm) >= 1 and all(in_wire for _, in_wire in warm),
              f"warm-up did not finish before startup: {warm}")
        check(booted.keys() == {2} and res is not None and res.kind == "full",
              f"boot {booted} kind {getattr(res, 'kind', None)}")
        for ids_got in served:
            check(ids_got == fab["tokens"],
                  f"served ids {ids_got} != phase 3's {fab['tokens']}")
        want = _expected_round_launches(fa, cfg, args, warm[0][0]["launches"])
        check(launches == want, f"round launches {launches} != {want}")

        ttd = t_startup - t0
        direct = fab["serve_ms"]
        emit("dissemination", config=cfg.name, mode=3, transport="tcp loopback",
             xxhash=not without_xxhash,
             blobs=len(ids), bytes=total, nic_bytes_per_s=nic,
             solver=solver, ttd_s=ttd,
             predicted_ttd_s=leader.predicted_ttd_ms / 1e3,
             solve_ms=leader.solve_ms, wire_gbps=total / ttd / 1e9,
             sent_bytes_by_source=sent,
             frame_checksum=integrity.fragment_checksum(b"")[0],
             digest_algo=integrity.digest_algo(),
             digest_stamp_s=phases.get("integrity_digest_stamp", {}).get(
                 "ms", 0.0) / 1e3,
             digest_verify_s=phases.get("integrity_digest", {}).get(
                 "ms", 0.0) / 1e3,
             crc_recv_s=phases.get("integrity_crc_recv", {}).get(
                 "ms", 0.0) / 1e3,
             crc_send_s=phases.get("integrity_crc_send", {}).get(
                 "ms", 0.0) / 1e3,
             # What each candidate hash costs on this host, GB/s on one
             # thread: the price of the digest and frame algorithms above
             # and of their fallbacks on a host without xxhash.
             hash_gbps=(integrity.hash_bench(256 << 20)
                        if not without_xxhash else None),
             loopback_raw_gbps=(loopback_gbps()
                                if not without_xxhash else None),
             staged_via_incremental_ingest=via_ingest, fallbacks=fallbacks,
             precompile=[rec for rec, _ in warm],
             boot_kind=res.kind, boot_via=res.via,
             ttft_s=t_boot - t_startup, ttft_total_s=t_boot - t0,
             boot_s=booted[2],
             request_latency_s=latency,
             # A request's decode ms/token, taking its prefill to cost what
             # phase 3's direct warm prefill cost.
             request_decode_ms_per_token=[
                 (lat * 1e3 - direct["prefill"]) / (args.gen - 1)
                 for lat in latency],
             direct_generate_ms=direct,
             served_ids_equal_phase3=True,
             attention_launches_by_kernel=launches,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             allocated_at_start=allocated_at_start,
             phase_wall_s=wall,
             phases_ms={k: v["ms"] for k, v in phases.items()})
    finally:
        requester.close()
        leader.close()
        seeder.close()
        dest.close()
        for t in ts.values():
            t.close()
        _join_round_threads(threads_before)
        os.environ.pop("DLD_BOOT_DONATE", None)
        integrity._xxhash = host_xxhash


def kernel_entry(fa, name, launches, case_stats, mixes, main_mix):
    """One ``kernels`` entry: the per-launch means of the main path's
    launch mix, or of phase 2's cases for a kernel the main path does not
    run, with every mix beside them."""
    head = mixes[main_mix][name] or case_stats[name]
    return {
        "name": f"block_attention_{name}",
        "route": "cuda",
        "source": CSRC + fa.SOURCES[name],
        "replaces": KERNEL_REPLACES,
        "launches": launches[name],
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "device_kernels": list(DEVICE_KERNELS[name]),
        "numbers_from": (f"{main_mix} serving mix" if mixes[main_mix][name]
                         else "phase-2 cases (not on the main path)"),
        "timing": TIMING,
        "mixes": {mix: stats[name] for mix, stats in mixes.items()},
        "phase2_cases": case_stats[name],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="llama3-8b-d4")
    ap.add_argument("--prompt", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--long-prompt", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.ops import (
        cuda_build, flash_attention as fa)

    cfg = CONFIGS[args.config]
    card = phase_env(cuda_build, fa)
    case_stats, mixes = phase_kernel(fa, cfg, args.prompt, args.gen,
                                     args.long_prompt)
    res, prompt, launches, fab = phase_main(cfg, args, fa)
    long_prompt = phase_long_serve(cfg, args, res)
    phase_parity(cfg, res, prompt, fa)
    phase_profile(cfg, res, prompt, "prompt")
    phase_profile(cfg, res, long_prompt, "long_prompt")
    del res, long_prompt  # phase 3's model: freed before the round
    torch.cuda.empty_cache()
    phase_dissemination(cfg, args, fa, fab, prompt)
    phase_dissemination(cfg, args, fa, fab, prompt, without_xxhash=True)

    main_mix = f"prompt{args.prompt}"
    print(json.dumps({"kernels": [
        kernel_entry(fa, name, launches, case_stats, mixes, main_mix)
        for name in fa.SOURCES]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
