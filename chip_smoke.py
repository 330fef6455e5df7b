#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--config llama3-8b-d4] [--prompt 128] [--gen 32]
                          [--long-prompt 2048] [--seed 0]

Phases, one JSON line each (any failure exits non-zero; no phase is
caught):

1. env: the card, torch/CUDA versions, and the build of every kernel
   source under ``distributed_llm_dissemination_tpu_torch/csrc`` (the
   two block-attention sources and the dequant source; one ``nvcc``
   per source, all started together).
2. kernel vs plain: each block-attention kernel (split-KV decode,
   tensor-core prefill) against its plain PyTorch version and
   an f64 oracle on every case shape it accepts, then the serving shapes
   of a ``--prompt`` and of a ``--long-prompt`` serve; then the f16
   and f32 instances of the decode and prefill kernels on cases of their
   type (f32: the JAX offsets, ragged hd 32 and 64, nothing visible,
   empty blocks, decode at t = 2048 and prefill at s = 2048 at full
   width) and on the ``--prompt`` serve's shapes in that type (a mix
   each).  The f32 prefill instance forms its products as 3xTF32 on the
   tensor cores and keeps p in f32, so its pv carries no p-rounding
   allowance.  Device times of
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
7. cli: first the seeded bytes: the card's ``seeded_leaf`` against the
   CPU path on every leaf of ``tiny2`` and on the ``wk`` leaf of one
   ``--config`` layer blob, and the card's seconds per GB for a whole
   layer blob.  Then the same round as phase 6 with each node its own
   process: ``python -m distributed_llm_dissemination_tpu_torch.cli.main``
   for dest 2 (``-hbm -serve``), seeder 1 and leader 0, on ephemeral
   loopback ports, mode 3, ``-boot --config``, on the card.  Leader and
   seeder each fabricate every blob from the seed on the card.  Then
   ``cli.genreq`` (one process per request) sends phase 3's prompt
   ``REQUESTS`` times.  Checked: every process exits 0 and the leader
   prints Time to deliver and Time to first token; leader and seeder
   agree on every blob's digest; the dest verifies every digest, stages
   every blob via incremental ingest with no fallback, receives bytes
   from both sources and launched exactly the attention kernels its
   warm-up, boot and requests need (its log's ``receiver summary``); the
   served ids equal phase 3's.  A child that fails, outlives its bound or
   prints no result fails the phase; every child is killed on the way
   out.
8. codec: the int8 and int4 wire codecs and their dequant kernels (K2
   and K3, both in ``csrc/dequant.cu``).  First the
   kernel cases: every ``--config`` blob encoded on the host by the
   port's ``encode_blob`` under each codec (encode seconds per GB); on
   layer blob 0 and the head blob each kernel equals its plain version
   run on the card, bit for bit, and layer blob 0 also the port's CPU
   host decode; synthetic leaves on the kernels' traps (unaligned scale
   blocks, odd and non-128 columns, 1-D leaves, blobs at odd offsets) in
   bf16, f16 and f32 likewise, and layer blob 0 rounded to f16 and
   encoded as an f16 model's (the f16 output instances); ms per launch by
   CUDA-graph replay beside the bytes bound and the plain version's ms.  Then the entropy forms (int8e,
   int4e) of layer blob 0 and the head blob, held on the card, stage
   through the boot's device paths: the DLE1 pass on the host, the base
   form through its kernel, one launch per blob and the plain version
   never, the leaves equal to the base form's bit for bit.  Then phase 6's
   round under
   ``ModelCodec`` int8, then int4: the seeders hold the wire blobs, the
   dest stages them on the card and boots through the kernel.  Checked:
   the dest holds and received exactly the codec's wire bytes, every
   digest verified, every blob staged via incremental ingest, no
   fallback, the kernel launched once per blob plus its warm-up and the
   plain version never, the attention launches as phase 6's, the booted
   params equal to a plain decode on the card of the same wire blobs, and
   ``REQUESTS`` served ids equal to a direct ``generate`` on those.  Then
   a negotiated round: raw ``llama3-8b-d4v8k`` blobs, ``WireCodec`` int8
   on every node and ``DLD_CODEC_MIN_RATE`` above the modelled links, so
   the leader picks int8 for every pair and the senders encode on send.
   Checked as above, plus: every pair chosen int8, every blob held in its
   int8 form, the booted params equal to a raw boot of the blobs'
   ``decode_to_raw``.
9. models: every model the JAX package serves.  (a) ``hf``: the
   ``--config`` seeded blobs written as a Hugging Face Llama checkpoint
   (bf16, projections transposed to HF's [out, in], an untied
   ``lm_head``, two safetensors shards, a ``config.json``) in a temporary
   directory, after a check that its disk has room (the phase fails
   when it has not).  Then the seeder's fabrication from
   ``"Model": "hf:<dir>"`` (``create_layers``: disk read, transpose,
   encode; seconds per GB), every blob byte-identical to the seeded
   blob, and phase 6's round of the ``hf:`` model with phase 6's checks,
   served ids equal to phase 3's, K1 launched and the plain attention
   never.  ``hf_f32``: the same checkpoint with its ``config.json`` as a
   current ``transformers`` writes it (``"dtype": "bfloat16"``, no
   ``torch_dtype``; shards hard-linked beside it), which both packages
   read as float32: fabricated back through ``hf:`` (every blob equal to
   the seeded leaves widened to f32, 7.69 GB), served in phase 6's round
   through K1's f32 instances only (launch counts by instance, no plain
   call), the booted params f32, the served ids equal to a plain-attention
   greedy run on the card up to the first near-tie, then the f32 model's
   warm decode ms per token at both prompt lengths.  ``hf_f16``: after
   the bf16 checkpoint is deleted, the same
   weights rounded to float16 as an f16 checkpoint, fabricated back
   (every blob equal to the seeded leaves rounded to f16) and served in
   phase 6's round through K1's f16 instances only (launch counts by
   instance), the booted params f16, the served ids equal to a direct
   greedy run with the plain attention on the card up to the first
   near-tie (``near_tie_ids``).  (b) ``moe``: every prefill and decode shape of a ``tiny-moe``
   serve through K1 against its plain version, as phase 2's serving
   mixes; ``tiny-moe`` seeded blobs; K2 and K3 on the rank-3 expert
   leaves of a layer blob against their plain versions, bit for bit;
   then phase 6's round raw and under ``ModelCodec`` int8 (phase 8's
   checks: one dequant launch per blob plus the warm-up, the plain
   version never, booted params equal to a plain decode), served ids
   equal to a direct ``generate``.  On the booted params, K1 against the
   plain attention and the card against the CPU port, each pair under
   one routing (``shared_routing``): the prompt's logits at every
   position, and each greedy decode step's logits and id with the
   kernel run fed the plain run's ids; each pair's own routings must
   agree on 95% of (layer, token) pairs (``moe_parity``).
10. train: the training path (``models/sharded.py``) on one card.  K1
   against its plain version at every block shape of a causal ring over
   ``TRAIN_SEQ`` tokens for sp = 1, 2 and 4, offsets included (a
   multi-card ring would launch these).  Then ``--config`` at full
   width, b = 1, ``TRAIN_SEQ`` tokens, one rank, layer remat: one step's
   loss and per-leaf gradients with K1 against the same step with the
   plain attention on the card (``TRAIN_LOSS_REL``, ``TRAIN_GRAD_REL``),
   then ``TRAIN_STEPS`` AdamW steps (ms per step, tokens per second,
   peak memory; K1 launches counted from just before to just after them,
   2 x n_layers per step, the plain attention never; the last loss below
   the first) and one more step under the profiler.  Then the
   checkpoint leg on ``CKPT_CONFIG`` after a disk-room check: two steps,
   ``save_train_state``, ``restore_train_state``, and the next steps
   bit-identical to the uninterrupted run; then ``python -m
   distributed_llm_dissemination_tpu_torch.cli.train -resume`` as a
   child process on the card, whose losses equal the library's.

Then the ``{"kernels": [...]}`` line (K1's two kernels, their f16 and f32
instances, then K2 and K3 and their f16 output instances; ``launches`` is
the main path's count -- phase 3 for K1, phase 9's f16 and f32 rounds
for its f16 and f32 instances, phase 8's ``ModelCodec`` round for K2 and
K3 -- and
``launches_by_path`` shows every counted path, phase 10's ``train``
among them; the prefill entry's ``train`` holds K1 at the training
step's block),
the script's wall time, the card's name and power limit as
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
# Dense tensor-core rates per input type.  f32 inputs run as 3xTF32 (three
# TF32 products per f32 product, the f32 prefill kernel's split): 495
# TFLOP/s of TF32 over 3.  Without tensor cores f32 peaks at 67 TFLOP/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12 / 3}
F32_SIMT_FLOPS = 67e12
CSRC = "distributed_llm_dissemination_tpu_torch/csrc/"
KERNEL_REPLACES = "distributed_llm_dissemination_tpu/ops/flash_attention.py:128"
# Kernel name -> the CUDA kernels (profiler names) it launches.
DEVICE_KERNELS = {"decode": ("decode_split_kernel", "decode_merge_kernel"),
                  "prefill": ("prefill_wgmma_kernel", "prefill_tf32x3_kernel")}
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
# The cli phase's dest serves this long after its boot: time for
# REQUESTS genreq processes (each a fresh interpreter) to ask.
SERVE_WINDOW_S = 45
CHILD_TIMEOUT_S = 600  # any one node or genreq process


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
    item = 4 if dtype_name == "float32" else 2
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
                   calls=10, host=False, timed=True):
    """Phase-2 record for one shape: which kernel served it, its errors
    against the plain version and the f64 oracle (checked), and, when
    ``timed``, the three device times beside the bound."""
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
    # pv of the prefill kernel also carries its rounding of p to the input
    # type, at most p_round_bound per row (ops/flash_attention.py).
    tol = 2e-3 if t > 1024 else 1e-3
    lmax = max(1.0, float(plain[2].abs().max()))
    pv_bound = torch.full_like(plain[2], tol * lmax, dtype=torch.float64)
    if name == "prefill" and t:
        pv_bound = pv_bound + fa.p_round_bound(
            oracle[2], t, float(v.float().abs().max()), dtype)
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
        library_ms = time_graph(lib, calls) if timed else None
    dtype_name = str(dtype).split(".")[-1]
    bound_ms, bound_by, flops, nbytes = attention_bound(
        b, kvh, g, sq, t, hd, q_off, k_off, dtype_name)
    ms = plain_ms = None
    if timed:
        ms = time_graph(lambda: fa.block_attention(qg, k, v, q_off, k_off),
                        calls)
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

def phase_env(cuda_build, fa, dq):
    import torch

    card = nvidia_smi()
    sources = list(fa.SOURCES.values()) + [dq.SOURCE]
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


def serving_mix(fa, cfg, prompt, gen, seed0, dtype=None):
    """Every serving shape of one (prompt, gen) serve in ``dtype`` (None =
    bf16), timed and checked, tallied per kernel and weighted by its launch
    count."""
    import torch

    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    shapes = serving_shapes(cfg, prompt, gen)
    tallies = {name: _new_tally() for name in fa.SOURCES}
    for j, (n, sq, t, q_off) in enumerate(shapes):
        rec = attention_case(fa, 1, kvh, g, sq, t, hd, q_off, 0,
                             dtype or torch.bfloat16, seed=seed0 + j,
                             host=j in (1, len(shapes) - 1))
        if j < 3 or j == len(shapes) - 1:
            emit("kernel_case", serving_prompt=prompt, launches=n, **rec)
        _add(tallies[rec["kernel"]], rec, n)
    return {name: _per_launch(tl) for name, tl in tallies.items()}


def phase_kernel(fa, cfg, prompt, gen, long_prompt):
    import torch

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
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
    cases += [                                                  # f16 instances
        (1, kvh, g, 1, 2048, hd, 2047, 0, f16),                 # decode
        (1, 2, 4, 2, 300, 32, 250, 0, f16),                     # decode hd 32
        (1, kvh, g, 2048, 2048, hd, 0, 0, f16),                 # prefill
        (1, 2, 2, 77, 300, 64, 250, 0, f16),                    # prefill hd 64
    ]
    cases += [                                                  # f32 instances
        (1, kvh, g, 1, 2048, hd, 2047, 0, f32),                 # decode
        (1, 2, 4, 2, 300, 64, 250, 0, f32),                     # decode hd 64
        (1, 2, 8, 1, 1000, 32, 999, 0, f32),                    # decode hd 32
        (1, kvh, g, 1, 160, hd, 10, 100, f32),                  # nothing visible
        (1, kvh, g, 1, 0, hd, 0, 0, f32),                       # empty block
        (1, kvh, g, 2048, 2048, hd, 0, 0, f32),                 # prefill
        (1, 2, 2, 64, 0, 64, 0, 0, f32),                        # empty block
    ]
    by_kernel = {name: _new_tally() for name in fa.SOURCES}
    seen, full_f32 = set(), {}
    for i, case in enumerate(cases):
        rec = attention_case(fa, *case, seed=i,
                             calls=4 if case[3] * case[4] > 1 << 20 else 10)
        emit("kernel_case", **rec)
        seen.add(rec["kernel"])
        if case[-1] == bf16:  # the f16 and f32 instances have their own mixes
            _add(by_kernel[rec["kernel"]], rec, 1)
        if case[-1] == f32 and case[:3] == (1, kvh, g) and case[4] == 2048:
            full_f32[rec["kernel"]] = rec
    check(seen == set(fa.SOURCES), f"phase-2 cases reach {seen}")
    mixes = {f"prompt{p}": serving_mix(fa, cfg, p, gen, seed0)
             for p, seed0 in ((prompt, 100), (long_prompt, 200))}
    # The same serve of an f16 and of an f32 model: K1's f16 and f32
    # instances (phase 9's f16 and f32 rounds launch them).
    mixes[f"prompt{prompt}_f16"] = serving_mix(fa, cfg, prompt, gen, 300,
                                               dtype=f16)
    mixes[f"prompt{prompt}_f32"] = serving_mix(fa, cfg, prompt, gen, 400,
                                               dtype=f32)
    emit("kernel_mixes", gen=gen, timing=TIMING, mixes=mixes)
    return ({name: _per_launch(tl) for name, tl in by_kernel.items()}, mixes,
            full_f32)


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


def mode3_round(cfg, args, fa, prompt, blobs, boot_codec="raw", plane=None):
    """One mode-3 round of phase 6's topology over loopback TCP: leader 0
    and seeder 1 hold ``blobs`` (one shared host copy), cold dest 2
    ingests them fragment by fragment into the card's memory, stages,
    boots under ``boot_codec`` and answers ``REQUESTS`` greedy requests
    for ``prompt`` from requester seat 3.  ``plane``: None, or a factory
    of each node's wire-codec plane (as ``cli.main`` builds one).  The
    kernel counts are zeroed just before and read just after.  Returns
    what the callers check, with the nodes closed and their threads
    joined."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc, SourceType)
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
        assignment_to_placement)
    from distributed_llm_dissemination_tpu_torch.runtime import (
        FlowRetransmitLeaderNode, FlowRetransmitReceiverNode, Node)
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester)
    from distributed_llm_dissemination_tpu_torch.transport.tcp import (
        TcpTransport)
    from distributed_llm_dissemination_tpu_torch.utils import (
        telemetry, trace)

    ids = sorted(blobs)

    def holdings():
        # Leader and seeder share one host copy of each blob.
        return {lid: LayerSrc(inmem_data=blobs[lid], data_size=len(blobs[lid]),
                              meta=LayerMeta(location=LayerLocation.INMEM,
                                             source_type=SourceType.MEM))
                for lid in ids}

    def codecs():
        return plane() if plane is not None else None

    assignment = {2: {lid: LayerMeta() for lid in ids}}
    placement = assignment_to_placement(assignment)  # one card, one stage
    nic = {0: SEEDER_NIC, 1: SEEDER_NIC, 2: DEST_NIC}
    # The boot keeps each staged blob's tensor referenced, so the callers'
    # byte checks read what was staged.
    os.environ["DLD_BOOT_DONATE"] = "0"
    ts = {i: TcpTransport("127.0.0.1:0") for i in range(4)}
    for t in ts.values():
        t.addr_registry.update({i: u.addr for i, u in ts.items()})
    gc.collect()  # an earlier round's nodes and tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    threads_before = set(threading.enumerate())
    trace.reset_run()
    fa.reset_counts()
    dq.reset_counts()  # the round's counts start here
    t_phase = time.monotonic()
    leader = FlowRetransmitLeaderNode(Node(0, 0, ts[0]), holdings(),
                                      assignment, nic, expected_nodes={1, 2},
                                      codecs=codecs())
    seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), holdings(),
                                        codecs=codecs())
    dest = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {}, stage_hbm=True,
                                      placement=placement, boot_cfg=cfg,
                                      boot_codec=boot_codec, codecs=codecs())
    requester = GenRequester(ts[3], my_id=3)
    try:
        seeder.announce()
        dest.announce()
        t_call = time.monotonic()
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
        return {  # ...and are read here
            "attention": dict(fa.launches_by_kernel),
            "attention_by_instance": dict(fa.launches_by_instance),
            "attention_plain": fa.plain_calls,
            "dequant": dict(dq.launches_by_kernel),
            "dequant_by_instance": dict(dq.launches_by_instance),
            "plain": dict(dq.plain_calls),
            "wall_s": time.monotonic() - t_phase,
            "counters": trace.counter_totals(),
            "phases": trace.phase_totals(),
            "links": telemetry.snapshot().get("links", {}),
            "nic": nic,
            # TTD as the CLI defines it starts once start_distribution
            # returns; before that the leader plans and, for negotiated
            # pairs, encodes each blob it stamps a codec-qualified digest
            # for.
            "start_s": t0 - t_call,
            "ttd_s": t_startup - t0, "ttft_s": t_boot - t_startup,
            "ttft_total_s": t_boot - t0,
            "predicted_ttd_s": leader.predicted_ttd_ms / 1e3,
            "solve_ms": leader.solve_ms,
            "booted": booted, "served": served, "latency": latency,
            "peak": torch.cuda.max_memory_allocated(),
            "allocated_at_start": allocated_at_start,
            "warm": dest.precompile_records,
            "res": dest.boot_result,
            "held": {lid: dest.layers[lid] for lid in ids},
            "digest_ok": set(dest._digest_ok),
            "choices": dict(leader._codec_choice),
            # The forms each sender encoded (its plane's size cache).
            "encoded": {"leader": sorted(leader.codecs._sizes)
                        if leader.codecs else [],
                        "seeder": sorted(seeder.codec_plane._sizes)
                        if seeder.codec_plane else []},
        }
    finally:
        requester.close()
        leader.close()
        seeder.close()
        dest.close()
        for t in ts.values():
            t.close()
        _join_round_threads(threads_before)
        os.environ.pop("DLD_BOOT_DONATE", None)


def _sent_by_source(links):
    return {src: links.get(f"{src}->2", {}).get("tx_bytes", 0)
            for src in (0, 1)}


def phase_dissemination(cfg, args, fa, fab, prompt, without_xxhash=False):
    """One mode-3 round (module docstring, phase 6).  ``without_xxhash``:
    every node of the round runs as on a host without the ``xxhash``
    extension (crc32 frame checksums, blake2b-128 layer digests).
    Returns the round's TTD."""
    import torch

    from distributed_llm_dissemination_tpu_torch.native import (
        load_flow_solver)
    from distributed_llm_dissemination_tpu_torch.utils import integrity

    blobs = fab["blobs"]
    ids = sorted(blobs)
    total = sum(len(b) for b in blobs.values())
    solver = "native (C++)" if load_flow_solver() is not None else "python"
    host_xxhash = integrity._xxhash
    if without_xxhash:
        integrity._xxhash = None
    try:
        out = mode3_round(cfg, args, fa, prompt, blobs)
        frame_checksum = integrity.fragment_checksum(b"")[0]
        digest_algo = integrity.digest_algo()
    finally:
        integrity._xxhash = host_xxhash
    counters, phases, res = out["counters"], out["phases"], out["res"]
    sent = _check_raw_round(cfg, out, blobs, fab["tokens"])
    check(sum(sent.values()) >= total, f"sent {sent} < {total} bytes")
    via_ingest = counters["hbm_staged.incremental_ingest"]
    fallbacks = {k: v for k, v in counters.items()
                 if k.startswith("fallback.")}
    warm = out["warm"]
    launches = out["attention"]
    want = _expected_round_launches(fa, cfg, args, warm[0][0]["launches"])
    check(launches == want, f"round launches {launches} != {want}")

    ttd = out["ttd_s"]
    direct = fab["serve_ms"]
    emit("dissemination", config=cfg.name, mode=3, transport="tcp loopback",
         xxhash=not without_xxhash,
         blobs=len(ids), bytes=total, nic_bytes_per_s=out["nic"],
         solver=solver, ttd_s=ttd,
         predicted_ttd_s=out["predicted_ttd_s"],
         solve_ms=out["solve_ms"], wire_gbps=total / ttd / 1e9,
         sent_bytes_by_source=sent,
         frame_checksum=frame_checksum, digest_algo=digest_algo,
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
         ttft_s=out["ttft_s"], ttft_total_s=out["ttft_total_s"],
         boot_s=out["booted"][2],
         request_latency_s=out["latency"],
         # A request's decode ms/token, taking its prefill to cost what
         # phase 3's direct warm prefill cost.
         request_decode_ms_per_token=[
             (lat * 1e3 - direct["prefill"]) / (args.gen - 1)
             for lat in out["latency"]],
         direct_generate_ms=direct,
         served_ids_equal_phase3=True,
         attention_launches_by_kernel=launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         allocated_at_start=out["allocated_at_start"],
         phase_wall_s=out["wall_s"],
         phases_ms={k: v["ms"] for k, v in phases.items()})
    return ttd


def seeded_check(cfg, seed):
    """The card's seeded draws against the CPU path: every leaf of
    ``tiny2`` and the ``wk`` leaf of one ``cfg`` layer blob, bit for bit;
    then the card's seconds per GB fabricating a whole layer blob into
    host bytes, and its draws alone."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS

    def same(a, b):
        return torch.equal(a.cpu().view(torch.int16), b.view(torch.int16))

    small = CONFIGS["tiny2"]
    leaves = 0
    for blob_id in range(serde.head_blob_id(small) + 1):
        for name, _ in serde.blob_specs(small, blob_id):
            check(same(serde.seeded_leaf(small, blob_id, name, seed, "cuda"),
                       serde.seeded_leaf(small, blob_id, name, seed, "cpu")),
                  f"tiny2 blob {blob_id} leaf {name}: card != CPU")
            leaves += 1
    wk = serde.seeded_leaf(cfg, 0, "wk", seed, "cuda")
    check(same(wk, serde.seeded_leaf(cfg, 0, "wk", seed, "cpu")),
          f"{cfg.name} blob 0 leaf wk: card != CPU")
    nbytes = serde.blob_nbytes(cfg, 0)
    serde.seeded_leaves(cfg, 0, seed, "cuda")  # warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    serde.seeded_leaves(cfg, 0, seed, "cuda")
    torch.cuda.synchronize()
    draw_s = time.monotonic() - t0
    t0 = time.monotonic()
    blob = serde.seeded_blob(cfg, 0, seed, "cuda")
    blob_s = time.monotonic() - t0
    check(len(blob) == nbytes, "layer blob size")
    return {"tiny2_leaves_equal": leaves, "wk_elements": wk.numel(),
            "wk_equal": True, "layer_blob_bytes": nbytes,
            "draw_s_per_gb": draw_s / (nbytes / 1e9),
            "blob_s_per_gb": blob_s / (nbytes / 1e9)}


def _free_ports(n):
    """``n`` free loopback ports, every probe socket held until all are
    collected (closing one at a time lets another process take it)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s_ in socks:
            s_.bind(("127.0.0.1", 0))
        return [s_.getsockname()[1] for s_ in socks]
    finally:
        for s_ in socks:
            s_.close()


def _log_records(path):
    out = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _one(records, message, who):
    hits = [r for r in records if r.get("message") == message]
    check(len(hits) == 1, f"{who}: {len(hits)} {message!r} records")
    return hits[0]


def phase_cli(cfg, args, fa, fab, prompt):
    """One node per process (module docstring, phase 7)."""
    import os
    import re

    from distributed_llm_dissemination_tpu_torch.models import serde

    t_phase = time.monotonic()
    seeded = seeded_check(cfg, args.seed)
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_cli")
    os.makedirs(work, exist_ok=True)
    ids = list(range(serde.head_blob_id(cfg) + 1))
    total = sum(serde.blob_nbytes(cfg, i) for i in ids)
    held = {"2": {str(i): {"LayerSize": serde.blob_nbytes(cfg, i)}
                  for i in ids}}
    ports = _free_ports(4)
    conf = {"Model": cfg.name, "ModelSeed": args.seed,
            "LayerSize": serde.blob_nbytes(cfg, 0),
            "Nodes": [
                {"Id": 0, "Addr": f"127.0.0.1:{ports[0]}", "IsLeader": True,
                 "NetworkBW": SEEDER_NIC, "Sources": {"2": 0},
                 "InitialLayers": held},
                {"Id": 1, "Addr": f"127.0.0.1:{ports[1]}",
                 "NetworkBW": SEEDER_NIC, "Sources": {"2": 0},
                 "InitialLayers": held},
                {"Id": 2, "Addr": f"127.0.0.1:{ports[2]}",
                 "NetworkBW": DEST_NIC, "Sources": {"2": 0}},
                # The requester seat: an address only.
                {"Id": 3, "Addr": f"127.0.0.1:{ports[3]}",
                 "NetworkBW": DEST_NIC, "Sources": {"2": 0}},
            ],
            "Assignment": {"2": {str(i): {} for i in ids}}}
    conf_path = os.path.join(work, "topology.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    env = dict(os.environ, PYTHONPATH=root)
    node = [sys.executable, "-m",
            "distributed_llm_dissemination_tpu_torch.cli.main",
            "-f", conf_path, "-m", "3", "-boot", cfg.name]
    procs, files = {}, []

    def start(name, argv):
        out = open(os.path.join(work, f"{name}.out"), "w")
        err = open(os.path.join(work, f"{name}.err"), "w")
        files.extend((out, err))
        procs[name] = subprocess.Popen(argv, stdout=out, stderr=err, env=env,
                                       cwd=root)

    def finish(name, timeout):
        try:
            rc = procs[name].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"chip_smoke check failed: {name} still "
                               f"running after {timeout} s") from None
        with open(os.path.join(work, f"{name}.err")) as f:
            tail = f.read()[-3000:]
        check(rc == 0, f"{name} exited {rc}:\n{tail}")
        with open(os.path.join(work, f"{name}.out")) as f:
            return f.read()

    try:
        start("dest", node + ["-id", "2", "-hbm",
                              "-serve", str(SERVE_WINDOW_S)])
        start("seeder", node + ["-id", "1"])
        start("leader", node + ["-id", "0"])
        out = finish("leader", CHILD_TIMEOUT_S)
        printed = {}
        for key, pat in (("ttd", r"Time to deliver: ([0-9.]+)s"),
                         ("predicted", r"Predicted time to deliver: "
                                       r"([0-9.]+)s"),
                         ("ttft", r"Time to first token: ([0-9.]+)s")):
            m = re.search(pat, out)
            check(m is not None, f"the leader printed no {key}: {out!r}")
            printed[key] = float(m.group(1))
        served, genreq_s = [], []
        for i in range(REQUESTS):
            t0 = time.monotonic()
            start(f"genreq{i}", [
                sys.executable, "-m",
                "distributed_llm_dissemination_tpu_torch.cli.genreq",
                "-f", conf_path, "-id", "3", "-node", "2",
                "-prompt", ",".join(map(str, prompt[0].tolist())),
                "-n", str(args.gen)])
            lines = finish(f"genreq{i}", CHILD_TIMEOUT_S).strip().splitlines()
            genreq_s.append(time.monotonic() - t0)
            check(bool(lines), f"genreq{i} printed no result")
            served.append(json.loads(lines[-1]).get("tokens"))
        finish("seeder", CHILD_TIMEOUT_S)
        finish("dest", SERVE_WINDOW_S + CHILD_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    wall = time.monotonic() - t_phase

    logs = {name: _log_records(os.path.join(work, f"{name}.err"))
            for name in ("leader", "seeder", "dest")}
    conflicts = [r for r in logs["leader"] if "conflict" in
                 r.get("message", "")]
    check(not conflicts, f"leader and seeder blobs differ: {conflicts[:2]}")
    dest = logs["dest"]
    verified = {r["layerID"] for r in dest
                if r.get("message") == "layer digest verified"}
    check(verified == set(ids), f"digests verified for {sorted(verified)}")
    summary = _one(dest, "receiver summary", "dest")
    counters = summary["counters"]
    via_ingest = counters.get("hbm_staged.incremental_ingest", 0)
    check(via_ingest == len(ids),
          f"{via_ingest} of {len(ids)} staged via incremental ingest")
    fallbacks = {k: v for k, v in counters.items() if k.startswith("fallback.")}
    check(not any(fallbacks.values()), f"fallbacks fired: {fallbacks}")
    sent = {src: summary["links"].get(f"{src}->2", {}).get(
        "delivered_bytes", 0) for src in (0, 1)}
    check(all(sent.values()), f"a source sent nothing: {sent}")
    check(sum(sent.values()) == total, f"delivered {sent} != {total} bytes")
    for ids_got in served:
        check(ids_got == fab["tokens"],
              f"served ids {ids_got} != phase 3's {fab['tokens']}")
    warm = _one(dest, "boot programs precompiled during dissemination",
                "dest")
    launches = summary["attention_launches_by_kernel"]
    want = _expected_round_launches(fa, cfg, args, warm["launches"])
    check(launches == want, f"dest launches {launches} != {want}")
    check(launches["prefill"] > 0 and launches["decode"] > 0,
          f"dest launches {launches}")
    requests = [r for r in dest
                if r.get("message") == "served generation request"]
    check(len(requests) == REQUESTS, f"{len(requests)} served requests")
    ttft_rec = _one(logs["leader"], "Time to first token", "leader")
    direct = fab["serve_ms"]
    emit("cli", config=cfg.name, mode=3, transport="tcp loopback",
         processes=["leader", "seeder", "dest"] + [
             f"genreq{i}" for i in range(REQUESTS)],
         seeded=seeded, blobs=len(ids), bytes=total,
         ttd_s=printed["ttd"], predicted_ttd_s=printed["predicted"],
         ttft_total_s=printed["ttft"],
         ttft_after_startup_s=printed["ttft"] - printed["ttd"],
         boot_s=ttft_rec["nodes"]["2"],
         sent_bytes_by_source=sent,
         digests_verified=len(verified),
         staged_via_incremental_ingest=via_ingest, fallbacks=fallbacks,
         precompile={k: v for k, v in warm.items()
                     if k not in ("level", "time", "node", "message")},
         request_latency_s=[r["decode_ms"] / 1e3 for r in requests],
         genreq_process_s=genreq_s,
         # A request's decode ms/token, taking its prefill to cost what
         # phase 3's direct warm prefill cost.
         request_decode_ms_per_token=[
             (r["decode_ms"] - direct["prefill"]) / (args.gen - 1)
             for r in requests],
         direct_generate_ms=direct,
         served_ids_equal_phase3=True,
         attention_launches_by_kernel=launches,
         peak_device_bytes={
             name: _one(recs, "device memory", name)["peak_allocated_bytes"]
             for name, recs in logs.items()},
         phase_wall_s=wall)


# ------------------------------------------------------------ phase 8

CODEC_REPLACES = {
    "int8": "distributed_llm_dissemination_tpu/models/quant.py:276",
    "int4": "distributed_llm_dissemination_tpu/models/quant.py:305"}
NEGOTIATED_CONFIG = "llama3-8b-d4v8k"  # llama3-8b-d4's layers, 8192-token head
# Above every modelled link of the round (SEEDER_NIC, DEST_NIC), so the
# leader picks the wire codec on loopback; pacing the wire down to the
# plane's default threshold (64 MiB/s) would cost about 30 s.
NEGOTIATE_MIN_RATE = 1 << 42
# Synthetic leaves on the kernels' traps: scale blocks at offsets that are
# not multiples of 4, odd cols (int4 rides them raw), cols that 128 does
# not divide, 1-D and 3-D leaves, a 2-column leaf.
TRAP_SPECS = (("a", (3, 5)), ("b", (7,)), ("c", (2, 3, 6)), ("d", (5, 130)),
              ("e", (4, 256)), ("f", (3, 7)), ("g", (1, 2)), ("h", (2, 34)))


def _bits(t):
    import torch

    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _to_card(data, shift=0):
    """A wire blob on the card, starting ``shift`` bytes into its buffer."""
    import torch

    buf = torch.empty(len(data) + shift, dtype=torch.uint8, device="cuda")
    buf[shift:].copy_(torch.frombuffer(data, dtype=torch.uint8))
    return buf[shift:]


def codec_kernel_case(dq, quant, kind, name, data, specs, dtype, shift=0,
                      timed=False):
    """K2/K3 (``kind``) against its plain version on the card on one wire
    blob, bit for bit.  ``timed``: also the kernel's and the plain
    version's device ms per call (CUDA-graph replay) and the bytes bound.
    Returns (record, the kernel's leaves)."""
    import torch

    table = quant.leaf_table(kind, specs, dtype)
    blob = _to_card(data, shift)
    kern = [torch.empty(leaf.shape, dtype=dtype, device="cuda")
            for leaf in table]
    plain = [torch.empty_like(k) for k in kern]
    ref = getattr(dq, f"dequant_{kind}_ref")
    dq.dequant(kind, blob, table, kern)
    ref(blob, table, plain)
    torch.cuda.synchronize()
    err = 0.0
    for leaf, a, b in zip(table, kern, plain):
        check(torch.equal(_bits(a), _bits(b)),
              f"{kind} kernel != plain on {name}:{leaf.name}")
        err = max(err, float((a.float() - b.float()).abs().max()))
    decoded = sum(k.numel() * k.element_size() for k in kern)
    rec = {"case": name, "kind": kind, "dtype": str(dtype).split(".")[-1],
           "leaves": len(table), "wire_bytes": len(data),
           "decoded_bytes": decoded, "blob_offset": shift,
           "bit_exact": True, "max_abs_err": err}
    if timed:
        rec["ms"] = time_graph(lambda: dq.dequant(kind, blob, table, kern))
        rec["plain_ms"] = time_graph(lambda: ref(blob, table, plain),
                                     calls=2, replays=2)
        rec["bound_ms"] = (len(data) + decoded) / HBM_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        rec["library_ms"] = None  # no single PyTorch call decodes a blob
    del blob, plain
    return rec, kern


def codec_kernels(cfg, quant, serde, dq, blobs):
    """Phase 8's kernel cases (module docstring).  Returns (wire blobs by
    codec, encode seconds by codec and blob, the cases)."""
    import dataclasses

    import numpy as np
    import torch

    head = serde.head_blob_id(cfg)
    wire, enc_s, cases = {}, {}, []
    # Layer blob 0 as an f16 model's: its leaves rounded to f16.
    cfg16 = dataclasses.replace(cfg, dtype=torch.float16)
    leaves = serde._split_blob(cfg, blobs[0], serde.blob_specs(cfg, 0))
    raw16 = b"".join(leaves[name].to(torch.float16).numpy().tobytes()
                     for name, _ in serde.blob_specs(cfg, 0))
    del leaves
    for kind in dq.KINDS:
        wire[kind], enc_s[kind] = {}, {}
        for lid in sorted(blobs):
            t0 = time.monotonic()
            wire[kind][lid] = bytearray(
                quant.encode_blob(cfg, lid, blobs[lid], kind))
            enc_s[kind][lid] = time.monotonic() - t0
            check(len(wire[kind][lid]) == quant.blob_nbytes_codec(
                cfg, lid, kind), f"{kind} blob {lid} size")
        for lid, name in ((0, "layer"), (head, "head")):
            rec, kern = codec_kernel_case(dq, quant, kind, name,
                                          wire[kind][lid],
                                          serde.blob_specs(cfg, lid),
                                          cfg.dtype, timed=True)
            if lid == 0:  # the card against the port's CPU host decode
                host = quant.decode_blob_host(cfg, lid, wire[kind][lid], kind)
                for (leaf_name, _), k in zip(serde.blob_specs(cfg, lid), kern):
                    check(torch.equal(_bits(k.cpu()), _bits(host[leaf_name])),
                          f"{kind} layer leaf {leaf_name} != host decode")
                rec["equals_cpu_host_decode"] = True
                del host
            del kern
            cases.append(rec)
        # The f16 output instances on the same layer, encoded as f16.
        data16 = bytearray(quant.encode_blob(cfg16, 0, raw16, kind))
        rec, kern = codec_kernel_case(dq, quant, kind, "layer_f16", data16,
                                      serde.blob_specs(cfg16, 0),
                                      torch.float16, timed=True)
        del kern, data16
        cases.append(rec)
        rng = np.random.default_rng(3)
        n = sum(int(np.prod(shape)) for _, shape in TRAP_SPECS)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            raw = x.to(dtype).view(torch.uint8).numpy().tobytes()
            data = bytearray(quant.encode_specs(TRAP_SPECS, dtype, raw, kind))
            for shift in (0, 1, 2, 4, 8):
                cases.append(codec_kernel_case(
                    dq, quant, kind, "traps", data, TRAP_SPECS, dtype,
                    shift=shift)[0])
    torch.cuda.empty_cache()
    return wire, enc_s, cases


def entropy_staging(cfg, quant, serde, dq, wire):
    """The entropy forms of layer blob 0 and the head blob, held on the
    card, staged by the boot's device paths (``stage_blob_leaves``,
    ``decode_head``): the DLE1 pass runs on the host, the base form on
    its kernel.  Checked per blob: one launch of the base form's kernel,
    none of the other and of the plain versions, and leaves equal bit for
    bit to the kernel's decode of the base form (which the kernel cases
    held against the plain version).  Returns a record per blob."""
    import torch

    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc)
    from distributed_llm_dissemination_tpu_torch.models import entropy
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        decode_head, stage_blob_leaves)

    head = serde.head_blob_id(cfg)
    recs = []
    for kind in dq.KINDS:
        ekind = kind + "e"
        for lid, name in ((0, "layer"), (head, "head")):
            t0 = time.monotonic()
            enc = bytearray(entropy.encode(wire[kind][lid]))
            encode_s = time.monotonic() - t0
            src = LayerSrc(data_size=len(enc),
                           meta=LayerMeta(location=LayerLocation.HBM,
                                          codec=ekind))
            src.device_array = _to_card(enc)
            torch.cuda.synchronize()
            dq.reset_counts()
            t0 = time.monotonic()
            if lid == head:
                got = decode_head(cfg, src, ekind, device="cuda")
            else:
                got = {n: a[0] for n, a in stage_blob_leaves(
                    cfg, lid, src, codec=ekind, device="cuda").items()}
            torch.cuda.synchronize()
            stage_s = time.monotonic() - t0
            launches, plain = dict(dq.launches_by_kernel), dict(dq.plain_calls)
            check(launches == {k: int(k == kind) for k in dq.KINDS},
                  f"{ekind} {name}: kernel launches {launches}")
            check(not any(plain.values()),
                  f"{ekind} {name}: plain dequant ran: {plain}")
            want = quant.decode_specs(_to_card(wire[kind][lid]),
                                      serde.blob_specs(cfg, lid), cfg.dtype,
                                      kind)
            for leaf, a in want.items():
                check(got[leaf].is_cuda and torch.equal(_bits(got[leaf]),
                                                        _bits(a)),
                      f"{ekind} {name}:{leaf} != the {kind} kernel's decode")
            recs.append({"codec": ekind, "blob": name,
                         "wire_bytes": len(enc),
                         "base_bytes": len(wire[kind][lid]),
                         "dle1_encode_s": encode_s, "stage_s": stage_s,
                         "launches": launches, "plain_calls": plain,
                         "equals_base_kernel_decode": True})
            del enc, src, got, want
    torch.cuda.empty_cache()
    return recs


def _check_codec_round(fa, cfg, args, out, ids, wire_sizes, kind, warm_key,
                       full_width=True):
    """The checks both kinds of codec round share (module docstring).
    ``full_width``: also the warm-up ended before startup (the round of a
    model of a few MB may end first)."""
    counters = out["counters"]
    for lid in ids:
        src = out["held"][lid]
        check(src.meta.location.name == "HBM", f"blob {lid} not on the card")
        check(src.data_size == wire_sizes[lid],
              f"blob {lid}: {src.data_size} B, wire form {wire_sizes[lid]}")
    check(out["digest_ok"] >= set(ids), f"digests verified {out['digest_ok']}")
    via_ingest = counters.get("hbm_staged.incremental_ingest", 0)
    check(via_ingest == len(ids),
          f"{via_ingest} of {len(ids)} staged via incremental ingest")
    fallbacks = {k: v for k, v in counters.items() if k.startswith("fallback.")}
    check(not any(fallbacks.values()), f"fallbacks fired: {fallbacks}")
    delivered = sum(row.get("delivered_bytes", 0)
                    for key, row in out["links"].items()
                    if "#" not in key and key.endswith("->2"))
    check(delivered == sum(wire_sizes.values()),
          f"delivered {delivered} B != wire forms {sum(wire_sizes.values())}")
    warm = out["warm"]
    check(len(warm) >= 1 and (all(in_wire for _, in_wire in warm)
                              or not full_width),
          f"warm-up did not finish before startup: {warm}")
    res = out["res"]
    check(out["booted"].keys() == {2} and res is not None
          and res.kind == "full", f"boot {out['booted']}")
    check(res.via == "streamed per-layer", f"via {res.via!r}")
    want = len(ids) + warm[0][0]["launches"].get(warm_key, 0)
    check(out["dequant"][kind] == want,
          f"{kind} launches {out['dequant'][kind]} != {want}")
    check(not any(out["plain"].values()),
          f"plain dequant ran in the round: {out['plain']}")
    att = _expected_round_launches(fa, cfg, args, warm[0][0]["launches"])
    check(out["attention"] == att,
          f"round attention launches {out['attention']} != {att}")
    return delivered


def _plain_params(cfg, serde, dq, quant, kind, wire):
    """Params decoded on the card by the plain dequant from the wire
    blobs: the reference the served ids are held against."""
    import torch

    L = serde.head_blob_id(cfg)
    layers = {name: torch.empty((L, *shape), dtype=cfg.dtype, device="cuda")
              for name, shape in serde.layer_param_specs(cfg)}
    ref = getattr(dq, f"dequant_{kind}_ref")
    for lid in range(L):
        table = quant.leaf_table(kind, serde.layer_param_specs(cfg), cfg.dtype)
        ref(_to_card(wire[lid]), table, [layers[t.name][lid] for t in table])
    table = quant.leaf_table(kind, serde.head_param_specs(cfg), cfg.dtype)
    head = {t.name: torch.empty(t.shape, dtype=cfg.dtype, device="cuda")
            for t in table}
    ref(_to_card(wire[L]), table, [head[t.name] for t in table])
    return {"embed": head["embed"], "layers": layers, "ln_f": head["ln_f"],
            "lm_head": head["lm_head"]}


def _same_params(a, b):
    """Booted params ``a`` bit for bit against the reference ``b``."""
    import torch

    pairs = [(name, a[name], b[name]) for name in ("embed", "ln_f", "lm_head")]
    pairs += [(name, t, b["layers"][name]) for name, t in a["layers"].items()]
    for name, x, y in pairs:
        check(torch.equal(_bits(x), _bits(y)), f"booted {name} differs")


def phase_codec(cfg, args, fa, fab, prompt, raw_ttd_s):
    """Phase 8 (module docstring).  Returns the kernels-line numbers of
    K2 and K3."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.models import quant, serde
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.runtime.codec import (
        WireCodecPlane)

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    ids = sorted(blobs)
    raw_bytes = sum(len(b) for b in blobs.values())
    wire, enc_s, cases = codec_kernels(cfg, quant, serde, dq, blobs)
    entropy_recs = entropy_staging(cfg, quant, serde, dq, wire)
    head = serde.head_blob_id(cfg)
    emit("codec_kernels", config=cfg.name, timing=TIMING,
         encode_s_per_gb={kind: sum(s.values()) / (raw_bytes / 1e9)
                          for kind, s in enc_s.items()},
         encode_s={kind: {"layer0": s[0], "head": s[head],
                          "all_blobs": sum(s.values())}
                   for kind, s in enc_s.items()},
         wire_bytes={kind: sum(len(b) for b in w.values())
                     for kind, w in wire.items()},
         raw_bytes=raw_bytes, cases=cases, entropy_staging=entropy_recs)
    stats = {kind: {c["case"]: c for c in cases
                    if c["kind"] == kind and "ms" in c} for kind in dq.KINDS}

    rounds = {}
    for kind in dq.KINDS:
        out = mode3_round(cfg, args, fa, prompt, wire[kind], boot_codec=kind,
                          plane=functools.partial(WireCodecPlane, cfg,
                                                  model_codec=kind))
        sizes = {lid: quant.blob_nbytes_codec(cfg, lid, kind) for lid in ids}
        delivered = _check_codec_round(fa, cfg, args, out, ids, sizes, kind,
                                       f"dequant_{kind}")
        ref = _plain_params(cfg, serde, dq, quant, kind, wire[kind])
        _same_params(out["res"].params, ref)
        want = generate(ref, prompt, cfg, args.gen)[0].tolist()
        for ids_got in out["served"]:
            check(ids_got == want, f"{kind} served ids {ids_got} != {want}")
        rounds[kind] = {
            "launches": out["dequant"][kind],
            "f16_launches": out["dequant_by_instance"][f"{kind}:float16"],
            "record": dict(
                codec=kind, ttd_s=out["ttd_s"], start_s=out["start_s"],
                ttft_after_startup_s=out["ttft_s"],
                wire_bytes=delivered, raw_bytes=raw_bytes,
                sent_bytes_by_source=_sent_by_source(out["links"]),
                seeder_encode_s=sum(enc_s[kind].values()),
                boot_decode_ms=out["phases"].get(
                    "boot_stream_stage", {}).get("ms"),
                boot_s=out["booted"][2], boot_via=out["res"].via,
                request_latency_s=out["latency"],
                dequant_launches=out["dequant"], plain_calls=out["plain"],
                warm_up=[rec for rec, _ in out["warm"]],
                attention_launches_by_kernel=out["attention"],
                max_memory_allocated=out["peak"],
                booted_params_equal_plain_decode=True,
                served_ids_equal_plain_reference=True, served_ids=want)}
        del out, ref
        gc.collect()
        torch.cuda.empty_cache()

    # The negotiated round: raw canonicals, WireCodec int8, the threshold
    # above the modelled links so the leader picks int8 on every pair.
    ncfg = CONFIGS[NEGOTIATED_CONFIG]
    t0 = time.monotonic()
    nblobs = {i: bytearray(serde.seeded_blob(ncfg, i, seed=args.seed))
              for i in range(serde.head_blob_id(ncfg) + 1)}
    fabricate_s = time.monotonic() - t0
    nids = sorted(nblobs)
    nprompt = prompt % ncfg.vocab  # the 8192-token vocabulary
    os.environ["DLD_CODEC_MIN_RATE"] = str(NEGOTIATE_MIN_RATE)
    try:
        out = mode3_round(ncfg, args, fa, nprompt, nblobs,
                          plane=functools.partial(WireCodecPlane, ncfg,
                                                  wire_codec="int8"))
    finally:
        os.environ.pop("DLD_CODEC_MIN_RATE", None)
    check(all(out["choices"].get((2, lid)) == "int8" for lid in nids),
          f"leader's codec choices {out['choices']}")
    sizes = {lid: quant.blob_nbytes_codec(ncfg, lid, "int8") for lid in nids}
    delivered = _check_codec_round(fa, ncfg, args, out, nids, sizes, "int8",
                                   "dequant_int8")
    for lid in nids:
        check(out["held"][lid].meta.codec == "int8",
              f"blob {lid} held as {out['held'][lid].meta.codec!r}")
    # The reference: each delivered wire blob back to canonical raw bytes on
    # the host (decode_to_raw), then a raw boot of those bytes.
    raw_ref = {lid: quant.decode_to_raw(
        ncfg, lid, out["held"][lid].device_array.cpu().numpy(), "int8")
        for lid in nids}
    ref = serde.params_from_blobs(ncfg, raw_ref)
    ref = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v.cuda()) for k, v in ref.items()}
    _same_params(out["res"].params, ref)
    want = generate(ref, nprompt, ncfg, args.gen)[0].tolist()
    for ids_got in out["served"]:
        check(ids_got == want, f"negotiated served ids {ids_got} != {want}")
    encoded = out["counters"].get("codec.encoded_blobs", 0)
    forms = sum(len(v) for v in out["encoded"].values())
    negotiated = dict(
        config=ncfg.name, wire_codec="int8",
        codec_min_rate=NEGOTIATE_MIN_RATE, nic_bytes_per_s=[SEEDER_NIC,
                                                            DEST_NIC],
        pairs_chosen=out["counters"].get("codec.pairs_chosen", 0),
        ttd_s=out["ttd_s"], start_s=out["start_s"],
        ttd_from_start_call_s=out["start_s"] + out["ttd_s"],
        raw_round_ttd_s=raw_ttd_s,
        ttft_after_startup_s=out["ttft_s"],
        fabricate_s=fabricate_s,
        raw_bytes=sum(len(b) for b in nblobs.values()),
        wire_bytes=delivered,
        sent_bytes_by_source=_sent_by_source(out["links"]),
        encode_s=out["phases"].get("codec_encode", {}).get("ms", 0.0) / 1e3,
        encoded_blobs=encoded, encoded_forms=forms,
        re_encodes=encoded - forms,
        boot_decode_ms=out["phases"].get("boot_stream_stage", {}).get("ms"),
        dequant_launches=out["dequant"], plain_calls=out["plain"],
        request_latency_s=out["latency"],
        max_memory_allocated=out["peak"],
        booted_params_equal_decode_to_raw_boot=True,
        served_ids_equal_reference=True)
    del out, ref, raw_ref, nblobs
    gc.collect()
    torch.cuda.empty_cache()
    emit("codec", rounds={k: r["record"] for k, r in rounds.items()},
         negotiated=negotiated, phase_wall_s=time.monotonic() - t_phase)
    return {kind: {"launches": rounds[kind]["launches"],
                   "f16_launches": rounds[kind]["f16_launches"],
                   "layer": stats[kind]["layer"], "head": stats[kind]["head"],
                   "layer_f16": stats[kind]["layer_f16"]}
            for kind in dq.KINDS}


# ------------------------------------------------------------ phase 9

HF_SHARDS = 2  # safetensors files of the phase-9 checkpoint
HF_DISK_SLACK = 1 << 30  # free bytes the checkpoint must leave on its disk
MOE_CONFIG = "tiny-moe"  # the JAX package's one MoE configuration
LOGIT_ATOL, LOGIT_MEAN_ATOL = 0.1, 0.02  # tests/test_torch_model.py
ROUTED_ALIKE = 0.95  # tests/test_torch_moe.py
# A layer leaf's name in a Hugging Face Llama checkpoint (the 2-D ones are
# stored transposed, [out, in]).
HF_LAYER_NAMES = {
    "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
    "ln1": "input_layernorm.weight",
    "ln2": "post_attention_layernorm.weight",
    "w1": "mlp.gate_proj.weight", "w3": "mlp.up_proj.weight",
    "w2": "mlp.down_proj.weight"}


def _safetensors_header(entries, dtype="BF16"):
    """A safetensors header for ``entries`` [(name, shape, nbytes)] of
    ``dtype`` tensors laid out in order: the 8-byte length, then the JSON
    padded with spaces to a multiple of 8."""
    header, off = {}, 0
    for name, shape, nbytes in entries:
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    return len(text).to_bytes(8, "little") + text


def write_hf_checkpoint(cfg, serde, blobs, path, f16=False):
    """``cfg``'s blobs as a Hugging Face Llama checkpoint in ``path``:
    bf16 (``f16``: every leaf rounded to float16, ``torch_dtype``
    float16), projections transposed to HF's [out, in], an untied
    ``lm_head``, the layers split over ``HF_SHARDS`` safetensors files, and
    a ``config.json`` with the configuration's constants.  The writer
    needs no ``safetensors`` package (the card's machine has none)."""
    import os

    import torch

    dtype = torch.float16 if f16 else torch.bfloat16

    tensors = []  # (shard, HF name, blob id, leaf name, transpose)
    head = serde.head_blob_id(cfg)
    per_shard = -(-cfg.n_layers // HF_SHARDS)
    for lid in range(cfg.n_layers):
        for ours, shape in serde.layer_param_specs(cfg):
            tensors.append((lid // per_shard,
                            f"model.layers.{lid}.{HF_LAYER_NAMES[ours]}",
                            lid, ours, len(shape) == 2))
    tensors += [(0, "model.embed_tokens.weight", head, "embed", False),
                (HF_SHARDS - 1, "model.norm.weight", head, "ln_f", False),
                (HF_SHARDS - 1, "lm_head.weight", head, "lm_head", True)]
    leaves = {}

    def leaf(lid, name, tr):
        if lid not in leaves:
            leaves.clear()  # one blob's views at a time
            leaves[lid] = serde.decode_device(
                serde._host_u8(blobs[lid]), serde.blob_specs(cfg, lid),
                torch.bfloat16)
        t = leaves[lid][name].to(dtype)
        return t.T.contiguous() if tr else t

    written = 0
    for shard in range(HF_SHARDS):
        mine = [t for t in tensors if t[0] == shard]
        shapes = {}
        for _, key, lid, name, tr in mine:
            shape = dict(serde.blob_specs(cfg, lid))[name]
            shapes[key] = tuple(reversed(shape)) if tr else shape
        entries = [(key, shapes[key], 2 * math.prod(shapes[key]))
                   for _, key, *_ in mine]
        fname = os.path.join(path, f"model-{shard + 1:05d}-of-"
                                   f"{HF_SHARDS:05d}.safetensors")
        with open(fname, "wb") as f:
            f.write(_safetensors_header(entries, "F16" if f16 else "BF16"))
            for _, key, lid, name, tr in mine:
                t = leaf(lid, name, tr)
                check(tuple(t.shape) == shapes[key], f"{key} shape")
                f.write(t.view(torch.uint8).numpy().data)
        written += os.path.getsize(fname)
    conf = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
            "num_hidden_layers": cfg.n_layers, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps,
            "torch_dtype": "float16" if f16 else "bfloat16",
            "tie_word_embeddings": False}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(conf, f)
    return written


def _check_raw_round(cfg, out, blobs, fab_tokens, full_width=True):
    """Phase 6's checks of a raw round (bytes on the card, ingest, no
    fallback, a warm-up, full boot, served ids equal ``fab_tokens``; None:
    every request served the same ids, which the caller checks).
    ``full_width``: also both seeders sent bytes and the warm-up ended
    before startup; a model of a few MB fits in one fragment per blob
    and its round may end first."""
    import torch

    ids = sorted(blobs)
    for lid in ids:
        arr = out["held"][lid].device_array
        check(out["held"][lid].meta.location.name == "HBM"
              and isinstance(arr, torch.Tensor) and arr.is_cuda,
              f"blob {lid} not on the card")
        host = torch.frombuffer(blobs[lid], dtype=torch.uint8).to("cuda")
        check(torch.equal(arr, host), f"blob {lid} not byte-exact")
        del host
    check(out["digest_ok"] >= set(ids), f"digests verified {out['digest_ok']}")
    counters = out["counters"]
    via_ingest = counters.get("hbm_staged.incremental_ingest", 0)
    check(via_ingest == len(ids),
          f"{via_ingest} of {len(ids)} staged via incremental ingest")
    fallbacks = {k: v for k, v in counters.items()
                 if k.startswith("fallback.")}
    check(not any(fallbacks.values()), f"fallbacks fired: {fallbacks}")
    sent = _sent_by_source(out["links"])
    check(all(sent.values()) or not full_width,
          f"a seeder sent nothing: {sent}")
    warm = out["warm"]
    check(len(warm) >= 1 and (all(in_wire for _, in_wire in warm)
                              or not full_width),
          f"warm-up did not finish before startup: {warm}")
    res = out["res"]
    check(out["booted"].keys() == {2} and res is not None
          and res.kind == "full", f"boot {out['booted']}")
    check(res.via == "streamed per-layer", f"via {res.via!r}")
    for ids_got in out["served"]:
        want = out["served"][0] if fab_tokens is None else fab_tokens
        check(ids_got == want,
              f"served ids {ids_got} != direct generate {want}")
    return sent


def _round_record(out, sent=None):
    return dict(ttd_s=out["ttd_s"], start_s=out["start_s"],
                predicted_ttd_s=out["predicted_ttd_s"],
                ttft_after_startup_s=out["ttft_s"],
                boot_s=out["booted"][2], boot_via=out["res"].via,
                request_latency_s=out["latency"],
                sent_bytes_by_source=sent or _sent_by_source(out["links"]),
                precompile=[rec for rec, _ in out["warm"]],
                attention_launches_by_kernel=out["attention"],
                attention_plain_calls=out["attention_plain"],
                dequant_launches=out["dequant"], plain_calls=out["plain"],
                max_memory_allocated=out["peak"],
                allocated_at_start=out["allocated_at_start"],
                round_wall_s=out["wall_s"])


def phase_hf(cfg, args, fa, fab, prompt):
    """Phase 9 (a): ``cfg``'s seeded weights as an HF checkpoint on disk,
    fabricated back through ``hf:`` and delivered, booted and served in
    phase 6's round; then ``hf_f32`` on the same checkpoint.  Returns the
    bf16 round's attention launches by kernel and the f32 round's by
    kernel instance."""
    import os
    import shutil
    import tempfile

    import torch

    from distributed_llm_dissemination_tpu_torch.core import config as ccfg
    from distributed_llm_dissemination_tpu_torch.core.types import SourceType
    from distributed_llm_dissemination_tpu_torch.models import hf, serde

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    ids = sorted(blobs)
    total = sum(len(b) for b in blobs.values())
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    check(free >= total + HF_DISK_SLACK,
          f"{free} B free under {tmp}; the {cfg.name} checkpoint needs "
          f"{total} B and {HF_DISK_SLACK} B to spare")
    path = tempfile.mkdtemp(prefix="hf-", dir=tmp)
    try:
        t0 = time.monotonic()
        written = write_hf_checkpoint(cfg, serde, blobs, path)
        write_s = time.monotonic() - t0
        name = hf.PREFIX + path
        hcfg = hf.config_from_name(name)
        for field in ("vocab", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "d_ff", "rope_theta", "norm_eps",
                      "dtype"):
            check(getattr(hcfg, field) == getattr(cfg, field),
                  f"hf config {field} {getattr(hcfg, field)} != "
                  f"{getattr(cfg, field)}")
        # The seeder's fabrication, as cli.main runs it: create_layers with
        # "Model": "hf:<dir>" reads, transposes and encodes each blob.
        nc = ccfg.NodeConf(id=1, addr="1",
                           initial_layers={SourceType.MEM: {b: 0 for b in ids}},
                           sources={SourceType.MEM: 0})
        t0 = time.monotonic()
        made = ccfg.create_layers(nc, save_disk=False, model=name)
        fab_s = time.monotonic() - t0
        hblobs = {lid: made[lid].inmem_data for lid in ids}
        same = [lid for lid in ids if hblobs[lid] == blobs[lid]]
        check(same == ids, f"hf blobs byte-identical to the seeded blobs: "
                           f"{same} of {ids}")
        del made
        out = mode3_round(hcfg, args, fa, prompt, hblobs)
        sent = _check_raw_round(hcfg, out, hblobs, fab["tokens"])
        want = _expected_round_launches(fa, hcfg, args,
                                        out["warm"][0][0]["launches"])
        check(out["attention"] == want,
              f"round attention launches {out['attention']} != {want}")
        check(sum(out["attention"].values()) > 0,
              "no K1 launch in the hf round")
        check(out["attention_plain"] == 0,
              f"{out['attention_plain']} plain attention calls in the hf round")
        emit("hf", config=f"hf:<tmp>/{os.path.basename(path)}",
             written_from=cfg.name, checkpoint_bytes=written, shards=HF_SHARDS,
             disk_free_bytes=free, write_s=write_s,
             blobs_byte_identical=f"{len(same)}/{len(ids)}",
             fabricate_s=fab_s, blob_s_per_gb=fab_s / (total / 1e9),
             served_ids_equal_direct_generate=True,
             phase_wall_s=time.monotonic() - t_phase,
             **_round_record(out, sent))
        launches = dict(out["attention"])
        del out, hblobs
        gc.collect()
        torch.cuda.empty_cache()
        f32_launches = phase_hf_f32(cfg, args, fa, fab, prompt, path)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return launches, f32_launches


def phase_hf_f32(cfg, args, fa, fab, prompt, path):
    """Phase 9 (a, float32): the bf16 checkpoint at ``path`` with its
    ``config.json`` as a current ``transformers`` writes it (``"dtype"``,
    no ``torch_dtype``), which both packages read as float32.  Its shards
    are hard-linked beside the new config (no new disk bytes); the
    seeder's fabrication through ``hf:`` widens every leaf to f32, and
    phase 6's round serves the model through K1's f32 instances.  Returns
    the round's attention launches by kernel instance."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.core import config as ccfg
    from distributed_llm_dissemination_tpu_torch.core.types import SourceType
    from distributed_llm_dissemination_tpu_torch.models import hf, serde

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    ids = sorted(blobs)
    f32_path = os.path.join(path, "f32")
    os.mkdir(f32_path)
    for name in os.listdir(path):
        if name.endswith(".safetensors"):
            os.link(os.path.join(path, name), os.path.join(f32_path, name))
    with open(os.path.join(path, "config.json")) as f:
        conf = json.load(f)
    conf["dtype"] = conf.pop("torch_dtype")
    with open(os.path.join(f32_path, "config.json"), "w") as f:
        json.dump(conf, f)
    name = hf.PREFIX + f32_path
    hcfg = hf.config_from_name(name)
    check(hcfg.dtype == torch.float32, f"hf dtype {hcfg.dtype} for a config "
          f"with dtype {conf['dtype']!r} and no torch_dtype")
    nc = ccfg.NodeConf(id=1, addr="1",
                       initial_layers={SourceType.MEM: {b: 0 for b in ids}},
                       sources={SourceType.MEM: 0})
    t0 = time.monotonic()
    made = ccfg.create_layers(nc, save_disk=False, model=name)
    fab_s = time.monotonic() - t0
    hblobs = {lid: made[lid].inmem_data for lid in ids}
    del made
    total = 0
    for lid in ids:  # each blob: the seeded leaves widened to f32, exactly
        specs = serde.blob_specs(cfg, lid)
        leaves = serde._split_blob(cfg, blobs[lid], specs)
        want = b"".join(leaves[n].to(torch.float32).numpy().tobytes()
                        for n, _ in specs)
        check(hblobs[lid] == want,
              f"f32 hf blob {lid} != the seeded blob widened to f32")
        total += len(want)
        del leaves, want
    out = mode3_round(hcfg, args, fa, prompt, hblobs)
    sent = _check_raw_round(hcfg, out, hblobs, None)
    want = _expected_round_launches(fa, hcfg, args,
                                    out["warm"][0][0]["launches"])
    check(out["attention"] == want,
          f"f32 round attention launches {out['attention']} != {want}")
    by_inst = out["attention_by_instance"]
    check(all(by_inst[f"{name}:float32"] == want[name] > 0
              for name in ("decode", "prefill"))
          and sum(by_inst.values()) == sum(want.values()),
          f"f32 round launches by instance {by_inst} (want {want})")
    check(out["attention_plain"] == 0,
          f"{out['attention_plain']} plain attention calls in the f32 round")
    params = out["res"].params
    check(all(t.dtype == torch.float32 for t in params["layers"].values()),
          "the f32 model booted in another dtype")
    served = out["served"][0]
    parity = near_tie_ids(fa, params, prompt, hcfg, served)
    record = _round_record(out, sent)
    del out, hblobs
    gc.collect()
    # Warm decode of the f32 model at both prompt lengths (phase 3's
    # prompts), outside the counted round.
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
    long_prompt = torch.randint(0, cfg.vocab, (1, args.long_prompt),
                                generator=gen, device="cuda")
    serve = {}
    for label, p, n in (("prompt", prompt, REPEATS),
                        ("long_prompt", long_prompt, LONG_REPEATS)):
        prefill, per_token = warm_serve(hcfg, params, p, args.gen, n)
        serve[label] = dict(
            prompt=p.shape[1], warm_samples=n,
            warm_prefill_ms_median=statistics.median(prefill),
            warm_decode_ms_per_token_median=statistics.median(per_token),
            warm_decode_ms_per_token_min_max=[per_token[0], per_token[-1]])
    emit("hf_f32", config=f"hf:<tmp>/{os.path.basename(path)}/f32",
         written_from=cfg.name, dtype="float32",
         config_dtype_key=conf["dtype"], torch_dtype_named=False,
         blob_bytes=total,
         blobs_equal_seeded_widened_to_f32=f"{len(ids)}/{len(ids)}",
         fabricate_s=fab_s, blob_s_per_gb=fab_s / (total / 1e9),
         served_ids=served,
         plain_attention_parity=parity,
         attention_launches_by_instance=by_inst, warm_serve=serve,
         phase_wall_s=time.monotonic() - t_phase, **record)
    launches = dict(by_inst)
    del params, long_prompt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def near_tie_ids(fa, params, prompt, cfg, served):
    """Phase 9's near-tie rule for one served id sequence: a direct greedy
    run with the plain attention on the card, and K1's logits on the same
    ids (teacher forcing).  A step whose plain top-2 margin is within
    twice its logits' difference may pick either id, so the served ids
    must equal the plain run's up to the first step, if any, that is such
    a near-tie; and K1's step logits stay within 2% of the largest."""
    n = len(served)
    plain = step_logits(params, prompt, cfg, n, fa.block_attention_ref)
    plain_ids = plain.argmax(-1).tolist()
    kern = step_logits(params, prompt, cfg, n, tokens=plain_ids)
    diffs = (kern - plain).abs().amax(-1)
    top = plain.topk(2, dim=-1).values
    near_ties = (top[:, 0] - top[:, 1] <= 2 * diffs).nonzero()[:, 0].tolist()
    first = next((i for i in range(n) if served[i] != plain_ids[i]), n)
    step_diff, scale = float(diffs.max()), float(plain.abs().max())
    check(first == n or first in near_ties,
          f"served ids {served} part from the plain run {plain_ids} at step "
          f"{first}, not a near-tie ({near_ties})")
    check(step_diff <= 0.02 * scale, f"K1 and plain decode logits differ by "
          f"{step_diff} (largest logit {scale})")
    return dict(plain_ids=plain_ids, ids_equal=first == n,
                first_difference=first, near_ties=near_ties,
                max_abs_step_logit_diff=step_diff, largest_logit=scale)


def phase_hf_f16(cfg, args, fa, fab, prompt):
    """Phase 9 (a, float16): ``cfg``'s seeded weights rounded to float16 as
    an HF checkpoint (written after the bf16 one is deleted, so the disk
    holds one at a time), fabricated back through ``hf:`` and served in
    phase 6's round through K1's f16 instances.  Returns the round's
    attention launches by kernel instance."""
    import os
    import shutil
    import tempfile

    import torch

    from distributed_llm_dissemination_tpu_torch.core import config as ccfg
    from distributed_llm_dissemination_tpu_torch.core.types import SourceType
    from distributed_llm_dissemination_tpu_torch.models import hf, serde

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    ids = sorted(blobs)
    total = sum(len(b) for b in blobs.values())
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    check(free >= total + HF_DISK_SLACK,
          f"{free} B free under {tmp}; the f16 checkpoint needs {total} B "
          f"and {HF_DISK_SLACK} B to spare")
    path = tempfile.mkdtemp(prefix="hf16-", dir=tmp)
    try:
        t0 = time.monotonic()
        written = write_hf_checkpoint(cfg, serde, blobs, path, f16=True)
        write_s = time.monotonic() - t0
        hcfg = hf.config_from_name(hf.PREFIX + path)
        check(hcfg.dtype == torch.float16, f"hf dtype {hcfg.dtype}")
        nc = ccfg.NodeConf(id=1, addr="1",
                           initial_layers={SourceType.MEM: {b: 0 for b in ids}},
                           sources={SourceType.MEM: 0})
        t0 = time.monotonic()
        made = ccfg.create_layers(nc, save_disk=False,
                                  model=hf.PREFIX + path)
        fab_s = time.monotonic() - t0
        hblobs = {lid: made[lid].inmem_data for lid in ids}
        del made
        for lid in ids:  # each blob: the seeded leaves rounded to f16
            specs = serde.blob_specs(cfg, lid)
            leaves = serde._split_blob(cfg, blobs[lid], specs)
            want = b"".join(leaves[name].to(torch.float16).numpy().tobytes()
                            for name, _ in specs)
            check(bytes(hblobs[lid]) == want,
                  f"f16 hf blob {lid} != the seeded blob rounded to f16")
            del leaves, want
        out = mode3_round(hcfg, args, fa, prompt, hblobs)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    sent = _check_raw_round(hcfg, out, hblobs, None)
    want = _expected_round_launches(fa, hcfg, args,
                                    out["warm"][0][0]["launches"])
    check(out["attention"] == want,
          f"f16 round attention launches {out['attention']} != {want}")
    by_inst = out["attention_by_instance"]
    for name in ("decode", "prefill"):
        check(by_inst[f"{name}:float16"] == want[name] > 0
              and by_inst[f"{name}:bfloat16"] == 0,
              f"f16 round launches by instance {by_inst}")
    check(out["attention_plain"] == 0,
          f"{out['attention_plain']} plain attention calls in the f16 round")
    params = out["res"].params
    check(all(t.dtype == torch.float16 for t in params["layers"].values()),
          "the f16 model booted in another dtype")
    parity = near_tie_ids(fa, params, prompt, hcfg, out["served"][0])
    emit("hf_f16", config=f"hf:<tmp>/{os.path.basename(path)}",
         written_from=cfg.name, dtype="float16", checkpoint_bytes=written,
         disk_free_bytes=free, write_s=write_s,
         blobs_equal_seeded_rounded_to_f16=f"{len(ids)}/{len(ids)}",
         fabricate_s=fab_s, blob_s_per_gb=fab_s / (total / 1e9),
         served_ids=out["served"][0], plain_attention_parity=parity,
         attention_launches_by_instance=by_inst,
         phase_wall_s=time.monotonic() - t_phase,
         **_round_record(out, sent))
    launches = dict(by_inst)
    del out, hblobs, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


class shared_routing:
    """Within the block, every MoE routing of the port's forward (each
    ``route_topk`` result, in call order) is appended to ``log``; with
    ``replay``, it is taken from ``log`` instead, and the block must use
    all of it.  Routing is discontinuous (``tests/test_torch_moe.py``):
    two forwards that differ by bf16 roundings may keep different experts
    for a token whose routing weights nearly tie, and that token's change
    spreads to every later position.  Replaying one run's routing in the
    other leaves only the attention's rounding between them."""

    def __init__(self, log, replay=False):
        self.log, self.replay = log, replay

    def __enter__(self):
        from distributed_llm_dissemination_tpu_torch.models import llama

        self.llama, self.orig, self.used = llama, llama.route_topk, 0

        def route(weights, cfg):
            if not self.replay:
                self.log.append(self.orig(weights, cfg))
                return self.log[-1]
            check(self.used < len(self.log), "more routings than recorded")
            w = self.log[self.used].to(weights.device)
            self.used += 1
            check(w.shape == weights.shape, "replayed routing of another shape")
            return w

        llama.route_topk = route
        return self

    def __exit__(self, *exc):
        self.llama.route_topk = self.orig
        check(exc[0] is not None or not self.replay
              or self.used == len(self.log),
              f"{self.used} of {len(self.log)} recorded routings replayed")


def routed_alike(a, b):
    """The share of (layer, token) pairs two routing logs route to the
    same experts."""
    return float(sum(((x.cpu() > 0) == (y.cpu() > 0)).all(-1).sum()
                     for x, y in zip(a, b))
                 / sum(x.shape[:-1].numel() for x in a))


def step_logits(params, prompt, cfg, n, attention=None, tokens=None):
    """f32 logits [n, vocab] of ``n`` decode steps through the serving
    path (``generate``'s KV-cached prefill, then one-token steps), each
    step fed ``tokens`` (teacher forcing) or, without them, its own
    argmax (greedy)."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import generate as gm

    P = prompt.shape[1]
    cache = gm.init_cache(cfg, 1, P + n, device=prompt.device)
    logits, cache = gm._forward_with_cache(params, prompt, 0, cache, cfg,
                                           attention)
    out = [logits[0]]
    for i in range(1, n):
        tok = tokens[i - 1] if tokens is not None else int(out[-1].argmax())
        step = torch.tensor([[tok]], device=prompt.device, dtype=prompt.dtype)
        logits, cache = gm._forward_with_cache(params, step, P + i - 1, cache,
                                               cfg, attention)
        out.append(logits[0])
    return torch.stack(out)


def moe_parity(fa, cfg, params, prompt, served):
    """On the card, K1 against the plain attention on the booted MoE
    params, and the card against the CPU port, each pair under one
    routing (``shared_routing``): the prompt's logits at every position,
    and every greedy decode step's logits and id, the kernel run fed the
    plain run's ids.  Each pair's own routings must agree on at least
    ``ROUTED_ALIKE`` of (layer, token) pairs, as the tier-1 test asks."""
    from distributed_llm_dissemination_tpu_torch.models import llama

    plain_attn = fa.block_attention_ref
    n = len(served)
    # K1 against the plain attention: the prompt (prefill kernel) ...
    plain_log, kern_log = [], []
    with shared_routing(plain_log):
        plain = llama.forward(params, prompt, cfg, attention=plain_attn)[0]
    with shared_routing(kern_log):
        kern_free = llama.forward(params, prompt, cfg)[0]
    with shared_routing(plain_log, replay=True):
        kern = llama.forward(params, prompt, cfg)[0]
    alike = routed_alike(kern_log, plain_log)
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    # ... and the decode steps (decode kernel).
    step_log = []
    with shared_routing(step_log):
        plain_steps = step_logits(params, prompt, cfg, n, plain_attn)
    plain_ids = plain_steps.argmax(-1).tolist()
    with shared_routing(step_log, replay=True):
        kern_steps = step_logits(params, prompt, cfg, n, tokens=plain_ids)
    kernel_ids = kern_steps.argmax(-1).tolist()
    diffs = (kern_steps - plain_steps).abs().amax(-1)
    step_diff = float(diffs.max())
    top = plain_steps.topk(2, dim=-1).values
    # A step whose plain top-2 margin is within twice its logits'
    # difference may pick either id; every other step must pick the plain
    # run's, and such near-ties may be at most half the steps.
    near_ties = (top[:, 0] - top[:, 1] <= 2 * diffs).nonzero()[:, 0].tolist()
    differ = [i for i in range(n) if kernel_ids[i] != plain_ids[i]]
    check(alike >= ROUTED_ALIKE, f"MoE kernel and plain attention route "
          f"{alike:.4f} of (layer, token) pairs alike")
    check(diff <= 0.02 * scale, f"MoE kernel and plain prompt logits differ "
          f"by {diff} (largest logit {scale})")
    check(step_diff <= 0.02 * scale, f"MoE kernel and plain decode logits "
          f"differ by {step_diff} (largest logit {scale})")
    check(set(differ) <= set(near_ties) and 2 * len(near_ties) <= n,
          f"MoE greedy ids: kernel {kernel_ids} != plain {plain_ids} "
          f"(near-ties at {near_ties})")
    # The card against the CPU port (plain attention on the CPU).
    cpu = {k: ({name: t.cpu() for name, t in v.items()}
               if isinstance(v, dict) else v.cpu()) for k, v in params.items()}
    cpu_log = []
    with shared_routing(cpu_log):
        cpu_logits = llama.forward(cpu, prompt.cpu(), cfg)[0]
    with shared_routing(cpu_log, replay=True):
        card = llama.forward(params, prompt, cfg)[0].cpu()
    cpu_alike = routed_alike(kern_log, cpu_log)
    err = (card - cpu_logits).abs()
    check(cpu_alike >= ROUTED_ALIKE, f"MoE card and CPU route {cpu_alike:.4f} "
          f"of (layer, token) pairs alike")
    check(float(err.max()) < LOGIT_ATOL and float(err.mean()) < LOGIT_MEAN_ATOL,
          f"MoE card logits vs the CPU port: max {float(err.max())}, mean "
          f"{float(err.mean())}")
    free = next((i for i in range(n) if plain_ids[i] != served[i]), n)
    return dict(routed_alike=alike, max_abs_logit_diff=diff, largest_logit=scale,
                max_abs_logit_diff_own_routing=float(
                    (kern_free - plain).abs().max()),
                decode_steps=n, kernel_ids=kernel_ids, plain_ids=plain_ids,
                ids_equal=kernel_ids == plain_ids, near_ties=near_ties,
                max_abs_step_logit_diff=step_diff,
                own_routing_ids_agree_prefix=free,
                cpu_routed_alike=cpu_alike, cpu_max_abs_err=float(err.max()),
                cpu_mean_abs_err=float(err.mean()))


def phase_moe(args, fa, prompt):
    """Phase 9 (b): ``tiny-moe``'s serving shapes through K1 against the
    plain version, then seeded rounds, raw and ``ModelCodec`` int8,
    booted on the card and served.  Returns (the serving mix, attention
    launches by round, K2 launches of the int8 round)."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import quant, serde
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.runtime.codec import (
        WireCodecPlane)

    t_phase = time.monotonic()
    cfg = CONFIGS[MOE_CONFIG]
    mprompt = prompt % cfg.vocab
    raw = {i: bytearray(serde.seeded_blob(cfg, i, seed=args.seed))
           for i in range(serde.head_blob_id(cfg) + 1)}
    ids = sorted(raw)
    # Every prefill and decode shape of a tiny-moe serve (kvh 2, g 2,
    # hd 32) through K1, held against the plain version on the card.
    mix = serving_mix(fa, cfg, mprompt.shape[1], args.gen, 300)
    check(mix["decode"] and mix["prefill"],
          f"a tiny-moe serve reaches K1's decode and prefill kernels: {mix}")
    # K2/K3 on the rank-3 expert leaves of layer blob 0 ([e, d, f] flattened
    # to [e*d, f] rows), bit for bit against the plain version on the card.
    cases = []
    for kind in dq.KINDS:
        wire0 = bytearray(quant.encode_blob(cfg, 0, raw[0], kind))
        rec, kern = codec_kernel_case(dq, quant, kind, "moe_layer", wire0,
                                      serde.layer_param_specs(cfg), cfg.dtype)
        rec["expert_leaves"] = [name for name, shape in
                                serde.layer_param_specs(cfg) if len(shape) == 3]
        cases.append(rec)
        del kern
    rounds, attention = {}, {}
    for codec in ("raw", "int8"):
        blobs = raw if codec == "raw" else {
            lid: bytearray(quant.encode_blob(cfg, lid, raw[lid], codec))
            for lid in ids}
        plane = (None if codec == "raw" else
                 functools.partial(WireCodecPlane, cfg, model_codec=codec))
        out = mode3_round(cfg, args, fa, mprompt, blobs, boot_codec=codec,
                          plane=plane)
        res = out["res"]
        if codec == "raw":
            want = generate(res.params, mprompt, cfg, args.gen)[0].tolist()
            _check_raw_round(cfg, out, blobs, want, full_width=False)
            att = _expected_round_launches(fa, cfg, args,
                                           out["warm"][0][0]["launches"])
            check(out["attention"] == att,
                  f"MoE round attention launches {out['attention']} != {att}")
        else:
            sizes = {lid: quant.blob_nbytes_codec(cfg, lid, codec)
                     for lid in ids}
            _check_codec_round(fa, cfg, args, out, ids, sizes, codec,
                               f"dequant_{codec}", full_width=False)
            ref = _plain_params(cfg, serde, dq, quant, codec, blobs)
            _same_params(res.params, ref)
            want = generate(ref, mprompt, cfg, args.gen)[0].tolist()
            for ids_got in out["served"]:
                check(ids_got == want, f"MoE {codec} served ids {ids_got} "
                                       f"!= {want}")
        check(out["attention_plain"] == 0,
              f"{out['attention_plain']} plain attention calls")
        parity = moe_parity(fa, cfg, res.params, mprompt, out["served"][0])
        rounds[codec] = dict(
            codec=codec, blobs=len(ids),
            wire_bytes=sum(len(b) for b in blobs.values()),
            served_ids_equal_direct_generate=True, served_ids=want,
            booted_params_equal_plain_decode=codec != "raw" or None,
            parity=parity, **_round_record(out))
        attention[codec] = dict(out["attention"])
        if codec != "raw":
            k2 = out["dequant"][codec]
        del out, res
        gc.collect()
        torch.cuda.empty_cache()
    emit("moe", config=cfg.name, n_experts=cfg.n_experts, top_k=cfg.top_k,
         kernel_mix=mix, expert_leaf_cases=cases, rounds=rounds,
         phase_wall_s=time.monotonic() - t_phase)
    return mix, attention, k2


# ------------------------------------------------------------ phase 10

TRAIN_SEQ = 2048  # the one sequence (b = 1) each training step takes
TRAIN_STEPS = 5
TRAIN_LR = 3e-3  # tests/test_models.py's AdamW training tests
TRAIN_SP = (1, 2, 4)  # the rings whose block shapes K1 is held at
CKPT_CONFIG = "llama3-8b-d4v8k"  # the checkpoint leg: about 9.4 GB of state
CLI_STEPS = 2
# K1 against the plain attention in one full-width step.  The kernel rounds
# p to bf16 for the PV product where the plain version keeps f32; on the
# CPU that rounding moved tiny2's bf16 gradients (512 tokens) by 0.6-1.8%
# in relative Frobenius norm and its loss by 6e-5 relative.  Held at 5%
# per leaf and 1e-3 of the loss.
TRAIN_GRAD_REL = 0.05
TRAIN_LOSS_REL = 1e-3


def ring_block_shapes(seq, sp_sizes):
    """Every block a causal ring over ``seq`` tokens computes on each of
    its ranks, for each ring size: (sp, rows = keys, q_off, k_off)."""
    return [(sp, seq // sp, my * (seq // sp), src * (seq // sp))
            for sp in sp_sizes for my in range(sp) for src in range(my + 1)]


def card_params(cfg, serde, seed, blobs=None):
    """The seeded params on the card, stacked as the model takes them:
    from host ``blobs``, or drawn on the card."""
    import torch

    def leaves(lid):
        if blobs is None:
            return serde.seeded_leaves(cfg, lid, seed, device="cuda")
        return {name: t.cuda() for name, t in serde._split_blob(
            cfg, blobs[lid], serde.blob_specs(cfg, lid)).items()}

    layers = {}
    for lid in range(cfg.n_layers):
        for name, t in leaves(lid).items():
            if name not in layers:
                layers[name] = torch.empty((cfg.n_layers, *t.shape),
                                           dtype=t.dtype, device="cuda")
            layers[name][lid].copy_(t)
    head = leaves(serde.head_blob_id(cfg))
    return {"embed": head["embed"], "layers": layers, "ln_f": head["ln_f"],
            "lm_head": head["lm_head"]}


def _rel_fro(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def _clone_tree(sharded, tree):
    return sharded.tree_unflatten((p, x.clone())
                                  for p, x in sharded.tree_leaves(tree))


def _same_tree(sharded, a, b):
    import torch

    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(sharded.tree_leaves(a),
                                         sharded.tree_leaves(b)))


def profile_step(step, args):
    """Where one warm training step spends the card's time (profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    k1 = [e for e in events if "prefill_wgmma_kernel" in e.key]
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return out, dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / wall_ms) if wall_ms else None,
        k1_device_ms=sum(e.self_device_time_total for e in k1) / 1e3,
        k1_launches=sum(e.count for e in k1),
        top=[{"name": e.key[:80], "device_ms": e.self_device_time_total / 1e3,
              "calls": e.count} for e in top])


def phase_train(cfg, args, fa, fab):
    """Phase 10 (module docstring).  Returns the train path's K1 launches
    by kernel and K1's numbers at the step's block."""
    import os
    import shutil
    import tempfile

    import torch

    from distributed_llm_dissemination_tpu_torch.models import (
        serde, sharded, train_ckpt)
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS

    t_phase = time.monotonic()
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    L = cfg.n_layers

    # (a) K1 at every block shape of a ring over TRAIN_SEQ tokens.
    ring = []
    for i, (sp, s, q_off, k_off) in enumerate(
            ring_block_shapes(TRAIN_SEQ, TRAIN_SP)):
        rec = attention_case(fa, 1, kvh, g, s, s, hd, q_off, k_off,
                             torch.bfloat16, seed=400 + i, calls=4,
                             timed=sp == 1)
        check(rec["kernel"] == "prefill", f"ring block {rec['shape']}")
        ring.append(dict(rec, sp=sp))
    step_block = ring[0]  # sp = 1: the one block of this card's step

    # (b) the full-width step: one step's loss and gradients with K1
    # against the same step with the plain attention, then AdamW steps.
    params = card_params(cfg, serde, args.seed, fab["blobs"])
    mesh = sharded.make_train_mesh(1, cfg)
    x, y = sharded.example_batch(cfg, mesh, batch=1, seq=TRAIN_SEQ)
    fa.reset_counts()
    loss_k, grads_k = sharded.loss_and_grads(cfg, mesh, params, x, y)
    torch.cuda.synchronize()
    grad_launches = dict(fa.launches_by_instance)
    grad_plain = fa.plain_calls
    loss_p, grads_p = sharded.loss_and_grads(
        cfg, mesh, params, x, y, attention=fa.block_attention_ref)
    rel = {"/".join(p): _rel_fro(a, b) for (p, _), a, b in zip(
        sharded.tree_leaves(params), grads_k, grads_p)}
    finite = all(bool(torch.isfinite(t).all()) for t in grads_k)
    del grads_k, grads_p
    loss_k, loss_p = float(loss_k), float(loss_p)
    check(finite and math.isfinite(loss_k), "non-finite loss or gradients")
    check(grad_launches["prefill:bfloat16"] == 2 * L and grad_plain == 0,
          f"K1 launches in one remat step {grad_launches}, plain "
          f"{grad_plain}")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_REL * abs(loss_p),
          f"K1 loss {loss_k} vs plain {loss_p}")
    check(max(rel.values()) <= TRAIN_GRAD_REL,
          f"K1 vs plain gradients, relative norm {rel}")

    opt = sharded.init_adamw_state(params)
    step = sharded.build_adamw_train_step(cfg, mesh, lr=TRAIN_LR)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()  # the train path's counts start here
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, loss = step(params, opt, x, y)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
    launches = dict(fa.launches_by_kernel)  # ...and are read here
    by_inst = dict(fa.launches_by_instance)
    plain = fa.plain_calls
    peak = torch.cuda.max_memory_allocated()
    check(launches == {"decode": 0, "prefill": TRAIN_STEPS * 2 * L}
          and by_inst["prefill:bfloat16"] == TRAIN_STEPS * 2 * L,
          f"train path K1 launches {by_inst}")
    check(plain == 0, f"{plain} plain attention calls on the train path")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"losses {losses}")
    (params, opt, _), prof = profile_step(step, (params, opt, x, y))
    del params, opt, x, y
    gc.collect()
    torch.cuda.empty_cache()
    med = statistics.median(step_s)
    flops = train_flops(cfg, TRAIN_SEQ)

    # (c) the checkpoint leg on CKPT_CONFIG: save, restore, continue
    # bit-identically; then cli.train -resume as a child process.
    ccfg = CONFIGS[CKPT_CONFIG]
    cparams = card_params(ccfg, serde, args.seed)
    cmesh = sharded.make_train_mesh(1, ccfg)
    cx, cy = sharded.example_batch(ccfg, cmesh, batch=1, seq=TRAIN_SEQ)
    copt = sharded.init_adamw_state(cparams)
    cstep = sharded.build_adamw_train_step(ccfg, cmesh, lr=TRAIN_LR)
    for _ in range(2):
        cparams, copt, _ = cstep(cparams, copt, cx, cy)
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      sharded.tree_leaves({"p": cparams, "o": copt}))
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    check(free >= 2 * state_bytes + HF_DISK_SLACK,
          f"{free} B free under {tmp}; the {ccfg.name} checkpoint needs "
          f"{state_bytes} B twice (a save writes beside the old one)")
    workdir = tempfile.mkdtemp(prefix="train-", dir=tmp)
    child = None
    try:
        path = os.path.join(workdir, "ckpt")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        train_ckpt.save_train_state(path, cparams, copt, cmesh)
        save_s = time.monotonic() - t0
        ref_losses = []
        rp, ro = _clone_tree(sharded, cparams), _clone_tree(sharded, copt)
        for _ in range(CLI_STEPS):
            rp, ro, loss = cstep(rp, ro, cx, cy)
            ref_losses.append(float(loss))
        del cparams, copt
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        gp, go = train_ckpt.restore_train_state(path, ccfg, cmesh)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        check(int(go["step"]) == 2, f"restored step {int(go['step'])}")
        got_losses = []
        for _ in range(CLI_STEPS):
            gp, go, loss = cstep(gp, go, cx, cy)
            got_losses.append(float(loss))
        check(got_losses == ref_losses and _same_tree(sharded, gp, rp)
              and _same_tree(sharded, go, ro),
              f"resumed run {got_losses} differs from the uninterrupted "
              f"{ref_losses}")
        del gp, go, rp, ro, cx, cy
        gc.collect()
        torch.cuda.empty_cache()
        conf = os.path.join(workdir, "conf.json")
        with open(conf, "w") as f:
            json.dump({"Model": ccfg.name}, f)
        cmd = [sys.executable, "-m",
               "distributed_llm_dissemination_tpu_torch.cli.train", "-f",
               conf, "-resume", "-ckpt", path, "-steps", str(CLI_STEPS),
               "-batch", "1", "-seq", str(TRAIN_SEQ), "-lr", str(TRAIN_LR)]
        t0 = time.monotonic()
        child = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        out, err = child.communicate(timeout=CHILD_TIMEOUT_S)
        cli_wall = time.monotonic() - t0
        check(child.returncode == 0,
              f"cli.train exited {child.returncode}: {err[-2000:]}")
        summary = json.loads(out.strip().splitlines()[-1])
        check(summary["resumed_step"] == 2
              and summary["final_step"] == 2 + CLI_STEPS
              and summary["losses"] == [round(v, 4) for v in ref_losses],
              f"cli.train summary {summary} (the library: {ref_losses})")
        ckpt_files = sorted(os.listdir(path))
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    emit("train", config=cfg.name, seq=TRAIN_SEQ, batch=1, remat=True,
         lr=TRAIN_LR, mesh=dict(mesh.shape), steps=TRAIN_STEPS,
         losses=losses, step_s=step_s, ms_per_step_median=med * 1e3,
         tokens_per_s=TRAIN_SEQ / med, model_flops_per_step=flops,
         achieved_tflops=flops / med / 1e12,
         max_memory_allocated=peak,
         k1_launches_per_step=by_inst["prefill:bfloat16"] / TRAIN_STEPS,
         k1_launches_by_instance=by_inst, plain_attention_calls=plain,
         k1_vs_plain=dict(loss_k1=loss_k, loss_plain=loss_p,
                          loss_rel_diff=abs(loss_k - loss_p) / abs(loss_p),
                          grad_rel_norm_diff=rel,
                          grad_rel_norm_diff_max=max(rel.values()),
                          tolerance={"loss_rel": TRAIN_LOSS_REL,
                                     "grad_rel_norm": TRAIN_GRAD_REL}),
         k1_step_block=step_block, ring_blocks=ring,
         profile=prof,
         checkpoint=dict(config=ccfg.name, state_bytes=state_bytes,
                         files=ckpt_files, save_s=save_s,
                         restore_s=restore_s,
                         resumed_bit_identical=True,
                         disk_free_bytes=free),
         cli=dict(wall_s=cli_wall, summary=summary,
                  losses_equal_library=True),
         phase_wall_s=time.monotonic() - t_phase)
    return launches, step_block


def train_flops(cfg, seq):
    """Model operations of one remat training step on ``seq`` tokens: the
    products of the forward (2 per multiply-add; causal attention counts
    its visible pairs), three times over for forward and backward, plus
    the layers' forward again for the recompute."""
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    proj = 2 * seq * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f)
    attn = 4 * hd * h * seq * (seq + 1) // 2
    layer = proj + attn
    head = 2 * seq * d * cfg.vocab
    return 3 * (cfg.n_layers * layer + head) + cfg.n_layers * layer


def codec_kernel_entry(dq, kind, st):
    """One ``kernels`` entry for K2/K3: the layer blob's numbers, the head
    blob's beside them."""
    layer = st["layer"]
    return {
        "name": f"dequant_{kind}",
        "route": "cuda",
        "source": CSRC + dq.SOURCE,
        "replaces": CODEC_REPLACES[kind],
        "launches": st["launches"]["codec"],
        "launches_by_path": st["launches"],
        "max_abs_err": max(layer["max_abs_err"], st["head"]["max_abs_err"]),
        "ms": layer["ms"],
        "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"],
        "bound_by": layer["bound_by"],
        "library_ms": None,
        "numbers_from": "llama3-8b-d4 layer blob 0; launches from phase 8's "
                        f"ModelCodec {kind} round",
        "timing": TIMING,
        "head_blob": {k: st["head"][k] for k in
                      ("ms", "plain_ms", "bound_ms", "wire_bytes",
                       "decoded_bytes")},
    }


def codec_f16_entry(dq, kind, st):
    """The kernels entry of K2/K3's f16 output instance: layer blob 0 as
    an f16 model's.  Its launches are the ``ModelCodec`` round's, which
    serves the bf16 model: no f16 instance runs there."""
    rec = st["layer_f16"]
    return {
        "name": f"dequant_{kind}_f16",
        "route": "cuda",
        "source": CSRC + dq.SOURCE,
        "replaces": CODEC_REPLACES[kind],
        "launches": st["f16_launches"],
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
        "numbers_from": "llama3-8b-d4 layer blob 0 rounded to f16, encoded "
                        f"{kind}; phase 8's cases, bit-exact (not on a "
                        "counted path: every round's model is bf16)",
        "timing": TIMING,
    }


def kernel_dtype_entry(fa, name, dtype, launches, mix, full=None):
    """The kernels entry of one of K1's f16 or f32 instances: that type's
    serving mix's per-launch numbers; launches from phase 9's round of a
    model of that type (``hf_f16``, ``hf_f32``).  ``full``: the phase-2
    full-width case of the instance, beside them (f32, with the ceiling
    of a kernel without tensor cores)."""
    head = mix[name]
    short = {"float16": "f16", "float32": "f32"}[dtype]
    entry = {
        "name": f"block_attention_{name}_{short}",
        "route": "cuda",
        "source": CSRC + fa.SOURCES[name],
        "replaces": KERNEL_REPLACES,
        "launches": launches[f"{name}:{dtype}"],
        "launches_by_path": {f"hf_{short}": launches[f"{name}:{dtype}"]},
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "device_kernels": list(DEVICE_KERNELS[name]),
        "numbers_from": f"{short} serving mix of the main prompt; launches "
                        f"from phase 9's {short} round",
        "timing": TIMING,
    }
    if full is not None:
        entry["full_width"] = dict(
            {k: full[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                  "bound_ms", "bound_by", "flops",
                                  "max_abs_err_vs_plain")},
            simt_bound_ms=max(full["flops"] / F32_SIMT_FLOPS,
                              full["bytes"] / HBM_BYTES_PER_S) * 1e3)
    return entry


def kernel_entry(fa, name, paths, case_stats, mixes, main_mix):
    """One ``kernels`` entry: the per-launch means of the main path's
    launch mix, or of phase 2's cases for a kernel the main path does not
    run, with every mix beside them.  ``paths``: each counted path's
    launches by kernel; ``launches`` is the main path's."""
    head = mixes[main_mix][name] or case_stats[name]
    return {
        "name": f"block_attention_{name}",
        "route": "cuda",
        "source": CSRC + fa.SOURCES[name],
        "replaces": KERNEL_REPLACES,
        "launches": paths["main"][name],
        "launches_by_path": {path: p[name] for path, p in paths.items()},
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
        cuda_build, dequant as dq, flash_attention as fa)

    t_script = time.monotonic()
    cfg = CONFIGS[args.config]
    card = phase_env(cuda_build, fa, dq)
    case_stats, mixes, full_f32 = phase_kernel(fa, cfg, args.prompt, args.gen,
                                               args.long_prompt)
    res, prompt, launches, fab = phase_main(cfg, args, fa)
    long_prompt = phase_long_serve(cfg, args, res)
    phase_parity(cfg, res, prompt, fa)
    phase_profile(cfg, res, prompt, "prompt")
    phase_profile(cfg, res, long_prompt, "long_prompt")
    del res, long_prompt  # phase 3's model: freed before the round
    torch.cuda.empty_cache()
    raw_ttd_s = phase_dissemination(cfg, args, fa, fab, prompt)
    phase_dissemination(cfg, args, fa, fab, prompt, without_xxhash=True)
    phase_cli(cfg, args, fa, fab, prompt)
    codec_stats = phase_codec(cfg, args, fa, fab, prompt, raw_ttd_s)
    hf_launches, f32_launches = phase_hf(cfg, args, fa, fab, prompt)
    f16_launches = phase_hf_f16(cfg, args, fa, fab, prompt)
    mixes[f"{MOE_CONFIG} prompt{args.prompt}"], moe_launches, moe_k2 = (
        phase_moe(args, fa, prompt))
    train_launches, train_block = phase_train(cfg, args, fa, fab)
    paths = {"main": launches, "hf": hf_launches,
             "moe_raw": moe_launches["raw"], "moe_int8": moe_launches["int8"],
             "train": train_launches}
    for kind, st in codec_stats.items():
        st["launches"] = {"codec": st["launches"],
                          "moe_int8": moe_k2 if kind == "int8" else 0}

    main_mix = f"prompt{args.prompt}"
    entries = [kernel_entry(fa, name, paths, case_stats, mixes, main_mix)
               for name in fa.SOURCES]
    entries[list(fa.SOURCES).index("prefill")]["train"] = {
        "launches_per_step": train_launches["prefill"] / TRAIN_STEPS,
        "block": train_block["shape"],
        **{k: train_block[k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
        "max_abs_err_vs_plain": train_block["max_abs_err_vs_plain"]}
    entries += [kernel_dtype_entry(fa, name, "float16", f16_launches,
                                   mixes[f"{main_mix}_f16"])
                for name in ("decode", "prefill")]
    entries += [kernel_dtype_entry(fa, name, "float32", f32_launches,
                                   mixes[f"{main_mix}_f32"], full_f32[name])
                for name in ("decode", "prefill")]
    entries += [codec_kernel_entry(dq, kind, st)
                for kind, st in codec_stats.items()]
    entries += [codec_f16_entry(dq, kind, st)
                for kind, st in codec_stats.items()]
    print(json.dumps({"kernels": entries}), flush=True)
    emit("script", wall_s=time.monotonic() - t_script)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
