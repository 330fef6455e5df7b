#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--config llama3-8b-d4] [--prompt 128] [--gen 32]
                          [--long-prompt 2048] [--seed 0] [--only cards4]

``--only cards4`` runs phase 1 and phase 16 alone (it needs four cards
and exits non-zero with fewer).

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
   a negotiated round: raw ``llama3-8b-d4v8k`` blobs cut to
   ``NEGOTIATED_LAYERS`` layers, ``WireCodec`` int8
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

11. swap (run after phase 7): the zero-downtime weight swap at
   ``--config``'s full width, in phase 6's topology in one process over
   loopback TCP (leader 0, seeder 1, cold dest 2 on the card) with a
   ``GenRequester`` as node 9.  v1 (seed ``--seed``) is delivered and
   booted; a thread sends the ``--prompt`` request for ``--gen`` greedy
   tokens back to back for the whole phase.  Leg A: a ``kind="swap"``
   job delivers v2 (seed + 1) under layer ids 1000 + slot and the
   commit fence flips the dest; leg B does the same for v3 (seed + 2,
   ids 2000 + slot) with the dest's ``HEADROOM_FACTOR`` raised so that
   the head blob stages on the host and the flip moves it to the card.
   Checked: no request fails; every answer equals a direct ``generate``
   on v1, v2 or v3 on the card (pairwise distinct), and every answer
   begun after a flip the new version's; each flipped tree equals the
   version's seeded leaves bit for bit; v1's blobs in the dest's store
   unchanged; ``swap.flips`` and ``swap.committed`` rise by one per leg,
   with no staging failure or abort; each job ``done`` with no dropped
   pair; leg B staged at least one blob on the host; K1 launched both
   kernels and the plain attention never.  Measured per leg: TTD to the
   leader's commit and to the dest's confirmation, ``prepare_ms`` and
   ``flip_ms`` from the swap's log records, request latency before the
   swap, during staging and after the flip, the longest gap between two
   answers, peak device memory, and before leg B the headroom as
   ``mem_get_info`` and as ``hbm_headroom_bytes`` read it.

12. fabric (run after phase 8): the single-controller device fabric.
   ``cli.podrun.run_pod`` at ``--config``'s full width in one process:
   leader 0, seeders 1 and 2 holding phase 3's seeded blobs, dest 3
   assigned the first two layer blobs and dest 4 the rest with the head,
   on a ``nodes`` mesh axis of 5 slots, all on the card, mode 3 over the
   in-memory control transport, then ``--gen`` greedy tokens after the
   ``--prompt`` prompt through the pipelined stages.  Checked: no
   ``LayerMsg`` crossed the transport; one ``DevicePlanMsg`` per blob
   whose layout tiles it, from the seeders only, both of them; every
   blob on its dest's stage slot of the card, byte-exact, its digest the
   seeded blob's; every ``fallback.*`` counter and
   ``shard.gather_host_fallback`` at 0; both stage boots on the card; the
   pipelined forward's logits of the prompt against phase 3's direct
   forward (``tests/test_torch_model.py``'s tolerance); the pod's ids
   equal to phase 3's; K1's launches equal what the dests' warm-ups, the
   stage boots, the pipelined forward, its prefill and ``--gen`` - 1
   decode steps must launch, and the plain attention never.  Then an
   uneven 3/1 partition (the same ids), one ``ModelCodec`` int8 round of
   phase 8's wire blobs (no layer byte on the transport, K2 launched once
   per blob, once more for the head when the pod assembles, and once per
   warm-up, the plain dequant never, the ids of phase
   8's int8 round), and ``gather_byte_shards`` of layer blob 0's int8
   form in 4 shards on 4 slots with ``decode``: K2 on the gathered tensor,
   leaves equal to the host decode bit for bit, ``pod.device_dequants``
   up by one.  Measured: TTD (beside phase 6's TCP round), the seeders'
   upload GB/s, the dests' finalize ms, the first pipelined forward and
   decode in the live pod, then the warm forward and decode ms per token
   once the pod's nodes have closed (beside phase 3's), peak memory and
   the collective program cache.

13. pods (run after phase 12): pod-shard delivery on the single-controller
   fabric, in one process over loopback TCP: leader 0 and seeder 1 hold
   phase 3's blobs, dests 3 and 4 form one pod (``pods={0: [3, 4]}``),
   both assigned every blob and booting on the card, on the in-process
   ``FabricPlane`` board; each NIC carries one 1/2 shard per blob and
   the full tree materializes through the board's gather
   (``gather_byte_shards``, every call timed).  Run raw, then with a
   negotiated int8 ``WireCodec`` (the senders' planes start out holding
   phase 8's encodes, so no encode runs).  Checked: each dest's tree
   byte-exact (the wire form for int8), each dest's NIC bytes equal to
   its shard bytes in the link table, every pod counter at its count and
   no degradation, both dests booted full on the card, one request per
   dest answered with phase 3's ids (raw) or phase 8's (int8), K1 as the
   warm-ups, boots and requests need and the plain attention never; for
   int8, K2 once per gathered tree plus the warm-ups, the plain dequant
   never, the booted params equal to the plain decode on the card and
   blob 0's to the host decode.  Measured: TTD, each dest's NIC bytes
   beside the model's, the gathers' seconds, boot, peak memory.
14. spmd: the multi-controller fabric, one ``cli.main`` process per node
   on the card: leader 0, seeders 1 and 2 (``-boot none``), dests 3 and 4
   as two stages of 2 layers each, both holding the head; a ``Mesh``
   with ``Fabric`` and a ``Distributed`` section on an ephemeral port,
   mode 3, ``-gen --gen`` on the leader.  The five processes share the
   card, so the group runs gloo.  Checked: every process exits 0; every
   process's ``spmd fabric up`` names gloo; each dest logs ``layer landed
   over device fabric`` with ``spmd`` for each of its blobs; no process
   logs a ``layer received`` record (whole or a fraction), and the link
   table of every process, the leader's included (its ``leader
   summary``), holds 0 bytes sent, received or delivered over the
   transport; every process's fallback counters at 0; every receiver's
   plain attention calls at 0; each member's generated ids
   equal the port's ``generate`` on the seeded params from the zero
   prompt; each dest's K1 launches equal its warm-up, stage boot and
   pipelined decode's.  Measured: TTD and TTFT as the leader prints
   them, each member's decode seconds, the transport's layer bytes per
   process, each process's peak device memory; the logs stay in
   ``build/chip_smoke_spmd/``.
15. ttd_matrix (run last): the port's TTD matrix harness
   (``cli/ttd_matrix.py``) on the card.  (a) ``python -m
   distributed_llm_dissemination_tpu_torch.cli.ttd_matrix -trials 1`` as
   a child, its record in ``build/chip_smoke_ttd/``: the five default
   scenarios (``local_4node``, ``reference_8node@8MiB`` and
   ``dcn_2slice_8node@8MiB`` over loopback TCP, ``pod_fabric_4node@8MiB``
   through ``cli.podrun`` with every slot on the card,
   ``spmd_fabric_2proc@8MiB`` as two gloo processes on the card) in
   modes 0-3, the codec A/B row, the north-star model and the hash-rate
   bench.  Checked: exit 0, a TTD for every mode of every scenario, a
   mode-3 ``predicted_s`` > 0 for each, ``mode1_vs_mode0`` recorded,
   every ``fallback.*`` counter of the pod rows at 0, the
   ``north_star_model`` rows equal to the port's solver in this process
   (``solve_ms`` aside), the record's card equal to ``nvidia-smi``'s.
   (b) ``run_physical(device="cuda")``: two seeders deliver the five
   ``llama3-8b-d4v8k`` blobs (four ~416 MiB layers and the trimmed head)
   to a cold ``-hbm`` dest over loopback TCP, mode 3, which boots on the
   card.  Checked from the dest's log: every digest verified, every blob
   staged through incremental ingest, no fallback counter fired, K1's
   launches equal to its warm-up's plus one boot prefill per layer, the
   plain attention never; TTD, TTFT, GB/s and the loopback ceilings
   recorded.  (c) ``run_physical_fabric(device="cuda")``: the same model
   over ``cli.podrun``'s [4, 2] mesh, every slot on the card; checked: 0
   layer fragments on TCP, at least one fabric delivery per blob.
   Measured: each row's wall time and the phase's.

16. cards4 (after phase 14; needs ``torch.cuda.device_count() >= 4``, else
   one line ``{"phase": "cards4", "ran": false, "cards": N}``): the port
   across four cards of one host.  (a) each card's ``nvidia-smi`` line,
   ``nvidia-smi topo -m``, the peer-access matrix and a 1 GiB copy from
   card 0 to each other card (GB/s, the ceiling of a cross-card move);
   then K1's decode and bf16 prefill, K2 and K3 with their tensors on
   each card while card 0 is current, each against its plain version at
   phase 2's and phase 8's tolerances and counted on its tensors' card.
   (b) one controller: ``cli.podrun.run_pod`` of phase 12's topology with
   leader ``CARDS4_LEADER`` and the mesh's slots on the cards in order
   (no ``device``): the dests' stages on two cards, the seeders on the
   other two.  Checked: each dest's blobs on its stage's card, byte-exact
   and digest-exact, no layer byte on the transport, every fallback
   counter at 0, ids equal to one card's ``generate``, K1 launched only on
   the dests' cards as phase 12 counts them; then a ``ModelCodec`` int8
   round whose stage leaves (K2 on each dest's card) equal the plain
   decode bit for bit; then phase 12's gather leg with one shard per
   card.  Measured: TTD, GB/s over TTD against the copy
   ceiling, the pod's warm decode ms per token against one card's.  (c)
   one ``cli.main`` process per card on nccl: leader 0, seeder 1, dests 2
   and 3 (phase 14's checks, every ``"process group up"`` record saying
   nccl, each dest's K1 launches on its own card).  (d) ``cli.train
   -steps 3 -seq 2048`` in a world of four processes (``WORLD_SIZE``,
   ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``; nccl; tp 2 x
   pp 2; rank 0 disseminates and broadcasts), then in a world of one on
   card 0.  Checked: every rank's shards equal the delivered params'
   slices (digests, ``-params-digest``), the one-rank params equal them
   whole, losses within ``CARDS4_LOSS_REL``, each rank's K1 prefill
   launches on its own card and as many as the one-rank run's (a rank
   runs its n_layers / pp layers once per pipeline hop, pp hops a step).  Measured: ms
   per step, tokens/s, peak memory per card, K1 prefill launches per
   step per card.  Logs in ``build/chip_smoke_cards4*/``.  (e) phase 17's
   dry run at n = 4 (``phase_dryrun``, no ``entry()``): the ``tiny-moe``
   step in four nccl processes, one per card; the dissemination round on
   a 2 x 2 ``pp x tp`` mesh (each stage on two cards, every blob on both)
   and the fabric round with dest 2 on cards 0-1 and the seeders on 2-3;
   phase 17's checks, K1 and K2 counted on their tensors' cards.

17. dryrun (after phase 16, before phase 9): the port's multi-device dry
   run (``distributed_llm_dissemination_tpu_torch/cli/dryrun.py``) on the
   card.  ``entry()`` first: ``llama.init_params(--config, 0)`` drawn on
   the card, equal to the seeded blobs bit for bit, its greedy ids of 16
   zero tokens the reference; then its 128-token forward (K1 prefill once
   per layer).  Then ``dryrun_multichip(1)`` at ``--config``'s width with
   phase 3's blobs and phase 8's int8 wire blobs (NICs ``SEEDER_NIC``):
   (a) one AdamW + remat step of ``tiny-moe``, (b) a mode-3 round over the
   in-memory transport into one stage on the card, the loss from the
   landed tensors and the full boot's greedy decode, (c) the int8 fabric
   round on a 2-slice topology with on-device dequant.  Checked: every
   blob byte-exact on its slots, the decode's ids equal to the reference,
   no ``LayerMsg`` on the fabric's transport, full boots, and K1's and
   K2's launches by kernel and card equal to what the warm-ups, boots,
   loss, decodes and the step must launch, the plain versions never.
   Measured: TTD, boot seconds, decode ms per token, the step's loss and
   seconds, peak memory; the phase's wall time.

18. receive (after phase 17): the receive path at ``--config``'s width,
   each round phase 6's topology into a cold ``-hbm`` dest on card 0 over
   loopback TCP, mode 3.  (a) is phase 6's own round: a spy on dest 2's
   layer sink tallies the bytes it placed in the reassembly buffers and
   the bytes that bounced, beside the link table's striped frames;
   checked there that the sink engaged.  (b) ``update()`` mid-flight:
   the leader's goal is blobs 0-1 (its boot held) until dest 2 acks one,
   then ``update()`` makes every blob the goal.  (c) the round with dest
   2's link corrupting inbound layer frames and the senders duplicating
   theirs (``RECEIVE_FAULTS``, seeded, no delays); then a
   ``StreamingBootStager`` given a wrong digest for blob 0 rejects it and
   ``boot_from_layers`` infills it.  (d) a round of phase 8's int4 wire
   blobs, and a request to the leader and one to unbooted seeder 1.
   Checked: each round's blobs byte-exact on the card via incremental
   ingest, every digest verified, no fallback, a full boot serving
   phase 3's ids (int4: a direct ``generate`` on its booted params'
   ids); (b) ``ready`` fires for the whole goal; (c) CRC drops and
   retransmits counted, the stager boot's ids phase 3's; (d) both
   refusals in the JAX package's text; K1 and K3 launches by kernel and
   card as ``receive_launches_predicted`` says, the plain versions never.
   Measured: the sink's share of bytes, (b)'s update-to-ready time and
   TTD, (c)'s NACKs and re-sent bytes, (d)'s request latency.

Then the ``{"kernels": [...]}`` line (K1's two kernels, their f16 and f32
instances, then K2 and K3 and their f16 output instances; ``launches`` is
the main path's count -- phase 3 for K1, phase 9's f16 and f32 rounds
for its f16 and f32 instances, phase 8's ``ModelCodec`` round for K2 and
K3 -- and
``launches_by_path`` shows every counted path, phase 10's ``train``
among them, with phase 11's ``swap``, phase 12's ``fabric`` (K2's
``fabric``: its int8 round and the gather's decode), phase 13's ``pods``
(K2's: its int8 round), phase 14's ``spmd`` (the dests' processes) and
phase 15's ``ttd_matrix`` (the physical row's dest process) and phase
16's ``cards4`` (K1: 16b's two rounds, 16c's dests, 16d's ranks and
16e; K2: 16b's int8 round and its gather, and 16e's fabric round; null
where the phase did not run) and phase 17's ``dryrun`` (K1: ``entry()``'s
forward and the three parts; K2: the fabric round) and phase 18's
``receive`` (K1: its three rounds, the stager boot and the direct
``generate``; K3: the int4 round);
the prefill entry's
``train``
holds K1 at the training step's block),
the script's wall time, the card's name and power limit as
``nvidia-smi`` prints them, and, last, the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# REQUESTS genreq processes (each a fresh interpreter, 1.4-1.7 s apiece
# on the card's host: the client never loads torch) to ask, about three
# times over; the phase waits for the dest to close its window.
SERVE_WINDOW_S = 15
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
                   calls=10, host=False, timed=True, device="cuda"):
    """Phase-2 record for one shape: which kernel served it, its errors
    against the plain version and the f64 oracle (checked), and, when
    ``timed``, the three device times beside the bound.  ``device``: the
    card the tensors lie on (phase 16a: each card while card 0 is
    current)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    qg, k, v = rnd(b, kvh, g, sq, hd), rnd(b, kvh, t, hd), rnd(b, kvh, t, hd)
    name = fa.kernel_for(sq, g, dtype)
    before = dict(fa.launches_by_kernel)
    got = fa.block_attention(qg, k, v, q_off, k_off)
    torch.cuda.synchronize(qg.device)
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
    fab["logits"] = res.logits.float().cpu()  # phase 12's reference
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


def _spy_sink(transport):
    """Wrap the layer sink the dest registered on ``transport`` (as
    ``tests/test_zerocopy.py:87-99`` does) and tally what it placed in the
    reassembly buffers and what it declined (those fragments bounce)."""
    real = transport.layer_sink
    check(real is not None, "the dest registered no layer sink")
    tally = dict.fromkeys(("placed", "placed_bytes", "declined",
                           "declined_bytes"), 0)
    lock = threading.Lock()

    def spy(layer_id, total, offset, size):
        got = real(layer_id, total, offset, size)
        key = "placed" if got is not None else "declined"
        with lock:
            tally[key] += 1
            tally[key + "_bytes"] += size
        return got

    transport.layer_sink = spy
    return tally


def _await_first_ack(leader, first, timeout_s=600.0):
    """Block until the leader's status row of dest 2 holds a blob of
    ``first`` (its ack landed); returns the acked ids."""
    deadline = time.monotonic() + timeout_s
    while True:
        with leader._lock:
            acked = sorted(set(leader.status.get(2, {})) & set(first))
        if acked:
            return acked
        check(time.monotonic() < deadline,
              f"no blob of {sorted(first)} acked in {timeout_s} s")
        time.sleep(0.001)


def _window(fa, dq):
    """The kernel counts since the last ``reset_counts``: K1 and K2/K3 by
    kernel, instance and card, and the plain versions' calls."""
    import copy

    return {"attention": dict(fa.launches_by_kernel),
            "attention_by_instance": dict(fa.launches_by_instance),
            "attention_by_device": copy.deepcopy(fa.launches_by_device),
            "attention_plain": fa.plain_calls,
            "dequant": dict(dq.launches_by_kernel),
            "dequant_by_instance": dict(dq.launches_by_instance),
            "dequant_by_device": copy.deepcopy(dq.launches_by_device),
            "plain": dict(dq.plain_calls)}


def mode3_round(cfg, args, fa, prompt, blobs, boot_codec="raw", plane=None,
                first=None, faults=None, refusals=False):
    """One mode-3 round of phase 6's topology over loopback TCP: leader 0
    and seeder 1 hold ``blobs`` (one shared host copy), cold dest 2
    ingests them fragment by fragment into the card's memory, stages,
    boots under ``boot_codec`` and answers ``REQUESTS`` greedy requests
    for ``prompt`` from requester seat 3.  ``plane``: None, or a factory
    of each node's wire-codec plane (as ``cli.main`` builds one).
    ``first``: the leader's first goal (blob ids); when dest 2 acks one of
    them the leader's ``update()`` makes every blob the goal, and the boot
    is held until then (phase 18 (b)).  ``faults``: {node: fault spec},
    each such node's link wrapped in a seeded ``FaultyTransport``.
    ``refusals``: after the requests, one request to the leader and one to
    unbooted seeder 1, whose refusal texts are returned.  The dest's layer
    sink is tallied (``_spy_sink``).  The kernel counts are zeroed just
    before and read just after.  Returns what the callers check, with the
    nodes closed and their threads joined."""
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
    from distributed_llm_dissemination_tpu_torch.transport.faults import (
        FaultyTransport, rules_from_spec)
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
    goal = ({2: {lid: LayerMeta() for lid in first}} if first
            else assignment)
    placement = assignment_to_placement(assignment)  # one card, one stage
    nic = {0: SEEDER_NIC, 1: SEEDER_NIC, 2: DEST_NIC}
    # The boot keeps each staged blob's tensor referenced, so the callers'
    # byte checks read what was staged.
    os.environ["DLD_BOOT_DONATE"] = "0"
    ts = {i: TcpTransport("127.0.0.1:0") for i in range(4)}
    for t in ts.values():
        t.addr_registry.update({i: u.addr for i, u in ts.items()})
    links = dict(ts)
    for i, spec in (faults or {}).items():
        seed, rules = rules_from_spec(spec)
        links[i] = FaultyTransport(ts[i], rules, seed=seed)
    gc.collect()  # an earlier round's nodes and tensors
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    allocated_at_start = torch.cuda.memory_allocated()
    threads_before = set(threading.enumerate())
    trace.reset_run()
    fa.reset_counts()
    dq.reset_counts()  # the round's counts start here
    t_phase = time.monotonic()
    leader = FlowRetransmitLeaderNode(Node(0, 0, links[0]), holdings(),
                                      goal, nic, expected_nodes={1, 2},
                                      codecs=codecs())
    # With a first goal the boot waits for the whole one: the startup of
    # a goal met before the update carries no boot.
    leader.boot_enabled = not first
    seeder = FlowRetransmitReceiverNode(Node(1, 0, links[1]), holdings(),
                                        codecs=codecs())
    dest = FlowRetransmitReceiverNode(Node(2, 0, links[2]), {},
                                      stage_hbm=True, placement=placement,
                                      boot_cfg=cfg, boot_codec=boot_codec,
                                      codecs=codecs())
    sink = _spy_sink(ts[2])
    requester = GenRequester(links[3], my_id=3)
    try:
        seeder.announce()
        dest.announce()
        t_call = time.monotonic()
        leader.start_distribution().get(timeout=300)
        t0 = time.monotonic()
        upd = None
        if first:
            acked = _await_first_ack(leader, first)
            t_update = time.monotonic()
            leader.boot_enabled = True
            leader.update(assignment)
            upd = {"acked_at_update": acked,
                   "update_after_start_s": t_update - t0}
        ready_goals = []
        while True:  # a first goal met before the update fires its own
            goal_met = leader.ready().get(timeout=600)
            ready_goals.append(sorted(goal_met.get(2, {})))
            if ready_goals[-1] == ids:
                break
        t_startup = time.monotonic()
        if upd is not None:
            upd.update(ready_goals=ready_goals,
                       update_to_ready_s=t_startup - t_update)
        booted = leader.boot_ready().get(timeout=600)
        t_boot = time.monotonic()
        served, latency = [], []
        for _ in range(REQUESTS):
            t_req = time.monotonic()
            served.append(requester.request(2, prompt[0].tolist(), args.gen,
                                            timeout=300))
            latency.append(time.monotonic() - t_req)
        refused = {}
        for node in ((0, 1) if refusals else ()):
            t_req = time.monotonic()
            try:
                requester.request(node, prompt[0].tolist(), args.gen,
                                  timeout=60)
            except RuntimeError as e:  # the refusal under test
                refused[node] = {"text": str(e),
                                 "latency_s": time.monotonic() - t_req}
            check(node in refused, f"node {node} served a request")
        return {  # ...and are read here
            **_window(fa, dq),
            "sink": dict(sink),
            "update": upd,
            "refused": refused,
            "faults": {i: dict(links[i].stats) for i in (faults or {})},
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


def _sink_record(out):
    """What dest 2's layer sink placed in the reassembly buffers and what
    bounced, with the round's striped and placed frames into dest 2 (the
    transport's link table)."""
    rows = [row for key, row in out["links"].items()
            if "#" not in key and key.endswith("->2")]
    sink = out["sink"]
    return dict(sink, bounced_bytes=sink["declined_bytes"],
                rx_bytes=sum(r.get("rx_bytes", 0) for r in rows),
                rx_frames=sum(r.get("rx_frames", 0) for r in rows),
                rx_placed_frames=sum(r.get("rx_placed_frames", 0)
                                     for r in rows),
                striped_frames=sum(r.get("rx_stripe_frames", 0)
                                   for r in rows),
                placed_share=sink["placed_bytes"] / max(
                    1, sink["placed_bytes"] + sink["declined_bytes"]))


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
    sink = _sink_record(out)
    check(sink["placed"] > 0, f"the layer sink never engaged: {sink}")
    if not without_xxhash:
        fab["sink"] = sink  # phase 18 (a)

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
         sink=sink, precompile=[rec for rec, _ in warm],
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


# ------------------------------------------------------------ phase 11

SWAP_BASES = {"v2": 1000, "v3": 2000}  # layer ids of each version's blobs
SWAP_SOAK_S = 2.0  # serving on after each flip is confirmed
SWAP_REQUESTER = 9


class _LogTap:
    """The port's JSON log stream, passed through, keeping the records
    whose message names the swap (the controller's prepare and flip
    records carry ``prepare_ms`` and ``flip_ms``)."""

    def __init__(self, inner):
        self.inner = inner
        self.records = []

    def write(self, line):
        if '"swap' in line:
            for part in line.splitlines():
                try:
                    rec = json.loads(part)
                except ValueError:
                    continue
                if isinstance(rec, dict) and str(
                        rec.get("message", "")).startswith("swap"):
                    self.records.append(rec)
        return self.inner.write(line)

    def flush(self):
        self.inner.flush()


def _seeded_tree_equal(cfg, serde, params, seed):
    """Every leaf of a served tree against ``seed``'s leaves drawn on the
    card, bit for bit, one blob at a time."""
    import torch

    head = serde.head_blob_id(cfg)
    for lid in range(head + 1):
        for name, t in serde.seeded_leaves(cfg, lid, seed, "cuda").items():
            got = params[name] if lid == head else params["layers"][name][lid]
            check(got.dtype == t.dtype and got.device == t.device
                  and torch.equal(got.view(torch.int16), t.view(torch.int16)),
                  f"served seed-{seed} blob {lid} leaf {name} != seeded leaf")


def _latency(rows):
    """Count, p50 and max of the (start, end, ids) rows' latency, in ms."""
    ms = sorted((e - s) * 1e3 for s, e, _ in rows)
    if not ms:
        return {"n": 0, "p50_ms": None, "max_ms": None}
    return {"n": len(ms), "p50_ms": statistics.median(ms), "max_ms": ms[-1]}


def _max_gap_ms(rows, t0, t1):
    """The longest time between two answers that end in [t0, t1], the
    window's edges counted as answers."""
    ends = [t0] + sorted(e for _, e, _ in rows if t0 <= e <= t1) + [t1]
    return max(b - a for a, b in zip(ends, ends[1:])) * 1e3


def phase_swap(cfg, args, fa, fab, prompt):
    """The zero-downtime swap on the card (module docstring, phase 11).
    Returns K1's launches in the phase, by kernel."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc, SourceType)
    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)
    from distributed_llm_dissemination_tpu_torch.parallel.ingest import (
        hbm_headroom_bytes)
    from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
        assignment_to_placement)
    from distributed_llm_dissemination_tpu_torch.runtime import (
        FlowRetransmitLeaderNode, FlowRetransmitReceiverNode, Node)
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester)
    from distributed_llm_dissemination_tpu_torch.transport.tcp import (
        TcpTransport)
    from distributed_llm_dissemination_tpu_torch.utils import trace
    from distributed_llm_dissemination_tpu_torch.utils.logging import log

    t_phase = time.monotonic()
    head = serde.head_blob_id(cfg)
    ids = list(range(head + 1))
    head_bytes = serde.blob_nbytes(cfg, head)
    seeds = {"v1": args.seed, "v2": args.seed + 1, "v3": args.seed + 2}
    blobs = {"v1": fab["blobs"]}
    t0 = time.monotonic()
    for v in ("v2", "v3"):
        blobs[v] = fabricate(cfg, serde, seeds[v])[0]
    fabricate_s = time.monotonic() - t0
    # Each version's greedy ids from a direct generate on its params,
    # through K1, before the counted run.
    want = {}
    for v in ("v1", "v2", "v3"):
        params = card_params(cfg, serde, seeds[v], blobs[v])
        want[v] = generate(params, prompt, cfg, args.gen)[0].tolist()
        del params
    check(want["v1"] == fab["tokens"],
          f"v1's direct ids {want['v1']} != phase 3's {fab['tokens']}")
    check(len({tuple(t) for t in want.values()}) == 3,
          f"the three versions' ids are not pairwise distinct: {want}")
    gc.collect()
    torch.cuda.empty_cache()

    def holdings():
        # Leader and seeder share one host copy of each version's blobs.
        out = {}
        for v, base in (("v1", 0), ("v2", SWAP_BASES["v2"]),
                        ("v3", SWAP_BASES["v3"])):
            for lid in ids:
                out[base + lid] = LayerSrc(
                    inmem_data=blobs[v][lid], data_size=len(blobs[v][lid]),
                    meta=LayerMeta(location=LayerLocation.INMEM,
                                   source_type=SourceType.MEM))
        return out

    assignment = {2: {lid: LayerMeta() for lid in ids}}
    placement = assignment_to_placement(assignment)  # one card, one stage
    nic = {0: SEEDER_NIC, 1: SEEDER_NIC, 2: DEST_NIC}
    os.environ["DLD_BOOT_DONATE"] = "0"  # v1's staged blobs stay checkable
    ts = {i: TcpTransport("127.0.0.1:0") for i in (0, 1, 2, SWAP_REQUESTER)}
    for t in ts.values():
        t.addr_registry.update({i: u.addr for i, u in ts.items()})
    threads_before = set(threading.enumerate())
    tap = _LogTap(log.stream)
    log.stream = tap
    trace.reset_run()
    fa.reset_counts()  # the phase's K1 counts start here
    leader = FlowRetransmitLeaderNode(Node(0, 0, ts[0]), holdings(),
                                      assignment, nic, expected_nodes={1, 2})
    seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), holdings())
    dest = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {}, stage_hbm=True,
                                      placement=placement, boot_cfg=cfg)
    requester = GenRequester(ts[SWAP_REQUESTER], my_id=SWAP_REQUESTER)
    plist = prompt[0].tolist()
    rows, failures = [], []  # rows: (start, end, ids) of each answer
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            t_req = time.monotonic()
            try:
                got = requester.request(2, plist, args.gen, timeout=120)
            except Exception as e:  # noqa: BLE001 -- every failure counts
                failures.append(repr(e))
                continue
            rows.append((t_req, time.monotonic(), got))

    def wait_for(cond, what, timeout_s=300.0):
        deadline = time.monotonic() + timeout_s
        while not cond():
            check(time.monotonic() < deadline, f"timed out waiting for {what}")
            time.sleep(0.005)
        return time.monotonic()

    legs = {}
    hammer_t = threading.Thread(target=hammer, name="swap-hammer",
                                daemon=True)
    try:
        seeder.announce()
        dest.announce()
        leader.start_distribution().get(timeout=300)
        leader.ready().get(timeout=600)
        check(set(leader.boot_ready().get(timeout=600)) == {2}, "v1 boot")
        check(requester.request(2, plist, args.gen, timeout=120)
              == want["v1"], "v1 does not serve its direct ids")
        hammer_t.start()
        t_prev = time.monotonic()
        time.sleep(1.0)  # answers before the first swap
        for v, prev in (("v2", "v1"), ("v3", "v2")):
            leg = {}
            if v == "v3":
                # Leg B: what both probes read once v1's tree is released
                # (the allocator keeps its blocks), then the factor that
                # stages the head blob on the host and the layer blobs on
                # the card.
                gc.collect()
                probe = hbm_headroom_bytes()
                leg["headroom_mem_get_info"] = torch.cuda.mem_get_info()[0]
                leg["headroom_probe"] = probe
                dest.swap.HEADROOM_FACTOR = 1.01 * probe / head_bytes
                leg["headroom_factor"] = dest.swap.HEADROOM_FACTOR
            counters = dict(trace.counter_totals())
            torch.cuda.reset_peak_memory_stats()
            base = SWAP_BASES[v]
            t_submit = time.monotonic()
            leader.submit_job(
                f"swap-{v}", {2: {base + lid: LayerMeta() for lid in ids}},
                priority=2, kind="swap", version=v, swap_base=base)
            t_commit = wait_for(lambda: leader.swap_table().get(v, {}).get(
                "State") == "committed", f"{v} committed at the leader")
            t_flip = wait_for(lambda: dest.serving_version == v,
                              f"{v} serving at the dest")
            t_confirm = wait_for(
                lambda: 2 in leader.swap_table()[v]["Confirmed"],
                f"{v}'s flip confirmed at the leader")
            peak = torch.cuda.max_memory_allocated()
            time.sleep(SWAP_SOAK_S)
            t_end = time.monotonic()
            totals = trace.counter_totals()
            delta = {k: totals.get(k, 0) - counters.get(k, 0)
                     for k in ("swap.flips", "swap.committed",
                               "swap.staging_failed", "swap.aborts")}
            check(delta["swap.flips"] == 1 and delta["swap.committed"] == 1,
                  f"{v}: swap counters {delta}")
            check(delta["swap.staging_failed"] == 0
                  and delta["swap.aborts"] == 0, f"{v}: {delta}")
            job = leader.jobs.table()[f"swap-{v}"]
            check(job["State"] == "done" and job["DroppedPairs"] == 0,
                  f"{v}: job row {job}")
            rec = dest.swap._versions[v]
            host_slots = sorted(rec["host_slots"])
            check(rec["state"] == "committed", f"{v}: dest state {rec}")
            check(v == "v2" or host_slots, "leg B staged no blob on the host")
            _seeded_tree_equal(cfg, serde, dest.boot_result.params,
                               seeds[v])
            swap_recs = [r for r in tap.records if r.get("version") == v]
            prep = [r for r in swap_recs if "prepare_ms" in r]
            flip = [r for r in swap_recs if "flip_ms" in r]
            check(len(prep) == 1 and len(flip) == 1,
                  f"{v}: {len(prep)} prepare and {len(flip)} flip records")
            # Answers by when they ended: since the last flip and before
            # the submit, during the staging (submit to flip), and begun
            # after the flip.
            before = [r for r in rows if r[0] >= t_prev and r[1] <= t_submit]
            staging = [r for r in rows if t_submit < r[1] <= t_flip]
            after = [r for r in rows if r[0] >= t_flip and r[1] <= t_end]
            check(after, f"{v}: no answer after the flip")
            for r in after:
                check(r[2] == want[v],
                      f"{v}: an answer after the flip is not {v}'s ids")
            for r in rows:
                check(r[2] in want.values(),
                      f"an answer is no version's ids: {r[2]}")
            for r in staging:
                check(r[2] in (want[prev], want[v]),
                      f"{v}: an answer during staging is neither "
                      f"{prev}'s nor {v}'s ids")
            leg.update(
                ttd_commit_s=t_commit - t_submit,
                ttd_confirm_s=t_confirm - t_submit,
                flip_seen_s=t_flip - t_submit,
                prepare_ms=prep[0]["prepare_ms"], flip_ms=flip[0]["flip_ms"],
                host_staged_blobs=prep[0]["host_staged_blobs"],
                host_slots=host_slots,
                latency_before=_latency(before),
                latency_staging=_latency(staging),
                latency_after=_latency(after),
                max_gap_ms=_max_gap_ms(rows, t_submit, t_end),
                max_memory_allocated=peak,
                bytes=sum(len(b) for b in blobs[v].values()))
            legs[v] = leg
            t_prev = t_flip
        stop.set()
        hammer_t.join(timeout=180)
        check(not hammer_t.is_alive(), "the request thread did not end")
        check(not failures, f"requests failed: {failures[:3]}")
        for lid in ids:  # v1's blobs in the dest's store, unchanged
            src = dest.layers[lid]
            check(bytes(src.inmem_data[:src.data_size]) == blobs["v1"][lid],
                  f"v1 blob {lid} changed in the dest's store")
            check(src.device_array is not None and torch.equal(
                src.device_array,
                torch.frombuffer(blobs["v1"][lid], dtype=torch.uint8).cuda()),
                f"v1 blob {lid} changed on the device")
        launches = dict(fa.launches_by_kernel)
        plain = fa.plain_calls
    finally:
        stop.set()
        log.stream = tap.inner
        requester.close()
        leader.close()
        seeder.close()
        dest.close()
        for t in ts.values():
            t.close()
        hammer_t.join(timeout=180)
        _join_round_threads(threads_before)
        os.environ.pop("DLD_BOOT_DONATE", None)
    check(launches["prefill"] > 0 and launches["decode"] > 0,
          f"K1 launches in the phase {launches}")
    check(plain == 0, f"{plain} plain attention calls on the card")
    emit("swap", config=cfg.name, transport="tcp loopback",
         versions={v: {"seed": s, "swap_base": SWAP_BASES.get(v, 0)}
                   for v, s in seeds.items()},
         fabricate_v2_v3_s=fabricate_s, requests=len(rows),
         failed_requests=len(failures), ids_distinct=True,
         legs=legs, attention_launches_by_kernel=launches,
         attention_plain_calls=plain,
         phase_wall_s=time.monotonic() - t_phase)
    return launches


# ------------------------------------------------------------ phase 8

CODEC_REPLACES = {
    "int8": "distributed_llm_dissemination_tpu/models/quant.py:276",
    "int4": "distributed_llm_dissemination_tpu/models/quant.py:305"}
NEGOTIATED_CONFIG = "llama3-8b-d4v8k"  # llama3-8b-d4's layers, 8192-token head
# ...cut to this depth, so the script stays within its time (the round's
# host encode on send is linear in the layers).
NEGOTIATED_LAYERS = 2
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


def _to_card(data, shift=0, device="cuda"):
    """A wire blob on the card, starting ``shift`` bytes into its buffer."""
    import torch

    buf = torch.empty(len(data) + shift, dtype=torch.uint8, device=device)
    buf[shift:].copy_(torch.frombuffer(data, dtype=torch.uint8))
    return buf[shift:]


def codec_kernel_case(dq, quant, kind, name, data, specs, dtype, shift=0,
                      timed=False, device="cuda"):
    """K2/K3 (``kind``) against its plain version on the card on one wire
    blob, bit for bit.  ``timed``: also the kernel's and the plain
    version's device ms per call (CUDA-graph replay) and the bytes bound.
    ``device``: the card the blob lies on.  Returns (record, the kernel's
    leaves)."""
    import torch

    table = quant.leaf_table(kind, specs, dtype)
    blob = _to_card(data, shift, device)
    kern = [torch.empty(leaf.shape, dtype=dtype, device=device)
            for leaf in table]
    plain = [torch.empty_like(k) for k in kern]
    ref = getattr(dq, f"dequant_{kind}_ref")
    dq.dequant(kind, blob, table, kern)
    ref(blob, table, plain)
    torch.cuda.synchronize(blob.device)
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
    ncfg = dataclasses.replace(CONFIGS[NEGOTIATED_CONFIG],
                               name=f"{NEGOTIATED_CONFIG}-d{NEGOTIATED_LAYERS}",
                               n_layers=NEGOTIATED_LAYERS)
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
    # Phase 12's int8 fabric round serves the same wire blobs, phase 18's
    # int4 round the int4 ones.
    fab["int8"] = {"wire": wire["int8"],
                   "ids": rounds["int8"]["record"]["served_ids"]}
    fab["int4"] = {"wire": wire["int4"]}
    emit("codec", rounds={k: r["record"] for k, r in rounds.items()},
         negotiated=negotiated, phase_wall_s=time.monotonic() - t_phase)
    return {kind: {"launches": rounds[kind]["launches"],
                   "f16_launches": rounds[kind]["f16_launches"],
                   "layer": stats[kind]["layer"], "head": stats[kind]["head"],
                   "layer_f16": stats[kind]["layer_f16"]}
            for kind in dq.KINDS}


# ------------------------------------------------------------ phase 12

FABRIC_CUT = 2  # layer blobs on dest 3 in the main partition (the rest on 4)
FABRIC_UNEVEN_CUT = 3  # the uneven partition (3/1 of llama3-8b-d4's 4)
FABRIC_SHARDS = 4  # gather_byte_shards leg: shards of layer blob 0, int8


def fabric_conf_dict(model, seed, sizes, cut, codec="raw", leader=0):
    """Phase 12's topology as JSON: leader ``leader`` (no layers), seeders
    1 and 2 holding every blob (``sizes``: blob id -> bytes), dest 3
    assigned the first ``cut`` layer blobs and dest 4 the rest with the
    head; a ``nodes`` mesh axis of one slot per node.  The dests' NIC is
    twice a seeder's, as phase 6's, so the max-flow plan may need both
    seeders."""
    held = {"2": {str(lid): {"LayerSize": n} for lid, n in sizes.items()}}
    head = max(sizes)
    nodes = [{"Id": leader, "Addr": str(leader), "IsLeader": True,
              "NetworkBW": SEEDER_NIC, "InitialLayers": {}}]
    nodes += [{"Id": i, "Addr": str(i), "NetworkBW": SEEDER_NIC,
               "InitialLayers": held} for i in (1, 2)]
    nodes += [{"Id": i, "Addr": str(i), "NetworkBW": DEST_NIC,
               "InitialLayers": {}} for i in (3, 4)]
    d = {"Model": model, "ModelSeed": seed, "Nodes": nodes,
         "Assignment": {"3": {str(b): {} for b in range(cut)},
                        "4": {str(b): {} for b in range(cut, head + 1)}},
         "Mesh": {"AxisNames": ["nodes"], "AxisSizes": [len(nodes)],
                  "PipelineAxis": "nodes", "Fabric": True}}
    if codec != "raw":
        d["ModelCodec"] = codec
    return d


def fabric_conf(cfg, args, blobs, cut, codec="raw", leader=0):
    """``fabric_conf_dict`` of ``blobs`` as ``cli.podrun`` reads it."""
    from distributed_llm_dissemination_tpu_torch.core import config as cfg_mod

    return cfg_mod.Config.from_json(fabric_conf_dict(
        cfg.name, args.seed, {lid: len(b) for lid, b in blobs.items()}, cut,
        codec, leader))


def fabric_round(cfg, args, fa, prompt, blobs, cut, codec="raw", hook=None,
                 leader=0, device="cuda:0"):
    """One ``cli.podrun.run_pod`` of phase 12's topology: seeders 1 and 2
    hold ``blobs`` (one shared host copy), ``--gen`` greedy tokens after
    ``prompt``.  ``device``: where the mesh slots run (phase 12: every
    slot on card 0; phase 16b: None, the host's cards in order).  Every
    message the in-memory transport carries is recorded; the kernel
    counts and trace counters are zeroed just before the run and read
    when ``hook`` is called, before the nodes close.  ``hook(leader,
    receivers, placement)`` returns extra fields for the result."""
    import torch

    from distributed_llm_dissemination_tpu_torch.cli.podrun import run_pod
    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc, SourceType)
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.transport import inmem
    from distributed_llm_dissemination_tpu_torch.utils import telemetry, trace

    def holdings():
        return {lid: LayerSrc(inmem_data=b, data_size=len(b),
                              meta=LayerMeta(location=LayerLocation.INMEM,
                                             source_type=SourceType.MEM))
                for lid, b in blobs.items()}

    sent, plans = [], []
    real_send = inmem.InmemTransport.send

    def spy(self, dest, msg):
        kind = type(msg).__name__
        sent.append(kind)
        if kind == "DevicePlanMsg" and all(p.plan_id != msg.plan_id
                                           for p in plans):
            plans.append(msg)  # once, not once per participant
        return real_send(self, dest, msg)

    out = {}

    def on_delivered(leader, receivers, placement):
        out.update(counts={
            "attention": dict(fa.launches_by_kernel),
            "attention_plain": fa.plain_calls,
            "attention_by_device": {d: dict(n) for d, n in
                                    fa.launches_by_device.items()},
            "dequant": dict(dq.launches_by_kernel),
            "dequant_plain": dict(dq.plain_calls),
            "dequant_by_device": {d: dict(n) for d, n in
                                  dq.launches_by_device.items()},
            "counters": trace.counter_totals(),
            "phases": trace.phase_totals(),
            "peak": torch.cuda.max_memory_allocated(),
            "peak_by_card": {
                f"cuda:{k}": torch.cuda.max_memory_allocated(k)
                for k in range(torch.cuda.device_count())}})
        dests = {r.node.my_id: r for r in receivers if r.node.my_id in (3, 4)}
        out.update(dests=dests, leader=leader, placement=placement,
                   warm={i: [rec for rec, _ in r.precompile_records]
                         for i, r in dests.items()})
        if hook is not None:
            out.update(hook(leader, receivers, placement))

    threads_before = set(threading.enumerate())
    gc.collect()
    torch.cuda.empty_cache()
    for k in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(k)
    inmem.InmemTransport.send = spy
    telemetry.reset_run()
    trace.reset_run()
    fa.reset_counts()
    dq.reset_counts()  # the round's counts start here
    try:
        summary = run_pod(fabric_conf(cfg, args, blobs, cut, codec, leader),
                          mode=3, timeout=600, gen=args.gen,
                          prompt=prompt[0].tolist(),
                          initial_layers={1: holdings(), 2: holdings()},
                          on_delivered=on_delivered, device=device)
    finally:
        inmem.InmemTransport.send = real_send
        out.pop("dests", None)
        out.pop("leader", None)
        _join_round_threads(threads_before)
    out.update(summary=summary, sent=sent, plans=plans)
    return out


def _fabric_checks(fa, cfg, args, out, blobs, cut, both_seeders=False):
    """What every phase-12 round must show: no layer byte on the
    transport, a plan per blob from the seeders only, every fallback
    counter at 0, both stage boots on the card, K1 launches as the warm-up,
    the stage boots, the pipelined forward and the decode need, and the
    plain attention never."""
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        BOOT_TOKENS)

    kinds = set(out["sent"])
    check("LayerMsg" not in kinds, "a LayerMsg crossed the transport")
    check(out["counts"]["counters"].get("fabric.upload_bytes", 0) > 0,
          "no seeder uploaded to the fabric")
    planned = {m.layer_id for m in out["plans"]}
    check(planned == set(blobs), f"plans for {sorted(planned)}")
    senders = {s for m in out["plans"] for s, _, _ in m.layout}
    check(senders == {1, 2} if both_seeders else senders <= {1, 2},
          f"plan senders {sorted(senders)}")
    for m in out["plans"]:
        pos = 0
        for _, off, size in sorted(m.layout, key=lambda x: x[1]):
            check(off == pos, f"plan {m.plan_id} does not tile")
            pos += size
        check(pos == len(blobs[m.layer_id]), f"plan {m.plan_id} short")
    fallbacks = {k: v for k, v in out["counts"]["counters"].items()
                 if k.startswith("fallback.")
                 or k == "shard.gather_host_fallback"}
    check(not any(fallbacks.values()), f"fallbacks fired: {fallbacks}")
    for i, depth in ((3, cut), (4, cfg.n_layers - cut)):
        res = out["boots"][i]
        check(res["kind"] == "stage" and res["device"].startswith("cuda"),
              f"dest {i} booted {res}")
        check(res["layers"] == depth, f"dest {i} booted {res['layers']}")
    g = cfg.n_heads // cfg.n_kv_heads
    L = cfg.n_layers
    want = {name: 0 for name in fa.SOURCES}
    for recs in out["warm"].values():
        for rec in recs:
            # One launch per warmed attention shape ("attention:<kernel>:
            # ..."): the record's launch diff would also count the other
            # dest's warm-up, which runs at the same time in this process.
            for entry in rec["compiled"]:
                if entry.startswith("attention:"):
                    want[entry.split(":")[1]] += 1
    want[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += L  # stage boots
    want[fa.kernel_for(args.prompt, g, cfg.dtype)] += 2 * L  # fwd + prefill
    want[fa.kernel_for(1, g, cfg.dtype)] += (args.gen - 1) * L
    check(out["counts"]["attention"] == want,
          f"fabric attention launches {out['counts']['attention']} != {want}")
    check(out["counts"]["attention_plain"] == 0,
          "the plain attention ran on the fabric path")
    check(out["summary"]["tokens"] is not None
          and len(out["summary"]["tokens"]) == args.gen, "pod decode ids")
    return want


def phase_fabric(cfg, args, fa, fab, prompt, raw_ttd_s):
    """The single-controller device fabric on the card (module docstring,
    phase 12).  Returns the K1 launches of its raw round and the K2
    launches of its int8 round."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import quant, serde
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.parallel import collectives
    from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
        device_slots)
    from distributed_llm_dissemination_tpu_torch.runtime.pp_serve import (
        assemble_pp_params, pod_decode, pod_forward)
    from distributed_llm_dissemination_tpu_torch.utils import integrity, trace

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    total = sum(len(b) for b in blobs.values())
    ttol = 0.1, 0.02  # tests/test_torch_model.py: LOGIT_ATOL, LOGIT_MEAN_ATOL

    def boots(receivers):
        return {r.node.my_id: {
            "kind": r.boot_result.kind, "layers": len(r.boot_result.layer_ids),
            "device": str(next(iter(r.boot_result.params.values())).device),
            "via": r.boot_result.via}
            for r in receivers if r.node.my_id in (3, 4)}

    def main_hook(leader, receivers, placement):
        dests = {r.node.my_id: r for r in receivers if r.node.my_id in (3, 4)}
        # Every delivered blob on its dest's stage slot, byte-exact, and
        # its digest the seeded blob's.
        exact, digests = 0, 0
        for i, r in dests.items():
            for lid in placement.layer_to_stage:
                if placement.layer_to_stage[lid] != placement.node_to_stage[i]:
                    continue
                src = r.layers[lid]
                arr = src.device_array
                check(arr is not None and arr.device.type == "cuda",
                      f"blob {lid} not on the card at dest {i}")
                check(arr.devices() == set(placement.devices_for_node(i)),
                      f"blob {lid} on slots {arr.devices()}")
                host = torch.frombuffer(blobs[lid], dtype=torch.uint8)
                check(torch.equal(arr, host.to(arr.device)),
                      f"blob {lid} not byte-exact at dest {i}")
                exact += 1
                got = integrity.layer_digest(arr.cpu().numpy())
                check(got == integrity.layer_digest(blobs[lid]),
                      f"blob {lid} digest {got}")
                digests += 1
        results = {r.node.my_id: r.boot_result for r in receivers}
        stores = {i: r.layers for i, r in dests.items()}
        assembled = assemble_pp_params(cfg, placement, results, stores)
        check(assembled[3]["embed"].device.type == "cuda",
              "the pod's head is not on the card")
        # The pipelined forward of the prompt against phase 3's direct
        # forward of the same params, and warm timings.
        logits, _ = pod_forward(cfg, placement, results, stores, prompt,
                                assembled=assembled)
        diff = (logits.float().cpu() - fab["logits"]).abs()
        check(bool(torch.isfinite(logits).all()), "non-finite pod logits")
        check(float(diff.max()) < ttol[0] and float(diff.mean()) < ttol[1],
              f"pod logits differ by {float(diff.max())} (mean "
              f"{float(diff.mean())})")
        return {"boots": boots(receivers), "exact": exact,
                "digests": digests, "logit_max_diff": float(diff.max()),
                "logit_mean_diff": float(diff.mean()),
                "assembled": (placement, assembled)}

    out = fabric_round(cfg, args, fa, prompt, blobs, FABRIC_CUT,
                       hook=main_hook)
    want = _fabric_checks(fa, cfg, args, out, blobs, FABRIC_CUT,
                          both_seeders=True)
    # Warm serving of the assembled pipeline once the pod's nodes have
    # closed (their control threads would share the interpreter with the
    # host-bound decode loop), as phase 3 times a direct serve.
    placement, assembled = out.pop("assembled")
    fwd = sorted(pod_forward(cfg, placement, {}, {}, prompt,
                             assembled=assembled)[1] for _ in range(REPEATS))
    one = sorted(pod_decode(cfg, placement, {}, {}, 1, prompt,
                            assembled=assembled)[1] for _ in range(REPEATS))
    full = sorted(pod_decode(cfg, placement, {}, {}, args.gen, prompt,
                             assembled=assembled)[1] for _ in range(REPEATS))
    out["warm_forward_s"] = fwd
    out["warm_decode_ms_per_token"] = sorted(
        (f - statistics.median(one)) / (args.gen - 1) * 1e3 for f in full)
    del placement, assembled
    summary = out["summary"]
    check(out["exact"] == len(blobs) and out["digests"] == len(blobs),
          f"{out['exact']} blobs byte-exact of {len(blobs)}")
    check(summary["tokens"] == fab["tokens"],
          f"pod ids {summary['tokens']} != phase 3's {fab['tokens']}")
    phases = out["counts"]["phases"]
    up = phases.get("fabric_upload", {"ms": 0.0, "n": 0})
    upload_bytes = out["counts"]["counters"].get("fabric.upload_bytes", 0)
    raw = dict(
        ttd_s=summary["ttd_s"], ttd_tcp_round_s=raw_ttd_s,
        predicted_s=summary.get("predicted_s"),
        ttft_s=summary.get("ttft_s"),
        upload_bytes=upload_bytes, uploads=up["n"],
        upload_ms_summed=up["ms"],  # concurrent uploads overlap
        upload_gbps_per_upload=upload_bytes / max(up["ms"], 1e-9) / 1e6,
        upload_gbps_over_ttd=upload_bytes / summary["ttd_s"] / 1e9,
        finalize_splice_ms=phases.get("splice", {}).get("ms"),
        finalize_window_ms=phases.get("collective", {}).get("ms"),
        dest_write_ms=phases.get("upload", {}).get("ms"),
        pod_forward_first_s=summary.get("pod_forward_s"),
        pod_forward_warm_after_close_s=out["warm_forward_s"],
        pod_decode_first_s=summary.get("pod_decode_s"),
        pod_decode_ms_per_token_warm_after_close=out[
            "warm_decode_ms_per_token"],
        direct_decode_ms_per_token=fab["serve_ms"]["per_token"],
        peak_memory=out["counts"]["peak"],
        plans=[{"layer": m.layer_id, "dest": m.dest_id,
                "layout": [list(x) for x in m.layout],
                "batch": [m.batch_id, m.batch_n]} for m in out["plans"]],
        messages={k: out["sent"].count(k) for k in sorted(set(out["sent"]))},
        boots=out["boots"], warm_up=out["warm"],
        logit_max_diff=out["logit_max_diff"],
        logit_mean_diff=out["logit_mean_diff"],
        attention_launches=out["counts"]["attention"],
        attention_launches_expected=want,
        collective_cache=summary["collective_cache"],
        tokens=summary["tokens"])
    launches = out["counts"]["attention"]
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # The uneven 3/1 partition serves the same ids.
    out = fabric_round(cfg, args, fa, prompt, blobs, FABRIC_UNEVEN_CUT,
                       hook=lambda leader, receivers, placement:
                       {"boots": boots(receivers)})
    _fabric_checks(fa, cfg, args, out, blobs, FABRIC_UNEVEN_CUT)
    check(out["summary"]["tokens"] == fab["tokens"],
          f"3/1 pod ids {out['summary']['tokens']} != {fab['tokens']}")
    uneven = dict(ttd_s=out["summary"]["ttd_s"],
                  pod_decode_s=out["summary"].get("pod_decode_s"),
                  boots=out["boots"], peak_memory=out["counts"]["peak"])
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # One int8 ModelCodec round over the fabric: the stage boots decode
    # every wire blob through K2 (one launch each, plus each dest's
    # warm-up), and the pod serves phase 8's int8 ids.
    wire = fab["int8"]["wire"]
    out = fabric_round(cfg, args, fa, prompt, wire, FABRIC_CUT, codec="int8",
                       hook=lambda leader, receivers, placement:
                       {"boots": boots(receivers)})
    _fabric_checks(fa, cfg, args, out, wire, FABRIC_CUT)
    warm_k2 = sum(rec["launches"].get("dequant_int8", 0)
                  for recs in out["warm"].values() for rec in recs)
    k2 = out["counts"]["dequant"]["int8"]
    # Each blob once as the dest's stager lands it, and the head blob once
    # more when the pod assembles (a stage boot keeps no head leaves).
    check(k2 == len(wire) + 1 + warm_k2,
          f"K2 launches {k2} != {len(wire)} blobs + the head again + "
          f"{warm_k2} warm-up")
    check(not any(out["counts"]["dequant_plain"].values()),
          f"plain dequant ran: {out['counts']['dequant_plain']}")
    check(out["summary"]["tokens"] == fab["int8"]["ids"],
          f"int8 pod ids {out['summary']['tokens']} != phase 8's "
          f"{fab['int8']['ids']}")
    int8 = dict(ttd_s=out["summary"]["ttd_s"],
                wire_bytes=sum(len(b) for b in wire.values()),
                dequant_launches=k2, warm_up_launches=warm_k2,
                head_decoded_again_at_assembly=1,
                boots=out["boots"], pod_decode_s=out["summary"].get(
                    "pod_decode_s"), peak_memory=out["counts"]["peak"])
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # gather_byte_shards of layer blob 0's int8 wire form in 4 shards on
    # 4 slots of the card, decoded on the gathered tensor through K2.
    from distributed_llm_dissemination_tpu_torch.core.types import (
        shard_range, shard_specs_for)

    blob = bytes(wire[0])
    parts = [(k, blob[shard_range(s, len(blob))[0]:
                      sum(shard_range(s, len(blob)))])
             for k, s in enumerate(shard_specs_for(FABRIC_SHARDS))]
    trace.reset_run()
    dq.reset_counts()
    t0 = time.monotonic()
    got, leaves = collectives.gather_byte_shards(
        parts, len(blob), verify_digest=integrity.layer_digest(blob),
        codec="int8", decode=(cfg, 0), devices=device_slots(FABRIC_SHARDS))
    torch.cuda.synchronize()
    gather_s = time.monotonic() - t0
    check(got == blob, "gathered wire bytes differ")
    check(trace.counter_totals().get("pod.device_dequants", 0) == 1,
          "pod.device_dequants did not rise by one")
    check(dq.launches_by_kernel["int8"] == 1 and not dq.plain_calls["int8"],
          f"gather decode launches {dict(dq.launches_by_kernel)}")
    host = quant.decode_blob_host(cfg, 0, blob, "int8")
    for name, _ in serde.blob_specs(cfg, 0):
        a, b = leaves[name][0], host[name]
        check(a.device.type == "cuda", f"leaf {name} not on the card")
        check(torch.equal(a.cpu().view(torch.int16), b.view(torch.int16)),
              f"gathered leaf {name} differs from the host decode")
    emit("fabric", config=cfg.name, card=nvidia_smi(), nodes=5,
         mesh={"nodes": 5}, bytes=total, raw=raw, uneven_3_1=uneven,
         int8=int8, gather=dict(shards=FABRIC_SHARDS, wire_bytes=len(blob),
                                seconds=gather_s, device_dequants=1,
                                leaves_equal_host_decode=True),
         phase_wall_s=time.monotonic() - t_phase)
    return launches, k2 + 1


# ------------------------------------------------------------ phase 13

POD_DESTS = (3, 4)  # one pod: both assigned every blob
POD_REQUESTER = 9


def _pod_want_launches(fa, cfg, args, warm_recs):
    """K1 launches of a pod round, by kernel: each dest's warm-up (its
    records' compiled attention shapes: two warm-ups at once in one
    process share the counters), its full boot's forward, and one served
    request (a prefill and ``gen - 1`` decode steps)."""
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        BOOT_TOKENS)

    g = cfg.n_heads // cfg.n_kv_heads
    L = cfg.n_layers
    want = {name: 0 for name in fa.SOURCES}
    for rec in warm_recs:
        for entry in rec["compiled"]:
            if entry.startswith("attention:"):
                want[entry.split(":")[1]] += 1
    n = len(POD_DESTS)
    want[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += n * L
    want[fa.kernel_for(args.prompt, g, cfg.dtype)] += n * L
    want[fa.kernel_for(1, g, cfg.dtype)] += n * (args.gen - 1) * L
    return want


def pod_round(cfg, args, fa, prompt, blobs, wire=None):
    """One mode-3 pod round over loopback TCP in this process: leader 0
    and seeder 1 hold the raw ``blobs`` (one host copy), dests 3 and 4
    form pod 0 on the in-process ``FabricPlane`` and boot on the card,
    requester seat 9 asks each dest once.  ``wire``: phase 8's int8 wire
    blobs; then every node negotiates ``WireCodec`` int8 (the threshold
    above every modelled link) and the senders' planes start out holding
    those encodes, so no encode runs in the round.  Every
    ``gather_byte_shards`` call is timed.  The kernel counts are zeroed
    just before and read just after."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.core.types import (
        LayerLocation, LayerMeta, LayerSrc, SourceType)
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq
    from distributed_llm_dissemination_tpu_torch.parallel import collectives
    from distributed_llm_dissemination_tpu_torch.parallel.fabric import (
        FabricPlane)
    from distributed_llm_dissemination_tpu_torch.runtime import (
        FlowRetransmitLeaderNode, FlowRetransmitReceiverNode, Node)
    from distributed_llm_dissemination_tpu_torch.runtime.client import (
        GenRequester)
    from distributed_llm_dissemination_tpu_torch.runtime.codec import (
        WireCodecPlane)
    from distributed_llm_dissemination_tpu_torch.transport.tcp import (
        TcpTransport)
    from distributed_llm_dissemination_tpu_torch.utils import (
        telemetry, trace)

    ids = sorted(blobs)

    def holdings():
        return {lid: LayerSrc(inmem_data=blobs[lid], data_size=len(blobs[lid]),
                              meta=LayerMeta(location=LayerLocation.INMEM,
                                             source_type=SourceType.MEM))
                for lid in ids}

    def plane(sender):
        if wire is None:
            return None
        p = WireCodecPlane(cfg, wire_codec="int8")
        if sender:
            p.cache_budget = 1 << 40
            for lid in ids:
                p._cache[(lid, "int8")] = wire[lid]
                p._sizes[(lid, "int8")] = len(wire[lid])
                p._cache_bytes += len(wire[lid])
        return p

    gathers = []
    real_gather = collectives.gather_byte_shards

    def timed_gather(*a, **k):
        t0 = time.monotonic()
        try:
            return real_gather(*a, **k)
        finally:
            gathers.append(time.monotonic() - t0)

    assignment = {d: {lid: LayerMeta() for lid in ids} for d in POD_DESTS}
    nic = {0: SEEDER_NIC, 1: SEEDER_NIC,
           **{d: DEST_NIC for d in POD_DESTS}}
    os.environ["DLD_BOOT_DONATE"] = "0"
    if wire is not None:
        os.environ["DLD_CODEC_MIN_RATE"] = str(NEGOTIATE_MIN_RATE)
    ts = {i: TcpTransport("127.0.0.1:0")
          for i in (0, 1, *POD_DESTS, POD_REQUESTER)}
    for t in ts.values():
        t.addr_registry.update({i: u.addr for i, u in ts.items()})
    board = FabricPlane()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    threads_before = set(threading.enumerate())
    telemetry.reset_run()
    trace.reset_run()
    collectives.gather_byte_shards = timed_gather
    fa.reset_counts()
    dq.reset_counts()  # the round's counts start here
    leader = seeder = requester = None
    dests = {}
    try:
        leader = FlowRetransmitLeaderNode(
            Node(0, 0, ts[0]), holdings(), assignment, nic,
            expected_nodes={1, *POD_DESTS}, fabric=board,
            pods={0: list(POD_DESTS)}, codecs=plane(True))
        seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), holdings(),
                                            codecs=plane(True))
        dests = {d: FlowRetransmitReceiverNode(
            Node(d, 0, ts[d]), {}, fabric=board, boot_cfg=cfg,
            device="cuda", codecs=plane(False)) for d in POD_DESTS}
        requester = GenRequester(ts[POD_REQUESTER], my_id=POD_REQUESTER)
        seeder.announce()
        for r in dests.values():
            r.announce()
        leader.start_distribution().get(timeout=300)
        t0 = time.monotonic()
        leader.ready().get(timeout=600)
        t_ready = time.monotonic()
        booted = leader.boot_ready().get(timeout=600)
        t_boot = time.monotonic()
        served = {d: requester.request(d, prompt[0].tolist(), args.gen,
                                       timeout=300) for d in POD_DESTS}
        return {  # ...and are read here
            "attention": dict(fa.launches_by_kernel),
            "attention_plain": fa.plain_calls,
            "dequant": dict(dq.launches_by_kernel),
            "dequant_plain": dict(dq.plain_calls),
            "counters": trace.counter_totals(),
            "phases": trace.phase_totals(),
            "links": telemetry.snapshot().get("links", {}),
            "ttd_s": t_ready - t0, "ttft_s": t_boot - t_ready,
            "gather_s": list(gathers), "booted": booted, "served": served,
            "peak": torch.cuda.max_memory_allocated(),
            "warm": [rec for r in dests.values()
                     for rec, _ in r.precompile_records],
            "res": {d: r.boot_result for d, r in dests.items()},
            "held": {d: {lid: r.layers[lid] for lid in ids}
                     for d, r in dests.items()},
            "choices": dict(leader._codec_choice),
        }
    finally:
        collectives.gather_byte_shards = real_gather
        for n in (requester, leader, seeder, *dests.values()):
            if n is not None:
                n.close()
        for t in ts.values():
            t.close()
        _join_round_threads(threads_before)
        os.environ.pop("DLD_BOOT_DONATE", None)
        os.environ.pop("DLD_CODEC_MIN_RATE", None)


def _check_pod_round(fa, cfg, args, out, sent_blobs, ids_want, codec):
    """What both pod rounds must show (module docstring, phase 13).
    ``sent_blobs``: the bytes each tree must equal (raw or wire form).
    Returns each dest's NIC ingress bytes."""
    from distributed_llm_dissemination_tpu_torch.core.types import (
        shard_range)

    ids = sorted(sent_blobs)
    nic = {}
    for k, d in enumerate(POD_DESTS):
        for lid in ids:
            src = out["held"][d][lid]
            check(src.meta.shard == "" and src.meta.codec == codec,
                  f"dest {d} holds blob {lid} as shard "
                  f"{src.meta.shard!r} codec {src.meta.codec!r}")
            check(bytes(src.inmem_data) == bytes(sent_blobs[lid]),
                  f"dest {d}'s tree of blob {lid} is not byte-exact")
        want = sum(shard_range(f"1/{len(POD_DESTS)}@{k}",
                               len(sent_blobs[lid]))[1] for lid in ids)
        got = sum(row.get("delivered_bytes", 0)
                  for key, row in out["links"].items()
                  if "#" not in key and key.endswith(f"->{d}"))
        check(got == want, f"dest {d}'s NIC carried {got} bytes, its "
                           f"shards are {want}")
        nic[d] = got
    c = out["counters"]
    n = len(POD_DESTS) * len(ids)
    for key in ("pod.pairs_planned", "pod.pairs_materialized",
                "pod.trees_materialized", "shard.gathered_layers"):
        check(c.get(key, 0) == n, f"{key} = {c.get(key, 0)}, want {n}")
    bad = {k: v for k, v in c.items()
           if k.startswith("fallback.") or k in (
               "pod.gather_degraded", "pod.collect_timeouts",
               "pod.materialize_failed", "shard.gather_host_fallback",
               "shard.gather_failed")}
    check(not any(bad.values()), f"degradations fired: {bad}")
    check(len(out["gather_s"]) == n, f"{len(out['gather_s'])} gathers")
    for d in POD_DESTS:
        res = out["res"][d]
        check(res is not None and res.kind == "full"
              and next(iter(res.params.values())).is_cuda,
              f"dest {d} did not boot on the card")
        check(out["served"][d] == ids_want,
              f"dest {d} served {out['served'][d]} != {ids_want}")
    want = _pod_want_launches(fa, cfg, args, out["warm"])
    check(out["attention"] == want,
          f"pod attention launches {out['attention']} != {want}")
    check(out["attention_plain"] == 0, "the plain attention ran")
    return nic, want


def phase_pods(cfg, args, fa, fab, prompt):
    """Pod-shard delivery in one process (module docstring, phase 13).
    Returns the K1 launches of the raw round and the K2 launches of the
    int8 round."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import quant, serde
    from distributed_llm_dissemination_tpu_torch.ops import dequant as dq

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    total = sum(len(b) for b in blobs.values())
    out = pod_round(cfg, args, fa, prompt, blobs)
    nic, want = _check_pod_round(fa, cfg, args, out, blobs, fab["tokens"],
                                 "")
    raw = dict(ttd_s=out["ttd_s"], ttft_after_ready_s=out["ttft_s"],
               nic_bytes_by_dest=nic, model_bytes=total,
               nic_fraction_by_dest={d: v / total for d, v in nic.items()},
               gather_s=out["gather_s"], gather_s_total=sum(out["gather_s"]),
               boot_s=out["booted"], peak_memory=out["peak"],
               attention_launches=out["attention"],
               attention_launches_expected=want,
               served_ids_equal_phase3=True)
    launches = out["attention"]
    del out
    gc.collect()
    torch.cuda.empty_cache()

    wire = fab["int8"]["wire"]
    wire_total = sum(len(b) for b in wire.values())
    out = pod_round(cfg, args, fa, prompt, blobs, wire=wire)
    check(all(out["choices"].get((d, lid)) == "int8"
              for d in POD_DESTS for lid in blobs),
          f"leader's codec choices {out['choices']}")
    nic, want = _check_pod_round(fa, cfg, args, out, wire,
                                 fab["int8"]["ids"], "int8")
    check(not out["counters"].get("codec.encoded_blobs", 0),
          "a sender encoded during the round")
    warm_k2 = sum(rec["launches"].get("dequant_int8", 0)
                  for rec in out["warm"])
    k2 = out["dequant"]["int8"]
    n = len(POD_DESTS) * len(wire)
    check(k2 == n + warm_k2, f"K2 launches {k2} != {n} gathered trees + "
                             f"{warm_k2} warm-up")
    check(not any(out["dequant_plain"].values()),
          f"plain dequant ran: {out['dequant_plain']}")
    ref = _plain_params(cfg, serde, dq, quant, "int8", wire)
    for d in POD_DESTS:
        _same_params(out["res"][d].params, ref)
    host0 = quant.decode_blob_host(cfg, 0, bytes(wire[0]), "int8")
    for name, t in host0.items():
        got = out["res"][POD_DESTS[0]].params["layers"][name][0]
        check(torch.equal(got.cpu().view(torch.int16), t.view(torch.int16)),
              f"booted leaf {name} of blob 0 differs from the host decode")
    int8 = dict(ttd_s=out["ttd_s"], ttft_after_ready_s=out["ttft_s"],
                nic_bytes_by_dest=nic, wire_bytes=wire_total,
                nic_fraction_by_dest={d: v / wire_total
                                      for d, v in nic.items()},
                gather_s=out["gather_s"],
                gather_s_total=sum(out["gather_s"]),
                boot_s=out["booted"], dequant_launches=k2,
                warm_up_launches=warm_k2, peak_memory=out["peak"],
                booted_params_equal_plain_decode=True,
                served_ids_equal_phase8=True)
    del out, ref
    gc.collect()
    torch.cuda.empty_cache()
    emit("pods", config=cfg.name, card=nvidia_smi(), transport="tcp loopback",
         dests=list(POD_DESTS), pod={0: list(POD_DESTS)}, bytes=total,
         raw=raw, int8=int8, phase_wall_s=time.monotonic() - t_phase)
    return launches, k2


# ------------------------------------------------------------ phase 14

SPMD_CUT = 2  # layer blobs on dest 3 (the rest on dest 4; both hold the head)
SPMD_PROMPT = 16  # the pod serve's boot prompt: zeros (ServeMsg.seq_len)
SPMD_TIMEOUT_S = 300  # any one node process


def spmd_conf(cfg, args, ports, seeders=(1, 2), dests=(3, 4)):
    """Phase 14's topology: leader 0 (no layers), ``seeders`` holding
    every blob, the first dest assigned the first ``SPMD_CUT`` layer
    blobs and the second the rest, both the head (a process serves from
    its own store); a ``nodes`` mesh axis of one stage per node,
    ``Mesh.Fabric`` and a ``Distributed`` section with an ephemeral
    coordinator (``ports[-1]``).  Phase 16c: one seeder, dests 2 and 3."""
    from distributed_llm_dissemination_tpu_torch.models import serde

    head = serde.head_blob_id(cfg)
    held = {"2": {str(i): {"LayerSize": serde.blob_nbytes(cfg, i)}
                  for i in range(head + 1)}}
    nodes = [{"Id": 0, "Addr": f"127.0.0.1:{ports[0]}", "IsLeader": True,
              "NetworkBW": SEEDER_NIC, "Sources": {"2": 0},
              "InitialLayers": {}}]
    nodes += [{"Id": i, "Addr": f"127.0.0.1:{ports[i]}",
               "NetworkBW": SEEDER_NIC, "Sources": {"2": 0},
               "InitialLayers": held} for i in seeders]
    nodes += [{"Id": i, "Addr": f"127.0.0.1:{ports[i]}",
               "NetworkBW": DEST_NIC, "Sources": {"2": 0},
               "InitialLayers": {}} for i in dests]
    first, second = dests
    return {"Model": cfg.name, "ModelSeed": args.seed,
            "LayerSize": serde.blob_nbytes(cfg, 0), "Nodes": nodes,
            "Assignment": {
                str(first): {str(b): {} for b in [*range(SPMD_CUT), head]},
                str(second): {str(b): {} for b in range(SPMD_CUT, head + 1)}},
            "Mesh": {"AxisNames": ["nodes"], "AxisSizes": [len(nodes)],
                     "PipelineAxis": "nodes", "Fabric": True},
            "Distributed": {"Coordinator": f"127.0.0.1:{ports[-1]}",
                            "CpuCollectives": "gloo"}}


def spmd_round(cfg, args, fa, blobs, work_name, seeders, dests, backend):
    """One ``cli.main`` process per node of ``spmd_conf``'s topology
    (phases 14 and 16c), logs in ``build/<work_name>/``; every check of
    phase 14, with ``backend`` the one every process must run.  Returns
    the phase's fields and the dests' K1 launches."""
    import os
    import re

    import torch

    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)
    from distributed_llm_dissemination_tpu_torch.ops.cuda_build import (
        BUILD_DIR)
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        BOOT_TOKENS)

    def libraries():
        return {p.name: p.stat().st_mtime_ns for p in BUILD_DIR.glob("*.so")}

    # The reference ids: the port's generate on the seeded params from the
    # zero boot prompt, on the card.
    params = card_params(cfg, serde, args.seed, blobs)
    zeros = torch.zeros((1, SPMD_PROMPT), dtype=torch.long, device="cuda")
    want_ids = generate(params, zeros, cfg, args.gen)[0].tolist()
    del params
    gc.collect()
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", work_name)
    os.makedirs(work, exist_ok=True)
    ids = [0, *seeders, *dests]
    ports = _free_ports(max(ids) + 2)
    conf = spmd_conf(cfg, args, ports, seeders, dests)
    conf_path = os.path.join(work, "topology.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    env = dict(os.environ, PYTHONPATH=root)
    node = [sys.executable, "-m",
            "distributed_llm_dissemination_tpu_torch.cli.main",
            "-f", conf_path, "-m", "3"]
    names = {0: "leader", **{i: f"seeder{i}" for i in seeders},
             **{i: f"dest{i}" for i in dests}}
    argv = {0: ["-gen", str(args.gen)],
            **{i: ["-boot", "none"] for i in seeders},
            **{i: [] for i in dests}}
    procs, files = {}, []
    built = libraries()
    t0 = time.monotonic()
    try:
        for i in (*dests, *seeders, 0):
            out = open(os.path.join(work, f"{names[i]}.out"), "w")
            err = open(os.path.join(work, f"{names[i]}.err"), "w")
            files.extend((out, err))
            procs[i] = subprocess.Popen(node + ["-id", str(i)] + argv[i],
                                        stdout=out, stderr=err, env=env,
                                        cwd=root)
        deadline = time.monotonic() + SPMD_TIMEOUT_S
        for i, p in procs.items():
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"chip_smoke check failed: {names[i]} "
                                   f"still running after {SPMD_TIMEOUT_S} s"
                                   ) from None
            with open(os.path.join(work, f"{names[i]}.err")) as f:
                tail = f.read()[-3000:]
            check(rc == 0, f"{names[i]} exited {rc}:\n{tail}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    wall = time.monotonic() - t0
    # The processes loaded phase 1's kernel libraries: none rebuilt or
    # replaced one.
    check(libraries() == built and built,
          f"kernel libraries changed under the processes: {built}")
    logs = {i: _log_records(os.path.join(work, f"{names[i]}.err"))
            for i in names}
    with open(os.path.join(work, "leader.out")) as f:
        leader_out = f.read()
    printed = {}
    for key, pat in (("ttd", r"Time to deliver: ([0-9.]+)s"),
                     ("ttft", r"Time to first token: ([0-9.]+)s")):
        m = re.search(pat, leader_out)
        check(m is not None, f"the leader printed no {key}: {leader_out!r}")
        printed[key] = float(m.group(1))
    for message in ("process group up", "spmd fabric up"):
        backends = {_one(recs, message, names[i])["backend"]
                    for i, recs in logs.items()}
        check(backends == {backend}, f"{message}: backends {backends}")
    devices = {names[i]: _one(recs, "spmd fabric up", names[i])["device"]
               for i, recs in logs.items()}
    head = serde.head_blob_id(cfg)
    g = cfg.n_heads // cfg.n_kv_heads
    first, second = dests
    assigned = {first: {*range(SPMD_CUT), head},
                second: {*range(SPMD_CUT, head), head}}
    members, launches = {}, {name: 0 for name in fa.SOURCES}
    on_transport = {}
    for i, recs in logs.items():
        check(not [r for r in recs
                   if "layer received" in r.get("message", "")],
              f"{names[i]} logged a layer on the transport")
        summary = _one(recs, "leader summary" if i == 0
                       else "receiver summary", names[i])
        # Layer bytes the transport carried to, from or for this process
        # (the per-job rows repeat the base rows, so only the latter).
        on_transport[names[i]] = sum(
            v for key, fields in summary["links"].items() if "#" not in key
            for k, v in fields.items() if k.endswith("_bytes"))
        fallbacks = {k: v for k, v in summary["counters"].items()
                     if k.startswith("fallback.")}
        check(not any(fallbacks.values()),
              f"{names[i]}: fallbacks fired: {fallbacks}")
        if i == 0:
            continue
        check(summary["attention_plain_calls"] == 0,
              f"{names[i]}: the plain attention ran")
        if i not in assigned:
            continue
        landed = {r["layerID"] for r in recs
                  if r.get("message") == "layer landed over device fabric"
                  and r.get("spmd") is True}
        check(landed == assigned[i], f"{names[i]} landed {sorted(landed)}")
        toks = _one(recs, "pod generated token ids", names[i])["tokens"]
        check(toks == want_ids,
              f"{names[i]} generated {toks} != generate's {want_ids}")
        dec = _one(recs, "pod decoded tokens from staged weights", names[i])
        warm = _one(recs, "boot programs precompiled during dissemination",
                    names[i])
        depth = len(assigned[i]) - 1
        want = {name: warm["launches"].get(name, 0) for name in fa.SOURCES}
        want[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += depth
        want[fa.kernel_for(SPMD_PROMPT, g, cfg.dtype)] += depth
        want[fa.kernel_for(1, g, cfg.dtype)] += (args.gen - 1) * depth
        got = summary["attention_launches_by_kernel"]
        check(got == want, f"{names[i]} launches {got} != {want}")
        # Every launch on the process's own card.
        by_dev = summary["attention_launches_by_device"]
        check(set(by_dev) == {devices[names[i]]}
              and by_dev[devices[names[i]]] == {k: n for k, n in want.items()
                                                if n},
              f"{names[i]} on {devices[names[i]]} launched {by_dev}")
        for name in fa.SOURCES:
            launches[name] += got[name]
        members[names[i]] = dict(
            layers=depth, device=devices[names[i]], decode_s=dec["seconds"],
            decode_ms_per_token=dec["seconds"] / args.gen * 1e3,
            attention_launches=got, attention_launches_by_device=by_dev,
            tokens_equal_generate=True)
    check(not any(on_transport.values()),
          f"layer bytes on the transport: {on_transport}")
    fields = dict(
        processes=len(names), backend=backend, mesh={"nodes": len(names)},
        devices=devices, ttd_s=printed["ttd"], ttft_s=printed["ttft"],
        members=members, tokens=want_ids,
        layer_bytes_on_transport=on_transport,
        peak_device_bytes={names[i]: _one(recs, "device memory",
                                          names[i])["peak_allocated_bytes"]
                           for i, recs in logs.items()},
        processes_wall_s=wall, logs=os.path.relpath(work, root),
        kernel_libraries_reused=sorted(built))
    return fields, launches


def phase_spmd(cfg, args, fa, fab):
    """The multi-controller fabric, one ``cli.main`` process per node
    (module docstring, phase 14).  Returns the dests' K1 launches."""
    t_phase = time.monotonic()
    fields, launches = spmd_round(cfg, args, fa, fab["blobs"],
                                  "chip_smoke_spmd", (1, 2), (3, 4), "gloo")
    emit("spmd", config=cfg.name, card=nvidia_smi(), **fields,
         phase_wall_s=time.monotonic() - t_phase)
    return launches


# ------------------------------------------------------------ phase 15

TTD_TIMEOUT_S = 420  # the harness child's default rows at -trials 1
TTD_SCENARIOS = ("local_4node", "reference_8node@8MiB",
                 "dcn_2slice_8node@8MiB", "pod_fabric_4node@8MiB",
                 "spmd_fabric_2proc@8MiB")


def _physical_checks(fa, rec, label):
    """Phase 15 (b): the dest of a ``run_physical`` round verified every
    blob, staged each through incremental ingest with no fallback, and
    launched K1 exactly as its warm-up and full boot need (the plain
    attention never).  Returns its K1 launches."""
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        BOOT_TOKENS)

    cfg = CONFIGS["llama3-8b-d4v8k"]
    blobs = serde.head_blob_id(cfg) + 1
    dest = rec.get("dest") or {}
    check(dest.get("digests_verified") == blobs,
          f"{label}: digests verified {dest.get('digests_verified')}")
    check(dest.get("staged_via") == {"incremental ingest": blobs},
          f"{label}: staged {dest.get('staged_via')}")
    fallbacks = {k: v for k, v in (dest.get("counters") or {}).items()
                 if k.startswith("fallback.") and v}
    check(not fallbacks, f"{label}: fallbacks fired: {fallbacks}")
    check(dest.get("attention_plain_calls") == 0,
          f"{label}: plain attention calls {dest.get('attention_plain_calls')}")
    g = cfg.n_heads // cfg.n_kv_heads
    want = {name: (dest.get("warmup_launches") or {}).get(name, 0)
            for name in fa.SOURCES}
    want[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += cfg.n_layers
    got = dest.get("attention_launches_by_kernel")
    check(got == want, f"{label}: K1 launches {got} != {want}")
    for key in ("ttd_s", "ttft_s", "achieved_gbps", "loopback_raw_gbps",
                "loopback_striped_gbps"):
        check(rec.get(key, 0) > 0, f"{label}: no {key} in {sorted(rec)}")
    return got


def phase_ttd_matrix(fa):
    """The port's TTD matrix harness on the card (module docstring, phase
    15).  Returns the physical dest's K1 launches."""
    import os

    from distributed_llm_dissemination_tpu_torch.cli import ttd_matrix as tm

    import torch

    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory
    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_ttd")
    os.makedirs(work, exist_ok=True)
    out_path = os.path.join(work, "TTD_MATRIX_CUDA.json")
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.monotonic()
    with open(os.path.join(work, "harness.err"), "w") as err:
        proc = subprocess.run(
            [sys.executable, "-m",
             "distributed_llm_dissemination_tpu_torch.cli.ttd_matrix",
             "-trials", "1", "-o", out_path],
            stdout=subprocess.DEVNULL, stderr=err, env=env, cwd=root,
            timeout=TTD_TIMEOUT_S)
    rows_s = time.monotonic() - t0
    with open(os.path.join(work, "harness.err")) as f:
        tail = f.read()[-3000:]
    check(proc.returncode == 0, f"ttd_matrix exited {proc.returncode}:\n{tail}")
    with open(out_path) as f:
        res = json.load(f)
    # (a) every mode of every default scenario delivered, the mode-3
    # plan recorded beside it, the north-star ratio recorded.
    check(sorted(res["scenarios"]) == sorted(TTD_SCENARIOS),
          f"scenarios {sorted(res['scenarios'])}")
    ttd = {}
    for name, per_mode in res["scenarios"].items():
        for m in ("0", "1", "2", "3"):
            check(per_mode.get(m, {}).get("ttd_s", 0) > 0,
                  f"{name} mode {m}: no TTD")
        check(per_mode["3"].get("predicted_s", 0) > 0,
              f"{name}: no mode-3 predicted_s")
        check("mode1_vs_mode0" in per_mode, f"{name}: no mode1_vs_mode0")
        ttd[name] = {m: per_mode[m]["ttd_s"] for m in ("0", "1", "2", "3")}
        ttd[name]["predicted_s"] = per_mode["3"]["predicted_s"]
        ttd[name]["mode1_vs_mode0"] = per_mode["mode1_vs_mode0"]
    pod = res["scenarios"]["pod_fabric_4node@8MiB"]
    for m in ("0", "1", "2", "3"):
        counters = (pod[m].get("telemetry") or {}).get("counters")
        check(counters is not None, f"pod mode {m}: no telemetry")
        fired = {k: v for k, v in counters.items()
                 if k.startswith("fallback.") and v}
        check(not fired, f"pod mode {m}: fallbacks fired: {fired}")
    def timeless(rows):
        return [{k: v for k, v in r.items() if k != "solve_ms"} for r in rows]

    check(timeless(res["north_star_model"]["rows"])
          == timeless(tm.run_north_star()["rows"]),
          "north_star_model rows differ from the solver in this process")
    check(res["card"] == nvidia_smi(), f"card {res['card']!r}")
    # (b) the physical row into the card, (c) its device-fabric twin.
    t0 = time.monotonic()
    phys = tm.run_physical(device="cuda")
    phys_s = time.monotonic() - t0
    launches = _physical_checks(fa, phys, "physical")
    t0 = time.monotonic()
    fab = tm.run_physical_fabric(device="cuda")
    fab_s = time.monotonic() - t0
    check(fab["tcp_layer_fragments"] == 0,
          f"fabric twin: {fab['tcp_layer_fragments']} layer fragments on TCP")
    check(fab["fabric_deliveries"] >= 5,
          f"fabric twin: {fab['fabric_deliveries']} fabric deliveries")
    emit("ttd_matrix", card=nvidia_smi(), trials=1, ttd_s=ttd,
         codec_ab={k: res["codec_ab"][k] for k in
                   ("int8_vs_raw", "int4_vs_raw")},
         physical={k: phys.get(k) for k in (
             "backend", "ttd_s", "ttft_s", "achieved_gbps",
             "loopback_raw_gbps", "loopback_striped_gbps", "link_fraction",
             "predicted_s", "total_bytes", "phases", "dest")},
         physical_fabric={k: fab.get(k) for k in (
             "backend", "ttd_s", "ttft_s", "achieved_gbps",
             "fabric_deliveries", "tcp_layer_fragments", "plan_phases")},
         rows_wall_s=rows_s, physical_wall_s=phys_s, fabric_wall_s=fab_s,
         record=os.path.relpath(out_path, root),
         phase_wall_s=time.monotonic() - t_phase)
    return launches


# ------------------------------------------------------------ phase 16

CARDS4 = 4  # the cards phase 16 needs
ONLY = ("cards4",)  # phases --only can run alone
# Phase 16b's leader id: above the seeders' and the dests', so the
# placement's id-order fill of the free stages puts seeders 1 and 2 on the
# two cards the dests do not use, and the leader (no layers) on slot 4,
# which repeats card 0.
CARDS4_LEADER = 5
CARDS4_PROBE_BYTES = 1 << 30  # the cross-card copy probe
CARDS4_SEEDERS, CARDS4_DESTS = (1,), (2, 3)  # 16c: one process per card
CARDS4_TRAIN_STEPS = 3
CARDS4_TRAIN_SEQ = 2048
CARDS4_TRAIN_BATCH = 2  # cli.train's default global batch at dp = 1
CARDS4_TRAIN_TIMEOUT_S = 420  # any one cli.train process
# 16d: the world of four against the world of one.  The first loss is a
# forward of the same params and batch: it differs only by the order of
# the tensor-parallel f32 sums of bf16 products and by bf16 roundings of
# the partial sums (1e-3 relative, the phase-10 bound between K1 and the
# plain attention).  Later losses follow AdamW updates of 1.92 G params
# whose gradients differ the same way, and the differences grow with each
# step: 1e-2 relative.
CARDS4_LOSS_REL = (1e-3, 1e-2)


def cards4_copy_gbps(src_card, dst_card, nbytes=CARDS4_PROBE_BYTES,
                     repeats=3):
    """Best GB/s of a ``nbytes`` copy from one card to another (peer
    copies where the cards allow them): the ceiling of a cross-card
    fabric move."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, device=f"cuda:{src_card}")
    dst = torch.empty(nbytes, dtype=torch.uint8, device=f"cuda:{dst_card}")
    best = float("inf")
    for i in range(repeats + 1):
        torch.cuda.synchronize(src.device)
        torch.cuda.synchronize(dst.device)
        t0 = time.monotonic()
        dst.copy_(src)
        torch.cuda.synchronize(src.device)
        torch.cuda.synchronize(dst.device)
        if i:  # the first copy enables peer access and warms up
            best = min(best, time.monotonic() - t0)
    del src, dst
    return nbytes / best / 1e9


def cards4_kernels(cfg, fa, dq, quant, serde, wire):
    """16a: each card's nvidia-smi line, the topology and peer-access
    matrix, the card 0 -> card k copy ceiling, and K1 decode, K1 prefill
    (bf16), K2 and K3 with their tensors on each card while card 0 is
    current, each against its plain version at phase 2's and phase 8's
    tolerances, each launch counted on its tensors' card."""
    import torch

    n = torch.cuda.device_count()
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]
    copy = {f"cuda:0->cuda:{k}": cards4_copy_gbps(0, k)
            for k in range(1, n)}
    torch.cuda.set_device(0)
    fa.reset_counts()
    dq.reset_counts()
    cases = {}
    g = cfg.n_heads // cfg.n_kv_heads
    layer_specs = serde.layer_param_specs(cfg)
    for k in range(n):
        dev = torch.device("cuda", k)
        rec = {}
        for label, sq, t, q_off in (("decode", 1, 160, 159),
                                    ("prefill", 128, 128, 0)):
            r = attention_case(fa, 1, cfg.n_kv_heads, g, sq, t,
                               cfg.head_dim, q_off, 0, torch.bfloat16,
                               seed=k, timed=False, device=dev)
            check(r["kernel"] == label, f"{label} case took {r['kernel']}")
            rec[label] = {key: r[key] for key in (
                "max_abs_err_vs_plain", "pv_err_over_bound", "tolerance")}
        for kind in ("int8", "int4"):
            r, kern = codec_kernel_case(dq, quant, kind, "layer0",
                                        wire[kind], layer_specs, cfg.dtype,
                                        device=dev)
            check(all(x.device == dev for x in kern),
                  f"{kind} leaves left card {k}")
            rec[kind] = {"bit_exact": r["bit_exact"],
                         "max_abs_err": r["max_abs_err"]}
            del kern
        check(torch.cuda.current_device() == 0,
              f"card {torch.cuda.current_device()} current after card {k}")
        cases[f"cuda:{k}"] = rec
    want = {f"cuda:{k}": {"decode": 1, "prefill": 1} for k in range(n)}
    check(fa.launches_by_device == want,
          f"K1 launches by card {fa.launches_by_device} != {want}")
    want = {f"cuda:{k}": {"int8": 1, "int4": 1} for k in range(n)}
    check(dq.launches_by_device == want,
          f"K2/K3 launches by card {dq.launches_by_device} != {want}")
    # The chip machine's nvidia-smi may not read the topology (it has
    # exited 255 there): its answer is recorded as it came.
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    cards = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout
    return dict(cards=cards.strip().splitlines(),
                topology={"rc": topo.returncode,
                          "lines": (topo.stdout + topo.stderr).splitlines()},
                peer_access=peer, copy_gbps=copy,
                copy_bytes=CARDS4_PROBE_BYTES, kernels=cases,
                attention_launches_by_device=dict(fa.launches_by_device),
                dequant_launches_by_device=dict(dq.launches_by_device))


def _cards_of(placement, node):
    return {str(s.device) for s in placement.devices_for_node(node)}


def _dest_boots(receivers, dests=(3, 4)):
    """Each dest's boot as ``_fabric_checks`` reads it."""
    return {r.node.my_id: {
        "kind": r.boot_result.kind, "layers": len(r.boot_result.layer_ids),
        "device": str(next(iter(r.boot_result.params.values())).device),
        "via": r.boot_result.via}
        for r in receivers if r.node.my_id in dests}


def cards4_pod(cfg, args, fa, dq, quant, serde, blobs, wire8, prompt,
               ids_want):
    """16b: ``cli.podrun.run_pod`` of phase 12's topology with the mesh's
    slots on the host's cards in order (leader ``CARDS4_LEADER``): the
    dests' stages on two cards, the seeders on the other two.  A raw
    round (every blob on its dest's cards byte-exact, no layer byte on the
    transport, ids equal to one card's ``generate``, K1 counted per
    card), then a ``ModelCodec`` int8 round whose stage leaves, decoded
    by K2 on each dest's card, equal the plain decode bit for bit."""
    import torch

    from distributed_llm_dissemination_tpu_torch.runtime.pp_serve import (
        assemble_pp_params, pod_decode)
    from distributed_llm_dissemination_tpu_torch.utils import integrity

    dests = (3, 4)

    def raw_hook(leader, receivers, placement):
        cards = {str(n): sorted(_cards_of(placement, n))
                 for n in sorted(placement.node_to_stage)}
        check(_cards_of(placement, 3).isdisjoint(_cards_of(placement, 4)),
              f"the dests share a card: {cards}")
        check(all(_cards_of(placement, s).isdisjoint(
                      _cards_of(placement, 3) | _cards_of(placement, 4))
                  for s in (1, 2)), f"a seeder on a dest's card: {cards}")
        exact = 0
        for r in receivers:
            i = r.node.my_id
            if i not in dests:
                continue
            for lid, st in placement.layer_to_stage.items():
                if st != placement.node_to_stage[i]:
                    continue
                arr = r.layers[lid].device_array
                check(arr is not None and arr.devices()
                      == set(placement.devices_for_node(i)),
                      f"blob {lid} at dest {i} not on its stage's slots")
                check(str(arr.device) in _cards_of(placement, i),
                      f"blob {lid} on {arr.device}, not dest {i}'s card")
                host = torch.frombuffer(blobs[lid], dtype=torch.uint8)
                check(torch.equal(arr, host.to(arr.device)),
                      f"blob {lid} not byte-exact at dest {i}")
                check(integrity.layer_digest(arr.cpu().numpy())
                      == integrity.layer_digest(blobs[lid]),
                      f"blob {lid} digest at dest {i}")
                exact += 1
        results = {r.node.my_id: r.boot_result for r in receivers}
        stores = {r.node.my_id: r.layers for r in receivers
                  if r.node.my_id in dests}
        return {"cards": cards, "exact": exact,
                "boots": _dest_boots(receivers, dests),
                "assembled": (placement, assemble_pp_params(
                    cfg, placement, results, stores))}

    out = fabric_round(cfg, args, fa, prompt, blobs, FABRIC_CUT,
                       hook=raw_hook, leader=CARDS4_LEADER, device=None)
    want = _fabric_checks(fa, cfg, args, out, blobs, FABRIC_CUT,
                          both_seeders=True)
    summary = out["summary"]
    check(out["exact"] == len(blobs), f"{out['exact']} blobs byte-exact")
    check(summary["tokens"] == ids_want,
          f"pod ids {summary['tokens']} != one card's {ids_want}")
    dest_cards = {c for i in dests for c in out["cards"][str(i)]}
    by_card = out["counts"]["attention_by_device"]
    check(set(by_card) == dest_cards,
          f"K1 ran on {sorted(by_card)}, the dests' cards are "
          f"{sorted(dest_cards)}")
    check({k: sum(c.get(k, 0) for c in by_card.values())
           for k in fa.SOURCES} == want, f"K1 by card {by_card} != {want}")
    placement, assembled = out.pop("assembled")
    full = sorted(pod_decode(cfg, placement, {}, {}, args.gen, prompt,
                             assembled=assembled)[1] for _ in range(REPEATS))
    one = sorted(pod_decode(cfg, placement, {}, {}, 1, prompt,
                            assembled=assembled)[1] for _ in range(REPEATS))
    decode_ms = sorted((f - statistics.median(one)) / (args.gen - 1) * 1e3
                       for f in full)
    del placement, assembled
    total = sum(len(b) for b in blobs.values())
    raw = dict(ttd_s=summary["ttd_s"], ttft_s=summary.get("ttft_s"),
               predicted_s=summary.get("predicted_s"),
               node_cards=out["cards"], bytes=total,
               gbps_over_ttd=total / summary["ttd_s"] / 1e9,
               pod_decode_ms_per_token_warm=decode_ms,
               attention_launches_by_device=by_card,
               peak_memory_by_card=out["counts"]["peak_by_card"],
               messages={k: out["sent"].count(k)
                         for k in sorted(set(out["sent"]))},
               tokens=summary["tokens"])
    launches = dict(out["counts"]["attention"])
    del out
    gc.collect()
    torch.cuda.empty_cache()

    plain = _plain_params(cfg, serde, dq, quant, "int8", wire8)

    def int8_hook(leader, receivers, placement):
        equal = 0
        for r in receivers:
            if r.node.my_id not in dests:
                continue
            res = r.boot_result
            for name, stacked in res.params.items():
                check(str(stacked.device) in _cards_of(placement,
                                                       r.node.my_id),
                      f"dest {r.node.my_id}'s {name} on {stacked.device}")
                for j, lid in enumerate(res.layer_ids):
                    check(torch.equal(_bits(stacked[j]), _bits(
                              plain["layers"][name][lid]).to(stacked.device)),
                          f"dest {r.node.my_id} layer {lid} {name} != "
                          "the plain decode")
                    equal += 1
        return {"leaves_equal_plain": equal,
                "boots": _dest_boots(receivers, dests),
                "cards": {str(i): sorted(_cards_of(placement, i))
                          for i in dests}}

    out = fabric_round(cfg, args, fa, prompt, wire8, FABRIC_CUT,
                       codec="int8", hook=int8_hook, leader=CARDS4_LEADER,
                       device=None)
    del plain
    _fabric_checks(fa, cfg, args, out, wire8, FABRIC_CUT)
    k2_cards = out["counts"]["dequant_by_device"]
    dest_cards = {c for cs in out["cards"].values() for c in cs}
    check(set(k2_cards) == dest_cards
          and all(c.get("int8", 0) > 0 for c in k2_cards.values()),
          f"K2 ran on {k2_cards}, the dests' cards are {sorted(dest_cards)}")
    check(not any(out["counts"]["dequant_plain"].values()),
          f"plain dequant ran: {out['counts']['dequant_plain']}")
    check(out["leaves_equal_plain"] == cfg.n_layers * len(
        serde.layer_param_specs(cfg)), f"{out['leaves_equal_plain']} leaves")
    check(out["summary"]["tokens"] is not None, "no int8 pod ids")
    int8 = dict(ttd_s=out["summary"]["ttd_s"],
                wire_bytes=sum(len(b) for b in wire8.values()),
                dequant_launches_by_device=k2_cards,
                attention_launches_by_device=out["counts"][
                    "attention_by_device"],
                leaves_equal_plain=out["leaves_equal_plain"],
                tokens=out["summary"]["tokens"])
    k2 = out["counts"]["dequant"]["int8"]
    for name, n in out["counts"]["attention"].items():
        launches[name] += n
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 12's gather leg across the cards: layer blob 0's int8 wire
    # form in one shard per card, gathered over the slots (peer copies),
    # decoded on the gathered tensor's card by K2.
    from distributed_llm_dissemination_tpu_torch.core.types import (
        shard_range, shard_specs_for)
    from distributed_llm_dissemination_tpu_torch.parallel import collectives
    from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
        device_slots)

    n = torch.cuda.device_count()
    blob = bytes(wire8[0])
    parts = [(k, blob[shard_range(sp, len(blob))[0]:
                      sum(shard_range(sp, len(blob)))])
             for k, sp in enumerate(shard_specs_for(n))]
    slots = device_slots(n)
    check(len({str(d) for d in slots}) == n, f"gather slots {slots}")
    dq.reset_counts()
    t0 = time.monotonic()
    got, leaves = collectives.gather_byte_shards(
        parts, len(blob), verify_digest=integrity.layer_digest(blob),
        codec="int8", decode=(cfg, 0), devices=slots)
    for d in slots:
        torch.cuda.synchronize(d)
    gather_s = time.monotonic() - t0
    check(got == blob, "gathered wire bytes differ")
    check(sum(dq.launches_by_kernel.values()) == 1
          and not dq.plain_calls["int8"],
          f"gather decode launches {dict(dq.launches_by_kernel)}")
    host = quant.decode_blob_host(cfg, 0, blob, "int8")
    for name, _ in serde.blob_specs(cfg, 0):
        a = leaves[name][0]
        check(a.device.type == "cuda", f"leaf {name} not on a card")
        check(torch.equal(a.cpu().view(torch.int16),
                          host[name].view(torch.int16)),
              f"gathered leaf {name} differs from the host decode")
    gather = dict(shards=n, slots=[str(d) for d in slots],
                  wire_bytes=len(blob), seconds=gather_s,
                  dequant_launches_by_device=dict(dq.launches_by_device),
                  leaves_equal_host_decode=True)
    del leaves
    return dict(raw=raw, int8=int8, gather=gather), launches, k2 + 1


def _rank_records(path, message):
    return [r for r in _log_records(path) if r.get("message") == message]


def cards4_train(cfg, args, fa, serde, blobs):
    """16d: ``cli.train -steps 3 -seq 2048`` in a world of four processes
    (one per card, nccl; rank 0 disseminates, then broadcasts), then the
    same in a world of one on card 0.  Every rank's shards equal the
    delivered params sliced by its coordinates (digests of every leaf,
    ``-params-digest``), the one-rank run's params equal them whole, and
    the losses agree within ``CARDS4_LOSS_REL``."""
    import os

    from distributed_llm_dissemination_tpu_torch.cli import train as tcli
    from distributed_llm_dissemination_tpu_torch.models import sharded
    from distributed_llm_dissemination_tpu_torch.models.train_ckpt import (
        _Coords)

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_cards4")
    os.makedirs(work, exist_ok=True)
    head = serde.head_blob_id(cfg)
    conf = {"Model": cfg.name, "ModelSeed": args.seed,
            "Nodes": [{"Id": 0, "Addr": "0", "IsLeader": True,
                       "NetworkBW": SEEDER_NIC, "Sources": {"1": 0},
                       "InitialLayers": {"1": {str(b): {}
                                               for b in range(head + 1)}}},
                      {"Id": 1, "Addr": "1", "NetworkBW": DEST_NIC,
                       "Sources": {"1": 0}, "InitialLayers": {}}],
            "Assignment": {"1": {str(b): {} for b in range(head + 1)}},
            "Mesh": {"AxisNames": ["nodes"], "AxisSizes": [2],
                     "PipelineAxis": "nodes", "Fabric": True}}
    conf_path = os.path.join(work, "train.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    argv = [sys.executable, "-m",
            "distributed_llm_dissemination_tpu_torch.cli.train",
            "-f", conf_path, "-steps", str(CARDS4_TRAIN_STEPS),
            "-seq", str(CARDS4_TRAIN_SEQ), "-batch", str(CARDS4_TRAIN_BATCH),
            "-params-digest"]

    def world(n):
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = root
        if n > 1:
            env.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(_free_ports(1)[0]))
        procs, files = [], []
        t0 = time.monotonic()
        try:
            for r in range(n):
                base = os.path.join(work, f"world{n}_rank{r}")
                out, err = open(base + ".out", "w"), open(base + ".err", "w")
                files.extend((out, err))
                renv = dict(env, RANK=str(r), LOCAL_RANK=str(r)) if n > 1 \
                    else env
                procs.append(subprocess.Popen(argv, stdout=out, stderr=err,
                                              env=renv, cwd=root))
            deadline = time.monotonic() + CARDS4_TRAIN_TIMEOUT_S
            for r, p in enumerate(procs):
                try:
                    rc = p.wait(timeout=max(1.0,
                                            deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"chip_smoke check failed: world {n} rank {r} still "
                        f"running after {CARDS4_TRAIN_TIMEOUT_S} s") from None
                with open(os.path.join(work, f"world{n}_rank{r}.err")) as f:
                    tail = f.read()[-3000:]
                check(rc == 0, f"world {n} rank {r} exited {rc}:\n{tail}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in files:
                f.close()
        wall = time.monotonic() - t0
        ranks = []
        for r in range(n):
            base = os.path.join(work, f"world{n}_rank{r}")
            placed = _rank_records(base + ".err", "training params placed")
            ran = _rank_records(base + ".err", "training ran")
            check(len(placed) == 1 and len(ran) == 1,
                  f"world {n} rank {r}: {len(placed)} placed, {len(ran)} "
                  "ran records")
            with open(base + ".out") as f:
                lines = [x for x in f.read().splitlines() if x.strip()]
            summary = json.loads(lines[-1]) if r == 0 else None
            check(r != 0 or "final_step" in summary,
                  f"world {n}: no summary from rank 0: {lines[-3:]}")
            ranks.append({"placed": placed[0], "ran": ran[0],
                          "summary": summary})
        return ranks, wall

    four, four_wall = world(CARDS4)
    one, one_wall = world(1)
    # The delivered params (the seeded blobs, the JAX package's bytes),
    # whole and as each rank of the four-rank mesh keeps them.
    full = dict(sharded.tree_leaves(serde.params_from_blobs(cfg, blobs)))
    specs = dict(sharded.tree_leaves(sharded.param_specs(cfg)))
    sizes = sharded.factor_mesh_axes(CARDS4, cfg)
    check(four[0]["summary"]["mesh"] == sizes and sizes["tp"] == 2
          and sizes["pp"] == 2, f"mesh {four[0]['summary']['mesh']}")
    check(one[0]["placed"]["digests"] == tcli.params_digests(
              sharded.tree_unflatten(full.items())),
          "the one-rank run's params differ from the delivered params")
    for r, rank in enumerate(four):
        view = _Coords(sizes, r)
        want = tcli.params_digests(sharded.tree_unflatten(
            (p, t[sharded.shard_slices(t.shape, specs[p], view)])
            for p, t in full.items()))
        check(rank["placed"]["rank"] == r
              and rank["placed"]["digests"] == want,
              f"rank {r}'s shards differ from the one-rank params' slices")
    del full
    l4, l1 = four[0]["summary"]["losses"], one[0]["summary"]["losses"]
    check(len(l4) == len(l1) == CARDS4_TRAIN_STEPS, f"losses {l4} / {l1}")
    rel = [abs(a - b) / abs(b) for a, b in zip(l4, l1)]
    check(rel[0] <= CARDS4_LOSS_REL[0]
          and all(x <= CARDS4_LOSS_REL[1] for x in rel[1:]),
          f"losses {l4} against one rank's {l1}")
    s4, s1 = four[0]["summary"], one[0]["summary"]
    check(s4["ttd_s"] > 0 and s1["ttd_s"] > 0, "no dissemination TTD")
    # K1: every rank launched the prefill on its own card only.  A rank
    # holds n_layers / pp layers and runs them once per pipeline hop, pp
    # hops a step (the JAX package's sequential fill, models/sharded.py
    # ``_local_loss``), so its count equals the one-rank run's.
    one_prefill = one[0]["ran"]["attention_launches_by_kernel"]["prefill"]
    per_card = {}
    for r, rank in enumerate(four):
        by_dev = rank["ran"]["attention_launches_by_device"]
        check(set(by_dev) == {f"cuda:{r}"},
              f"rank {r} launched K1 on {sorted(by_dev)}")
        n = by_dev[f"cuda:{r}"].get("prefill", 0)
        check(n == one_prefill,
              f"rank {r}: {n} prefill launches, one rank {one_prefill}")
        per_card[f"cuda:{r}"] = n / CARDS4_TRAIN_STEPS
    tokens = CARDS4_TRAIN_BATCH * CARDS4_TRAIN_SEQ
    return dict(
        steps=CARDS4_TRAIN_STEPS, seq=CARDS4_TRAIN_SEQ, mesh=sizes,
        tokens_per_step=tokens,
        world4=dict(losses=l4, step_s=s4["step_s"],
                    ms_per_step_after_first=statistics.median(
                        s4["step_s"][1:]) * 1e3,
                    tokens_per_s=tokens / statistics.median(s4["step_s"][1:]),
                    ttd_s=s4["ttd_s"], broadcast_s=s4.get("broadcast_s"),
                    peak_memory_by_card={
                        f"cuda:{r}": rank["ran"]["peak_allocated_bytes"]
                        for r, rank in enumerate(four)},
                    prefill_launches_per_step_by_card=per_card,
                    processes_wall_s=four_wall),
        world1=dict(losses=l1, step_s=s1["step_s"],
                    ms_per_step_after_first=statistics.median(
                        s1["step_s"][1:]) * 1e3,
                    tokens_per_s=tokens / statistics.median(s1["step_s"][1:]),
                    ttd_s=s1["ttd_s"],
                    peak_memory=one[0]["ran"]["peak_allocated_bytes"],
                    prefill_launches_per_step=one_prefill
                    / CARDS4_TRAIN_STEPS,
                    processes_wall_s=one_wall),
        loss_rel_diff=rel, loss_rel_tolerance=list(CARDS4_LOSS_REL),
        shards_equal_delivered_params=True,
        logs=os.path.relpath(work, root)), four


def phase_cards4(cfg, args, fa, dq, fab=None):
    """Phase 16 (module docstring): the port across four cards of one
    host.  ``fab``: phase 3's blobs and phase 8's int8 wire blobs when the
    earlier phases ran (else made here).  Returns the K1 and K2 launches
    of its paths, summed over the cards."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import quant, serde
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)

    t_phase = time.monotonic()
    torch.cuda.set_device(0)
    if fab is None:
        blobs, _ = fabricate(cfg, serde, args.seed)
        wire8 = None
    else:
        blobs = fab["blobs"]
        wire8 = fab.get("int8", {}).get("wire")
    t0 = time.monotonic()
    if wire8 is None:
        wire8 = {lid: quant.encode_blob(cfg, lid, bytes(b), "int8")
                 for lid, b in blobs.items()}
    wire = {"int8": wire8[0],
            "int4": quant.encode_blob(cfg, 0, bytes(blobs[0]), "int4")}
    encode_s = time.monotonic() - t0
    # 16a
    t0 = time.monotonic()
    a = cards4_kernels(cfg, fa, dq, quant, serde, wire)
    a["wall_s"] = time.monotonic() - t0
    # One card's reference: phase 3's prompt and the seeded params'
    # greedy ids and warm decode on card 0.
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (1, args.prompt), generator=gen,
                           device="cuda")
    params = card_params(cfg, serde, args.seed, blobs)
    ids_want = generate(params, prompt, cfg, args.gen)[0].tolist()
    _, one_card_ms = warm_serve(cfg, params, prompt, args.gen, REPEATS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # 16b
    t0 = time.monotonic()
    fa.reset_counts()
    dq.reset_counts()
    b, k1_pod, k2_pod = cards4_pod(cfg, args, fa, dq, quant, serde, blobs,
                                   wire8, prompt, ids_want)
    b["raw"]["one_card_decode_ms_per_token_warm"] = one_card_ms
    b["raw"]["copy_probe_gbps"] = a["copy_gbps"]
    b["wall_s"] = time.monotonic() - t0
    # 16c
    t0 = time.monotonic()
    c, k1_spmd = spmd_round(cfg, args, fa, blobs, "chip_smoke_cards4_spmd",
                            CARDS4_SEEDERS, CARDS4_DESTS, "nccl")
    c["wall_s"] = time.monotonic() - t0
    # 16d
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    d, ranks = cards4_train(cfg, args, fa, serde, blobs)
    d["wall_s"] = time.monotonic() - t0
    k1_train = {name: sum(r["ran"]["attention_launches_by_kernel"].get(
        name, 0) for r in ranks) for name in fa.SOURCES}
    # 16e
    e, k1_dry, k2_dry = phase_dryrun(cfg, args, fa, dq, blobs, wire8,
                                     n=CARDS4)
    launches = {name: k1_pod[name] + k1_spmd[name] + k1_train[name]
                + k1_dry[name] for name in fa.SOURCES}
    by_device = {"attention": {}, "dequant": {}}
    for kind, tables in (
            ("attention", (b["raw"]["attention_launches_by_device"],
                           b["int8"]["attention_launches_by_device"],
                           *(m["attention_launches_by_device"]
                             for m in c["members"].values()),
                           *(r["ran"]["attention_launches_by_device"]
                             for r in ranks))),
            ("dequant", (b["int8"]["dequant_launches_by_device"],))):
        tables += (e["launches_by_device"][kind],)
        for table in tables:
            for dev, per in table.items():
                tally = by_device[kind].setdefault(dev, {})
                for name, n in per.items():
                    tally[name] = tally.get(name, 0) + n
    emit("cards4", ran=True, config=cfg.name, card=nvidia_smi(),
         cards=torch.cuda.device_count(), encode_s=encode_s,
         kernels_and_cards=a, one_controller=b, nccl_processes=c,
         training=d, dryrun=e, attention_launches=launches,
         dequant_launches={"int8": k2_pod + k2_dry},
         launches_by_device=by_device,
         phase_wall_s=time.monotonic() - t_phase)
    return launches, k2_pod + k2_dry


# ------------------------------------------------------------ phase 17


def _params_equal_blobs(cfg, serde, params, blobs):
    """Check ``params`` (on the card) against the seeded host blobs bit
    for bit, leaf by leaf."""
    import torch

    head = serde.head_blob_id(cfg)
    for lid in range(head + 1):
        data = torch.frombuffer(blobs[lid], dtype=torch.uint8).cuda()
        for name, leaf in serde.decode_device(
                data, serde.blob_specs(cfg, lid), cfg.dtype).items():
            got = params[name] if lid == head else params["layers"][name][lid]
            check(torch.equal(_bits(got), _bits(leaf)),
                  f"init_params leaf {name} of blob {lid} != the seeded blob")


def _warm_attention(fa, warm):
    """One launch per warmed attention shape (``"attention:<kernel>:..."``)
    in the warm-up records ``{node: [compiled entries, ...]}``."""
    want = {name: 0 for name in fa.SOURCES}
    for recs in warm.values():
        for compiled in recs:
            for entry in compiled:
                if entry.startswith("attention:"):
                    want[entry.split(":")[1]] += 1
    return want


def _add_launches(tally, per):
    for name, n in per.items():
        tally[name] = tally.get(name, 0) + n
    return tally


def dryrun_checks(fa, cfg, out, n, ids_want):
    """What each part of ``dryrun_multichip(n)`` must show on the cards
    (phases 17 and 16e).  (a): the loss finite, one AdamW step, rank r on
    card r, K1's prefill twice per layer a rank runs (the forward and the
    remat recompute; sp = 1, one ring block) on its own card only.  (b):
    every blob byte-exact on its stage's cards, the decode's ids equal to
    ``ids_want``, K1 as the warm-ups, the boots, the loss, the pod forward
    and both decodes need, only on the dests' cards.  (c): no layer byte
    on the transport, every blob byte-exact on dest 2's cards (apart from
    the seeders' when n > 1), a full boot, K1 as the warm-up and the boot
    need, K2 once per blob plus the warm-up's, the plain versions never.
    Returns the K1 launches of (b) and (c), and (c)'s K2."""
    from distributed_llm_dissemination_tpu_torch.cli import dryrun
    from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        BOOT_TOKENS)

    g = cfg.n_heads // cfg.n_kv_heads
    L = cfg.n_layers
    cards = [f"cuda:{k}" for k in range(n)]
    zero = {name: 0 for name in fa.SOURCES}

    tr = out["train"]
    tcfg = CONFIGS[dryrun.TRAIN_CONFIG]
    check(tr["step"] == 1 and math.isfinite(tr["loss"]),
          f"train step {tr['step']}, loss {tr['loss']}")
    check(tr["devices"] == cards and tr["mesh"]["sp"] == 1,
          f"train ranks on {tr['devices']}, mesh {tr['mesh']}")
    per_rank = dict(zero)
    per_rank[fa.kernel_for(8, tcfg.n_heads // tcfg.n_kv_heads,
                           tcfg.dtype)] += 2 * tcfg.n_layers
    for r, (by_k, by_dev) in enumerate(zip(tr["attention_by_rank"],
                                           tr["attention_by_device"])):
        check(by_k == per_rank, f"rank {r} K1 {by_k} != {per_rank}")
        check(by_dev == {cards[r]: {k: v for k, v in per_rank.items() if v}},
              f"rank {r} launched K1 on {by_dev}")
    check(tr["attention_plain"] == 0, "plain attention in the train step")

    b = out["dissemination"]
    pp = 2 if n % 2 == 0 else 1
    width = n // pp
    stage_cards = [cards[s * width:(s + 1) * width] for s in range(pp)]
    dests = {str(i + 1): stage_cards[i] for i in range(pp)}
    check(b["stages"] == pp and b["node_devices"] == dests,
          f"dissemination stages {b['stages']}, nodes on {b['node_devices']}")
    check(b["landed_exact"] == L + 1, f"{b['landed_exact']} blobs exact")
    for bid, devs in b["blob_devices"].items():
        node = "1" if pp == 1 or int(bid) < min(3, L - 1) else "2"
        check(devs == dests[node], f"blob {bid} on {devs}, not {dests[node]}")
    check(set(b["boots"].values()) == ({"stage"} if pp == 2 else {"full"}),
          f"boots {b['boots']}")
    check(math.isfinite(b["loss_from_landed"]), "non-finite landed loss")
    check(b["tokens"] == ids_want,
          f"dry-run ids {b['tokens']} != generate's {ids_want}")
    want_b = _warm_attention(fa, b["warm"])
    want_b[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += L  # boots
    # The loss, the pod forward (two stages), the decode's prefill and the
    # reference generate's, each over 16 tokens; then both decodes' steps.
    want_b[fa.kernel_for(16, g, cfg.dtype)] += (4 if pp == 2 else 3) * L
    want_b[fa.kernel_for(1, g, cfg.dtype)] += 2 * (dryrun.DECODE_NEW - 1) * L
    check(b["attention"] == want_b,
          f"dissemination K1 {b['attention']} != {want_b}")
    check(b["attention_plain"] == 0, "plain attention in the round")
    check(set(b["attention_by_device"]) <= set(cards[:pp * width]),
          f"dissemination K1 on {sorted(b['attention_by_device'])}")

    c = out["fabric"]
    dest = c["node_devices"]["2"]
    check(c["layer_msgs_on_transport"] == 0,
          f"{c['layer_msgs_on_transport']} LayerMsg on the transport")
    check(c["landed_exact"] == L + 1 and c["kind"] == "full",
          f"fabric: {c['landed_exact']} exact, boot {c['kind']}")
    check(all(d == dest for d in c["blob_devices"].values()),
          f"fabric blobs on {c['blob_devices']}, dest 2 on {dest}")
    check(n == 1 or set(dest).isdisjoint(c["node_devices"]["0"]
                                         + c["node_devices"]["1"]),
          f"fabric nodes on {c['node_devices']}")
    want_c = _warm_attention(fa, c["warm"])
    want_c[fa.kernel_for(BOOT_TOKENS, g, cfg.dtype)] += L
    check(c["attention"] == want_c, f"fabric K1 {c['attention']} != {want_c}")
    k2 = L + 1 + sum(e == "dequant:int8" for recs in c["warm"].values()
                     for compiled in recs for e in compiled)
    check(c["dequant"] == {"int8": k2, "int4": 0},
          f"fabric K2/K3 {c['dequant']}, want {k2} int8")
    check(c["attention_plain"] == 0 and not any(c["dequant_plain"].values()),
          "a plain version ran in the fabric round")
    for key in ("attention_by_device", "dequant_by_device"):
        check(set(c[key]) <= set(dest), f"fabric {key} {c[key]}, dest {dest}")
    return _add_launches(dict(b["attention"]), c["attention"]), k2


def phase_dryrun(cfg, args, fa, dq, blobs, wire8, n=1):
    """``cli.dryrun.dryrun_multichip(n)`` at ``--config``'s width on the
    cards (module docstring: phase 17 with n = 1, then ``entry()`` first;
    phase 16e with n = 4).  ``blobs``/``wire8``: the seeded blobs and
    their int8 wire form of ``--seed`` (passed on when it is 0, the dry
    run's seed; else it fabricates).  Returns (record, the path's K1
    launches by kernel, its K2 launches)."""
    import os

    import torch

    from distributed_llm_dissemination_tpu_torch.cli import dryrun
    from distributed_llm_dissemination_tpu_torch.models import serde
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)

    t_phase = time.monotonic()
    torch.cuda.set_device(0)
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    g = cfg.n_heads // cfg.n_kv_heads
    seed0 = args.seed == 0
    rec = {"n": n, "config": cfg.name}
    # The reference: greedy ids of 16 zero tokens from entry()'s params
    # (init_params(cfg, 0) on card 0), held against the seeded blobs.
    t0 = time.monotonic()
    fn, (params, tokens) = dryrun.entry(config=cfg.name)
    torch.cuda.synchronize()
    rec["init_params_s"] = time.monotonic() - t0
    if seed0:
        _params_equal_blobs(cfg, serde, params, blobs)
        rec["init_params_equal_seeded_blobs"] = True
    ids_want = generate(params, torch.zeros((1, 16), dtype=torch.long,
                                            device="cuda"),
                        cfg, dryrun.DECODE_NEW)[0].tolist()
    fa.reset_counts()
    dq.reset_counts()  # the dry run's path counts from here
    entry_k1 = {name: 0 for name in fa.SOURCES}
    if n == 1:
        t0 = time.monotonic()
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        rec["entry_forward_s"] = time.monotonic() - t0
        check(tuple(logits.shape) == (1, 128, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"entry logits {tuple(logits.shape)}")
        entry_k1[fa.kernel_for(128, g, cfg.dtype)] += cfg.n_layers
        check(dict(fa.launches_by_kernel) == entry_k1,
              f"entry K1 {dict(fa.launches_by_kernel)} != {entry_k1}")
        del logits
    del fn, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    for k in range(n):
        torch.cuda.reset_peak_memory_stats(k)
    t0 = time.monotonic()
    out = dryrun.dryrun_multichip(
        n, config=cfg.name, blobs=blobs if seed0 else None,
        wire=wire8 if seed0 else None,
        workdir=os.path.join(root, "build", f"chip_smoke_dryrun{n}"))
    rec["dryrun_multichip_s"] = time.monotonic() - t0
    k1, k2 = dryrun_checks(fa, cfg, out, n, ids_want)
    train = out["train"]
    parent = _add_launches(_add_launches(dict(entry_k1), k1),
                           train["attention"] if n == 1 else {})
    check(dict(fa.launches_by_kernel) == parent,
          f"K1 in this process {dict(fa.launches_by_kernel)} != {parent}")
    check(dict(dq.launches_by_kernel) == {"int8": k2, "int4": 0},
          f"K2/K3 in this process {dict(dq.launches_by_kernel)}")
    check(fa.plain_calls == 0 and not any(dq.plain_calls.values()),
          "a plain version ran on the dry run's path")
    launches = _add_launches(_add_launches(dict(entry_k1), k1),
                             train["attention"])
    by_device = {"attention": {}, "dequant": {}}
    for table in ([out["dissemination"]["attention_by_device"],
                   out["fabric"]["attention_by_device"]]
                  + train["attention_by_device"]
                  + ([{"cuda:0": entry_k1}] if n == 1 else [])):
        for dev, per in table.items():
            _add_launches(by_device["attention"].setdefault(dev, {}), per)
    for dev, per in out["fabric"]["dequant_by_device"].items():
        _add_launches(by_device["dequant"].setdefault(dev, {}), per)
    b, c = out["dissemination"], out["fabric"]
    rec.update(
        train={k: train[k] for k in ("mesh", "loss", "step", "step_s",
                                     "wall_s", "devices")},
        dissemination=dict(
            {k: b[k] for k in ("stages", "mesh", "ttd_s", "predicted_s",
                               "solve_ms", "boots", "boot_s",
                               "loss_from_landed", "pod_forward_s",
                               "pod_decode_s", "tokens", "node_devices",
                               "blob_devices")},
            decode_ms_per_token=b["pod_decode_s"] / dryrun.DECODE_NEW * 1e3,
            bytes=sum(len(x) for x in blobs.values()) if seed0 else None),
        fabric={k: c[k] for k in ("stages", "mesh", "ttd_s", "predicted_s",
                                  "solve_ms", "boot_s", "kind", "via",
                                  "wire_bytes", "layer_msgs_on_transport",
                                  "node_devices")},
        ids_equal_generate=True, nic=dryrun.NIC,
        attention_launches=launches, dequant_launches={"int8": k2},
        launches_by_device=by_device,
        peak_memory_by_card={f"cuda:{k}": torch.cuda.max_memory_allocated(k)
                             for k in range(n)},
        phase_wall_s=time.monotonic() - t_phase)
    return rec, launches, k2


# ------------------------------------------------------------ phase 18

RECEIVE_FIRST = (0, 1)  # (b): the leader's goal until its update()
RECEIVE_BAD_BLOB = 0  # (c): the blob the stager is given a wrong digest for
# (c): corrupt inbound layer frames on dest 2's link, duplicate the
# senders' (leader 0, seeder 1) layer frames to it; seeded, no delays.
RECEIVE_FAULTS = {2: "seed=18,corrupt=29,times=4",
                  0: "seed=18,dup=31,times=4", 1: "seed=18,dup=31,times=4"}
# (d): the refusals' text as the JAX package writes it
# (``distributed_llm_dissemination_tpu/runtime/leader.py:1903``,
# ``runtime/receiver.py:2565``), behind ``GenRequester``'s prefix;
# ``tests/test_torch_generate_serving.py`` holds the port's equal to it.
JAX_REFUSALS = {
    0: "node 0 refused generation: the leader seat serves no model; ask a "
       "booted assignee",
    1: "node 1 refused generation: no booted model at this node (no boot "
       "config)"}


def receive_launches_predicted(fa, cfg, args):
    """Phase 18's K1 launches by kernel, as ``PERF.md`` predicts them: each
    of its three rounds is phase 6's (a warm-up of one prefill and one
    decode, the boot's forward, ``REQUESTS`` served requests); (c)'s
    stager boot runs phase 3's serve (the boot forward over the prompt,
    then ``--gen`` tokens); (d)'s direct ``generate`` one prefill and
    ``--gen - 1`` decode steps."""
    g = cfg.n_heads // cfg.n_kv_heads
    L = cfg.n_layers
    want = {name: 0 for name in fa.SOURCES}
    for _ in range(3):
        _add_launches(want, _expected_round_launches(
            fa, cfg, args, {"prefill": 1, "decode": 1}))
    for n, sq, *_ in serving_shapes(cfg, args.prompt, args.gen):
        want[fa.kernel_for(sq, g, cfg.dtype)] += n
    want[fa.kernel_for(args.prompt, g, cfg.dtype)] += L
    want[fa.kernel_for(1, g, cfg.dtype)] += (args.gen - 1) * L
    return want


def _receive_counts(fa, cfg, args, out, warm_key=None):
    """A round's K1 launches against phase 6's formula, on card 0 only."""
    want = _expected_round_launches(fa, cfg, args, out["warm"][0][0]["launches"])
    check(out["attention"] == want,
          f"round K1 {out['attention']} != {want}")
    check(set(out["attention_by_device"]) == {"cuda:0"}
          and set(out["dequant_by_device"]) <= {"cuda:0"},
          f"launched on {sorted(out['attention_by_device'])}, "
          f"{sorted(out['dequant_by_device'])}")
    check(out["attention_plain"] == 0 and not any(out["plain"].values()),
          "a plain version ran in the round")
    return out


def phase_receive(cfg, args, fa, dq, fab, prompt):
    """Phase 18 (module docstring): the receive path on the card.  (a) is
    phase 6's round (``fab["sink"]``); (b)-(d) run here.  Returns (record,
    K1 launches by kernel, K3 launches)."""
    import torch

    from distributed_llm_dissemination_tpu_torch.models import quant
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)
    from distributed_llm_dissemination_tpu_torch.runtime.boot import (
        boot_from_layers)
    from distributed_llm_dissemination_tpu_torch.runtime.codec import (
        WireCodecPlane)
    from distributed_llm_dissemination_tpu_torch.runtime.stream_boot import (
        StreamingBootStager)
    from distributed_llm_dissemination_tpu_torch.utils import integrity, trace

    t_phase = time.monotonic()
    blobs = fab["blobs"]
    ids = sorted(blobs)
    tokens = fab["tokens"]
    total = sum(len(b) for b in blobs.values())
    k1 = {name: 0 for name in fa.SOURCES}
    k3 = 0
    by_device = {"attention": {}, "dequant": {}}

    def tally(win):
        nonlocal k3
        _add_launches(k1, win["attention"])
        k3 += win["dequant"]["int4"]
        check(win["dequant"]["int8"] == 0, f"K2 launched: {win['dequant']}")
        for key in by_device:
            for dev, per in win[f"{key}_by_device"].items():
                _add_launches(by_device[key].setdefault(dev, {}), per)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (b) update() mid-flight: the first goal is blobs 0-1; at its first
    # ack the goal becomes every blob.
    out = mode3_round(cfg, args, fa, prompt, blobs, first=RECEIVE_FIRST)
    _check_raw_round(cfg, out, blobs, tokens, full_width=False)
    sent = _sent_by_source(out["links"])
    check(all(sent.values()), f"a seeder sent nothing: {sent}")
    upd = out["update"]
    check(upd["ready_goals"][-1] == ids and len(upd["ready_goals"]) <= 2,
          f"ready goals {upd['ready_goals']}")
    tally(_receive_counts(fa, cfg, args, out))
    rec_b = dict(_round_record(out, sent), **upd,
                 acked_blob_bytes=[len(blobs[lid])
                                   for lid in upd["acked_at_update"]],
                 sent_beyond_model_bytes=sum(sent.values()) - total,
                 sink=_sink_record(out), served_ids_equal_phase3=True)
    del out
    free()

    # (c) the round under seeded faults, then the stager given a wrong
    # digest for one blob: it rejects it and the boot infills it.
    out = mode3_round(cfg, args, fa, prompt, blobs, faults=RECEIVE_FAULTS)
    _check_raw_round(cfg, out, blobs, tokens)
    tally(_receive_counts(fa, cfg, args, out))
    counters = out["counters"]
    for key in ("integrity.crc_drop", "integrity.retransmit_frags"):
        check(counters.get(key, 0) >= 1, f"{key} = {counters.get(key, 0)}")
    check(out["faults"][2]["corrupt"] >= 1
          and out["faults"][0]["dup"] + out["faults"][1]["dup"] >= 1,
          f"faults fired {out['faults']}")
    sent = _sent_by_source(out["links"])
    rec_c = dict(_round_record(out, sent),
                 sent_beyond_model_bytes=sum(sent.values()) - total,
                 fault_specs=RECEIVE_FAULTS, faults_fired=out["faults"],
                 **{k.split(".", 1)[1]: counters.get(k, 0) for k in (
                     "integrity.crc_drop", "integrity.crc_drop_bytes",
                     "integrity.nack_sent", "integrity.nack_suppressed",
                     "integrity.retransmit_frags",
                     "integrity.retransmit_bytes")},
                 sink=_sink_record(out), served_ids_equal_phase3=True)
    held = out["held"]
    del out
    free()
    digests = {lid: integrity.layer_digest(bytes(blobs[lid])) for lid in ids}
    digests[RECEIVE_BAD_BLOB] = "00" * integrity.DIGEST_SIZE
    mismatches = trace.counter_totals().get("integrity.digest_mismatch", 0)
    fa.reset_counts()
    dq.reset_counts()
    t0 = time.monotonic()
    stager = StreamingBootStager(cfg, device="cuda", digest_lookup=digests.get,
                                 digest_verified=set())
    try:
        for lid in ids:
            check(stager.submit(lid, held[lid]), f"stager refused blob {lid}")
        staged = stager.collect(ids)
        res = boot_from_layers(cfg, held, stager=stager, tokens=prompt,
                               generate_tokens=args.gen)
    finally:
        stager.close()
    win = _window(fa, dq)
    rejected = sorted(set(ids) - set(staged))
    check(rejected == [RECEIVE_BAD_BLOB], f"stager rejected {rejected}")
    check(trace.counter_totals().get("integrity.digest_mismatch", 0)
          > mismatches, "no digest mismatch counted")
    check(res.via == "streamed per-layer (+1 infilled)", f"via {res.via!r}")
    check(res.tokens[0].tolist() == tokens,
          f"infilled boot ids {res.tokens[0].tolist()} != {tokens}")
    want = {name: 0 for name in fa.SOURCES}
    g = cfg.n_heads // cfg.n_kv_heads
    for n, sq, *_ in serving_shapes(cfg, args.prompt, args.gen):
        want[fa.kernel_for(sq, g, cfg.dtype)] += n
    check(win["attention"] == want, f"stager boot K1 {win['attention']}")
    tally(win)
    rec_c["stager"] = {"rejected": rejected, "via": res.via,
                       "boot_s": time.monotonic() - t0,
                       "ids_equal_phase3": True}
    del held, res, staged
    free()

    # (d) int4 serving over the wire, and the refusals.
    wire = fab["int4"]["wire"]
    out = mode3_round(cfg, args, fa, prompt, wire, boot_codec="int4",
                      plane=functools.partial(WireCodecPlane, cfg,
                                              model_codec="int4"),
                      refusals=True)
    sizes = {lid: quant.blob_nbytes_codec(cfg, lid, "int4") for lid in ids}
    delivered = _check_codec_round(fa, cfg, args, out, ids, sizes, "int4",
                                   "dequant_int4")
    tally(_receive_counts(fa, cfg, args, out))
    for node, text in JAX_REFUSALS.items():
        got = out["refused"][node]["text"]
        check(got == text, f"node {node} refused with {got!r}")
    fa.reset_counts()
    dq.reset_counts()
    direct = generate(out["res"].params, prompt, cfg, args.gen)[0].tolist()
    win = _window(fa, dq)
    for ids_got in out["served"]:
        check(ids_got == direct, f"int4 served ids {ids_got} != {direct}")
    want = {name: 0 for name in fa.SOURCES}
    want[fa.kernel_for(args.prompt, g, cfg.dtype)] += cfg.n_layers
    want[fa.kernel_for(1, g, cfg.dtype)] += (args.gen - 1) * cfg.n_layers
    check(win["attention"] == want, f"direct generate K1 {win['attention']}")
    tally(win)
    rec_d = dict(_round_record(out), wire_bytes=delivered,
                 refused=out["refused"], served_ids=direct,
                 served_ids_equal_direct_generate=True)
    del out
    free()

    predicted = receive_launches_predicted(fa, cfg, args)
    check(k1 == predicted, f"phase 18 K1 {k1} != predicted {predicted}")
    check(k3 == len(ids) + 1, f"phase 18 K3 {k3} != {len(ids) + 1}")
    check(by_device == {"attention": {"cuda:0": {k: v for k, v in k1.items()
                                                 if v}},
                        "dequant": {"cuda:0": {"int4": k3}}},
          f"phase 18 launches by card {by_device}")
    rec = dict(config=cfg.name, bytes=total, sink=fab["sink"],
               update=rec_b, faults=rec_c, int4=rec_d,
               attention_launches=k1, attention_launches_predicted=predicted,
               dequant_launches={"int4": k3}, launches_by_device=by_device,
               phase_wall_s=time.monotonic() - t_phase)
    return rec, k1, k3


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
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the env and "
                         "kernel build phase, alone: " + ", ".join(ONLY))
    args = ap.parse_args()
    only = [p for p in args.only.split(",") if p]
    if any(p not in ONLY for p in only):
        print(f"chip_smoke: --only takes {', '.join(ONLY)}; got "
              f"{args.only!r}", file=sys.stderr)
        return 2

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
    cards = torch.cuda.device_count()
    if "cards4" in only and cards < CARDS4:
        print(f"chip_smoke: --only cards4 needs {CARDS4} cards; this host "
              f"has {cards}", file=sys.stderr)
        return 2
    card = phase_env(cuda_build, fa, dq)
    if only:
        phase_cards4(cfg, args, fa, dq)
        emit("script", wall_s=time.monotonic() - t_script, only=only)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}), flush=True)
        return 0
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
    swap_launches = phase_swap(cfg, args, fa, fab, prompt)
    codec_stats = phase_codec(cfg, args, fa, fab, prompt, raw_ttd_s)
    fabric_launches, fabric_k2 = phase_fabric(cfg, args, fa, fab, prompt,
                                              raw_ttd_s)
    pods_launches, pods_k2 = phase_pods(cfg, args, fa, fab, prompt)
    spmd_launches = phase_spmd(cfg, args, fa, fab)
    cards4_k1 = cards4_k2 = None
    if cards >= CARDS4:
        cards4_k1, cards4_k2 = phase_cards4(cfg, args, fa, dq, fab)
    else:
        emit("cards4", ran=False, cards=cards)
    dryrun_rec, dryrun_k1, dryrun_k2 = phase_dryrun(
        cfg, args, fa, dq, fab["blobs"], fab["int8"]["wire"])
    emit("dryrun", **dryrun_rec)
    del fab["int8"]
    receive_rec, receive_k1, receive_k3 = phase_receive(cfg, args, fa, dq,
                                                        fab, prompt)
    emit("receive", **receive_rec)
    del fab["int4"]
    hf_launches, f32_launches = phase_hf(cfg, args, fa, fab, prompt)
    f16_launches = phase_hf_f16(cfg, args, fa, fab, prompt)
    mixes[f"{MOE_CONFIG} prompt{args.prompt}"], moe_launches, moe_k2 = (
        phase_moe(args, fa, prompt))
    train_launches, train_block = phase_train(cfg, args, fa, fab)
    ttd_launches = phase_ttd_matrix(fa)
    paths = {"main": launches, "hf": hf_launches,
             "moe_raw": moe_launches["raw"], "moe_int8": moe_launches["int8"],
             "train": train_launches, "swap": swap_launches,
             "fabric": fabric_launches, "pods": pods_launches,
             "spmd": spmd_launches, "ttd_matrix": ttd_launches,
             "dryrun": dryrun_k1, "receive": receive_k1,
             "cards4": cards4_k1 or dict.fromkeys(fa.SOURCES)}
    for kind, st in codec_stats.items():
        st["launches"] = {"codec": st["launches"],
                          "moe_int8": moe_k2 if kind == "int8" else 0}
    codec_stats["int8"]["launches"]["fabric"] = fabric_k2
    codec_stats["int8"]["launches"]["pods"] = pods_k2
    codec_stats["int8"]["launches"]["cards4"] = cards4_k2
    codec_stats["int8"]["launches"]["dryrun"] = dryrun_k2
    codec_stats["int8"]["launches"]["receive"] = 0
    codec_stats["int4"]["launches"]["receive"] = receive_k3

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
