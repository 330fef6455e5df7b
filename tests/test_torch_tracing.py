"""The port's spans, phases and counters on the round's path.

``utils/trace.py``'s phases and spans also enter the profiler's trace as
``dld.<name>`` annotations when a profiler records the calling thread,
and touch nothing of the profiler otherwise.  The fabric sender times the
union of its concurrent uploads and counts their pageable bytes, the
digest stamp counts the bytes it hashed, hashes a large holding's layers
on the digest pool with every digest as the serial one, and times the
union of its hashes; ``cli.podrun.run_pod`` splits a round into
``pod_*`` phases that cover it back to back.
"""

import json
import random
import sys
import threading
import time

import pytest
import torch

from distributed_llm_dissemination_tpu_torch.cli.podrun import run_pod
from distributed_llm_dissemination_tpu_torch.core import config as cfg_mod
from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation,
    LayerMeta,
    LayerSrc,
    SourceType,
)
from distributed_llm_dissemination_tpu_torch.models import llama, serde
from distributed_llm_dissemination_tpu_torch.runtime import (
    Node,
    ReceiverNode,
)
from distributed_llm_dissemination_tpu_torch.runtime import send as send_mod
from distributed_llm_dissemination_tpu_torch.transport import (
    InmemTransport,
    reset_registry,
)
from distributed_llm_dissemination_tpu_torch.utils import (
    integrity,
    telemetry,
    threads,
    trace,
)

POD_STEPS = ("pod_build", "pod_announce", "pod_start", "pod_deliver",
             "pod_boot", "pod_assemble", "pod_forward")


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    telemetry.reset_run()
    yield
    reset_registry()


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith("dld.")),
                  key=lambda e: e["ts"])


def test_phase_and_span_are_profiler_annotations(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.phase("x"):
            time.sleep(0.002)
        with trace.span("y", layerID=1):
            pass
        steps = trace.Steps()
        steps.next("s1")
        steps.next("s2")
        steps.close()
    got = _annotations(prof, tmp_path)
    assert [e["name"] for e in got] == ["dld.x", "dld.y", "dld.s1", "dld.s2"]
    assert got[0]["dur"] >= 2000  # microseconds
    totals = trace.phase_totals()
    assert totals["x"]["n"] == 1 and totals["x"]["ms"] >= 2.0
    assert totals["s1"]["n"] == totals["s2"]["n"] == 1


def test_without_a_profiler_no_annotation_is_entered(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.phase("x"):
        pass
    with trace.span("y"):
        pass
    steps = trace.Steps()
    steps.next("s1")
    steps.close()
    with pytest.raises(ValueError):
        with trace.phase("x"):
            raise ValueError("failed work is still timed")
    assert trace.phase_totals()["x"]["n"] == 2
    assert trace.phase_totals()["s1"]["n"] == 1


def test_overlapping_uploads_count_their_busy_time_once(monkeypatch):
    """Two uploads on two threads that overlap: the busy phase is one
    interval, at least the longer upload and less than the summed thread
    time; every byte of a bytearray source is pageable."""
    held = {0: 0.3, 1: 0.1}
    gate = threading.Barrier(2)
    real = send_mod.resolve_device

    def slow_device(device):
        gate.wait(timeout=10)
        time.sleep(held[threading.current_thread().index])
        return real(device)

    monkeypatch.setattr(send_mod, "resolve_device", slow_device)
    out = {}

    def upload(i):
        threading.current_thread().index = i
        out[i] = send_mod._FabricUploadCache._upload(
            bytearray(b"%d" % i) * (1000 + i), "cpu")

    ts = [threading.Thread(target=upload, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    phases = trace.phase_totals()
    busy, summed = phases["fabric_upload_busy"], phases["fabric_upload"]
    assert busy["n"] == 1 and summed["n"] == 2
    assert busy["ms"] >= max(held.values()) * 1000
    assert busy["ms"] <= summed["ms"]
    # The 0.1 s both ran is counted once, not twice.
    assert busy["ms"] < summed["ms"] - 0.5 * min(held.values()) * 1000
    assert out[0].numel() == 1000 and out[1].numel() == 1001
    counters = trace.counter_totals()
    assert counters["fabric.upload_bytes"] == 2001
    assert counters["fabric.upload_pageable_bytes"] == 2001


def test_busy_keeps_its_count_under_contention():
    """Many threads entering and leaving one busy clock with a short
    switch interval: the clock ends closed, and its time is within the
    run's wall time."""
    busy = trace.Busy("stress")

    def work():
        for _ in range(2000):
            with busy:
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(16)]
        t0 = time.monotonic()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        wall_ms = (time.monotonic() - t0) * 1000
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert busy._open == 0
    got = trace.phase_totals()["stress"]
    assert got["n"] >= 1 and got["ms"] <= wall_ms


def _src(data: bytes, location=LayerLocation.INMEM) -> LayerSrc:
    buf = bytearray(data)
    return LayerSrc(inmem_data=buf, data_size=len(buf),
                    meta=LayerMeta(location=location,
                                   source_type=SourceType.MEM))


def test_digest_stamp_counts_the_bytes_it_hashed(tmp_path):
    disk = tmp_path / "layer"
    disk.write_bytes(b"\x07" * 4096)
    on_disk = LayerSrc(fp=str(disk), offset=0, data_size=4096,
                       meta=LayerMeta(location=LayerLocation.DISK,
                                      source_type=SourceType.DISK))
    layers = {0: _src(b"\x01" * 1000), 1: _src(b"\x02" * 3000),
              2: on_disk,
              3: _src(b"\x03" * 500, LayerLocation.CLIENT)}  # not readable
    node = Node(1, 0, InmemTransport("1", addr_registry={0: "0", 1: "1"}))
    receiver = ReceiverNode(node, layers)
    try:
        digests = receiver._announce_digests()
        receiver._announce_digests()  # cached: hashes nothing again
    finally:
        receiver.close()
    assert sorted(digests) == [0, 1, 2]
    assert trace.counter_totals()["integrity.digest_stamp_bytes"] == (
        1000 + 3000 + 4096)


GATE = integrity.POOLED_STAMP_MIN_BYTES
POOLED = "integrity.digest_stamp_pooled_bytes"


@pytest.fixture
def small_gate(monkeypatch):
    """A 1 MiB gate, so that a pooled holding is a few MiB: the pool's
    tests then take little of the host's memory bandwidth from the
    tests beside them."""
    monkeypatch.setattr(integrity, "POOLED_STAMP_MIN_BYTES", 1 << 20)
    return 1 << 20


def _holder(layers):
    node = Node(1, 0, InmemTransport("1", addr_registry={0: "0", 1: "1"}))
    return ReceiverNode(node, layers)


def _announce(layers):
    """The holder's announce digests, the call's wall ms, the counters
    and phases it left."""
    receiver = _holder(layers)
    try:
        t0 = time.monotonic()
        digests = receiver._announce_digests()
        wall_ms = (time.monotonic() - t0) * 1000
    finally:
        receiver.close()
    return digests, wall_ms, trace.counter_totals(), trace.phase_totals()


def _random_src(seed: int, size: int) -> LayerSrc:
    return _src(random.Random(seed).randbytes(size))


def _on_disk(path, data: bytes) -> LayerSrc:
    path.write_bytes(data)
    return LayerSrc(fp=str(path), offset=0, data_size=len(data),
                    meta=LayerMeta(location=LayerLocation.DISK,
                                   source_type=SourceType.DISK))


@pytest.mark.parametrize("algo,mix,gate", [
    ("xxh3", "memory", GATE), ("blake2b", "memory", 1 << 20),
    ("xxh3", "mixed", 1 << 20)])
def test_pooled_stamp_digests_are_the_serial_ones(algo, mix, gate, tmp_path,
                                                  monkeypatch):
    """A holding at the gate is hashed on the pool, each layer whole:
    every digest is the serial ``layer_digest`` of its bytes, and every
    readable byte is counted as pooled.  A CLIENT holding is left out."""
    monkeypatch.setenv("DLD_DIGEST_ALGO", algo)
    monkeypatch.setattr(integrity, "POOLED_STAMP_MIN_BYTES", gate)
    size = gate // 4
    layers = {i: _random_src(i, size) for i in range(4)}
    want = {i: integrity.layer_digest(bytes(layers[i].inmem_data))
            for i in range(4)}
    if mix == "mixed":
        disk = random.Random(9).randbytes(size)
        layers[2] = _on_disk(tmp_path / "layer", disk)
        want[2] = integrity.layer_digest(disk)
        layers[4] = _src(b"\x03" * 500, LayerLocation.CLIENT)
    digests, _, counters, phases = _announce(layers)
    assert digests == want
    assert counters[POOLED] == 4 * size
    assert counters["integrity.digest_stamp_bytes"] == 4 * size
    assert phases["integrity_digest_stamp"]["n"] == len(layers)
    assert phases["integrity_digest_stamp_wait"]["n"] == 1


def test_a_layer_whose_hash_fails_is_left_out_on_the_pool(small_gate,
                                                         monkeypatch):
    size = small_gate // 4
    layers = {i: _random_src(i, size) for i in range(4)}
    real = integrity._digest_layer_src

    def failing(src):
        if src is layers[1]:
            raise OSError("read failed")
        return real(src)

    monkeypatch.setattr(integrity, "_digest_layer_src", failing)
    digests, _, counters, _ = _announce(layers)
    assert digests == {i: integrity.layer_digest(bytes(layers[i].inmem_data))
                       for i in (0, 2, 3)}
    assert counters[POOLED] == 3 * size


@pytest.mark.parametrize("sizes", [(1000, 3000, 4096), (GATE,),
                                   (GATE // 2 - 1, GATE // 2)])
def test_a_holding_under_the_gate_is_hashed_inline(sizes, monkeypatch):
    """Fewer than two layers, or fewer bytes than the gate, hash on the
    caller's thread: nothing is pooled and the pool is not waited on."""
    ran_on = set()
    real = integrity._digest_layer_src

    def spy(src):
        ran_on.add(threading.current_thread().name)
        return real(src)

    monkeypatch.setattr(integrity, "_digest_layer_src", spy)
    layers = {i: _src(bytes([i + 1]) * n) for i, n in enumerate(sizes)}
    digests, _, counters, phases = _announce(layers)
    assert digests == {i: integrity.layer_digest(bytes(src.inmem_data))
                       for i, src in layers.items()}
    assert counters[POOLED] == 0
    assert "integrity_digest_stamp_wait" not in phases
    assert ran_on == {threading.current_thread().name}


def test_stamp_busy_is_the_union_of_the_pooled_hashes(small_gate):
    """``integrity_digest_stamp_busy`` counts concurrent hashes once: no
    more than the call's wall time, nor than the per-layer sum."""
    layers = {i: _random_src(i, 8 * small_gate) for i in range(6)}
    _, wall_ms, _, phases = _announce(layers)
    busy = phases["integrity_digest_stamp_busy"]["ms"]
    assert 0 < busy <= wall_ms
    assert busy <= phases["integrity_digest_stamp"]["ms"] + 0.1


@pytest.mark.timeout(60)
def test_pooled_stamp_under_thread_switch_stress(small_gate):
    """More layers than workers, with a thread switch every microsecond:
    every digest lands in its own layer's slot, every byte is counted
    once, and the busy union closes."""
    n = 4 * threads.usable_cpus() + 3
    size = -(-small_gate // n)
    layers = {i: _random_src(i, size) for i in range(n)}
    want = {i: integrity.layer_digest(bytes(src.inmem_data))
            for i, src in layers.items()}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        digests, _, counters, _ = _announce(layers)
    finally:
        sys.setswitchinterval(old)
    assert digests == want
    assert counters[POOLED] == counters[
        "integrity.digest_stamp_bytes"] == n * size
    assert integrity._stamp_busy._open == 0


def test_a_second_announce_hashes_nothing(small_gate):
    receiver = _holder({i: _random_src(i, small_gate // 4)
                        for i in range(4)})
    try:
        first = receiver._announce_digests()
        counters = trace.counter_totals()
        again = receiver._announce_digests()
    finally:
        receiver.close()
    assert again == first
    assert trace.counter_totals() == counters


def test_the_digest_pool_workers_are_in_the_census(small_gate,
                                                   monkeypatch):
    ran_on = set()
    real = integrity._digest_layer_src

    def spy(src):
        ran_on.add(threading.current_thread().name)
        return real(src)

    monkeypatch.setattr(integrity, "_digest_layer_src", spy)
    _announce({i: _random_src(i, small_gate // 4) for i in range(4)})
    assert ran_on and all(n.startswith("torch-data-digest-")
                          for n in ran_on)
    workers = [t.name for t in threading.enumerate()
               if t.name.startswith("torch-data-digest-")]
    assert ran_on <= set(workers)
    assert len(workers) <= threads.usable_cpus()
    assert threads.census()["data"] >= len(workers)


def _pipeline_conf(name="tiny"):
    cfg = llama.CONFIGS[name]
    head_id = serde.head_blob_id(cfg)
    cut = cfg.n_layers // 2

    def node(i, held=()):
        return {"Id": i, "Addr": str(i), "IsLeader": i == 0,
                "Sources": {"2": 0}, "NetworkBW": 10**9,
                "InitialLayers": ({"2": {str(b): {} for b in held}}
                                  if held else {})}

    return cfg_mod.Config.from_json({
        "Model": name, "ModelSeed": 0,
        "Nodes": [node(0, range(head_id + 1)), node(1), node(2)],
        "Assignment": {"1": {str(b): {} for b in range(cut)},
                       "2": {str(b): {} for b in range(cut, head_id + 1)}},
        "Mesh": {"AxisNames": ["nodes", "tp"], "AxisSizes": [4, 2],
                 "PipelineAxis": "nodes", "Fabric": True},
    })


def test_run_pod_steps_cover_the_round_back_to_back():
    seen = {}

    def on_delivered(leader, receivers, placement):
        seen["t"] = time.monotonic()
        seen["phases"] = trace.phase_totals()

    conf = _pipeline_conf()
    t0 = time.monotonic()
    summary = run_pod(conf, mode=3, timeout=120.0, device="cpu",
                      on_delivered=on_delivered)
    wall_ms = (seen["t"] - t0) * 1000
    assert summary["boot_nodes"] == 2
    phases = seen["phases"]
    pods = {k: v for k, v in phases.items() if k.startswith("pod_")}
    assert sorted(pods) == sorted(POD_STEPS)
    assert all(v["n"] == 1 for v in pods.values())
    covered = sum(v["ms"] for v in pods.values())
    assert 0.98 * wall_ms <= covered <= wall_ms
