"""The port's spans, phases and counters on the round's path.

``utils/trace.py``'s phases and spans also enter the profiler's trace as
``dld.<name>`` annotations when a profiler records the calling thread,
and touch nothing of the profiler otherwise.  The fabric sender times the
union of its concurrent uploads and counts their pageable bytes, the
digest stamp counts the bytes it hashed, and ``cli.podrun.run_pod``
splits a round into ``pod_*`` phases that cover it back to back.
"""

import json
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
from distributed_llm_dissemination_tpu_torch.utils import telemetry, trace

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
