"""The readers of the boot's copy counters and of the experts' FFN
(``metrics/boot_copied_share.py``, ``moe_routed_share.py``,
``moe_ffn_ms.py``) on synthetic runs: each gives its value from what it
reads, and None where a round or trace lacks it (a program that boots
stacked copies and counts no expert rows records neither)."""

import types

import pytest

from dissem_bench import run as bench_run
from dissem_bench.devtrace import Trace
from dissem_bench.tests.conftest import STAGED, tiny_cell
from dissem_bench.tests.test_bench_tracing import _read, _round, _run

STAGE_BYTES = 46_440_644_608


def test_boot_copied_share_is_the_copied_bytes_in_percent():
    run = _run(_round(counters={"boot.stage_bytes": STAGE_BYTES,
                                "boot.stage_copied_bytes": 0}),
               _round(counters={"boot.stage_bytes": 400,
                                "boot.stage_copied_bytes": 100}))
    assert _read("boot_copied_share", run) == pytest.approx(12.5)


def test_moe_routed_share_is_the_routed_rows_in_percent():
    run = _run(_round(counters={"moe.routed_rows": 8192,
                                "moe.computed_rows": 32768}),
               _round(counters={"moe.routed_rows": 9000,
                                "moe.computed_rows": 32768}))
    assert _read("moe_routed_share", run) == pytest.approx(
        (25.0 + 100 * 9000 / 32768) / 2)


# A round as the parent program records it: uploads and the stamp are
# counted, the boot's bytes and the expert rows are not.
BEFORE = _round({"integrity_digest_stamp": 2500.0},
                {"integrity.digest_stamp_bytes": STAGE_BYTES,
                 "fabric.upload_bytes": 0})


@pytest.mark.parametrize("name", ["boot_copied_share", "moe_routed_share"])
def test_counter_readers_give_none_where_the_rounds_lack_what_they_read(
        name):
    assert _read(name, _run(BEFORE, BEFORE)) is None
    assert _read(name, _run()) is None
    empty = _round(counters={"boot.stage_bytes": 0,
                             "boot.stage_copied_bytes": 0,
                             "moe.routed_rows": 0, "moe.computed_rows": 0})
    assert _read(name, _run(empty)) is None


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _traced(*events):
    return types.SimpleNamespace(trace=Trace(list(events)), rounds=[])


FORWARD = _x("bench.pod_forward", "user_annotation", 1000, 1000)


def test_moe_ffn_ms_sums_the_device_time_launched_inside_its_spans():
    run = _traced(
        FORWARD,
        _x("dld.moe_ffn", "user_annotation", 1100, 100),
        _x("dld.moe_ffn", "user_annotation", 1500, 100),
        # launched inside the spans: counted, wherever the device ran them
        _x("cudaLaunchKernel", "cuda_runtime", 1110, 5, correlation=1),
        _x("cuLaunchKernelEx", "cuda_driver", 1520, 5, correlation=2),
        _x("gemm", "kernel", 1700, 250, device=0, correlation=1),
        _x("gemm", "kernel", 1960, 30, device=1, correlation=2),
        # launched outside them (attention): not counted
        _x("cudaLaunchKernel", "cuda_runtime", 1300, 5, correlation=3),
        _x("attn", "kernel", 1310, 400, device=0, correlation=3),
        # a span outside the forward (the boot's own): not counted
        _x("dld.moe_ffn", "user_annotation", 3000, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 3010, 5, correlation=4),
        _x("gemm", "kernel", 3020, 70, device=0, correlation=4))
    assert _read("moe_ffn_ms", run) == pytest.approx(0.28)


def test_moe_ffn_ms_gives_none_without_its_spans_or_their_kernels():
    assert _read("moe_ffn_ms", types.SimpleNamespace(trace=None)) is None
    dense = _traced(FORWARD,
                    _x("cudaLaunchKernel", "cuda_runtime", 1300, 5,
                       correlation=3),
                    _x("attn", "kernel", 1310, 400, device=0, correlation=3))
    assert _read("moe_ffn_ms", dense) is None
    host_only = _traced(FORWARD,
                        _x("dld.moe_ffn", "user_annotation", 1100, 100))
    assert _read("moe_ffn_ms", host_only) is None
    assert _read("moe_ffn_ms", _traced(
        _x("dld.moe_ffn", "user_annotation", 1100, 100))) is None


def test_traced_tiny_run_reads_the_counters_of_the_stage_boots_and_experts(
        monkeypatch):
    """The four-card cell's path on the CPU at a tiny shape: its stage
    boots view their landed blobs (nothing copied), and the routed share
    is the forward's own route mask over every token and expert."""
    from distributed_llm_dissemination_tpu_torch.runtime import pp_serve

    cell = tiny_cell(STAGED)
    forwards = []  # each forward's route masks, the warm-up's first
    real = pp_serve.pod_forward

    def forward(*a, **k):
        from distributed_llm_dissemination_tpu_torch.models import llama

        route = llama.route_topk
        masks = []
        forwards.append(masks)

        def kept(weights, cfg):
            w = route(weights, cfg)
            masks.append(w > 0)
            return w

        monkeypatch.setattr(llama, "route_topk", kept)
        try:
            return real(*a, **k)
        finally:
            monkeypatch.setattr(llama, "route_topk", route)

    monkeypatch.setattr(pp_serve, "pod_forward", forward)
    res = bench_run.run_cell(cell, 2**31 + 7, 0.1, True, device="cpu")
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["boot_copied_share"]["value"] == 0
    window = forwards[1:]
    assert len(window) == res["diagnostics"]["rounds"]
    shares = []
    for masks in window:
        assert len(masks) == cell.shape.n_layers
        shares.append(100 * sum(int(m.sum()) for m in masks)
                      / sum(m.numel() for m in masks))
    assert got["moe_routed_share"]["value"] == pytest.approx(
        sum(shares) / len(shares))
    assert "moe_ffn_ms" not in got  # no device trace on the CPU
