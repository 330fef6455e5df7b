"""A whole run of each cell's path at a tiny shape on the CPU: the
reference judges the rounds, the result line has the keys the benchmark reads, and
a run whose timed path is broken underneath comes out not correct."""

import json

import pytest
import torch

from dissem_bench import run
from dissem_bench.tests.conftest import tiny_cell


def _run(cell, seconds=0.5, trace=False, seed=2**31 + 101):
    return run.run_cell(cell, seed, seconds, trace, device="cpu")


def test_sound_round_is_correct_and_the_line_has_its_keys(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} - {"peak_hbm_gb"} \
        == set(res["metrics"])  # no memory reading on the CPU
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert "ttd_s" in res["metrics"]
    checks = res["checks"]
    assert checks["blobs_mismatched"]["value"] == 0
    assert checks["leaves_mismatched"]["value"] == 0
    assert checks["logit_gap"]["value"] <= checks["logit_gap"]["limit"]
    assert res["diagnostics"]["judged_tokens"] >= 16
    json.dumps(res)


def test_traced_run_prints_per_layer_metrics(cell):
    res = _run(cell, seconds=0.1, trace=True)
    names = {m["name"] for m in cell.per_layer}
    assert set(res["metrics"]) <= names
    stems = {n.split(".")[0] for n in res["metrics"]}
    assert {"solve_ms", "upload_bytes", "boot_s", "first_forward_ms",
            "round_mfu"} <= stems
    held = cell.traffic["holders"][0]["where"]
    uploaded = next(v["value"] for k, v in res["metrics"].items()
                    if k.startswith("upload_bytes"))
    assert (uploaded == 0) == (held == "hbm")
    assert res["correct"]


def _alter_token(monkeypatch):
    from distributed_llm_dissemination_tpu_torch.runtime import pp_serve

    real = pp_serve.pod_forward

    def wrong(*a, **k):
        logits, s = real(*a, **k)
        return torch.roll(logits, 1, dims=-1), s

    monkeypatch.setattr(pp_serve, "pod_forward", wrong)


def _skip_exchange(monkeypatch):
    from distributed_llm_dissemination_tpu_torch.parallel import fabric

    real = fabric.FabricPlane.publish

    def empty(self, plan_id, offset, piece, *a, **k):
        return real(self, plan_id, offset, torch.zeros_like(piece), *a, **k)

    monkeypatch.setattr(fabric.FabricPlane, "publish", empty)


def _corrupt_landed(monkeypatch):
    from distributed_llm_dissemination_tpu_torch.runtime import receiver

    cls = receiver.FlowRetransmitReceiverNode
    real = cls._fabric_store

    def corrupt(self, layer_id, total, device_arr=None, host_buf=None):
        if device_arr is not None and layer_id == 0:
            device_arr[7] ^= 0x40
        return real(self, layer_id, total, device_arr=device_arr,
                    host_buf=host_buf)

    monkeypatch.setattr(cls, "_fabric_store", corrupt)


def _corrupt_served_head(monkeypatch):
    from distributed_llm_dissemination_tpu_torch.runtime import pp_serve

    real = pp_serve.assemble_pp_params

    def corrupt(*a, **k):
        mesh, stages, counts, head = real(*a, **k)
        return mesh, stages, counts, dict(head, ln_f=head["ln_f"] * 2)

    monkeypatch.setattr(pp_serve, "assemble_pp_params", corrupt)


def _upload_skipped(monkeypatch):
    """The seeders' uploads go uncounted, as if a round reused bytes
    that an earlier one left on the card."""
    from distributed_llm_dissemination_tpu_torch.utils import trace

    real = trace.count

    def count(name, n=1):
        if name != "fabric.upload_bytes":
            real(name, n)

    monkeypatch.setattr(trace, "count", count)


def _round_left_on_card(monkeypatch):
    from dissem_bench.paths import fabric

    real = fabric.Runner.round

    def kept(self, *a, **k):
        rec = real(self, *a, **k)
        rec["left_on_card"] = {0: 1 << 20}
        return rec

    monkeypatch.setattr(fabric.Runner, "round", kept)


@pytest.mark.parametrize("fault", [_alter_token, _skip_exchange,
                                   _corrupt_landed, _corrupt_served_head])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell, seconds=0.2)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault,check", [
    (_upload_skipped, "round_upload_bytes_least"),
    (_round_left_on_card, "left_on_card_bytes")])
def test_a_round_that_does_not_start_clean_is_not_correct(fault, check,
                                                         monkeypatch):
    fault(monkeypatch)
    res = _run(tiny_cell("mistral7b.fabric1.host_seeded"), seconds=0.2)
    assert not res["correct"]
    c = res["checks"][check]
    assert c["value"] != c["limit"]


def test_uploads_where_the_seeders_hold_device_copies_are_not_correct(
        monkeypatch):
    from dissem_bench.paths import fabric

    real = fabric.Runner.round

    def uploaded(self, *a, **k):
        rec = real(self, *a, **k)
        rec["counters"] = dict(rec["counters"], **{"fabric.upload_bytes": 1})
        return rec

    monkeypatch.setattr(fabric.Runner, "round", uploaded)
    res = _run(tiny_cell("mixtral8x7b.fabric4.hbm_seeded"), seconds=0.2)
    assert not res["correct"]
    assert res["checks"]["round_upload_bytes_most"] == {"value": 1,
                                                        "limit": 0}


def test_misrouted_experts_are_not_correct(monkeypatch):
    """Experts picked against the router (the two it likes least): the
    judge follows the routes, so the routing margin must catch it."""
    from distributed_llm_dissemination_tpu_torch.models import llama

    def misroute(weights, cfg):
        low = torch.topk(-weights, cfg.top_k, dim=-1).indices
        w = torch.zeros_like(weights).scatter(-1, low, 1.0)
        return w / w.sum(-1, keepdim=True)

    monkeypatch.setattr(llama, "route_topk", misroute)
    res = _run(tiny_cell("mixtral8x7b.fabric4.hbm_seeded"), seconds=0.2)
    assert not res["correct"]
    margin = res["checks"]["routing_margin"]
    assert margin["value"] > margin["limit"]


def test_no_card_means_no_result():
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "-m", "dissem_bench.run", "--workload",
         "mistral7b.fabric1.host_seeded", "--seed", "1", "--seconds", "1"],
        cwd=str(run.__file__).rsplit("/dissem_bench/", 1)[0],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_sample_rounds_follow_the_seed():
    assert run.sample_rounds(5, 10, 3) == run.sample_rounds(5, 10, 3)
    assert len(run.sample_rounds(5, 2, 3)) == 2
