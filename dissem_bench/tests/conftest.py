"""Shared helpers of the benchmark's CPU tests: a cell of the benchmark
with its configuration cut to a tiny shape, run through the same path on
the CPU.

Beside the cells of ``BENCHMARK.json`` the tests load the four-card
Mixtral cell whose files the benchmark keeps for a later entry
(``configs/mixtral-8x7b-v0.1.json``, ``traffic/fabric4.hbm_seeded.json``,
``limits/mixtral8x7b.fabric4.hbm_seeded.json``): it drives the expert
path, the seeders' device copies and the cross-card reader."""

import copy
import dataclasses

import pytest

from dissem_bench import spec

TINY = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=256, num_hidden_layers=4, vocab_size=256,
            head_dim=32)
DENSE = "mistral7b.fabric1.host_seeded"
STAGED = "mixtral8x7b.fabric4.hbm_seeded"
WORKLOADS = (DENSE, STAGED)


def bench() -> dict:
    """``BENCHMARK.json`` with the kept four-card cell added, reporting
    every per-layer metric the file names and the cross-card share."""
    b = copy.deepcopy(spec.read_json(spec.ROOT / "BENCHMARK.json"))
    b["configs"].append({"name": "mixtral-8x7b-v0.1",
                         "file": "dissem_bench/configs/mixtral-8x7b-v0.1.json"})
    b["workloads"].append({"name": STAGED, "config": "mixtral-8x7b-v0.1",
                           "traffic": "fabric4.hbm_seeded", "chips": 4})
    for m in b["per_layer"]:
        m["workloads"] = m["workloads"] + [STAGED]
    b["per_layer"].append({"name": "cross_card_ceiling_share", "unit": "%",
                           "moves": "time_to_serve_s",
                           "workloads": [STAGED]})
    return b


def load(workload: str) -> spec.Cell:
    return spec.load_cell(workload, bench())


def tiny_cell(workload: str, tokens: int = 16) -> spec.Cell:
    cell = load(workload)
    name = "bench-tiny-moe" if cell.shape.n_experts else "bench-tiny"
    shape = spec.shape_from_config(name, dict(cell.config, **TINY))
    return dataclasses.replace(
        cell, shape=shape, traffic=dict(cell.traffic, prompt_tokens=tokens))


@pytest.fixture(params=WORKLOADS)
def cell(request):
    return tiny_cell(request.param)
