"""BENCHMARK.json and the files it names: every part of every cell is
found by name, the configurations give the published byte counts, and
the file keeps to the rules its reader enforces."""

import importlib
import json
import re

import pytest

from dissem_bench import layout, spec
from dissem_bench.tests.conftest import STAGED, load

BENCH = spec.read_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.traffic["path"] and spec.path_module(cell.traffic["path"])
    assert callable(spec.path_module(cell.traffic["path"]).Runner)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert cell.limits["logit_gap"] > 0
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "time_to_serve_s", "peak_hbm_gb"} <= names
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert {m["moves"] for m in cell.per_layer} <= names


@pytest.mark.parametrize("name,published_layers,total", [
    ("mistral-7b-v0.3", 32, 14_496_047_104),
    ("mixtral-8x7b-v0.1", 32, 93_405_585_408),
])
def test_published_byte_counts(name, published_layers, total):
    c = spec.read_json(spec.ROOT / "dissem_bench" / "configs" / f"{name}.json")
    c = dict(c, num_hidden_layers=published_layers)
    s = spec.shape_from_config(name, c)
    assert layout.model_nbytes(s) == total


def test_run_configs_byte_counts():
    m = spec.load_cell("mistral7b.fabric1.host_seeded").shape
    assert len(m.blob_ids) == 33
    assert layout.blob_nbytes(m, 0) == 436_224_000
    assert layout.blob_nbytes(m, m.head_id) == 536_879_104
    x = load(STAGED).shape
    assert layout.blob_nbytes(x, 0) == 2_902_540_288
    assert layout.blob_nbytes(x, x.head_id) == 524_296_192
    assert layout.model_nbytes(x) == 70_185_263_104


def test_reduced_lists_every_change_from_the_published_config():
    for c in BENCH["configs"]:
        f = spec.read_json(spec.ROOT / c["file"])
        changed = sorted(f.get("published", {}))
        assert sorted(c["reduced"]) == sorted(f["reduced"]) == changed
        assert f["source"] == c["source"]


def test_benchmark_json_keeps_to_its_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["dissem_bench"]
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e_cells = {m["name"]: set(m.get("workloads", cells))
                 for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # every cell a metric lists reports the metric it moves
        assert set(m["workloads"]) <= e2e_cells[m["moves"]]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_traffic_names_the_nodes_it_places():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        t = cell.traffic
        nodes = {t["leader"]} | {h["node"] for h in t["holders"]} | {
            s["node"] for s in t["stages"]}
        assert {int(k) for k in t["cards"]} == nodes
        assert max(t["cards"].values()) < w["chips"]
        held = sorted(b for h in t["holders"]
                      for b in spec.holder_blobs(h, cell.shape))
        goal = sorted(b for s in t["stages"]
                      for b in spec.holder_blobs(s, cell.shape))
        assert held == goal == cell.shape.blob_ids


def test_modules_are_found_by_file_name():
    for sub in ("paths", "metrics"):
        for p in (spec.PKG_DIR / sub).glob("[!_]*.py"):
            importlib.import_module(f"dissem_bench.{sub}.{p.stem}")
