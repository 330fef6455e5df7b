"""Finding a cell's parts by name: ``BENCHMARK.json``, the configuration
file, the traffic file, the path runner, the metric readers and the
limits.  Everything is read relative to the benchmark's root (the
checkout the command runs in)."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Any, Dict, List

import torch

from .layout import Shape

PKG_DIR = Path(__file__).resolve().parent
ROOT = PKG_DIR.parent
DTYPES = {"bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    shape: Shape
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, Any]


def read_json(path) -> Any:
    with open(path) as f:
        return json.load(f)


def shape_from_config(name: str, c: Dict[str, Any]) -> Shape:
    """The sizes a config file gives, in the published ``config.json``
    keys."""
    d, heads = int(c["hidden_size"]), int(c["num_attention_heads"])
    return Shape(
        name=name, vocab=int(c["vocab_size"]), d_model=d,
        n_layers=int(c["num_hidden_layers"]), n_heads=heads,
        n_kv_heads=int(c["num_key_value_heads"]),
        head_dim=int(c.get("head_dim") or d // heads),
        d_ff=int(c["intermediate_size"]), rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]),
        n_experts=int(c.get("num_local_experts") or 0),
        top_k=int(c.get("num_experts_per_tok") or 0),
        dtype=DTYPES[c["torch_dtype"]])


def load_cell(workload: str, bench=None) -> Cell:
    """The cell ``workload`` of ``bench`` (default: ``BENCHMARK.json``)."""
    if bench is None:
        bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(ROOT / conf_entry["file"])
    traffic = read_json(PKG_DIR / "traffic" / f"{w['traffic']}.json")

    def applies(m):
        return workload in m.get("workloads", [workload])

    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        shape=shape_from_config(w["config"], config), traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        limits=read_json(PKG_DIR / "limits" / f"{workload}.json"))


def path_module(name: str):
    """The runner of a traffic's path: ``dissem_bench/paths/<name>.py``."""
    return importlib.import_module(f"dissem_bench.paths.{name}")


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return importlib.import_module(f"dissem_bench.metrics.{name}").read


def port_config(shape: Shape):
    """The port's ``ModelConfig`` for ``shape``, registered in the port's
    model table under the configuration's name (the table is how the
    port's boot and pod serve resolve a model by name)."""
    from distributed_llm_dissemination_tpu_torch.models import llama

    if shape.head_dim * shape.n_heads != shape.d_model:
        raise ValueError(f"{shape.name}: the port derives head_dim as "
                         "d_model / n_heads")
    mcfg = llama.ModelConfig(
        name=shape.name, vocab=shape.vocab, d_model=shape.d_model,
        n_layers=shape.n_layers, n_heads=shape.n_heads,
        n_kv_heads=shape.n_kv_heads, d_ff=shape.d_ff,
        rope_theta=shape.rope_theta, norm_eps=shape.norm_eps,
        dtype=shape.dtype, n_experts=shape.n_experts,
        top_k=shape.top_k or 2)
    llama.CONFIGS[shape.name] = mcfg
    return mcfg


def layer_range(frac, n_layers: int) -> List[int]:
    """Layer ids of a ``[from, to)`` share of the layers, as fractions."""
    lo, hi = (round(float(x) * n_layers) for x in frac)
    return list(range(lo, hi))


def holder_blobs(entry: Dict[str, Any], shape: Shape) -> List[int]:
    """The blob ids a traffic file's holder or stage entry names."""
    ids = layer_range(entry["layers"], shape.n_layers)
    return ids + ([shape.head_id] if entry.get("head") else [])
