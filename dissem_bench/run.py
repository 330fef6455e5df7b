"""Run one cell of the benchmark and print its result as the last line.

    python3 -m dissem_bench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s`` from the start of this process): import
torch, read the cell's files, make the seeders' blobs from the seed, and
run one whole round that warms every kernel, library and solver the
rounds use.  Then a closed loop of rounds while the window is open: every
round started is finished and counted.  After the window: the device
peak is read, the last round's dests (landed blobs, booted stage leaves,
the head leaves served with) are compared byte for byte with the blobs
handed to the seeders, every round is checked to have started with
nothing of the last one on the cards and to have uploaded every byte its
seeders hold in host memory, the dests are freed, and the plain float32
reference (``reference/model.py``) judges the served tokens of a sample
of the rounds, drawn from the seed.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1``
profiles the first round of the window with ``torch.profiler`` and
prints the per-layer metrics (``metrics/<name>.py``) and a breakdown.
The program's own output goes to standard error, so that the last line
of standard output is the result.  The run needs the cell's cards; it
exits non-zero with no result without them, or if JAX or the JAX package
was loaded into this process.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_llm_dissemination_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (the port's name begins with the JAX
    package's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def sample_rounds(seed: int, n: int, k: int) -> List[int]:
    from .weights import mix

    return sorted(random.Random(mix(seed, 7)).sample(range(n), min(k, n)))


def judge_tokens(cell, runner, rounds, seed,
                 control: Optional[str] = None) -> Dict[str, float]:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over every position of the sampled rounds; for
    experts the reference follows each round's own routes, and the
    routing margin says how far those stray from its own top-k.

    ``control``: a variant of the reference (``reference/model.py``) is
    put in the program's place: its first-ranked tokens and its own
    routes stand for the served ones of the same rounds, and are judged
    the same way."""
    import torch

    from .reference import model as ref

    k = int(cell.limits.get("sample_rounds", 3))
    picked = [r for r in sample_rounds(seed, len(rounds), k)
              if rounds[r]["ids"] is not None]
    out = {"logit_gap": float("inf"), "judged_tokens": 0}
    experts = bool(cell.shape.n_experts)
    if experts:
        out["routing_margin"] = float("inf")
        if control is None:
            picked = [r for r in picked
                      if len(rounds[r]["routes"]) == cell.shape.n_layers]
    if not picked:
        return out
    layer_leaves, head, dev = runner.reference_inputs()
    tokens = torch.cat([rounds[r]["prompt"] for r in picked])
    if control is None:
        served = torch.cat([rounds[r]["ids"] for r in picked])
        routes = None
        if experts:
            routes = [torch.cat([rounds[r]["routes"][i] for r in picked])
                      for i in range(cell.shape.n_layers)]
        res = ref.forward(cell.shape, layer_leaves, head, tokens, dev,
                          routes=routes)
    else:
        res = ref.forward(cell.shape, layer_leaves, head, tokens, dev,
                          variants=(control, "f32"),
                          routes=control if experts else None)
        served = res["logits"][control].argmax(-1)
    out["logit_gap"] = float(ref.served_gap(res["logits"]["f32"],
                                            served).max())
    out["judged_tokens"] = served.numel()
    if experts:
        out["routing_margin"] = res["routing_margin"]
    return out


def _checks(cell, delivery, judged, rounds, failed, left_after,
            uploads) -> Dict[str, dict]:
    """Each number compared, with its limit.  ``uploads``: the least
    bytes a round has to upload from host memory and the most it may
    (None: no most), from the traffic's holders."""
    lim = cell.limits
    left = [max(r["left_on_card"].values(), default=0) for r in rounds]
    left.append(max(left_after.values(), default=0))
    up = [int(r["counters"].get("fabric.upload_bytes", 0)) for r in rounds]
    rows = {
        "logit_gap": (judged["logit_gap"], float(lim["logit_gap"]), "max"),
        "routing_margin": (judged.get("routing_margin"),
                           lim.get("routing_margin"), "max"),
        "blobs_mismatched": (delivery["blobs_mismatched"], 0, "max"),
        "leaves_mismatched": (delivery["leaves_mismatched"], 0, "max"),
        "left_on_card_bytes": (max(left), 0, "max"),
        "round_upload_bytes_least": (min(up, default=None), uploads[0],
                                     "min"),
        "round_upload_bytes_most": (max(up, default=None)
                                    if uploads[1] is not None else None,
                                    uploads[1], "max"),
        "rounds_failed": (failed, 0, "max"),
        "rounds_done": (len(rounds), 1, "min"),
    }
    out = {}
    for name, (v, limit, kind) in rows.items():
        if v is None:
            continue  # not a number of this cell (routing: dense models)
        ok = v <= limit if kind == "max" else v >= limit
        out[name] = {"value": v, "limit": limit,
                     "rule": "at most" if kind == "max" else "at least",
                     "ok": bool(ok)}
    return out


def _trace_reading(trace_path, cards) -> dict:
    from .devtrace import Trace

    tr = Trace.load(trace_path)
    window = tr.span("bench.run_pod")
    if window is None:
        return {"trace": tr, "window": None}
    t0, t1 = window
    busy = [tr.busy_s(c, t0, t1) for c in cards]
    gaps = []
    for c in cards:
        for a, b in tr.idle_gaps(c, t0, t1):
            gaps.append([f"{tr.host_label((a + b) / 2)} (cuda:{c})",
                         (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"trace": tr, "window": window,
            "busy_s": statistics.fmean(busy), "window_s": (t1 - t0) / 1e6,
            "breakdown": {"device_ops": tr.device_ops(t0, t1),
                          "idle_gaps": gaps[:10]}}


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None,
             started: float = T_START, control: Optional[str] = None
             ) -> dict:
    """Set up, warm up, run the window and judge it; returns the result
    object (the last line's content).  ``device``: None = the traffic's
    cards; ``"cpu"`` runs the same path on the CPU (tests).  ``control``:
    judge a reference variant's tokens in place of the served ones
    (``control.py``; never in a benchmark run)."""
    import torch

    from . import spec, weights
    from .metrics import mean

    on_card = device != "cpu"
    tokens = int(cell.traffic["prompt_tokens"])
    parts = {"start_s": time.monotonic() - started}
    t = time.monotonic()
    runner = spec.path_module(cell.traffic["path"]).Runner(cell, seed, device)
    runner.setup()
    parts["holdings_s"] = time.monotonic() - t
    t = time.monotonic()
    runner.round(weights.prompt(cell.shape, seed, -1, tokens))  # warm-up
    runner.mark_baseline()
    parts["warmup_s"] = time.monotonic() - t
    cards = runner.cards
    setup_peak = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    setup_s = time.monotonic() - started

    rounds: List[dict] = []
    failed = 0
    tmp = tempfile.TemporaryDirectory() if trace else None
    trace_path = tmp and os.path.join(tmp.name, "round.json")
    t_open = time.monotonic()
    while time.monotonic() < t_open + seconds:
        prompt = weights.prompt(cell.shape, seed, len(rounds), tokens)
        profiled = trace and not rounds
        try:
            if profiled:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if on_card:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                with torch.profiler.profile(activities=acts) as prof:
                    rec = runner.round(prompt, traced=True)
                prof.export_chrome_trace(trace_path)
            else:
                rec = runner.round(prompt)
        except Exception:  # noqa: BLE001 -- a failed round is counted
            failed += 1
            traceback.print_exc()
            break
        rec["prompt"] = prompt
        rounds.append(rec)
    window_s = time.monotonic() - t_open
    peak = {c: torch.cuda.max_memory_allocated(c) for c in cards}
    memory_peak = max([max(setup_peak[c], peak[c]) for c in cards] or [0])

    delivery = runner.check_delivery()
    left = runner.release()
    judged = judge_tokens(cell, runner, rounds, seed, control)
    checks = _checks(cell, delivery, judged, rounds, failed, left,
                     runner.upload_limits)

    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": len(rounds) + failed, "failed": failed}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        reading = _trace_reading(trace_path, cards) if on_card else {}
        tmp.cleanup()
        run = types.SimpleNamespace(
            shape=cell.shape, rounds=rounds, tokens=tokens,
            cards=cards, chips=cell.chips, probe_gbps=runner.probe_gbps,
            seeders_in_hbm=runner.seeders_in_hbm,
            trace=reading.get("trace"), window=reading.get("window"))
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if "busy_s" in reading:
            dev["busy_s"] = reading["busy_s"]
            dev["window_s"] = reading["window_s"]
            breakdown = reading["breakdown"]
    else:
        e2e = {"ttd_s": mean(r["ttd_s"] for r in rounds),
               "time_to_serve_s": mean(r["time_to_serve_s"] for r in rounds),
               "peak_hbm_gb": (max(peak.values()) / 1e9 if peak else None),
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    runner.close()
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["diagnostics"] = {
        "window_s": window_s, "rounds": len(rounds), "setup_parts": parts,
        "round_s": [r["round_s"] for r in rounds],
        "ttd_s": [r["ttd_s"] for r in rounds],
        "time_to_serve_s": [r["time_to_serve_s"] for r in rounds],
        "upload_bytes": [r["counters"].get("fabric.upload_bytes", 0)
                         for r in rounds],
        "peak_by_card": peak, "probe_gbps": runner.probe_gbps,
        "judged_tokens": judged["judged_tokens"]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    for name, c in checks.items():
        print(f"check {name}: {c['value']} ({c['rule']} {c['limit']}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dissem_bench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    from . import spec

    cell = spec.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this host "
              f"has {have}", file=sys.stderr)
        return 2
    stdout = sys.stdout
    sys.stdout = sys.stderr  # the port's prints go to standard error
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    finally:
        sys.stdout = stdout
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
