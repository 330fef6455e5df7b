"""The control of the comparison that decides ``correct``.

The reference put in the program's place one precision below the served
bfloat16: float8 e4m3 weights and activations at every weight product
(``reference/model.py``, variant ``"fp8"``).  For each seed this runs
the cell as a benchmark run does, with a short window, and then judges
the control's first-ranked tokens (and, for experts, its own routes) in
place of the served ones, through the run's own checks: ``correct``
has to come out false.  Benchmark runs give the program's readings of
the same numbers; each limit lies between the two.

    python3 -m dissem_bench.control --workload <name> --seeds 1,2,3 \\
        [--seconds 12]

Prints one JSON line per seed and a summary line; not part of a run.
"""

from __future__ import annotations

import argparse
import json
import sys

CONTROL = "fp8"


def control_run(cell, seed: int, seconds: float, device=None) -> dict:
    """One run of the cell whose judged tokens are the control's:
    ``{"seed", "correct", "checks"}``."""
    from . import run

    res = run.run_cell(cell, seed, seconds, False, device=device,
                       control=CONTROL)
    return {"seed": seed, "correct": res["correct"], "checks": res["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dissem_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args(argv)
    from . import spec

    cell = spec.load_cell(args.workload)
    rows = []
    stdout = sys.stdout
    for s in args.seeds.split(","):
        sys.stdout = sys.stderr  # the port's prints go to standard error
        try:
            rows.append(control_run(cell, int(s), args.seconds))
        finally:
            sys.stdout = stdout
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "control": CONTROL,
                      "seeds": len(rows),
                      "any_correct": any(r["correct"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
