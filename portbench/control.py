"""The readings that the correctness limits are set from, for one cell, in
one process: for each seed, a short window of the program at the cell's
own size and load, the numbers it reads against the reference (the lower
readings), and the same numbers with the control in the program's place:
the reference computed one precision step below the one the configuration
states (``reference/score.py``), which has to come out as not correct.

    python3 -m portbench.control --workload CELL --seconds S --seeds N [N ...] [--program-only N ...]

One JSON line per seed, then the largest program reading and the smallest
control reading of each number, beside the cell's limit."""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[], help="program and control")
    p.add_argument("--program-only", type=int, nargs="*", default=[], help="program alone")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .harness import load_cell, run_cell

    cell = load_cell(args.workload)
    high: dict = {}
    low: dict = {}
    jobs = [(s, True) for s in args.seeds] + [(s, False) for s in args.program_only]
    for seed, with_control in jobs:
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, t0, device=args.device)
        program = {c.name: c.value for c in out["checks"]}
        line = {"seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                "program": program}
        for k, v in program.items():
            high[k] = max(high.get(k, 0.0), v)
        if with_control:
            control = {c.name: c.value for c in out["op"].check(out["answered"], control=True)}
            line["control"] = control
            for k, v in control.items():
                low[k] = min(low.get(k, float("inf")), v)
        line["wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(line), flush=True)
        del out
    limits = cell.workload["limits"]
    for k in sorted(high):
        print(json.dumps({"number": k, "lower_reading": high[k], "control_reading": low.get(k),
                          "limit": limits.get(k.removesuffix("_gap"))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
