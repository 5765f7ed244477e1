"""Run cells several times, each run a process of its own as the check
runs it, and report each metric's spread: the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) as a share of
the median.

    python3 -m portbench.spread --out DIR --runs CELL:SEED[,SEED...][:TRACE] ...

Each run's standard output and error go to ``DIR/<k>.<cell>.<seed>.<trace>.{out,err}``
(k counts the runs);
one summary line per run and the spreads per cell are printed."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values):
    """(q3 - q1) / median, or None under four values."""
    if len(values) < 4:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def run_one(cell: str, seed: int, seconds: int, trace: int, out: Path, k: int) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    stem = f"{k:03d}.{cell}.{seed}.{trace}"
    (out / f"{stem}.out").write_text(proc.stdout)
    (out / f"{stem}.err").write_text(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"cell": cell, "seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": wall,
            "result": result, "stderr_tail": proc.stderr[-1500:] if result is None else ""}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=int, default=None,
                   help="run length (default: BENCHMARK.json's run_seconds)")
    p.add_argument("--runs", nargs="+", required=True, help="CELL:SEED[,SEED...][:TRACE]")
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads(Path("BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    per_cell: dict = {}
    n_run = 0
    for spec in args.runs:
        parts = spec.split(":")
        cell, seeds = parts[0], [int(s) for s in parts[1].split(",")]
        trace = int(parts[2]) if len(parts) > 2 else 0
        for seed in seeds:
            r = run_one(cell, seed, seconds, trace, out, n_run)
            n_run += 1
            res = r["result"] or {}
            metrics = {k: v["value"] for k, v in res.get("metrics", {}).items()}
            checks = {k: v["value"] for k, v in res.get("checks", {}).items()}
            print(json.dumps({"cell": cell, "seed": seed, "trace": trace, "rc": r["rc"],
                              "wall_s": round(r["wall_s"], 1), "correct": res.get("correct"),
                              "attempted": res.get("attempted"), "metrics": metrics,
                              "checks": checks, "device": res.get("device"),
                              "host": res.get("host"), "err": r["stderr_tail"]}), flush=True)
            if trace == 0 and res:
                for k, v in metrics.items():
                    per_cell.setdefault(cell, {}).setdefault(k, []).append(v)
    for cell, metrics in per_cell.items():
        print(json.dumps({"cell": cell, "spread": {k: spread(v) for k, v in metrics.items()},
                          "median": {k: statistics.median(v) for k, v in metrics.items()}}))
    (out / "summary.json").write_text(json.dumps(per_cell))
    return 0


if __name__ == "__main__":
    sys.exit(main())
