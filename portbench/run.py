"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA devices as the cell asks for and exits with an error,
printing no result, without them.  With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
and the device's busy and window seconds.  Every number compared with the
reference is printed beside its limit, as the last lines of standard error
and under ``checks``, the result's last key.  A run that loaded JAX or the
JAX package exits with an error and prints no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(peak_bytes: int, trace=None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": peak_bytes}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def _num(v: float):
    """A number for strict JSON: a non-finite reading as its name."""
    return v if v == v and abs(v) != float("inf") else repr(v)


def build_result(out: dict, device: dict) -> dict:
    """The result line: the keys the contract names, then ``host`` (the
    set-up's phases, whether this run built the kernel library, and the
    CPU cores the process kept busy over the window), then ``checks`` last."""
    run = out["run"]
    result = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": out["metrics"],
        "device": device,
    }
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["host"] = {"setup_phases": out["setup_phases"],
                      "kernel_library_built": out["kernel_library_built"],
                      "window_cpu_cores": out["window_cpu_cores"]}
    result["checks"] = {c.name: {"value": _num(c.value), "limit": c.limit} for c in out["checks"]}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from .guard import forbidden_modules
    from .harness import load_cell, run_cell

    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    run = out["run"]
    result = build_result(out, device_info(run.peak_bytes, run.trace))
    walls = sorted(c.t1 - c.t0 for c in run.ok_calls)
    if walls:
        print(f"portbench: set-up {run.setup_s:.3f} s ("
              + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_phases"].items())
              + f"); window {run.window_s:.3f} s, {len(walls)} calls, call s min "
              f"{walls[0]:.4f} median {walls[len(walls) // 2]:.4f} max {walls[-1]:.4f}; "
              f"first call {run.ok_calls[0].t1 - run.ok_calls[0].t0:.4f}; "
              + ("kernel library built; " if out["kernel_library_built"] else "")
              + f"window cpu cores {out['window_cpu_cores']:.3f}"
              + "".join(f"; {k} mean {sum(c.spans[k] for c in run.ok_calls) / len(walls):.4f}"
                        for k in sorted(run.ok_calls[0].spans)), file=sys.stderr)
    if walls and run.trace is not None and run.trace.calls:
        print(f"portbench: traced {run.trace.calls} calls, {run.trace.window_s / run.trace.calls:.4f} "
              f"s per call (untraced {run.window_s / len(walls):.4f}); device busy "
              f"{run.trace.busy_s / run.trace.calls:.4f} s per call", file=sys.stderr)
    for err in out["errors"]:
        print(f"portbench: failed call: {err}", file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
