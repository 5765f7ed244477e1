"""The benchmark's driver: finds a cell's files by name, makes its inputs
from the seed, warms up, measures a window of closed-loop calls into the
program, optionally traces a few more, reads the cell's metrics, and holds
what the calls produced to the plain reference.

Everything that belongs to one cell, configuration, traffic mix, program
entry or metric is a file of its own, found by name:

- ``BENCHMARK.json`` (the repository root): cells, configurations, metrics;
- ``configs/<config>.json``: the deployment's sizes (the ``file`` it names);
- ``traffic/<traffic>.json``: the mix, read by the entry ``ops/<op>.py``
  (every cell is one client in a closed loop: a call starts when the last
  one has returned);
- ``workloads/<cell>.json``: the cell's trace length and correctness limits;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import resource
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell with its files, as ``BENCHMARK.json`` names them."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` of the checkout at ``root``."""
    here = root / HERE.name
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    return Cell(
        name=name,
        entry=entry,
        config=config,
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(here / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_op(name: str):
    """The program entry a traffic mix drives: ``ops/<name>.py``."""
    return importlib.import_module(f"portbench.ops.{name}")


def load_reader(metric: str) -> Callable:
    return load_module(HERE / "metrics" / f"{metric}.py", f"portbench.metrics.{metric}").read


@dataclass
class Call:
    """One call of the window: host clock, pairs it scored, what the op
    keeps of its answer for the check, and its spans (seconds by name)."""

    t0: float
    t1: float
    pairs: int
    answer: Any = None
    spans: Dict[str, float] = field(default_factory=dict)
    error: Optional[str] = None


@dataclass
class Run:
    """What the metric readers see."""

    cell: Cell
    seed: int
    setup_s: float
    window: tuple
    calls: List[Call]
    peak_bytes: int
    trace: Any = None

    @property
    def ok_calls(self) -> List[Call]:
        return [c for c in self.calls if c.error is None]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


@dataclass
class Check:
    """One number compared with its limit: correct when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _call(op, i: int) -> Call:
    from torch.profiler import record_function

    t0 = time.perf_counter()
    try:
        with record_function("portbench.call"):
            pairs, answer, spans = op.call(i)
        error = None
    except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
        pairs, answer, spans, error = 0, None, {}, f"{type(e).__name__}: {e}"
    return Call(t0, time.perf_counter(), pairs, answer, spans, error)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda") -> dict:
    """One run: set-up, warm-up, a window of ``seconds``, the trace when
    asked, the metrics, then the check against the reference."""
    import torch

    import codec_eval_tpu_torch  # noqa: F401

    t_lib = time.perf_counter()
    built = False
    if device == "cuda":
        from codec_eval_tpu_torch.kernels.cuda import _lib

        built = not _lib.library_path().exists()
        _lib.load()
    t_op = time.perf_counter()
    op = load_op(cell.traffic["op"]).Op(cell, seed, device)
    op.setup()
    t_warm = time.perf_counter()
    op.warmup()
    if device == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    phases = {"imports": t_lib - t_start, "kernel_library": t_op - t_lib,
              "inputs_and_program": t_warm - t_op, "warmup": t_end - t_warm}

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls: List[Call] = []
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    w0 = time.perf_counter()
    while True:
        calls.append(_call(op, len(calls)))
        if calls[-1].t1 - w0 >= seconds:
            break
    window = (w0, calls[-1].t1)
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu_cores = ((use1.ru_utime + use1.ru_stime) - (use0.ru_utime + use0.ru_stime)) / (window[1] - w0)
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0

    traced = None
    calls_after: List[Call] = []
    if trace:
        from . import spans
        from .trace import profile

        log: list = []

        def traced_calls():
            with spans.kernel_calls(log):
                for k in range(int(cell.workload["trace_calls"])):
                    calls_after.append(_call(op, len(calls) + k))
            return len(calls_after), sum(c.pairs for c in calls_after)

        traced = profile(traced_calls)
        traced.bounds = spans.work_bounds(log)

    run = Run(cell, seed, setup_s, window, calls, peak, traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    answered = [c for c in calls + calls_after if c.error is None]
    op.release()
    checks = op.check(answered)
    failed = sum(c.error is not None for c in calls + calls_after)
    return {
        "run": run,
        "op": op,
        "answered": answered,
        "setup_phases": phases,
        "kernel_library_built": built,
        "window_cpu_cores": cpu_cores,
        "metrics": metrics,
        "checks": checks,
        "attempted": len(calls) + len(calls_after),
        "failed": failed,
        "errors": sorted({c.error for c in calls + calls_after if c.error})[:5],
        "correct": failed == 0 and bool(checks) and all(c.ok for c in checks),
    }
