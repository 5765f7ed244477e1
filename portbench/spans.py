"""Spans and recorders the benchmark puts around calls into the program,
from its own files: a timer on a method of one object, and, for a traced
window, a recorder of the shapes each kernel wrapper is called with."""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

WORK_TABLE = Path(__file__).resolve().parent / "yardstick" / "kernel_work.json"


def time_method(obj, name: str, sink: List[float]) -> None:
    """Wrap ``obj.name`` (on the instance) so that each call appends its
    wall seconds to ``sink``; under the profiler the call is a host span
    ``portbench.<name>``."""
    from torch.profiler import record_function

    inner = getattr(obj, name)

    @functools.wraps(inner)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            with record_function(f"portbench.{name}"):
                return inner(*args, **kwargs)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def record_results(cls, name: str, sink: list) -> None:
    """Wrap ``cls.name`` so that each call's result is appended to ``sink``
    (for a program entry whose answers the caller does not get back)."""
    inner = getattr(cls, name)

    @functools.wraps(inner)
    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(out)
        return out

    setattr(cls, name, recorded)


def load_work_table() -> dict:
    return json.loads(WORK_TABLE.read_text())["works"]


def _summary(args, kwargs) -> Tuple[list, list]:
    """(shapes of tensor arguments, numeric scalars), in call order."""
    import torch

    shapes, scalars = [], []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            shapes.append(tuple(a.shape))
        elif isinstance(a, (int, float)) and not isinstance(a, bool):
            scalars.append(float(a))
    return shapes, scalars


@contextlib.contextmanager
def kernel_calls(log: List[Tuple[str, str, list, list]]):
    """Within the block, every call of a wrapper that the work table names
    appends (work, count, shapes, scalars) to ``log``.  Each module of the
    program that holds the wrapper under any name gets the recorder; all
    are restored after."""
    table = load_work_table()
    patched = []
    try:
        for work, spec in table.items():
            for target, count in spec["calls"].items():
                mod_name, attr = target.split(":")
                try:
                    original = getattr(importlib.import_module(mod_name), attr)
                except (ImportError, AttributeError):
                    continue

                def recorder(*args, _o=original, _w=work, _c=count, **kwargs):
                    shapes, scalars = _summary(args, kwargs)
                    log.append((_w, _c, shapes, scalars))
                    return _o(*args, **kwargs)

                functools.update_wrapper(recorder, original)
                for mod in list(sys.modules.values()):
                    if not getattr(mod, "__name__", "").startswith("codec_eval_tpu_torch"):
                        continue
                    for key, val in list(vars(mod).items()):
                        if val is original:
                            setattr(mod, key, recorder)
                            patched.append((mod, key, original))
        yield
    finally:
        for mod, key, original in reversed(patched):
            setattr(mod, key, original)


def work_bounds(log) -> Dict[str, Tuple[float, int]]:
    """{work: (sum of bound ms, calls)} of a ``kernel_calls`` log."""
    from .yardstick.counts import call_bound_ms

    out: Dict[str, Tuple[float, int]] = {}
    for work, count, shapes, scalars in log:
        ms, n = out.get(work, (0.0, 0))
        out[work] = (ms + call_bound_ms(count, shapes, scalars), n + 1)
    return out
