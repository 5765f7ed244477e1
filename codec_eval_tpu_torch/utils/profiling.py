"""Tracing: named spans and counters at the port's layer boundaries, and a
``torch.profiler`` trace of host and CUDA activity around a block.

Tracing has no switch of its own: it is on exactly while a
``torch.profiler`` session records on the calling thread (``device_trace``
below, or any profiler a caller starts).  Then ``span(name)`` opens a host
range on the profiler's clock, the clock of the CUDA activity it records,
and ``count(name, n)`` adds to an in-memory total.  With no profiler
recording, ``span`` returns one shared no-op context and ``count`` does
nothing, so the calls cost well under a microsecond each and can stay on
the hot path.

Span names are fixed strings ``ce.<layer>.<step>``; one call's spans nest
under its top span (``ce.session.image``, ``ce.gate.assert_quality``,
``ce.runner.score_pairs``).  The profiler records the thread that started
it: work on other threads, such as ``EvalSession.evaluate_corpus``'s
staging worker, is neither spanned nor counted.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_recording = torch._C._autograd._profiler_enabled
# A host range with no shadow on the device timeline: unlike
# ``record_function``, it is not a user annotation, for which the profiler
# adds a ``gpu_user_annotation`` range that covers the kernels it launched.
_HostRange = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

_counters: Dict[str, int] = {}
_counters_lock = threading.Lock()


def span(name: str):
    """A context manager: a host range ``name`` while a profiler records,
    otherwise a shared no-op."""
    if _recording():
        return _HostRange(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records (``n = 0``
    still makes the counter exist)."""
    if _recording():
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of the counters' totals."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block, host and CUDA
    activity, and write it into ``log_dir`` as a Chrome trace
    (``trace-<time>.json``; view it in Perfetto or ``chrome://tracing``).

    No-op when log_dir is None, so call sites can be left in place.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace-{time.time_ns()}.json"))
