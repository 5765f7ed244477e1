"""What the program records about itself while a profiler records, read by
the per-layer metrics of a traced run:

- its spans: host ranges named ``ce.<layer>.<step>``, among the trace's
  host events, and the CUDA runtime's calls that the profiler records
  inside them;
- its counters: ``codec_eval_tpu_torch.utils.profiling.counters()``, which
  count only while a profiler records, so that in a traced run they cover
  the traced window's calls.

A program without them (an older checkout) gives None, not an error."""

from __future__ import annotations

import bisect
from typing import Optional

#: CUDA runtime calls in which the host blocks until the device's queue drains.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def span_ms(trace, name: str) -> Optional[float]:
    """Host milliseconds of the spans ``name`` inside the traced window,
    summed; None without a trace or without such a span."""
    if trace is None:
        return None
    lo, hi = trace.window
    us = [e - s for n, s, e in trace.host if n == name and lo <= s and e <= hi]
    return sum(us) * 1e-3 if us else None


def wait_ms(trace, inside: str) -> Optional[float]:
    """Host milliseconds of the CUDA runtime's synchronising calls that lie
    inside the spans ``inside`` (which do not overlap) in the traced window,
    summed; None without a trace or without such a span."""
    if trace is None:
        return None
    lo, hi = trace.window
    spans = sorted((s, e) for n, s, e in trace.host if n == inside and lo <= s and e <= hi)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    us = 0.0
    for n, s, e in trace.host:
        if n in SYNC_CALLS:
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and e <= spans[k][1]:
                us += e - s
    return us * 1e-3


def counter(run, name: str) -> Optional[int]:
    """The program's counter ``name`` after a traced run; None without a
    trace, or where the program has no such counter."""
    if run.trace is None:
        return None
    try:
        from codec_eval_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get(name)
