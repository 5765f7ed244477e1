"""The device trace of a few calls: ``torch.profiler`` over CPU and CUDA
activity, reduced in memory to the numbers the per-layer readers take.
Nothing is written to disk."""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: (name, start_us, end_us) on the profiler's clock.
Event = Tuple[str, float, float]

WINDOW = "portbench.traced_window"


def is_copy(name: str) -> bool:
    """A memory copy or fill on the device, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class Trace:
    """A traced window: device events clipped to it, host events, and how
    many calls and pairs it held."""

    window: Tuple[float, float]
    device: List[Event]
    host: List[Event]
    calls: int
    pairs: int
    #: Per work of ``yardstick/kernel_work.json``: (sum of bound ms over the
    #: calls recorded, number of calls recorded).
    bounds: Dict[str, Tuple[float, int]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return merge([(s, e) for _, s, e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernels(self) -> List[Event]:
        return [ev for ev in self.device if not is_copy(ev[0])]

    def time_by_name(self) -> Dict[str, float]:
        """Device seconds per operation name."""
        out: Dict[str, float] = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s) * 1e-6
        return out

    def time_matching(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose name matches a pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum((e - s) * 1e-6 for name, s, e in self.kernels()
                   if any(r.search(name) for r in rx))

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds of the device, summed by what the host was doing at
        each gap's middle (the innermost host event there), longest first."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        host = sorted(self.host, key=lambda ev: ev[1])
        starts = [ev[1] for ev in host]
        by_name: Dict[str, float] = {}
        for i in range(0, len(edges), 2):
            s, e = max(edges[i], lo), min(edges[i + 1], hi)
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name, best = "(no host event)", None
            j = bisect.bisect_right(starts, mid)
            for k in range(j - 1, max(-1, j - 4000), -1):
                hn, hs, he = host[k]
                if he >= mid and (best is None or he - hs < best):
                    name, best = hn, he - hs
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in self.idle_gaps()[:top]]}


def profile(fn: Callable[[], Tuple[int, int]]) -> Trace:
    """Run ``fn`` (which makes calls and returns how many calls and pairs)
    under the profiler; the window is ``fn``'s own span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WINDOW):
            calls, pairs = fn()
            if cuda:
                torch.cuda.synchronize()
    window: Optional[Tuple[float, float]] = None
    device: List[Event] = []
    host: List[Event] = []
    for ev in prof.events():
        tr = ev.time_range
        if getattr(ev, "is_user_annotation", False) and ev.device_type == DeviceType.CUDA:
            continue  # a host span's shadow on the device timeline, not device work
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith("portbench."):
                continue
            device.append((ev.name, float(tr.start), float(tr.end)))
        elif ev.name == WINDOW:
            window = (float(tr.start), float(tr.end))
        else:
            host.append((ev.name, float(tr.start), float(tr.end)))
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    lo, hi = window
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    return Trace(window=window, device=device, host=host, calls=calls, pairs=pairs)
