"""Scalar statistics + BD-Rate.

Host copy of ``codec_eval_tpu/stats/summary.py`` (the port imports
nothing from the JAX package).

Behavioral port of the reference's stats core (reference:
src/stats/mod.rs:37-372): Summary (population std-dev), R-7 percentiles,
sample std_dev for the free function, trimmed mean, IQR, and Bjontegaard
delta-rate with the reference's exact integration semantics.

These are host-side (numpy f64) — they consume a handful of scalars per
curve; the heavy per-pixel work happens in the device kernels.  Batched
on-device variants for corpus-scale reductions live in the JAX package's
``codec_eval_tpu.parallel``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _sorted(values: Sequence[float]) -> np.ndarray:
    return np.sort(np.asarray(values, dtype=np.float64))


def percentile_sorted(sorted_vals: np.ndarray, p: float) -> float:
    """R-7 linear interpolation on pre-sorted values; accepts 0-1 or 0-100.
    reference: src/stats/mod.rs:276-303."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_vals[0])
    if p > 1.0:
        p = p / 100.0
    p = min(max(p, 0.0), 1.0)
    idx = p * (n - 1)
    lower = int(np.floor(idx))
    upper = int(np.ceil(idx))
    frac = idx - lower
    if lower == upper:
        return float(sorted_vals[lower])
    return float(sorted_vals[lower] * (1.0 - frac) + sorted_vals[upper] * frac)


def percentile(values: Sequence[float], p: float) -> float:
    """R-7 percentile (p in 0..1).  reference: src/stats/mod.rs:185."""
    if len(values) == 0:
        return 0.0
    return percentile_sorted(_sorted(values), p)


def percentile_u32(values: Sequence[int], p: float) -> int:
    """Integer percentile, rounded.  reference: src/stats/mod.rs:207."""
    if len(values) == 0:
        return 0
    s = np.sort(np.asarray(values, dtype=np.float64))
    pos = min(max(p, 0.0), 1.0) * (len(s) - 1)
    lower = int(np.floor(pos))
    upper = min(lower + 1, len(s) - 1)
    frac = pos - lower
    return int(round(s[lower] * (1.0 - frac) + s[upper] * frac))


def mean(values: Sequence[float]) -> float:
    if len(values) == 0:
        return 0.0
    return float(np.mean(np.asarray(values, dtype=np.float64)))


def median(values: Sequence[float]) -> float:
    """Even-length: average of two middle values.  reference: src/stats/mod.rs:116."""
    if len(values) == 0:
        return 0.0
    s = _sorted(values)
    mid = len(s) // 2
    if len(s) % 2 == 0:
        return float((s[mid - 1] + s[mid]) / 2.0)
    return float(s[mid])


def std_dev(values: Sequence[float]) -> float:
    """Sample standard deviation (N-1).  reference: src/stats/mod.rs:160."""
    if len(values) < 2:
        return 0.0
    return float(np.std(np.asarray(values, dtype=np.float64), ddof=1))


def trimmed_mean(values: Sequence[float], trim_pct: float) -> float:
    """Mean after trimming trim_pct from each end.  reference: src/stats/mod.rs:242."""
    if len(values) == 0:
        return 0.0
    s = _sorted(values)
    trim_count = int(len(s) * min(max(trim_pct, 0.0), 0.5))
    if trim_count * 2 >= len(s):
        return median(values)
    trimmed = s[trim_count : len(s) - trim_count]
    return float(np.mean(trimmed))


def iqr(values: Sequence[float]) -> float:
    """Interquartile range.  reference: src/stats/mod.rs:269."""
    return percentile(values, 0.75) - percentile(values, 0.25)


@dataclass
class Summary:
    """Descriptive statistics.  reference: src/stats/mod.rs:37-97.

    Note: ``std_dev`` here is the *population* deviation (N denominator),
    matching ``Summary::compute``; the free function :func:`std_dev` is the
    sample deviation (N-1), matching the reference's split behavior.
    """

    count: int
    mean: float
    median: float
    std_dev: float
    min: float
    max: float
    p5: float
    p25: float
    p75: float
    p95: float

    @classmethod
    def compute(cls, values: Sequence[float]) -> Optional["Summary"]:
        if len(values) == 0:
            return None
        s = _sorted(values)
        m = float(np.mean(s))
        variance = float(np.mean((s - m) ** 2))
        return cls(
            count=len(s),
            mean=m,
            median=percentile_sorted(s, 0.5),
            std_dev=float(np.sqrt(variance)),
            min=float(s[0]),
            max=float(s[-1]),
            p5=percentile_sorted(s, 0.05),
            p25=percentile_sorted(s, 0.25),
            p75=percentile_sorted(s, 0.75),
            p95=percentile_sorted(s, 0.95),
        )

    def to_json(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "median": self.median,
            "std_dev": self.std_dev,
            "min": self.min,
            "max": self.max,
            "p5": self.p5,
            "p25": self.p25,
            "p75": self.p75,
            "p95": self.p95,
        }


def _integrate_curve(points: List[Tuple[float, float]], min_x: float, max_x: float) -> float:
    """Trapezoidal integration with the reference's exact clipping behavior
    (x clipped to range, y endpoints NOT re-interpolated).
    reference: src/stats/mod.rs:375-396."""
    area = 0.0
    for (y0, x0), (y1, x1) in zip(points, points[1:]):
        if x1 < min_x or x0 > max_x:
            continue
        x0c = max(x0, min_x)
        x1c = min(x1, max_x)
        area += (y0 + y1) / 2.0 * (x1c - x0c)
    return area


def bd_rate(
    reference: Sequence[Tuple[float, float]], test: Sequence[Tuple[float, float]]
) -> Optional[float]:
    """Bjontegaard delta-rate between two (bitrate, quality) curves.

    Negative = test curve is more efficient.  Requires >= 4 points each and
    an overlapping quality range.  reference: src/stats/mod.rs:314-372.
    """
    if len(reference) < 4 or len(test) < 4:
        return None
    ref_sorted = sorted(reference, key=lambda p: p[1])
    test_sorted = sorted(test, key=lambda p: p[1])
    min_quality = max(ref_sorted[0][1], test_sorted[0][1])
    max_quality = min(ref_sorted[-1][1], test_sorted[-1][1])
    if min_quality >= max_quality:
        return None
    ref_log = [(np.log(r), q) for r, q in ref_sorted]
    test_log = [(np.log(r), q) for r, q in test_sorted]
    ref_area = _integrate_curve(ref_log, min_quality, max_quality)
    test_area = _integrate_curve(test_log, min_quality, max_quality)
    avg_ref = ref_area / (max_quality - min_quality)
    avg_test = test_area / (max_quality - min_quality)
    return float((10.0 ** (avg_test - avg_ref) - 1.0) * 100.0)


__all__ = [
    "Summary",
    "mean",
    "median",
    "std_dev",
    "percentile",
    "percentile_u32",
    "trimmed_mean",
    "iqr",
    "bd_rate",
]
