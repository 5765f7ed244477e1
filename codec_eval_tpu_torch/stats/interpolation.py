"""Power-law quality interpolation (`y = a * x^b + c`).

Host copy of ``codec_eval_tpu/stats/interpolation.py`` (the port imports
nothing from the JAX package).

Behavioral port of reference: src/interpolation/mod.rs:33-422 — grid-search
power-law fits with leave-one-out validation, adjacent-averaged gap
polynomials keyed by codec x viewing condition, and inverse linear lookup.

The grid search is vectorized over the whole exponent grid at once (numpy),
the natural accelerator-friendly formulation of the reference's serial loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class InterpolationConfig:
    """reference: src/interpolation/mod.rs:33-53."""

    min_exponent: float = 0.5
    max_exponent: float = 3.0
    exponent_step: float = 0.1
    min_r_squared: float = 0.90


@dataclass
class GapPolynomial:
    """One power-law segment over quality range [q_low, q_high].
    reference: src/interpolation/mod.rs:59-107."""

    q_low: int
    q_high: int
    a: float
    b: float
    c: float
    r_squared: float
    validation_error: float

    def interpolate(self, x: float) -> float:
        return float(np.clip(self.a * x**self.b + self.c, 0.0, 100.0))

    def covers(self, q: int) -> bool:
        return self.q_low <= q <= self.q_high


@dataclass
class InterpolationTable:
    """Polynomials keyed by codec x condition.
    reference: src/interpolation/mod.rs:114-150."""

    codec: str
    condition: str
    polynomials: List[GapPolynomial] = field(default_factory=list)

    def find_polynomial(self, q: int) -> Optional[GapPolynomial]:
        for p in self.polynomials:
            if p.covers(q):
                return p
        return None

    def interpolate(self, x: float) -> float:
        poly = self.find_polynomial(int(round(x)))
        return poly.interpolate(x) if poly else x


def fit_power_law(
    points: Sequence[Tuple[float, float]], config: InterpolationConfig
) -> Optional[Tuple[float, float, float, float]]:
    """Grid-search exponent, closed-form linear fit of (a, c) per exponent,
    keep best R².  Vectorized over the exponent grid.
    reference: src/interpolation/mod.rs:167-222."""
    if len(points) < 3:
        return None
    x = np.asarray([p[0] for p in points], dtype=np.float64)
    y = np.asarray([p[1] for p in points], dtype=np.float64)
    n = float(len(points))

    exps = np.arange(
        config.min_exponent, config.max_exponent + 1e-9, config.exponent_step
    )
    # xt[k, i] = x_i ^ b_k
    xt = x[None, :] ** exps[:, None]
    sum_x = xt.sum(axis=1)
    sum_y = y.sum()
    sum_xy = (xt * y[None, :]).sum(axis=1)
    sum_x2 = (xt * xt).sum(axis=1)
    denom = n * sum_x2 - sum_x * sum_x

    valid = np.abs(denom) >= 1e-10
    if not valid.any():
        return None
    a = np.where(valid, (n * sum_xy - sum_x * sum_y) / np.where(valid, denom, 1.0), 0.0)
    c = (sum_y - a * sum_x) / n

    y_mean = sum_y / n
    ss_tot = float(((y - y_mean) ** 2).sum())
    residuals = y[None, :] - (a[:, None] * xt + c[:, None])
    ss_res = (residuals**2).sum(axis=1)
    r2 = np.where(ss_tot > 0.0, 1.0 - ss_res / ss_tot, 0.0)
    r2 = np.where(valid, r2, -np.inf)

    k = int(np.argmax(r2))
    if not np.isfinite(r2[k]):
        return None
    return float(a[k]), float(exps[k]), float(c[k]), float(r2[k])


def fit_gap_polynomial(
    points: Sequence[Tuple[int, float]],
    skip_idx: int,
    config: InterpolationConfig,
) -> Optional[GapPolynomial]:
    """Leave-one-out fit: skip one point, validate by predicting it.
    reference: src/interpolation/mod.rs:236-271."""
    if len(points) < 4 or skip_idx >= len(points):
        return None
    skipped = points[skip_idx]
    training = [
        (float(q), d) for i, (q, d) in enumerate(points) if i != skip_idx
    ]
    fit = fit_power_law(training, config)
    if fit is None:
        return None
    a, b, c, r2 = fit
    predicted = a * float(skipped[0]) ** b + c
    return GapPolynomial(
        q_low=int(points[0][0]),
        q_high=int(points[-1][0]),
        a=a,
        b=b,
        c=c,
        r_squared=r2,
        validation_error=abs(predicted - skipped[1]),
    )


def compute_gap_polynomials(
    points: Sequence[Tuple[int, float]], config: InterpolationConfig
) -> List[GapPolynomial]:
    """Fit each internal gap, then average adjacent coefficients.
    reference: src/interpolation/mod.rs:301-372."""
    if len(points) < 4:
        return []

    gap_polys: List[Tuple[int, GapPolynomial]] = []
    for skip_idx in range(1, len(points) - 1):
        q_low = points[skip_idx - 1][0]
        q_high = points[skip_idx + 1][0]
        if q_high - q_low <= 2:
            continue
        poly = fit_gap_polynomial(points, skip_idx, config)
        if poly is not None:
            gap_polys.append((skip_idx, poly))

    result: List[GapPolynomial] = []
    for i, (idx, poly) in enumerate(gap_polys):
        a_sum, b_sum, c_sum, count = poly.a, poly.b, poly.c, 1.0
        if i > 0:
            prev_idx, prev = gap_polys[i - 1]
            if idx - prev_idx <= 2:
                a_sum += prev.a
                b_sum += prev.b
                c_sum += prev.c
                count += 1.0
        if i + 1 < len(gap_polys):
            next_idx, nxt = gap_polys[i + 1]
            if next_idx - idx <= 2:
                a_sum += nxt.a
                b_sum += nxt.b
                c_sum += nxt.c
                count += 1.0
        result.append(
            GapPolynomial(
                q_low=poly.q_low,
                q_high=poly.q_high,
                a=a_sum / count,
                b=b_sum / count,
                c=c_sum / count,
                r_squared=poly.r_squared,
                validation_error=poly.validation_error,
            )
        )
    return result


def linear_interpolate(
    target_y: float, points: Sequence[Tuple[int, float]]
) -> Optional[float]:
    """Inverse lookup: find x producing target_y by bracketing segments,
    clamped to [0, 100]; closest point if outside range.
    reference: src/interpolation/mod.rs:389-422."""
    if not points:
        return None
    if len(points) == 1:
        return float(points[0][0])
    for (x1, y1), (x2, y2) in zip(points, points[1:]):
        in_range = (y1 <= target_y <= y2) or (y2 <= target_y <= y1)
        if in_range and abs(y2 - y1) > 1e-12:
            t = (target_y - y1) / (y2 - y1)
            return float(np.clip(x1 + t * (x2 - x1), 0.0, 100.0))
    closest = min(points, key=lambda p: abs(p[1] - target_y))
    return float(closest[0])


__all__ = [
    "InterpolationConfig",
    "GapPolynomial",
    "InterpolationTable",
    "fit_power_law",
    "fit_gap_polynomial",
    "compute_gap_polynomials",
    "linear_interpolate",
]
