"""Subjective-study (human A/B testing) statistics.

Host copy of ``codec_eval_tpu/stats/abtest.py`` (the port imports
nothing from the JAX package).

The reference *documents* a complete methodology for human codec studies —
2AFC forced-choice analysis, MOS confidence intervals, participant
screening, bias detection, multiple-comparison correction (reference:
README.md:521-660 "Scientific Methodology" / "Human A/B Testing") — but
ships no code for it.  This module makes that methodology executable so a
study can be analyzed with the same framework that produced the objective
scores.

Everything is deterministic host-side numpy (a study is at most a few
thousand scalars); no scipy dependency.  Where the reference prose names a
procedure, the docstring cites the line:

- 2AFC binomial test + preference reporting  (README.md:640-645)
- Holm-Bonferroni / Benjamini-Hochberg FDR    (README.md:642-644)
- MOS mean + 95% CI, trimmed means, bootstrap (README.md:629-637)
- Cohen's d effect size                       (README.md:637)
- Wilcoxon signed-rank (normal approximation) (README.md:636)
- position-bias detection                     (README.md:611-614)
- attention-check / consistency screening     (README.md:586-607)
- power analysis (the "~64 participants for a 0.5 MOS difference at
  SD=1.0, 80% power" worked example)          (README.md:580)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TwoAfcResult",
    "two_afc_test",
    "binomial_test_two_sided",
    "holm_bonferroni",
    "benjamini_hochberg",
    "bootstrap_ci",
    "MosSummary",
    "mos_summary",
    "cohens_d",
    "wilcoxon_signed_rank",
    "PositionBias",
    "position_bias",
    "ParticipantRecord",
    "ScreeningCriteria",
    "ScreeningResult",
    "screen_participants",
    "required_sample_size",
    "recommended_sample_size",
    "FatigueCheck",
    "fatigue_check",
    "ScaleUsage",
    "scale_usage",
]


# ---------------------------------------------------------------------------
# Normal distribution helpers (no scipy)


def _norm_cdf(z: float) -> float:
    return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF via bisection on erf (deterministic,
    |error| < 1e-10 — more than enough for sample-size planning)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    lo, hi = -12.0, 12.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _norm_cdf(mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# 2AFC forced choice (README.md:640-645)


def binomial_test_two_sided(k: int, n: int, p: float = 0.5) -> float:
    """Exact two-sided binomial test: the sum of P(X=i) over all outcomes
    no more likely than the observed one (the standard "small p-values"
    definition, matching scipy.stats.binomtest)."""
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k} n={n}")
    if n == 0:
        return 1.0
    i = np.arange(n + 1)
    # log P(X=i) for numerical stability at large n
    log_pmf = (
        _log_comb(n, i) + i * math.log(p) + (n - i) * math.log1p(-p)
        if 0.0 < p < 1.0
        else None
    )
    if log_pmf is None:  # degenerate p=0 or 1
        return 1.0 if (k == 0 and p == 0.0) or (k == n and p == 1.0) else 0.0
    pmf = np.exp(log_pmf)
    # relative tolerance guards the float-equality at the observed mass
    cutoff = pmf[k] * (1.0 + 1e-12)
    return float(min(1.0, pmf[pmf <= cutoff].sum()))


def _log_comb(n: int, i: np.ndarray) -> np.ndarray:
    from math import lgamma

    lg = np.vectorize(lgamma)
    return lg(n + 1) - lg(i + 1) - lg(n - i + 1)


@dataclass(frozen=True)
class TwoAfcResult:
    """One pairwise forced-choice comparison, reported the way the
    reference prescribes: "Codec A preferred 67% of time (p < 0.01, N=100)"
    (README.md:645)."""

    wins: int
    trials: int
    preference: float  # wins / trials
    p_value: float  # exact two-sided binomial vs H0: 50%

    def report(self, name: str = "Codec A") -> str:
        return (
            f"{name} preferred {self.preference * 100.0:.0f}% of time "
            f"(p = {self.p_value:.3g}, N = {self.trials})"
        )


def two_afc_test(wins: int, trials: int) -> TwoAfcResult:
    """Binomial test for a 2AFC preference count against H0: 50%
    (README.md:640-642)."""
    if trials <= 0:
        raise ValueError("trials must be positive")
    return TwoAfcResult(
        wins=wins,
        trials=trials,
        preference=wins / trials,
        p_value=binomial_test_two_sided(wins, trials, 0.5),
    )


# ---------------------------------------------------------------------------
# Multiple-comparison correction (README.md:642-644)


def holm_bonferroni(p_values: Sequence[float]) -> List[float]:
    """Holm step-down adjusted p-values (monotone, clipped to 1)."""
    p = np.asarray(p_values, dtype=np.float64)
    m = len(p)
    if m == 0:
        return []
    order = np.argsort(p, kind="stable")
    adj = np.empty(m)
    running = 0.0
    for rank, idx in enumerate(order):
        running = max(running, (m - rank) * p[idx])
        adj[idx] = min(1.0, running)
    return adj.tolist()


def benjamini_hochberg(p_values: Sequence[float]) -> List[float]:
    """Benjamini-Hochberg FDR adjusted p-values (step-up)."""
    p = np.asarray(p_values, dtype=np.float64)
    m = len(p)
    if m == 0:
        return []
    order = np.argsort(p, kind="stable")
    adj = np.empty(m)
    running = 1.0
    for rank in range(m - 1, -1, -1):
        idx = order[rank]
        running = min(running, p[idx] * m / (rank + 1))
        adj[idx] = running
    return np.minimum(adj, 1.0).tolist()


# ---------------------------------------------------------------------------
# Rating (MOS) analysis (README.md:629-637)


def bootstrap_ci(
    values: Sequence[float],
    statistic: Optional[Callable[[np.ndarray], float]] = None,
    n_boot: int = 10_000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float]:
    """Percentile bootstrap CI — the robust method the reference recommends
    for MOS data whose normality is "often violated" (README.md:631-635).
    Deterministic for a given seed.  ``statistic`` defaults to the mean."""
    data = np.asarray(values, dtype=np.float64)
    if data.size == 0:
        raise ValueError("empty sample")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, data.size, size=(n_boot, data.size))
    stats = np.apply_along_axis(statistic or np.mean, 1, data[idx])
    lo, hi = np.quantile(stats, [alpha / 2.0, 1.0 - alpha / 2.0])
    return float(lo), float(hi)


@dataclass(frozen=True)
class MosSummary:
    """Per-condition MOS summary: mean with bootstrap 95% CI plus the
    robust statistics the reference's analysis recipe calls for
    (README.md:629-635)."""

    n: int
    mean: float
    ci_low: float
    ci_high: float
    median: float
    std: float  # sample (N-1)
    trimmed_mean_20: float  # 20% total trim (10% each tail)


def mos_summary(
    ratings: Sequence[float], alpha: float = 0.05, seed: int = 0
) -> MosSummary:
    data = np.asarray(ratings, dtype=np.float64)
    if data.size == 0:
        raise ValueError("empty sample")
    from .summary import trimmed_mean

    lo, hi = bootstrap_ci(data, np.mean, alpha=alpha, seed=seed)
    return MosSummary(
        n=int(data.size),
        mean=float(data.mean()),
        ci_low=lo,
        ci_high=hi,
        median=float(np.median(data)),
        std=float(data.std(ddof=1)) if data.size > 1 else 0.0,
        trimmed_mean_20=trimmed_mean(data.tolist(), 20.0),
    )


def cohens_d(a: Sequence[float], b: Sequence[float]) -> float:
    """Cohen's d with pooled sample SD (README.md:637)."""
    x = np.asarray(a, dtype=np.float64)
    y = np.asarray(b, dtype=np.float64)
    if x.size < 2 or y.size < 2:
        raise ValueError("need at least 2 samples per group")
    pooled_var = (
        (x.size - 1) * x.var(ddof=1) + (y.size - 1) * y.var(ddof=1)
    ) / (x.size + y.size - 2)
    if pooled_var == 0.0:
        return 0.0
    return float((x.mean() - y.mean()) / math.sqrt(pooled_var))


def wilcoxon_signed_rank(
    a: Sequence[float], b: Sequence[float]
) -> Tuple[float, float]:
    """Paired Wilcoxon signed-rank test, normal approximation with tie and
    zero corrections (Pratt zeros dropped).  Returns (W, two-sided p).
    The non-parametric test the reference's recipe names (README.md:636);
    the approximation is standard for N >= ~10 pairs."""
    x = np.asarray(a, dtype=np.float64)
    y = np.asarray(b, dtype=np.float64)
    if x.shape != y.shape:
        raise ValueError("paired samples must have equal length")
    d = x - y
    d = d[d != 0.0]
    n = d.size
    if n == 0:
        return 0.0, 1.0
    ranks = _rank_with_ties(np.abs(d))
    w_pos = float(ranks[d > 0].sum())
    mu = n * (n + 1) / 4.0
    # tie correction on the rank variance
    _, counts = np.unique(np.abs(d), return_counts=True)
    tie_term = float(((counts**3 - counts)).sum()) / 48.0
    sigma2 = n * (n + 1) * (2 * n + 1) / 24.0 - tie_term
    if sigma2 <= 0.0:
        return w_pos, 1.0
    z = (w_pos - mu) / math.sqrt(sigma2)
    p = 2.0 * (1.0 - _norm_cdf(abs(z)))
    return w_pos, float(min(1.0, p))


def _rank_with_ties(values: np.ndarray) -> np.ndarray:
    order = np.argsort(values, kind="stable")
    ranks = np.empty(values.size, dtype=np.float64)
    sorted_vals = values[order]
    i = 0
    while i < values.size:
        j = i
        while j + 1 < values.size and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        avg = (i + j) / 2.0 + 1.0  # 1-based average rank across the tie run
        ranks[order[i : j + 1]] = avg
        i = j + 1
    return ranks


# ---------------------------------------------------------------------------
# Bias detection (README.md:609-626)


@dataclass(frozen=True)
class PositionBias:
    """Left/first-position preference check.  ``biased`` applies the
    reference's exclusion rule (> 70% same-side choices, README.md:613-614)
    on top of the significance test."""

    left_rate: float
    p_value: float
    biased: bool


def position_bias(left_choices: int, total: int) -> PositionBias:
    if total <= 0:
        raise ValueError("total must be positive")
    rate = left_choices / total
    p = binomial_test_two_sided(left_choices, total, 0.5)
    return PositionBias(
        left_rate=rate,
        p_value=p,
        biased=(rate > 0.70 or rate < 0.30) and p < 0.05,
    )


# ---------------------------------------------------------------------------
# Participant screening (README.md:586-607)


@dataclass
class ParticipantRecord:
    """Raw per-participant tallies a study harness accumulates."""

    participant_id: str
    attention_checks: int = 0
    attention_failures: int = 0
    duplicate_pairs: int = 0
    duplicate_agreements: int = 0
    response_times_ms: List[float] = field(default_factory=list)
    trials_completed: int = 0
    trials_assigned: int = 0


@dataclass(frozen=True)
class ScreeningCriteria:
    """The reference's pre-registered exclusion thresholds
    (README.md:590-595): > 20% attention-check failures, < 60% duplicate
    agreement, < 200 ms responses (random clicking), < 80% completion."""

    max_attention_failure_rate: float = 0.20
    min_duplicate_agreement: float = 0.60
    min_response_time_ms: float = 200.0
    max_fast_response_rate: float = 0.10
    min_completion: float = 0.80


@dataclass(frozen=True)
class ScreeningResult:
    participant_id: str
    included: bool
    reasons: Tuple[str, ...]


def screen_participants(
    records: Sequence[ParticipantRecord],
    criteria: Optional[ScreeningCriteria] = None,
) -> List[ScreeningResult]:
    """Apply the documented exclusion criteria; reasons name every rule a
    participant tripped so the report can publish both with/without
    exclusion, as the reference's outlier policy requires
    (README.md:648-652)."""
    crit = criteria or ScreeningCriteria()
    out: List[ScreeningResult] = []
    for rec in records:
        reasons: List[str] = []
        if rec.attention_checks > 0:
            fail_rate = rec.attention_failures / rec.attention_checks
            if fail_rate > crit.max_attention_failure_rate:
                reasons.append(
                    f"attention failure rate {fail_rate:.0%} > "
                    f"{crit.max_attention_failure_rate:.0%}"
                )
        if rec.duplicate_pairs > 0:
            agree = rec.duplicate_agreements / rec.duplicate_pairs
            if agree < crit.min_duplicate_agreement:
                reasons.append(
                    f"duplicate agreement {agree:.0%} < "
                    f"{crit.min_duplicate_agreement:.0%}"
                )
        if rec.response_times_ms:
            times = np.asarray(rec.response_times_ms, dtype=np.float64)
            fast = float((times < crit.min_response_time_ms).mean())
            if fast > crit.max_fast_response_rate:
                reasons.append(
                    f"{fast:.0%} responses < {crit.min_response_time_ms:.0f} ms"
                )
        if rec.trials_assigned > 0:
            completion = rec.trials_completed / rec.trials_assigned
            if completion < crit.min_completion:
                reasons.append(
                    f"completion {completion:.0%} < {crit.min_completion:.0%}"
                )
        out.append(
            ScreeningResult(
                participant_id=rec.participant_id,
                included=not reasons,
                reasons=tuple(reasons),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Power analysis (README.md:580)


def required_sample_size(
    delta: float,
    sd: float,
    power: float = 0.80,
    alpha: float = 0.05,
) -> int:
    """Per-condition N for a two-sample comparison of means (normal
    approximation): n = 2 * ((z_{1-alpha/2} + z_{power}) * sd / delta)^2.
    Reproduces the reference's worked example — 0.5 MOS difference at
    SD=1.0 and 80% power needs ~64 participants per condition
    (README.md:580)."""
    if delta <= 0.0 or sd <= 0.0:
        raise ValueError("delta and sd must be positive")
    z_a = _norm_ppf(1.0 - alpha / 2.0)
    z_b = _norm_ppf(power)
    n = 2.0 * ((z_a + z_b) * sd / delta) ** 2
    return int(math.ceil(n))


def recommended_sample_size(difficulty: str) -> Tuple[int, Tuple[int, int]]:
    """The reference's sample-size table (README.md:572-578): minimum N and
    a recommended range keyed by how obvious the quality difference is.
    Returns ``(minimum, (rec_low, rec_high))``."""
    table = {
        "large": (15, (20, 30)),
        "medium": (30, (50, 80)),
        "small": (80, (150, 300)),
    }
    key = difficulty.strip().lower()
    if key not in table:
        raise ValueError(
            f"difficulty must be one of {sorted(table)}, got {difficulty!r}"
        )
    return table[key]


# ---------------------------------------------------------------------------
# Fatigue / anchoring detection (README.md:616-620)


@dataclass(frozen=True)
class FatigueCheck:
    """Early-vs-late accuracy comparison on attention checks.  The reference
    detects fatigue by comparing attention-check accuracy early vs late in a
    session (README.md:617-618); a significant drop means the session ran
    too long (it prescribes 15-20 minute sessions)."""

    early_accuracy: float
    late_accuracy: float
    p_value: float  # two-proportion z-test, two-sided
    fatigued: bool  # significant accuracy DROP late vs early


def fatigue_check(
    early_correct: int,
    early_total: int,
    late_correct: int,
    late_total: int,
    alpha: float = 0.05,
) -> FatigueCheck:
    if early_total <= 0 or late_total <= 0:
        raise ValueError("totals must be positive")
    pe = early_correct / early_total
    pl = late_correct / late_total
    pooled = (early_correct + late_correct) / (early_total + late_total)
    var = pooled * (1.0 - pooled) * (1.0 / early_total + 1.0 / late_total)
    if var <= 0.0:
        p = 1.0
    else:
        z = (pe - pl) / math.sqrt(var)
        p = 2.0 * (1.0 - _norm_cdf(abs(z)))
    return FatigueCheck(
        early_accuracy=pe,
        late_accuracy=pl,
        p_value=float(min(1.0, p)),
        fatigued=(pl < pe) and p < alpha,
    )


# ---------------------------------------------------------------------------
# Central-tendency / scale-usage detection (README.md:622-626)


@dataclass(frozen=True)
class ScaleUsage:
    """Rating-scale usage histogram.  The reference detects central-tendency
    bias from the histogram of ratings ("should use full scale",
    README.md:623-625) and prescribes switching to forced choice when raters
    avoid the extremes."""

    histogram: Dict[int, int]
    extremes_rate: float  # share of ratings at scale min or max
    central_tendency: bool  # extremes rarely used


def scale_usage(
    ratings: Sequence[float],
    scale_min: int = 1,
    scale_max: int = 5,
    min_extremes_rate: float = 0.05,
) -> ScaleUsage:
    data = np.asarray(ratings, dtype=np.float64)
    if data.size == 0:
        raise ValueError("empty sample")
    hist = {
        level: int((np.rint(data) == level).sum())
        for level in range(scale_min, scale_max + 1)
    }
    extremes = hist[scale_min] + hist[scale_max]
    rate = extremes / data.size
    return ScaleUsage(
        histogram=hist,
        extremes_rate=float(rate),
        central_tendency=rate < min_extremes_rate,
    )
