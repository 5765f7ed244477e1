"""Encoder-winner prediction from comparison + heuristics data.

Port of ``codec_eval_tpu/analysis/predictor.py``, the same code (host only).

Capability port of reference: crates/codec-compare/src/build_predictor.rs:
104-490+ — joins a two-codec comparison table with per-image content
heuristics, determines the per-(image, bpp-bucket) winner by interpolated
matched-bpp quality, and evaluates candidate selection rules for accuracy.

The reference hand-writes ~20 threshold-rule variants; here a compact rule
set is evaluated the same way AND a logistic-regression rule is fitted
directly (numpy least squares on the logit), which is the data-driven
generalization of the hand-tuned search.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .comparison import ComparisonRow, _interp_at_bpp

BPP_BUCKETS = [0.5, 1.0, 1.5, 2.0, 3.0]


@dataclass
class WinnerSample:
    image: str
    bpp_bucket: float
    winner: str  # codec id
    margin: float  # s2 advantage of the winner
    features: Dict[str, float]


def determine_winners(
    rows: Sequence[ComparisonRow],
    heuristics: Dict[str, Dict[str, float]],
    codec_a: str,
    codec_b: str,
    buckets: Sequence[float] = tuple(BPP_BUCKETS),
    min_margin: float = 0.0,
) -> List[WinnerSample]:
    """Per-(image, bucket) winner by interpolated quality at matched bpp.
    reference: build_predictor.rs:104-241."""
    curves: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    for r in rows:
        if r.codec in (codec_a, codec_b):
            curves.setdefault(r.image, {}).setdefault(r.codec, []).append(
                (r.bpp, r.ssimulacra2)
            )
    samples: List[WinnerSample] = []
    for image, by_codec in curves.items():
        if codec_a not in by_codec or codec_b not in by_codec:
            continue
        feats = heuristics.get(image)
        if feats is None:
            continue
        for bucket in buckets:
            va = _interp_at_bpp(by_codec[codec_a], bucket)
            vb = _interp_at_bpp(by_codec[codec_b], bucket)
            if va is None or vb is None:
                continue
            margin = abs(va - vb)
            if margin < min_margin:
                continue
            samples.append(
                WinnerSample(
                    image=image,
                    bpp_bucket=bucket,
                    winner=codec_a if va >= vb else codec_b,
                    margin=margin,
                    features=feats,
                )
            )
    return samples


@dataclass
class Rule:
    """A candidate selection rule: features -> predicted winner."""

    name: str
    predict: Callable[[Dict[str, float], float], str]


def default_rules(codec_a: str, codec_b: str) -> List[Rule]:
    """Compact analog of the reference's rule_combined_v1..v21 family."""

    def mk(name, fn):
        return Rule(name, fn)

    return [
        mk("always_a", lambda f, b: codec_a),
        mk("always_b", lambda f, b: codec_b),
        mk(
            "flat_blocks_60",
            lambda f, b: codec_a if f.get("flat_block_pct", 0) > 60 else codec_b,
        ),
        mk(
            "flat_blocks_75",
            lambda f, b: codec_a if f.get("flat_block_pct", 0) > 75 else codec_b,
        ),
        mk(
            "edge_density_10",
            lambda f, b: codec_b if f.get("edge_density", 0) > 0.10 else codec_a,
        ),
        mk(
            "high_freq_ratio",
            lambda f, b: codec_b if f.get("freq_ratio", 0) > 0.15 else codec_a,
        ),
        mk(
            "low_bpp_a_else_b",
            lambda f, b: codec_a if b <= 1.0 else codec_b,
        ),
        mk(
            "combined_flat_and_bpp",
            lambda f, b: codec_a
            if (f.get("flat_block_pct", 0) > 60 or b <= 0.5)
            else codec_b,
        ),
        mk(
            "contrast_20",
            lambda f, b: codec_b
            if f.get("local_contrast_mean", 0) > 20.0
            else codec_a,
        ),
    ]


@dataclass
class RuleScore:
    name: str
    accuracy: float
    weighted_accuracy: float  # margin-weighted
    n: int


def evaluate_rules(
    samples: Sequence[WinnerSample], rules: Sequence[Rule]
) -> List[RuleScore]:
    """Accuracy table, sorted best-first.
    reference: build_predictor.rs:243-490 (rule evaluation)."""
    scores = []
    total_margin = sum(s.margin for s in samples) or 1.0
    for rule in rules:
        correct = 0
        weighted = 0.0
        for s in samples:
            if rule.predict(s.features, s.bpp_bucket) == s.winner:
                correct += 1
                weighted += s.margin
        n = len(samples)
        scores.append(
            RuleScore(
                name=rule.name,
                accuracy=correct / n if n else 0.0,
                weighted_accuracy=weighted / total_margin,
                n=n,
            )
        )
    scores.sort(key=lambda s: -s.weighted_accuracy)
    return scores


_LOGIT_FEATURES = [
    "flat_block_pct",
    "edge_density",
    "freq_ratio",
    "local_contrast_mean",
    "block_variance_mean",
]


def fit_logistic_rule(
    samples: Sequence[WinnerSample], codec_a: str, codec_b: str
) -> Optional[Rule]:
    """Fit a margin-weighted linear classifier over the heuristic features
    (plus the bpp bucket) — the learned counterpart of the hand rules."""
    if len(samples) < 8:
        return None

    def vec(s: WinnerSample) -> List[float]:
        return [s.features.get(k, 0.0) for k in _LOGIT_FEATURES] + [s.bpp_bucket, 1.0]

    x = np.array([vec(s) for s in samples], dtype=np.float64)
    y = np.array([1.0 if s.winner == codec_a else -1.0 for s in samples])
    w = np.array([s.margin for s in samples])
    # Feature standardization for conditioning.
    mu, sd = x.mean(axis=0), x.std(axis=0) + 1e-9
    sd[-1] = 1.0
    mu[-1] = 0.0
    xn = (x - mu) / sd
    # Weighted ridge least squares on the sign target.
    lam = 1e-3
    a_mat = xn.T @ (xn * w[:, None]) + lam * np.eye(xn.shape[1])
    b_vec = xn.T @ (y * w)
    coef = np.linalg.solve(a_mat, b_vec)

    def predict(features: Dict[str, float], bucket: float) -> str:
        raw = np.array(
            [features.get(k, 0.0) for k in _LOGIT_FEATURES] + [bucket, 1.0]
        )
        z = float(((raw - mu) / sd) @ coef)
        return codec_a if z >= 0 else codec_b

    return Rule("fitted_linear", predict)
