"""Unified quality interpretation and encoder-selection prediction.

Port of ``codec_eval_tpu/analysis/quality_predictor.py``, the same code (host only).

Behavioral port of reference:
crates/codec-compare/src/quality_predictor.rs:12-127 — empirical
quality-equivalence maps between a baseline JPEG encoder ("mozjpeg"-class)
and a perceptually-tuned one ("jpegli"-class), linear butteraugli-vs-quality
fits, content-aware crossover selection, bpp estimators, and the unified
0-100 quality scale anchored to butteraugli.

The empirical constants are the reference's published corpus fits
(quality_predictor.rs:6-60); they describe encoder families, not this
machine's binaries, and are retained as documented domain calibration data.
"""

from __future__ import annotations

from typing import Tuple


def mozjpeg_to_jpegli_quality(moz_quality: int) -> int:
    """Quality giving equal butteraugli (mozQ90 ~ jpegliQ80, ...)."""
    q = int(moz_quality)
    if q >= 90:
        return max(q - 10, 75)
    if q >= 85:
        return max(q - 15, 70)
    if q >= 75:
        return max(q - 20, 55)
    if q >= 60:
        return max(q - 25, 35)
    return 25


def jpegli_to_mozjpeg_quality(jpegli_quality: int) -> int:
    q = int(jpegli_quality)
    if q >= 80:
        return min(q + 10, 100)
    if q >= 70:
        return q + 15
    if q >= 55:
        return q + 20
    if q >= 35:
        return q + 25
    return 100


def estimate_butteraugli(quality: int, encoder: str) -> float:
    """Linear corpus fits: jpegli BA ~ 7.5 - 0.065Q; mozjpeg ~ 9.5 - 0.078Q."""
    q = float(quality)
    if encoder == "jpegli":
        return max(7.5 - 0.065 * q, 0.5)
    return max(9.5 - 0.078 * q, 1.0)


def quality_for_butteraugli(target: float, encoder: str) -> int:
    if encoder == "jpegli":
        return int(min(max((7.5 - target) / 0.065, 25.0), 100.0))
    return int(min(max((9.5 - target) / 0.078, 25.0), 100.0))


def predict_encoder_for_quality(
    target_butteraugli: float,
    flat_block_pct: float,
    edge_strength: float,
    local_contrast: float,
) -> Tuple[str, float]:
    """Which encoder family produces smaller files at the target quality.

    The crossover butteraugli threshold shifts with content flatness and
    complexity (quality_predictor.rs:62-92).
    """
    complexity = edge_strength + local_contrast
    if flat_block_pct > 75.0 and complexity < 20.0:
        crossover = 3.0
    elif flat_block_pct > 60.0:
        crossover = 3.5
    else:
        crossover = 4.5

    if target_butteraugli > crossover:
        q = quality_for_butteraugli(target_butteraugli, "mozjpeg")
        return "mozjpeg", estimate_bpp_mozjpeg(q, flat_block_pct)
    q = quality_for_butteraugli(target_butteraugli, "jpegli")
    return "jpegli", estimate_bpp_jpegli(q, flat_block_pct)


def estimate_bpp_mozjpeg(quality: int, flat_pct: float) -> float:
    base = 0.1 + 0.016 * float(quality)
    content_factor = 0.3 + 0.7 * (100.0 - flat_pct) / 100.0
    return base * content_factor


def estimate_bpp_jpegli(quality: int, flat_pct: float) -> float:
    base = 0.4 + 0.017 * float(quality)
    content_factor = 0.3 + 0.7 * (100.0 - flat_pct) / 100.0
    return base * content_factor


def unified_quality_to_butteraugli(unified_quality: int) -> float:
    """Unified 0-100 scale: UQ100 -> BA 0.0, UQ0 -> BA 8.0."""
    return 8.0 * (1.0 - float(unified_quality) / 100.0)


def unified_to_encoder_quality(unified_quality: int, encoder: str) -> int:
    return quality_for_butteraugli(
        unified_quality_to_butteraugli(unified_quality), encoder
    )
