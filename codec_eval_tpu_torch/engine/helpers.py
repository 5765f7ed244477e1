"""Lightweight evaluation helpers: evaluate_single / assert_quality /
assert_perception_level.

Port of ``codec_eval_tpu/engine/helpers.py`` (reference:
src/eval/helpers.rs:105-317), the CI one-shot path.  Metric math runs
through the same batch scorer as the full session, at N = 1, on ``device``:
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import DimensionMismatch, QualityBelowThreshold
from ..metrics import MetricConfig, MetricResult, PerceptionLevel
from ..utils.profiling import span
from .scoring import BatchScorer


def _as_rgb8(img) -> np.ndarray:
    from .image import ImageData

    if isinstance(img, ImageData):
        return img.to_rgb8()
    arr = np.asarray(img)
    if arr.ndim != 3 or arr.shape[2] < 3:
        raise ValueError(f"expected (H, W, 3) image, got {arr.shape}")
    return np.ascontiguousarray(arr[..., :3]).astype(np.uint8, copy=False)


def evaluate_single(
    reference, encoded, config: MetricConfig, viewing_simulation=None, device="cuda"
) -> MetricResult:
    """Score one decoded image against a reference with the given metrics.

    ``viewing_simulation`` optionally takes a
    ``viewing.SimulationParams``: both images are passed through the
    viewing transform (linear-light resize to the simulated display scale,
    kernels/resize.py) on ``device`` before scoring, so the metrics see
    what the modeled viewer sees.  The reference prescribes this transform
    but leaves resampling unimplemented (src/viewing.rs:244-301) and only
    adjusts thresholds; here both strategies are available.

    reference: src/eval/helpers.rs:105-172.
    """
    with span("ce.gate.evaluate_single"):
        ref = _as_rgb8(reference)
        enc = _as_rgb8(encoded)
        if ref.shape != enc.shape:
            raise DimensionMismatch(
                (ref.shape[1], ref.shape[0]), (enc.shape[1], enc.shape[0])
            )
        scorer = BatchScorer(config, device=device)
        if viewing_simulation is not None:
            from ..viewing import simulate_viewing

            ref = simulate_viewing(ref, viewing_simulation, device=scorer.device)
            enc = simulate_viewing(enc, viewing_simulation, device=scorer.device)
    return scorer.score_pair(ref, enc)


def assert_quality(
    reference,
    encoded,
    min_ssimulacra2: Optional[float] = None,
    max_dssim: Optional[float] = None,
    device="cuda",
) -> None:
    """CI gate: raise QualityBelowThreshold unless thresholds are met.

    Only the metrics whose thresholds are given are computed
    (reference: src/eval/helpers.rs:212-253).
    """
    config = MetricConfig(
        dssim=max_dssim is not None,
        ssimulacra2=min_ssimulacra2 is not None,
    )
    with span("ce.gate.assert_quality"):
        result = evaluate_single(reference, encoded, config, device=device)

    if min_ssimulacra2 is not None and result.ssimulacra2 is not None:
        if result.ssimulacra2 < min_ssimulacra2:
            raise QualityBelowThreshold(
                "SSIMULACRA2", result.ssimulacra2, min_ssimulacra2
            )
    if max_dssim is not None and result.dssim is not None:
        if result.dssim > max_dssim:
            raise QualityBelowThreshold("DSSIM", result.dssim, max_dssim)


def assert_perception_level(
    reference, encoded, min_level: PerceptionLevel, device="cuda"
) -> None:
    """Semantic CI gate on the DSSIM-derived perception level.

    reference: src/eval/helpers.rs:291-317.
    """
    result = evaluate_single(reference, encoded, MetricConfig(dssim=True), device=device)
    if result.dssim is None:
        return
    actual = PerceptionLevel.from_dssim(result.dssim)
    if actual.rank() > min_level.rank():
        raise QualityBelowThreshold(
            f"PerceptionLevel (DSSIM {result.dssim:.6f})",
            float(actual.rank()),
            float(min_level.rank()),
        )
