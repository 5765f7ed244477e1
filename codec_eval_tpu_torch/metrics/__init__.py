"""Metric configuration, results and perception levels.

A copy of ``codec_eval_tpu/metrics/__init__.py`` without the single-pair
``calculate`` API (reference: src/metrics/mod.rs:46-331); the per-pixel
compute lives in ``codec_eval_tpu_torch.kernels`` as PyTorch and CUDA code.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class MetricConfig:
    """Which metrics to calculate.  reference: src/metrics/mod.rs:46-64."""

    dssim: bool = False
    ssimulacra2: bool = False
    butteraugli: bool = False
    psnr: bool = False
    # Roundtrip the reference image through u8-quantized XYB first, to
    # isolate compression error from color-space error for XYB codecs.
    xyb_roundtrip: bool = False

    @classmethod
    def all(cls) -> "MetricConfig":
        return cls(dssim=True, ssimulacra2=True, butteraugli=True, psnr=True)

    @classmethod
    def fast(cls) -> "MetricConfig":
        """PSNR only.  NOT recommended for quality comparison."""
        return cls(psnr=True)

    @classmethod
    def perceptual(cls) -> "MetricConfig":
        """DSSIM + SSIMULACRA2 + Butteraugli.  Recommended."""
        return cls(dssim=True, ssimulacra2=True, butteraugli=True)

    @classmethod
    def perceptual_xyb(cls) -> "MetricConfig":
        """Perceptual metrics with XYB roundtrip (for XYB codecs)."""
        return cls(dssim=True, ssimulacra2=True, butteraugli=True, xyb_roundtrip=True)

    @classmethod
    def ssimulacra2_only(cls) -> "MetricConfig":
        return cls(ssimulacra2=True)

    def with_xyb_roundtrip(self) -> "MetricConfig":
        self.xyb_roundtrip = True
        return self


@dataclass
class MetricResult:
    """Calculated metric values.  reference: src/metrics/mod.rs:140-149."""

    dssim: Optional[float] = None
    ssimulacra2: Optional[float] = None
    butteraugli: Optional[float] = None
    psnr: Optional[float] = None

    def perception_level(self) -> Optional["PerceptionLevel"]:
        if self.dssim is None:
            return None
        return PerceptionLevel.from_dssim(self.dssim)

    def perception_level_ssimulacra2(self) -> Optional["PerceptionLevel"]:
        if self.ssimulacra2 is None:
            return None
        return PerceptionLevel.from_ssimulacra2(self.ssimulacra2)

    def perception_level_butteraugli(self) -> Optional["PerceptionLevel"]:
        if self.butteraugli is None:
            return None
        return PerceptionLevel.from_butteraugli(self.butteraugli)

    def to_json(self) -> dict:
        return {
            "dssim": self.dssim,
            "ssimulacra2": self.ssimulacra2,
            "butteraugli": self.butteraugli,
            "psnr": self.psnr,
        }

    @classmethod
    def from_json(cls, d: dict) -> "MetricResult":
        return cls(
            dssim=d.get("dssim"),
            ssimulacra2=d.get("ssimulacra2"),
            butteraugli=d.get("butteraugli"),
            psnr=d.get("psnr"),
        )


class PerceptionLevel(enum.Enum):
    """Perceptual quality bands from empirical thresholds.

    reference: src/metrics/mod.rs:172-284 (threshold tables documented at
    src/metrics/mod.rs:17-27).
    """

    IMPERCEPTIBLE = "Imperceptible"
    MARGINAL = "Marginal"
    SUBTLE = "Subtle"
    NOTICEABLE = "Noticeable"
    DEGRADED = "Degraded"

    @classmethod
    def from_dssim(cls, dssim: float) -> "PerceptionLevel":
        if dssim < 0.0003:
            return cls.IMPERCEPTIBLE
        if dssim < 0.0007:
            return cls.MARGINAL
        if dssim < 0.0015:
            return cls.SUBTLE
        if dssim < 0.003:
            return cls.NOTICEABLE
        return cls.DEGRADED

    @classmethod
    def from_ssimulacra2(cls, score: float) -> "PerceptionLevel":
        if score > 90.0:
            return cls.IMPERCEPTIBLE
        if score > 80.0:
            return cls.MARGINAL
        if score > 70.0:
            return cls.SUBTLE
        if score > 50.0:
            return cls.NOTICEABLE
        return cls.DEGRADED

    @classmethod
    def from_butteraugli(cls, score: float) -> "PerceptionLevel":
        if score < 1.0:
            return cls.IMPERCEPTIBLE
        if score < 2.0:
            return cls.MARGINAL
        if score < 3.0:
            return cls.SUBTLE
        if score < 5.0:
            return cls.NOTICEABLE
        return cls.DEGRADED

    def max_dssim(self) -> float:
        return {
            PerceptionLevel.IMPERCEPTIBLE: 0.0003,
            PerceptionLevel.MARGINAL: 0.0007,
            PerceptionLevel.SUBTLE: 0.0015,
            PerceptionLevel.NOTICEABLE: 0.003,
            PerceptionLevel.DEGRADED: float("inf"),
        }[self]

    def min_ssimulacra2(self) -> float:
        return {
            PerceptionLevel.IMPERCEPTIBLE: 90.0,
            PerceptionLevel.MARGINAL: 80.0,
            PerceptionLevel.SUBTLE: 70.0,
            PerceptionLevel.NOTICEABLE: 50.0,
            PerceptionLevel.DEGRADED: float("-inf"),
        }[self]

    def max_butteraugli(self) -> float:
        return {
            PerceptionLevel.IMPERCEPTIBLE: 1.0,
            PerceptionLevel.MARGINAL: 2.0,
            PerceptionLevel.SUBTLE: 3.0,
            PerceptionLevel.NOTICEABLE: 5.0,
            PerceptionLevel.DEGRADED: float("inf"),
        }[self]

    def code(self) -> str:
        return {
            PerceptionLevel.IMPERCEPTIBLE: "IMP",
            PerceptionLevel.MARGINAL: "MAR",
            PerceptionLevel.SUBTLE: "SUB",
            PerceptionLevel.NOTICEABLE: "NOT",
            PerceptionLevel.DEGRADED: "DEG",
        }[self]

    # Severity ordering: IMPERCEPTIBLE is best.
    def rank(self) -> int:
        return list(PerceptionLevel).index(self)

    def is_at_least(self, required: "PerceptionLevel") -> bool:
        """True if this level is as good as or better than `required`."""
        return self.rank() <= required.rank()

    def __str__(self) -> str:
        return self.value


__all__ = ["MetricConfig", "MetricResult", "PerceptionLevel"]
