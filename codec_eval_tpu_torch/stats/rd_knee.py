"""R-D knee detection, fixed-frame corner angles, and calibration.

Host copy of ``codec_eval_tpu/stats/rd_knee.py`` (the port imports
nothing from the JAX package).

Behavioral port of the reference's largest analytics module
(reference: src/stats/rd_knee.rs:57-1084):

- ``FixedFrame``: a web-calibrated normalization frame in which every encode
  gets a corner *angle* measured from the worst corner (bpp_max, quality=0);
  the aspect is calibrated so the mozjpeg/CID22 reference knee sits at 45°.
- dual angles (SSIMULACRA2 vs Butteraugli) reveal artifact character,
- per-curve-normalized knee detection (first slope <= 1 crossing, midpoint),
- angular binning schemes, configuration fingerprints, configured Pareto
  frontiers with bin coverage, corpus aggregation, and the shipped mozjpeg
  calibration defaults pinned as regression data.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Fixed frame
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FixedFrame:
    """Fixed normalization frame for web-targeted R-D analysis.
    reference: src/stats/rd_knee.rs:57-105."""

    bpp_max: float = 4.0
    s2_max: float = 100.0
    ba_max: float = 15.0
    # Calibrated so the CID22 mozjpeg s2 knee (0.7274 bpp, 65.10) is at 45°.
    aspect: float = (1.0 - 0.7274 / 4.0) / (65.10 / 100.0)

    def s2_angle(self, bpp: float, s2: float) -> float:
        """Corner angle (degrees) for an SSIMULACRA2 measurement."""
        bpp_norm = bpp / self.bpp_max
        s2_norm = s2 / self.s2_max
        return math.degrees(math.atan2(s2_norm * self.aspect, 1.0 - bpp_norm))

    def ba_angle(self, bpp: float, ba: float) -> float:
        """Corner angle for Butteraugli (inverted: lower = better)."""
        bpp_norm = bpp / self.bpp_max
        ba_norm = 1.0 - ba / self.ba_max
        return math.degrees(math.atan2(ba_norm * self.aspect, 1.0 - bpp_norm))

    def position(self, bpp: float, s2: float, ba: float) -> "RDPosition":
        return RDPosition(
            theta_s2=self.s2_angle(bpp, s2),
            theta_ba=self.ba_angle(bpp, ba),
            bpp=bpp,
            ssimulacra2=s2,
            butteraugli=ba,
        )


#: Standard web-targeting frame.
WEB_FRAME = FixedFrame()


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AxisRange:
    """[min, max] axis normalization.  reference: src/stats/rd_knee.rs:132-160."""

    min: float
    max: float

    def normalize(self, value: float) -> float:
        return (value - self.min) / (self.max - self.min)

    def denormalize(self, norm: float) -> float:
        return norm * (self.max - self.min) + self.min

    def span(self) -> float:
        return self.max - self.min


class QualityDirection:
    HIGHER_IS_BETTER = "HigherIsBetter"
    LOWER_IS_BETTER = "LowerIsBetter"


@dataclass(frozen=True)
class NormalizationContext:
    """Per-curve normalization for knee detection.
    reference: src/stats/rd_knee.rs:165-188."""

    bpp_range: AxisRange
    quality_range: AxisRange
    direction: str

    def normalize_bpp(self, bpp: float) -> float:
        return self.bpp_range.normalize(bpp)

    def normalize_quality(self, raw_quality: float) -> float:
        n = self.quality_range.normalize(raw_quality)
        if self.direction == QualityDirection.LOWER_IS_BETTER:
            return 1.0 - n
        return n


# ---------------------------------------------------------------------------
# Knee / calibration / position
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RDKnee:
    """The 45°-tangent landmark on a corpus-aggregate R-D curve.
    reference: src/stats/rd_knee.rs:199-215."""

    bpp: float
    quality: float
    fixed_angle: float
    norm: NormalizationContext


@dataclass
class RDCalibration:
    """Dual-metric calibration with knees in the fixed frame.
    reference: src/stats/rd_knee.rs:220-257."""

    frame: FixedFrame
    ssimulacra2: RDKnee
    butteraugli: RDKnee
    corpus: str
    codec: str
    image_count: int
    computed_at: str = ""

    def disagreement_range(self) -> Tuple[float, float]:
        a, b = self.ssimulacra2.bpp, self.butteraugli.bpp
        return (min(a, b), max(a, b))

    def position(self, bpp: float, s2: float, ba: float) -> "RDPosition":
        return self.frame.position(bpp, s2, ba)


@dataclass(frozen=True)
class RDPosition:
    """An encode's dual-angle position in corner space.
    reference: src/stats/rd_knee.rs:273-312."""

    theta_s2: float
    theta_ba: float
    bpp: float
    ssimulacra2: float
    butteraugli: float

    def in_disagreement_zone(self, cal: RDCalibration) -> bool:
        lo, hi = cal.disagreement_range()
        return lo <= self.bpp <= hi

    def bin(self, scheme: "BinScheme") -> "AngleBin":
        return scheme.bin_for(self.theta_s2)

    def dual_bin(self, scheme: "BinScheme") -> "DualAngleBin":
        return DualAngleBin(
            s2=scheme.bin_for(self.theta_s2), ba=scheme.bin_for(self.theta_ba)
        )


# ---------------------------------------------------------------------------
# Angular binning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AngleBin:
    index: int
    center: float
    width: float

    def lo(self) -> float:
        return self.center - self.width / 2.0

    def hi(self) -> float:
        return self.center + self.width / 2.0

    def contains(self, angle_deg: float) -> bool:
        return self.lo() <= angle_deg < self.hi()


@dataclass(frozen=True)
class DualAngleBin:
    s2: AngleBin
    ba: AngleBin


@dataclass(frozen=True)
class BinScheme:
    """Equal-width angular bins over [0°, 90°].
    reference: src/stats/rd_knee.rs:320-411."""

    start: float
    width: float
    count: int

    @classmethod
    def range(cls, lo: float, hi: float, count: int) -> "BinScheme":
        width = (hi - lo) / count
        return cls(start=lo + width / 2.0, width=width, count=count)

    @classmethod
    def default_18(cls) -> "BinScheme":
        return cls.range(0.0, 90.0, 18)

    @classmethod
    def fine_36(cls) -> "BinScheme":
        return cls.range(0.0, 90.0, 36)

    def bin_for(self, angle_deg: float) -> AngleBin:
        first_edge = self.start - self.width / 2.0
        idx = math.floor((angle_deg - first_edge) / self.width)
        idx = int(min(max(idx, 0), self.count - 1))
        return AngleBin(index=idx, center=self.start + idx * self.width, width=self.width)

    def bins(self) -> List[AngleBin]:
        return [
            AngleBin(index=i, center=self.start + i * self.width, width=self.width)
            for i in range(self.count)
        ]


# ---------------------------------------------------------------------------
# Codec configuration tracking
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamValue:
    """A single typed tuning-parameter value (int / float / bool / text),
    formatted the way the reference's Display impl does (bools as
    ``true``/``false``, floats without a trailing ``.0``).
    reference: src/stats/rd_knee.rs:420-437."""

    value: object

    @classmethod
    def int(cls, v: int) -> "ParamValue":
        return cls(int(v))

    @classmethod
    def float(cls, v: float) -> "ParamValue":
        return cls(float(v))

    @classmethod
    def bool(cls, v: bool) -> "ParamValue":
        return cls(bool(v))

    @classmethod
    def text(cls, v: str) -> "ParamValue":
        return cls(str(v))

    def __str__(self) -> str:
        v = self.value
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float):
            # Rust's {} for f64 drops a redundant fractional part: 1.0 -> "1".
            return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)
        return str(v)

    def to_json(self):
        return self.value


@dataclass
class CodecConfig:
    """The tuning knobs that produced an encode (sorted param map +
    fingerprint).  reference: src/stats/rd_knee.rs:436-471."""

    codec: str
    version: str
    params: Dict[str, object] = field(default_factory=dict)

    def with_param(self, key: str, value) -> "CodecConfig":
        self.params[key] = value
        return self

    def fingerprint(self) -> str:
        def fmt(v):
            if isinstance(v, ParamValue):
                return str(v)
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)

        parts = [f"{k}={fmt(v)}" for k, v in sorted(self.params.items())]
        return f"{self.codec}@{self.version} [{', '.join(parts)}]"


# ---------------------------------------------------------------------------
# Configured Pareto frontier
# ---------------------------------------------------------------------------


@dataclass
class ConfiguredRDPoint:
    position: RDPosition
    config: CodecConfig
    image: Optional[str] = None
    encode_time_ms: Optional[float] = None
    decode_time_ms: Optional[float] = None


@dataclass
class ConfiguredParetoFront:
    """Configuration-aware Pareto frontier (bpp vs s2) with angular bin
    coverage queries.  reference: src/stats/rd_knee.rs:489-608."""

    calibration: RDCalibration
    scheme: BinScheme
    points: List[ConfiguredRDPoint] = field(default_factory=list)

    @classmethod
    def compute(
        cls,
        points: Sequence[ConfiguredRDPoint],
        calibration: RDCalibration,
        scheme: BinScheme,
    ) -> "ConfiguredParetoFront":
        def dominates(a: RDPosition, b: RDPosition) -> bool:
            return (
                a.bpp <= b.bpp
                and a.ssimulacra2 >= b.ssimulacra2
                and (a.bpp < b.bpp or a.ssimulacra2 > b.ssimulacra2)
            )

        front: List[ConfiguredRDPoint] = []
        for point in points:
            if any(dominates(p.position, point.position) for p in front):
                continue
            front = [p for p in front if not dominates(point.position, p.position)]
            front.append(point)
        front.sort(key=lambda p: p.position.bpp)
        return cls(calibration=calibration, scheme=scheme, points=front)

    def best_config_for_s2(self, min_s2: float) -> Optional[ConfiguredRDPoint]:
        cands = [p for p in self.points if p.position.ssimulacra2 >= min_s2]
        return min(cands, key=lambda p: p.position.bpp) if cands else None

    def best_config_for_ba(self, max_ba: float) -> Optional[ConfiguredRDPoint]:
        cands = [p for p in self.points if p.position.butteraugli <= max_ba]
        return min(cands, key=lambda p: p.position.bpp) if cands else None

    def best_config_for_bpp(self, max_bpp: float) -> Optional[ConfiguredRDPoint]:
        cands = [p for p in self.points if p.position.bpp <= max_bpp]
        return max(cands, key=lambda p: p.position.ssimulacra2) if cands else None

    def in_bin(self, bin_: AngleBin) -> List[ConfiguredRDPoint]:
        return [p for p in self.points if bin_.contains(p.position.theta_s2)]

    def coverage(self) -> List[Tuple[AngleBin, int]]:
        return [(b, len(self.in_bin(b))) for b in self.scheme.bins()]

    def empty_bins(self) -> List[AngleBin]:
        return [b for b, count in self.coverage() if count == 0]


# ---------------------------------------------------------------------------
# Corpus aggregation and knee detection
# ---------------------------------------------------------------------------


@dataclass
class EncodeResult:
    """One encode of one image at one quality.
    reference: src/stats/rd_knee.rs:615-623."""

    bpp: float
    ssimulacra2: float
    butteraugli: float
    image: str
    config: CodecConfig


@dataclass
class CorpusAggregate:
    """Corpus-mean R-D curve (bpp, mean_s2, mean_ba) sorted by bpp.
    reference: src/stats/rd_knee.rs:626-702."""

    corpus: str
    codec: str
    curve: List[Tuple[float, float, float]]
    image_count: int

    def ssimulacra2_knee(self, frame: FixedFrame) -> Optional[RDKnee]:
        return self._find_knee_for(
            QualityDirection.HIGHER_IS_BETTER,
            lambda p: p[1],
            frame.s2_angle,
        )

    def butteraugli_knee(self, frame: FixedFrame) -> Optional[RDKnee]:
        return self._find_knee_for(
            QualityDirection.LOWER_IS_BETTER,
            lambda p: p[2],
            frame.ba_angle,
        )

    def calibrate(self, frame: FixedFrame) -> Optional[RDCalibration]:
        s2 = self.ssimulacra2_knee(frame)
        ba = self.butteraugli_knee(frame)
        if s2 is None or ba is None:
            return None
        return RDCalibration(
            frame=frame,
            ssimulacra2=s2,
            butteraugli=ba,
            corpus=self.corpus,
            codec=self.codec,
            image_count=self.image_count,
            computed_at="",
        )

    def _find_knee_for(
        self,
        direction: str,
        extract: Callable[[Tuple[float, float, float]], float],
        fixed_angle: Callable[[float, float], float],
    ) -> Optional[RDKnee]:
        if len(self.curve) < 3:
            return None
        bpps = [p[0] for p in self.curve]
        qs = [extract(p) for p in self.curve]
        norm = NormalizationContext(
            bpp_range=AxisRange(min(bpps), max(bpps)),
            quality_range=AxisRange(min(qs), max(qs)),
            direction=direction,
        )
        return find_knee(self.curve, norm, extract, fixed_angle)


def find_knee(
    curve: Sequence[Tuple[float, float, float]],
    norm: NormalizationContext,
    extract_quality: Callable[[Tuple[float, float, float]], float],
    compute_fixed_angle: Callable[[float, float], float],
) -> Optional[RDKnee]:
    """First segment whose normalized slope drops to <= 1.0; knee is the
    segment midpoint.  reference: src/stats/rd_knee.rs:706-750."""
    if len(curve) < 2:
        return None

    slopes: List[Tuple[int, float]] = []
    for i in range(len(curve) - 1):
        b0 = norm.normalize_bpp(curve[i][0])
        b1 = norm.normalize_bpp(curve[i + 1][0])
        q0 = norm.normalize_quality(extract_quality(curve[i]))
        q1 = norm.normalize_quality(extract_quality(curve[i + 1]))
        d_bpp = b1 - b0
        if abs(d_bpp) < 1e-12:
            continue
        slopes.append((i, (q1 - q0) / d_bpp))

    if not slopes:
        return None

    crossing = next(
        (k for k, (_, s) in enumerate(slopes) if s <= 1.0), len(slopes) // 2
    )
    seg_idx = slopes[crossing][0]
    bpp = (curve[seg_idx][0] + curve[seg_idx + 1][0]) / 2.0
    quality = (extract_quality(curve[seg_idx]) + extract_quality(curve[seg_idx + 1])) / 2.0
    return RDKnee(
        bpp=bpp,
        quality=quality,
        fixed_angle=compute_fixed_angle(bpp, quality),
        norm=norm,
    )


def interpolate_s2_at(
    curve: Sequence[Tuple[float, float, float]], target_bpp: float
) -> Optional[float]:
    """Linear interpolation of mean-s2 at a bpp on an aggregate curve.
    reference: src/stats/rd_knee.rs:980-996."""
    if len(curve) < 2:
        return None
    for (b0, s0, _), (b1, s1, _) in zip(curve, curve[1:]):
        if b0 <= target_bpp <= b1 and abs(b1 - b0) > 1e-12:
            t = (target_bpp - b0) / (b1 - b0)
            return s0 + t * (s1 - s0)
    return None


# ---------------------------------------------------------------------------
# Shipped calibration defaults (pinned regression data)
# ---------------------------------------------------------------------------


class defaults:
    """Measured mozjpeg calibrations (reference: src/stats/rd_knee.rs:1018-1084)."""

    @staticmethod
    def mozjpeg_cid22() -> RDCalibration:
        """MozJPEG 4:2:0 progressive on CID22-training (209 images, 512²)."""
        frame = WEB_FRAME
        return RDCalibration(
            frame=frame,
            ssimulacra2=RDKnee(
                bpp=0.7274,
                quality=65.10,
                fixed_angle=frame.s2_angle(0.7274, 65.10),
                norm=NormalizationContext(
                    bpp_range=AxisRange(0.1760, 3.6274),
                    quality_range=AxisRange(-8.48, 87.99),
                    direction=QualityDirection.HIGHER_IS_BETTER,
                ),
            ),
            butteraugli=RDKnee(
                bpp=0.7048,
                quality=4.378,
                fixed_angle=frame.ba_angle(0.7048, 4.378),
                norm=NormalizationContext(
                    bpp_range=AxisRange(0.1760, 3.6274),
                    quality_range=AxisRange(1.854, 11.663),
                    direction=QualityDirection.LOWER_IS_BETTER,
                ),
            ),
            corpus="CID22-training",
            codec="mozjpeg-420-prog",
            image_count=209,
            computed_at="2026-02-03T22:56:01Z",
        )

    @staticmethod
    def mozjpeg_clic2025() -> RDCalibration:
        """MozJPEG 4:2:0 progressive on CLIC2025-training (32 images, ~2048px)."""
        frame = WEB_FRAME
        return RDCalibration(
            frame=frame,
            ssimulacra2=RDKnee(
                bpp=0.4623,
                quality=58.95,
                fixed_angle=frame.s2_angle(0.4623, 58.95),
                norm=NormalizationContext(
                    bpp_range=AxisRange(0.1194, 3.0694),
                    quality_range=AxisRange(-16.94, 87.63),
                    direction=QualityDirection.HIGHER_IS_BETTER,
                ),
            ),
            butteraugli=RDKnee(
                bpp=0.3948,
                quality=5.192,
                fixed_angle=frame.ba_angle(0.3948, 5.192),
                norm=NormalizationContext(
                    bpp_range=AxisRange(0.1194, 3.0694),
                    quality_range=AxisRange(1.895, 13.264),
                    direction=QualityDirection.LOWER_IS_BETTER,
                ),
            ),
            corpus="CLIC2025-training",
            codec="mozjpeg-420-prog",
            image_count=32,
            computed_at="2026-02-03T23:09:01Z",
        )


__all__ = [
    "FixedFrame",
    "WEB_FRAME",
    "AxisRange",
    "QualityDirection",
    "NormalizationContext",
    "RDKnee",
    "RDCalibration",
    "RDPosition",
    "AngleBin",
    "DualAngleBin",
    "BinScheme",
    "CodecConfig",
    "ConfiguredRDPoint",
    "ConfiguredParetoFront",
    "EncodeResult",
    "CorpusAggregate",
    "find_knee",
    "interpolate_s2_at",
    "defaults",
]
