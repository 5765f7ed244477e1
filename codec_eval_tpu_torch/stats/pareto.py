"""Pareto-front computation for rate-distortion analysis.

Host copy of ``codec_eval_tpu/stats/pareto.py`` (the port imports
nothing from the JAX package).

Behavioral port of the reference (reference: src/stats/pareto.rs:11-186).
Host-side insert-retain algorithm for API parity; a vectorized on-device
variant for large sharded score grids lives in the JAX package's
``codec_eval_tpu.parallel``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass
class RDPoint:
    """A point on a rate-distortion curve.  Lower bpp and higher quality are
    better; negate lower-is-better metrics before constructing."""

    codec: str
    quality_setting: float
    bpp: float
    quality: float
    encode_time_ms: Optional[float] = None
    image: Optional[str] = None

    def dominates(self, other: "RDPoint") -> bool:
        """Better-or-equal on both axes and strictly better on one.
        reference: src/stats/pareto.rs:55-62."""
        return (
            self.bpp <= other.bpp
            and self.quality >= other.quality
            and (self.bpp < other.bpp or self.quality > other.quality)
        )

    def to_json(self) -> dict:
        return {
            "codec": self.codec,
            "quality_setting": self.quality_setting,
            "bpp": self.bpp,
            "quality": self.quality,
            "encode_time_ms": self.encode_time_ms,
            "image": self.image,
        }

    @classmethod
    def from_json(cls, d: dict) -> "RDPoint":
        return cls(
            codec=d["codec"],
            quality_setting=d["quality_setting"],
            bpp=d["bpp"],
            quality=d["quality"],
            encode_time_ms=d.get("encode_time_ms"),
            image=d.get("image"),
        )


@dataclass
class ParetoFront:
    """Non-dominated subset of RD points, sorted by bpp.
    reference: src/stats/pareto.rs:66-186."""

    points: List[RDPoint] = field(default_factory=list)

    @classmethod
    def compute(cls, points: Sequence[RDPoint]) -> "ParetoFront":
        front: List[RDPoint] = []
        for point in points:
            if any(p.dominates(point) for p in front):
                continue
            front = [p for p in front if not point.dominates(p)]
            front.append(point)
        front.sort(key=lambda p: p.bpp)
        return cls(points=front)

    def is_empty(self) -> bool:
        return not self.points

    def __len__(self) -> int:
        return len(self.points)

    def at_quality(self, min_quality: float) -> List[RDPoint]:
        return [p for p in self.points if p.quality >= min_quality]

    def at_bpp(self, max_bpp: float) -> List[RDPoint]:
        return [p for p in self.points if p.bpp <= max_bpp]

    def best_at_bpp(self, max_bpp: float) -> Optional[RDPoint]:
        candidates = self.at_bpp(max_bpp)
        return max(candidates, key=lambda p: p.quality) if candidates else None

    def best_at_quality(self, min_quality: float) -> Optional[RDPoint]:
        candidates = self.at_quality(min_quality)
        return min(candidates, key=lambda p: p.bpp) if candidates else None

    def codecs(self) -> List[str]:
        return sorted({p.codec for p in self.points})

    def filter_codec(self, codec: str) -> List[RDPoint]:
        return [p for p in self.points if p.codec == codec]

    @staticmethod
    def per_codec(points: Sequence[RDPoint]) -> Dict[str, "ParetoFront"]:
        by_codec: Dict[str, List[RDPoint]] = {}
        for p in points:
            by_codec.setdefault(p.codec, []).append(p)
        return {codec: ParetoFront.compute(pts) for codec, pts in by_codec.items()}

    def to_json(self) -> dict:
        return {"points": [p.to_json() for p in self.points]}

    @classmethod
    def from_json(cls, d: dict) -> "ParetoFront":
        return cls(points=[RDPoint.from_json(p) for p in d.get("points", [])])


__all__ = ["RDPoint", "ParetoFront"]
