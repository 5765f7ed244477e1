"""Report types with the JSON and CSV schemas of the reference.

A copy of ``codec_eval_tpu/engine/report.py`` (reference: src/eval/report.rs;
serde layout: durations as integer milliseconds, RFC3339 timestamps,
PerceptionLevel as its variant name) with the 13-column CSV summary of
src/eval/session.rs:526-584.  Host code: no tensor reaches it.
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional

from ..metrics import MetricResult, PerceptionLevel


def _rfc3339_now() -> str:
    # chrono's to_rfc3339 emits offset "+00:00"; datetime.isoformat matches.
    return datetime.now(timezone.utc).isoformat()


def _json_float(v: Optional[float]) -> Optional[float]:
    """JSON has no inf/nan; serde would fail — we clamp to null like the
    reference's Option treatment of unscored metrics."""
    if v is None or math.isnan(v):
        return None
    if math.isinf(v):
        return 1e308 if v > 0 else -1e308
    return v


@dataclass
class CodecResult:
    """One (codec, quality) evaluation.  reference: src/eval/report.rs:16-52."""

    codec_id: str
    codec_version: str
    quality: float
    file_size: int
    bits_per_pixel: float
    encode_time_ms: int
    decode_time_ms: Optional[int]
    metrics: MetricResult
    perception: Optional[PerceptionLevel]
    cached_path: Optional[str] = None
    codec_params: Dict[str, str] = field(default_factory=dict)

    def compression_ratio(self, original_size: int) -> float:
        if self.file_size == 0:
            return 0.0
        return original_size / self.file_size

    def to_json(self) -> dict:
        return {
            "codec_id": self.codec_id,
            "codec_version": self.codec_version,
            "quality": self.quality,
            "file_size": self.file_size,
            "bits_per_pixel": self.bits_per_pixel,
            "encode_time": self.encode_time_ms,
            "decode_time": self.decode_time_ms,
            "metrics": {
                "dssim": _json_float(self.metrics.dssim),
                "ssimulacra2": _json_float(self.metrics.ssimulacra2),
                "butteraugli": _json_float(self.metrics.butteraugli),
                "psnr": _json_float(self.metrics.psnr),
            },
            "perception": self.perception.value if self.perception else None,
            "cached_path": self.cached_path,
            "codec_params": self.codec_params,
        }

    @classmethod
    def from_json(cls, d: dict) -> "CodecResult":
        perception = d.get("perception")
        return cls(
            codec_id=d["codec_id"],
            codec_version=d["codec_version"],
            quality=d["quality"],
            file_size=d["file_size"],
            bits_per_pixel=d["bits_per_pixel"],
            encode_time_ms=d.get("encode_time", 0),
            decode_time_ms=d.get("decode_time"),
            metrics=MetricResult.from_json(d.get("metrics", {})),
            perception=PerceptionLevel(perception) if perception else None,
            cached_path=d.get("cached_path"),
            codec_params=d.get("codec_params", {}),
        )


@dataclass
class ImageReport:
    """Per-image evaluation report.  reference: src/eval/report.rs:68-135."""

    name: str
    width: int
    height: int
    source_path: Optional[str] = None
    uncompressed_size: int = 0
    results: List[CodecResult] = field(default_factory=list)
    timestamp: str = field(default_factory=_rfc3339_now)

    def __post_init__(self) -> None:
        if not self.uncompressed_size:
            self.uncompressed_size = self.width * self.height * 3

    def results_for_codec(self, codec_id: str) -> List[CodecResult]:
        return [r for r in self.results if r.codec_id == codec_id]

    def best_at_size(self, max_bytes: int) -> Optional[CodecResult]:
        """Best (lowest-DSSIM) result at or below a size budget.
        reference: src/eval/report.rs:112-126."""
        candidates = [r for r in self.results if r.file_size <= max_bytes]
        if not candidates:
            return None
        return max(
            candidates,
            key=lambda r: -r.metrics.dssim if r.metrics.dssim is not None else -math.inf,
        )

    def smallest_at_quality(self, max_dssim: float) -> Optional[CodecResult]:
        candidates = [
            r
            for r in self.results
            if r.metrics.dssim is not None and r.metrics.dssim <= max_dssim
        ]
        return min(candidates, key=lambda r: r.file_size) if candidates else None

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "source_path": self.source_path,
            "width": self.width,
            "height": self.height,
            "uncompressed_size": self.uncompressed_size,
            "results": [r.to_json() for r in self.results],
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ImageReport":
        return cls(
            name=d["name"],
            width=d["width"],
            height=d["height"],
            source_path=d.get("source_path"),
            uncompressed_size=d.get("uncompressed_size", 0),
            results=[CodecResult.from_json(r) for r in d.get("results", [])],
            timestamp=d.get("timestamp", _rfc3339_now()),
        )


@dataclass
class CorpusReport:
    """Corpus-wide report.  reference: src/eval/report.rs:138-183."""

    name: str
    images: List[ImageReport] = field(default_factory=list)
    timestamp: str = field(default_factory=_rfc3339_now)
    config_summary: str = ""

    def total_results(self) -> int:
        return sum(len(img.results) for img in self.images)

    def codec_ids(self) -> List[str]:
        ids = sorted({r.codec_id for img in self.images for r in img.results})
        return ids

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "images": [img.to_json() for img in self.images],
            "timestamp": self.timestamp,
            "config_summary": self.config_summary,
        }

    @classmethod
    def from_json(cls, d: dict) -> "CorpusReport":
        return cls(
            name=d["name"],
            images=[ImageReport.from_json(i) for i in d.get("images", [])],
            timestamp=d.get("timestamp", _rfc3339_now()),
            config_summary=d.get("config_summary", ""),
        )


CSV_COLUMNS = [
    "image",
    "codec",
    "version",
    "quality",
    "file_size",
    "bpp",
    "encode_ms",
    "decode_ms",
    "dssim",
    "ssimulacra2",
    "butteraugli",
    "psnr",
    "perception",
]


def _fmt_quality(q: float) -> str:
    """Rust f64 Display: integral values render without trailing zeros."""
    if q == int(q):
        return str(int(q))
    return repr(q)


def write_csv_summary(report: CorpusReport, path: Path) -> None:
    """13-column CSV with the reference's exact column order and float
    formats ({:.4} bpp, {:.6} dssim, {:.2} ssimulacra2, {:.4} butteraugli,
    {:.2} psnr).  reference: src/eval/session.rs:526-584."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_COLUMNS)
        for img in report.images:
            for r in img.results:
                m = r.metrics
                w.writerow(
                    [
                        img.name,
                        r.codec_id,
                        r.codec_version,
                        _fmt_quality(r.quality),
                        str(r.file_size),
                        f"{r.bits_per_pixel:.4f}",
                        str(r.encode_time_ms),
                        "" if r.decode_time_ms is None else str(r.decode_time_ms),
                        "" if m.dssim is None else f"{m.dssim:.6f}",
                        "" if m.ssimulacra2 is None else f"{m.ssimulacra2:.2f}",
                        "" if m.butteraugli is None else f"{m.butteraugli:.4f}",
                        "" if m.psnr is None else f"{m.psnr:.2f}",
                        "" if r.perception is None else r.perception.code(),
                    ]
                )


def write_json(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj.to_json(), f, indent=2)
        f.write("\n")
