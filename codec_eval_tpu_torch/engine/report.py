"""Report types with the JSON schema of ``codec_eval_tpu/engine/report.py``.

reference: src/eval/report.rs (serde layout: Duration-as-integer-millis,
RFC3339 timestamps, PerceptionLevel as its variant name).
"""

from __future__ import annotations

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

def write_json(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj.to_json(), f, indent=2)
        f.write("\n")
