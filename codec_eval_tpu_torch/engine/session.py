"""EvalSession: the callback-based evaluation engine.

Port of the host path of ``codec_eval_tpu/engine/session.py`` (reference:
src/eval/session.rs:280-508).  Codecs are opaque host callbacks; every
decoded candidate of an image is staged into one batch and scored by the
``BatchScorer`` on the session's device in one pass.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..errors import CodecError, CodecEvalError, DimensionMismatch, InvalidQuality
from ..metrics import MetricConfig, MetricResult
from ..viewing import ViewingCondition
from .image import ImageData
from .report import CodecResult, ImageReport, write_json
from .scoring import BatchScorer

#: Encode callback: (ImageData, EncodeRequest) -> bytes
EncodeFn = Callable[["ImageData", "EncodeRequest"], bytes]
#: Decode callback: bytes -> ImageData
DecodeFn = Callable[[bytes], "ImageData"]

DEFAULT_QUALITY_LEVELS = [50.0, 60.0, 70.0, 80.0, 85.0, 90.0, 95.0]


@dataclass
class EncodeRequest:
    """Quality + codec-specific params.  reference: src/eval/session.rs:150-178."""

    quality: float
    params: Dict[str, str] = field(default_factory=dict)

    def with_param(self, key: str, value: str) -> "EncodeRequest":
        self.params[key] = value
        return self


@dataclass
class EvalConfig:
    """Session configuration.  reference: src/eval/session.rs:188-278."""

    report_dir: Path
    viewing: ViewingCondition = field(default_factory=ViewingCondition.desktop)
    metrics: MetricConfig = field(default_factory=MetricConfig.all)
    quality_levels: List[float] = field(default_factory=lambda: list(DEFAULT_QUALITY_LEVELS))

    def __post_init__(self) -> None:
        for q in self.quality_levels:
            if not 0.0 <= q <= 100.0:
                raise InvalidQuality(q)

    @classmethod
    def builder(cls) -> "EvalConfigBuilder":
        return EvalConfigBuilder()


class EvalConfigBuilder:
    """Builder with the reference's defaulting rules (report_dir required)."""

    def __init__(self) -> None:
        self._report_dir: Optional[Path] = None
        self._viewing: Optional[ViewingCondition] = None
        self._metrics: Optional[MetricConfig] = None
        self._quality_levels: Optional[List[float]] = None

    def report_dir(self, path) -> "EvalConfigBuilder":
        self._report_dir = Path(path)
        return self

    def viewing(self, viewing: ViewingCondition) -> "EvalConfigBuilder":
        self._viewing = viewing
        return self

    def metrics(self, metrics: MetricConfig) -> "EvalConfigBuilder":
        self._metrics = metrics
        return self

    def quality_levels(self, levels: List[float]) -> "EvalConfigBuilder":
        self._quality_levels = [float(q) for q in levels]
        return self

    def build(self) -> EvalConfig:
        if self._report_dir is None:
            raise ValueError("report_dir is required")
        return EvalConfig(
            report_dir=self._report_dir,
            viewing=self._viewing or ViewingCondition.desktop(),
            metrics=self._metrics or MetricConfig.all(),
            quality_levels=self._quality_levels or list(DEFAULT_QUALITY_LEVELS),
        )


@dataclass
class _CodecEntry:
    id: str
    version: str
    encode: EncodeFn
    decode: Optional[DecodeFn]


class EvalSession:
    """The evaluation engine.  reference: src/eval/session.rs:309-497.

    ``device`` is where the metrics run: the card ("cuda", the default) or
    the host ("cpu", when the caller asks for it).
    """

    def __init__(self, config: EvalConfig, device="cuda"):
        self.config = config
        self._codecs: List[_CodecEntry] = []
        self._scorer = BatchScorer(config.metrics, device=device)

    def add_codec(self, codec_id: str, version: str, encode: EncodeFn) -> "EvalSession":
        self._codecs.append(_CodecEntry(codec_id, version, encode, None))
        return self

    def add_codec_with_decode(
        self, codec_id: str, version: str, encode: EncodeFn, decode: DecodeFn
    ) -> "EvalSession":
        self._codecs.append(_CodecEntry(codec_id, version, encode, decode))
        return self

    def _stage_cell(self, image: ImageData, codec: _CodecEntry, quality: float) -> dict:
        """Host phase for one (codec, quality) cell: encode/decode, timed.
        Callback failures become typed ``CodecError``s."""
        width, height = image.width, image.height
        request = EncodeRequest(quality=quality)
        t0 = time.perf_counter()
        try:
            encoded = codec.encode(image, request)
        except CodecEvalError:
            raise
        except Exception as e:  # noqa: BLE001 - callback boundary
            raise CodecError(
                codec.id, f"encode failed at q{quality:g}: {type(e).__name__}: {e}"
            ) from e
        encode_ms = int((time.perf_counter() - t0) * 1000)
        entry = {
            "codec": codec,
            "quality": quality,
            "params": request.params,
            "file_size": len(encoded),
            "encode_ms": encode_ms,
            "decode_ms": None,
            "decoded": None,
            "error": None,
        }
        if codec.decode is not None:
            t0 = time.perf_counter()
            try:
                decoded = codec.decode(encoded)
            except CodecEvalError:
                raise
            except Exception as e:  # noqa: BLE001 - callback boundary
                raise CodecError(
                    codec.id, f"decode failed at q{quality:g}: {type(e).__name__}: {e}"
                ) from e
            entry["decode_ms"] = int((time.perf_counter() - t0) * 1000)
            decoded_rgb = decoded.to_rgb8_srgb()
            if decoded_rgb.shape[:2] != (height, width):
                raise DimensionMismatch(
                    (width, height), (decoded_rgb.shape[1], decoded_rgb.shape[0])
                )
            entry["decoded"] = decoded_rgb
        return entry

    def _stage_image(self, image: ImageData, on_error: str = "raise") -> List[dict]:
        """Run every (codec, quality) cell.  With ``on_error="skip"`` a
        failing cell is kept as an unscored row and the others still run."""
        staged: List[dict] = []
        for codec in self._codecs:
            for quality in self.config.quality_levels:
                try:
                    staged.append(self._stage_cell(image, codec, quality))
                except CodecEvalError as e:
                    if on_error != "skip":
                        raise
                    staged.append(
                        {
                            "codec": codec,
                            "quality": quality,
                            "params": {},
                            "file_size": 0,
                            "encode_ms": 0,
                            "decode_ms": None,
                            "decoded": None,
                            "error": str(e),
                        }
                    )
        return staged

    def _score_and_report(self, name: str, image: ImageData, staged: List[dict]) -> ImageReport:
        """Device phase: one batch for all decodable pairs."""
        width, height = image.width, image.height
        report = ImageReport(name=name, width=width, height=height)
        decodable = [e for e in staged if e["decoded"] is not None]
        if decodable and self._scorer.enabled():
            batch = np.stack([e["decoded"] for e in decodable])
            results = self._scorer.score_batch(image.to_rgb8(), batch)
            for e, m in zip(decodable, results):
                e["metrics"] = m
        for e in staged:
            metrics = e.get("metrics", MetricResult())
            report.results.append(
                CodecResult(
                    codec_id=e["codec"].id,
                    codec_version=e["codec"].version,
                    quality=e["quality"],
                    file_size=e["file_size"],
                    bits_per_pixel=e["file_size"] * 8 / (width * height),
                    encode_time_ms=e["encode_ms"],
                    decode_time_ms=e["decode_ms"],
                    metrics=metrics,
                    perception=metrics.perception_level() if e["decoded"] is not None else None,
                    codec_params=e["params"],
                )
            )
        return report

    def evaluate_image(self, name: str, image: ImageData, on_error: str = "raise") -> ImageReport:
        """Evaluate one image across all codecs x quality levels: host codecs
        run serially (timed each), then every decoded candidate is scored in
        one batch."""
        return self._score_and_report(name, image, self._stage_image(image, on_error))

    def write_image_report(self, report: ImageReport) -> None:
        """JSON report at <report_dir>/<name>.json.  reference: src/eval/session.rs:500-508."""
        self.config.report_dir.mkdir(parents=True, exist_ok=True)
        write_json(report, self.config.report_dir / f"{report.name}.json")
