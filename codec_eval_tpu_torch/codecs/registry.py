"""Codec registry and comparison configuration.

Port of ``codec_eval_tpu/codecs/registry.py`` (reference:
crates/codec-compare/src/registry.rs:14-285): a ``CompareConfig`` with a
format selection decides which adapters register into an inner
``EvalSession``, which scores on ``device`` (the card unless the caller
asks for the CPU).  The zenjpeg slot is filled by ``TpuJpegCodec``'s
presets on the same device, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

from ..engine import EvalConfig, EvalSession, ImageData, ImageReport, CorpusReport
from ..metrics import MetricConfig
from ..viewing import ViewingCondition
from .base import STANDARD_QUALITY_LEVELS, CodecImpl
from .pil_codecs import (
    AvifCodec,
    JpegCodec,
    WebPCodec,
    jpegli_stub,
    jpegxl_stub,
)


@dataclass
class FormatSelection:
    """Which codec families to include.
    reference: crates/codec-compare/src/registry.rs:89-138."""

    jpeg: bool = False
    zenjpeg: bool = False
    webp: bool = False
    avif: bool = False
    jpegxl: bool = False

    @classmethod
    def all(cls) -> "FormatSelection":
        return cls(jpeg=True, zenjpeg=True, webp=True, avif=True, jpegxl=True)

    @classmethod
    def jpeg_only(cls) -> "FormatSelection":
        return cls(jpeg=True, zenjpeg=True)

    @classmethod
    def next_gen(cls) -> "FormatSelection":
        return cls(webp=True, avif=True, jpegxl=True)


@dataclass
class CompareConfig:
    """Comparison run configuration.
    reference: crates/codec-compare/src/registry.rs:14-85."""

    output_dir: Path = Path("./reports")
    quality_levels: List[float] = field(
        default_factory=lambda: list(STANDARD_QUALITY_LEVELS)
    )
    viewing: ViewingCondition = field(default_factory=ViewingCondition.desktop)
    metrics: MetricConfig = field(default_factory=MetricConfig.perceptual)
    formats: FormatSelection = field(default_factory=FormatSelection)
    avif_speed: int = 6

    @classmethod
    def new(cls, output_dir) -> "CompareConfig":
        return cls(output_dir=Path(output_dir))

    def with_quality_levels(self, levels) -> "CompareConfig":
        self.quality_levels = [float(q) for q in levels]
        return self

    def with_viewing(self, viewing: ViewingCondition) -> "CompareConfig":
        self.viewing = viewing
        return self

    def with_metrics(self, metrics: MetricConfig) -> "CompareConfig":
        self.metrics = metrics
        return self

    def with_formats(self, formats: FormatSelection) -> "CompareConfig":
        self.formats = formats
        return self

    def with_avif_speed(self, speed: int) -> "CompareConfig":
        self.avif_speed = min(speed, 10)
        return self


class CodecRegistry:
    """Registers codec adapters into an EvalSession and runs evaluations.
    reference: crates/codec-compare/src/registry.rs:138-285."""

    def __init__(self, config: CompareConfig, device="cuda"):
        self.config = config
        eval_config = EvalConfig(
            report_dir=Path(config.output_dir),
            viewing=config.viewing,
            metrics=config.metrics,
            quality_levels=list(config.quality_levels),
        )
        self.device = device
        self.session = EvalSession(eval_config, device=device)
        self.codecs: List[CodecImpl] = []
        self.skipped: List[CodecImpl] = []

    def register_codec(self, codec: CodecImpl) -> bool:
        """Bridge a CodecImpl into session callbacks; skips unavailable
        codecs (reference: registry.rs:233-242)."""
        if not codec.is_available():
            self.skipped.append(codec)
            return False
        self.codecs.append(codec)
        self.session.add_codec_impl(codec)
        return True

    def register_all(self) -> int:
        """Register every adapter selected by the format flags.
        reference: registry.rs:162-231."""
        count = 0
        f = self.config.formats
        if f.jpeg:
            for codec in JpegCodec.all_variants():
                count += self.register_codec(codec)
            count += self.register_codec(jpegli_stub())
        if f.zenjpeg:
            # The reference's zenjpeg slot (a jpegli-style software
            # encoder) is filled by tpujpeg.
            from .tpujpeg import TpuJpegCodec

            for codec in TpuJpegCodec.presets(device=self.device):
                count += self.register_codec(codec)
        if f.webp:
            count += self.register_codec(WebPCodec())
        if f.avif:
            for codec in AvifCodec.presets():
                codec.speed = codec.speed if codec.label != "baseline" else self.config.avif_speed
                count += self.register_codec(codec)
        if f.jpegxl:
            from .jxl import JpegXlCodec, is_available as _jxl_available

            count += self.register_codec(
                JpegXlCodec() if _jxl_available() else jpegxl_stub()
            )
        return count

    def codec_ids(self) -> List[str]:
        return [c.id() for c in self.codecs]

    def evaluate_image(self, name: str, image: ImageData) -> ImageReport:
        return self.session.evaluate_image(name, image)

    def write_image_report(self, report: ImageReport) -> None:
        self.session.write_image_report(report)

    def write_corpus_report(self, report: CorpusReport) -> None:
        self.session.write_corpus_report(report)
