"""CompareAgainstAll: builder API for "my codec against everything".

Port of ``codec_eval_tpu/codecs/compare.py`` (reference:
crates/codec-compare/src/compare.rs:83-363): a subject codec's
encode/decode callbacks swept against the comparison codecs over a corpus,
with Pareto membership and per-codec BD-rates (BETTER/WORSE/SIMILAR at the
+-5% band).  Scoring runs on ``device``, the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..engine import CorpusReport, EvalConfig, EvalSession, ImageData
from ..corpus import Corpus
from ..errors import CodecEvalError
from ..metrics import MetricConfig
from ..stats.pareto import ParetoFront
from ..stats.summary import bd_rate, mean
from ..viewing import ViewingCondition
from .base import STANDARD_QUALITY_LEVELS
from .pil_codecs import AvifCodec, JpegCodec, WebPCodec
from .report import Metric, ReportGenerator, extract_rd_points


@dataclass
class CompareResult:
    """reference: crates/codec-compare/src/compare.rs:279-363."""

    subject_codec: str
    corpus_report: CorpusReport
    pareto: ParetoFront
    bd_rates: Dict[str, float]
    output_dir: Path

    def subject_on_pareto(self) -> bool:
        return any(p.codec == self.subject_codec for p in self.pareto.points)

    def subject_rd_curve(self) -> List[tuple]:
        return [
            (p.bpp, p.quality)
            for p in self.pareto.points
            if p.codec == self.subject_codec
        ]

    def print_summary(self) -> None:
        print("=" * 60)
        print(f"COMPARISON RESULTS FOR: {self.subject_codec}")
        print("=" * 60)
        print("\nBD-Rate (negative = subject is better):")
        print("-" * 40)
        for codec, rate in sorted(self.bd_rates.items(), key=lambda kv: kv[1]):
            status = "BETTER" if rate < -5.0 else "WORSE" if rate > 5.0 else "SIMILAR"
            print(f"  {codec:<20} {rate:+8.1f}%  ({status})")
        print("-" * 40)
        print(f"\nSubject on Pareto front: {self.subject_on_pareto()}")


class CompareAgainstAll:
    """Builder for one-vs-all codec comparison over a corpus."""

    def __init__(self, codec_id: str, version: str, device="cuda"):
        self.codec_id = codec_id
        self.device = device
        self.codec_version = version
        self._encode: Optional[Callable] = None
        self._decode: Optional[Callable] = None
        self._corpus_path: Optional[Path] = None
        self._format: Optional[str] = None
        self._quality_levels = list(STANDARD_QUALITY_LEVELS)
        self._metric = Metric.SSIMULACRA2
        self._include_same_format = True
        self._include_other_formats = True
        self._limit: Optional[int] = None
        self._output_dir = Path("./reports")
        self._viewing = ViewingCondition.desktop()

    # -- builder -----------------------------------------------------------
    def with_encode(self, fn) -> "CompareAgainstAll":
        self._encode = fn
        return self

    def with_decode(self, fn) -> "CompareAgainstAll":
        self._decode = fn
        return self

    def with_format(self, fmt: str) -> "CompareAgainstAll":
        self._format = fmt
        return self

    def on_corpus(self, path) -> "CompareAgainstAll":
        self._corpus_path = Path(path)
        return self

    def with_quality_levels(self, levels) -> "CompareAgainstAll":
        self._quality_levels = [float(q) for q in levels]
        return self

    def with_metric(self, metric: Metric) -> "CompareAgainstAll":
        self._metric = metric
        return self

    def same_format_only(self) -> "CompareAgainstAll":
        self._include_same_format = True
        self._include_other_formats = False
        return self

    def other_formats_only(self) -> "CompareAgainstAll":
        self._include_same_format = False
        self._include_other_formats = True
        return self

    def with_limit(self, limit: int) -> "CompareAgainstAll":
        self._limit = limit
        return self

    def output_to(self, path) -> "CompareAgainstAll":
        self._output_dir = Path(path)
        return self

    def with_viewing(self, viewing: ViewingCondition) -> "CompareAgainstAll":
        self._viewing = viewing
        return self

    # -- run ---------------------------------------------------------------
    def run(self) -> CompareResult:
        if self._encode is None or self._decode is None:
            raise CodecEvalError("encode/decode functions not provided")
        if self._corpus_path is None:
            raise CodecEvalError("corpus path not provided")

        corpus = Corpus.discover(self._corpus_path)
        count = min(self._limit or len(corpus.images), len(corpus.images))

        self._output_dir.mkdir(parents=True, exist_ok=True)
        config = (
            EvalConfig.builder()
            .report_dir(self._output_dir)
            .viewing(self._viewing)
            .metrics(MetricConfig.perceptual())
            .quality_levels(self._quality_levels)
            .build()
        )
        session = EvalSession(config, device=self.device)
        session.add_codec_with_decode(
            self.codec_id, self.codec_version, self._encode, self._decode
        )
        self._register_comparison_codecs(session)

        corpus_report = CorpusReport(name="compare")
        for corpus_image in corpus.images[:count]:
            path = corpus_image.full_path(corpus.root_path)
            try:
                image = ImageData.open(path)
            except CodecEvalError:
                continue
            try:
                report = session.evaluate_image(corpus_image.name(), image)
            except CodecEvalError:
                continue
            corpus_report.images.append(report)

        rd_points = extract_rd_points(corpus_report, self._metric)
        pareto = ParetoFront.compute(rd_points)
        bd_rates = self._compute_bd_rates(corpus_report)

        ReportGenerator(self._output_dir, self._metric).generate(corpus_report)

        return CompareResult(
            subject_codec=self.codec_id,
            corpus_report=corpus_report,
            pareto=pareto,
            bd_rates=bd_rates,
            output_dir=self._output_dir,
        )

    def _register_comparison_codecs(self, session: EvalSession) -> None:
        """Format-filtered comparison set.
        reference: crates/codec-compare/src/compare.rs:365-430."""
        same_fmt = {
            "jpeg": JpegCodec.all_variants(),
            "jpg": JpegCodec.all_variants(),
            "webp": [WebPCodec()],
            "avif": AvifCodec.presets(),
        }
        fmt = (self._format or "").lower()
        for family, codecs in same_fmt.items():
            is_same = fmt in (family,)
            include = (
                (is_same and self._include_same_format)
                or (not is_same and self._include_other_formats)
            )
            if family == "jpg":  # alias of jpeg
                continue
            if not include:
                continue
            for codec in codecs:
                if codec.id() == self.codec_id or not codec.is_available():
                    continue
                session.add_codec_with_decode(
                    codec.id(), codec.version(), codec.encode_fn(), codec.decode_fn()
                )

    def _compute_bd_rates(self, report: CorpusReport) -> Dict[str, float]:
        """Per-codec BD-rate vs the subject's per-quality mean curve."""
        metric = self._metric

        by_codec: Dict[str, Dict[float, List[tuple]]] = {}
        for img in report.images:
            for r in img.results:
                v = metric.extract(r.metrics)
                if v is None:
                    continue
                q = -v if metric.lower_is_better else v
                by_codec.setdefault(r.codec_id, {}).setdefault(
                    r.quality, []
                ).append((r.bits_per_pixel, q))

        def curve(codec: str) -> List[tuple]:
            by_q = by_codec.get(codec, {})
            return [
                (mean([s[0] for s in by_q[q]]), mean([s[1] for s in by_q[q]]))
                for q in sorted(by_q)
            ]

        subject_curve = curve(self.codec_id)
        rates: Dict[str, float] = {}
        for codec in by_codec:
            if codec == self.codec_id:
                continue
            bd = bd_rate(curve(codec), subject_curve)
            if bd is not None:
                # Negative = subject needs fewer bits than `codec`.
                rates[codec] = bd
        return rates
