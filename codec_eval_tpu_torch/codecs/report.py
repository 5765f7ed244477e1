"""Comparison report generation: Pareto charts, statistics, BD-rate tables.

A copy of ``codec_eval_tpu/codecs/report.py`` (reference:
crates/codec-compare/src/report.rs:14-474): R-D points from a corpus report
(lower-is-better metrics negated), overall and per-format Pareto fronts,
SVG charts, per-codec statistics and BD-rate against a baseline, written as
SVG, JSON and a self-contained HTML report.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from ..engine.report import CorpusReport
from ..stats.chart import ChartConfig, ChartPoint, ChartSeries, generate_svg
from ..stats.pareto import ParetoFront, RDPoint
from ..stats.summary import bd_rate, mean
from .base import codec_color


class Metric(enum.Enum):
    """Primary metric for comparison charts.
    reference: crates/codec-compare/src/report.rs:23."""

    SSIMULACRA2 = "ssimulacra2"
    DSSIM = "dssim"
    BUTTERAUGLI = "butteraugli"
    PSNR = "psnr"

    @property
    def lower_is_better(self) -> bool:
        return self in (Metric.DSSIM, Metric.BUTTERAUGLI)

    def extract(self, metrics) -> Optional[float]:
        return getattr(metrics, self.value)


def extract_rd_points(report: CorpusReport, metric: Metric) -> List[RDPoint]:
    """CorpusReport -> RD points, negating lower-is-better metrics so the
    Pareto convention (higher quality = better) holds.
    reference: crates/codec-compare/src/report.rs:120-146."""
    points: List[RDPoint] = []
    for img in report.images:
        for r in img.results:
            value = metric.extract(r.metrics)
            if value is None:
                continue
            quality = -value if metric.lower_is_better else value
            points.append(
                RDPoint(
                    codec=r.codec_id,
                    quality_setting=r.quality,
                    bpp=r.bits_per_pixel,
                    quality=quality,
                    encode_time_ms=float(r.encode_time_ms),
                    image=img.name,
                )
            )
    return points


def per_quality_series(
    report: CorpusReport, metric: Metric
) -> Dict[str, List[ChartPoint]]:
    """Average (bpp, metric) per codec per quality level for chart lines.
    reference: crates/codec-compare/src/report.rs:149-199."""
    acc: Dict[str, Dict[float, List[tuple]]] = {}
    for img in report.images:
        for r in img.results:
            value = metric.extract(r.metrics)
            if value is None:
                continue
            acc.setdefault(r.codec_id, {}).setdefault(r.quality, []).append(
                (r.bits_per_pixel, value)
            )
    series: Dict[str, List[ChartPoint]] = {}
    for codec, by_q in acc.items():
        pts = []
        for q in sorted(by_q):
            samples = by_q[q]
            pts.append(
                ChartPoint(
                    x=mean([s[0] for s in samples]),
                    y=mean([s[1] for s in samples]),
                    label=f"q{q:g}",
                )
            )
        series[codec] = pts
    return series


@dataclass
class CodecStats:
    """Per-codec aggregate row.
    reference: crates/codec-compare/src/report.rs:286-374."""

    codec_id: str
    result_count: int
    avg_bpp: float
    avg_metric: float
    avg_encode_ms: float
    bd_rate_vs_baseline: Optional[float] = None


@dataclass
class ComparisonStats:
    metric: Metric
    baseline_codec: str
    codecs: List[CodecStats] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "metric": self.metric.value,
            "baseline_codec": self.baseline_codec,
            "codecs": [
                {
                    "codec_id": c.codec_id,
                    "result_count": c.result_count,
                    "avg_bpp": c.avg_bpp,
                    "avg_metric": c.avg_metric,
                    "avg_encode_ms": c.avg_encode_ms,
                    "bd_rate_vs_baseline": c.bd_rate_vs_baseline,
                }
                for c in self.codecs
            ],
        }


def compute_statistics(report: CorpusReport, metric: Metric) -> ComparisonStats:
    """Per-codec means + BD-rate against the alphabetically-first codec."""
    by_codec: Dict[str, List] = {}
    for img in report.images:
        for r in img.results:
            if metric.extract(r.metrics) is None:
                continue
            by_codec.setdefault(r.codec_id, []).append(r)
    if not by_codec:
        return ComparisonStats(metric=metric, baseline_codec="")

    baseline = sorted(by_codec)[0]

    def rd_curve(codec: str) -> List[tuple]:
        # Per-quality means: (bitrate=bpp, quality) with direction fixed.
        by_q: Dict[float, List[tuple]] = {}
        for r in by_codec[codec]:
            v = metric.extract(r.metrics)
            q = -v if metric.lower_is_better else v
            by_q.setdefault(r.quality, []).append((r.bits_per_pixel, q))
        return [
            (mean([s[0] for s in by_q[q]]), mean([s[1] for s in by_q[q]]))
            for q in sorted(by_q)
        ]

    base_curve = rd_curve(baseline)
    stats = ComparisonStats(metric=metric, baseline_codec=baseline)
    for codec in sorted(by_codec):
        results = by_codec[codec]
        bd = None
        if codec != baseline:
            bd = bd_rate(base_curve, rd_curve(codec))
        stats.codecs.append(
            CodecStats(
                codec_id=codec,
                result_count=len(results),
                avg_bpp=mean([r.bits_per_pixel for r in results]),
                avg_metric=mean([metric.extract(r.metrics) for r in results]),
                avg_encode_ms=mean([float(r.encode_time_ms) for r in results]),
                bd_rate_vs_baseline=bd,
            )
        )
    return stats


class ReportGenerator:
    """Writes pareto.svg, per-format pareto_<fmt>.svg, stats.json,
    pareto.json (reference: crates/codec-compare/src/report.rs:82-117),
    plus a self-contained report.html the reference leaves to consumers."""

    def __init__(self, output_dir, metric: Metric = Metric.SSIMULACRA2):
        self.output_dir = Path(output_dir)
        self.metric = metric

    def with_metric(self, metric: Metric) -> "ReportGenerator":
        self.metric = metric
        return self

    def generate(self, report: CorpusReport) -> dict:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        rd_points = extract_rd_points(report, self.metric)
        pareto = ParetoFront.compute(rd_points)

        # Overall chart from per-quality averaged series.
        series = [
            ChartSeries(name=codec, color=codec_color(codec), points=pts)
            for codec, pts in sorted(per_quality_series(report, self.metric).items())
        ]
        label = self.metric.value.upper()
        config = (
            ChartConfig.new(f"Rate-Distortion: {label}")
            .with_y_label(
                f"← {label}" if self.metric.lower_is_better else f"{label} →"
            )
            .with_lower_is_better(self.metric.lower_is_better)
        )
        svg = generate_svg(series, config)
        if svg:
            (self.output_dir / "pareto.svg").write_text(svg)

        # Per-format charts (codec family prefix up to first '-').
        formats: Dict[str, List[ChartSeries]] = {}
        for s in series:
            fam = s.name.split("-")[0]
            formats.setdefault(fam, []).append(s)
        for fam, fam_series in formats.items():
            if len(formats) <= 1:
                break
            fam_svg = generate_svg(
                fam_series, ChartConfig.new(f"R-D: {label} ({fam})").with_lower_is_better(
                    self.metric.lower_is_better
                )
            )
            if fam_svg:
                (self.output_dir / f"pareto_{fam}.svg").write_text(fam_svg)

        stats = compute_statistics(report, self.metric)
        with open(self.output_dir / "stats.json", "w") as f:
            json.dump(stats.to_json(), f, indent=2)
        with open(self.output_dir / "pareto.json", "w") as f:
            json.dump(pareto.to_json(), f, indent=2)

        from .html_report import generate_html

        (self.output_dir / "report.html").write_text(generate_html(report))

        return {"pareto": pareto, "stats": stats}

    @staticmethod
    def print_statistics(stats: ComparisonStats) -> None:
        """Console table.  reference: crates/codec-compare/src/report.rs:428-474."""
        print(f"\n{'codec':<26} {'n':>4} {'avg bpp':>8} "
              f"{'avg ' + stats.metric.value:>14} {'enc ms':>7} {'BD-rate':>9}")
        print("-" * 74)
        for c in stats.codecs:
            if c.codec_id == stats.baseline_codec:
                bd = "baseline"
            elif c.bd_rate_vs_baseline is None:
                bd = "n/a"  # needs >= 4 overlapping quality points
            else:
                bd = f"{c.bd_rate_vs_baseline:+8.1f}%"
            print(
                f"{c.codec_id:<26} {c.result_count:>4} {c.avg_bpp:>8.3f} "
                f"{c.avg_metric:>14.4f} {c.avg_encode_ms:>7.1f} {bd:>9}"
            )
