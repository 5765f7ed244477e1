"""Self-contained HTML comparison report.

A copy of ``codec_eval_tpu/codecs/html_report.py``: one ``report.html``
with the R-D charts inline, the per-codec statistics and BD-rate table,
perception badges and a per-image drilldown, every string escaped.
"""

from __future__ import annotations

import html
from typing import Dict, List, Optional, Sequence

from ..engine.report import CorpusReport
from ..stats.chart import ChartConfig, ChartSeries, generate_svg
from ..stats.pareto import ParetoFront
from .base import codec_color
from .report import (
    ComparisonStats,
    Metric,
    compute_statistics,
    extract_rd_points,
    per_quality_series,
)

#: Badge colors per perception level (AA-contrast white text on all five).
_LEVEL_COLORS = {
    "Imperceptible": "#1a7a4a",
    "Marginal": "#3a7bd5",
    "Subtle": "#8a6d1a",
    "Noticeable": "#c05621",
    "Degraded": "#b03030",
}

_CSS = """
:root { color-scheme: light dark;
  --bg: #ffffff; --fg: #1d2129; --muted: #5f6672; --line: #e3e6ea;
  --card: #f6f7f9; --accent: #3a7bd5; }
@media (prefers-color-scheme: dark) { :root {
  --bg: #15181d; --fg: #e8eaed; --muted: #9aa2ad; --line: #30353d;
  --card: #1d2127; --accent: #6ea8fe; } }
* { box-sizing: border-box; }
body { margin: 0 auto; max-width: 70rem; padding: 1.5rem 1.25rem 4rem;
  background: var(--bg); color: var(--fg);
  font: 15px/1.5 system-ui, -apple-system, "Segoe UI", sans-serif; }
h1 { font-size: 1.45rem; margin: 0 0 .25rem; }
h2 { font-size: 1.15rem; margin: 2.2rem 0 .6rem; }
h3 { font-size: .95rem; margin: 1.4rem 0 .4rem; color: var(--muted);
  text-transform: uppercase; letter-spacing: .04em; }
.meta { color: var(--muted); margin-bottom: 1rem; }
.tiles { display: flex; flex-wrap: wrap; gap: .75rem; margin: 1rem 0; }
.tile { background: var(--card); border: 1px solid var(--line);
  border-radius: 8px; padding: .6rem 1rem; min-width: 7.5rem; }
.tile .v { font-size: 1.35rem; font-weight: 600;
  font-variant-numeric: tabular-nums; }
.tile .k { color: var(--muted); font-size: .8rem; }
table { border-collapse: collapse; width: 100%; margin: .5rem 0 1rem;
  font-variant-numeric: tabular-nums; }
th, td { padding: .3rem .6rem; border-bottom: 1px solid var(--line);
  text-align: right; white-space: nowrap; }
th { color: var(--muted); font-weight: 600; font-size: .8rem; }
th:first-child, td:first-child { text-align: left; }
tr.baseline td { font-weight: 600; }
.chart { margin: .75rem 0; }
.chart svg { max-width: 100%; height: auto; }
.badge { display: inline-block; padding: 0 .45em; border-radius: 4px;
  color: #fff; font-size: .75rem; font-weight: 600; line-height: 1.5; }
.swatch { display: inline-block; width: .7em; height: .7em;
  border-radius: 2px; margin-right: .4em; vertical-align: baseline; }
details { margin: .4rem 0; }
summary { cursor: pointer; color: var(--accent); }
footer { margin-top: 3rem; color: var(--muted); font-size: .8rem; }
"""


def _esc(s: object) -> str:
    return html.escape(str(s), quote=True)


def _fmt(v: Optional[float], nd: int = 3) -> str:
    if v is None:
        return "–"
    return f"{v:.{nd}f}"


def _level_badge(perception) -> str:
    if perception is None:
        return "–"
    color = _LEVEL_COLORS.get(perception.value, "#5f6672")
    return (f'<span class="badge" style="background:{color}">'
            f"{_esc(perception.code())}</span>")


def _codec_cell(codec_id: str) -> str:
    return (f'<span class="swatch" style="background:'
            f"{codec_color(codec_id)}\"></span>{_esc(codec_id)}")


def _metrics_with_data(report: CorpusReport) -> List[Metric]:
    present = []
    for metric in Metric:
        if any(
            metric.extract(r.metrics) is not None
            for img in report.images
            for r in img.results
        ):
            present.append(metric)
    return present


def _stats_table(stats: ComparisonStats) -> str:
    rows = []
    for c in stats.codecs:
        if c.codec_id == stats.baseline_codec:
            bd = "baseline"
        elif c.bd_rate_vs_baseline is None:
            bd = "n/a"
        else:
            bd = f"{c.bd_rate_vs_baseline:+.1f}%"
        cls = ' class="baseline"' if c.codec_id == stats.baseline_codec else ""
        rows.append(
            f"<tr{cls}><td>{_codec_cell(c.codec_id)}</td>"
            f"<td>{c.result_count}</td><td>{c.avg_bpp:.3f}</td>"
            f"<td>{c.avg_metric:.4f}</td><td>{c.avg_encode_ms:.1f}</td>"
            f"<td>{bd}</td></tr>"
        )
    return (
        "<table><thead><tr><th>codec</th><th>results</th><th>avg bpp</th>"
        f"<th>avg {_esc(stats.metric.value)}</th><th>enc ms</th>"
        "<th>BD-rate</th></tr></thead><tbody>"
        + "".join(rows)
        + "</tbody></table>"
    )


def _pareto_table(front: ParetoFront, metric: Metric, limit: int = 40) -> str:
    pts = sorted(front.points, key=lambda p: p.bpp)
    rows = []
    for p in pts[:limit]:
        value = -p.quality if metric.lower_is_better else p.quality
        img = f"<td>{_esc(p.image)}</td>" if p.image else "<td>–</td>"
        rows.append(
            f"<tr><td>{_codec_cell(p.codec)}</td><td>{p.quality_setting:g}</td>"
            f"<td>{p.bpp:.3f}</td><td>{value:.4f}</td>{img}</tr>"
        )
    more = (
        f'<p class="meta">{len(pts) - limit} more points omitted.</p>'
        if len(pts) > limit
        else ""
    )
    return (
        "<table><thead><tr><th>codec</th><th>q</th><th>bpp</th>"
        f"<th>{_esc(metric.value)}</th><th>image</th></tr></thead><tbody>"
        + "".join(rows)
        + "</tbody></table>"
        + more
    )


def _image_section(report: CorpusReport) -> str:
    blocks = []
    for img in report.images:
        rows = []
        for r in img.results:
            m = r.metrics
            rows.append(
                f"<tr><td>{_codec_cell(r.codec_id)}</td><td>{r.quality:g}</td>"
                f"<td>{r.file_size}</td><td>{r.bits_per_pixel:.3f}</td>"
                f"<td>{r.encode_time_ms}</td>"
                f"<td>{_fmt(m.ssimulacra2, 2)}</td><td>{_fmt(m.dssim, 6)}</td>"
                f"<td>{_fmt(m.butteraugli, 2)}</td><td>{_fmt(m.psnr, 2)}</td>"
                f"<td>{_level_badge(r.perception)}</td></tr>"
            )
        blocks.append(
            f"<details><summary>{_esc(img.name)} "
            f"({img.width}×{img.height}, {len(img.results)} results)</summary>"
            "<table><thead><tr><th>codec</th><th>q</th><th>bytes</th>"
            "<th>bpp</th><th>enc ms</th><th>ssim2</th><th>dssim</th>"
            "<th>ba</th><th>psnr</th><th>level</th></tr></thead><tbody>"
            + "".join(rows)
            + "</tbody></table></details>"
        )
    return "".join(blocks)


def _metric_chart(report: CorpusReport, metric: Metric) -> str:
    series = [
        ChartSeries(name=codec, color=codec_color(codec), points=pts)
        for codec, pts in sorted(per_quality_series(report, metric).items())
    ]
    label = metric.value.upper()
    config = (
        ChartConfig.new(f"Rate-Distortion: {label}")
        .with_y_label(f"← {label}" if metric.lower_is_better else f"{label} →")
        .with_lower_is_better(metric.lower_is_better)
    )
    return generate_svg(series, config) or ""


def generate_html(
    report: CorpusReport, metrics: Optional[Sequence[Metric]] = None
) -> str:
    """Render a corpus report as one self-contained HTML document.

    ``metrics`` defaults to every metric that has at least one value in the
    report; metrics with no data are omitted entirely.
    """
    if metrics is None:
        metrics = _metrics_with_data(report)

    qualities = sorted(
        {r.quality for img in report.images for r in img.results}
    )
    tiles = [
        (len(report.images), "images"),
        (len(report.codec_ids()), "codecs"),
        (report.total_results(), "results"),
        (len(qualities), "quality levels"),
    ]
    tiles_html = "".join(
        f'<div class="tile"><div class="v">{v}</div>'
        f'<div class="k">{k}</div></div>'
        for v, k in tiles
    )

    sections = []
    for metric in metrics:
        rd_points = extract_rd_points(report, metric)
        if not rd_points:
            continue
        front = ParetoFront.compute(rd_points)
        stats = compute_statistics(report, metric)
        sections.append(
            f"<h2>{_esc(metric.value.upper())}</h2>"
            f'<div class="chart">{_metric_chart(report, metric)}</div>'
            "<h3>Per-codec statistics</h3>" + _stats_table(stats)
            + f"<h3>Pareto front ({len(front.points)} points)</h3>"
            + _pareto_table(front, metric)
        )

    config_line = (
        f'<div class="meta">{_esc(report.config_summary)}</div>'
        if report.config_summary
        else ""
    )
    return (
        "<!DOCTYPE html>\n"
        '<html lang="en"><head><meta charset="utf-8">'
        '<meta name="viewport" content="width=device-width, initial-scale=1">'
        f"<title>{_esc(report.name)} — codec comparison</title>"
        f"<style>{_CSS}</style></head><body>"
        f"<h1>{_esc(report.name)}</h1>"
        f'<div class="meta">generated {_esc(report.timestamp)}</div>'
        f"{config_line}"
        f'<div class="tiles">{tiles_html}</div>'
        + "".join(sections)
        + "<h2>Per-image results</h2>"
        + _image_section(report)
        + "<footer>codec-eval-tpu comparison report</footer>"
        "</body></html>\n"
    )
