"""Light/dark-adaptive SVG line+scatter charts for R-D analysis.

Host copy of ``codec_eval_tpu/stats/chart.py`` (the port imports
nothing from the JAX package).

Capability port of reference: src/stats/chart.rs:10-401 — series of
(x, y, label) points rendered with a CSS-media-query dark mode, padded
bounds, gridlines, a legend column on the right, and a ``lower_is_better``
y-axis flip for distance metrics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class ChartPoint:
    x: float
    y: float
    label: Optional[str] = None


@dataclass
class ChartSeries:
    name: str
    color: str
    points: List[ChartPoint] = field(default_factory=list)


@dataclass
class ChartConfig:
    title: str = "Quality vs Size"
    x_label: str = "Bits per Pixel (BPP) →"
    y_label: str = "Quality Score"
    lower_is_better: bool = False
    width: int = 700
    height: int = 450

    @classmethod
    def new(cls, title: str) -> "ChartConfig":
        return cls(title=title)

    def with_x_label(self, label: str) -> "ChartConfig":
        self.x_label = label
        return self

    def with_y_label(self, label: str) -> "ChartConfig":
        self.y_label = label
        return self

    def with_lower_is_better(self, flag: bool) -> "ChartConfig":
        self.lower_is_better = flag
        return self

    def with_dimensions(self, width: int, height: int) -> "ChartConfig":
        self.width = width
        self.height = height
        return self


_STYLE = """<style>
  :root {
    --bg: #ffffff; --text: #1a1a1a; --grid: #e0e0e0;
    --axis: #333333; --legend-bg: #ffffff; --legend-border: #cccccc;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      --bg: #16181d; --text: #e0e0e0; --grid: #33363d;
      --axis: #aaaaaa; --legend-bg: #1e2127; --legend-border: #44474f;
    }
  }
  .bg { fill: var(--bg); }
  .title { fill: var(--text); font: bold 16px sans-serif; }
  .label { fill: var(--text); font: 12px sans-serif; }
  .tick { fill: var(--text); font: 10px sans-serif; }
  .grid { stroke: var(--grid); stroke-width: 1; }
  .axis { stroke: var(--axis); stroke-width: 1.5; }
  .legend-box { fill: var(--legend-bg); stroke: var(--legend-border); }
</style>
"""


def _bounds(values: Sequence[float], pad: float = 0.05) -> Tuple[float, float]:
    lo, hi = min(values), max(values)
    if hi == lo:
        hi = lo + 1.0
    span = hi - lo
    return lo - span * pad, hi + span * pad


def _ticks(lo: float, hi: float, n: int = 6) -> List[float]:
    import math

    span = hi - lo
    raw = span / max(n - 1, 1)
    mag = 10 ** math.floor(math.log10(raw)) if raw > 0 else 1.0
    for mult in (1, 2, 2.5, 5, 10):
        step = mult * mag
        if span / step <= n:
            break
    first = math.ceil(lo / step) * step
    ticks = []
    v = first
    while v <= hi + 1e-9:
        ticks.append(round(v, 10))
        v += step
    return ticks


def generate_svg(series: Sequence[ChartSeries], config: ChartConfig) -> str:
    """Render the chart; returns "" for all-empty input (matching the
    reference's contract)."""
    non_empty = [s for s in series if s.points]
    if not non_empty:
        return ""

    xs = [p.x for s in non_empty for p in s.points]
    ys = [p.y for s in non_empty for p in s.points]
    min_x, max_x = _bounds(xs)
    min_y, max_y = _bounds(ys)

    w, h = config.width, config.height
    m_top, m_right, m_bottom, m_left = 50, 140, 70, 90
    pw, ph = w - m_left - m_right, h - m_top - m_bottom

    def sx(v: float) -> float:
        return m_left + (v - min_x) / (max_x - min_x) * pw

    def sy(v: float) -> float:
        frac = (v - min_y) / (max_y - min_y)
        if not config.lower_is_better:
            frac = 1.0 - frac
        return m_top + frac * ph

    out: List[str] = []
    out.append(
        f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {w} {h}">'
    )
    out.append(_STYLE)
    out.append(f'<rect class="bg" width="{w}" height="{h}"/>')
    out.append(
        f'<text class="title" x="{w / 2:.0f}" y="28" text-anchor="middle">'
        f"{_esc(config.title)}</text>"
    )

    # Grid + ticks.
    for tx in _ticks(min_x, max_x):
        px = sx(tx)
        out.append(
            f'<line class="grid" x1="{px:.1f}" y1="{m_top}" x2="{px:.1f}" '
            f'y2="{m_top + ph}"/>'
        )
        out.append(
            f'<text class="tick" x="{px:.1f}" y="{m_top + ph + 16}" '
            f'text-anchor="middle">{_fmt(tx)}</text>'
        )
    for ty in _ticks(min_y, max_y):
        py = sy(ty)
        out.append(
            f'<line class="grid" x1="{m_left}" y1="{py:.1f}" '
            f'x2="{m_left + pw}" y2="{py:.1f}"/>'
        )
        out.append(
            f'<text class="tick" x="{m_left - 8}" y="{py + 3:.1f}" '
            f'text-anchor="end">{_fmt(ty)}</text>'
        )

    # Axes.
    out.append(
        f'<line class="axis" x1="{m_left}" y1="{m_top + ph}" '
        f'x2="{m_left + pw}" y2="{m_top + ph}"/>'
    )
    out.append(
        f'<line class="axis" x1="{m_left}" y1="{m_top}" x2="{m_left}" '
        f'y2="{m_top + ph}"/>'
    )
    out.append(
        f'<text class="label" x="{m_left + pw / 2:.0f}" y="{h - 20}" '
        f'text-anchor="middle">{_esc(config.x_label)}</text>'
    )
    out.append(
        f'<text class="label" x="24" y="{m_top + ph / 2:.0f}" '
        f'text-anchor="middle" transform="rotate(-90 24 {m_top + ph / 2:.0f})">'
        f"{_esc(config.y_label)}</text>"
    )

    # Series: polyline + markers.
    for s in non_empty:
        pts = sorted(s.points, key=lambda p: p.x)
        path = " ".join(f"{sx(p.x):.1f},{sy(p.y):.1f}" for p in pts)
        out.append(
            f'<polyline fill="none" stroke="{s.color}" stroke-width="2" '
            f'points="{path}"/>'
        )
        for p in pts:
            out.append(
                f'<circle cx="{sx(p.x):.1f}" cy="{sy(p.y):.1f}" r="3.5" '
                f'fill="{s.color}"><title>{_esc(s.name)}'
                f"{': ' + _esc(p.label) if p.label else ''}"
                f" ({_fmt(p.x)}, {_fmt(p.y)})</title></circle>"
            )

    # Legend column.
    lx = m_left + pw + 12
    out.append(
        f'<rect class="legend-box" x="{lx - 6}" y="{m_top}" width="{m_right - 16}" '
        f'height="{18 * len(non_empty) + 10}" rx="4"/>'
    )
    for i, s in enumerate(non_empty):
        ly = m_top + 14 + i * 18
        out.append(
            f'<line x1="{lx}" y1="{ly}" x2="{lx + 16}" y2="{ly}" '
            f'stroke="{s.color}" stroke-width="3"/>'
        )
        out.append(
            f'<text class="tick" x="{lx + 22}" y="{ly + 3}">{_esc(s.name)}</text>'
        )

    out.append("</svg>")
    return "\n".join(out)


def _esc(s: str) -> str:
    return (
        s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    )


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e6:
        return str(int(v))
    return f"{v:.3g}"


__all__ = ["ChartPoint", "ChartSeries", "ChartConfig", "generate_svg"]
