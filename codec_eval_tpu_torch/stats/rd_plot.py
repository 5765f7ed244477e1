"""Dark-theme R-D plot with fixed-frame angle grid and knee markers.

Host copy of ``codec_eval_tpu/stats/rd_plot.py`` (the port imports
nothing from the JAX package).

Capability port of reference: src/stats/rd_knee.rs:761-980 (plot_rd_svg) —
plots a corpus-aggregate (bpp, s2) curve inside the fixed frame, with angle
reference lines radiating from the worst corner (bpp_max, quality 0) and
markers at the detected knees.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from .rd_knee import FixedFrame, RDCalibration

_W, _H = 760, 520
_M = dict(top=46, right=30, bottom=56, left=64)


def plot_rd_svg(
    curve: Sequence[Tuple[float, float, float]],
    frame: FixedFrame,
    calibration: Optional[RDCalibration] = None,
    title: str = "Rate-Distortion (SSIMULACRA2)",
    angle_step_deg: float = 15.0,
) -> str:
    """Render the aggregate curve (bpp, mean_s2, mean_ba) as dark-theme SVG."""
    pw = _W - _M["left"] - _M["right"]
    ph = _H - _M["top"] - _M["bottom"]

    def sx(bpp: float) -> float:
        return _M["left"] + (bpp / frame.bpp_max) * pw

    def sy(s2: float) -> float:
        return _M["top"] + (1.0 - s2 / frame.s2_max) * ph

    out: List[str] = []
    out.append(f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {_W} {_H}">')
    out.append(
        "<style>"
        ".bg{fill:#14161b}.txt{fill:#d7dae0;font:12px monospace}"
        ".title{fill:#ffffff;font:bold 15px monospace}"
        ".grid{stroke:#2a2e37;stroke-width:1}"
        ".angle{stroke:#3a4150;stroke-width:1;stroke-dasharray:4 4}"
        ".anglelbl{fill:#8f98a8;font:10px monospace}"
        ".curve{stroke:#58a6ff;stroke-width:2.5;fill:none}"
        ".pt{fill:#58a6ff}"
        ".knee{fill:#f85149}.kneelbl{fill:#f85149;font:11px monospace}"
        "</style>"
    )
    out.append(f'<rect class="bg" width="{_W}" height="{_H}"/>')
    out.append(
        f'<text class="title" x="{_W / 2:.0f}" y="26" text-anchor="middle">{title}</text>'
    )

    # Cartesian grid.
    for i in range(5):
        bpp = frame.bpp_max * i / 4
        out.append(
            f'<line class="grid" x1="{sx(bpp):.1f}" y1="{_M["top"]}" '
            f'x2="{sx(bpp):.1f}" y2="{_M["top"] + ph}"/>'
        )
        out.append(
            f'<text class="txt" x="{sx(bpp):.1f}" y="{_M["top"] + ph + 18}" '
            f'text-anchor="middle">{bpp:g}</text>'
        )
    for i in range(5):
        s2 = frame.s2_max * i / 4
        out.append(
            f'<line class="grid" x1="{_M["left"]}" y1="{sy(s2):.1f}" '
            f'x2="{_M["left"] + pw}" y2="{sy(s2):.1f}"/>'
        )
        out.append(
            f'<text class="txt" x="{_M["left"] - 8}" y="{sy(s2) + 4:.1f}" '
            f'text-anchor="end">{s2:g}</text>'
        )
    out.append(
        f'<text class="txt" x="{_M["left"] + pw / 2:.0f}" y="{_H - 14}" '
        f'text-anchor="middle">bits per pixel</text>'
    )

    # Angle rays from the worst corner (bpp_max, 0).  A point at angle theta
    # satisfies tan(theta) = (s2_norm * aspect) / (1 - bpp_norm).
    cx, cy = sx(frame.bpp_max), sy(0.0)
    deg = angle_step_deg
    while deg < 90.0:
        t = math.tan(math.radians(deg))
        # Parametrize by bpp_norm from 1 -> 0.
        s2_norm_at0 = t * 1.0 / frame.aspect  # at bpp_norm = 0
        if s2_norm_at0 <= 1.0:
            x2, y2 = sx(0.0), sy(s2_norm_at0 * frame.s2_max)
        else:
            bpp_norm = 1.0 - frame.aspect / t
            x2, y2 = sx(bpp_norm * frame.bpp_max), sy(frame.s2_max)
        out.append(
            f'<line class="angle" x1="{cx:.1f}" y1="{cy:.1f}" '
            f'x2="{x2:.1f}" y2="{y2:.1f}"/>'
        )
        out.append(
            f'<text class="anglelbl" x="{x2 + 3:.1f}" y="{y2 - 3:.1f}">{deg:g}°</text>'
        )
        deg += angle_step_deg

    # Curve + points.
    pts = sorted(curve, key=lambda p: p[0])
    path = " ".join(f"{sx(b):.1f},{sy(s):.1f}" for b, s, _ in pts)
    out.append(f'<polyline class="curve" points="{path}"/>')
    for b, s, _ in pts:
        out.append(f'<circle class="pt" cx="{sx(b):.1f}" cy="{sy(s):.1f}" r="3"/>')

    # Knee markers.
    if calibration is not None:
        k = calibration.ssimulacra2
        out.append(
            f'<circle class="knee" cx="{sx(k.bpp):.1f}" cy="{sy(k.quality):.1f}" r="5"/>'
        )
        out.append(
            f'<text class="kneelbl" x="{sx(k.bpp) + 8:.1f}" y="{sy(k.quality) - 8:.1f}">'
            f"knee {k.bpp:.3f} bpp @ {k.quality:.1f} ({k.fixed_angle:.1f}°)</text>"
        )

    out.append("</svg>")
    return "\n".join(out)


__all__ = ["plot_rd_svg"]
