"""Quality/size regression baselines for codec-iter.

A copy of ``codec_eval_tpu/iter/baseline.py`` (host code; reference:
crates/codec-iter/src/baseline.rs:11-104): JSON baselines at
``baselines/<format>.json`` (schema-compatible with the reference's
committed baselines so they can replay as regression fixtures),
per-quality aggregation, and the delta table with the scalar pareto score
``delta_ssim2 - 10 * delta_bpp``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .eval import EvalPoint


@dataclass
class Baseline:
    format: str
    config_summary: str
    corpus_path: str
    created_at: str
    points: List[EvalPoint] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "format": self.format,
            "config_summary": self.config_summary,
            "corpus_path": self.corpus_path,
            "created_at": self.created_at,
            "points": [p.to_json() for p in self.points],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Baseline":
        return cls(
            format=d["format"],
            config_summary=d.get("config_summary", ""),
            corpus_path=d.get("corpus_path", ""),
            created_at=d.get("created_at", ""),
            points=[EvalPoint.from_json(p) for p in d.get("points", [])],
        )


def baseline_path(baselines_dir: Path, fmt: str) -> Path:
    return Path(baselines_dir) / f"{fmt}.json"


def load_baseline(baselines_dir: Path, fmt: str) -> Optional[Baseline]:
    path = baseline_path(baselines_dir, fmt)
    if not path.exists():
        return None
    with open(path) as f:
        return Baseline.from_json(json.load(f))


def save_baseline(baselines_dir: Path, baseline: Baseline) -> Path:
    Path(baselines_dir).mkdir(parents=True, exist_ok=True)
    path = baseline_path(baselines_dir, baseline.format)
    with open(path, "w") as f:
        json.dump(baseline.to_json(), f, indent=2)
    return path


def make_baseline(
    fmt: str, config_summary: str, corpus_path: str, points: Sequence[EvalPoint]
) -> Baseline:
    return Baseline(
        format=fmt,
        config_summary=config_summary,
        corpus_path=str(corpus_path),
        created_at=datetime.now(timezone.utc).isoformat(),
        points=list(points),
    )


@dataclass
class ComparisonRow:
    """reference: crates/codec-iter/src/baseline.rs:45-52."""

    quality: int
    bpp: float
    ssim2: float
    delta_bpp: float
    delta_ssim2: float
    pareto: float


def _aggregate_by_quality(points: Sequence[EvalPoint]) -> Dict[int, Tuple[float, float]]:
    acc: Dict[int, Tuple[List[float], List[float]]] = {}
    for p in points:
        bpps, ssims = acc.setdefault(p.quality, ([], []))
        bpps.append(p.bpp)
        ssims.append(p.ssim2)
    return {
        q: (sum(b) / len(b), sum(s) / len(s)) for q, (b, s) in acc.items()
    }


def compare_with_baseline(
    points: Sequence[EvalPoint], baseline: Baseline
) -> List[ComparisonRow]:
    """Per-quality means vs baseline; pareto = dSSIM2 - 10*dBPP.
    reference: crates/codec-iter/src/baseline.rs:54-86."""
    current = _aggregate_by_quality(points)
    base = _aggregate_by_quality(baseline.points)
    rows = []
    for q in sorted(current):
        bpp, ssim2 = current[q]
        if q in base:
            delta_bpp = bpp - base[q][0]
            delta_ssim2 = ssim2 - base[q][1]
        else:
            delta_bpp = delta_ssim2 = 0.0
        rows.append(
            ComparisonRow(
                quality=q,
                bpp=bpp,
                ssim2=ssim2,
                delta_bpp=delta_bpp,
                delta_ssim2=delta_ssim2,
                pareto=delta_ssim2 - delta_bpp * 10.0,
            )
        )
    return rows
