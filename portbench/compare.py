"""The comparison that decides ``correct``: each metric's widest relative
gap between the scores the program produced and the reference's scores of
the same pairs.

The gap of one score is |program - reference| / max(|reference|, floor).
The floor keeps a score near 0 (a DSSIM of an almost lossless candidate)
from turning rounding into a large share; each floor is far below the
scores the ladders produce.  Two infinite PSNRs (identical pixels) agree;
an infinite or NaN gap fails every limit."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

from .harness import Check

FLOORS = {"ssimulacra2": 1.0, "dssim": 1e-4, "butteraugli": 0.1, "psnr": 1.0}


def gap(metric: str, program: float, reference: float) -> float:
    if program is None or reference is None:
        return math.inf
    if math.isinf(program) or math.isinf(reference):
        return 0.0 if program == reference else math.inf
    if math.isnan(program) or math.isnan(reference):
        return math.inf
    return abs(program - reference) / max(abs(reference), FLOORS[metric])


def widest(pairs: Iterable[Tuple[str, float, float]]) -> Dict[str, float]:
    """{metric: widest gap} over (metric, program, reference) triples."""
    out: Dict[str, float] = {}
    for metric, p, r in pairs:
        out[metric] = max(out.get(metric, 0.0), gap(metric, p, r))
    return out


def checks(widest_gaps: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    """One check per metric: ``<metric>_gap`` against the cell's limit."""
    return [Check(f"{m}_gap", v, float(limits[m])) for m, v in sorted(widest_gaps.items())]
