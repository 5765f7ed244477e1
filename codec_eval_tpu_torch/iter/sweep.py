"""Config sweep: run several codec configs and rank by average SSIM2.

Port of ``codec_eval_tpu/iter/sweep.py`` (reference:
crates/codec-iter/src/sweep.rs:13-65); host code over ``run_eval``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .eval import Codec, EvalResult, SourceImage, run_eval


@dataclass
class SweepResult:
    configs: Dict[str, EvalResult] = field(default_factory=dict)

    def ranked(self) -> List[Tuple[str, float, float, int]]:
        """(name, avg_bpp, avg_ssim2, total_ms) sorted by avg SSIM2 desc."""
        rows = []
        for name, result in self.configs.items():
            n = len(result.points)
            if n == 0:
                continue
            avg_bpp = sum(p.bpp for p in result.points) / n
            avg_ssim2 = sum(p.ssim2 for p in result.points) / n
            rows.append((name, avg_bpp, avg_ssim2, result.total_ms))
        rows.sort(key=lambda r: -r[2])
        return rows


def run_sweep(
    images: Sequence[SourceImage],
    codecs: Sequence[Codec],
    qualities: Sequence[int],
    progress=None,
    *,
    device="cuda",
) -> SweepResult:
    result = SweepResult()
    for codec in codecs:
        result.configs[codec.summary] = run_eval(
            images, codec, qualities, progress, device=device
        )
    return result


def print_sweep(result: SweepResult) -> None:
    """Ranked table, best marked '*'.  reference: sweep.rs:33-65."""
    rows = result.ranked()
    print(f"\nSweep over {len(rows)} configs")
    print(f"  {'Config':<40} {'Avg BPP':>8} {'Avg SSIM2':>10} {'Time':>8}")
    print("  " + "-" * 70)
    for i, (name, avg_bpp, avg_ssim2, ms) in enumerate(rows):
        marker = " *" if i == 0 else ""
        print(f"  {name:<40} {avg_bpp:>8.3f} {avg_ssim2:>10.1f} {ms:>6}ms{marker}")
    print("\n  * = best avg SSIM2")
