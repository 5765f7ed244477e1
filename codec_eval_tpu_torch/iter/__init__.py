"""codec-iter: the encoder-iteration layer (eval loop, baselines, sweeps).

Port of ``codec_eval_tpu/iter`` without ``codecs.py`` and ``source.py``,
which need PIL and come with the command-line tools.
"""

from .baseline import (
    Baseline,
    ComparisonRow,
    compare_with_baseline,
    load_baseline,
    make_baseline,
    save_baseline,
)
from .eval import Codec, EvalPoint, EvalResult, SourceImage, run_eval
from .sweep import SweepResult, print_sweep, run_sweep

__all__ = [
    "Baseline",
    "Codec",
    "ComparisonRow",
    "EvalPoint",
    "EvalResult",
    "SourceImage",
    "SweepResult",
    "compare_with_baseline",
    "load_baseline",
    "make_baseline",
    "print_sweep",
    "run_eval",
    "run_sweep",
    "save_baseline",
]
