"""codec-iter: the encoder-iteration layer (eval loop, sources, codecs,
baselines, sweeps).

Port of ``codec_eval_tpu/iter``.
"""

from .baseline import (
    Baseline,
    ComparisonRow,
    compare_with_baseline,
    load_baseline,
    make_baseline,
    save_baseline,
)
from .codecs import (
    AVIF_PRESETS,
    AvifIterConfig,
    JpegIterConfig,
    TpuJpegIterConfig,
    WebpIterConfig,
    build_codec,
)
from .eval import Codec, EvalPoint, EvalResult, SourceImage, run_eval
from .source import MEDIUM, SMALL, TINY, load_image, load_sources
from .sweep import SweepResult, print_sweep, run_sweep

__all__ = [
    "AVIF_PRESETS",
    "AvifIterConfig",
    "Baseline",
    "Codec",
    "ComparisonRow",
    "EvalPoint",
    "EvalResult",
    "JpegIterConfig",
    "MEDIUM",
    "SMALL",
    "SourceImage",
    "SweepResult",
    "TINY",
    "TpuJpegIterConfig",
    "WebpIterConfig",
    "build_codec",
    "compare_with_baseline",
    "load_baseline",
    "load_image",
    "load_sources",
    "make_baseline",
    "print_sweep",
    "run_eval",
    "run_sweep",
    "save_baseline",
]
