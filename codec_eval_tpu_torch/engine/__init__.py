"""Evaluation engine: images, reports, the batch scorer and the session."""

from .helpers import assert_perception_level, assert_quality, evaluate_single
from .image import ImageData
from .report import CodecResult, CorpusReport, ImageReport, write_json
from .scoring import BatchScorer
from .session import (
    DEFAULT_QUALITY_LEVELS,
    EncodeRequest,
    EvalConfig,
    EvalConfigBuilder,
    EvalSession,
)
from .tpu_sweep import TpuSweepPoint, encode_to_target, evaluate_tpujpeg_sweep

__all__ = [
    "assert_perception_level",
    "assert_quality",
    "evaluate_single",
    "BatchScorer",
    "CodecResult",
    "CorpusReport",
    "DEFAULT_QUALITY_LEVELS",
    "EncodeRequest",
    "EvalConfig",
    "EvalConfigBuilder",
    "EvalSession",
    "ImageData",
    "ImageReport",
    "TpuSweepPoint",
    "encode_to_target",
    "evaluate_tpujpeg_sweep",
    "write_json",
]
