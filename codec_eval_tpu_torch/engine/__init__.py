"""Evaluation engine: images, reports, the batch scorer and the session."""

from .image import ImageData
from .report import CodecResult, ImageReport, write_json
from .scoring import BatchScorer
from .session import EncodeRequest, EvalConfig, EvalConfigBuilder, EvalSession

__all__ = [
    "BatchScorer",
    "CodecResult",
    "EncodeRequest",
    "EvalConfig",
    "EvalConfigBuilder",
    "EvalSession",
    "ImageData",
    "ImageReport",
    "write_json",
]
