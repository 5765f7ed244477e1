"""The error types the session, the scorer and the metrics raise, copied from
``codec_eval_tpu/errors.py`` (the port imports nothing from the JAX
package).  reference: src/error.rs:12-100."""

from __future__ import annotations


class CodecEvalError(Exception):
    """Base error for codec-eval-tpu and its PyTorch port."""


class ImageLoadError(CodecEvalError):
    pass


class CodecError(CodecEvalError):
    """An encode/decode callback failed."""

    def __init__(self, codec: str, reason: str):
        super().__init__(f"codec '{codec}': {reason}")
        self.codec = codec
        self.reason = reason


class DimensionMismatch(CodecEvalError):
    def __init__(self, expected, actual):
        super().__init__(f"dimension mismatch: expected {expected}, got {actual}")
        self.expected = expected
        self.actual = actual


class MetricCalculationError(CodecEvalError):
    def __init__(self, metric: str, reason: str):
        super().__init__(f"metric '{metric}': {reason}")
        self.metric = metric
        self.reason = reason


class InvalidQuality(CodecEvalError):
    def __init__(self, quality: float):
        super().__init__(f"invalid quality: {quality}")
        self.quality = quality


class UnsupportedFormat(CodecEvalError):
    pass
