"""The typed error hierarchy, copied from
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


class CorpusError(CodecEvalError):
    pass


class CsvImportError(CodecEvalError):
    pass


class InvalidQuality(CodecEvalError):
    def __init__(self, quality: float):
        super().__init__(f"invalid quality: {quality}")
        self.quality = quality


class QualityBelowThreshold(CodecEvalError):
    """A quality assertion failed (the CI-gate error).
    reference: src/error.rs + src/eval/helpers.rs:230-253."""

    def __init__(self, metric: str, value: float, threshold: float):
        super().__init__(
            f"{metric} quality below threshold: {value} vs required {threshold}"
        )
        self.metric = metric
        self.value = value
        self.threshold = threshold


class UnsupportedFormat(CodecEvalError):
    pass


class ReportError(CodecEvalError):
    pass


class CacheError(CodecEvalError):
    pass
