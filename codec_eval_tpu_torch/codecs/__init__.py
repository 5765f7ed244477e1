"""Codec adapters and the comparison harness: a port of
``codec_eval_tpu/codecs`` without its device JPEG codec (``TpuJpegCodec``,
``decode_jpeg_device``, ``score_jpeg_files``), which waits for the device
JPEG ladder's port."""

from .base import STANDARD_QUALITY_LEVELS, CodecImpl, codec_color
from .compare import CompareAgainstAll, CompareResult
from .pil_codecs import (
    AvifCodec,
    JpegCodec,
    PngCodec,
    UnavailableCodec,
    WebPCodec,
    jpegli_stub,
    jpegxl_stub,
)
from .jxl import JpegXlCodec
from .registry import CodecRegistry, CompareConfig, FormatSelection
from .html_report import generate_html
from .report import (
    CodecStats,
    ComparisonStats,
    Metric,
    ReportGenerator,
    compute_statistics,
    extract_rd_points,
    per_quality_series,
)

__all__ = [
    "STANDARD_QUALITY_LEVELS",
    "CodecImpl",
    "codec_color",
    "CompareAgainstAll",
    "CompareResult",
    "AvifCodec",
    "JpegCodec",
    "PngCodec",
    "UnavailableCodec",
    "WebPCodec",
    "jpegli_stub",
    "jpegxl_stub",
    "JpegXlCodec",
    "CodecRegistry",
    "CompareConfig",
    "FormatSelection",
    "CodecStats",
    "ComparisonStats",
    "Metric",
    "ReportGenerator",
    "compute_statistics",
    "extract_rd_points",
    "generate_html",
    "per_quality_series",
]
