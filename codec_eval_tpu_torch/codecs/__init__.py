"""Codec adapters and the comparison harness: a port of
``codec_eval_tpu/codecs``, with the device JPEG codec (``TpuJpegCodec``)
and device JPEG decoding (``decode_jpeg_device``, ``score_jpeg_files``)."""

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
from .jpeg_device import decode_jpeg_device, score_jpeg_files
from .tpujpeg import TpuJpegCodec
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
    "TpuJpegCodec",
    "decode_jpeg_device",
    "score_jpeg_files",
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
