"""Metrics prelude: one import point for consumer projects.

Port of ``codec_eval_tpu/metrics/prelude.py`` (reference:
src/metrics/prelude.rs:34-117): the metric entry points, config types and
kernel-level primitives, so downstream projects do not import from internal
module paths.  Every function takes tensors on the device it should run on.
"""

# Metric entry points.
from ..kernels.butteraugli import (  # noqa: F401
    ButteraugliParams,
    butteraugli,
    butteraugli_distmap,
    butteraugli_pnorm,
)
from ..kernels.color import (  # noqa: F401
    linear_rgb_to_xyb,
    linear_to_srgb,
    srgb_to_linear,
    srgb_u8_to_linear,
    xyb_roundtrip,
    xyb_to_linear_rgb,
)
from ..kernels.dssim import dssim, dssim_u8  # noqa: F401
from ..kernels.psnr import psnr  # noqa: F401
from ..kernels.ssimulacra2 import (  # noqa: F401
    Ssimulacra2Reference,
    precompute_reference,
    ssimulacra2,
    ssimulacra2_batch,
)

# Config / result / level types.
from . import MetricConfig, MetricResult, PerceptionLevel  # noqa: F401

# Host-side color management.
from ..color import ColorProfile, prepare_for_comparison, transform_to_srgb  # noqa: F401

__all__ = [
    "ButteraugliParams",
    "butteraugli",
    "butteraugli_distmap",
    "butteraugli_pnorm",
    "linear_rgb_to_xyb",
    "linear_to_srgb",
    "srgb_to_linear",
    "srgb_u8_to_linear",
    "xyb_roundtrip",
    "xyb_to_linear_rgb",
    "dssim",
    "dssim_u8",
    "psnr",
    "Ssimulacra2Reference",
    "precompute_reference",
    "ssimulacra2",
    "ssimulacra2_batch",
    "MetricConfig",
    "MetricResult",
    "PerceptionLevel",
    "ColorProfile",
    "prepare_for_comparison",
    "transform_to_srgb",
]
