"""Metric kernels on tensors: plain PyTorch, with the hand-written CUDA
kernels under ``cuda/``."""

from .color import (
    linear_rgb_to_xyb,
    linear_to_srgb,
    srgb_to_linear,
    srgb_u8_to_linear,
    xyb_roundtrip,
    xyb_to_linear_rgb,
)
from .masked import (
    butteraugli_masked,
    dssim_masked,
    pad_to_bucket,
    psnr_masked,
    score_mixed_sizes,
    score_mixed_sizes_all,
    ssimulacra2_masked,
    ssimulacra2_masked_batch,
)
from .psnr import psnr
from .ssimulacra2 import (
    Ssimulacra2Reference,
    precompute_reference,
    ssimulacra2,
    ssimulacra2_batch,
)

__all__ = [
    "linear_rgb_to_xyb",
    "linear_to_srgb",
    "srgb_to_linear",
    "srgb_u8_to_linear",
    "xyb_roundtrip",
    "xyb_to_linear_rgb",
    "butteraugli_masked",
    "dssim_masked",
    "pad_to_bucket",
    "psnr_masked",
    "score_mixed_sizes",
    "score_mixed_sizes_all",
    "ssimulacra2_masked",
    "ssimulacra2_masked_batch",
    "psnr",
    "Ssimulacra2Reference",
    "precompute_reference",
    "ssimulacra2",
    "ssimulacra2_batch",
]
