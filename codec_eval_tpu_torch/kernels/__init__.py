"""Metric kernels on tensors: plain PyTorch, with the hand-written CUDA
kernels under ``cuda/``."""

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

__all__ = [
    "butteraugli_masked",
    "dssim_masked",
    "pad_to_bucket",
    "psnr_masked",
    "score_mixed_sizes",
    "score_mixed_sizes_all",
    "ssimulacra2_masked",
    "ssimulacra2_masked_batch",
]
