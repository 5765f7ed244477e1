"""PSNR.  Port of ``codec_eval_tpu/kernels/psnr.py`` (reference:
src/metrics/mod.rs:312-331)."""

from __future__ import annotations

import math

import torch


def psnr(reference_u8: torch.Tensor, test_u8: torch.Tensor) -> torch.Tensor:
    """PSNR in dB over u8 buffers; the last three axes are one image, so a
    (N, 3, H, W) batch against a (3, H, W) reference gives N values.

    Returns +inf for identical images, matching the reference.
    """
    diff = reference_u8.to(torch.float32) - test_u8.to(torch.float32)
    mse = (diff * diff).mean(dim=(-3, -2, -1))
    return torch.where(
        mse == 0.0,
        torch.full_like(mse, math.inf),
        10.0 * torch.log10(255.0 * 255.0 / torch.clamp(mse, min=1e-30)),
    )
