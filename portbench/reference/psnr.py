"""PSNR: a frozen copy of ``codec_eval_tpu_torch/kernels/psnr.py``
(commit 80b80d3), with the compute precision a parameter."""

from __future__ import annotations

import math

import torch


def psnr(reference_u8: torch.Tensor, test_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """PSNR in dB over u8 buffers; the last three axes are one image.
    +inf for identical images."""
    diff = reference_u8.to(dtype) - test_u8.to(dtype)
    mse = (diff * diff).mean(dim=(-3, -2, -1))
    return torch.where(
        mse == 0.0,
        torch.full_like(mse, math.inf),
        10.0 * torch.log10(255.0 * 255.0 / torch.clamp(mse, min=1e-30)),
    ).to(torch.float32)
