"""sRGB <-> linear light and XYB: a frozen copy of the parts of
``codec_eval_tpu_torch/kernels/color.py`` (commit 80b80d3) that the metrics
use.  Plain PyTorch; the 3x3 mixes are elementwise multiply-adds, never a
matmul, so they stay in the input's precision on every device."""

from __future__ import annotations

import numpy as np
import torch

OPSIN_ABSORBANCE_MATRIX = np.array(
    [
        [0.30, 0.622, 0.078],
        [0.23, 0.692, 0.078],
        [0.24342268924547819, 0.20476744424496821, 0.5518098665095536],
    ],
    dtype=np.float32,
)
OPSIN_ABSORBANCE_BIAS = float(np.float32(0.0037930732552754493))
NEG_OPSIN_ABSORBANCE_BIAS_CBRT = float(np.float32(-0.15595412))
_ONE_THIRD_F32 = float(np.float32(1.0 / 3.0))


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as a true division (``float / Tensor`` would multiply by
    the reciprocal and round twice)."""
    return torch.full_like(t, num) / t


def cbrt(v: torch.Tensor) -> torch.Tensor:
    """Signed cube root: |v| ** f32(1/3) taken in f64 and rounded once."""
    mag = torch.abs(v).to(torch.float64).pow(_ONE_THIRD_F32).to(v.dtype)
    return torch.sign(v) * mag


def srgb_to_linear(v: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """sRGB [0,1] -> linear light."""
    v = v.to(dtype)
    return torch.where(
        v <= 0.04045,
        v / 12.92,
        torch.clamp((v + 0.055) / 1.055, min=0.0).pow(2.4),
    )


def srgb_u8_to_linear(v: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """u8 sRGB -> linear light in ``dtype``."""
    return srgb_to_linear(v.to(dtype) / 255.0, dtype)


def linear_rgb_to_xyb(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB (..., 3) -> XYB (..., 3)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    m = OPSIN_ABSORBANCE_MATRIX
    bias = OPSIN_ABSORBANCE_BIAS
    opsin = [
        float(m[i, 0]) * r + float(m[i, 1]) * g + float(m[i, 2]) * b + bias
        for i in range(3)
    ]
    cr, cg, cb = (cbrt(o) + NEG_OPSIN_ABSORBANCE_BIAS_CBRT for o in opsin)
    return torch.stack([0.5 * (cr - cg), 0.5 * (cr + cg), cb], dim=-1)
