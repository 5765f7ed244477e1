"""Color-space math on tensors: sRGB <-> linear light and XYB opsin space.

Port of ``codec_eval_tpu/kernels/color.py`` (reference:
src/metrics/xyb.rs:33-253).  Functions take a trailing channel axis of size
3, like the JAX versions, so tests compare like with like.  The 3x3 mixes are
written as elementwise multiply-adds, never a matmul, so they stay in f32 on
every device.
"""

from __future__ import annotations

import numpy as np
import torch

# reference: src/metrics/xyb.rs:34-57, 185-190
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
INV_OPSIN_MATRIX = np.array(
    [
        [11.031566901960783, -9.866943921568629, -0.16462299647058826],
        [-3.254147380392157, 4.418770392156863, -0.16462299647058826],
        [-3.6588512862745097, 2.7129230470588235, 1.9459282392156863],
    ],
    dtype=np.float32,
)
XYB_RANGES = np.array([[-0.016, 0.029], [0.0, 0.846], [0.0, 0.846]], dtype=np.float32)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as a true division.  PyTorch evaluates ``float / Tensor``
    as ``t.reciprocal() * num``, which rounds twice and differs from JAX."""
    return torch.full_like(t, num) / t


_ONE_THIRD_F32 = float(np.float32(1.0 / 3.0))


def cbrt(v: torch.Tensor) -> torch.Tensor:
    """Signed cube root (torch has no ``cbrt``): |v| ** f32(1/3) taken in f64
    and rounded once, which is how XLA's f32 cbrt rounds in all but ~0.1% of
    values (f32 ``pow`` differs from it in ~20%)."""
    mag = torch.abs(v).to(torch.float64).pow(_ONE_THIRD_F32).to(v.dtype)
    return torch.sign(v) * mag


def srgb_to_linear(v: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] -> linear light.  reference: src/metrics/xyb.rs:60-67."""
    v = v.to(torch.float32)
    return torch.where(
        v <= 0.04045,
        v / 12.92,
        torch.clamp((v + 0.055) / 1.055, min=0.0).pow(2.4),
    )


def linear_to_srgb(v: torch.Tensor) -> torch.Tensor:
    """Linear light -> sRGB [0,1].  reference: src/metrics/xyb.rs:70-77."""
    v = v.to(torch.float32)
    return torch.where(
        v <= 0.0031308,
        v * 12.92,
        1.055 * torch.clamp(v, min=1e-12).pow(1.0 / 2.4) - 0.055,
    )


def srgb_u8_to_linear(v: torch.Tensor) -> torch.Tensor:
    """u8 sRGB -> linear f32.  reference: src/metrics/xyb.rs:80-83."""
    return srgb_to_linear(v.to(torch.float32) / 255.0)


def linear_to_srgb_u8(v: torch.Tensor) -> torch.Tensor:
    """Linear f32 -> u8 sRGB, rounding half away from zero (values are >= 0)."""
    s = linear_to_srgb(torch.clamp(v, 0.0, 1.0)) * 255.0
    return torch.floor(s + 0.5).to(torch.uint8)


def linear_rgb_to_xyb(rgb: torch.Tensor) -> torch.Tensor:
    """Linear RGB (..., 3) -> XYB (..., 3).  reference: src/metrics/xyb.rs:104-129."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    m = OPSIN_ABSORBANCE_MATRIX
    bias = OPSIN_ABSORBANCE_BIAS
    opsin = [
        float(m[i, 0]) * r + float(m[i, 1]) * g + float(m[i, 2]) * b + bias
        for i in range(3)
    ]
    cr, cg, cb = (cbrt(o) + NEG_OPSIN_ABSORBANCE_BIAS_CBRT for o in opsin)
    return torch.stack([0.5 * (cr - cg), 0.5 * (cr + cg), cb], dim=-1)


def xyb_to_linear_rgb(xyb: torch.Tensor) -> torch.Tensor:
    """XYB (..., 3) -> linear RGB (..., 3).  reference: src/metrics/xyb.rs:133-164."""
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    cr = (y + x) - NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    cg = (y - x) - NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    cb = b - NEG_OPSIN_ABSORBANCE_BIAS_CBRT
    opsin = [c * c * c - OPSIN_ABSORBANCE_BIAS for c in (cr, cg, cb)]
    inv = INV_OPSIN_MATRIX
    out = [
        float(inv[i, 0]) * opsin[0] + float(inv[i, 1]) * opsin[1] + float(inv[i, 2]) * opsin[2]
        for i in range(3)
    ]
    return torch.stack(out, dim=-1)


def _quantize_to_u8(value: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Quantize within [lo, hi] to 255 levels.  reference: src/metrics/xyb.rs:194-199."""
    rng = hi - lo
    normalized = (value - lo) / rng
    quantized = torch.clamp(torch.floor(normalized * 255.0 + 0.5), 0.0, 255.0) / 255.0
    return quantized * rng + lo


def xyb_roundtrip(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Roundtrip sRGB u8 (..., 3) through u8-quantized XYB (simulates 8-bit
    XYB storage).  reference: src/metrics/xyb.rs:225-253."""
    xyb = linear_rgb_to_xyb(srgb_u8_to_linear(rgb_u8))
    ranges = torch.from_numpy(XYB_RANGES).to(rgb_u8.device)
    xyb_q = _quantize_to_u8(xyb, ranges[:, 0], ranges[:, 1])
    return linear_to_srgb_u8(xyb_to_linear_rgb(xyb_q))
