"""Separable Gaussian blur and 2x2 box downscale: a frozen copy of
``codec_eval_tpu_torch/kernels/blur.py`` (commit 80b80d3).  Planes are
``(..., H, W)``; every leading axis is a batch axis."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_taps(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1-D Gaussian taps, radius ceil(4.5*sigma) by default."""
    if radius is None:
        radius = max(1, int(math.ceil(4.5 * sigma)))
    n = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-0.5 * (n / sigma) ** 2)
    taps /= taps.sum()
    return taps.astype(np.float32)


def fir_separable(planes: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded separable FIR over the last two axes, vertical pass
    first, taps summed in order."""
    k = len(taps)
    r = k // 2
    h, w = planes.shape[-2], planes.shape[-1]
    xp = F.pad(planes, (0, 0, r, r))
    out = float(taps[0]) * xp[..., 0:h, :]
    for i in range(1, k):
        out = out + float(taps[i]) * xp[..., i : i + h, :]
    xp = F.pad(out, (r, r))
    out = float(taps[0]) * xp[..., :, 0:w]
    for i in range(1, k):
        out = out + float(taps[i]) * xp[..., :, i : i + w]
    return out


def blur_separable(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian-blur a stack of planes ``(..., H, W)``, zero-padded borders."""
    return fir_separable(planes, gaussian_taps(sigma))


def downscale_by_2(planes: torch.Tensor) -> torch.Tensor:
    """2x2 box downscale on ``(..., H, W)`` to ceil(n/2), odd borders
    edge-clamped."""
    h, w = planes.shape[-2], planes.shape[-1]
    if h % 2:
        planes = torch.cat([planes, planes[..., -1:, :]], dim=-2)
    if w % 2:
        planes = torch.cat([planes, planes[..., :, -1:]], dim=-1)
    h2, w2 = planes.shape[-2], planes.shape[-1]
    lead = planes.shape[:-2]
    return planes.reshape(lead + (h2 // 2, 2, w2 // 2, 2)).mean(dim=(-3, -1))
