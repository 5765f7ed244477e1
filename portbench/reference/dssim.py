"""DSSIM, batched over candidates: a frozen copy of
``codec_eval_tpu_torch/kernels/dssim.py`` (commit 80b80d3), with the
precision of the Lab planes and everything after them a parameter.

Linear RGB -> scaled Lab; chroma at half resolution and half weight; a
separable 3-tap edge-replicated window; a 5-scale 2x2 box pyramid with the
MS-SSIM weights; per scale and channel the mean SSIM; then ``1/ssim - 1``.
The port states f64 for the Lab planes on (the f32 variance terms cancel
catastrophically); the control takes f32."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .blur import downscale_by_2
from .color import cbrt, rdiv

SCALE_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
CHROMA_WEIGHT = 0.5
C1 = 0.01**2
C2 = 0.03**2
_BLUR_TAPS = (0.3087588, 0.3824827, 0.3087588)
_D65_X, _D65_Y, _D65_Z = 0.9505, 1.0, 1.089
_EPSILON = 216.0 / 24389.0
_KAPPA_116 = (24389.0 / 27.0) / 116.0


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(
        t > _EPSILON, cbrt(torch.clamp(t, min=1e-12)) - 16.0 / 116.0, _KAPPA_116 * t
    )


def _linear_rgb_to_lab_planes(rgb_planes: torch.Tensor, dtype) -> torch.Tensor:
    """Linear RGB (..., 3, H, W) -> dssim-core's scaled Lab planes."""
    rgb_planes = rgb_planes.to(dtype)
    r, g, b = rgb_planes[..., 0, :, :], rgb_planes[..., 1, :, :], rgb_planes[..., 2, :, :]
    fx = (0.4124 * r + 0.3576 * g + 0.1805 * b) / _D65_X
    fy = (0.2126 * r + 0.7152 * g + 0.0722 * b) / _D65_Y
    fz = (0.0193 * r + 0.1192 * g + 0.9505 * b) / _D65_Z
    x, y, z = _lab_f(fx), _lab_f(fy), _lab_f(fz)
    l_chan = 1.16 * y
    a_chan = 86.2 / 220.0 + (500.0 / 220.0) * (x - y)
    b_chan = 107.9 / 220.0 + (200.0 / 220.0) * (y - z)
    return torch.stack([l_chan, a_chan, b_chan], dim=-3)


def _blur_window(planes: torch.Tensor) -> torch.Tensor:
    """dssim-core's 3x3 window on (..., H, W), edge-replicated borders."""
    a, b, _ = _BLUR_TAPS
    h, w = planes.shape[-2], planes.shape[-1]
    xp = torch.cat([planes[..., :1, :], planes, planes[..., -1:, :]], dim=-2)
    out = a * xp[..., 0:h, :] + b * xp[..., 1 : 1 + h, :] + a * xp[..., 2 : 2 + h, :]
    xp = torch.cat([out[..., :, :1], out, out[..., :, -1:]], dim=-1)
    return a * xp[..., :, 0:w] + b * xp[..., :, 1 : 1 + w] + a * xp[..., :, 2 : 2 + w]


def _lab_channel_pyramids(lab: torch.Tensor) -> list:
    """Per scale, (luma (..., 1, h, w), chroma (..., 2, ~h/2, ~w/2))."""
    luma = lab[..., :1, :, :]
    chroma = downscale_by_2(lab[..., 1:, :, :])
    stacks = []
    for scale in range(len(SCALE_WEIGHTS)):
        if scale:
            luma = downscale_by_2(luma)
            chroma = downscale_by_2(chroma)
        stacks.append((luma, chroma))
    return stacks


def _ssim_means(ch1, mu1, s11, ch2) -> torch.Tensor:
    """Mean SSIM per plane of a (..., C, H, W) stack, reference moments given."""
    n = ch1.shape[-3]
    blurred = _blur_window(torch.cat([ch2, ch2 * ch2, ch1 * ch2], dim=-3))
    mu2 = blurred[..., :n, :, :]
    s22 = blurred[..., n : 2 * n, :, :]
    s12 = blurred[..., 2 * n :, :, :]
    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    ssim = ((2.0 * mu12 + C1) * (2.0 * (s12 - mu12) + C2)) / (
        (mu11 + mu22 + C1) * ((s11 - mu11) + (s22 - mu22) + C2)
    )
    return ssim.mean(dim=(-2, -1))


@dataclass
class DssimReference:
    """Per-scale reference Lab pyramids and window moments."""

    planes: list
    mu: list
    sqblur: list
    dtype: torch.dtype


def precompute_dssim_reference(ref_linear: torch.Tensor, dtype=torch.float64) -> DssimReference:
    """ref_linear: (3, H, W) linear-light RGB."""
    lab = _linear_rgb_to_lab_planes(ref_linear, dtype)
    planes, mus, sqs = [], [], []
    for luma, chroma in _lab_channel_pyramids(lab):
        bl = _blur_window(torch.cat([luma, luma * luma], dim=0))
        bc = _blur_window(torch.cat([chroma, chroma * chroma], dim=0))
        planes.append((luma, chroma))
        mus.append((bl[:1], bc[:2]))
        sqs.append((bl[1:], bc[2:]))
    return DssimReference(planes, mus, sqs, dtype)


def dssim_against_reference(ref: DssimReference, dist_linear: torch.Tensor) -> torch.Tensor:
    """DSSIM of candidates (N, 3, H, W) linear RGB vs a precomputed reference."""
    lab2 = _linear_rgb_to_lab_planes(dist_linear, ref.dtype)
    total = None
    wsum = 0.0
    for s, (luma2, chroma2) in enumerate(_lab_channel_pyramids(lab2)):
        l1, c1 = ref.planes[s]
        lmu, cmu = ref.mu[s]
        lsq, csq = ref.sqblur[s]
        luma = _ssim_means(l1, lmu, lsq, luma2)
        chroma = _ssim_means(c1, cmu, csq, chroma2)
        w = SCALE_WEIGHTS[s]
        if total is None:
            total = torch.zeros_like(luma[..., 0])
        total = total + w * luma[..., 0]
        total = total + w * CHROMA_WEIGHT * torch.sum(chroma, dim=-1)
        wsum += w * (1.0 + 2.0 * CHROMA_WEIGHT)
    ssim = torch.clamp(total / wsum, 1e-6, 1.0)
    return (rdiv(1.0, ssim) - 1.0).to(torch.float32)
