"""SSIMULACRA2, batched over candidates against one reference: a frozen
copy of the plain route of ``codec_eval_tpu_torch/kernels/ssimulacra2.py``
and of K1's plain version ``scale_features_plain``
(``kernels/cuda/scale_features.py``), commit 80b80d3.

sRGB -> linear RGB -> per-scale 2x2 box downsample -> positive XYB ->
Gaussian windowed SSIM and ringing / detail-loss maps -> 1- and 4-norm
pooling -> 108-feature weighted score.  ``dtype`` is the precision of
every plane (f32 as the port states it; the control takes bfloat16)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import ssimulacra2_weights as W
from .blur import blur_separable, downscale_by_2
from .color import linear_rgb_to_xyb

NUM_SCALES = 6
SIGMA = 1.5
C2 = 0.0009


def _to_positive_xyb(linear_planes: torch.Tensor) -> torch.Tensor:
    """Linear RGB planes (..., 3, H, W) -> positive-shifted XYB planes."""
    xyb = linear_rgb_to_xyb(torch.movedim(linear_planes, -3, -1))
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    return torch.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55], dim=-3)


def scale_features(xyb1, mu1, s11, xyb2) -> torch.Tensor:
    """Features of one scale: xyb2 (..., 3, h, w) -> (..., 3, 2, 3)."""
    stacked = torch.cat([xyb2, xyb2 * xyb2, xyb1 * xyb2], dim=-3)
    blurred = blur_separable(stacked, SIGMA)
    mu2, s22, s12 = blurred[..., 0:3, :, :], blurred[..., 3:6, :, :], blurred[..., 6:9, :, :]

    mu11 = mu1 * mu1
    mu22 = mu2 * mu2
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu12) + C2
    denom_s = (s11 - mu11) + (s22 - mu22) + C2
    d = torch.clamp(1.0 - (num_m * num_s) / denom_s, min=0.0)

    detail1 = torch.abs(xyb1 - mu1)
    detail2 = torch.abs(xyb2 - mu2)
    d1 = (1.0 + detail2) / (1.0 + detail1) - 1.0
    artifact = torch.clamp(d1, min=0.0)
    detail_lost = torch.clamp(-d1, min=0.0)

    def mean(x):
        return x.mean(dim=(-2, -1))

    def fourth(x):
        x2 = x * x
        return torch.sqrt(torch.sqrt(mean(x2 * x2)))

    one = torch.stack([mean(d), mean(artifact), mean(detail_lost)], dim=-1)
    four = torch.stack([fourth(d), fourth(artifact), fourth(detail_lost)], dim=-1)
    return torch.stack([one, four], dim=-2)


@dataclass
class Ssimulacra2Reference:
    """Per-scale reference planes, reused across every candidate."""

    xyb: list
    mu: list
    sqblur: list


def precompute_reference(lin_planar: torch.Tensor) -> Ssimulacra2Reference:
    """The reference's (3, H, W) linear RGB -> its pyramid."""
    linear = lin_planar
    xybs, mus, sqs = [], [], []
    for scale in range(NUM_SCALES):
        if scale:
            linear = downscale_by_2(linear)
        xyb = _to_positive_xyb(linear)
        blurred = blur_separable(torch.cat([xyb, xyb * xyb], dim=0), SIGMA)
        xybs.append(xyb.contiguous())
        mus.append(blurred[:3].contiguous())
        sqs.append(blurred[3:].contiguous())
    return Ssimulacra2Reference(xybs, mus, sqs)


def score_from_features(features: torch.Tensor) -> torch.Tensor:
    """(..., 108) features -> SSIMULACRA2 score in (-inf, 100]."""
    weights = torch.as_tensor(W.WEIGHTS_V21, dtype=features.dtype, device=features.device)
    s = torch.sum(weights * torch.abs(features), dim=-1) * W.SCALE_FACTOR
    v = (W.CUBIC_A * s * s + W.CUBIC_B * s + W.CUBIC_C) * s
    return torch.where(
        v > 0.0,
        100.0 - 10.0 * torch.clamp(v, min=1e-30).pow(W.POWER),
        torch.full_like(v, 100.0),
    )


def ssimulacra2_batch(
    ref: Ssimulacra2Reference, ref_u8: torch.Tensor, dist_u8: torch.Tensor, lin: torch.Tensor
) -> torch.Tensor:
    """Scores of (N, 3, H, W) candidates, given planar u8 and their linear
    RGB, against a precomputed reference; identical candidates score 100."""
    linear = lin
    per_scale = []
    for scale in range(NUM_SCALES):
        if scale:
            linear = downscale_by_2(linear)
        xyb2 = _to_positive_xyb(linear).contiguous()
        per_scale.append(scale_features(ref.xyb[scale], ref.mu[scale], ref.sqblur[scale], xyb2))
    feats = torch.stack(per_scale, dim=2).to(torch.float32)
    scores = score_from_features(feats.reshape(feats.shape[0], -1))
    identical = (dist_u8 == ref_u8).flatten(1).all(dim=1)
    return torch.where(identical, torch.full_like(scores, 100.0), scores)
