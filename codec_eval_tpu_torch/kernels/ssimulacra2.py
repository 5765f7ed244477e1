"""SSIMULACRA2, batched over candidates against one precomputed reference.

Port of ``codec_eval_tpu/kernels/ssimulacra2.py`` (public SSIMULACRA 2.1):
sRGB -> linear RGB -> per-scale 2x2 box downsample -> positive XYB ->
Gaussian windowed SSIM and ringing / detail-loss maps -> 1- and 4-norm
pooling -> 108-feature weighted score.  The reference side (pyramid, XYB,
mu1, s11) is computed once per image; each scale's candidate side runs as
one K1 call over the whole batch (``cuda/scale_features.py``), the path of
the JAX package's ``_ssimulacra2_batch_pallas``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import ssimulacra2_weights as W
from .blur import blur_separable, downscale_by_2
from .color import linear_rgb_to_xyb, srgb_u8_to_linear
from .cuda.scale_features import SIGMA, scale_features_batch, scale_features_plain

NUM_SCALES = 6

#: The plain per-scale features (the CPU path of K1).
_scale_features = scale_features_plain


def _to_positive_xyb(linear_planes: torch.Tensor) -> torch.Tensor:
    """Linear RGB planes (..., 3, H, W) -> positive-shifted XYB planes:
    B' = B - Y + 0.55, X' = X*14 + 0.42, Y' = Y + 0.01."""
    xyb = linear_rgb_to_xyb(torch.movedim(linear_planes, -3, -1))
    x, y, b = xyb[..., 0], xyb[..., 1], xyb[..., 2]
    return torch.stack([x * 14.0 + 0.42, y + 0.01, (b - y) + 0.55], dim=-3)


@dataclass
class Ssimulacra2Reference:
    """Per-scale reference planes, reused across every candidate."""

    xyb: list  # per scale: (3, h, w) positive XYB
    mu: list  # per scale: blur(xyb)
    sqblur: list  # per scale: blur(xyb * xyb)


def precompute_reference(
    ref_u8: torch.Tensor, lin_planar: torch.Tensor | None = None
) -> Ssimulacra2Reference:
    """ref_u8: (H, W, 3) uint8 sRGB.  ``lin_planar`` optionally supplies its
    (3, H, W) linear RGB so callers can share one staging pass."""
    linear = (
        lin_planar
        if lin_planar is not None
        else torch.movedim(srgb_u8_to_linear(ref_u8), -1, 0)
    )
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


def ssimulacra2_batch_pre(
    ref: Ssimulacra2Reference,
    ref_u8: torch.Tensor,
    dist_batch_u8: torch.Tensor,
    lin_planar: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scores of a candidate batch against a precomputed reference.

    ``ref_u8`` and ``dist_batch_u8`` are compared for byte identity in the
    same layout ((3, H, W) against (N, 3, H, W) on the scorer's path);
    identical candidates score exactly 100.  ``lin_planar`` is the batch's
    (N, 3, H, W) linear RGB; without it the batch is taken as (N, H, W, 3).
    """
    linear = (
        lin_planar
        if lin_planar is not None
        else torch.movedim(srgb_u8_to_linear(dist_batch_u8), -1, 1)
    )
    per_scale = []
    for scale in range(NUM_SCALES):
        if scale:
            linear = downscale_by_2(linear)
        xyb2 = _to_positive_xyb(linear).contiguous()
        per_scale.append(
            scale_features_batch(ref.xyb[scale], ref.mu[scale], ref.sqblur[scale], xyb2)
        )  # (N, 3, 2, 3)
    feats = torch.stack(per_scale, dim=2)  # (N, 3, 6, 2, 3)
    scores = score_from_features(feats.reshape(feats.shape[0], -1))
    identical = (dist_batch_u8 == ref_u8).flatten(1).all(dim=1)
    return torch.where(identical, torch.full_like(scores, 100.0), scores)
