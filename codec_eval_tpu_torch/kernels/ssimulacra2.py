"""SSIMULACRA2, batched over candidates against one precomputed reference.

Port of ``codec_eval_tpu/kernels/ssimulacra2.py`` (public SSIMULACRA 2.1):
sRGB -> linear RGB -> per-scale 2x2 box downsample -> positive XYB ->
Gaussian windowed SSIM and ringing / detail-loss maps -> 1- and 4-norm
pooling -> 108-feature weighted score.  The reference side (pyramid, XYB,
mu1, s11) is computed once per image; each scale's candidate side runs as
one K1 call over the whole batch (``cuda/scale_features.py``), the path of
the JAX package's ``_ssimulacra2_batch_pallas``.  A single pair
(``ssimulacra2``, ``features_from_linear``) runs each scale through K8, the
single-pair form, as the JAX package's ``scale_features_pallas`` route.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import ssimulacra2_weights as W
from .blur import blur_separable, downscale_by_2
from .color import linear_rgb_to_xyb, srgb_u8_to_linear
from .cuda.scale_features import (
    SIGMA,
    scale_features,
    scale_features_batch,
    scale_features_plain,
)

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
    (3, H, W) linear RGB so callers can share one staging pass.  Without it
    the planes are staged contiguous, as the batch scorer stages them, so
    both give the same pyramid to the bit."""
    linear = (
        lin_planar
        if lin_planar is not None
        else torch.movedim(srgb_u8_to_linear(ref_u8), -1, 0).contiguous()
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


def features_from_linear(
    ref: Ssimulacra2Reference, linear: torch.Tensor, windows=None
) -> torch.Tensor:
    """All 108 features of one candidate given as (3, H, W) linear RGB,
    channel-major ((3, 6, 2, 3) flattened), each scale through K8.
    ``windows`` gives each scale's row window (lo, hi), whose rows alone
    the features pool (a row band's own rows); None pools every row."""
    per_scale = []
    for scale in range(NUM_SCALES):
        if scale:
            linear = downscale_by_2(linear)
        xyb2 = _to_positive_xyb(linear).contiguous()
        per_scale.append(scale_features(ref.xyb[scale], ref.mu[scale], ref.sqblur[scale], xyb2,
                                        None if windows is None else windows[scale]))
    return torch.stack(per_scale, dim=1).reshape(-1)


def features_against_reference(
    ref: Ssimulacra2Reference, dist_u8: torch.Tensor, windows=None
) -> torch.Tensor:
    """Like ``features_from_linear`` for one (H, W, 3) u8 sRGB candidate."""
    return features_from_linear(
        ref, torch.movedim(srgb_u8_to_linear(dist_u8), -1, 0).contiguous(), windows)


@functools.lru_cache(maxsize=None)
def _weights(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The 108 feature weights on ``device``, copied there once: a copy per
    call would be a pageable one, which holds the host until the device's
    queue drains."""
    return torch.as_tensor(W.WEIGHTS_V21, dtype=dtype, device=device)


def score_from_features(features: torch.Tensor) -> torch.Tensor:
    """(..., 108) features -> SSIMULACRA2 score in (-inf, 100]."""
    weights = _weights(features.device, features.dtype)
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
        else torch.movedim(srgb_u8_to_linear(dist_batch_u8), -1, 1).contiguous()
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


def ssimulacra2(ref_u8: torch.Tensor, dist_u8: torch.Tensor) -> torch.Tensor:
    """Score of one (H, W, 3) u8 sRGB pair; byte-identical pairs score
    exactly 100.  reference: src/metrics/ssimulacra2.rs:59."""
    score = score_from_features(features_against_reference(precompute_reference(ref_u8), dist_u8))
    return torch.where(torch.all(ref_u8 == dist_u8), torch.full_like(score, 100.0), score)


def ssimulacra2_batch(ref_u8: torch.Tensor, dist_batch_u8: torch.Tensor) -> torch.Tensor:
    """Scores of (N, H, W, 3) u8 candidates against one (H, W, 3) reference,
    the reference precompute shared across the batch (K1 at every scale)."""
    return ssimulacra2_batch_pre(precompute_reference(ref_u8), ref_u8, dist_batch_u8)
