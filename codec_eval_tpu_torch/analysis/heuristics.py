"""Per-image content heuristics as one device pass.

Port of ``codec_eval_tpu/analysis/heuristics.py`` (reference:
crates/codec-compare/src/image_heuristics.rs:23-300): the per-image
features used for encoder-selection prediction (luminance stats,
central-difference edges, 8x8 block-variance buckets, color and saturation
stats, adjacent-pixel frequency energies, 3x3 local contrast, directional
complexity).

The JAX package jits the feature stack and vmaps it over a corpus batch;
here the same slices and reductions run on an (N, H, W, 3) batch at once
on the caller's device, and the N x 24 features come back to the host in
one copy.  The 3x3 local maximum and minimum are ``max_pool2d`` windows,
which select values and so equal the JAX package's stacked shifts exactly.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

#: Feature order for CSV output (matches the reference's struct order).
FEATURE_NAMES = [
    "mean_luminance",
    "luminance_variance",
    "luminance_std",
    "edge_strength_mean",
    "edge_strength_max",
    "edge_density",
    "flat_block_pct",
    "low_var_block_pct",
    "mid_var_block_pct",
    "high_var_block_pct",
    "detail_block_pct",
    "block_variance_mean",
    "block_variance_std",
    "color_variance",
    "saturation_mean",
    "saturation_std",
    "high_freq_energy",
    "low_freq_energy",
    "freq_ratio",
    "local_contrast_mean",
    "local_contrast_std",
    "horizontal_complexity",
    "vertical_complexity",
    "diagonal_complexity",
]


def _share(mask: torch.Tensor, dims) -> torch.Tensor:
    """The share of True values over ``dims``, as a float32 mean."""
    return mask.to(torch.float32).mean(dim=dims)


def _gray(rgb: torch.Tensor) -> torch.Tensor:
    """``0.299 r + 0.587 g + 0.114 b`` of (..., 3) f32 values in [0, 255],
    rounded as XLA's CPU code rounds the JAX package's jitted expression:
    ``fma(0.114, b, fma(0.299, r, 0.587 g))``.  Each fused step runs in f64,
    where a product of an f32 weight and a u8 value plus an f32 sum is
    exact, and is rounded to f32 once, so the card and the CPU give the same
    bits.  The thresholded features (edges, frequencies, block buckets)
    count values that sit on their thresholds, so the rounding matters."""
    r, g, b = (rgb[..., c].to(torch.float64) for c in range(3))
    acc = (0.587 * rgb[..., 1]).to(torch.float64)
    acc = (float(np.float32(0.299)) * r + acc).to(torch.float32).to(torch.float64)
    return (float(np.float32(0.114)) * b + acc).to(torch.float32)


def _features(rgb_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All features of an (N, H, W, 3) u8 batch, each an (N,) tensor."""
    rgb = rgb_u8.to(torch.float32)
    n, h, w = rgb.shape[0], rgb.shape[1], rgb.shape[2]
    hw = (-2, -1)

    gray = _gray(rgb)

    out: Dict[str, torch.Tensor] = {}

    # Luminance.
    mean_lum = gray.mean(dim=hw)
    dev = gray - mean_lum[:, None, None]
    lum_var = (dev * dev).mean(dim=hw)
    out["mean_luminance"] = mean_lum
    out["luminance_variance"] = lum_var
    out["luminance_std"] = torch.sqrt(lum_var)

    # Edges: central differences on the interior, magnitude sqrt(gx^2+gy^2).
    gx = gray[:, 1:-1, 2:] - gray[:, 1:-1, :-2]
    gy = gray[:, 2:, 1:-1] - gray[:, :-2, 1:-1]
    strength = torch.sqrt(gx * gx + gy * gy)
    out["edge_strength_mean"] = strength.mean(dim=hw)
    out["edge_strength_max"] = strength.amax(dim=hw)
    out["edge_density"] = _share(strength > 30.0, hw)

    # 8x8 block variances.
    bh, bw = h // 8, w // 8
    blocks = gray[:, : bh * 8, : bw * 8].reshape(n, bh, 8, bw, 8)
    bmean = blocks.mean(dim=(2, 4), keepdim=True)
    bdev = blocks - bmean
    bvar = (bdev * bdev).mean(dim=(2, 4)).reshape(n, -1)
    out["flat_block_pct"] = 100.0 * _share(bvar < 100.0, -1)
    out["low_var_block_pct"] = 100.0 * _share(bvar < 500.0, -1)
    out["mid_var_block_pct"] = 100.0 * _share((bvar >= 500.0) & (bvar < 2000.0), -1)
    out["high_var_block_pct"] = 100.0 * _share((bvar >= 2000.0) & (bvar < 5000.0), -1)
    out["detail_block_pct"] = 100.0 * _share(bvar >= 5000.0, -1)
    bv_mean = bvar.mean(dim=-1)
    bv_dev = bvar - bv_mean[:, None]
    out["block_variance_mean"] = bv_mean
    out["block_variance_std"] = torch.sqrt((bv_dev * bv_dev).mean(dim=-1))

    # Color: mean of per-channel variances.
    ch_dev = rgb - rgb.mean(dim=(1, 2), keepdim=True)
    out["color_variance"] = (ch_dev * ch_dev).mean(dim=(1, 2)).mean(dim=-1)

    # Saturation: (max - min) / max per pixel.
    cmax = rgb.amax(dim=-1)
    cmin = rgb.amin(dim=-1)
    sat = torch.where(cmax > 0.0, (cmax - cmin) / torch.clamp(cmax, min=1e-9),
                      torch.zeros_like(cmax))
    sat_mean = sat.mean(dim=hw)
    sat_dev = sat - sat_mean[:, None, None]
    out["saturation_mean"] = sat_mean
    out["saturation_std"] = torch.sqrt((sat_dev * sat_dev).mean(dim=hw))

    # Frequency proxy: fraction of small / large horizontal transitions.
    diff = torch.abs(gray[:, :, 1:] - gray[:, :, :-1])
    low = _share(diff < 10.0, hw)
    high = _share(diff > 30.0, hw)
    out["low_freq_energy"] = low
    out["high_freq_energy"] = high
    out["freq_ratio"] = torch.where(low > 0.0, high / torch.clamp(low, min=1e-12), high)

    # Local contrast: 3x3 max - min over the interior.
    g = gray[:, None]
    contrast = (F.max_pool2d(g, 3, stride=1) + F.max_pool2d(-g, 3, stride=1))[:, 0]
    c_mean = contrast.mean(dim=hw)
    c_dev = contrast - c_mean[:, None, None]
    out["local_contrast_mean"] = c_mean
    out["local_contrast_std"] = torch.sqrt((c_dev * c_dev).mean(dim=hw))

    # Directional complexity.
    out["horizontal_complexity"] = torch.abs(gx).mean(dim=hw)
    out["vertical_complexity"] = torch.abs(gy).mean(dim=hw)
    diag = gray[:, 2:, 2:] - gray[:, :-2, :-2]
    out["diagonal_complexity"] = torch.abs(diag).mean(dim=hw)

    return out


def compute_heuristics(rgb_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """All features of one (H, W, 3) u8 image on its device, each a 0-d
    tensor."""
    return {k: v[0] for k, v in _features(rgb_u8[None]).items()}


def heuristics_batch(batch_u8: np.ndarray, device="cuda") -> List[Dict[str, float]]:
    """(N, H, W, 3) batch -> list of feature dicts: one pass on ``device``
    (the card unless the caller asks for ``"cpu"``) and one copy back."""
    x = torch.from_numpy(np.require(batch_u8, requirements="CW")).to(resolve_device(device))
    feats = _features(x)
    names = sorted(feats)
    stacked = torch.stack([feats[k] for k in names], dim=1).cpu().numpy()
    return [{k: float(row[j]) for j, k in enumerate(names)} for row in stacked]


def heuristics_one(rgb_u8: np.ndarray, device="cuda") -> Dict[str, float]:
    """The features of one (H, W, 3) u8 image (``heuristics_batch`` at N = 1)."""
    return heuristics_batch(np.asarray(rgb_u8)[None], device=device)[0]
