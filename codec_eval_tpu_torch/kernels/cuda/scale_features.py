"""K1: SSIMULACRA2 per-scale features for a batch of candidates.

``scale_features_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/scale_features.py:scale_features_pallas_batch``:
(3, H, W) reference planes xyb1, mu1, s11 against (N, 3, H, W) candidates
xyb2 -> (N, 3, 2, 3) features (channel x norm x {ssim, artifact, detail}).
On a CUDA tensor it launches the hand-written kernel
(``csrc/scale_features.cu``), which writes six partial sums per 32x16 tile;
this wrapper adds them and forms the norms, as the JAX wrapper does.  On a
CPU tensor it runs ``scale_features_plain``, the port of
``codec_eval_tpu/kernels/ssimulacra2.py:_scale_features``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blur import blur_separable, gaussian_taps
from . import _lib

SIGMA = 1.5
C2 = 0.0009
#: Output tile of the kernel (csrc/scale_features.cu TW, TH).
TILE = (32, 16)


def _norms(sums: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """(..., 6) sums (d, d^4, art, art^4, lost, lost^4) -> (..., 2, 3)."""
    mean = sums / float(n_pixels)
    one = mean[..., 0::2]
    four = torch.sqrt(torch.sqrt(mean[..., 1::2]))
    return torch.stack([one, four], dim=-2)


def scale_features_plain(
    xyb1: torch.Tensor, mu1: torch.Tensor, s11: torch.Tensor, xyb2: torch.Tensor
) -> torch.Tensor:
    """Features for one scale: xyb2 (..., 3, h, w) -> (..., 3, 2, 3)."""
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


def scale_features_batch(
    xyb1: torch.Tensor, mu1: torch.Tensor, s11: torch.Tensor, xyb2: torch.Tensor
) -> torch.Tensor:
    """K1.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if xyb2.device.type == "cpu":
        return scale_features_plain(xyb1, mu1, s11, xyb2)
    _lib.require_cuda("xyb2", xyb2, (None, 3, None, None))
    n, _, h, w = xyb2.shape
    for name, t in (("xyb1", xyb1), ("mu1", mu1), ("s11", s11)):
        _lib.require_cuda(name, t, (3, h, w))
        if t.device != xyb2.device:
            raise ValueError(f"{name} and xyb2 must be on one device")
    taps = np.ascontiguousarray(gaussian_taps(SIGMA))
    if len(taps) != 15:
        raise ValueError("scale-features kernel takes 15 taps")
    nblocks = -(-w // TILE[0]) * -(-h // TILE[1])
    dev = xyb2.device
    partial = torch.empty((n, 3, nblocks, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_scale_features(
            _lib.ptr(xyb1), _lib.ptr(mu1), _lib.ptr(s11), _lib.ptr(xyb2),
            _lib.ptr(partial), n, h, w, _lib.ptr(taps), _lib.stream(dev),
        )
    _lib.check(rc, "ce_scale_features")
    scale_features_batch.launches += 1
    return _norms(partial.sum(dim=2), h * w)


scale_features_batch.launches = 0
scale_features_batch.source = "codec_eval_tpu_torch/csrc/scale_features.cu"
scale_features_batch.replaces = "codec_eval_tpu/kernels/pallas/scale_features.py:407"
