"""K9: the candidate-side SSIM moments of a batch of pairs.

``candidate_moments`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/moments.py:candidate_moments_pallas`` at
sigma 1.5: x1 and x2 planes of shape (N, 3, H, W) or (3, H, W) -> (mu2,
s22, s12), the zero-boundary Gaussian blurs of x2, x2*x2 and x1*x2, each of
the input's shape.  It carries a leading batch axis because the masked
scorer (``kernels/masked.py``) gives every pair its own reference.  On a
CUDA tensor it launches the hand-written kernel (``csrc/moments.cu``, K1's
moment tile); on a CPU tensor it runs ``candidate_moments_plain``, what the
JAX package's ``fused_candidate_moments`` computes off the TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blur import blur_separable, gaussian_taps
from . import _lib

SIGMA = 1.5


def candidate_moments_plain(x1: torch.Tensor, x2: torch.Tensor):
    """(mu2, s22, s12) as one zero-padded separable blur of the stacked
    products (``kernels/blur.py``)."""
    blurred = blur_separable(torch.cat([x2, x2 * x2, x1 * x2], dim=-3), SIGMA)
    c = x2.shape[-3]
    return blurred[..., :c, :, :], blurred[..., c : 2 * c, :, :], blurred[..., 2 * c :, :, :]


def candidate_moments(x1: torch.Tensor, x2: torch.Tensor):
    """K9.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if x2.device.type == "cpu":
        return candidate_moments_plain(x1, x2)
    _lib.require_cuda("x2", x2, (None, 3, None, None) if x2.dim() == 4 else (3, None, None))
    _lib.require_cuda("x1", x1, tuple(x2.shape))
    if x1.device != x2.device:
        raise ValueError("x1 and x2 must be on one device")
    taps = np.ascontiguousarray(gaussian_taps(SIGMA))
    if len(taps) != 15:
        raise ValueError("the moments kernel takes 15 taps")
    h, w = x2.shape[-2], x2.shape[-1]
    planes = x2.numel() // (h * w)
    dev = x2.device
    out = torch.empty((3,) + tuple(x2.shape), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_candidate_moments(
            _lib.ptr(x1), _lib.ptr(x2), _lib.ptr(out), planes, h, w, _lib.ptr(taps),
            _lib.stream(dev),
        )
    _lib.check(rc, "ce_candidate_moments")
    candidate_moments.launches += 1
    return out[0], out[1], out[2]


candidate_moments.launches = 0
candidate_moments.source = "codec_eval_tpu_torch/csrc/moments.cu"
candidate_moments.replaces = "codec_eval_tpu/kernels/pallas/moments.py:76"
