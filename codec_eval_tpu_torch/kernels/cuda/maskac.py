"""K7: Butteraugli's candidate-side masking term, blur and epilogue fused.

``mask_diff_ac_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/maskac.py:mask_diff_ac_batch_pallas``, with
the same arguments: (B, H, W) diff-precomputed contrast planes ``d1``, the
reference's (H, W) blur ``b0``, ``ac_mul`` and ``sigma`` -> (B, H, W)
``ac_mul * (b0 - b1) * (b0 - b1)``, where ``b1`` is K6's renormalized blur
of ``d1``.  On a CUDA tensor it launches the hand-written kernel
(``csrc/blur.cu``, which shares K6's tile code), so ``b1`` never reaches
device memory; on a CPU tensor it runs the plain PyTorch version beside it.
"""

from __future__ import annotations

import torch

from . import _lib
from .blur import _host_taps, blur_batch_plain
from .freqsep import recip_norm


def mask_diff_ac_plain(d1: torch.Tensor, b0: torch.Tensor, ac_mul: float, sigma: float = 2.7):
    b1 = blur_batch_plain(d1[:, None], sigma)[:, 0]
    d = b0 - b1
    return (ac_mul * d) * d


def mask_diff_ac_batch(
    d1: torch.Tensor, b0: torch.Tensor, ac_mul: float, sigma: float = 2.7
) -> torch.Tensor:
    """K7.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if d1.device.type == "cpu":
        return mask_diff_ac_plain(d1, b0, ac_mul, sigma)
    _lib.require_cuda("d1", d1, (None, None, None))
    b, h, w = d1.shape
    _lib.require_cuda("b0", b0, (h, w))
    if b0.device != d1.device:
        raise ValueError("d1 and b0 must be on one device")
    taps = _host_taps(sigma)
    dev = d1.device
    out = torch.empty_like(d1)
    recip = recip_norm(h, w, sigma, dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_mask_diff_ac(
            _lib.ptr(d1), _lib.ptr(b0), _lib.ptr(recip), _lib.ptr(out), b, h, w,
            _lib.ptr(taps), len(taps), float(ac_mul), _lib.stream(dev),
        )
    _lib.check(rc, "ce_mask_diff_ac")
    mask_diff_ac_batch.launches += 1
    return out


mask_diff_ac_batch.launches = 0
mask_diff_ac_batch.source = "codec_eval_tpu_torch/csrc/blur.cu"
mask_diff_ac_batch.replaces = "codec_eval_tpu/kernels/pallas/maskac.py:60"
