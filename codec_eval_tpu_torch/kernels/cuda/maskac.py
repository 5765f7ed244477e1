"""K7: Butteraugli's candidate-side masking term, blur and epilogue fused.

``mask_diff_ac_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/maskac.py:mask_diff_ac_batch_pallas``, with
the same arguments: (B, H, W) diff-precomputed contrast planes ``d1``, the
reference's (H, W) blur ``b0``, ``ac_mul`` and ``sigma`` -> (B, H, W)
``ac_mul * (b0 - b1) * (b0 - b1)``, where ``b1`` is K6's renormalized blur
of ``d1``.  On a CUDA tensor it launches the hand-written kernel
(``csrc/blur.cu``, K6's strip walk with the mask term in its last stage),
so ``b1`` never reaches device memory; on a CPU tensor it runs the plain
PyTorch version beside it.  The single pair calls it twice per Butteraugli
score, so a call does little on the host: K6's ``plan`` caches the rest.
"""

from __future__ import annotations

import torch

from . import _lib
from .blur import blur_batch_plain, plan


def mask_diff_ac_plain(d1: torch.Tensor, b0: torch.Tensor, ac_mul: float, sigma: float = 2.7):
    b1 = blur_batch_plain(d1[:, None], sigma)[:, 0]
    d = b0 - b1
    return (ac_mul * d) * d


def _launch(d1: torch.Tensor, b0: torch.Tensor, ac_mul: float, sigma: float,
            seg=None) -> torch.Tensor:
    """One launch of K7 on checked CUDA tensors; ``seg`` defaults to
    ``blur.segment_rows``'s choice."""
    b, h, w = d1.shape
    p = plan("ce_mask_diff_ac", b, h, w, sigma, d1.get_device())
    out = torch.empty_like(d1)
    rc = _lib.launch(p.fn, d1.get_device(), d1.data_ptr(), b0.data_ptr(), p.recip.data_ptr(),
                     out.data_ptr(), b, h, w, p.seg if seg is None else seg, p.taps_ptr,
                     len(p.taps), float(ac_mul))
    _lib.check(rc, "ce_mask_diff_ac")
    return out


def mask_diff_ac_batch(
    d1: torch.Tensor, b0: torch.Tensor, ac_mul: float, sigma: float = 2.7
) -> torch.Tensor:
    """K7.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if d1.device.type == "cpu":
        return mask_diff_ac_plain(d1, b0, ac_mul, sigma)
    _lib.require_cuda("d1", d1, (None, None, None))
    _lib.require_cuda("b0", b0, tuple(d1.shape[1:]))
    if b0.device != d1.device:
        raise ValueError("d1 and b0 must be on one device")
    out = _launch(d1, b0, ac_mul, sigma)
    mask_diff_ac_batch.launches += 1
    return out


mask_diff_ac_batch.launches = 0
mask_diff_ac_batch.source = "codec_eval_tpu_torch/csrc/blur.cu"
mask_diff_ac_batch.replaces = "codec_eval_tpu/kernels/pallas/maskac.py:60"
