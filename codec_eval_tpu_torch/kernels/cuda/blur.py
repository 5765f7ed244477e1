"""K6: border-renormalized Gaussian blur of a batch of planes.

``blur_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/blur.py:blur_batch_pallas``, with the same
arguments: (B, C, H, W) f32 planes and a sigma -> (B, C, H, W).  The blur is
a zero-padded separable FIR with Butteraugli's unnormalized taps (radius
``int(2.25 * sigma)``, up to 33 taps) times the reciprocal of the blurred
inside-image indicator, which equals the row-normalized operator product of
``butteraugli._blur`` up to summation order.  On a CUDA tensor it launches
the hand-written kernel (``csrc/blur.cu``); on a CPU tensor it runs the
plain PyTorch version beside it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..blur import fir_separable
from . import _lib
from .freqsep import _taps, recip_norm

#: The kernel's largest tap count (radius 16): sigma 7.16 takes 33.
MAX_TAPS = 33


def blur_batch_plain(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    h, w = planes.shape[-2], planes.shape[-1]
    return fir_separable(planes, _taps(sigma)) * recip_norm(h, w, sigma, planes.device)


@functools.lru_cache(maxsize=8)
def _host_taps(sigma: float) -> np.ndarray:
    taps = np.ascontiguousarray(_taps(sigma))
    if len(taps) > MAX_TAPS:
        raise ValueError(f"blur kernel takes at most {MAX_TAPS} taps, sigma {sigma} needs {len(taps)}")
    return taps


def blur_batch(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """K6.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if planes.device.type == "cpu":
        return blur_batch_plain(planes, sigma)
    _lib.require_cuda("planes", planes, (None, None, None, None))
    b, c, h, w = planes.shape
    taps = _host_taps(sigma)
    dev = planes.device
    out = torch.empty_like(planes)
    recip = recip_norm(h, w, sigma, dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_blur(
            _lib.ptr(planes), _lib.ptr(recip), _lib.ptr(out), b * c, h, w,
            _lib.ptr(taps), len(taps), _lib.stream(dev),
        )
    _lib.check(rc, "ce_blur")
    blur_batch.launches += 1
    return out


blur_batch.launches = 0
blur_batch.source = "codec_eval_tpu_torch/csrc/blur.cu"
blur_batch.replaces = "codec_eval_tpu/kernels/pallas/blur.py:61"
