"""K6: border-renormalized Gaussian blur of a batch of planes.

``blur_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/blur.py:blur_batch_pallas``, with the same
arguments: (B, C, H, W) f32 planes and a sigma -> (B, C, H, W).  The blur is
a zero-padded separable FIR with Butteraugli's unnormalized taps (radius
``int(2.25 * sigma)``, up to 33 taps) times the reciprocal of the blurred
inside-image indicator, which equals the row-normalized operator product of
``butteraugli._blur`` up to summation order.  On a CUDA tensor it launches
the hand-written kernel (``csrc/blur.cu``, the strip walk of K1 and K9 at
the blur's radius); on a CPU tensor it runs the plain PyTorch version
beside it.  ``plan`` holds what a launch needs besides its tensors, cached
per launch shape and device, so that a call does little on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..blur import fir_separable
from . import _lib
from .freqsep import _taps, recip_norm

#: The kernel's largest tap count (radius 16): sigma 7.16 takes 33.
MAX_TAPS = 33
#: The strip walk's segment lengths, longest first, and the blocks per SM
#: its grid should give the card (six fit at once: ~62 registers, 160
#: threads).  A segment runs its vertical pass over 2R halo rows (12 at
#: sigma 2.7), so longer segments win while the grid keeps ~3.5 blocks per
#: SM; a single image takes shorter ones, down to 4 rows, below which the
#: halo rows cost more than the spread gains (measured on the H100:
#: PERF.md, §6).
SEGMENTS = (256, 128, 64, 32, 16, 8, 4)
MIN_BLOCKS_PER_SM = 3.5


def blur_batch_plain(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    h, w = planes.shape[-2], planes.shape[-1]
    return fir_separable(planes, _taps(sigma)) * recip_norm(h, w, sigma, planes.device)


@functools.lru_cache(maxsize=8)
def _host_taps(sigma: float) -> np.ndarray:
    taps = np.ascontiguousarray(_taps(sigma))
    if len(taps) > MAX_TAPS:
        raise ValueError(f"blur kernel takes at most {MAX_TAPS} taps, sigma {sigma} needs {len(taps)}")
    return taps


def segment_rows(planes: int, h: int, w: int, sms: int) -> int:
    """Rows per segment of K6's and K7's strips for ``planes`` (h, w)
    planes on ``sms`` SMs (``_lib.segment_rows``).  No value crosses a
    block, so the outputs do not depend on it."""
    return _lib.segment_rows(planes * -(-w // _lib.STRIP), h, SEGMENTS, MIN_BLOCKS_PER_SM, sms)


class Plan(NamedTuple):
    """What a launch needs besides its tensors."""

    fn: object  # the bound C entry point
    recip: torch.Tensor  # the (h, w) reciprocal plane
    taps: np.ndarray  # the host taps, kept alive for ``taps_ptr``
    taps_ptr: int
    seg: int  # rows per segment


@functools.lru_cache(maxsize=64)
def plan(entry: str, planes: int, h: int, w: int, sigma: float, device: int) -> Plan:
    """The ``Plan`` of a launch of the C entry point ``entry`` on
    ``planes`` (h, w) planes of CUDA device ``device``, made once per
    launch shape.  Raises before touching the card on a sigma the kernel
    does not take."""
    taps = _host_taps(sigma)
    dev = torch.device("cuda", device)
    return Plan(getattr(_lib.load(), entry), recip_norm(h, w, sigma, dev), taps,
                taps.ctypes.data, segment_rows(planes, h, w, _lib.sm_count(dev)))


def _launch(planes: torch.Tensor, sigma: float, seg=None) -> torch.Tensor:
    """One launch of K6 on a checked CUDA tensor; ``seg`` defaults to
    ``segment_rows``'s choice."""
    b, c, h, w = planes.shape
    p = plan("ce_blur", b * c, h, w, sigma, planes.get_device())
    out = torch.empty_like(planes)
    rc = _lib.launch(p.fn, planes.get_device(), planes.data_ptr(), p.recip.data_ptr(), out.data_ptr(),
                     b * c, h, w, p.seg if seg is None else seg, p.taps_ptr, len(p.taps))
    _lib.check(rc, "ce_blur")
    return out


def blur_batch(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """K6.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if planes.device.type == "cpu":
        return blur_batch_plain(planes, sigma)
    _lib.require_cuda("planes", planes, (None, None, None, None))
    out = _launch(planes, sigma)
    blur_batch.launches += 1
    return out


blur_batch.launches = 0
blur_batch.source = "codec_eval_tpu_torch/csrc/blur.cu"
blur_batch.replaces = "codec_eval_tpu/kernels/pallas/blur.py:61"
