"""K9: the SSIM moments of a batch of pairs, candidate and reference side.

``candidate_moments`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/moments.py:candidate_moments_pallas`` at
sigma 1.5: x1 and x2 planes of shape (N, 3, H, W) or (3, H, W) -> (mu2,
s22, s12), the zero-boundary Gaussian blurs of x2, x2*x2 and x1*x2, each of
the input's shape.  It carries a leading batch axis because the masked
scorer (``kernels/masked.py``) gives every pair its own reference.
``reference_moments`` is its one-input form for the reference side: x1 ->
(mu1, s11), the blurs of x1 and x1*x1, the first two planes that
``candidate_moments(x1, x1)`` gives, from one read of x1 and two planes
written.  Both launch one kernel (``csrc/moments.cu``, K1's strip walk,
or a tile walk for small launches) on CUDA tensors; on CPU tensors they
run ``candidate_moments_plain`` and ``reference_moments_plain``, what the
JAX package's ``fused_candidate_moments`` and its masked reference blur
compute off the TPU.  Each counts its own launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..blur import blur_separable, gaussian_taps
from . import _lib

SIGMA = 1.5
#: The strip walk's segment lengths, longest first, and the blocks per SM
#: its grid should give the card (four fit at once: ~90 registers, 160
#: threads).  A segment runs its vertical pass over 14 halo rows, so longer
#: segments win until the grid drops under ~2.5 blocks per SM (measured on
#: the H100: PERF.md, §6).
SEGMENTS = (128, 64, 32, 16)
MIN_BLOCKS_PER_SM = 2.5
#: The ``walk`` argument of the C entry points (``csrc/moments.cu`` Walk).
STRIP_WALK, TILE_WALK = 0, 1
#: Launches of at most this many channel-pixels (planes x h x w) take the
#: tile walk (one 32x16 tile per block): there the grid is small, a block's
#: latency sets the time, and the strip walk's row groups cost more than
#: they save (measured on the H100: PERF.md, §6).
TILE_MAX_WORK = 1 << 19


def segment_rows(planes: int, h: int, w: int, sms: int) -> int:
    """Rows per segment of the strip walk for ``planes`` (h, w) planes on
    ``sms`` SMs (``_lib.segment_rows``).  No value crosses a block, so the
    outputs do not depend on it."""
    return _lib.segment_rows(planes * -(-w // _lib.STRIP), h, SEGMENTS, MIN_BLOCKS_PER_SM, sms)


def launch_walk(planes: int, h: int, w: int) -> int:
    """The walk of a launch of ``planes`` (h, w) planes: ``TILE_WALK`` for
    at most ``TILE_MAX_WORK`` channel-pixels, else ``STRIP_WALK``."""
    return TILE_WALK if planes * h * w <= TILE_MAX_WORK else STRIP_WALK


def candidate_moments_plain(x1: torch.Tensor, x2: torch.Tensor):
    """(mu2, s22, s12) as one zero-padded separable blur of the stacked
    products (``kernels/blur.py``)."""
    blurred = blur_separable(torch.cat([x2, x2 * x2, x1 * x2], dim=-3), SIGMA)
    c = x2.shape[-3]
    return blurred[..., :c, :, :], blurred[..., c : 2 * c, :, :], blurred[..., 2 * c :, :, :]


def reference_moments_plain(x1: torch.Tensor):
    """(mu1, s11): the blur of the stacked x1 and x1*x1, as the JAX
    package's masked scorer takes them; each plane blurs on its own, so
    they equal the first two of ``candidate_moments_plain(x1, x1)``."""
    blurred = blur_separable(torch.cat([x1, x1 * x1], dim=-3), SIGMA)
    c = x1.shape[-3]
    return blurred[..., :c, :, :], blurred[..., c:, :, :]


def _taps() -> np.ndarray:
    taps = np.ascontiguousarray(gaussian_taps(SIGMA))
    if len(taps) != 15:
        raise ValueError("the moments kernel takes 15 taps")
    return taps


def _check(x1: torch.Tensor, x2: torch.Tensor) -> None:
    _lib.require_cuda("x2", x2, (None, 3, None, None) if x2.dim() == 4 else (3, None, None))
    _lib.require_cuda("x1", x1, tuple(x2.shape))
    if x1.device != x2.device:
        raise ValueError("x1 and x2 must be on one device")


#: Each form's C entry point and the moments it writes.
_FORMS = {"candidate": ("ce_candidate_moments", 3), "reference": ("ce_reference_moments", 2)}


def _launch(form: str, inputs: tuple, walk=None, seg=None) -> torch.Tensor:
    """One launch of ``form`` on checked CUDA tensors: ``inputs`` is (x1,
    x2) for the candidate form, (x1,) for the reference form.  ``walk`` and
    ``seg`` default to ``launch_walk``'s and ``segment_rows``'s choices.
    Returns the (3 or 2, *x1.shape) stack of blurred moments."""
    entry, moments = _FORMS[form]
    x1 = inputs[0]
    h, w = x1.shape[-2], x1.shape[-1]
    planes = x1.numel() // (h * w)
    dev = x1.device
    if walk is None:
        walk = launch_walk(planes, h, w)
    if seg is None:
        seg = segment_rows(planes, h, w, _lib.sm_count(dev)) if walk == STRIP_WALK else 0
    taps = _taps()
    out = torch.empty((moments,) + tuple(x1.shape), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(_lib.load(), entry)(*map(_lib.ptr, inputs), _lib.ptr(out), planes, h, w,
                                         walk, seg, _lib.ptr(taps), _lib.stream(dev))
    _lib.check(rc, entry)
    return out


def candidate_moments(x1: torch.Tensor, x2: torch.Tensor):
    """K9.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if x2.device.type == "cpu":
        if x1.device != x2.device:
            raise ValueError("x1 and x2 must be on one device")
        return candidate_moments_plain(x1, x2)
    _check(x1, x2)
    out = _launch("candidate", (x1, x2))
    candidate_moments.launches += 1
    return out[0], out[1], out[2]


candidate_moments.launches = 0
candidate_moments.source = "codec_eval_tpu_torch/csrc/moments.cu"
candidate_moments.replaces = "codec_eval_tpu/kernels/pallas/moments.py:76"


def reference_moments(x1: torch.Tensor):
    """K9's reference form: x1 -> (mu1, s11).  Plain version on CPU tensors;
    the CUDA kernel on CUDA tensors."""
    if x1.device.type == "cpu":
        return reference_moments_plain(x1)
    _check(x1, x1)
    out = _launch("reference", (x1,))
    reference_moments.launches += 1
    return out[0], out[1]


reference_moments.launches = 0
reference_moments.source = candidate_moments.source
reference_moments.replaces = candidate_moments.replaces
