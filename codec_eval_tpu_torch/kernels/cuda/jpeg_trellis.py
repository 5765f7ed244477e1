"""K10: the trellis DP of the device JPEG encoder (``csrc/jpeg_trellis.cu``).

``trellis_dp`` launches it on CUDA tensors, counting its launches in
``trellis_dp.launches`` and the blocks it quantizes in the
``jpeg.trellis_blocks`` counter.  ``kernels.jpeg_enc.trellis_quantize_dev``
calls it for CUDA tensors and runs the plain version beside it
(``trellis_quantize_plain``) for CPU tensors.  The kernel takes the DP's
one broadcast, a ladder: (..., 64) coefficients against n_q rows of 64
steps, read as (n_blocks, 64) against (n_q, 64), so the
(n_q, n_blocks, 64) ``|F| / q`` is never written.  ``ladder_form`` maps
the shapes onto that form and refuses any other broadcast.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...utils.profiling import count
from . import _lib

#: Warps (one block of 64 coefficients each) per CTA (``kWarps``).
WARPS = 8
#: CTAs per SM at most; a larger launch walks its blocks with a grid stride.
CTAS_PER_SM = 8


def ladder_form(dct_shape: Tuple[int, ...], q_shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(n_q, n_blocks) of coefficients of shape ``dct_shape`` (..., 64)
    against steps of shape ``q_shape``: a ladder, (n_q, 1, ..., 1, 64) with
    one more axis than the coefficients, as ``reconstruct_sweep`` passes
    them ((n_q, 1, 1, 64) for a (by, bx, 64) plane, (n_q, 1, 1, 1, 64) for
    stacked chroma), or one quality's steps, (64,) or (1, ..., 1, 64) of at
    most the coefficients' rank, n_q = 1.  Raises ``ValueError`` on any
    other broadcast."""
    dct_shape, q_shape = tuple(dct_shape), tuple(q_shape)
    lead = len(q_shape) - len(dct_shape)  # the ladder axis, if 1
    if (len(dct_shape) < 1 or dct_shape[-1] != 64 or not q_shape or q_shape[-1] != 64
            or lead > 1 or any(d != 1 for d in q_shape[max(lead, 0):-1])):
        raise ValueError(f"trellis kernel: steps {q_shape} do not form a ladder over "
                         f"coefficients {dct_shape}; it takes (..., 64) against "
                         "(n_q, 1, ..., 1, 64) or one quality's (1, ..., 1, 64)")
    n_blocks = 1
    for d in dct_shape[:-1]:
        n_blocks *= d
    return (q_shape[0] if lead == 1 else 1), n_blocks


def grid(total_blocks: int, sms: int) -> int:
    """CTAs for ``total_blocks`` blocks of 64 on a card of ``sms`` SMs."""
    return min(-(-total_blocks // WARPS), CTAS_PER_SM * sms)


def trellis_dp(dct: torch.Tensor, q: torch.Tensor, rates: np.ndarray, eob: float) -> torch.Tensor:
    """One launch of K10: ``dct`` (..., 64) f32 CUDA coefficients, ``q``
    f32 steps on its device in a form ``ladder_form`` takes (a ladder's
    strided view of its tables is read in place; steps strided along the
    last axis are copied first), ``rates`` the (11, 63) f32 table
    lam * RT[r, s] at [s, r], ``eob`` lam times the EOB code length ->
    f32 of the broadcast shape: (n_q, ..., 64) for a ladder, the
    coefficients' shape for one quality's steps."""
    n_q, n_blocks = ladder_form(dct.shape, q.shape)
    _lib.require_cuda("dct_zz", dct, tuple(dct.shape))
    if q.device != dct.device or q.dtype != torch.float32:
        raise ValueError("trellis kernel: steps must be f32 on the coefficients' device")
    if rates.dtype != np.float32 or rates.shape != (11, 63) or not rates.flags.c_contiguous:
        raise ValueError("trellis kernel: rates must be a C-contiguous (11, 63) f32 array")
    shape = (n_q, *dct.shape) if q.dim() > dct.dim() else dct.shape
    q = q.reshape(n_q, 64)
    if q.stride(-1) != 1:
        q = q.contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=dct.device)
    if out.numel() == 0:
        return out
    dev = dct.get_device()
    rc = _lib.launch(_lib.load().ce_trellis_dp, dev, dct.data_ptr(), q.data_ptr(),
                     out.data_ptr(), n_q, n_blocks, q.stride(0),
                     grid(n_q * n_blocks, _lib.sm_count(dct.device)), _lib.ptr(rates), float(eob))
    _lib.check(rc, "ce_trellis_dp")
    trellis_dp.launches += 1
    count("jpeg.trellis_blocks", n_q * n_blocks)
    return out


trellis_dp.launches = 0
trellis_dp.source = "codec_eval_tpu_torch/csrc/jpeg_trellis.cu"
#: No Pallas kernel: the JAX package's DP is a ``jax.lax.scan`` in jnp.
trellis_dp.replaces = "codec_eval_tpu/kernels/jpeg_enc.py:904"
