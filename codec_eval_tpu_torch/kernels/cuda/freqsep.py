"""K2 and K3: Butteraugli opsin dynamics and band separation, batched.

``opsin_xyb_batch`` and ``bands_batch`` are the port's counterparts of
``codec_eval_tpu/kernels/pallas/freqsep.py``'s ``opsin_xyb_batch_pallas`` and
``bands_batch_pallas``, with the same arguments.  On a CUDA tensor each
launches its hand-written kernel (``csrc/freqsep.cu``); on a CPU tensor it
runs the plain PyTorch version beside it.  Both compute each blur as a
zero-padded separable FIR multiplied by the reciprocal of the blurred
inside-image indicator (the model's border renormalization).

Rounding: XLA contracts ``a*b + c`` into one fused multiply-add wherever
the product has no other use, and the JAX package's results carry that
rounding; the bands' residuals (XYB - blur, about 1e-3 of their inputs)
amplify any difference.  So the plain versions and the kernels take a fused
multiply-add exactly where XLA does: ``_fma`` below (exact in f64, rounded
once to f32) and ``fmaf`` in the kernels, which are otherwise built with
``-fmad=false``.  Plain version, kernel and the Pallas kernel (run in
interpret mode) then agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..color import rdiv
from . import _lib

SIGMA_SURROUND = 1.2
SIGMA_MF = 3.2248991
SIGMA_UHF = 1.5641633


def _taps64(sigma: float) -> np.ndarray:
    """Butteraugli's unnormalized Gaussian taps, radius int(2.25*sigma)."""
    radius = max(1, int(2.25 * sigma))
    return np.exp(-1.0 / (2.0 * sigma * sigma) * np.arange(-radius, radius + 1) ** 2)


@functools.lru_cache(maxsize=None)
def _taps(sigma: float) -> np.ndarray:
    return _taps64(sigma).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _recip_norm_np(h: int, w: int, sigma: float) -> np.ndarray:
    """1 / (blurred inside-image indicator) as an (h, w) f32 plane: the
    denominator separates into an outer product of 1-D blurred masks."""
    t = _taps64(sigma)
    r = len(t) // 2

    def norm1d(n):
        padded = np.pad(np.ones(n), r)
        out = np.zeros(n)
        for i, tap in enumerate(t):
            out += tap * padded[i : i + n]
        return out

    return (1.0 / np.outer(norm1d(h), norm1d(w))).astype(np.float32)


@functools.lru_cache(maxsize=32)
def recip_norm(h: int, w: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_recip_norm_np(h, w, sigma)).to(device)


def _fma(a, b, c) -> torch.Tensor:
    """f32 ``a*b + c`` rounded once: the product of two f32 is exact in f64.
    Python numbers are first rounded to f32, as JAX's weak types are."""
    def d(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        return float(np.float32(x))

    return (d(a) * d(b) + d(c)).to(torch.float32)


def _fir_fma(planes: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded separable FIR on (..., H, W), vertical pass first, with
    the fused multiply-adds of XLA's tap chain: fma(t0, x0, t1*x1), then
    fma(ti, xi, acc)."""
    t = [float(v) for v in taps]
    r = len(t) // 2
    h, w = planes.shape[-2], planes.shape[-1]

    def chain(pieces):
        acc = _fma(t[0], pieces[0], t[1] * pieces[1])
        for i in range(2, len(t)):
            acc = _fma(t[i], pieces[i], acc)
        return acc

    xp = F.pad(planes, (0, 0, r, r))
    v = chain([xp[..., i : i + h, :] for i in range(len(t))])
    vp = F.pad(v, (r, r))
    return chain([vp[..., :, i : i + w] for i in range(len(t))])


def _fast_log2(x: torch.Tensor) -> torch.Tensor:
    """FastLog2f: exponent by integer bit manipulation, mantissa by a
    rational polynomial."""
    bits = x.to(torch.float32).view(torch.int32)
    e = bits - 0x3F2AAAAB
    exp = e >> 23
    mant = (bits - (exp << 23)).view(torch.float32)
    m = mant - 1.0
    p = _fma(_fma(0.74245876, m, 1.4287161), m, -1.8503833e-06)
    q = _fma(_fma(0.17409343, m, 1.0096718), m, 0.99032813)
    return p / q + exp.to(torch.float32)


# --------------------------------------------------------------------- K2


def opsin_xyb_plain(linear_scaled: torch.Tensor, consts) -> torch.Tensor:
    """(B, 3, H, W) intensity-scaled linear RGB -> (B, 3, H, W) opponent XYB."""
    h, w = linear_scaled.shape[-2], linear_scaled.shape[-1]
    recip = recip_norm(h, w, SIGMA_SURROUND, linear_scaled.device)
    blurred = _fir_fma(linear_scaled, _taps(SIGMA_SURROUND)) * recip
    return opsin_from_blurred(linear_scaled, blurred, consts)


def opsin_from_blurred(linear_scaled: torch.Tensor, blurred: torch.Tensor, consts) -> torch.Tensor:
    """Opsin dynamics after the sigma-1.2 surround blur ``blurred`` of
    ``linear_scaled``, both (B, 3, H, W): sensitivity, absorbance, XYB."""
    (m00, m01, m02, m10, m11, m12, m20, m21, m22,
     b0, b1, b2, gmul, goff, gsub) = consts
    mix = ((m00, m01, m02, b0), (m10, m11, m12, b1), (m20, m21, m22, b2))

    def absorb(p, i):
        a, b, c, bias = mix[i]
        return _fma(c, p[:, 2], _fma(a, p[:, 0], b * p[:, 1])) + bias

    xyb = []
    for i in range(3):
        bias = mix[i][3]
        p = torch.clamp(torch.clamp(absorb(blurred, i), min=bias), min=1e-4)
        gamma = _fma(gmul, _fast_log2(torch.clamp(p, min=0.0) + goff), -gsub)
        sens = torch.clamp(gamma / p, min=1e-4)
        xyb.append(torch.clamp(absorb(linear_scaled, i) * sens, min=bias))
    return torch.stack([xyb[0] - xyb[1], xyb[0] + xyb[1], xyb[2]], dim=1)


@functools.lru_cache(maxsize=8)
def _opsin_args(consts) -> tuple:
    return (
        np.asarray(consts, np.float32),
        np.ascontiguousarray(_taps(SIGMA_SURROUND)),
    )


#: K2's grid: the segment lengths, longest first, and the blocks per SM its
#: grid should give the card (five fit at once: 76 registers, 160 threads).
#: Longer segments re-read fewer halo rows (4 each), but past ~3.5 blocks
#: per SM their long blocks leave SMs idle at the end of the grid; a
#: one-row segment is one row group, the shortest walk for a small image
#: (measured on the H100: PERF.md, §6).
OPSIN_SEGMENTS = (64, 32, 16, 8, 4, 1)
OPSIN_MIN_BLOCKS_PER_SM = 3.5


def opsin_segment_rows(b: int, h: int, w: int, sms: int) -> int:
    """Rows per segment of K2's strips for a (b, h, w) launch on ``sms``
    SMs (``_lib.segment_rows``), so that one image (the single-pair path's
    B = 1) still spreads over the card."""
    return _lib.segment_rows(b * -(-w // _lib.STRIP), h, OPSIN_SEGMENTS,
                             OPSIN_MIN_BLOCKS_PER_SM, sms)


def _opsin_launch(linear_scaled: torch.Tensor, consts, seg=None) -> torch.Tensor:
    """One launch of K2 on a checked CUDA tensor; ``seg`` defaults to
    ``opsin_segment_rows``'s choice."""
    b, _, h, w = linear_scaled.shape
    host_consts, taps = _opsin_args(tuple(consts))
    if len(host_consts) != 15 or len(taps) != 5:
        raise ValueError("opsin kernel takes 15 constants and 5 taps")
    dev = linear_scaled.device
    if seg is None:
        seg = opsin_segment_rows(b, h, w, _lib.sm_count(dev))
    out = torch.empty_like(linear_scaled)
    recip = recip_norm(h, w, SIGMA_SURROUND, dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_opsin_xyb(
            _lib.ptr(linear_scaled), _lib.ptr(recip), _lib.ptr(out), b, h, w, seg,
            _lib.ptr(host_consts), _lib.ptr(taps), _lib.stream(dev),
        )
    _lib.check(rc, "ce_opsin_xyb")
    return out


def opsin_xyb_batch(linear_scaled: torch.Tensor, consts) -> torch.Tensor:
    """K2.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if linear_scaled.device.type == "cpu":
        return opsin_xyb_plain(linear_scaled, consts)
    _lib.require_cuda("linear_scaled", linear_scaled, (None, 3, None, None))
    out = _opsin_launch(linear_scaled, consts)
    opsin_xyb_batch.launches += 1
    return out


opsin_xyb_batch.launches = 0
opsin_xyb_batch.source = "codec_eval_tpu_torch/csrc/freqsep.cu"
opsin_xyb_batch.replaces = "codec_eval_tpu/kernels/pallas/freqsep.py:274"


# --------------------------------------------------------------------- K3


def _remove_range(v, w):
    return torch.where(v > w, v - w, torch.where(v < -w, v + w, torch.zeros_like(v)))


def _amplify_range(v, w):
    return torch.where(v > w, v + w, torch.where(v < -w, v - w, 2.0 * v))


def _maximum_clamp(v, m, mul):
    return torch.where(
        v >= m, _fma(v - m, mul, m), torch.where(v < -m, _fma(v + m, mul, -m), v)
    )


def bands_plain(xyb: torch.Tensor, lf: torch.Tensor, consts) -> torch.Tensor:
    """(B, 3, H, W) XYB and its LF blur -> (B, 7, H, W) band planes in the
    order uhf_x, uhf_y, hf_x, hf_y, mf_x, mf_y, mf_b."""
    (mf_x_remove, mf_y_amplify, uhf_x_remove, hf_x_remove,
     suppress_yw, suppress_s, maxclamp_hf, maxclamp_uhf, maxclamp_mul,
     uhf_y_mul, hf_y_mul, hf_y_amplify) = consts
    h, w = xyb.shape[-2], xyb.shape[-1]
    r332 = recip_norm(h, w, SIGMA_MF, xyb.device)
    r156 = recip_norm(h, w, SIGMA_UHF, xyb.device)
    mf_pre = xyb - lf
    fir332 = _fir_fma(mf_pre, _taps(SIGMA_MF))
    mf_blur = fir332 * r332
    mf_x = _remove_range(mf_blur[:, 0], mf_x_remove)
    mf_y = _amplify_range(mf_blur[:, 1], mf_y_amplify)
    hf0 = _fma(-fir332[:, :2], r332, mf_pre[:, :2])
    # Red-green suppression by luminance change, before the UHF split.
    suppress = suppress_s + rdiv(
        (1.0 - suppress_s) * suppress_yw, _fma(hf0[:, 1], hf0[:, 1], suppress_yw)
    )
    hf = torch.stack([hf0[:, 0] * suppress, hf0[:, 1]], dim=1)
    hf_blur = _fir_fma(hf, _taps(SIGMA_UHF)) * r156
    uhf_x = _remove_range(_fma(hf0[:, 0], suppress, -hf_blur[:, 0]), uhf_x_remove)
    hf_x = _remove_range(hf_blur[:, 0], hf_x_remove)
    hfc = _maximum_clamp(hf_blur[:, 1], maxclamp_hf, maxclamp_mul)
    uhf_y = _maximum_clamp(hf[:, 1] - hfc, maxclamp_uhf, maxclamp_mul) * uhf_y_mul
    hf_y = _amplify_range(hfc * hf_y_mul, hf_y_amplify)
    return torch.stack([uhf_x, uhf_y, hf_x, hf_y, mf_x, mf_y, mf_blur[:, 2]], dim=1)


@functools.lru_cache(maxsize=8)
def _bands_args(consts) -> tuple:
    suppress_yw, suppress_s = consts[4], consts[5]
    return (
        # The kernel takes (1 - s) * yw precomputed, as Python evaluates it.
        np.asarray(tuple(consts) + ((1.0 - suppress_s) * suppress_yw,), np.float32),
        np.ascontiguousarray(_taps(SIGMA_MF)),
        np.ascontiguousarray(_taps(SIGMA_UHF)),
    )


#: K3's grid: blocks resident per SM (registers bound them), the waves of
#: blocks a launch should hold, and the segment lengths, longest first.
BANDS_BLOCKS_PER_SM = 3
BANDS_WAVES = 2
BANDS_SEGMENTS = (256, 128, 64, 32)


def bands_segment_rows(b: int, h: int, w: int, sms: int) -> int:
    """Rows per segment of K3's strips for a (b, h, w) launch on ``sms``
    SMs (``_lib.segment_rows``): ``BANDS_WAVES`` waves of blocks.  A
    segment re-reads its 20 halo rows, so longer is cheaper while the card
    has blocks."""
    return _lib.segment_rows(b * -(-w // _lib.STRIP), h, BANDS_SEGMENTS,
                             BANDS_WAVES * BANDS_BLOCKS_PER_SM, sms)


def bands_batch(xyb: torch.Tensor, lf: torch.Tensor, consts) -> torch.Tensor:
    """K3.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if xyb.device.type == "cpu":
        return bands_plain(xyb, lf, consts)
    _lib.require_cuda("xyb", xyb, (None, 3, None, None))
    _lib.require_cuda("lf", lf, tuple(xyb.shape))
    if lf.device != xyb.device:
        raise ValueError("xyb and lf must be on one device")
    b, _, h, w = xyb.shape
    host_consts, t332, t156 = _bands_args(tuple(consts))
    if len(host_consts) != 13 or len(t332) != 15 or len(t156) != 7:
        raise ValueError("bands kernel takes 12 constants, 15 and 7 taps")
    dev = xyb.device
    out = torch.empty((b, 7, h, w), dtype=torch.float32, device=dev)
    r332 = recip_norm(h, w, SIGMA_MF, dev)
    r156 = recip_norm(h, w, SIGMA_UHF, dev)
    seg = bands_segment_rows(b, h, w, _lib.sm_count(dev))
    with torch.cuda.device(dev):
        rc = _lib.load().ce_bands(
            _lib.ptr(xyb), _lib.ptr(lf), _lib.ptr(r332), _lib.ptr(r156), _lib.ptr(out),
            b, h, w, seg, _lib.ptr(host_consts), _lib.ptr(t332), _lib.ptr(t156),
            _lib.stream(dev),
        )
    _lib.check(rc, "ce_bands")
    bands_batch.launches += 1
    return out


bands_batch.launches = 0
bands_batch.source = "codec_eval_tpu_torch/csrc/freqsep.cu"
bands_batch.replaces = "codec_eval_tpu/kernels/pallas/freqsep.py:485"
