"""Butteraugli, the exact (unmasked) batch path: a frozen copy of commit
80b80d3's ``codec_eval_tpu_torch/kernels/butteraugli.py`` batch route with
each hand-written kernel replaced by its plain version, copied beside it:
K2 ``opsin_xyb_plain`` and K3 ``bands_plain`` (``kernels/cuda/freqsep.py``),
K4 ``malta_ac_plain`` and K5 ``malta_diffmap_plain`` (``kernels/cuda/malta.py``),
K6 ``blur_batch_plain`` (``kernels/cuda/blur.py``).  The size routes are the
port's: the whole-diffmap form on planes of 1400 px and more, the FIR mask
blur on planes of 1024 px and more; they change only the order of sums.

The LF and mask blurs are dense operator products (matmuls), f32 with TF32
off as the port states; the control runs them with TF32 on."""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .color import rdiv

SIGMA_SURROUND = 1.2
SIGMA_MF = 3.2248991
SIGMA_UHF = 1.5641633
SIGMA_LF = 7.1559334
SIGMA_MASK = 2.7

_FUSED_EPI_MIN_SIDE = 1400
_BLUR_FIR_MIN_SIDE = 1024
_BLUR_FIR_MAX_TAPS = 16

_OPSIN = np.array(
    [
        [0.29956549, 0.63373089, 0.077705614],
        [0.22158691, 0.69391388, 0.098731361],
        [0.02, 0.02, 0.20480129],
    ],
    np.float32,
)
_OPSIN_BIAS = np.array([1.7557484, 1.7557484, 12.226455], np.float32)
_GAMMA_MUL = 13.339627
_GAMMA_OFF = 9.9710636
_GAMMA_SUB = 23.160463

_XLF_X = 32.221748
_XLF_Y = 13.769779
_XLF_B = 47.504616
_XLF_Y_TO_B = -0.36226705

_MF_X_REMOVE = 0.29
_MF_Y_AMPLIFY = 0.1
_UHF_X_REMOVE = 0.04
_HF_X_REMOVE = 1.5
_SUPPRESS_YW = 46.0
_SUPPRESS_S = 0.6530205607414246
_MAXCLAMP_HF = 28.469181
_MAXCLAMP_UHF = 5.1917529
_MAXCLAMP_MUL = 0.72421616
_UHF_Y_MUL = 2.6931376
_HF_Y_MUL = 2.155
_HF_Y_AMPLIFY = 0.132

_W_UHF_MALTA = 1.10039032555
_NORM1_UHF = 71.7800275169
_W_UHF_MALTA_X = 173.5
_NORM1_UHF_X = 5.0
_W_HF_MALTA = 18.7237414387
_NORM1_HF = 4498534.45232
_W_HF_MALTA_X = 6923.99476109
_NORM1_HF_X = 8051.15833247
_W_MF_MALTA = 37.0819870399
_NORM1_MF = 130262059.556
_W_MF_MALTA_X = 8246.75321353
_NORM1_MF_X = 1009002.70582
_MALTA_MULLI = 0.39905817637
_MALTA_MULLI_LF = 0.611612573796
_MALTA_LEN = 3.75
_MALTA_W0 = 0.5
_MALTA_W1 = 0.33000001311302185

_WMUL = (
    400.0, 1.50815703118, 0.0,
    2150.0, 10.6195433239, 16.2176043152,
    29.2353797994, 0.844626970982, 0.703646627719,
)

_MASK_HF_MUL = 2.5
_MASK_UHF_MUL = 0.4
_DIFF_PRE_MUL = 6.1942406
_DIFF_PRE_BIAS = 12.610506
_MASK_DIFF_AC_MUL = 10.0
_MASKY = (0.451936922203, 0.829591754942, 2.5485944793)
_MASKDCY = (3.87449418804, 0.20025578522, 0.505054525019)
_MASK_GLOBAL_SCALE = 0.0710417702794075

_SUPERSAMPLE_W = 0.5
_SUPERSAMPLE_KEEP = 0.85

HF_ASYMMETRY = 0.8
XMUL = 1.0
INTENSITY_TARGET = 80.0

MALTA_RADIUS = 4
LINES_FULL = (
    (1.0, tuple((k, k) for k in range(-3, 4))),
    (1.0, tuple((k, -k) for k in range(-3, 4))),
    (2.0, ((-4, -1), (-3, -1), (-2, -1), (-1, 0), (0, 0), (1, 0), (2, 1), (3, 1), (4, 1))),
    (2.0, ((-4, 1), (-3, 1), (-2, 1), (-1, 0), (0, 0), (1, 0), (2, -1), (3, -1), (4, -1))),
    (2.0, ((-1, -4), (-1, -3), (-1, -2), (0, -1), (0, 0), (0, 1), (1, 2), (1, 3), (1, 4))),
    (2.0, ((-1, 2), (-1, 3), (-1, 4), (0, -1), (0, 0), (0, 1), (1, -4), (1, -3), (1, -2))),
    (1.0, tuple((k, 0) for k in range(-4, 5))),
    (1.0, tuple((0, k) for k in range(-4, 5))),
    (1.0, ((-3, -2), (-2, -1), (-1, -1), (0, 0), (1, 1), (2, 1), (3, 2))),
    (1.0, ((-3, 2), (-2, 1), (-1, 1), (0, 0), (1, -1), (2, -1), (3, -2))),
    (1.0, ((-2, -3), (-1, -2), (-1, -1), (0, 0), (1, 1), (1, 2), (2, 3))),
    (1.0, ((-2, 3), (-1, 1), (-1, 2), (0, 0), (1, -2), (1, -1), (2, -3))),
)
LINES_LF = (
    (1.0, ((-4, -2), (-2, -1), (0, 0), (2, 1), (4, 2))),
    (1.0, ((-4, 2), (-2, 1), (0, 0), (2, -1), (4, -2))),
    (1.0, ((-2, -4), (-1, -2), (0, 0), (1, 2), (2, 4))),
    (1.0, ((-2, 4), (-1, 2), (0, 0), (1, -2), (2, -4))),
    (1.0, ((-3, -3), (-2, -2), (0, 0), (2, 2), (3, 3))),
    (1.0, ((-3, 3), (-2, 2), (0, 0), (2, -2), (3, -3))),
    (1.0, ((-4, -1), (-2, -1), (0, 0), (2, 1), (4, 1))),
    (1.0, ((-4, 1), (-2, 1), (0, 0), (2, -1), (4, -1))),
    (1.0, ((-1, -4), (-1, -2), (0, 0), (1, 2), (1, 4))),
    (1.0, ((-1, 2), (-1, 4), (0, 0), (1, -4), (1, -2))),
    (1.0, ((-4, 0), (-2, 0), (0, 0), (2, 0), (4, 0))),
    (1.0, ((0, -4), (0, -2), (0, 0), (0, 2), (0, 4))),
    (1.0, ((-3, -2), (-2, -1), (0, 0), (2, 1), (3, 2))),
    (1.0, ((-3, 2), (-2, 1), (0, 0), (2, -1), (3, -2))),
    (1.0, ((-2, -3), (-1, -2), (0, 0), (1, 2), (2, 3))),
    (1.0, ((-2, 3), (-1, 2), (0, 0), (1, -2), (2, -3))),
)
#: (dest accumulator, pattern) per diff plane: uhf_y, uhf_x, hf_y, hf_x, mf_y, mf_x.
_CHANNEL_SPEC = ((1, "full"), (0, "full"), (1, "lf"), (0, "lf"), (1, "lf"), (0, "lf"))
# (band, channel, asym_kind, weight, norm1, mulli), in the order of the diff planes.
_MALTA_CALLS = (
    ("uhf", 1, "a", _W_UHF_MALTA, _NORM1_UHF, _MALTA_MULLI),
    ("uhf", 0, "a", _W_UHF_MALTA_X, _NORM1_UHF_X, _MALTA_MULLI),
    ("hf", 1, "sqrt_a", _W_HF_MALTA, _NORM1_HF, _MALTA_MULLI_LF),
    ("hf", 0, "sqrt_a", _W_HF_MALTA_X, _NORM1_HF_X, _MALTA_MULLI_LF),
    ("mf", 1, "none", _W_MF_MALTA, _NORM1_MF, _MALTA_MULLI_LF),
    ("mf", 0, "none", _W_MF_MALTA_X, _NORM1_MF_X, _MALTA_MULLI_LF),
)


@dataclass
class PsychoImage:
    uhf: torch.Tensor
    hf: torch.Tensor
    mf: torch.Tensor
    lf: torch.Tensor


# ---------------------------------------------------------------- blurs


def _taps64(sigma: float) -> np.ndarray:
    radius = max(1, int(2.25 * sigma))
    return np.exp(-1.0 / (2.0 * sigma * sigma) * np.arange(-radius, radius + 1) ** 2)


@functools.lru_cache(maxsize=None)
def _taps(sigma: float) -> np.ndarray:
    return _taps64(sigma).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _recip_norm_np(h: int, w: int, sigma: float) -> np.ndarray:
    """1 / (blurred inside-image indicator), an (h, w) f32 plane."""
    t = _taps64(sigma)
    r = len(t) // 2

    def norm1d(n):
        padded = np.pad(np.ones(n), r)
        out = np.zeros(n)
        for i, tap in enumerate(t):
            out += tap * padded[i : i + n]
        return out

    return (1.0 / np.outer(norm1d(h), norm1d(w))).astype(np.float32)


def _recip_norm(h: int, w: int, sigma: float, device) -> torch.Tensor:
    return torch.from_numpy(_recip_norm_np(h, w, sigma)).to(device)


@functools.lru_cache(maxsize=64)
def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) row-normalized banded Toeplitz blur operator."""
    radius = max(1, int(2.25 * sigma))
    taps = np.exp(-1.0 / (2.0 * sigma * sigma) * np.arange(-radius, radius + 1) ** 2)
    m = np.zeros((n, n), np.float64)
    for i, t in enumerate(taps):
        k = i - radius
        idx = np.arange(max(0, -k), min(n, n - k))
        m[idx, idx + k] = t
    m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


def _blur(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """Renormalized Gaussian of (..., H, W) planes as two operator products."""
    h, w = planes.shape[-2], planes.shape[-1]
    bh = torch.from_numpy(_blur_matrix(h, sigma)).to(planes.device)
    bw = torch.from_numpy(_blur_matrix(w, sigma)).to(planes.device)
    return torch.matmul(torch.matmul(bh, planes), bw.T)


def _fma(a, b, c) -> torch.Tensor:
    """f32 ``a*b + c`` rounded once (the product of two f32 is exact in f64)."""
    def d(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        return float(np.float32(x))

    return (d(a) * d(b) + d(c)).to(torch.float32)


def _fir_fma(planes: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded separable FIR, vertical first, with XLA's fused tap chain."""
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


def _fir_blur(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """K6's plain version: zero-padded FIR times the reciprocal plane."""
    h, w = planes.shape[-2], planes.shape[-1]
    return _fir_separable(planes, _taps(sigma)) * _recip_norm(h, w, sigma, planes.device)


def _fir_separable(planes: torch.Tensor, taps) -> torch.Tensor:
    k = len(taps)
    r = k // 2
    h, w = planes.shape[-2], planes.shape[-1]
    xp = F.pad(planes, (0, 0, r, r))
    out = float(taps[0]) * xp[..., 0:h, :]
    for i in range(1, k):
        out = out + float(taps[i]) * xp[..., i : i + h, :]
    xp = F.pad(out, (r, r))
    out = float(taps[0]) * xp[..., :, 0:w]
    for i in range(1, k):
        out = out + float(taps[i]) * xp[..., :, i : i + w]
    return out


# -------------------------------------------------------- opsin and bands


def _fast_log2(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).view(torch.int32)
    e = bits - 0x3F2AAAAB
    exp = e >> 23
    mant = (bits - (exp << 23)).view(torch.float32)
    m = mant - 1.0
    p = _fma(_fma(0.74245876, m, 1.4287161), m, -1.8503833e-06)
    q = _fma(_fma(0.17409343, m, 1.0096718), m, 0.99032813)
    return p / q + exp.to(torch.float32)


def _opsin_xyb(linear_scaled: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) intensity-scaled linear RGB -> opponent XYB (K2's plain version)."""
    h, w = linear_scaled.shape[-2], linear_scaled.shape[-1]
    recip = _recip_norm(h, w, SIGMA_SURROUND, linear_scaled.device)
    blurred = _fir_fma(linear_scaled, _taps(SIGMA_SURROUND)) * recip
    m = [float(v) for v in _OPSIN.reshape(-1)]
    bias = [float(v) for v in _OPSIN_BIAS]
    mix = ((m[0], m[1], m[2], bias[0]), (m[3], m[4], m[5], bias[1]), (m[6], m[7], m[8], bias[2]))

    def absorb(p, i):
        a, b, c, bb = mix[i]
        return _fma(c, p[:, 2], _fma(a, p[:, 0], b * p[:, 1])) + bb

    xyb = []
    for i in range(3):
        bb = mix[i][3]
        p = torch.clamp(torch.clamp(absorb(blurred, i), min=bb), min=1e-4)
        gamma = _fma(_GAMMA_MUL, _fast_log2(torch.clamp(p, min=0.0) + _GAMMA_OFF), -_GAMMA_SUB)
        sens = torch.clamp(gamma / p, min=1e-4)
        xyb.append(torch.clamp(absorb(linear_scaled, i) * sens, min=bb))
    return torch.stack([xyb[0] - xyb[1], xyb[0] + xyb[1], xyb[2]], dim=1)


def _remove_range(v, w):
    return torch.where(v > w, v - w, torch.where(v < -w, v + w, torch.zeros_like(v)))


def _amplify_range(v, w):
    return torch.where(v > w, v + w, torch.where(v < -w, v - w, 2.0 * v))


def _maximum_clamp(v, m, mul):
    return torch.where(
        v >= m, _fma(v - m, mul, m), torch.where(v < -m, _fma(v + m, mul, -m), v)
    )


def _bands(xyb: torch.Tensor, lf: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) XYB and its LF blur -> (B, 7, H, W): uhf_x, uhf_y, hf_x,
    hf_y, mf_x, mf_y, mf_b (K3's plain version)."""
    h, w = xyb.shape[-2], xyb.shape[-1]
    r332 = _recip_norm(h, w, SIGMA_MF, xyb.device)
    r156 = _recip_norm(h, w, SIGMA_UHF, xyb.device)
    mf_pre = xyb - lf
    fir332 = _fir_fma(mf_pre, _taps(SIGMA_MF))
    mf_blur = fir332 * r332
    mf_x = _remove_range(mf_blur[:, 0], _MF_X_REMOVE)
    mf_y = _amplify_range(mf_blur[:, 1], _MF_Y_AMPLIFY)
    hf0 = _fma(-fir332[:, :2], r332, mf_pre[:, :2])
    suppress = _SUPPRESS_S + rdiv(
        (1.0 - _SUPPRESS_S) * _SUPPRESS_YW, _fma(hf0[:, 1], hf0[:, 1], _SUPPRESS_YW)
    )
    hf = torch.stack([hf0[:, 0] * suppress, hf0[:, 1]], dim=1)
    hf_blur = _fir_fma(hf, _taps(SIGMA_UHF)) * r156
    uhf_x = _remove_range(_fma(hf0[:, 0], suppress, -hf_blur[:, 0]), _UHF_X_REMOVE)
    hf_x = _remove_range(hf_blur[:, 0], _HF_X_REMOVE)
    hfc = _maximum_clamp(hf_blur[:, 1], _MAXCLAMP_HF, _MAXCLAMP_MUL)
    uhf_y = _maximum_clamp(hf[:, 1] - hfc, _MAXCLAMP_UHF, _MAXCLAMP_MUL) * _UHF_Y_MUL
    hf_y = _amplify_range(hfc * _HF_Y_MUL, _HF_Y_AMPLIFY)
    return torch.stack([uhf_x, uhf_y, hf_x, hf_y, mf_x, mf_y, mf_blur[:, 2]], dim=1)


def _psycho_batch(lin_scaled: torch.Tensor) -> PsychoImage:
    xyb = _opsin_xyb(lin_scaled.contiguous())
    lf = _blur(xyb, SIGMA_LF).contiguous()
    bands = _bands(xyb, lf)
    lf_vals = torch.stack(
        [lf[:, 0] * _XLF_X, lf[:, 1] * _XLF_Y, (lf[:, 2] + _XLF_Y_TO_B * lf[:, 1]) * _XLF_B],
        dim=1,
    )
    return PsychoImage(uhf=bands[:, 0:2], hf=bands[:, 2:4], mf=bands[:, 4:7], lf=lf_vals)


def _index(pi: PsychoImage, i: int) -> PsychoImage:
    return PsychoImage(uhf=pi.uhf[i], hf=pi.hf[i], mf=pi.mf[i], lf=pi.lf[i])


# ----------------------------------------------------------------- Malta


def _malta_sweep(plane: torch.Tensor, lines) -> torch.Tensor:
    r = MALTA_RADIUS
    h, w = plane.shape[-2], plane.shape[-1]
    pad = F.pad(plane, (r, r, r, r))
    acc = torch.zeros_like(plane)
    for weight, line in lines:
        s = None
        for dy, dx in line:
            piece = pad[..., r + dy : r + dy + h, r + dx : r + dx + w]
            s = piece if s is None else s + piece
        acc = acc + weight * (s * s)
    return acc


def _malta_ac(diffs: torch.Tensor) -> torch.Tensor:
    """(B, 6, H, W) diff planes -> (B, 2, H, W) accumulators (K4's plain version)."""
    acc = [None, None]
    for i, (dest, kind) in enumerate(_CHANNEL_SPEC):
        term = _malta_sweep(diffs[:, i], LINES_FULL if kind == "full" else LINES_LF)
        acc[dest] = term if acc[dest] is None else acc[dest] + term
    return torch.stack(acc, dim=1)


def _malta_prologue(l0, l1, n2g: float, n2l: float, n1: float) -> torch.Tensor:
    diff = l0 - l1
    denom = n1 + 0.5 * (torch.abs(l0) + torch.abs(l1))
    diffs = rdiv(n2g, denom) * diff
    scaler2 = rdiv(n2l, denom)
    fabs0 = torch.abs(l0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    zero = torch.zeros_like(diff)
    impact_pos = torch.where(
        l1 < too_small,
        scaler2 * (too_small - l1),
        torch.where(l1 > too_big, -scaler2 * (l1 - too_big), zero),
    )
    impact_neg = torch.where(
        l1 > -too_small,
        -scaler2 * (l1 + too_small),
        torch.where(l1 < -too_big, scaler2 * (-l1 - too_big), zero),
    )
    return diffs + torch.where(l0 >= 0, impact_pos, impact_neg)


def _l2_asymmetric(v0, v1, k_gt: float, k_lt: float) -> torch.Tensor:
    d = v0 - v1
    total = k_gt * d * d
    fabs0 = torch.abs(v0)
    too_small = 0.4 * fabs0
    zero = torch.zeros_like(d)
    pos = torch.where(v1 < too_small, too_small - v1, torch.where(v1 > fabs0, v1 - fabs0, zero))
    neg = torch.where(v1 > -too_small, v1 + too_small, torch.where(v1 < -fabs0, -v1 - fabs0, zero))
    v = torch.where(v0 < 0, neg, pos)
    return total + k_lt * v * v


def _asym_weights(kind: str, wbase: float) -> Tuple[float, float]:
    a = np.float32(HF_ASYMMETRY)
    sqrt_a = np.sqrt(a)
    if kind == "a":
        return float(np.float32(wbase) * a), float(np.float32(wbase) / a)
    if kind == "sqrt_a":
        return float(np.float32(wbase) * sqrt_a), float(np.float32(wbase) / sqrt_a)
    return float(np.float32(wbase)), float(np.float32(wbase))


def _malta_diffs_stack(pi0: PsychoImage, pi1: PsychoImage) -> torch.Tensor:
    """The six asymmetric diff planes, weights rounded to f32 at each step."""
    f = np.float32
    den = f(_MALTA_LEN * 2 + 1)
    planes = []
    for band, ch, kind, wbase, norm1, mulli in _MALTA_CALLS:
        wg, wl = _asym_weights(kind, wbase)
        n2g = float(f(mulli) * np.sqrt(f(_MALTA_W0) * f(wg)) / den * f(norm1))
        n2l = float(f(mulli) * np.sqrt(f(_MALTA_W1) * f(wl)) / den * f(norm1))
        planes.append(_malta_prologue(getattr(pi0, band)[..., ch, :, :],
                                      getattr(pi1, band)[..., ch, :, :], n2g, n2l, norm1))
    return torch.stack(planes, dim=-3)


# ------------------------------------------------------------ masks


def _combine_channels_for_masking(pi: PsychoImage) -> torch.Tensor:
    xdiff = (pi.uhf[..., 0, :, :] + pi.hf[..., 0, :, :]) * _MASK_HF_MUL
    ydiff = pi.uhf[..., 1, :, :] * _MASK_UHF_MUL + pi.hf[..., 1, :, :] * _MASK_UHF_MUL
    return torch.sqrt(xdiff * xdiff + ydiff * ydiff)


def _diff_precompute(v: torch.Tensor) -> torch.Tensor:
    bias = _DIFF_PRE_MUL * _DIFF_PRE_BIAS
    return torch.sqrt(_DIFF_PRE_MUL * torch.abs(v) + bias) - math.sqrt(bias)


def _fuzzy_erosion(v: torch.Tensor) -> torch.Tensor:
    h, w = v.shape[-2], v.shape[-1]
    big = float(np.finfo(np.float32).max / 4)
    padded = F.pad(v, (3, 3, 3, 3), value=big)
    cands = [v, 2.0 * v, 2.0 * v]
    for dy in (-3, 0, 3):
        for dx in (-3, 0, 3):
            if dy == 0 and dx == 0:
                continue
            cands.append(padded[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w])
    smallest = torch.topk(torch.stack(cands, dim=-1), 3, dim=-1, largest=False, sorted=True)[0]
    return 0.45 * smallest[..., 0] + 0.3 * smallest[..., 1] + 0.25 * smallest[..., 2]


def _mask_response(d: torch.Tensor, consts) -> torch.Tensor:
    scaler, offset, mul = consts
    c = rdiv(mul, scaler * d + offset)
    retval = _MASK_GLOBAL_SCALE * (1.0 + c)
    return retval * retval


def _mask_pre_of(pi0: PsychoImage):
    b0 = _blur(_diff_precompute(_combine_channels_for_masking(pi0)), SIGMA_MASK)
    mask = _fuzzy_erosion(b0)
    return (b0, _mask_response(mask, _MASKY), _mask_response(mask, _MASKDCY))


def _mask_diff_ac(pi1: PsychoImage, b0: torch.Tensor, route_hw: tuple) -> torch.Tensor:
    d1 = _diff_precompute(_combine_channels_for_masking(pi1))
    ntaps = 2 * max(1, int(2.25 * SIGMA_MASK)) + 1
    if min(route_hw) >= _BLUR_FIR_MIN_SIDE and ntaps <= _BLUR_FIR_MAX_TAPS:
        b1 = _fir_blur(d1[:, None].contiguous(), SIGMA_MASK)[:, 0]
    else:
        b1 = _blur(d1, SIGMA_MASK)
    return _MASK_DIFF_AC_MUL * (b0 - b1) * (b0 - b1)


# ----------------------------------------------------------------- diffmap


def _diffmap_psycho(pi0, pi1, malta_ac, mask_pre, diff_ac) -> torch.Tensor:
    a = np.float32(HF_ASYMMETRY)
    ac0, ac1 = malta_ac[:, 0], malta_ac[:, 1]
    w0 = np.float32(_WMUL[0])
    w1 = np.float32(_WMUL[1])

    def l2(v0, v1, wg, wl):
        return _l2_asymmetric(v0, v1, float(np.float32(0.8) * np.float32(wg)),
                              float(np.float32(0.8) * np.float32(wl)))

    ac0 = ac0 + l2(pi0.hf[..., 0, :, :], pi1.hf[:, 0], float(w0 * a), float(w0 / a))
    ac1 = ac1 + l2(pi0.hf[..., 1, :, :], pi1.hf[:, 1], float(w1 * a), float(w1 / a))
    d_mf = pi0.mf - pi1.mf
    wmf = torch.tensor(_WMUL[3:6], dtype=torch.float32, device=d_mf.device)[:, None, None]
    ac_mf = wmf * d_mf * d_mf
    ac0 = ac0 + ac_mf[:, 0]
    ac1 = ac1 + ac_mf[:, 1]
    ac2 = torch.zeros_like(ac0) + ac_mf[:, 2]
    d_lf = pi0.lf - pi1.lf
    wlf = torch.tensor(_WMUL[6:9], dtype=torch.float32, device=d_lf.device)[:, None, None]
    dc = wlf * d_lf * d_lf
    _b0, maskval, dc_maskval = mask_pre
    ac1 = ac1 + diff_ac
    total = dc_maskval * (XMUL * dc[:, 0] + dc[:, 1] + dc[:, 2]) + maskval * (
        XMUL * ac0 + ac1 + ac2
    )
    return torch.sqrt(torch.clamp(total, min=0.0))


def _fused_diffmap(pi0: PsychoImage, pi1: PsychoImage, mask_pre, dac) -> torch.Tensor:
    """K5's plain version with its constants resolved in Python doubles."""
    a = float(HF_ASYMMETRY)
    sqrt_a = math.sqrt(a)
    ch_consts = []
    for _band, _ch, kind, wbase, norm1, mulli in _MALTA_CALLS:
        if kind == "a":
            wg, wl = wbase * a, wbase / a
        elif kind == "sqrt_a":
            wg, wl = wbase * sqrt_a, wbase / sqrt_a
        else:
            wg = wl = wbase
        den = _MALTA_LEN * 2 + 1
        ch_consts.append((mulli * math.sqrt(_MALTA_W0 * wg) / den * norm1,
                          mulli * math.sqrt(_MALTA_W1 * wl) / den * norm1, norm1))
    (l2x_g, l2x_l, l2y_g, l2y_l, w_mfx, w_mfy, w_mfb, w_lfx, w_lfy, w_lfb, xmul) = (
        _WMUL[0] * a, _WMUL[0] / a, _WMUL[1] * a, _WMUL[1] / a,
        _WMUL[3], _WMUL[4], _WMUL[5], _WMUL[6], _WMUL[7], _WMUL[8], float(XMUL),
    )
    cand6 = torch.stack(
        [pi1.uhf[:, 1], pi1.uhf[:, 0], pi1.hf[:, 1], pi1.hf[:, 0], pi1.mf[:, 1], pi1.mf[:, 0]],
        dim=1,
    )
    ref6 = torch.stack([pi0.uhf[1], pi0.uhf[0], pi0.hf[1], pi0.hf[0], pi0.mf[1], pi0.mf[0]])
    crest = torch.cat([pi1.mf[:, 2:3], pi1.lf], dim=1)
    rrest = torch.cat([pi0.mf[2:3], pi0.lf], dim=0)
    masks = (mask_pre[1], mask_pre[2])
    diffs = torch.stack(
        [_malta_prologue(ref6[c], cand6[:, c], *ch_consts[c]) for c in range(6)], dim=1
    )
    ac = _malta_ac(diffs)
    ac0 = ac[:, 0] + _l2_asymmetric(ref6[3], cand6[:, 3], 0.8 * l2x_g, 0.8 * l2x_l)
    ac1 = ac[:, 1] + _l2_asymmetric(ref6[2], cand6[:, 2], 0.8 * l2y_g, 0.8 * l2y_l)
    d_mfx = ref6[5] - cand6[:, 5]
    ac0 = ac0 + w_mfx * d_mfx * d_mfx
    d_mfy = ref6[4] - cand6[:, 4]
    ac1 = ac1 + w_mfy * d_mfy * d_mfy
    d_mfb = rrest[0] - crest[:, 0]
    ac2 = w_mfb * d_mfb * d_mfb
    ac1 = ac1 + dac
    d_lfx = rrest[1] - crest[:, 1]
    d_lfy = rrest[2] - crest[:, 2]
    d_lfb = rrest[3] - crest[:, 3]
    dc = xmul * (w_lfx * d_lfx * d_lfx) + w_lfy * d_lfy * d_lfy + w_lfb * d_lfb * d_lfb
    total = masks[1] * dc + masks[0] * (xmul * ac0 + ac1 + ac2)
    return torch.sqrt(torch.clamp(total, min=0.0))


def _subsample2x(planes: torch.Tensor) -> torch.Tensor:
    h, w = planes.shape[-2], planes.shape[-1]
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    p = F.pad(planes, (0, pw - w, 0, ph - h))
    p = p.reshape(planes.shape[:-2] + (ph // 2, 2, pw // 2, 2))
    out = 0.25 * p.sum(dim=(-3, -1))
    if h % 2:
        out = torch.cat([out[..., :-1, :], out[..., -1:, :] * 2.0], dim=-2)
    if w % 2:
        out = torch.cat([out[..., :, :-1], out[..., :, -1:] * 2.0], dim=-1)
    return out


# -------------------------------------------------------------- scoring


@dataclass
class ButteraugliReference:
    pi0_full: Optional[PsychoImage]
    pi0_sub: Optional[PsychoImage]
    shape: Tuple[int, int]
    mask_full: Optional[tuple] = None
    mask_sub: Optional[tuple] = None


def precompute_butteraugli_reference(lin0: torch.Tensor) -> ButteraugliReference:
    """lin0: the reference's (3, H, W) linear RGB in [0, 1]."""
    h, w = lin0.shape[-2], lin0.shape[-1]
    it = float(np.float32(INTENSITY_TARGET))
    if h < 8 or w < 8:
        return ButteraugliReference(None, None, (h, w))
    pi0_full = _index(_psycho_batch(lin0[None] * it), 0)
    pi0_sub = None
    if (h + 1) // 2 >= 8 and (w + 1) // 2 >= 8:
        pi0_sub = _index(_psycho_batch(_subsample2x(lin0)[None] * it), 0)
    return ButteraugliReference(
        pi0_full, pi0_sub, (h, w), _mask_pre_of(pi0_full),
        _mask_pre_of(pi0_sub) if pi0_sub is not None else None,
    )


def _resolve(ref_pi, pi1, mask_pre, route_hw) -> torch.Tensor:
    dac = _mask_diff_ac(pi1, mask_pre[0], route_hw)
    if min(route_hw) >= _FUSED_EPI_MIN_SIDE:
        return _fused_diffmap(ref_pi, pi1, mask_pre, dac)
    ac = _malta_ac(_malta_diffs_stack(ref_pi, pi1).contiguous())
    return _diffmap_psycho(ref_pi, pi1, ac, mask_pre, dac)


def butteraugli_batch(ref: ButteraugliReference, lin_full: torch.Tensor) -> torch.Tensor:
    """Scores of (N, 3, H, W) linear RGB candidates against a precomputed
    reference: the max of the distance map.  Under 8 px a side: 0."""
    h, w = ref.shape
    if h < 8 or w < 8:
        return torch.zeros(lin_full.shape[0], dtype=torch.float32, device=lin_full.device)
    it = float(np.float32(INTENSITY_TARGET))
    result = _resolve(ref.pi0_full, _psycho_batch(lin_full * it), ref.mask_full, (h, w))
    if ref.pi0_sub is not None:
        half = ((h + 1) // 2, (w + 1) // 2)
        sub = _resolve(ref.pi0_sub, _psycho_batch(_subsample2x(lin_full) * it), ref.mask_sub,
                       half)
        up = sub.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :h, :w]
        result = result * _SUPERSAMPLE_KEEP + _SUPERSAMPLE_W * up
    return torch.amax(result, dim=(-2, -1))
