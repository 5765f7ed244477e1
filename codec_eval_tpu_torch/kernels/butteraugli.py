"""Butteraugli psychovisual distance: the batched scoring path.

Port of the batch path of ``codec_eval_tpu/kernels/butteraugli.py`` (the
public butteraugli model shipped in libjxl), two resolutions:

1. opsin dynamics -- K2 (``cuda/freqsep.py``);
2. frequency separation -- the sigma-7.16 LF blur as a dense row-normalized
   operator product, then K3 for the MF/HF/UHF bands;
3. Malta directional line sums -- the asymmetric diff planes, then K4
   (``cuda/malta.py``);
4. masking -- from the reference once per image, plus the candidate's
   sigma-2.7 blur term, as dense operator products;
5. combination -- ``sqrt(dc_mask*dc + mask*ac)`` per pixel and the
   half-resolution pass blended in as ``0.85*full + 0.5*upsampled(half)``;
   the score is the max of the map.

On CUDA tensors both the reference and the candidate side run through the
kernels; on CPU tensors every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .color import rdiv
from .cuda.freqsep import bands_batch, opsin_xyb_batch
from .cuda.malta import malta_ac_batch

SIGMA_LF = 7.1559334
SIGMA_MASK = 2.7

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
_MALTA_W1 = 0.33000001311302185  # f32-rounded 0.33, as compiled

# L2 band weights: hf X/Y/B, mf X/Y/B, lf X/Y/B.
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

# Malta line patterns (dy, dx).  Full variant: the slope-4 / slope-1/4 lines
# appear twice in the model's unrolled sum, hence weight 2.
_MALTA_LINES_FULL: Tuple[Tuple[float, Tuple[Tuple[int, int], ...]], ...] = (
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

_MALTA_LINES_LF: Tuple[Tuple[float, Tuple[Tuple[int, int], ...]], ...] = (
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

# (band, channel, dest_ac, asym_kind, weight, norm1, mulli, pattern), in the
# order of the stacked Malta diff planes.
_MALTA_CALLS = (
    ("uhf", 1, 1, "a", _W_UHF_MALTA, _NORM1_UHF, _MALTA_MULLI, "full"),
    ("uhf", 0, 0, "a", _W_UHF_MALTA_X, _NORM1_UHF_X, _MALTA_MULLI, "full"),
    ("hf", 1, 1, "sqrt_a", _W_HF_MALTA, _NORM1_HF, _MALTA_MULLI_LF, "lf"),
    ("hf", 0, 0, "sqrt_a", _W_HF_MALTA_X, _NORM1_HF_X, _MALTA_MULLI_LF, "lf"),
    ("mf", 1, 1, "none", _W_MF_MALTA, _NORM1_MF, _MALTA_MULLI_LF, "lf"),
    ("mf", 0, 0, "none", _W_MF_MALTA_X, _NORM1_MF_X, _MALTA_MULLI_LF, "lf"),
)

_OPSIN_CONSTS = tuple(float(v) for v in _OPSIN.reshape(-1)) + tuple(
    float(v) for v in _OPSIN_BIAS
) + (_GAMMA_MUL, _GAMMA_OFF, _GAMMA_SUB)
_BAND_CONSTS = (
    _MF_X_REMOVE, _MF_Y_AMPLIFY, _UHF_X_REMOVE, _HF_X_REMOVE,
    _SUPPRESS_YW, _SUPPRESS_S, _MAXCLAMP_HF, _MAXCLAMP_UHF, _MAXCLAMP_MUL,
    _UHF_Y_MUL, _HF_Y_MUL, _HF_Y_AMPLIFY,
)


@dataclass(frozen=True)
class ButteraugliParams:
    """The public model's knobs (reference: ButteraugliParams struct)."""

    hf_asymmetry: float = 0.8
    xmul: float = 1.0
    intensity_target: float = 80.0


@dataclass
class PsychoImage:
    """Band planes of one image or a batch: uhf/hf (..., 2, H, W) X and Y,
    mf (..., 3, H, W), lf (..., 3, H, W) in "vals" space."""

    uhf: torch.Tensor
    hf: torch.Tensor
    mf: torch.Tensor
    lf: torch.Tensor


# ----------------------------------------------------------------- blurs


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) row-normalized banded Toeplitz blur operator: each output is a
    weighted mean over the in-range taps (the model's border handling)."""
    radius = max(1, int(2.25 * sigma))
    taps = np.exp(-1.0 / (2.0 * sigma * sigma) * np.arange(-radius, radius + 1) ** 2)
    m = np.zeros((n, n), np.float64)
    for i, t in enumerate(taps):
        k = i - radius
        idx = np.arange(max(0, -k), min(n, n - k))
        m[idx, idx + k] = t
    m /= m.sum(axis=1, keepdims=True)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _blur_operator(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_blur_matrix(n, sigma)).to(device)


def _blur(planes: torch.Tensor, sigma: float) -> torch.Tensor:
    """Renormalized Gaussian of (..., H, W) planes as two dense operator
    products (f32: TF32 is off for the whole package)."""
    h, w = planes.shape[-2], planes.shape[-1]
    bh = _blur_operator(h, sigma, planes.device)
    bw = _blur_operator(w, sigma, planes.device)
    return torch.matmul(torch.matmul(bh, planes), bw.T)


# -------------------------------------------------------- band separation


def _psycho_batch(lin_scaled: torch.Tensor) -> PsychoImage:
    """(B, 3, H, W) intensity-scaled linear RGB -> batched PsychoImage."""
    xyb = opsin_xyb_batch(lin_scaled.contiguous(), _OPSIN_CONSTS)
    lf = _blur(xyb, SIGMA_LF).contiguous()
    bands = bands_batch(xyb, lf, _BAND_CONSTS)
    lf_vals = torch.stack(
        [
            lf[:, 0] * _XLF_X,
            lf[:, 1] * _XLF_Y,
            (lf[:, 2] + _XLF_Y_TO_B * lf[:, 1]) * _XLF_B,
        ],
        dim=1,
    )
    return PsychoImage(uhf=bands[:, 0:2], hf=bands[:, 2:4], mf=bands[:, 4:7], lf=lf_vals)


def _index(pi: PsychoImage, i: int) -> PsychoImage:
    return PsychoImage(uhf=pi.uhf[i], hf=pi.hf[i], mf=pi.mf[i], lf=pi.lf[i])


# ----------------------------------------------------------------- Malta


def _malta_prologue(lum0, lum1, w_0gt1: float, w_0lt1: float, norm1: float, mulli: float):
    """The per-pixel asymmetric diff plane the directional sweep consumes.
    The scalar weights are rounded to f32 at each step, as in JAX."""
    f = np.float32
    den = f(_MALTA_LEN * 2 + 1)
    norm2_0gt1 = float(f(mulli) * np.sqrt(f(_MALTA_W0) * f(w_0gt1)) / den * f(norm1))
    norm2_0lt1 = float(f(mulli) * np.sqrt(f(_MALTA_W1) * f(w_0lt1)) / den * f(norm1))

    diff = lum0 - lum1
    denom = norm1 + 0.5 * (torch.abs(lum0) + torch.abs(lum1))
    diffs = rdiv(norm2_0gt1, denom) * diff
    scaler2 = rdiv(norm2_0lt1, denom)
    fabs0 = torch.abs(lum0)
    too_small = 0.55 * fabs0
    too_big = 1.05 * fabs0
    zero = torch.zeros_like(diff)
    impact_pos = torch.where(
        lum1 < too_small,
        scaler2 * (too_small - lum1),
        torch.where(lum1 > too_big, -scaler2 * (lum1 - too_big), zero),
    )
    impact_neg = torch.where(
        lum1 > -too_small,
        -scaler2 * (lum1 + too_small),
        torch.where(lum1 < -too_big, scaler2 * (-lum1 - too_big), zero),
    )
    return diffs + torch.where(lum0 >= 0, impact_pos, impact_neg)


def _asym_weights(kind: str, wbase: float, hf_asymmetry: float) -> Tuple[float, float]:
    """The (w_0gt1, w_0lt1) pair of one Malta call, rounded to f32 at each
    step as the JAX package computes it."""
    a = np.float32(hf_asymmetry)
    sqrt_a = np.sqrt(a)
    if kind == "a":
        return float(np.float32(wbase) * a), float(np.float32(wbase) / a)
    if kind == "sqrt_a":
        return float(np.float32(wbase) * sqrt_a), float(np.float32(wbase) / sqrt_a)
    return float(np.float32(wbase)), float(np.float32(wbase))


def _malta_diffs_stack(pi0: PsychoImage, pi1: PsychoImage, hf_asymmetry: float) -> torch.Tensor:
    """The six asymmetric diff planes, stacked on axis -3: (..., 6, H, W)."""
    planes = []
    for band, ch, _dest, kind, wbase, norm1, mulli, _pat in _MALTA_CALLS:
        l0 = getattr(pi0, band)[..., ch, :, :]
        l1 = getattr(pi1, band)[..., ch, :, :]
        wg, wl = _asym_weights(kind, wbase, hf_asymmetry)
        planes.append(_malta_prologue(l0, l1, wg, wl, norm1, mulli))
    return torch.stack(planes, dim=-3)


# ------------------------------------------------------------ L2 and masks


def _l2_diff_asymmetric(v0, v1, w_0gt1: float, w_0lt1: float):
    k_gt = float(np.float32(0.8) * np.float32(w_0gt1))
    k_lt = float(np.float32(0.8) * np.float32(w_0lt1))
    d = v0 - v1
    total = k_gt * d * d
    fabs0 = torch.abs(v0)
    too_small = 0.4 * fabs0
    zero = torch.zeros_like(d)
    pos = torch.where(
        v1 < too_small, too_small - v1, torch.where(v1 > fabs0, v1 - fabs0, zero)
    )
    neg = torch.where(
        v1 > -too_small, v1 + too_small, torch.where(v1 < -fabs0, -v1 - fabs0, zero)
    )
    v = torch.where(v0 < 0, neg, pos)
    return total + k_lt * v * v


def _combine_channels_for_masking(pi: PsychoImage) -> torch.Tensor:
    xdiff = (pi.uhf[..., 0, :, :] + pi.hf[..., 0, :, :]) * _MASK_HF_MUL
    ydiff = pi.uhf[..., 1, :, :] * _MASK_UHF_MUL + pi.hf[..., 1, :, :] * _MASK_UHF_MUL
    return torch.sqrt(xdiff * xdiff + ydiff * ydiff)


def _diff_precompute(v: torch.Tensor) -> torch.Tensor:
    bias = _DIFF_PRE_MUL * _DIFF_PRE_BIAS
    return torch.sqrt(_DIFF_PRE_MUL * torch.abs(v) + bias) - math.sqrt(bias)


def _fuzzy_erosion(v: torch.Tensor) -> torch.Tensor:
    """0.45*m0 + 0.3*m1 + 0.25*m2 of the three smallest of {v, 2v, 2v, the
    8 neighbours at step 3}; outside the image counts as very large."""
    h, w = v.shape[-2], v.shape[-1]
    big = float(np.finfo(np.float32).max / 4)
    padded = torch.nn.functional.pad(v, (3, 3, 3, 3), value=big)
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


def _mask_y(d: torch.Tensor) -> torch.Tensor:
    return _mask_response(d, _MASKY)


def _mask_dc_y(d: torch.Tensor) -> torch.Tensor:
    return _mask_response(d, _MASKDCY)


def _mask_pre_of(pi0: PsychoImage):
    """Candidate-independent masking: (b0, MaskY, MaskDcY) of the reference."""
    b0 = _blur(_diff_precompute(_combine_channels_for_masking(pi0)), SIGMA_MASK)
    mask = _fuzzy_erosion(b0)
    return (b0, _mask_y(mask), _mask_dc_y(mask))


def _mask_diff_ac_batch(pi1_batch: PsychoImage, b0: torch.Tensor) -> torch.Tensor:
    """The candidate-side masking term: (B, H, W) diff_ac."""
    b1 = _blur(_diff_precompute(_combine_channels_for_masking(pi1_batch)), SIGMA_MASK)
    return _MASK_DIFF_AC_MUL * (b0 - b1) * (b0 - b1)


# ----------------------------------------------------------------- diffmap


def _diffmap_psycho(
    pi0: PsychoImage,
    pi1: PsychoImage,
    hf_asymmetry: float,
    xmul: float,
    malta_ac: torch.Tensor,
    mask_pre,
    diff_ac: torch.Tensor,
) -> torch.Tensor:
    """Per-pixel distance of a candidate batch (leading axis B) with the
    Malta accumulators (B, 2, H, W), the reference masks and the candidate
    mask term (B, H, W) already computed."""
    a = np.float32(hf_asymmetry)
    ac0, ac1 = malta_ac[:, 0], malta_ac[:, 1]
    w0 = np.float32(_WMUL[0])
    w1 = np.float32(_WMUL[1])
    ac0 = ac0 + _l2_diff_asymmetric(
        pi0.hf[0], pi1.hf[:, 0], float(w0 * a), float(w0 / a)
    )
    ac1 = ac1 + _l2_diff_asymmetric(
        pi0.hf[1], pi1.hf[:, 1], float(w1 * a), float(w1 / a)
    )
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
    total = dc_maskval * (xmul * dc[:, 0] + dc[:, 1] + dc[:, 2]) + maskval * (
        xmul * ac0 + ac1 + ac2
    )
    return torch.sqrt(torch.clamp(total, min=0.0))


def _subsample2x(planes: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., ceil(H/2), ceil(W/2)); mean of available samples."""
    h, w = planes.shape[-2], planes.shape[-1]
    ph, pw = (h + 1) // 2 * 2, (w + 1) // 2 * 2
    p = torch.nn.functional.pad(planes, (0, pw - w, 0, ph - h))
    p = p.reshape(planes.shape[:-2] + (ph // 2, 2, pw // 2, 2))
    out = 0.25 * p.sum(dim=(-3, -1))
    if h % 2:
        out = torch.cat([out[..., :-1, :], out[..., -1:, :] * 2.0], dim=-2)
    if w % 2:
        out = torch.cat([out[..., :, :-1], out[..., :, -1:] * 2.0], dim=-1)
    return out


def _add_supersampled2x(result: torch.Tensor, sub: torch.Tensor) -> torch.Tensor:
    h, w = result.shape[-2], result.shape[-1]
    up = sub.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)[..., :h, :w]
    return result * _SUPERSAMPLE_KEEP + _SUPERSAMPLE_W * up


# -------------------------------------------------------------- public API


@dataclass
class ButteraugliReference:
    """Reference-side psycho images and masks (b0, MaskY, MaskDcY) at full
    and half resolution, computed once per image."""

    pi0_full: PsychoImage
    pi0_sub: Optional[PsychoImage]
    params: ButteraugliParams
    shape: Tuple[int, int]
    mask_full: Optional[tuple] = None
    mask_sub: Optional[tuple] = None


def precompute_butteraugli_reference(
    lin0: torch.Tensor, params: Optional[ButteraugliParams] = None
) -> ButteraugliReference:
    """lin0: the reference's (3, H, W) linear RGB in [0, 1]."""
    if params is None:
        params = ButteraugliParams()
    h, w = lin0.shape[-2], lin0.shape[-1]
    it = float(np.float32(params.intensity_target))
    if h < 8 or w < 8:
        return ButteraugliReference(None, None, params, (h, w))
    pi0_full = _index(_psycho_batch(lin0[None] * it), 0)
    sh, sw = (h + 1) // 2, (w + 1) // 2
    pi0_sub = None
    if sh >= 8 and sw >= 8:
        pi0_sub = _index(_psycho_batch(_subsample2x(lin0)[None] * it), 0)
    return ButteraugliReference(
        pi0_full=pi0_full,
        pi0_sub=pi0_sub,
        params=params,
        shape=(h, w),
        mask_full=_mask_pre_of(pi0_full),
        mask_sub=_mask_pre_of(pi0_sub) if pi0_sub is not None else None,
    )


def _resolve(ref_pi: PsychoImage, pi1: PsychoImage, mask_pre, params: ButteraugliParams):
    dac = _mask_diff_ac_batch(pi1, mask_pre[0])
    stacks = _malta_diffs_stack(ref_pi, pi1, params.hf_asymmetry).contiguous()
    ac = malta_ac_batch(stacks, _MALTA_LINES_FULL, _MALTA_LINES_LF)
    return _diffmap_psycho(
        ref_pi, pi1, params.hf_asymmetry, params.xmul, malta_ac=ac, mask_pre=mask_pre,
        diff_ac=dac,
    )


def butteraugli_batch(ref: ButteraugliReference, lin_full: torch.Tensor) -> torch.Tensor:
    """Scores of candidates given as (N, 3, H, W) linear RGB against one
    precomputed reference.  Images under 8 px on a side score 0."""
    h, w = ref.shape
    n = lin_full.shape[0]
    if h < 8 or w < 8:
        return torch.zeros((n,), dtype=torch.float32, device=lin_full.device)
    it = float(np.float32(ref.params.intensity_target))
    pi1f = _psycho_batch(lin_full * it)
    result = _resolve(ref.pi0_full, pi1f, ref.mask_full, ref.params)
    if ref.pi0_sub is not None:
        pi1s = _psycho_batch(_subsample2x(lin_full) * it)
        sub = _resolve(ref.pi0_sub, pi1s, ref.mask_sub, ref.params)
        result = _add_supersampled2x(result, sub)
    return torch.amax(result, dim=(-2, -1))
