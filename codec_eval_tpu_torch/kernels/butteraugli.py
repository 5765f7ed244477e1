"""Butteraugli psychovisual distance: the batched and the single-pair paths.

Port of ``codec_eval_tpu/kernels/butteraugli.py`` (the public butteraugli
model shipped in libjxl), two resolutions:

1. opsin dynamics -- K2 (``cuda/freqsep.py``);
2. frequency separation -- the sigma-7.16 LF blur as a dense row-normalized
   operator product, then K3 for the MF/HF/UHF bands;
3. Malta directional line sums -- the asymmetric diff planes, then K4
   (``cuda/malta.py``);
4. masking -- from the reference once per image as dense operator
   products, plus the candidate's sigma-2.7 blur term: a dense operator
   product, or K6 (``cuda/blur.py``) on planes of 1024 px and more;
5. combination -- ``sqrt(dc_mask*dc + mask*ac)`` per pixel and the
   half-resolution pass blended in as ``0.85*full + 0.5*upsampled(half)``;
   the score is the max of the map.

On planes of 1400 px and more, steps 3 and 5's per-pixel distance run as
one kernel, K5 (``cuda/malta.py``), as the JAX package routes them.

A single pair (``butteraugli``, ``butteraugli_distmap``, ...) takes the
batch path at B = 1, except for the candidate's masking term: at every size
it runs as K7 (``cuda/maskac.py``), the sigma-2.7 blur and the squared
difference fused, so the batch's K6 / dense-operator route is left as it is.

The mixed-size scorer (``kernels/masked.py``) takes the mask-aware forms at
the end of this file: every blur a dense operator product renormalized over
each pair's valid rectangle, the Malta sweeps on K4.

On CUDA tensors both the reference and the candidate side run through the
kernels; on CPU tensors every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .color import rdiv, srgb_u8_to_linear
from .cuda.blur import blur_batch
from .cuda.freqsep import (
    SIGMA_MF,
    SIGMA_SURROUND,
    SIGMA_UHF,
    _amplify_range,
    _fma,
    _maximum_clamp,
    _remove_range,
    bands_batch,
    opsin_from_blurred,
    opsin_xyb_batch,
)
from .cuda.malta import (
    LINES_FULL,
    LINES_LF,
    l2_asymmetric,
    malta_ac_batch,
    malta_diffmap_batch,
    malta_prologue,
)
from .cuda.maskac import mask_diff_ac_batch

SIGMA_LF = 7.1559334
SIGMA_MASK = 2.7

# Size routes, under the JAX package's names and at its defaults
# (``codec_eval_tpu/kernels/butteraugli.py``): K5, the whole-diffmap kernel,
# on planes whose shortest side is at least _FUSED_EPI_MIN_SIDE; K6, the
# batched FIR blur, for the candidate's mask blur on planes whose shortest
# side is at least _BLUR_PALLAS_MIN_SIDE, when the filter has at most
# _BLUR_PALLAS_MAX_TAPS taps (sigma 2.7 has 13; the 33-tap LF blur stays a
# dense operator product there too).
_FUSED_EPI_MIN_SIDE = 1400
_BLUR_PALLAS_MIN_SIDE = 1024
_BLUR_PALLAS_MAX_TAPS = 16

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

# Malta line patterns (dy, dx), compiled into the Malta kernels (K4, K5).
_MALTA_LINES_FULL = LINES_FULL
_MALTA_LINES_LF = LINES_LF

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
    return malta_prologue(lum0, lum1, norm2_0gt1, norm2_0lt1, norm1)


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
    return l2_asymmetric(v0, v1, k_gt, k_lt)


def _combine_channels_for_masking(pi: PsychoImage) -> torch.Tensor:
    xdiff = (pi.uhf[..., 0, :, :] + pi.hf[..., 0, :, :]) * _MASK_HF_MUL
    ydiff = pi.uhf[..., 1, :, :] * _MASK_UHF_MUL + pi.hf[..., 1, :, :] * _MASK_UHF_MUL
    return torch.sqrt(xdiff * xdiff + ydiff * ydiff)


def _diff_precompute(v: torch.Tensor) -> torch.Tensor:
    bias = _DIFF_PRE_MUL * _DIFF_PRE_BIAS
    return torch.sqrt(_DIFF_PRE_MUL * torch.abs(v) + bias) - math.sqrt(bias)


def _fuzzy_erosion(v: torch.Tensor, mask2d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0.45*m0 + 0.3*m1 + 0.25*m2 of the three smallest of {v, 2v, 2v, the
    8 neighbours at step 3}; outside the image counts as very large, and so
    does a neighbour where ``mask2d`` (the valid rectangle) is 0."""
    h, w = v.shape[-2], v.shape[-1]
    big = float(np.finfo(np.float32).max / 4)
    src = v if mask2d is None else torch.where(mask2d > 0, v, torch.full_like(v, big))
    padded = torch.nn.functional.pad(src, (3, 3, 3, 3), value=big)
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


def _blur_batch_ok(h: int, w: int, sigma: float) -> bool:
    """Whether a batched blur of (h, w) planes takes K6."""
    ntaps = 2 * max(1, int(2.25 * sigma)) + 1
    return min(h, w) >= _BLUR_PALLAS_MIN_SIDE and ntaps <= _BLUR_PALLAS_MAX_TAPS


def _mask_diff_ac_batch(
    pi1_batch: PsychoImage, b0: torch.Tensor, route_hw: Optional[tuple] = None
) -> torch.Tensor:
    """The candidate-side masking term: (B, H, W) diff_ac; K6 or the dense
    operator product as the size route of ``route_hw`` (the planes' own
    shape by default) gives."""
    d1 = _diff_precompute(_combine_channels_for_masking(pi1_batch))
    if _blur_batch_ok(*(route_hw or d1.shape[-2:]), SIGMA_MASK):
        b1 = blur_batch(d1[:, None].contiguous(), SIGMA_MASK)[:, 0]
    else:
        b1 = _blur(d1, SIGMA_MASK)
    return _MASK_DIFF_AC_MUL * (b0 - b1) * (b0 - b1)


def _mask_diff_ac_pair(
    pi1_batch: PsychoImage, b0: torch.Tensor, route_hw: Optional[tuple] = None
) -> torch.Tensor:
    """The single pair's masking term, (1, H, W): K7 at every size."""
    del route_hw
    d1 = _diff_precompute(_combine_channels_for_masking(pi1_batch)).contiguous()
    return mask_diff_ac_batch(d1, b0.contiguous(), _MASK_DIFF_AC_MUL, SIGMA_MASK)


#: How a path computes its candidates' masking term: (B-stacked
#: PsychoImage, the reference's (H, W) blur b0, the (h, w) its size routes
#: see) -> (B, H, W).
MaskTerm = Callable[[PsychoImage, torch.Tensor, tuple], torch.Tensor]


# ----------------------------------------------------------------- diffmap


@functools.lru_cache(maxsize=None)
def _band_weights(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_WMUL[3:6]`` and ``_WMUL[6:9]`` as f32 (3, 1, 1) planes on
    ``device``: views of one tensor, copied there once (a copy per call is a
    pageable one, which holds the host until the device's queue drains)."""
    w = torch.tensor(_WMUL[3:9], dtype=torch.float32, device=device)[:, None, None]
    return w[:3], w[3:]


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
    mask term (B, H, W) already computed.  The reference ``pi0`` is one
    image, or a batch of B on the masked path (one reference per pair)."""
    a = np.float32(hf_asymmetry)
    ac0, ac1 = malta_ac[:, 0], malta_ac[:, 1]
    w0 = np.float32(_WMUL[0])
    w1 = np.float32(_WMUL[1])
    ac0 = ac0 + _l2_diff_asymmetric(
        pi0.hf[..., 0, :, :], pi1.hf[:, 0], float(w0 * a), float(w0 / a)
    )
    ac1 = ac1 + _l2_diff_asymmetric(
        pi0.hf[..., 1, :, :], pi1.hf[:, 1], float(w1 * a), float(w1 / a)
    )
    d_mf = pi0.mf - pi1.mf
    wmf, wlf = _band_weights(d_mf.device)
    ac_mf = wmf * d_mf * d_mf
    ac0 = ac0 + ac_mf[:, 0]
    ac1 = ac1 + ac_mf[:, 1]
    ac2 = torch.zeros_like(ac0) + ac_mf[:, 2]
    d_lf = pi0.lf - pi1.lf
    dc = wlf * d_lf * d_lf

    _b0, maskval, dc_maskval = mask_pre
    ac1 = ac1 + diff_ac
    total = dc_maskval * (xmul * dc[:, 0] + dc[:, 1] + dc[:, 2]) + maskval * (
        xmul * ac0 + ac1 + ac2
    )
    return torch.sqrt(torch.clamp(total, min=0.0))


def _fused_diffmap_ok(h: int, w: int) -> bool:
    """Whether the diffmap of (h, w) planes takes K5."""
    return min(h, w) >= _FUSED_EPI_MIN_SIDE


def _fused_diffmap_consts(hf_asymmetry: float, xmul: float):
    """K5's per-channel prologue constants (n2g, n2l, norm1) and epilogue
    weights, resolved in Python doubles as the JAX package does for its
    fused kernel (the unfused path rounds to f32 at each step instead)."""
    a = float(hf_asymmetry)
    sqrt_a = math.sqrt(a)
    ch_consts = []
    for _band, _ch, _dest, kind, wbase, norm1, mulli, _pat in _MALTA_CALLS:
        if kind == "a":
            wg, wl = wbase * a, wbase / a
        elif kind == "sqrt_a":
            wg, wl = wbase * sqrt_a, wbase / sqrt_a
        else:
            wg = wl = wbase
        den = _MALTA_LEN * 2 + 1
        n2g = mulli * math.sqrt(_MALTA_W0 * wg) / den * norm1
        n2l = mulli * math.sqrt(_MALTA_W1 * wl) / den * norm1
        ch_consts.append((n2g, n2l, norm1))
    epi = (
        _WMUL[0] * a, _WMUL[0] / a, _WMUL[1] * a, _WMUL[1] / a,
        _WMUL[3], _WMUL[4], _WMUL[5], _WMUL[6], _WMUL[7], _WMUL[8],
        float(xmul),
    )
    return tuple(ch_consts), epi


def _fused_diffmap_args(
    pi0: PsychoImage, pi1: PsychoImage, hf_asymmetry: float, xmul: float, mask_pre,
    dac: torch.Tensor,
) -> tuple:
    """K5's arguments: the planes staged as the JAX package stages them."""
    ch_consts, epi = _fused_diffmap_consts(hf_asymmetry, xmul)
    cand6 = torch.stack(
        [pi1.uhf[:, 1], pi1.uhf[:, 0], pi1.hf[:, 1], pi1.hf[:, 0], pi1.mf[:, 1], pi1.mf[:, 0]],
        dim=1,
    )
    ref6 = torch.stack([pi0.uhf[1], pi0.uhf[0], pi0.hf[1], pi0.hf[0], pi0.mf[1], pi0.mf[0]])
    crest = torch.cat([pi1.mf[:, 2:3], pi1.lf], dim=1)
    rrest = torch.cat([pi0.mf[2:3], pi0.lf], dim=0)
    masks = torch.stack([mask_pre[1], mask_pre[2]])
    return (
        cand6, ref6, crest, rrest, dac.contiguous(), masks,
        _MALTA_LINES_FULL, _MALTA_LINES_LF, ch_consts, epi,
    )


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


def _resolve(
    ref_pi: PsychoImage, pi1: PsychoImage, mask_pre, params: ButteraugliParams,
    mask_term: MaskTerm, route_hw: tuple,
):
    """One resolution's distance map; ``route_hw`` is the (h, w) whose
    size routes (K5, K6) apply: the planes' own, or the whole image's when
    the planes are a row band of it (``parallel/spatial.py``), so that a
    band launches the kernels of the whole image."""
    dac = mask_term(pi1, mask_pre[0], route_hw)
    if _fused_diffmap_ok(*route_hw):
        return malta_diffmap_batch(
            *_fused_diffmap_args(ref_pi, pi1, params.hf_asymmetry, params.xmul, mask_pre, dac)
        )
    stacks = _malta_diffs_stack(ref_pi, pi1, params.hf_asymmetry).contiguous()
    ac = malta_ac_batch(stacks, _MALTA_LINES_FULL, _MALTA_LINES_LF)
    return _diffmap_psycho(
        ref_pi, pi1, params.hf_asymmetry, params.xmul, malta_ac=ac, mask_pre=mask_pre,
        diff_ac=dac,
    )


def butteraugli_distmap_batch(
    ref: ButteraugliReference, lin_full: torch.Tensor, mask_term: MaskTerm,
    route_hw: Optional[tuple] = None,
) -> torch.Tensor:
    """(N, H, W) distance maps of candidates given as (N, 3, H, W) linear
    RGB against one precomputed reference, with ``mask_term`` computing the
    candidates' masking term.  Images under 8 px on a side give zero maps.
    ``route_hw``: the (H, W) whose size routes apply, the planes' own by
    default (a row band passes its whole image's)."""
    h, w = ref.shape
    full = (h, w) if route_hw is None else tuple(route_hw)
    if h < 8 or w < 8:
        return torch.zeros((lin_full.shape[0], h, w), dtype=torch.float32, device=lin_full.device)
    it = float(np.float32(ref.params.intensity_target))
    pi1f = _psycho_batch(lin_full * it)
    result = _resolve(ref.pi0_full, pi1f, ref.mask_full, ref.params, mask_term, full)
    if ref.pi0_sub is not None:
        pi1s = _psycho_batch(_subsample2x(lin_full) * it)
        half = ((full[0] + 1) // 2, (full[1] + 1) // 2)
        sub = _resolve(ref.pi0_sub, pi1s, ref.mask_sub, ref.params, mask_term, half)
        result = _add_supersampled2x(result, sub)
    return result


def butteraugli_batch(ref: ButteraugliReference, lin_full: torch.Tensor) -> torch.Tensor:
    """Scores of candidates given as (N, 3, H, W) linear RGB against one
    precomputed reference.  Images under 8 px on a side score 0."""
    maps = butteraugli_distmap_batch(ref, lin_full, _mask_diff_ac_batch)
    return torch.amax(maps, dim=(-2, -1))


# ------------------------------------------------------------ single pairs


def _planar_linear(u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) u8 sRGB -> (..., 3, H, W) linear RGB."""
    return torch.movedim(srgb_u8_to_linear(u8), -1, -3).contiguous()


def butteraugli_distmap_against(
    ref: ButteraugliReference,
    dist_u8: torch.Tensor,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
) -> torch.Tensor:
    """Distance map of one (H, W, 3) u8 candidate against a precomputed
    reference.  As in the JAX package, the intensity target is the one the
    reference was computed with; ``intensity_target`` is accepted and unused."""
    del intensity_target
    ref = dataclasses.replace(
        ref, params=dataclasses.replace(ref.params, hf_asymmetry=hf_asymmetry)
    )
    return butteraugli_distmap_batch(ref, _planar_linear(dist_u8)[None], _mask_diff_ac_pair)[0]


def butteraugli_against_reference(
    ref: ButteraugliReference,
    dist_u8: torch.Tensor,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
) -> torch.Tensor:
    return torch.amax(butteraugli_distmap_against(ref, dist_u8, intensity_target, hf_asymmetry))


def butteraugli_distmap(
    ref_u8: torch.Tensor,
    dist_u8: torch.Tensor,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
    params: Optional[ButteraugliParams] = None,
    route_hw: Optional[tuple] = None,
) -> torch.Tensor:
    """Per-pixel distance map of one (H, W, 3) u8 sRGB pair; ``route_hw``
    as in ``butteraugli_distmap_batch``."""
    if params is None:
        params = ButteraugliParams(hf_asymmetry=hf_asymmetry, intensity_target=intensity_target)
    ref = precompute_butteraugli_reference(_planar_linear(ref_u8), params)
    return butteraugli_distmap_batch(ref, _planar_linear(dist_u8)[None], _mask_diff_ac_pair,
                                     route_hw)[0]


def butteraugli(
    ref_u8: torch.Tensor,
    dist_u8: torch.Tensor,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
    params: Optional[ButteraugliParams] = None,
) -> torch.Tensor:
    """Max-norm distance of one pair; byte-identical pairs score exactly 0.
    reference: src/metrics/butteraugli.rs:45, :99."""
    dmap = butteraugli_distmap(ref_u8, dist_u8, intensity_target, hf_asymmetry, params)
    score = torch.amax(dmap)
    return torch.where(torch.all(ref_u8 == dist_u8), torch.zeros_like(score), score)


def butteraugli_pnorm(
    ref_u8: torch.Tensor,
    dist_u8: torch.Tensor,
    p: float = 3.0,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
) -> torch.Tensor:
    """p-norm of the distance map (the jxl-style aggregate)."""
    dmap = butteraugli_distmap(ref_u8, dist_u8, intensity_target, hf_asymmetry)
    return torch.pow(torch.mean(torch.pow(torch.clamp(dmap, min=0.0), p)), 1.0 / p)


# ------------------------------------------------- the masked (padded) path
#
# The mask-aware forms of the stages above, for ``kernels/masked.py``: a
# batch of N pairs zero-padded to one bucket shape, each with its own valid
# (top-left) rectangle, given as {0, 1} row and column vectors mrow (N, h)
# and mcol (N, w) and their outer product m2 (N, h, w).  Every blur is the
# dense operator product renormalized over the valid rectangle only, as the
# JAX package computes it; K2, K3 and K6 take one renormalization plane for
# the whole batch, so they do not serve here.  The Malta sweeps run on K4:
# with the diff planes zeroed beyond the valid rectangle, its zero-padded
# sweep is exactly the masked one.


def _blur_masked(
    planes: torch.Tensor, sigma: float, mrow: torch.Tensor, mcol: torch.Tensor
) -> torch.Tensor:
    """(N, C, h, w) planes, zero beyond each pair's valid rectangle ->
    their blur renormalized over that rectangle only, zero beyond it.  The
    renormalization separates into an outer product of blurred 1-D masks."""
    h, w = planes.shape[-2], planes.shape[-1]
    bh = _blur_operator(h, sigma, planes.device)
    bw = _blur_operator(w, sigma, planes.device)
    out = torch.matmul(torch.matmul(bh, planes), bw.T)
    vrow = torch.matmul(mrow, bh.T)
    vcol = torch.matmul(mcol, bw.T)
    denom = vrow[:, :, None] * vcol[:, None, :]
    out = out / torch.clamp(denom, min=1e-9)[:, None]
    return out * (mrow[:, :, None] * mcol[:, None, :])[:, None]


def _opsin_dynamics(linear_scaled: torch.Tensor, m2, mrow, mcol) -> torch.Tensor:
    """(N, 3, h, w) intensity-scaled linear RGB -> opponent XYB, the
    surround blur masked."""
    blurred = _blur_masked(linear_scaled * m2[:, None], SIGMA_SURROUND, mrow, mcol)
    return opsin_from_blurred(linear_scaled, blurred, _OPSIN_CONSTS)


def _separate_frequencies(xyb: torch.Tensor, m2, mrow, mcol) -> PsychoImage:
    xyb = xyb * m2[:, None]
    return _bands_from_lf(xyb, _blur_masked(xyb, SIGMA_LF, mrow, mcol), m2, mrow, mcol)


def _bands_from_lf(xyb: torch.Tensor, lf: torch.Tensor, m2, mrow, mcol) -> PsychoImage:
    """The band chain of K3 (``cuda/freqsep.py:bands_plain``) with masked
    blurs, given the masked XYB and its LF blur; every band masked."""

    def blur(p, sigma):
        return _blur_masked(p * m2[:, None], sigma, mrow, mcol)

    mf = xyb - lf
    mf_b = blur(mf[:, 2:3], SIGMA_MF)[:, 0]
    mf_xy = blur(mf[:, :2], SIGMA_MF)
    hf = mf[:, :2] - mf_xy
    mf_x = _remove_range(mf_xy[:, 0], _MF_X_REMOVE)
    mf_y = _amplify_range(mf_xy[:, 1], _MF_Y_AMPLIFY)
    lf_vals = torch.stack(
        [lf[:, 0] * _XLF_X, lf[:, 1] * _XLF_Y, (lf[:, 2] + _XLF_Y_TO_B * lf[:, 1]) * _XLF_B],
        dim=1,
    )
    # Red-green suppression by intensity change, on the full hf.
    suppress = _SUPPRESS_S + rdiv(
        (1.0 - _SUPPRESS_S) * _SUPPRESS_YW, _fma(hf[:, 1], hf[:, 1], _SUPPRESS_YW)
    )
    hf = torch.stack([hf[:, 0] * suppress, hf[:, 1]], dim=1)
    hf_blur = blur(hf, SIGMA_UHF)
    uhf_x = _remove_range(hf[:, 0] - hf_blur[:, 0], _UHF_X_REMOVE)
    out_hf_x = _remove_range(hf_blur[:, 0], _HF_X_REMOVE)
    hfc = _maximum_clamp(hf_blur[:, 1], _MAXCLAMP_HF, _MAXCLAMP_MUL)
    uhf_y = _maximum_clamp(hf[:, 1] - hfc, _MAXCLAMP_UHF, _MAXCLAMP_MUL) * _UHF_Y_MUL
    out_hf_y = _amplify_range(hfc * _HF_Y_MUL, _HF_Y_AMPLIFY)
    m = m2[:, None]
    return PsychoImage(
        uhf=torch.stack([uhf_x, uhf_y], dim=1) * m,
        hf=torch.stack([out_hf_x, out_hf_y], dim=1) * m,
        mf=torch.stack([mf_x, mf_y, mf_b], dim=1) * m,
        lf=lf_vals * m,
    )


def _mask_reference_side(pi0: PsychoImage, m2, mrow, mcol):
    """The reference's masking pieces (b0, MaskY, MaskDcY), masked: the
    fuzzy erosion leaves out neighbours beyond the valid rectangle."""
    d0 = _diff_precompute(_combine_channels_for_masking(pi0))
    b0 = _blur_masked((d0 * m2)[:, None], SIGMA_MASK, mrow, mcol)[:, 0]
    mask = _fuzzy_erosion(b0, m2)
    return b0, _mask_y(mask), _mask_dc_y(mask)


def _mask_candidate_side(b0: torch.Tensor, pi1: PsychoImage, m2, mrow, mcol) -> torch.Tensor:
    """The candidate's masking term ``ac_mul * (b0 - b1)^2``, masked."""
    d1 = _diff_precompute(_combine_channels_for_masking(pi1))
    b1 = _blur_masked((d1 * m2)[:, None], SIGMA_MASK, mrow, mcol)[:, 0]
    return _MASK_DIFF_AC_MUL * (b0 - b1) * (b0 - b1)
