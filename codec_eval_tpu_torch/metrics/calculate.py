"""Flat metric entry points with the reference's calling conventions.

Port of ``codec_eval_tpu/metrics/calculate.py`` (reference:
src/metrics/ssimulacra2.rs:59,135, src/metrics/dssim.rs:40,158,
src/metrics/butteraugli.rs:45,99,150, src/metrics/mod.rs:312): flat-buffer
or array inputs with explicit width/height, ICC-aware variants that bring
both images to sRGB on the host first, and the intensity-target Butteraugli
knob.  Each function scores one pair on ``device``: the card by default,
where SSIMULACRA2 runs K8 at every scale and Butteraugli K2-K5 and K7;
``device="cpu"`` runs the plain versions.  Each returns a Python float.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..color import ColorProfile, prepare_for_comparison
from ..device import resolve_device
from ..errors import DimensionMismatch
from ..kernels.butteraugli import butteraugli
from ..kernels.dssim import dssim_u8
from ..kernels.psnr import psnr
from ..kernels.ssimulacra2 import ssimulacra2
from ..utils.native import srgb_to_linear_host


def _as_image(data, width: Optional[int], height: Optional[int]) -> np.ndarray:
    """Bytes or a 1-D buffer with ``width``/``height``, or an (H, W, 3[+])
    array -> (H, W, 3) u8."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, np.uint8)
    arr = np.asarray(data)
    if arr.ndim == 1:
        if width is None or height is None:
            raise ValueError("a flat buffer needs width and height")
        arr = arr.reshape(height, width, 3)
    return arr[..., :3].astype(np.uint8, copy=False)


def _check(ref: np.ndarray, test: np.ndarray) -> None:
    if ref.shape != test.shape:
        raise DimensionMismatch((ref.shape[1], ref.shape[0]), (test.shape[1], test.shape[0]))


def _pair(reference, test, width, height, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Both images as (H, W, 3) u8 tensors on the resolved device."""
    dev = resolve_device(device)
    ref = _as_image(reference, width, height)
    tst = _as_image(test, width, height)
    _check(ref, tst)
    return torch.tensor(ref, device=dev), torch.tensor(tst, device=dev)


def calculate_ssimulacra2(
    reference, test, width: Optional[int] = None, height: Optional[int] = None,
    *, device="cuda",
) -> float:
    """SSIMULACRA2 score in (-inf, 100].  reference: src/metrics/ssimulacra2.rs:59."""
    return float(ssimulacra2(*_pair(reference, test, width, height, device)))


def calculate_dssim(
    reference, test, width: Optional[int] = None, height: Optional[int] = None,
    *, device="cuda",
) -> float:
    """DSSIM (0 = identical).  reference: src/metrics/dssim.rs:40."""
    return float(dssim_u8(*_pair(reference, test, width, height, device)))


def calculate_butteraugli(
    reference, test, width: Optional[int] = None, height: Optional[int] = None,
    *, device="cuda",
) -> float:
    """Butteraugli max-norm distance.  reference: src/metrics/butteraugli.rs:45."""
    return calculate_butteraugli_with_intensity(
        reference, test, width, height, intensity_target=80.0, device=device
    )


def calculate_butteraugli_with_intensity(
    reference,
    test,
    width: Optional[int] = None,
    height: Optional[int] = None,
    intensity_target: float = 80.0,
    *,
    device="cuda",
) -> float:
    """Butteraugli at a display intensity target (nits).
    reference: src/metrics/butteraugli.rs:99."""
    ref, tst = _pair(reference, test, width, height, device)
    return float(butteraugli(ref, tst, intensity_target=intensity_target))


def calculate_psnr(
    reference, test, width: Optional[int] = None, height: Optional[int] = None,
    *, device="cuda",
) -> float:
    """PSNR in dB (inf for identical).  reference: src/metrics/mod.rs:312."""
    return float(psnr(*_pair(reference, test, width, height, device)))


def _icc_pair(reference, test, width, height, ref_profile, test_profile):
    ref = _as_image(reference, width, height)
    tst = _as_image(test, width, height)
    _check(ref, tst)
    return prepare_for_comparison(
        ref, ref_profile or ColorProfile.srgb(), tst, test_profile or ColorProfile.srgb()
    )


def calculate_ssimulacra2_icc(
    reference, test, width=None, height=None,
    reference_profile: Optional[ColorProfile] = None,
    test_profile: Optional[ColorProfile] = None,
    *, device="cuda",
) -> float:
    """ICC-aware SSIMULACRA2: both images transformed to sRGB first.
    reference: src/metrics/ssimulacra2.rs:135."""
    ref, tst = _icc_pair(reference, test, width, height, reference_profile, test_profile)
    return calculate_ssimulacra2(ref, tst, device=device)


def calculate_dssim_icc(
    reference, test, width=None, height=None,
    reference_profile: Optional[ColorProfile] = None,
    test_profile: Optional[ColorProfile] = None,
    *, device="cuda",
) -> float:
    """reference: src/metrics/dssim.rs:158."""
    ref, tst = _icc_pair(reference, test, width, height, reference_profile, test_profile)
    return calculate_dssim(ref, tst, device=device)


def calculate_butteraugli_icc(
    reference, test, width=None, height=None,
    reference_profile: Optional[ColorProfile] = None,
    test_profile: Optional[ColorProfile] = None,
    *, device="cuda",
) -> float:
    """reference: src/metrics/butteraugli.rs:150."""
    ref, tst = _icc_pair(reference, test, width, height, reference_profile, test_profile)
    return calculate_butteraugli(ref, tst, device=device)


def rgb8_to_dssim_image(data, width: int, height: int) -> np.ndarray:
    """sRGB u8 RGB -> linear-light RGBA f32 (alpha 1), the pixel format
    dssim-core consumes.  reference: src/metrics/dssim.rs:102-115."""
    rgb = np.asarray(data, dtype=np.uint8).reshape(height, width, 3)
    out = np.empty((height, width, 4), np.float32)
    out[..., :3] = srgb_to_linear_host(rgb)
    out[..., 3] = 1.0
    return out


def rgba8_to_dssim_image(data, width: int, height: int) -> np.ndarray:
    """sRGB u8 RGBA -> linear-light RGBA f32 (alpha scaled 0-1 linearly).
    reference: src/metrics/dssim.rs:131-148."""
    rgba = np.asarray(data, dtype=np.uint8).reshape(height, width, 4)
    out = np.empty((height, width, 4), np.float32)
    out[..., :3] = srgb_to_linear_host(rgba[..., :3])
    out[..., 3] = rgba[..., 3].astype(np.float32) / 255.0
    return out


__all__ = [
    "calculate_ssimulacra2",
    "calculate_dssim",
    "rgb8_to_dssim_image",
    "rgba8_to_dssim_image",
    "calculate_butteraugli",
    "calculate_butteraugli_with_intensity",
    "calculate_psnr",
    "calculate_ssimulacra2_icc",
    "calculate_dssim_icc",
    "calculate_butteraugli_icc",
]
