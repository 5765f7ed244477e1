"""Host-side ICC color management (lcms2 via PIL.ImageCms).

A copy of ``codec_eval_tpu/color.py`` (reference: src/metrics/icc.rs:33-130):
relative-colorimetric intent, no black-point compensation.  The metrics
always receive sRGB: ICC transforms happen once per image on the host,
before anything reaches the card.  PIL is imported only when a profile is
not sRGB, so sRGB pairs need no PIL.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .errors import MetricCalculationError


@dataclass
class ColorProfile:
    """Either sRGB or an embedded ICC profile.
    reference: src/metrics/icc.rs:33."""

    icc_data: Optional[bytes] = None

    @classmethod
    def srgb(cls) -> "ColorProfile":
        return cls(None)

    @classmethod
    def icc(cls, data: bytes) -> "ColorProfile":
        return cls(bytes(data))

    @classmethod
    def from_icc_bytes(cls, icc: Optional[bytes]) -> "ColorProfile":
        """sRGB unless ``icc`` is non-empty bytes.
        reference: src/metrics/icc.rs:50-55."""
        if icc:
            return cls.icc(icc)
        return cls.srgb()

    @property
    def is_srgb(self) -> bool:
        return self.icc_data is None


def transform_to_srgb(rgb_u8: np.ndarray, icc_profile: bytes) -> np.ndarray:
    """Transform (H, W, 3) u8 pixels tagged with ``icc_profile`` into sRGB.
    reference: src/metrics/icc.rs:69-103."""
    try:
        from PIL import Image, ImageCms
    except ImportError as e:
        raise MetricCalculationError("ICC", f"PIL/ImageCms unavailable: {e}") from e

    try:
        src = ImageCms.ImageCmsProfile(io.BytesIO(icc_profile))
        dst = ImageCms.createProfile("sRGB")
        im = Image.fromarray(rgb_u8, mode="RGB")
        transform = ImageCms.buildTransform(
            src, dst, "RGB", "RGB", renderingIntent=ImageCms.Intent.RELATIVE_COLORIMETRIC
        )
        return np.asarray(ImageCms.applyTransform(im, transform))
    except Exception as e:  # noqa: BLE001 - any lcms2 failure is the metric's error
        raise MetricCalculationError("ICC", f"transform failed: {e}") from e


def prepare_for_comparison(
    reference_rgb: np.ndarray,
    reference_profile: ColorProfile,
    test_rgb: np.ndarray,
    test_profile: ColorProfile,
) -> tuple[np.ndarray, np.ndarray]:
    """Bring both images into sRGB for metric calculation.
    reference: src/metrics/icc.rs:121-130."""
    ref = (
        reference_rgb
        if reference_profile.is_srgb
        else transform_to_srgb(reference_rgb, reference_profile.icc_data)
    )
    test = test_rgb if test_profile.is_srgb else transform_to_srgb(test_rgb, test_profile.icc_data)
    return ref, test
