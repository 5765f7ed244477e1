"""ImageData: the input-image contract of the evaluation engine.

A copy of ``codec_eval_tpu/engine/image.py`` (reference:
src/eval/session.rs:25-148): an (H, W, 3|4) u8 image with an optional ICC
profile.  Alpha is dropped at the RGB8 boundary; an ICC-tagged image is
brought to sRGB on the host (``color.transform_to_srgb``, lcms2 through
PIL) before its pixels reach the card.  PIL is imported only to open a file
or to apply a profile, so sRGB arrays need no PIL.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..errors import DimensionMismatch, ImageLoadError


@dataclass
class ImageData:
    """An RGB(A) image with optional ICC profile.

    ``data`` is (H, W, 3) or (H, W, 4) uint8, row-major.
    """

    data: np.ndarray
    icc_profile: Optional[bytes] = None

    def __post_init__(self) -> None:
        if self.data.ndim != 3 or self.data.shape[2] not in (3, 4):
            raise ImageLoadError(
                f"ImageData expects (H, W, 3|4) u8, got {self.data.shape}"
            )
        if self.data.dtype != np.uint8:
            raise ImageLoadError(f"ImageData expects uint8, got {self.data.dtype}")

    # -- constructors (mirror the reference's variants) --------------------
    @classmethod
    def rgb8(cls, data: np.ndarray) -> "ImageData":
        return cls(np.ascontiguousarray(data[..., :3]))

    @classmethod
    def rgba8(cls, data: np.ndarray) -> "ImageData":
        assert data.shape[2] == 4
        return cls(np.ascontiguousarray(data))

    @classmethod
    def rgb_slice(cls, data: bytes | np.ndarray, width: int, height: int) -> "ImageData":
        arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
        return cls(np.ascontiguousarray(arr.reshape(height, width, 3)))

    @classmethod
    def rgba_slice(cls, data: bytes | np.ndarray, width: int, height: int) -> "ImageData":
        arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
        return cls(np.ascontiguousarray(arr.reshape(height, width, 4)))

    @classmethod
    def rgb_slice_with_icc(
        cls, data: bytes | np.ndarray, width: int, height: int, icc_profile: bytes
    ) -> "ImageData":
        img = cls.rgb_slice(data, width, height)
        img.icc_profile = icc_profile
        return img

    @classmethod
    def open(cls, path) -> "ImageData":
        """Load from a file via PIL, preserving any embedded ICC profile."""
        from PIL import Image

        try:
            with Image.open(path) as im:
                icc = im.info.get("icc_profile")
                if im.mode not in ("RGB", "RGBA"):
                    im = im.convert("RGB")
                arr = np.asarray(im)
        except Exception as e:  # noqa: BLE001 - mirrors reference ImageLoad error
            raise ImageLoadError(f"failed to load {path}: {e}") from e
        return cls(np.ascontiguousarray(arr), icc_profile=icc)

    # -- accessors ---------------------------------------------------------
    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    def to_rgb8(self) -> np.ndarray:
        """(H, W, 3) u8 view/copy, alpha dropped; no ICC transform.
        reference: src/eval/session.rs:98-117 (``to_rgb8_vec``)."""
        if self.data.shape[2] == 3:
            return self.data
        return np.ascontiguousarray(self.data[..., :3])

    def to_rgb8_vec(self) -> bytes:
        """Flat RGB8 bytes (API-parity helper)."""
        return self.to_rgb8().tobytes()

    def color_profile(self):
        from ..color import ColorProfile

        if self.icc_profile is not None:
            return ColorProfile.icc(self.icc_profile)
        return ColorProfile.srgb()

    def to_rgb8_srgb(self) -> np.ndarray:
        """(H, W, 3) u8 in sRGB, applying the ICC profile if present.
        reference: src/eval/session.rs:143-148."""
        rgb = self.to_rgb8()
        if self.icc_profile is None:
            return rgb
        from ..color import transform_to_srgb

        return transform_to_srgb(rgb, self.icc_profile)
