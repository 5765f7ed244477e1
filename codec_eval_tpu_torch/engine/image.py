"""ImageData: the input-image contract of the evaluation engine.

The subset of ``codec_eval_tpu/engine/image.py`` the scoring path needs: an
(H, W, 3|4) u8 image, alpha dropped at the RGB8 boundary.  ICC transforms
are not ported, so an image with an ICC profile is refused rather than
scored in the wrong colour space.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..errors import ImageLoadError, UnsupportedFormat


@dataclass
class ImageData:
    """An RGB(A) image; ``data`` is (H, W, 3) or (H, W, 4) uint8, row-major."""

    data: np.ndarray
    icc_profile: Optional[bytes] = None

    def __post_init__(self) -> None:
        if self.data.ndim != 3 or self.data.shape[2] not in (3, 4):
            raise ImageLoadError(
                f"ImageData expects (H, W, 3|4) u8, got {self.data.shape}"
            )
        if self.data.dtype != np.uint8:
            raise ImageLoadError(f"ImageData expects uint8, got {self.data.dtype}")

    @classmethod
    def rgb8(cls, data: np.ndarray) -> "ImageData":
        return cls(np.ascontiguousarray(data[..., :3]))

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    def to_rgb8(self) -> np.ndarray:
        """(H, W, 3) u8 view/copy, alpha dropped; no ICC transform."""
        if self.data.shape[2] == 3:
            return self.data
        return np.ascontiguousarray(self.data[..., :3])

    def to_rgb8_srgb(self) -> np.ndarray:
        """(H, W, 3) u8 in sRGB."""
        if self.icc_profile is not None:
            raise UnsupportedFormat("ICC-tagged images are not supported by the port yet")
        return self.to_rgb8()
