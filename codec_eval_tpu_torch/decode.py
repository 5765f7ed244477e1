"""ICC-aware JPEG decoding for XYB-JPEG evaluation.

A copy of ``codec_eval_tpu/decode.py`` (reference: src/decode.rs:41-122):
decode a JPEG with PIL, keep its embedded ICC profile, and return an
``ImageData`` that carries it, so the session brings the decode to sRGB
before scoring.  Grayscale expands to RGB; CMYK is refused.
"""

from __future__ import annotations

import io
from typing import Callable

import numpy as np

from .engine.image import ImageData
from .errors import CodecError


def decode_jpeg_with_icc(data: bytes) -> ImageData:
    """Decode JPEG bytes; returns ImageData with icc_profile when embedded."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(data)) as im:
            if im.format != "JPEG":
                raise CodecError("jpeg-decode", f"not a JPEG (got {im.format})")
            icc = im.info.get("icc_profile")
            if im.mode == "CMYK":
                raise CodecError(
                    "jpeg-decode", "CMYK JPEGs are not currently supported"
                )
            if im.mode in ("L", "I;16"):
                # Grayscale -> RGB (16-bit takes the high byte via convert).
                im = im.convert("L").convert("RGB")
            elif im.mode != "RGB":
                im = im.convert("RGB")
            arr = np.ascontiguousarray(np.asarray(im))
    except CodecError:
        raise
    except Exception as e:  # noqa: BLE001
        raise CodecError("jpeg-decode", str(e)) from e

    img = ImageData(arr)
    if icc:
        img.icc_profile = icc
    return img


def jpeg_decode_callback() -> Callable[[bytes], ImageData]:
    """Decode callback factory for ``EvalSession.add_codec_with_decode``.
    reference: src/decode.rs:122."""
    return decode_jpeg_with_icc
