"""Codec adapter contract and shared constants.

A copy of ``codec_eval_tpu/codecs/base.py`` (reference:
crates/codec-compare/src/encoders/mod.rs:21-85).  Codecs are opaque host
byte producers behind the encode/decode callbacks; only their decodes reach
the card, through the session's batch scorer.
"""

from __future__ import annotations

import abc
from typing import Callable

from ..engine.image import ImageData
from ..engine.session import EncodeRequest

#: Standard 8-point quality ladder.
#: reference: crates/codec-compare/src/encoders/mod.rs:85
STANDARD_QUALITY_LEVELS = [50.0, 60.0, 70.0, 75.0, 80.0, 85.0, 90.0, 95.0]


class CodecImpl(abc.ABC):
    """Adapter contract between a concrete codec and the EvalSession."""

    @abc.abstractmethod
    def id(self) -> str:
        """Unique identifier, e.g. "jpeg-420-prog"."""

    @abc.abstractmethod
    def version(self) -> str:
        """Version string of the underlying encoder."""

    @abc.abstractmethod
    def format(self) -> str:
        """Output extension, e.g. "jpg", "webp", "avif"."""

    @abc.abstractmethod
    def encode(self, image: ImageData, request: EncodeRequest) -> bytes:
        ...

    @abc.abstractmethod
    def decode(self, data: bytes) -> ImageData:
        ...

    def is_available(self) -> bool:
        return True

    # EvalSession-compatible callables.
    def encode_fn(self) -> Callable[[ImageData, EncodeRequest], bytes]:
        return self.encode

    def decode_fn(self) -> Callable[[bytes], ImageData]:
        return self.decode


#: Chart palette per codec id.
#: reference: crates/codec-compare/src/encoders/mod.rs:44-77
_CODEC_COLORS = {
    "mozjpeg": "#e74c3c",
    "jpegli": "#3498db",
    "libjpeg-turbo": "#95a5a6",
    "jpeg": "#e74c3c",
    "zenjpeg": "#2ecc71",
    "tpujpeg": "#2ecc71",
    "webp": "#27ae60",
    "avif-aom": "#9b59b6",
    "avif-rav1e": "#e67e22",
    "avif-rav1e-qm": "#d35400",
    "avif-rav1e-qm-cdef": "#c0392b",
    "avif-rav1e-qm-rdotx": "#8e44ad",
    "avif-rav1e-qm-vaq15": "#16a085",
    "avif-rav1e-qm-cdef-rdotx": "#2980b9",
    "avif-rav1e-qm-seg125": "#27ae60",
    "avif-rav1e-qm-seg150": "#1abc9c",
    "avif-rav1e-qm-seg2": "#f1c40f",
    "avif-rav1e-qm-rdotx-seg2": "#e91e63",
    "avif-svt": "#1abc9c",
    "jpegxl": "#f39c12",
}


def codec_color(codec_id: str) -> str:
    """Chart color for a codec id (family prefix match, then default)."""
    if codec_id in _CODEC_COLORS:
        return _CODEC_COLORS[codec_id]
    for key, color in _CODEC_COLORS.items():
        if codec_id.startswith(key):
            return color
    return "#34495e"
