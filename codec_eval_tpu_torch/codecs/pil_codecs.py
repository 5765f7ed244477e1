"""Codec adapters over the system image libraries, through PIL.

A copy of ``codec_eval_tpu/codecs/pil_codecs.py`` (reference:
crates/codec-compare/src/encoders/{jpeg,webp,avif}.rs): JPEG (4:2:0 and
4:4:4, with and without optimized Huffman tables), WebP, AVIF presets and
lossless PNG, and the stubs of the adapters this environment lacks.  PIL is
imported when an adapter is used, not at import: a machine without PIL
still imports the package, and ``is_available()`` says False there.
"""

from __future__ import annotations

import io
from typing import List, Optional

import numpy as np

from ..engine.image import ImageData
from ..engine.session import EncodeRequest
from ..errors import CodecError
from .base import CodecImpl


def _pil_version(feature: Optional[str] = None) -> str:
    try:
        from PIL import __version__, features

        if feature:
            v = features.version(feature)
            if v:
                return str(v)
        return __version__
    except Exception:  # noqa: BLE001
        return "unknown"


def _decode_with_pil(data: bytes) -> ImageData:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        icc = im.info.get("icc_profile")
        if im.mode not in ("RGB", "RGBA"):
            im = im.convert("RGB")
        arr = np.asarray(im)
    img = ImageData(np.ascontiguousarray(arr))
    img.icc_profile = icc
    return img


class _PilCodec(CodecImpl):
    """Shared encode/decode plumbing for PIL-backed formats."""

    _pil_format: str = ""
    _format_ext: str = ""
    _feature: Optional[str] = None

    def format(self) -> str:
        return self._format_ext

    def version(self) -> str:
        return _pil_version(self._feature)

    def is_available(self) -> bool:
        if self._feature is None:
            return True
        try:
            from PIL import features

            return bool(features.check(self._feature))
        except Exception:  # noqa: BLE001
            return False

    def _save_kwargs(self, request: EncodeRequest) -> dict:
        raise NotImplementedError

    def encode(self, image: ImageData, request: EncodeRequest) -> bytes:
        from PIL import Image

        try:
            buf = io.BytesIO()
            Image.fromarray(image.to_rgb8()).save(
                buf, self._pil_format, **self._save_kwargs(request)
            )
            return buf.getvalue()
        except Exception as e:  # noqa: BLE001
            raise CodecError(self.id(), f"encode failed: {e}") from e

    def decode(self, data: bytes) -> ImageData:
        try:
            return _decode_with_pil(data)
        except Exception as e:  # noqa: BLE001
            raise CodecError(self.id(), f"decode failed: {e}") from e


class JpegCodec(_PilCodec):
    """libjpeg-turbo with the reference's 4 variant axes
    (4:2:0/4:4:4 x progressive/baseline), optimized entropy coding."""

    _pil_format = "JPEG"
    _format_ext = "jpg"
    _feature = "jpg"

    #: PIL subsampling codes.
    _SUBSAMPLING = {"444": 0, "422": 1, "420": 2}

    def __init__(self, subsampling: str = "420", progressive: bool = True):
        assert subsampling in self._SUBSAMPLING
        self.subsampling = subsampling
        self.progressive = progressive

    def id(self) -> str:
        mode = "prog" if self.progressive else "base"
        return f"jpeg-{self.subsampling}-{mode}"

    def _save_kwargs(self, request: EncodeRequest) -> dict:
        return {
            "quality": int(round(request.quality)),
            "subsampling": self._SUBSAMPLING[self.subsampling],
            "progressive": self.progressive,
            "optimize": True,
        }

    @classmethod
    def all_variants(cls) -> List["JpegCodec"]:
        """The reference's 4-variant matrix
        (crates/codec-compare/src/encoders/jpeg.rs:57-120)."""
        return [
            cls("420", True),
            cls("420", False),
            cls("444", True),
            cls("444", False),
        ]


class WebPCodec(_PilCodec):
    """libwebp lossy.  reference: crates/codec-compare/src/encoders/webp.rs."""

    _pil_format = "WEBP"
    _format_ext = "webp"
    _feature = "webp"

    def __init__(self, method: int = 4):
        self.method = method

    def id(self) -> str:
        return "webp" if self.method == 4 else f"webp-m{self.method}"

    def _save_kwargs(self, request: EncodeRequest) -> dict:
        return {
            "quality": int(round(request.quality)),
            "method": self.method,
        }


class AvifCodec(_PilCodec):
    """libavif/aom with codec-specific tuning, mirroring the reference's
    rav1e preset ladder (crates/codec-iter/src/avif_config.rs:33-68).

    The ``advanced`` dict is passed to aom via libavif's codec-specific
    options (the analog of rav1e's qm/cdef/rdo knobs).  Empirically
    effective through this path: ``enable-qm`` + ``qm-min``/``qm-max``
    (quantization matrices — the reference's headline ``qm`` preset),
    ``sharpness``, and ``tune`` (default ssim; psnr selectable); cdef and
    loop-restoration toggles are accepted but are no-ops in still-picture
    mode (verified by output hashing).

    Measured preset tradeoffs (tools/avif_ladder_bench.py: 512px images x
    q=35..85, SSIMULACRA2 BD-rate vs `baseline`, encode-time ratio;
    negative = smaller files at equal quality).  Every number is labeled
    with its corpus — the two corpora disagree sharply, which is itself
    the finding:

    ========== ================== ====== ================== ======
    .          synthetic-photo-v1        synthetic-trig
    preset     BD-rate(s2) (2026-08-19)  BD-rate(s2) (2026-08-16)
    ========== ================== ====== ================== ======
    fast            +0.1%          0.43       +47.6%          0.32
    slow            -0.8%          6.01       -18.0%          3.76
    444            -16.4%          0.97       -55.3%          1.18
    qm             +14.3%          0.77        +3.2%          1.06
    qm-full        +15.9%          0.54        +6.3%          0.95
    qm-444          -2.9%          0.68       -52.6%          1.00
    qm-sharp       +13.6%          0.63        +2.9%          0.74
    qm-slow         +7.2%          2.60       -15.4%          5.94
    tune-psnr       +0.3%          0.48        -0.3%          1.64
    ========== ================== ====== ================== ======

    Reading: the trig corpus's saturated high-frequency chroma exaggerates
    4:4:4 (-55%) — on photo-statistics content (1/f spectra + film grain,
    iter.source.photo_sources) the 4:4:4 win shrinks to -16% and aom's
    quantization-matrix presets HURT (+14%), because qm deletes exactly the
    grain/texture SSIMULACRA2 scores.  The reference's qm ~ -10% claim is
    rav1e-on-CID22 (avif_config.rs:3-7) — a different encoder's qm on real
    photographs; treat these aom-knob numbers as this framework's own
    measurements, not a reproduction of that claim.  Re-measure on a real
    corpus before quoting for production ladders.
    """

    _pil_format = "AVIF"
    _format_ext = "avif"
    _feature = "avif"

    def __init__(
        self,
        speed: int = 6,
        subsampling: str = "4:2:0",
        label: str = "",
        advanced: Optional[dict] = None,
    ):
        self.speed = speed
        self.subsampling = subsampling
        self.label = label
        self.advanced = dict(advanced) if advanced else None

    def id(self) -> str:
        if self.label:
            return f"avif-aom-{self.label}"
        return f"avif-aom-s{self.speed}"

    def _save_kwargs(self, request: EncodeRequest) -> dict:
        kwargs = {
            "quality": int(round(request.quality)),
            "speed": self.speed,
            "subsampling": self.subsampling,
        }
        if self.advanced:
            kwargs["advanced"] = self.advanced
        return kwargs

    @classmethod
    def presets(cls) -> List["AvifCodec"]:
        """Named preset ladder; BD-rate (SSIMULACRA2) / time vs `baseline`
        measured by tools/avif_ladder_bench.py (2026-08-16 run, see tool)."""
        qm = {"enable-qm": "1"}
        return [
            cls(speed=6, label="baseline"),  # reference point
            cls(speed=8, label="fast"),  # iteration speed
            cls(speed=4, label="slow"),  # more RDO effort
            cls(speed=6, subsampling="4:4:4", label="444"),
            cls(speed=6, label="qm", advanced=qm),
            cls(
                speed=6,
                label="qm-full",
                advanced={"enable-qm": "1", "qm-min": "0", "qm-max": "8"},
            ),
            cls(speed=6, subsampling="4:4:4", label="qm-444", advanced=qm),
            cls(
                speed=6,
                label="qm-sharp",
                advanced={"enable-qm": "1", "sharpness": "2"},
            ),
            cls(speed=4, label="qm-slow", advanced=qm),
            cls(speed=6, label="tune-psnr", advanced={"tune": "psnr"}),
        ]


class PngCodec(_PilCodec):
    """Lossless PNG anchor codec."""

    _pil_format = "PNG"
    _format_ext = "png"
    _feature = None

    def id(self) -> str:
        return "png"

    def _save_kwargs(self, request: EncodeRequest) -> dict:
        return {"optimize": True}


class UnavailableCodec(CodecImpl):
    """A codec with no backend in this environment; registry skips it.

    Mirrors the reference's feature-stubbed adapters that return
    ``is_available() == false`` when their crate feature is off."""

    def __init__(self, codec_id: str, fmt: str, reason: str):
        self._id = codec_id
        self._fmt = fmt
        self.reason = reason

    def id(self) -> str:
        return self._id

    def version(self) -> str:
        return "unavailable"

    def format(self) -> str:
        return self._fmt

    def is_available(self) -> bool:
        return False

    def encode(self, image: ImageData, request: EncodeRequest) -> bytes:
        raise CodecError(self._id, f"not available: {self.reason}")

    def decode(self, data: bytes) -> ImageData:
        raise CodecError(self._id, f"not available: {self.reason}")


def jpegxl_stub() -> UnavailableCodec:
    """Fallback when libjxl is absent; the real adapter is codecs/jxl.py
    (ctypes over the system libjxl, encode + decode)."""
    return UnavailableCodec(
        "jpegxl", "jxl", "libjxl shared library not found on this system"
    )


def jpegli_stub() -> UnavailableCodec:
    return UnavailableCodec(
        "jpegli",
        "jpg",
        "jpegli not present; tpujpeg-* fills the jpegli-style ladder slot",
    )
