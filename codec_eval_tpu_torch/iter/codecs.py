"""Codec builders for the fast-iteration CLI.

Port of ``codec_eval_tpu/iter/codecs.py`` (reference:
crates/codec-iter/src/{config.rs,avif_config.rs,main.rs:252-295}), the
same code for the PIL encoders: format dispatch with JPEG
subsampling/progressive knobs and named AVIF presets, each yielding a
``Codec`` closure pair with a config-summary string used as the baseline
key.  ``TpuJpegIterConfig`` is the in-house JPEG encoder's slot (the
reference's zenjpeg, with its XYB mode); its analysis and decode run on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..errors import UnsupportedFormat
from .eval import Codec


def _pil_decode(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(io.BytesIO(data)).convert("RGB"))


@dataclass
class JpegIterConfig:
    """reference: crates/codec-iter/src/config.rs:5-20."""

    subsampling: str = "420"  # 420 | 444 | 422 | 440
    progressive: bool = True

    _PIL_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}

    def summary(self) -> str:
        prog = "prog" if self.progressive else "base"
        return f"jpeg-{self.subsampling}-ycbcr-{prog}"

    def build(self) -> Codec:
        from PIL import Image

        sub = self._PIL_SUBSAMPLING.get(self.subsampling)
        if sub is None:
            raise UnsupportedFormat(
                f"subsampling {self.subsampling} not supported by this encoder"
            )

        def encode(rgb: np.ndarray, quality: int) -> bytes:
            buf = io.BytesIO()
            Image.fromarray(rgb).save(
                buf,
                "JPEG",
                quality=int(quality),
                subsampling=sub,
                progressive=self.progressive,
                optimize=True,
            )
            return buf.getvalue()

        return Codec(encode=encode, decode=_pil_decode, summary=self.summary())


#: AVIF preset ladder: aom effort points standing in for the reference's
#: rav1e tuning presets (crates/codec-iter/src/avif_config.rs:33-68).
AVIF_PRESETS: Dict[str, dict] = {
    "baseline": {"speed": 6, "subsampling": "4:2:0"},
    "slow": {"speed": 4, "subsampling": "4:2:0"},
    "slower": {"speed": 2, "subsampling": "4:2:0"},
    "fast": {"speed": 8, "subsampling": "4:2:0"},
    "444": {"speed": 6, "subsampling": "4:4:4"},
    "slow-444": {"speed": 4, "subsampling": "4:4:4"},
}


@dataclass
class AvifIterConfig:
    preset: str = "baseline"

    def summary(self) -> str:
        p = AVIF_PRESETS[self.preset]
        return f"avif-aom-s{p['speed']}-{self.preset}"

    def build(self) -> Codec:
        from PIL import Image

        if self.preset not in AVIF_PRESETS:
            raise UnsupportedFormat(
                f"unknown avif preset {self.preset}; known: {sorted(AVIF_PRESETS)}"
            )
        p = AVIF_PRESETS[self.preset]

        def encode(rgb: np.ndarray, quality: int) -> bytes:
            buf = io.BytesIO()
            Image.fromarray(rgb).save(
                buf,
                "AVIF",
                quality=int(quality),
                speed=p["speed"],
                subsampling=p["subsampling"],
            )
            return buf.getvalue()

        return Codec(encode=encode, decode=_pil_decode, summary=self.summary())


@dataclass
class TpuJpegIterConfig:
    """The in-house jpegli-style encoder (``codecs.tpujpeg``) in the
    iteration loop: the reference's zenjpeg format slot, XYB axis included
    (crates/codec-iter/src/config.rs:5-67)."""

    subsampling: str = "420"
    adaptive: bool = True
    xyb: bool = False
    progressive: bool = False
    trellis: bool = False
    device: str = "cuda"

    def summary(self) -> str:
        # trellis replaces the AQ bias (TpuJpegCodec forces adaptive off)
        aq = "trellis" if self.trellis else ("aq" if self.adaptive else "plain")
        prog = "-prog" if self.progressive else ""
        if self.xyb:
            return f"tpujpeg-xyb-{aq}{prog}"
        return f"tpujpeg-{self.subsampling}-{aq}{prog}"

    def build(self) -> Codec:
        from ..codecs.tpujpeg import TpuJpegCodec
        from ..engine.image import ImageData
        from ..engine.session import EncodeRequest

        impl = TpuJpegCodec(
            subsampling=self.subsampling,
            adaptive=self.adaptive,
            colorspace="xyb" if self.xyb else "ycbcr",
            progressive=self.progressive,
            trellis=self.trellis,
            device=self.device,
        )

        def encode(rgb: np.ndarray, quality: int) -> bytes:
            return impl.encode(ImageData.rgb8(rgb), EncodeRequest(float(quality)))

        def decode(data: bytes) -> np.ndarray:
            # Through the adapter: the XYB mode's channels need the opsin
            # inverse that a plain JPEG decode does not apply.
            return impl.decode(data).to_rgb8()

        return Codec(encode=encode, decode=decode, summary=self.summary())


@dataclass
class WebpIterConfig:
    method: int = 4

    def summary(self) -> str:
        return f"webp-m{self.method}"

    def build(self) -> Codec:
        from PIL import Image

        def encode(rgb: np.ndarray, quality: int) -> bytes:
            buf = io.BytesIO()
            Image.fromarray(rgb).save(
                buf, "WEBP", quality=int(quality), method=self.method
            )
            return buf.getvalue()

        return Codec(encode=encode, decode=_pil_decode, summary=self.summary())


def build_codec(
    fmt: str,
    subsampling: str = "420",
    progressive: bool = True,
    preset: str = "baseline",
    webp_method: int = 4,
    xyb: bool = False,
    trellis: bool = False,
    device="cuda",
) -> Codec:
    """Format dispatch.  reference: crates/codec-iter/src/main.rs:252-295.
    ``device`` is where tpujpeg's analysis and decode run."""
    fmt = fmt.lower()
    if fmt in ("jpeg", "jpg"):
        return JpegIterConfig(subsampling=subsampling, progressive=progressive).build()
    if fmt == "avif":
        return AvifIterConfig(preset=preset).build()
    if fmt == "webp":
        return WebpIterConfig(method=webp_method).build()
    if fmt == "tpujpeg":
        return TpuJpegIterConfig(
            subsampling=subsampling, xyb=xyb,
            # trellis is baseline-only (its rate model is the sequential
            # (run, size) alphabet); it overrides the progressive default.
            progressive=progressive and not trellis,
            trellis=trellis,
            device=device,
        ).build()
    raise UnsupportedFormat(f"unknown format '{fmt}' (jpeg|avif|webp|tpujpeg)")
