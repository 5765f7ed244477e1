"""tpujpeg: the in-house jpegli-style JPEG encoder adapter.

Port of ``codec_eval_tpu/codecs/tpujpeg.py``.  It fills the reference's
zenjpeg slot (a self-built, jpegli-style software JPEG encoder in the
comparison ladder; reference: crates/codec-compare/src/encoders/zenjpeg.rs:
10-58, crates/codec-iter/src/config.rs:5-67).  The quality-independent
analysis (colour conversion, subsampling, every 8x8 forward DCT and the
activity field) runs on the codec's device (``kernels.jpeg_enc.transform``);
each quality is then a host quantization pass and the native optimized-
Huffman entropy coder (native/jpeg_entropy.cpp).

- Adaptive quantization through the rounding bias: the tables stay global
  (standard-decodable) while busy blocks round AC coefficients toward a
  wider deadzone.
- Optimized Huffman tables always.
- ``encode_sweep`` encodes every quality from one analysis pass, and
  ``device_sweep`` runs the whole ladder (encode, decode, score) on the
  device (``engine.tpu_sweep``).
- Trellis quantization (``trellis=True``): rate-distortion-optimal AC
  selection, the C++ DP on the host and the same DP on the device in a
  ladder; it replaces the AQ bias.

Decoding goes through ``codecs.jpeg_device`` for both the YCbCr and the XYB
(Adobe transform 0) containers.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..engine.image import ImageData
from ..engine.session import EncodeRequest
from ..errors import CodecError, CodecEvalError
from ..kernels import jpeg_enc as _je
from ..utils import native as _native
from .base import CodecImpl

__all__ = ["TpuJpegCodec", "is_available"]


def is_available() -> bool:
    """True once the native entropy coder is loaded (built at first use; a
    failed build raises)."""
    return _native.jpeg_entropy_available()


class TpuJpegCodec(CodecImpl):
    """jpegli-style baseline JPEG encoder with a device transform path.

    Parameters
    ----------
    subsampling: "420" (default), "444", "422", or "440".
    adaptive: the activity-driven rounding bias (default True; forced off
        by ``trellis``, which replaces it).
    aq_strength: the largest reduction of the AC rounding offset at full
        activity; 0.30 means busy blocks round with offset 0.5 - 0.30.
    colorspace: "ycbcr" or "xyb" (4:4:4 only, an Adobe transform-0
        container).
    progressive: the SOF2 spectral-selection scan script.
    trellis: rate-distortion-optimal AC selection (baseline only).
    trellis_lambda: the DP's bits-against-distortion weight, in
        (quantizer step)^2 per bit.
    device: where the analysis, the device ladder and the decode run: the
        card unless the caller asks for the CPU.
    """

    def __init__(
        self,
        subsampling: str = "420",
        adaptive: bool = True,
        aq_strength: float = 0.30,
        colorspace: str = "ycbcr",
        progressive: bool = False,
        trellis: bool = False,
        trellis_lambda: float = 0.10,
        device="cuda",
    ):
        if subsampling not in ("420", "444", "422", "440"):
            raise CodecError("tpujpeg", f"unsupported subsampling {subsampling!r}")
        if colorspace not in ("ycbcr", "xyb"):
            raise CodecError("tpujpeg", f"unsupported colorspace {colorspace!r}")
        if colorspace == "xyb":
            subsampling = "444"  # XYB mode is 4:4:4 only
        if trellis and progressive:
            # The trellis rate model is the baseline (run, size) alphabet.
            raise CodecError("tpujpeg", "trellis requires baseline mode")
        if trellis:
            adaptive = False
        self.subsampling = subsampling
        self.adaptive = adaptive
        self.aq_strength = float(aq_strength)
        self.colorspace = colorspace
        self.progressive = bool(progressive)
        self.trellis = bool(trellis)
        self.trellis_lambda = float(trellis_lambda)
        self.device = device
        # One-slot transform memo: a session sweeps the qualities of one
        # image, so consecutive encode() calls see the same pixels (keyed
        # by the FNV-1a of the raw bytes, so other pixels miss).
        self._memo_lock = threading.Lock()
        self._memo_key: Optional[Tuple[int, int, int]] = None
        self._memo_val: Optional[Dict[str, np.ndarray]] = None

    # -- CodecImpl ----------------------------------------------------------

    def id(self) -> str:
        aq = "-aq" if self.adaptive else ""
        prog = "-prog" if self.progressive else ""
        tre = "-trellis" if self.trellis else ""
        if self.colorspace == "xyb":
            return f"tpujpeg-xyb{aq}{tre}{prog}"
        return f"tpujpeg-{self.subsampling}{aq}{tre}{prog}"

    def version(self) -> str:
        return "1.0"

    def format(self) -> str:
        return "jpg"

    def is_available(self) -> bool:
        return is_available()

    def encode(self, image: ImageData, request: EncodeRequest) -> bytes:
        rgb = image.to_rgb8()
        tr = self._transform(rgb)
        return self._encode_from_transform(tr, rgb.shape[1], rgb.shape[0], float(request.quality))

    def decode(self, data: bytes) -> ImageData:
        from .jpeg_device import decode_jpeg_device

        try:
            return ImageData.rgb8(decode_jpeg_device(data, device=self.device))
        except (ValueError, CodecEvalError) as exc:
            raise CodecError(self.id(), f"decode failed: {exc}") from exc

    # -- sweep API ----------------------------------------------------------

    def encode_sweep(self, image: ImageData, qualities: Sequence[float]) -> List[bytes]:
        """Encode every quality level from one analysis pass."""
        rgb = image.to_rgb8()
        tr = self._transform(rgb)
        w, h = rgb.shape[1], rgb.shape[0]
        return [self._encode_from_transform(tr, w, h, float(q)) for q in qualities]

    def device_sweep(
        self,
        image: ImageData,
        qualities: Sequence[float],
        metrics: Sequence[str],
        with_bytes: bool = False,
        size_mode: str = "exact",
    ):
        """The whole ladder on the device (``engine.tpu_sweep``) with this
        codec's settings: the hook ``EvalSession`` uses to fuse encode,
        decode and scoring.  size_mode="device" takes byte sizes from the
        device rate statistics (ignored when the bytes are needed)."""
        from ..engine.tpu_sweep import evaluate_tpujpeg_sweep

        return evaluate_tpujpeg_sweep(
            image.to_rgb8(),
            qualities,
            subsampling=self.subsampling,
            aq_strength=self.aq_strength if self.adaptive else 0.0,
            metrics=metrics,
            colorspace=self.colorspace,
            progressive=self.progressive,
            return_bytes=with_bytes,
            trellis_lambda=self.trellis_lambda if self.trellis else 0.0,
            with_sizes="device" if size_mode == "device" else True,
            device=self.device,
        )

    # -- internals ----------------------------------------------------------

    def _transform(self, rgb: np.ndarray) -> Dict[str, np.ndarray]:
        key = (_native.fnv1a64(rgb), rgb.shape[0], rgb.shape[1])
        with self._memo_lock:
            if key == self._memo_key and self._memo_val is not None:
                return self._memo_val
        val = _je.jpeg_transform(rgb, self.subsampling, self.colorspace, device=self.device)
        with self._memo_lock:
            self._memo_key, self._memo_val = key, val
        return val

    def _qtables(self, quality: float):
        if self.colorspace == "xyb":
            return _je.quality_to_qtables(quality, _je.XYB_LUMA_BASE, _je.XYB_CHROMA_BASE)
        return _je.quality_to_qtables(quality)

    def _bias(self, act: np.ndarray) -> np.ndarray | float:
        if not self.adaptive:
            return 0.5
        return np.clip(0.5 - self.aq_strength * act, 0.2, 0.5).astype(np.float32)

    def _encode_from_transform(
        self, tr: Dict[str, np.ndarray], width: int, height: int, quality: float
    ) -> bytes:
        ql, qc = self._qtables(quality)
        if self.trellis:
            # The static rate tables the device DP shares, so that host and
            # device make the same decisions.
            lam = self.trellis_lambda
            qy = _je.trellis_quantize_blocks(tr["dct_y"], ql, _je.DEFAULT_AC_LENGTHS_LUMA, lam)
            qcb = _je.trellis_quantize_blocks(tr["dct_cb"], qc, _je.DEFAULT_AC_LENGTHS_CHROMA, lam)
            qcr = _je.trellis_quantize_blocks(tr["dct_cr"], qc, _je.DEFAULT_AC_LENGTHS_CHROMA, lam)
        else:
            qy = _je.quantize_blocks(tr["dct_y"], ql, self._bias(tr["act_y"]))
            qcb = _je.quantize_blocks(tr["dct_cb"], qc, self._bias(tr["act_c"]))
            qcr = _je.quantize_blocks(tr["dct_cr"], qc, self._bias(tr["act_c"]))
        return _native.jpeg_encode_baseline(
            width, height, self.subsampling,
            qy, qcb, qcr, ql[_je.ZIGZAG], qc[_je.ZIGZAG],
            app_mode=1 if self.colorspace == "xyb" else 0,
            progressive=self.progressive,
        )

    @classmethod
    def presets(cls, device="cuda") -> List["TpuJpegCodec"]:
        """The tpujpeg ladder (the zenjpeg config grid's analog,
        reference: crates/codec-iter/src/config.rs:5-67)."""
        return [
            cls(subsampling="420", adaptive=True, device=device),
            cls(subsampling="444", adaptive=True, device=device),
            cls(subsampling="420", adaptive=False, device=device),
            cls(subsampling="444", adaptive=False, device=device),
            cls(colorspace="xyb", adaptive=True, device=device),
            cls(subsampling="420", adaptive=True, progressive=True, device=device),
            cls(subsampling="420", trellis=True, device=device),
            cls(colorspace="xyb", trellis=True, device=device),
        ]
