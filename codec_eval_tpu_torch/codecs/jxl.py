"""JPEG XL codec adapter over the system libjxl C API (ctypes).

A copy of ``codec_eval_tpu/codecs/jxl.py`` (reference:
crates/codec-compare/src/encoders/jpegxl.rs:14-60): lossy VarDCT with the
cjxl quality -> distance mapping, effort 0-9 (default 7), and decoding of
any ``.jxl`` stream.  ``is_available()`` is False where the shared library
is missing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..engine.image import ImageData
from ..engine.session import EncodeRequest
from ..errors import CodecError
from .base import CodecImpl

_LIB_CANDIDATES = ["libjxl.so.0.7", "libjxl.so.0", "libjxl.so"]

# --- enums (libjxl 0.7 public headers) -------------------------------------
_JXL_TYPE_UINT8 = 2
_JXL_NATIVE_ENDIAN = 0

_JXL_ENC_SUCCESS = 0
_JXL_ENC_NEED_MORE_OUTPUT = 2

_JXL_DEC_SUCCESS = 0
_JXL_DEC_NEED_MORE_INPUT = 2
_JXL_DEC_NEED_IMAGE_OUT_BUFFER = 5
_JXL_DEC_BASIC_INFO = 0x40
_JXL_DEC_FULL_IMAGE = 0x1000


class _PixelFormat(ctypes.Structure):
    _fields_ = [
        ("num_channels", ctypes.c_uint32),
        ("data_type", ctypes.c_int),
        ("endianness", ctypes.c_int),
        ("align", ctypes.c_size_t),
    ]


class _PreviewHeader(ctypes.Structure):
    _fields_ = [("xsize", ctypes.c_uint32), ("ysize", ctypes.c_uint32)]


class _AnimationHeader(ctypes.Structure):
    _fields_ = [
        ("tps_numerator", ctypes.c_uint32),
        ("tps_denominator", ctypes.c_uint32),
        ("num_loops", ctypes.c_uint32),
        ("have_timecodes", ctypes.c_int32),
    ]


class _BasicInfo(ctypes.Structure):
    """JxlBasicInfo, libjxl 0.7 layout (trailing padding oversized: the
    library only touches sizeof(its JxlBasicInfo) <= sizeof(this))."""

    _fields_ = [
        ("have_container", ctypes.c_int32),
        ("xsize", ctypes.c_uint32),
        ("ysize", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("exponent_bits_per_sample", ctypes.c_uint32),
        ("intensity_target", ctypes.c_float),
        ("min_nits", ctypes.c_float),
        ("relative_to_max_display", ctypes.c_int32),
        ("linear_below", ctypes.c_float),
        ("uses_original_profile", ctypes.c_int32),
        ("have_preview", ctypes.c_int32),
        ("have_animation", ctypes.c_int32),
        ("orientation", ctypes.c_int),
        ("num_color_channels", ctypes.c_uint32),
        ("num_extra_channels", ctypes.c_uint32),
        ("alpha_bits", ctypes.c_uint32),
        ("alpha_exponent_bits", ctypes.c_uint32),
        ("alpha_premultiplied", ctypes.c_int32),
        ("preview", _PreviewHeader),
        ("animation", _AnimationHeader),
        ("intrinsic_xsize", ctypes.c_uint32),
        ("intrinsic_ysize", ctypes.c_uint32),
        ("padding", ctypes.c_uint8 * 200),
    ]


class _ColorEncoding(ctypes.Structure):
    """JxlColorEncoding (only ever filled by JxlColorEncodingSetToSRGB)."""

    _fields_ = [
        ("color_space", ctypes.c_int),
        ("white_point", ctypes.c_int),
        ("white_point_xy", ctypes.c_double * 2),
        ("primaries", ctypes.c_int),
        ("primaries_red_xy", ctypes.c_double * 2),
        ("primaries_green_xy", ctypes.c_double * 2),
        ("primaries_blue_xy", ctypes.c_double * 2),
        ("transfer_function", ctypes.c_int),
        ("gamma", ctypes.c_double),
        ("rendering_intent", ctypes.c_int),
    ]


_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    for name in _LIB_CANDIDATES:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            lib.JxlEncoderCreate.restype = ctypes.c_void_p
            lib.JxlEncoderCreate.argtypes = [ctypes.c_void_p]
            lib.JxlEncoderDestroy.argtypes = [ctypes.c_void_p]
            lib.JxlEncoderVersion.restype = ctypes.c_uint32
            lib.JxlEncoderSetBasicInfo.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_BasicInfo)]
            lib.JxlEncoderInitBasicInfo.argtypes = [ctypes.POINTER(_BasicInfo)]
            lib.JxlColorEncodingSetToSRGB.argtypes = [
                ctypes.POINTER(_ColorEncoding), ctypes.c_int32]
            lib.JxlEncoderSetColorEncoding.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_ColorEncoding)]
            lib.JxlEncoderOptionsCreate.restype = ctypes.c_void_p
            lib.JxlEncoderOptionsCreate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p]
            lib.JxlEncoderOptionsSetDistance.argtypes = [
                ctypes.c_void_p, ctypes.c_float]
            lib.JxlEncoderOptionsSetEffort.argtypes = [
                ctypes.c_void_p, ctypes.c_int]
            lib.JxlEncoderAddImageFrame.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_PixelFormat),
                ctypes.c_void_p, ctypes.c_size_t]
            lib.JxlEncoderCloseInput.argtypes = [ctypes.c_void_p]
            lib.JxlEncoderProcessOutput.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t)]

            lib.JxlDecoderCreate.restype = ctypes.c_void_p
            lib.JxlDecoderCreate.argtypes = [ctypes.c_void_p]
            lib.JxlDecoderDestroy.argtypes = [ctypes.c_void_p]
            lib.JxlDecoderSubscribeEvents.argtypes = [
                ctypes.c_void_p, ctypes.c_int]
            lib.JxlDecoderSetInput.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
            lib.JxlDecoderCloseInput.argtypes = [ctypes.c_void_p]
            lib.JxlDecoderProcessInput.argtypes = [ctypes.c_void_p]
            lib.JxlDecoderGetBasicInfo.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_BasicInfo)]
            lib.JxlDecoderImageOutBufferSize.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_PixelFormat),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.JxlDecoderSetImageOutBuffer.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(_PixelFormat),
                ctypes.c_void_p, ctypes.c_size_t]
            lib.JxlSignatureCheck.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        except AttributeError:
            continue
        _lib = lib
        return lib
    _lib_failed = True
    return None


def is_available() -> bool:
    return _load() is not None


def quality_to_distance(quality: float) -> float:
    """The public cjxl quality->Butteraugli-distance mapping
    (libjxl JxlEncoderDistanceFromQuality; quality 90 ~ distance 1.0)."""
    if quality >= 100.0:
        return 0.0
    if quality >= 30.0:
        return 0.1 + (100.0 - quality) * 0.09
    return 53.0 / 3000.0 * quality * quality - 23.0 / 20.0 * quality + 25.0


def encode_jxl(rgb: np.ndarray, quality: float, effort: int = 7) -> bytes:
    """Encode (H, W, 3) u8 sRGB to lossy VarDCT JPEG XL bytes."""
    lib = _load()
    if lib is None:
        raise CodecError("jpegxl", "libjxl not available")
    h, w = rgb.shape[:2]
    rgb = np.ascontiguousarray(rgb[..., :3], dtype=np.uint8)

    enc = lib.JxlEncoderCreate(None)
    if not enc:
        raise CodecError("jpegxl", "JxlEncoderCreate failed")
    try:
        info = _BasicInfo()
        lib.JxlEncoderInitBasicInfo(ctypes.byref(info))
        info.xsize, info.ysize = w, h
        info.bits_per_sample = 8
        info.num_color_channels = 3
        info.uses_original_profile = 0  # allow XYB (lossy) transform
        if lib.JxlEncoderSetBasicInfo(enc, ctypes.byref(info)) != _JXL_ENC_SUCCESS:
            raise CodecError("jpegxl", "SetBasicInfo failed")
        ce = _ColorEncoding()
        lib.JxlColorEncodingSetToSRGB(ctypes.byref(ce), 0)
        if lib.JxlEncoderSetColorEncoding(enc, ctypes.byref(ce)) != _JXL_ENC_SUCCESS:
            raise CodecError("jpegxl", "SetColorEncoding failed")

        opts = lib.JxlEncoderOptionsCreate(enc, None)
        lib.JxlEncoderOptionsSetDistance(opts, quality_to_distance(quality))
        lib.JxlEncoderOptionsSetEffort(opts, int(effort))

        fmt = _PixelFormat(3, _JXL_TYPE_UINT8, _JXL_NATIVE_ENDIAN, 0)
        if (
            lib.JxlEncoderAddImageFrame(opts, ctypes.byref(fmt), rgb.ctypes.data, rgb.nbytes)
            != _JXL_ENC_SUCCESS
        ):
            raise CodecError("jpegxl", "AddImageFrame failed")
        lib.JxlEncoderCloseInput(enc)

        out = bytearray()
        chunk = (ctypes.c_uint8 * (1 << 20))()
        while True:
            next_out = ctypes.cast(chunk, ctypes.POINTER(ctypes.c_uint8))
            avail = ctypes.c_size_t(len(chunk))
            status = lib.JxlEncoderProcessOutput(
                enc, ctypes.byref(next_out), ctypes.byref(avail)
            )
            produced = len(chunk) - avail.value
            out += bytes(chunk[:produced])
            if status == _JXL_ENC_SUCCESS:
                return bytes(out)
            if status != _JXL_ENC_NEED_MORE_OUTPUT:
                raise CodecError("jpegxl", f"ProcessOutput status {status}")
    finally:
        lib.JxlEncoderDestroy(enc)


def decode_jxl(data: bytes) -> np.ndarray:
    """Decode JPEG XL bytes to (H, W, 3) u8 RGB."""
    lib = _load()
    if lib is None:
        raise CodecError("jpegxl", "libjxl not available")
    dec = lib.JxlDecoderCreate(None)
    if not dec:
        raise CodecError("jpegxl", "JxlDecoderCreate failed")
    buf_bytes = ctypes.create_string_buffer(bytes(data), len(data))
    try:
        lib.JxlDecoderSubscribeEvents(
            dec, _JXL_DEC_BASIC_INFO | _JXL_DEC_FULL_IMAGE
        )
        lib.JxlDecoderSetInput(dec, buf_bytes, len(data))
        lib.JxlDecoderCloseInput(dec)
        fmt = _PixelFormat(3, _JXL_TYPE_UINT8, _JXL_NATIVE_ENDIAN, 0)
        info = _BasicInfo()
        pixels = None
        while True:
            status = lib.JxlDecoderProcessInput(dec)
            if status == _JXL_DEC_BASIC_INFO:
                if lib.JxlDecoderGetBasicInfo(dec, ctypes.byref(info)) != 0:
                    raise CodecError("jpegxl", "GetBasicInfo failed")
            elif status == _JXL_DEC_NEED_IMAGE_OUT_BUFFER:
                size = ctypes.c_size_t()
                lib.JxlDecoderImageOutBufferSize(
                    dec, ctypes.byref(fmt), ctypes.byref(size)
                )
                pixels = np.empty(size.value, dtype=np.uint8)
                lib.JxlDecoderSetImageOutBuffer(
                    dec, ctypes.byref(fmt), pixels.ctypes.data, pixels.nbytes
                )
            elif status == _JXL_DEC_FULL_IMAGE:
                pass  # frame done; continue to SUCCESS
            elif status == _JXL_DEC_SUCCESS:
                if pixels is None:
                    raise CodecError("jpegxl", "no image decoded")
                return pixels.reshape(info.ysize, info.xsize, 3)
            elif status == _JXL_DEC_NEED_MORE_INPUT:
                raise CodecError("jpegxl", "truncated JPEG XL stream")
            else:
                raise CodecError("jpegxl", f"decode status {status}")
    finally:
        lib.JxlDecoderDestroy(dec)


class JpegXlCodec(CodecImpl):
    """Lossy JPEG XL via the system libjxl.

    reference: crates/codec-compare/src/encoders/jpegxl.rs:14-60 (speed 0-9,
    default 7; quality mapped to Butteraugli distance).
    """

    def __init__(self, effort: int = 7):
        self.effort = int(effort)

    def id(self) -> str:
        return "jpegxl" if self.effort == 7 else f"jpegxl-e{self.effort}"

    def version(self) -> str:
        lib = _load()
        if lib is None:
            return "unavailable"
        v = int(lib.JxlEncoderVersion())
        return f"{v // 1_000_000}.{v // 1000 % 1000}.{v % 1000}"

    def format(self) -> str:
        return "jxl"

    def is_available(self) -> bool:
        return is_available()

    def encode(self, image: ImageData, request: EncodeRequest) -> bytes:
        return encode_jxl(image.to_rgb8(), float(request.quality), self.effort)

    def decode(self, data: bytes) -> ImageData:
        return ImageData(decode_jxl(data))


__all__ = [
    "JpegXlCodec",
    "decode_jxl",
    "encode_jxl",
    "is_available",
    "quality_to_distance",
]
