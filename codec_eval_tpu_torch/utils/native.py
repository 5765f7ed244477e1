"""Host helpers of ``codec_eval_tpu/utils/native.py``: sRGB decoding for
staging, the FNV-1a file checksum, and binary PPM reading and writing for
codec-iter's source cache.

All in their pure-Python forms only (a numpy lookup table,
``corpus.checksum``'s streaming hash, and the JAX module's Python branch of
``read_ppm`` and ``write_ppm``): the port builds no native host library
(its only compiled code is the kernels under ``csrc/``).
"""

from __future__ import annotations

import functools

from pathlib import Path

import numpy as np


@functools.lru_cache(maxsize=1)
def _lut() -> np.ndarray:
    """The 256 linear values of the sRGB u8 codes, computed in f64 and
    rounded once to f32."""
    v = np.arange(256, dtype=np.float64) / 255.0
    lut = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)
    lut.flags.writeable = False
    return lut


def srgb_to_linear_host(u8: np.ndarray) -> np.ndarray:
    """sRGB u8 -> linear f32, any shape."""
    return _lut()[np.ascontiguousarray(u8)]


def fnv1a64_file(path) -> int:
    """FNV-1a 64-bit hash of a file's bytes; raises if it cannot be read."""
    from ..corpus.checksum import fnv1a_64_file

    return fnv1a_64_file(Path(path))


def write_ppm(path, rgb: np.ndarray) -> None:
    """(H, W, 3) u8 -> a binary P6 file with maxval 255."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb).tobytes())


def read_ppm(path) -> np.ndarray:
    """A binary P6 file with maxval 255, as ``write_ppm`` writes it -> (H, W, 3) u8."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise IOError(f"not a P6 PPM: {path}")
        dims = f.readline().split()
        w_, h_ = int(dims[0]), int(dims[1])
        if int(f.readline()) != 255:
            raise IOError(f"not an 8-bit PPM: {path}")
        data = np.frombuffer(f.read(w_ * h_ * 3), dtype=np.uint8)
        return data.reshape(h_, w_, 3).copy()
