"""Host helpers of ``codec_eval_tpu/utils/native.py``: sRGB decoding for
staging and the FNV-1a file checksum.

Both in their pure-Python forms only (a numpy lookup table, and
``corpus.checksum``'s streaming hash): the port builds no native host
library (its only compiled code is the kernels under ``csrc/``).
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
