"""Host-side sRGB decoding for staging.

The counterpart of ``codec_eval_tpu/utils/native.py:srgb_to_linear_host``
in its numpy lookup-table form only: the port builds no native host
library (its only compiled code is the kernels under ``csrc/``).
"""

from __future__ import annotations

import functools

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
