"""Operations and bytes of each kernel's work, and the least time the card
could take for it: a frozen copy of ``chip_smoke.py``'s counts (commit
80b80d3: ``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``, ``K1_OPS`` ... ``K9_REF_OPS``,
``malta_ops``, ``blur_ops``, ``bound`` and the bytes each phase counts).

A count is what the function needs, whatever a kernel does: a multiply or
an add counts one; selects, compares, abs and negation count nothing; each
input byte is read once and each output byte written once.  The peaks are
one H100 SXM's at 700 W (NVIDIA's data sheet).  The kernels are built with
``-fmad=false``, which halves the f32 rate they can issue; the published
peak stays the denominator."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..reference.butteraugli import LINES_FULL, LINES_LF

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

K1_OPS = 2 + 6 * (15 + 14) + 16 + 6 + 6 + 6
K2_OPS = 164
K3_OPS = 270
PROLOGUE_OPS = 10
EPILOGUE_OPS = 2 * 7 + 2 + 2 * 4 + 3 + 1 + 12 + 6 + 1
MASK_EPILOGUE_OPS = 3
K9_OPS = 2 + 6 * (15 + 14)
K9_REF_OPS = 1 + 4 * (15 + 14)
F32 = 4


def bound_ms(n_bytes: float, ops: float) -> float:
    """The least time (ms): the larger of bytes over the memory rate and f32
    operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def malta_ops(lines_full=LINES_FULL, lines_lf=LINES_LF) -> int:
    """Operations per pixel of the six Malta sweeps: each line's samples
    added and the sum squared, weighted where its weight is not 1, added to
    the plane's other lines; two full-pattern and four lf-pattern planes;
    then the six plane terms summed into two accumulators."""
    def per_plane(lines):
        return sum(len(line) - 1 + 1 + (weight != 1) for weight, line in lines) + len(lines) - 1

    return 2 * per_plane(lines_full) + 4 * per_plane(lines_lf) + 6 - 2


def blur_taps(sigma: float) -> int:
    """Butteraugli's tap count at ``sigma``: radius int(2.25 * sigma)."""
    return 2 * max(1, int(2.25 * sigma)) + 1


def blur_ops(sigma: float) -> int:
    """Operations per pixel of the renormalized blur: two FIR passes and
    the renormalization."""
    return 2 * (2 * blur_taps(sigma) - 1) + 1


def _numel(shape: Sequence[int]) -> int:
    return int(np.prod(shape, dtype=np.int64))


# Each function below takes the shapes (tuples) of one call's tensor
# arguments, in the wrapper's order, and its scalar arguments, and gives
# (bytes, ops) for that call.

def scale_features(shapes, scalars):
    """K1/K8: reference planes xyb1, mu1, s11 (3, h, w) and candidates xyb2
    (..., 3, h, w) -> (..., 3, 2, 3) features."""
    x2 = shapes[3]
    n = _numel(x2[:-3])
    return F32 * (sum(_numel(s) for s in shapes[:4]) + 18 * n), K1_OPS * _numel(x2)


def opsin_xyb(shapes, scalars):
    """K2: (B, 3, H, W) intensity-scaled linear RGB -> opponent XYB."""
    b, _, h, w = shapes[0]
    return F32 * (2 * _numel(shapes[0]) + h * w), K2_OPS * b * h * w


def bands(shapes, scalars):
    """K3: XYB and its LF blur (B, 3, H, W) -> seven band planes."""
    b, _, h, w = shapes[0]
    return F32 * (_numel(shapes[0]) + _numel(shapes[1]) + 7 * b * h * w + 2 * h * w), \
        K3_OPS * b * h * w


def malta_ac(shapes, scalars):
    """K4: six diff planes (B, 6, H, W) -> two accumulators."""
    b, _, h, w = shapes[0]
    return F32 * (_numel(shapes[0]) + 2 * b * h * w), malta_ops() * b * h * w


def malta_diffmap(shapes, scalars):
    """K5: band planes, masking term (B, H, W) and masks -> the diffmap."""
    b, h, w = shapes[4]
    return F32 * (sum(_numel(s) for s in shapes) + b * h * w), \
        (malta_ops() + 6 * PROLOGUE_OPS + EPILOGUE_OPS) * b * h * w


def blur(shapes, scalars):
    """K6: (B, C, H, W) planes at ``sigma`` -> their renormalized blur."""
    h, w = shapes[0][-2:]
    return F32 * (2 * _numel(shapes[0]) + h * w), blur_ops(scalars[0]) * _numel(shapes[0])


def mask_diff_ac(shapes, scalars):
    """K7: d1 (B, H, W) and b0 (H, W) -> ac_mul * (b0 - blur(d1))^2."""
    sigma = scalars[1] if len(scalars) > 1 else 2.7
    return F32 * (2 * _numel(shapes[0]) + 2 * _numel(shapes[1])), \
        (blur_ops(sigma) + MASK_EPILOGUE_OPS) * _numel(shapes[0])


def candidate_moments(shapes, scalars):
    """K9: x1, x2 (N, 3, h, w) -> the three blurred moments."""
    return F32 * 5 * _numel(shapes[1]), K9_OPS * _numel(shapes[1])


def reference_moments(shapes, scalars):
    """K9's reference form: x1 (N, 3, h, w) -> the two blurred moments."""
    return F32 * 3 * _numel(shapes[0]), K9_REF_OPS * _numel(shapes[0])


COUNTS = {
    "scale_features": scale_features,
    "opsin_xyb": opsin_xyb,
    "bands": bands,
    "malta_ac": malta_ac,
    "malta_diffmap": malta_diffmap,
    "blur": blur,
    "mask_diff_ac": mask_diff_ac,
    "candidate_moments": candidate_moments,
    "reference_moments": reference_moments,
}


def call_bound_ms(count: str, shapes, scalars) -> float:
    """The bound of one call whose work ``count`` names."""
    n_bytes, ops = COUNTS[count](shapes, scalars)
    if not (math.isfinite(n_bytes) and math.isfinite(ops)):
        raise ValueError(f"{count}: counts are not finite")
    return bound_ms(n_bytes, ops)
