"""K1: SSIMULACRA2 per-scale features for a batch of candidates.

``scale_features_batch`` is the port's counterpart of
``codec_eval_tpu/kernels/pallas/scale_features.py:scale_features_pallas_batch``:
(3, H, W) reference planes xyb1, mu1, s11 against (N, 3, H, W) candidates
xyb2 -> (N, 3, 2, 3) features (channel x norm x {ssim, artifact, detail}).
On a CUDA tensor it launches the hand-written kernel
(``csrc/scale_features.cu``), which sums the maps in double, adds each
plane's block partials in a fixed order and forms the norms itself, so the
wrapper issues one launch and nothing else.  On a CPU tensor it runs
``scale_features_plain``, the port of
``codec_eval_tpu/kernels/ssimulacra2.py:_scale_features``.

K8, ``scale_features``, is the counterpart of the single-pair
``scale_features_pallas``: (3, H, W) planes -> (3, 2, 3).  The Pallas
kernel differs from the batched one only in how its grid carries the batch
(ANY-space inputs and VMEM limits), not in what it computes, so K8 launches
the same CUDA kernel at N = 1, under its own wrapper and launch counter.
The kernel's partials and their order depend on the plane's size only, so
a pair's features equal those of the same candidate in a batch.

Both wrappers and the plain version take a row window ``rows = (lo, hi)``:
the features of rows [lo, hi) only, with every row still blurred.  A row
band of spatial sharding (``parallel/spatial.py``) sums its own rows and
not its halo.  ``rows=None`` is the whole plane, the same bits as (0, h).
"""

from __future__ import annotations

import numpy as np
import torch

from ..blur import blur_separable, gaussian_taps
from . import _lib

SIGMA = 1.5
C2 = 0.0009
#: Output columns per block of the kernel (csrc/common.cuh kStrip).
STRIP = _lib.STRIP


def segment_rows(h: int) -> int:
    """Rows per segment of the kernel's strips: about an eighth of the
    plane, 16 to 128 rows.  It depends on the plane's size only, never on
    the number of candidates, so neither do the partial sums."""
    return min(128, max(16, -(-h // 8)))


def grid_blocks(h: int, w: int) -> int:
    """Blocks (and partial sums) per (candidate, channel) plane."""
    return -(-w // STRIP) * -(-h // segment_rows(h))


_counters: dict = {}


def _counter(device: torch.device, planes: int) -> torch.Tensor:
    """The device's zeroed block counters, one per plane, at least
    ``planes`` long.  The kernel leaves every counter at 0 after its launch,
    so one buffer per device serves every call on the current stream."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < planes:
        buf = _counters[device] = torch.zeros(planes, dtype=torch.int32, device=device)
    return buf


def _window(rows, h: int) -> tuple:
    """The row window (lo, hi) of an h-row plane; None is every row."""
    lo, hi = (0, h) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= lo < hi <= h:
        raise ValueError(f"row window {rows} is not inside 0..{h}")
    return lo, hi


def scale_features_plain(
    xyb1: torch.Tensor, mu1: torch.Tensor, s11: torch.Tensor, xyb2: torch.Tensor, rows=None
) -> torch.Tensor:
    """Features for one scale: xyb2 (..., 3, h, w) -> (..., 3, 2, 3), over
    the rows ``rows`` = (lo, hi) of the maps (every row when None)."""
    stacked = torch.cat([xyb2, xyb2 * xyb2, xyb1 * xyb2], dim=-3)
    blurred = blur_separable(stacked, SIGMA)
    mu2, s22, s12 = blurred[..., 0:3, :, :], blurred[..., 3:6, :, :], blurred[..., 6:9, :, :]

    mu11 = mu1 * mu1
    mu22 = mu2 * mu2
    mu12 = mu1 * mu2
    mu_diff = mu1 - mu2
    num_m = 1.0 - mu_diff * mu_diff
    num_s = 2.0 * (s12 - mu12) + C2
    denom_s = (s11 - mu11) + (s22 - mu22) + C2
    d = torch.clamp(1.0 - (num_m * num_s) / denom_s, min=0.0)

    detail1 = torch.abs(xyb1 - mu1)
    detail2 = torch.abs(xyb2 - mu2)
    d1 = (1.0 + detail2) / (1.0 + detail1) - 1.0
    artifact = torch.clamp(d1, min=0.0)
    detail_lost = torch.clamp(-d1, min=0.0)

    if rows is not None:
        lo, hi = _window(rows, xyb2.shape[-2])
        d, artifact, detail_lost = (m[..., lo:hi, :] for m in (d, artifact, detail_lost))

    def mean(x):
        return x.mean(dim=(-2, -1))

    def fourth(x):
        x2 = x * x
        return torch.sqrt(torch.sqrt(mean(x2 * x2)))

    one = torch.stack([mean(d), mean(artifact), mean(detail_lost)], dim=-1)
    four = torch.stack([fourth(d), fourth(artifact), fourth(detail_lost)], dim=-1)
    return torch.stack([one, four], dim=-2)


def _launch(xyb1, mu1, s11, xyb2: torch.Tensor, rows=None) -> torch.Tensor:
    """The CUDA kernel on (N, 3, H, W) candidates -> (N, 3, 2, 3)."""
    _lib.require_cuda("xyb2", xyb2, (None, 3, None, None))
    n, _, h, w = xyb2.shape
    lo, hi = _window(rows, h)
    for name, t in (("xyb1", xyb1), ("mu1", mu1), ("s11", s11)):
        _lib.require_cuda(name, t, (3, h, w))
        if t.device != xyb2.device:
            raise ValueError(f"{name} and xyb2 must be on one device")
    taps = np.ascontiguousarray(gaussian_taps(SIGMA))
    if len(taps) != 15:
        raise ValueError("scale-features kernel takes 15 taps")
    dev = xyb2.device
    partial = torch.empty((n, 3, grid_blocks(h, w), 6), dtype=torch.float64, device=dev)
    out = torch.empty((n, 3, 2, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib.load().ce_scale_features(
            _lib.ptr(xyb1), _lib.ptr(mu1), _lib.ptr(s11), _lib.ptr(xyb2),
            _lib.ptr(partial), _lib.ptr(_counter(dev, n * 3)), _lib.ptr(out),
            n, h, w, segment_rows(h), lo, hi, _lib.ptr(taps), _lib.stream(dev),
        )
    _lib.check(rc, "ce_scale_features")
    return out


def scale_features_batch(
    xyb1: torch.Tensor, mu1: torch.Tensor, s11: torch.Tensor, xyb2: torch.Tensor, rows=None
) -> torch.Tensor:
    """K1.  Plain version on CPU tensors; the CUDA kernel on CUDA tensors."""
    if xyb2.device.type == "cpu":
        return scale_features_plain(xyb1, mu1, s11, xyb2, rows)
    out = _launch(xyb1, mu1, s11, xyb2, rows)
    scale_features_batch.launches += 1
    return out


scale_features_batch.launches = 0
scale_features_batch.source = "codec_eval_tpu_torch/csrc/scale_features.cu"
scale_features_batch.replaces = "codec_eval_tpu/kernels/pallas/scale_features.py:407"


def scale_features(
    xyb1: torch.Tensor, mu1: torch.Tensor, s11: torch.Tensor, xyb2: torch.Tensor, rows=None
) -> torch.Tensor:
    """K8: one pair's (3, H, W) planes -> (3, 2, 3).  Plain version on CPU
    tensors; the CUDA kernel at N = 1 on CUDA tensors."""
    if xyb2.device.type == "cpu":
        return scale_features_plain(xyb1, mu1, s11, xyb2, rows)
    _lib.require_cuda("xyb2", xyb2, (3, None, None))
    out = _launch(xyb1, mu1, s11, xyb2[None], rows)[0]
    scale_features.launches += 1
    return out


scale_features.launches = 0
scale_features.source = "codec_eval_tpu_torch/csrc/scale_features.cu"
scale_features.replaces = "codec_eval_tpu/kernels/pallas/scale_features.py:209"
