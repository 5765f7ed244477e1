"""Spatial sharding: one image's rows split into bands over the space axis.

The JAX package has no counterpart of this module.  There, ``spatial=True``
is a sharding annotation on the image rows, and XLA's SPMD partitioner
inserts the halo exchanges that the convolutions need
(``codec_eval_tpu/parallel/mesh.py``).  Eager PyTorch has no partitioner, so
the port scores **row bands with a recompute halo**:

- the rows are cut into ``n_space`` bands; band j *owns* rows [lo, hi) and
  holds rows [lo - halo, hi + halo), clipped at the image's edges;
- each band is scored on its own device through the single-pair metric
  functions, and each metric reduces only its owned rows: partial sums for
  PSNR, SSIMULACRA2 and DSSIM, a max for Butteraugli;
- the partials of the bands are combined into the pair's scores.

Two invariants make a band's owned pixels exactly those of the whole image:

- ``lo``, ``hi`` and the halo are multiples of ``ALIGN`` = 2^5, the deepest
  2x downscale of any metric (SSIMULACRA2's six scales; DSSIM's chroma at
  half resolution and four more downscales).  So every downscale pairs rows
  as on the whole image, and an odd-height clamp happens only in the band
  that holds the image's last row;
- the halo covers every metric's receptive field at every scale
  (``receptive_fields``, from the taps the port uses).  A blur's border
  (zero-padded, renormalized or edge-replicated, as the stage has it) then
  changes only rows within one radius of a band's edge, and those rows are
  never owned.

Butteraugli's size routes (K5, K6) see the whole image's shape, not the
band's, so a band launches the kernels of the unsharded pair.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..kernels import butteraugli as _ba
from ..kernels import dssim as _dssim
from ..kernels.blur import gaussian_taps
from ..kernels.color import srgb_u8_to_linear
from ..kernels.cuda.freqsep import SIGMA_MF, SIGMA_SURROUND, SIGMA_UHF, _taps
from ..kernels.cuda.malta import LINES_FULL, LINES_LF
from ..kernels.cuda.scale_features import SIGMA as S2_SIGMA
from ..kernels.ssimulacra2 import (
    NUM_SCALES as _S2_SCALES,
    features_against_reference,
    precompute_reference,
    score_from_features,
)

__all__ = [
    "ALIGN",
    "Band",
    "BandedBatch",
    "halo_rows",
    "receptive_fields",
    "row_bands",
    "score_banded_pair",
]

_DSSIM_SCALES = len(_dssim.SCALE_WEIGHTS)  # chroma: one more 2x downscale first

#: Band boundaries and the halo are multiples of this: 2 ** (the deepest
#: 2x downscale of any metric).
ALIGN = 1 << max(_S2_SCALES - 1, _DSSIM_SCALES)


def _reach(radius: int, scale: int) -> int:
    """Full-resolution rows that a ``radius``-row stencil at 2x-downscale
    level ``scale`` reaches from the rows of one of its pixels, wherever the
    pixel lies: ``radius`` pixels of 2^scale rows, and the pixel's own
    2^scale - 1 other rows."""
    return radius * (1 << scale) + (1 << scale) - 1


def _ba_radius(sigma: float) -> int:
    return len(_taps(sigma)) // 2


def receptive_fields() -> dict:
    """Each metric's reach in full-resolution rows: how far from an owned
    row the inputs that decide its value can lie, from the taps the port's
    kernels use."""
    s2 = len(gaussian_taps(S2_SIGMA)) // 2  # sigma 1.5: ceil(4.5 sigma) = 7
    dssim = (len(_dssim._BLUR_TAPS) // 2) * _dssim.BLUR_PASSES
    # Butteraugli at one resolution: opsin's surround blur, the LF blur, the
    # MF and UHF blurs of the band chain; then the larger of the Malta
    # lines' reach and the mask's blur plus the fuzzy erosion's step of 3.
    malta = max(abs(dy) for _w, line in LINES_FULL + LINES_LF for dy, _dx in line)
    bands = sum(map(_ba_radius, (SIGMA_SURROUND, _ba.SIGMA_LF, SIGMA_MF, SIGMA_UHF)))
    one_res = bands + max(malta, _ba_radius(_ba.SIGMA_MASK) + 3)
    return {
        "ssimulacra2": max(_reach(s2, s) for s in range(_S2_SCALES)),
        "dssim": max(_reach(dssim, s + c) for s in range(_DSSIM_SCALES) for c in (0, 1)),
        # the half-resolution pass (one 2x subsample) is blended in at full
        "butteraugli": max(_reach(one_res, 0), _reach(one_res, 1)),
        "psnr": 0,
    }


def halo_rows() -> int:
    """The halo: the widest receptive field, rounded up to ``ALIGN``."""
    return -(-max(receptive_fields().values()) // ALIGN) * ALIGN


@dataclass(frozen=True)
class Band:
    """One row band of an image: it holds rows [start, stop) and owns
    rows [lo, hi)."""

    start: int
    stop: int
    lo: int
    hi: int

    def window(self, scale: int) -> tuple:
        """The owned rows in the band's own row coordinates after ``scale``
        2x downscales (each rounding up, as ``downscale_by_2`` does)."""
        top = _ceil_div(self.start, scale)
        return _ceil_div(self.lo, scale) - top, _ceil_div(self.hi, scale) - top


def _ceil_div(n: int, scale: int) -> int:
    return -(-n // (1 << scale))


def row_bands(height: int, n_space: int, halo: int | None = None) -> tuple:
    """``n_space`` bands of an image ``height`` rows tall: blocks of
    ``ALIGN`` rows dealt out as evenly as they go (the first bands take the
    extra blocks; the last block may be short), each band grown by the
    halo and clipped at the image's edges."""
    if halo is None:
        halo = halo_rows()
    blocks = -(-height // ALIGN)
    if not 0 < n_space <= blocks:
        raise ValueError(f"{height} rows do not split into {n_space} bands of whole "
                         f"{ALIGN}-row blocks")
    cuts = [0]
    for j in range(n_space):
        cuts.append(cuts[-1] + blocks // n_space + (j < blocks % n_space))
    out = []
    for a, b in zip(cuts, cuts[1:]):
        lo, hi = a * ALIGN, min(b * ALIGN, height)
        out.append(Band(max(0, lo - halo), min(height, hi + halo), lo, hi))
    return tuple(out)


@dataclass
class BandedBatch:
    """One batch shard of same-size (N, H, W, 3) u8 images, cut into row
    bands: ``pixels[j]`` is band j's (N, stop - start, W, 3) rows on its
    space device."""

    height: int
    width: int
    bands: tuple
    pixels: list

    def __len__(self) -> int:
        return int(self.pixels[0].shape[0])


def shard_rows(batch: np.ndarray, devices: Sequence) -> BandedBatch:
    """A host (N, H, W, 3) batch as row bands, band j on ``devices[j]``."""
    h, w = batch.shape[1:3]
    bands = row_bands(h, len(devices))
    return BandedBatch(h, w, bands, [
        torch.from_numpy(np.ascontiguousarray(batch[:, b.start:b.stop])).to(dev)
        for b, dev in zip(bands, devices)
    ])


def _band_partials(ref_u8: torch.Tensor, dist_u8: torch.Tensor, band: Band, shape: tuple,
                   wanted: Sequence[str]) -> dict:
    """One band's partials of one pair: (rows, W, 3) u8 on one device."""
    lo, hi = band.window(0)
    w = shape[1]
    out = {"identical": torch.equal(ref_u8[lo:hi], dist_u8[lo:hi])}
    if "psnr" in wanted:
        d = ref_u8[lo:hi].to(torch.float64) - dist_u8[lo:hi].to(torch.float64)
        out["psnr"] = (torch.sum(d * d), (hi - lo) * w * 3)
    if "ssimulacra2" in wanted:
        windows = [band.window(s) for s in range(_S2_SCALES)]
        feats = features_against_reference(precompute_reference(ref_u8), dist_u8, windows)
        counts = [(b - a) * _ceil_div(w, s) for s, (a, b) in enumerate(windows)]
        out["ssimulacra2"] = (feats.reshape(3, _S2_SCALES, 2, 3), counts)
    if "dssim" in wanted:
        ref_lin = torch.movedim(srgb_u8_to_linear(ref_u8), -1, 0)
        dist_lin = torch.movedim(srgb_u8_to_linear(dist_u8), -1, 0)
        windows = [(band.window(s), band.window(s + 1)) for s in range(_DSSIM_SCALES)]
        sums = _dssim.dssim_window_sums(
            _dssim.precompute_dssim_reference(ref_lin), dist_lin, windows)
        counts = [((lb - la) * _ceil_div(w, s), (cb - ca) * _ceil_div(w, s + 1))
                  for s, ((la, lb), (ca, cb)) in enumerate(windows)]
        out["dssim"] = (sums, counts)
    if "butteraugli" in wanted:
        dmap = _ba.butteraugli_distmap(ref_u8, dist_u8, route_hw=shape)
        out["butteraugli"] = torch.amax(dmap[lo:hi])
    return out


def _combine(parts: list, wanted: Sequence[str], device: torch.device) -> dict:
    """The pair's scores from its bands' partials, on ``device``."""
    identical = all(p["identical"] for p in parts)
    out = {}
    if "psnr" in wanted:
        sse = sum(p["psnr"][0].to(device) for p in parts)
        mse = sse / sum(p["psnr"][1] for p in parts)
        val = 10.0 * torch.log10(255.0 * 255.0 / torch.clamp(mse, min=1e-30))
        out["psnr"] = torch.where(mse == 0.0, torch.full_like(val, math.inf), val).float()
    if "ssimulacra2" in wanted:
        one = four = 0.0
        total = torch.zeros(_S2_SCALES, dtype=torch.float64, device=device)
        for p in parts:
            f, counts = p["ssimulacra2"]
            f = f.to(device, torch.float64)
            c = torch.tensor(counts, dtype=torch.float64, device=device)[None, :, None]
            one = one + f[:, :, 0] * c
            four = four + f[:, :, 1] ** 4 * c
            total = total + c[0, :, 0]
        t = total[None, :, None]
        feats = torch.stack([one / t, (four / t) ** 0.25], dim=2).to(torch.float32)
        score = score_from_features(feats.reshape(-1))
        out["ssimulacra2"] = torch.full_like(score, 100.0) if identical else score
    if "dssim" in wanted:
        luma, chroma = [], []
        for s in range(_DSSIM_SCALES):
            lsum = sum(p["dssim"][0][s][0].to(device) for p in parts)
            csum = sum(p["dssim"][0][s][1].to(device) for p in parts)
            luma.append(lsum / sum(p["dssim"][1][s][0] for p in parts))
            chroma.append(csum / sum(p["dssim"][1][s][1] for p in parts))
        val = _dssim.dssim_from_means(luma, chroma)
        out["dssim"] = torch.zeros_like(val) if identical else val
    if "butteraugli" in wanted:
        val = torch.amax(torch.stack([p["butteraugli"].to(device) for p in parts]))
        out["butteraugli"] = torch.zeros_like(val) if identical else val
    return out


def score_banded_pair(refs: BandedBatch, dists: BandedBatch, k: int, wanted: Sequence[str],
                      device: torch.device) -> dict:
    """Pair k of two banded shards: each band scored on its own device, the
    partials combined on ``device``."""
    if (refs.height, refs.width, refs.bands) != (dists.height, dists.width, dists.bands):
        raise ValueError("reference and candidate bands differ")
    shape = (refs.height, refs.width)
    parts = [_band_partials(r[k], d[k], band, shape, wanted)
             for band, r, d in zip(refs.bands, refs.pixels, dists.pixels)]
    return _combine(parts, wanted, device)
