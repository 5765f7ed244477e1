"""Masked scoring: mixed-size images padded to shared bucket shapes.

Port of ``codec_eval_tpu/kernels/masked.py``.  A corpus whose images differ
in size is grouped into padded shape buckets (multiples of ``granularity``),
and each bucket is scored as one batch: (N, H_pad, W_pad, 3) u8 pairs
zero-padded with ``pad_to_bucket`` and their true dims ``valid_hw`` (N, 2).
The JAX package ``vmap``s one pair; here every function takes the batch,
each pair with its own valid rectangle.

Why this is exact and not an approximation (the JAX module's argument).
The metrics have two kinds of spatial operator:

- zero-boundary blurs (SSIMULACRA2's sigma-1.5 moments): if the padded
  planes are zero beyond the valid region, a blur at a valid pixel reads the
  same zeros the exact-shape blur synthesizes.  The colour transforms map 0
  to nonzero constants, so planes are re-zeroed with the validity mask
  before every blur; Butteraugli's renormalized blurs renormalize over the
  valid rectangle only, and DSSIM's edge-replicated window adds the
  replicated samples back on the boundary lines;
- the 2x2 downscale, which edge-clamps odd dims: on the zero-padded array
  an odd valid dim averages the last valid row with a zero row, half the
  clamped value, so that one row or column is multiplied by 2 (by 4 at a
  doubly odd corner), and the valid dims become ``ceil(v / 2)``.

With per-pixel maps exact at valid pixels, the poolings take masked sums
over the true pixel count.  Every sigma-1.5 moment blur of SSIMULACRA2 runs
as K9 (``cuda/moments.py``), the reference side in its one-input form;
Butteraugli's Malta sweeps run as K4; everything else is plain PyTorch on
the pairs' device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.profiling import span
from . import butteraugli as ba
from . import dssim as ds
from .blur import downscale_by_2
from .color import rdiv
from .cuda.moments import candidate_moments, reference_moments
from .cuda.scale_features import C2
from .ssimulacra2 import NUM_SCALES, _to_positive_xyb, score_from_features

METRICS = ("ssimulacra2", "dssim", "butteraugli", "psnr")


def pad_to_bucket(img_u8: np.ndarray, h_pad: int, w_pad: int) -> np.ndarray:
    """Zero-pad (H, W, 3) uint8 to (h_pad, w_pad, 3) on the host."""
    h, w = img_u8.shape[:2]
    if h > h_pad or w > w_pad:
        raise ValueError(f"image ({h}x{w}) larger than bucket ({h_pad}x{w_pad})")
    return np.pad(img_u8, ((0, h_pad - h), (0, w_pad - w), (0, 0)))


def _valid_dims(refs_u8: torch.Tensor, valid_hw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair valid dims (N,), clamped to the bucket: out-of-range dims
    degrade to "the whole padded array is valid" instead of mis-normalizing
    the masked means."""
    hw = torch.as_tensor(valid_hw, device=refs_u8.device).to(torch.int64)
    return hw[:, 0].clamp(max=refs_u8.shape[1]), hw[:, 1].clamp(max=refs_u8.shape[2])


def _valid_mask(h: int, w: int, vh: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """(N, h, w) float mask: 1.0 where (row < vh) & (col < vw)."""
    rows = torch.arange(h, device=vh.device)[None, :, None]
    cols = torch.arange(w, device=vw.device)[None, None, :]
    return ((rows < vh[:, None, None]) & (cols < vw[:, None, None])).to(torch.float32)


def _downscale_masked(planes: torch.Tensor, vh: torch.Tensor, vw: torch.Tensor):
    """2x2 box downscale of (N, C, h, w) planes that are zero beyond each
    pair's valid dims, corrected so valid pixels match the exact-shape
    edge-clamped downscale.  Returns the planes and the new valid dims."""
    out = downscale_by_2(planes)  # bucket dims are even
    h2, w2 = out.shape[-2], out.shape[-1]
    ri = torch.arange(h2, device=vh.device)[None, :]
    ci = torch.arange(w2, device=vw.device)[None, :]
    rfix = torch.where((vh[:, None] % 2 == 1) & (ri == vh[:, None] // 2), 2.0, 1.0)
    cfix = torch.where((vw[:, None] % 2 == 1) & (ci == vw[:, None] // 2), 2.0, 1.0)
    fix = (rfix[:, :, None] * cfix[:, None, :]).to(out.dtype)
    return out * fix[:, None], (vh + 1) // 2, (vw + 1) // 2


def _masked_moments(x: torch.Tensor, mask: torch.Tensor, count: torch.Tensor):
    """Masked 1-norm and 4-norm over the trailing (h, w) dims of (N, C, h, w)."""
    m1 = (x * mask).sum(dim=(-2, -1)) / count[:, None]
    x2 = x * x
    m4 = torch.sqrt(torch.sqrt((x2 * x2 * mask).sum(dim=(-2, -1)) / count[:, None]))
    return m1, m4


# ------------------------------------------------------------ SSIMULACRA2


def _scale_features_masked(xyb1, mu1, s11, xyb2, mask, count) -> torch.Tensor:
    """(N, 3, 2, 3) features of one scale; ``xyb1``/``xyb2`` (N, 3, h, w)
    already zero beyond the valid region, ``mask`` (N, 1, h, w)."""
    mu2, s22, s12 = candidate_moments(xyb1, xyb2)

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

    ssim_1, ssim_4 = _masked_moments(d, mask, count)
    art_1, art_4 = _masked_moments(artifact, mask, count)
    det_1, det_4 = _masked_moments(detail_lost, mask, count)
    one = torch.stack([ssim_1, art_1, det_1], dim=-1)
    four = torch.stack([ssim_4, art_4, det_4], dim=-1)
    return torch.stack([one, four], dim=2)


def _xyb_pyramid(refs_pad: torch.Tensor, dists_pad: torch.Tensor, valid_hw):
    """Per SSIMULACRA2 scale: (xyb1, xyb2, mask, count), the (N, 3, h, w)
    positive-XYB planes of the references and candidates zero beyond each
    pair's valid dims, the (N, 1, h, w) mask and the (N,) pixel counts."""
    vh, vw = _valid_dims(refs_pad, valid_hw)
    lin1, lin2 = ba._planar_linear(refs_pad), ba._planar_linear(dists_pad)
    for scale in range(NUM_SCALES):
        if scale:
            lin1, _, _ = _downscale_masked(lin1, vh, vw)
            lin2, vh, vw = _downscale_masked(lin2, vh, vw)
        mask = _valid_mask(lin1.shape[-2], lin1.shape[-1], vh, vw)[:, None]
        # XYB maps 0 to nonzero constants: re-zero the padding so the
        # zero-boundary blurs see what the exact-shape blurs see.
        xyb1 = (_to_positive_xyb(lin1) * mask).contiguous()
        xyb2 = (_to_positive_xyb(lin2) * mask).contiguous()
        yield xyb1, xyb2, mask, (vh * vw).to(torch.float32)


def ssimulacra2_masked_batch(
    refs_pad: torch.Tensor, dists_pad: torch.Tensor, valid_hw
) -> torch.Tensor:
    """SSIMULACRA2 of (N, H_pad, W_pad, 3) u8 pairs padded with
    ``pad_to_bucket`` and their (N, 2) true dims.  Bucket dims must be
    multiples of 32, so five pyramid halvings stay even.  Identical padded
    pairs score exactly 100."""
    per_scale = []
    for xyb1, xyb2, mask, count in _xyb_pyramid(refs_pad, dists_pad, valid_hw):
        mu1, s11 = reference_moments(xyb1)
        per_scale.append(_scale_features_masked(xyb1, mu1, s11, xyb2, mask, count))
    feats = torch.stack(per_scale, dim=2)  # (N, 3, 6, 2, 3), channel-major
    scores = score_from_features(feats.reshape(feats.shape[0], -1))
    identical = (refs_pad == dists_pad).flatten(1).all(dim=1)
    return torch.where(identical, torch.full_like(scores, 100.0), scores)


def ssimulacra2_masked(ref_pad_u8, dist_pad_u8, valid_h: int, valid_w: int) -> torch.Tensor:
    """SSIMULACRA2 of one zero-padded (H_pad, W_pad, 3) pair."""
    return ssimulacra2_masked_batch(
        ref_pad_u8[None], dist_pad_u8[None], [[valid_h, valid_w]]
    )[0]


# ------------------------------------------------------------------- DSSIM


def _blur_window_masked(planes: torch.Tensor, vh: torch.Tensor, vw: torch.Tensor):
    """dssim-core's 3-tap window on (N, C, h, w), exact at valid pixels.

    The exact-shape window edge-replicates; on a zero-beyond-valid array the
    out-of-range tap reads 0 instead of the replicated sample, so ``tap * x``
    is added back on the two boundary lines of each axis.  Rows and columns
    beyond the valid dims get spill values; callers mask at pooling.
    """
    a, b, _ = ds._BLUR_TAPS
    h, w = planes.shape[-2], planes.shape[-1]
    ri = torch.arange(h, device=vh.device)[None, :]
    ci = torch.arange(w, device=vw.device)[None, :]
    rfix = ((ri == 0).to(planes.dtype) + (ri == vh[:, None] - 1).to(planes.dtype))
    cfix = ((ci == 0).to(planes.dtype) + (ci == vw[:, None] - 1).to(planes.dtype))
    xp = F.pad(planes, (0, 0, 1, 1))
    out = a * xp[..., 0:h, :] + b * xp[..., 1 : 1 + h, :] + a * xp[..., 2 : 2 + h, :]
    out = out + a * planes * rfix[:, None, :, None]
    xp = F.pad(out, (1, 1))
    out2 = a * xp[..., :, 0:w] + b * xp[..., :, 1 : 1 + w] + a * xp[..., :, 2 : 2 + w]
    return out2 + a * out * cfix[:, None, None, :]


def _ssim_means_masked(p1, p2, vh, vw) -> torch.Tensor:
    """Mean SSIM over the valid region, per pair and plane: (N, C)."""
    mask = _valid_mask(p1.shape[-2], p1.shape[-1], vh, vw)[:, None].to(p1.dtype)
    count = (vh * vw).to(p1.dtype)
    x1 = p1 * mask
    x2 = p2 * mask
    n = x1.shape[1]
    stacked = torch.cat([x1, x2, x1 * x1, x2 * x2, x1 * x2], dim=1)
    blurred = _blur_window_masked(stacked, vh, vw)
    mu1, mu2 = blurred[:, :n], blurred[:, n : 2 * n]
    s11, s22, s12 = blurred[:, 2 * n : 3 * n], blurred[:, 3 * n : 4 * n], blurred[:, 4 * n :]
    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    ssim_map = ((2.0 * mu12 + ds.C1) * (2.0 * (s12 - mu12) + ds.C2)) / (
        (mu11 + mu22 + ds.C1) * ((s11 - mu11) + (s22 - mu22) + ds.C2)
    )
    return (ssim_map * mask).sum(dim=(-2, -1)) / count[:, None]


def dssim_masked_batch(refs_pad: torch.Tensor, dists_pad: torch.Tensor, valid_hw) -> torch.Tensor:
    """DSSIM of zero-padded u8 pairs (dssim-core's recipe, as
    ``kernels/dssim.py``: Lab in f64, chroma at half resolution and half
    weight).  Lab planes are re-zeroed beyond valid before every spatial op;
    identical padded pairs score exactly 0."""
    vh, vw = _valid_dims(refs_pad, valid_hw)
    mask0 = _valid_mask(refs_pad.shape[1], refs_pad.shape[2], vh, vw)[:, None].to(torch.float64)
    lab1 = ds._linear_rgb_to_lab_planes(ba._planar_linear(refs_pad)) * mask0
    lab2 = ds._linear_rgb_to_lab_planes(ba._planar_linear(dists_pad)) * mask0
    luma1, luma2 = lab1[:, :1], lab2[:, :1]
    chroma1, _, _ = _downscale_masked(lab1[:, 1:], vh, vw)
    chroma2, cvh, cvw = _downscale_masked(lab2[:, 1:], vh, vw)
    total = torch.zeros(lab1.shape[0], dtype=lab1.dtype, device=lab1.device)
    wsum = 0.0
    for scale, sweight in enumerate(ds.SCALE_WEIGHTS):
        if scale:
            luma1, _, _ = _downscale_masked(luma1, vh, vw)
            luma2, vh, vw = _downscale_masked(luma2, vh, vw)
            chroma1, _, _ = _downscale_masked(chroma1, cvh, cvw)
            chroma2, cvh, cvw = _downscale_masked(chroma2, cvh, cvw)
        total = total + sweight * _ssim_means_masked(luma1, luma2, vh, vw)[:, 0]
        total = total + sweight * ds.CHROMA_WEIGHT * torch.sum(
            _ssim_means_masked(chroma1, chroma2, cvh, cvw), dim=-1
        )
        wsum += sweight * (1.0 + 2.0 * ds.CHROMA_WEIGHT)
    ssim = torch.clamp(total / wsum, 1e-6, 1.0)
    val = (rdiv(1.0, ssim) - 1.0).to(torch.float32)
    identical = (refs_pad == dists_pad).flatten(1).all(dim=1)
    return torch.where(identical, torch.zeros_like(val), val)


def dssim_masked(ref_pad_u8, dist_pad_u8, valid_h: int, valid_w: int) -> torch.Tensor:
    """DSSIM of one zero-padded (H_pad, W_pad, 3) pair."""
    return dssim_masked_batch(ref_pad_u8[None], dist_pad_u8[None], [[valid_h, valid_w]])[0]


# ------------------------------------------------------------- Butteraugli


def _resolutions(refs_pad: torch.Tensor, dists_pad: torch.Tensor, valid_hw):
    """The two resolutions of the masked Butteraugli pass: (lin0, lin1, vh,
    vw) at full and at half resolution, the (N, 3, h, w) linear RGB of the
    references and candidates zero beyond the valid dims (N,)."""
    vh, vw = _valid_dims(refs_pad, valid_hw)
    lin1, lin2 = ba._planar_linear(refs_pad), ba._planar_linear(dists_pad)
    s1, svh, svw = _downscale_masked(lin1, vh, vw)
    s2, _, _ = _downscale_masked(lin2, vh, vw)
    return (lin1, lin2, vh, vw), (s1, s2, svh, svw)


def _malta_inputs(lin0, lin1, vh, vw, params: "ba.ButteraugliParams"):
    """The psycho images of one resolution and K4's input: (stacks, pi0,
    pi1, m2, mrow, mcol), ``stacks`` the (N, 6, h, w) Malta diff planes
    zeroed beyond the valid rectangle, on which K4's zero-padded sweep is
    exactly the masked one."""
    h, w = lin0.shape[-2], lin0.shape[-1]
    mrow = (torch.arange(h, device=vh.device)[None, :] < vh[:, None]).to(torch.float32)
    mcol = (torch.arange(w, device=vw.device)[None, :] < vw[:, None]).to(torch.float32)
    m2 = mrow[:, :, None] * mcol[:, None, :]
    it = float(np.float32(params.intensity_target))
    pi0, pi1 = (
        ba._separate_frequencies(ba._opsin_dynamics(lin * it, m2, mrow, mcol), m2, mrow, mcol)
        for lin in (lin0, lin1)
    )
    stacks = (ba._malta_diffs_stack(pi0, pi1, params.hf_asymmetry) * m2[:, None]).contiguous()
    return stacks, pi0, pi1, m2, mrow, mcol


def _masked_scale(lin0, lin1, vh, vw, params: "ba.ButteraugliParams"):
    """One resolution of the masked Butteraugli pass (see ``_resolutions``)
    -> the (N, h, w) diffmap and the (N, h, w) valid mask."""
    stacks, pi0, pi1, m2, mrow, mcol = _malta_inputs(lin0, lin1, vh, vw, params)
    ac = ba.malta_ac_batch(stacks, ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
    mask_pre = ba._mask_reference_side(pi0, m2, mrow, mcol)
    dac = ba._mask_candidate_side(mask_pre[0], pi1, m2, mrow, mcol)
    dmap = ba._diffmap_psycho(
        pi0, pi1, params.hf_asymmetry, params.xmul, malta_ac=ac, mask_pre=mask_pre, diff_ac=dac
    )
    return dmap, m2


def butteraugli_masked_batch(
    refs_pad: torch.Tensor,
    dists_pad: torch.Tensor,
    valid_hw,
    intensity_target: float = 80.0,
    hf_asymmetry: float = 0.8,
) -> torch.Tensor:
    """Butteraugli (max-norm) of zero-padded u8 pairs: the full and the
    half-resolution pass masked end to end, the half-resolution pass blended
    in where ``ceil(v / 2) >= 8`` and the max taken over valid pixels.  A
    pair under 8 px on a side, or an identical padded pair, scores 0."""
    params = ba.ButteraugliParams(hf_asymmetry=hf_asymmetry, intensity_target=intensity_target)
    full, half = _resolutions(refs_pad, dists_pad, valid_hw)
    dmap, m2 = _masked_scale(*full, params)
    sub, _ = _masked_scale(*half, params)
    blended = ba._add_supersampled2x(dmap, sub)
    # The exact-shape pass adds the half resolution only when ceil(v/2) >= 8.
    vh, vw, svh, svw = full[2], full[3], half[2], half[3]
    dmap = torch.where(((svh >= 8) & (svw >= 8))[:, None, None], blended, dmap)
    score = torch.amax(dmap * m2, dim=(-2, -1))
    score = torch.where((vh >= 8) & (vw >= 8), score, torch.zeros_like(score))
    identical = (refs_pad == dists_pad).flatten(1).all(dim=1)
    return torch.where(identical, torch.zeros_like(score), score)


def butteraugli_masked(
    ref_pad_u8, dist_pad_u8, valid_h: int, valid_w: int,
    intensity_target: float = 80.0, hf_asymmetry: float = 0.8,
) -> torch.Tensor:
    """Butteraugli of one zero-padded (H_pad, W_pad, 3) pair."""
    return butteraugli_masked_batch(
        ref_pad_u8[None], dist_pad_u8[None], [[valid_h, valid_w]], intensity_target, hf_asymmetry
    )[0]


# -------------------------------------------------------------------- PSNR


def psnr_masked_batch(refs_pad: torch.Tensor, dists_pad: torch.Tensor, valid_hw) -> torch.Tensor:
    """PSNR (dB, 255 peak) over each pair's valid region; inf where equal."""
    vh, vw = _valid_dims(refs_pad, valid_hw)
    mask = _valid_mask(refs_pad.shape[1], refs_pad.shape[2], vh, vw)[..., None]
    diff = refs_pad.to(torch.float32) - dists_pad.to(torch.float32)
    count = (vh * vw * 3).to(torch.float32)
    mse = (diff * diff * mask).sum(dim=(1, 2, 3)) / count
    return torch.where(
        mse == 0.0,
        torch.full_like(mse, float("inf")),
        10.0 * torch.log10(rdiv(255.0 * 255.0, torch.clamp(mse, min=1e-20))),
    )


def psnr_masked(ref_pad_u8, dist_pad_u8, valid_h: int, valid_w: int) -> torch.Tensor:
    """PSNR of one zero-padded (H_pad, W_pad, 3) pair."""
    return psnr_masked_batch(ref_pad_u8[None], dist_pad_u8[None], [[valid_h, valid_w]])[0]


# -------------------------------------------------------------- buckets


def bucket_shapes(
    shapes: Sequence[Tuple[int, int]], granularity: int = 128
) -> List[Tuple[int, int]]:
    """Each (h, w) rounded up to a multiple of ``granularity``, which must
    be a multiple of 32 so five pyramid halvings stay even.  Coarser buckets
    trade padding for fewer batches."""
    g = granularity
    if g % 32:
        raise ValueError("granularity must be a multiple of 32")
    return [(-(-h // g) * g, -(-w // g) * g) for h, w in shapes]


def bucket_plan(pairs, granularity: int, batch: int):
    """Group mixed-size pairs into padded shape buckets and yield their
    chunks: (chunk_indices, rows, (h_pad, w_pad)), ``rows`` the pair index
    of each of the chunk's batch rows.  The short tail of a bucket that
    spans several chunks is padded to ``batch`` by repeating its last pair,
    as the JAX package keeps one compiled program per bucket; the repeats
    are in ``rows`` and not in ``chunk_indices``."""
    assignments = bucket_shapes([p[0].shape[:2] for p in pairs], granularity)
    groups: dict = {}
    for i, shape in enumerate(assignments):
        groups.setdefault(shape, []).append(i)
    for frame, idxs in groups.items():
        for start in range(0, len(idxs), batch):
            chunk = idxs[start : start + batch]
            n = len(chunk)
            pad_n = batch if n < batch and len(idxs) > batch else n
            yield chunk, chunk + [chunk[-1]] * (pad_n - n), frame


def _bucketed_chunks(pairs, granularity: int, batch: int):
    """``bucket_plan``'s chunks as padded batches: (chunk_indices, refs,
    dists, valid_hw) as numpy."""
    for chunk, rows, (hp, wp) in bucket_plan(pairs, granularity, batch):
        refs = np.stack([pad_to_bucket(pairs[i][0], hp, wp) for i in rows])
        dists = np.stack([pad_to_bucket(pairs[i][1], hp, wp) for i in rows])
        hw = np.array([pairs[i][0].shape[:2] for i in rows], np.int32)
        yield chunk, refs, dists, hw


def _fused_masked_all(refs_pad: torch.Tensor, dists_pad: torch.Tensor, valid_hw) -> dict:
    """All four masked metrics of a batch of padded pairs: {metric: (N,)}."""
    out = {}
    with span("ce.masked.ssimulacra2"):
        out["ssimulacra2"] = ssimulacra2_masked_batch(refs_pad, dists_pad, valid_hw)
    with span("ce.masked.dssim"):
        out["dssim"] = dssim_masked_batch(refs_pad, dists_pad, valid_hw)
    with span("ce.masked.butteraugli"):
        out["butteraugli"] = butteraugli_masked_batch(refs_pad, dists_pad, valid_hw)
    with span("ce.masked.psnr"):
        out["psnr"] = psnr_masked_batch(refs_pad, dists_pad, valid_hw)
    return out


def _score_buckets(pairs, granularity: int, batch: int, device, fn) -> dict:
    dev = resolve_device(device)
    out: dict = {}
    for chunk, refs, dists, hw in _bucketed_chunks(pairs, granularity, batch):
        scores = fn(torch.from_numpy(refs).to(dev), torch.from_numpy(dists).to(dev),
                    torch.from_numpy(hw).to(dev))
        for k, v in scores.items():
            col = out.setdefault(k, np.zeros(len(pairs), np.float32))
            col[chunk] = v.cpu().numpy()[: len(chunk)]
    return out


def score_mixed_sizes(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    granularity: int = 128,
    batch: int = 8,
    device="cuda",
) -> np.ndarray:
    """SSIMULACRA2 of mixed-size (H, W, 3) u8 pairs, scored bucket by
    bucket on ``device`` (the card unless the caller asks for the CPU).
    Scores in input order."""
    if not pairs:
        return np.zeros((0,), np.float32)
    return _score_buckets(
        pairs, granularity, batch, device,
        lambda r, d, hw: {"ssimulacra2": ssimulacra2_masked_batch(r, d, hw)},
    )["ssimulacra2"]


def score_mixed_sizes_all(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    granularity: int = 128,
    batch: int = 8,
    device="cuda",
) -> dict:
    """All four metrics of mixed-size u8 pairs, one batch per bucket chunk
    on ``device``: ``{metric: np.ndarray}`` in input order."""
    if not pairs:
        return {k: np.zeros((0,), np.float32) for k in METRICS}
    return _score_buckets(pairs, granularity, batch, device, _fused_masked_all)


__all__ = [
    "pad_to_bucket",
    "ssimulacra2_masked",
    "ssimulacra2_masked_batch",
    "dssim_masked",
    "butteraugli_masked",
    "psnr_masked",
    "bucket_plan",
    "bucket_shapes",
    "score_mixed_sizes",
    "score_mixed_sizes_all",
]
