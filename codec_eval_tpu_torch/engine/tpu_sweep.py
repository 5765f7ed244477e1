"""The device R-D sweep: encode, decode and score a whole tpujpeg quality
ladder with no candidate pixel leaving the device.

Port of ``codec_eval_tpu/engine/tpu_sweep.py``.  The reference's eval loop
round-trips every (codec, quality) candidate through host RAM between the
codec and the scorer (reference: crates/codec-iter/src/eval.rs:151-167).
Here the tpujpeg transform, the per-quality quantize / dequantize / inverse
DCT (``kernels.jpeg_enc.reconstruct_sweep``) and the batch scorer's stages
(``engine.scoring``) run one after the other on one device.  The host's
only work is the optional entropy pass that turns the quantized
coefficients into real .jpg bytes for exact sizes: it runs in a worker
thread, started before the scoring is queued, so it overlaps the scoring.
``with_sizes="device"`` takes the sizes from device rate statistics
instead (``kernels.jpeg_rate``).

One image's ladder is written once, in ``_image_ladder``: this module's
sweep runs it for one image, ``parallel.ladder_runner`` for each image of a
corpus.  Its spans (``utils.profiling``): ``ce.ladder.image`` around the
encoder's ``ce.jpeg.*`` spans, ``ce.ladder.rate`` (with sizes) and
``ce.ladder.score``.

The scored pixels are this package's own decode of the bytes
(``codecs.jpeg_device`` gives the same candidates).
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import jpeg_enc as _je
from ..utils import native as _native
from ..utils.profiling import span
from . import scoring

__all__ = ["TpuSweepPoint", "evaluate_tpujpeg_sweep", "encode_to_target"]


@dataclass
class TpuSweepPoint:
    """One (quality) row of a device ladder evaluation."""

    quality: float
    bits_per_pixel: Optional[float]
    file_size: Optional[int]
    metrics: Dict[str, float]
    data: Optional[bytes] = None  # the .jpg bytes, when return_bytes=True


def _size_mode(with_sizes) -> str:
    mode = {True: "exact", False: "none"}.get(with_sizes, with_sizes)
    if mode not in ("exact", "none", "device"):
        raise ValueError(f"with_sizes must be bool or 'device', got {with_sizes!r}")
    return mode


def _image_ladder(
    image_u8: np.ndarray, dev: torch.device, qtabs: np.ndarray, subsampling: str,
    aq_strength: float, colorspace: str, progressive: bool, trellis_lambda: float,
    metrics: Sequence[str], size_mode: str, pool: Optional[ThreadPoolExecutor], q_chunk: int,
) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor], List[Future]]:
    """One image's whole ladder on ``dev``, with nothing fetched but what
    the host coder needs: ``evaluate_tpujpeg_sweep`` and
    ``parallel.ladder_runner`` both run it.

    ``qtabs`` is ``jpeg_enc.qtabs_for``'s (n_q, 2, 64) stack; the quality
    axis is scored ``q_chunk`` qualities at a time.  Returns the scores
    ({metric: (n_q,)} on ``dev``), with ``size_mode="device"`` the packed
    rate statistics (on ``dev``), and with ``"exact"`` the futures of each
    quality's .jpg bytes: the coefficients are fetched and handed to
    ``pool`` before the scoring is queued, and the native coder releases
    the interpreter lock, so it runs while this thread queues the scoring.
    """
    from ..kernels import jpeg_rate as _jr

    h, w = image_u8.shape[:2]
    n_q = len(qtabs)
    config = scoring.metric_config(metrics)
    app_mode = 1 if colorspace == "xyb" else 0
    stats, pending = None, []
    with span("ce.ladder.image"):
        img = torch.from_numpy(np.require(image_u8, np.uint8, "CW")).to(dev)
        cands, coefs = _je.reconstruct_sweep(
            img, torch.from_numpy(qtabs).to(dev), aq_strength, subsampling, colorspace,
            with_coefs=size_mode != "none", trellis_lambda=float(trellis_lambda),
        )
        if size_mode == "device":
            with span("ce.ladder.rate"):
                planes = (coefs["y"], coefs["cb"], coefs["cr"])
                stats = (_jr.progressive_ladder_rate_stats(*planes, h, w, subsampling)
                         if progressive else _jr.ladder_rate_stats(*planes, subsampling))
        elif size_mode == "exact":
            with span("ce.ladder.rate"):
                cy, ccb, ccr = (coefs[k].cpu().numpy() for k in ("y", "cb", "cr"))
                qt_zz = qtabs.astype(np.uint16)[:, :, _je.ZIGZAG]

                def encode(qi: int) -> bytes:
                    return _native.jpeg_encode_baseline(
                        w, h, subsampling, cy[qi], ccb[qi], ccr[qi], qt_zz[qi, 0], qt_zz[qi, 1],
                        app_mode=app_mode, progressive=progressive,
                    )

                pending = [pool.submit(encode, qi) for qi in range(n_q)]
        with span("ce.ladder.score"):
            pre = scoring.build_precompute(img, config)
            parts = [scoring.score_chunk(pre, cands[qs:qs + q_chunk], config)
                     for qs in range(0, n_q, q_chunk)]
            scores = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return scores, stats, pending


def evaluate_tpujpeg_sweep(
    image_u8: np.ndarray,
    qualities: Sequence[float],
    subsampling: str = "420",
    aq_strength: float = 0.30,
    metrics: Sequence[str] = scoring.METRICS,
    with_sizes: "bool | str" = True,
    size_pool: Optional[ThreadPoolExecutor] = None,
    colorspace: str = "ycbcr",
    progressive: bool = False,
    return_bytes: bool = False,
    trellis_lambda: float = 0.0,
    device="cuda",
) -> List[TpuSweepPoint]:
    """Score a full tpujpeg quality ladder of one (H, W, 3) u8 image on
    ``device`` (the card unless the caller asks for the CPU).

    with_sizes=False skips the entropy pass (scores only); "device" takes
    the file sizes from device rate statistics (entropy-exact, 0xFF
    stuffing estimated, about +-0.15%); True entropy-codes on the host for
    exact sizes, in ``size_pool`` when one is given, else in a worker
    thread of its own.  return_bytes=True
    keeps each quality's .jpg bytes (and implies exact sizes).
    trellis_lambda > 0 runs the trellis DP in place of the AQ bias.
    """
    size_mode = "exact" if return_bytes else _size_mode(with_sizes)
    dev = resolve_device(device)
    h, w = image_u8.shape[:2]
    n_q = len(qualities)
    if colorspace == "xyb":
        subsampling = "444"
    with ThreadPoolExecutor(max_workers=1) as own_pool:
        scores, stats, pending = _image_ladder(
            image_u8, dev, _je.qtabs_for(qualities, colorspace), subsampling, aq_strength,
            colorspace, progressive, trellis_lambda, metrics, size_mode, size_pool or own_pool, n_q)
        datas = [f.result() for f in pending]
    sizes: List[Optional[int]] = [None] * n_q
    if size_mode == "exact":
        sizes = [len(d) for d in datas]
    elif size_mode == "device":
        from ..kernels import jpeg_rate as _jr

        estimate = (_jr.progressive_size_estimates_from_packed if progressive
                    else _jr.size_estimates_from_packed)
        sizes = estimate(stats.cpu().numpy(), app_mode=1 if colorspace == "xyb" else 0)
    blobs = datas if return_bytes else [None] * n_q

    host_scores = scoring.fetch_scores(scores)
    return [
        TpuSweepPoint(
            quality=float(q),
            bits_per_pixel=sizes[qi] * 8.0 / (h * w) if sizes[qi] is not None else None,
            file_size=sizes[qi],
            metrics={k: float(v[qi]) for k, v in host_scores.items()},
            data=blobs[qi],
        )
        for qi, q in enumerate(qualities)
    ]


def encode_to_target(
    image_u8: np.ndarray,
    min_ssimulacra2: Optional[float] = None,
    max_butteraugli: Optional[float] = None,
    max_dssim: Optional[float] = None,
    max_bits_per_pixel: Optional[float] = None,
    qualities: Sequence[float] = tuple(range(30, 99, 2)),
    subsampling: str = "420",
    aq_strength: float = 0.30,
    colorspace: str = "ycbcr",
    progressive: bool = False,
    trellis_lambda: float = 0.0,
    device="cuda",
) -> TpuSweepPoint:
    """Encode to a perceptual (and/or rate) target: the smallest file on
    the quality grid that meets every given constraint.

    The whole grid is one device ladder (scores only, plus device rate
    statistics when a bpp ceiling is given); the chosen quality is then
    entropy-coded for its real bytes.  Raises QualityBelowThreshold, naming
    the constraint that binds, when no grid point meets them.  Returns the
    point with ``.data`` (the .jpg bytes), its exact size and its scores.
    """
    from ..errors import QualityBelowThreshold

    if not any(c is not None for c in (min_ssimulacra2, max_butteraugli, max_dssim,
                                        max_bits_per_pixel)):
        raise ValueError("no target given")
    metrics = tuple(
        m
        for m, need in (
            ("ssimulacra2", min_ssimulacra2 is not None),
            ("butteraugli", max_butteraugli is not None),
            ("dssim", max_dssim is not None),
        )
        if need
    ) or ("ssimulacra2",)
    qualities = sorted(float(q) for q in qualities)
    common = dict(subsampling=subsampling, aq_strength=aq_strength, metrics=metrics,
                  colorspace=colorspace, progressive=progressive,
                  trellis_lambda=trellis_lambda, device=device)
    points = evaluate_tpujpeg_sweep(
        image_u8, qualities,
        with_sizes="device" if max_bits_per_pixel is not None else False, **common,
    )

    def ok_perceptual(p: TpuSweepPoint) -> bool:
        if min_ssimulacra2 is not None and p.metrics["ssimulacra2"] < min_ssimulacra2:
            return False
        if max_butteraugli is not None and p.metrics["butteraugli"] > max_butteraugli:
            return False
        if max_dssim is not None and p.metrics["dssim"] > max_dssim:
            return False
        return True

    # Quality is the rate knob: the lowest admissible grid point is the
    # smallest file (scores are not quite monotone in q, so scan).  Device
    # sizes are estimates (+-0.15%, held to +-0.4%): admit bpp-marginal
    # points and settle against the exact size below.
    bpp_est_margin = 1.004
    chosen = next(
        (p for p in points if ok_perceptual(p) and (
            max_bits_per_pixel is None
            or p.bits_per_pixel <= max_bits_per_pixel * bpp_est_margin)),
        None,
    )
    if chosen is None:
        # The top quality's scores are the best the grid can do: a
        # perceptual floor it misses is infeasible; otherwise the bpp
        # ceiling excludes every admissible point.
        top = points[-1]
        if min_ssimulacra2 is not None and top.metrics["ssimulacra2"] < min_ssimulacra2:
            raise QualityBelowThreshold("SSIMULACRA2", top.metrics["ssimulacra2"], min_ssimulacra2)
        if max_butteraugli is not None and top.metrics["butteraugli"] > max_butteraugli:
            raise QualityBelowThreshold("Butteraugli", top.metrics["butteraugli"], max_butteraugli)
        if max_dssim is not None and top.metrics["dssim"] > max_dssim:
            raise QualityBelowThreshold("DSSIM", top.metrics["dssim"], max_dssim)
        admissible = [p for p in points if ok_perceptual(p)] or points
        raise QualityBelowThreshold(
            "bits_per_pixel", min(p.bits_per_pixel for p in admissible), max_bits_per_pixel
        )

    exact = evaluate_tpujpeg_sweep(image_u8, [chosen.quality], with_sizes=True,
                                   return_bytes=True, **common)[0]
    # Exact sizes grow with quality: if the smallest admissible point busts
    # the ceiling, every higher one does too.
    if max_bits_per_pixel is not None and exact.bits_per_pixel > max_bits_per_pixel:
        raise QualityBelowThreshold("bits_per_pixel", exact.bits_per_pixel, max_bits_per_pixel)
    return TpuSweepPoint(quality=chosen.quality, bits_per_pixel=exact.bits_per_pixel,
                         file_size=exact.file_size, metrics=exact.metrics, data=exact.data)
