"""Batched scoring: one reference image against N decoded u8 candidates.

Port of ``codec_eval_tpu/engine/scoring.py``.  The reference side (XYB
roundtrip, SSIMULACRA2 and DSSIM pyramids, Butteraugli psycho images and
masks) runs once per image and is cached; each batch of candidates is then
staged to planar (N, 3, H, W) linear RGB once, scored by all four metrics
on the scorer's device, and fetched to the host in one copy.  PyTorch runs
eagerly, so candidates are scored as they come, without padding to buckets.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from ..kernels.butteraugli import butteraugli_batch, precompute_butteraugli_reference
from ..kernels.color import srgb_u8_to_linear, xyb_roundtrip
from ..kernels.dssim import dssim_against_reference, precompute_dssim_reference
from ..kernels.psnr import psnr
from ..kernels.ssimulacra2 import precompute_reference, ssimulacra2_batch_pre
from ..metrics import MetricConfig, MetricResult

METRICS = ("dssim", "ssimulacra2", "butteraugli", "psnr")


def resolve_device(device) -> torch.device:
    """The scorer's device: "cpu" or a CUDA device that exists.  Nothing
    falls back: asking for CUDA without a card is an error."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev


def build_precompute(ref_u8: torch.Tensor, config: MetricConfig) -> Dict[str, object]:
    """Reference-side work for (H, W, 3) u8 ``ref_u8``, on its device."""
    if config.xyb_roundtrip:
        ref_u8 = xyb_roundtrip(ref_u8)
    out: Dict[str, object] = {"ref_u8": ref_u8}
    if not (config.dssim or config.ssimulacra2 or config.butteraugli):
        return out
    # One (3, H, W) linear staging pass shared by every metric.
    lin = torch.movedim(srgb_u8_to_linear(ref_u8), -1, 0).contiguous()
    if config.dssim:
        out["dssim"] = precompute_dssim_reference(lin)
    if config.ssimulacra2:
        out["s2"] = precompute_reference(ref_u8, lin_planar=lin)
    if config.butteraugli:
        out["ba"] = precompute_butteraugli_reference(lin)
    return out


def score_chunk(
    pre: Dict[str, object], batch_u8: torch.Tensor, config: MetricConfig
) -> Dict[str, torch.Tensor]:
    """Scores of a planar (N, 3, H, W) u8 batch against a precompute."""
    ref_cmp = torch.movedim(pre["ref_u8"], -1, 0)
    identical = (batch_u8 == ref_cmp).flatten(1).all(dim=1)
    out: Dict[str, torch.Tensor] = {}
    lin = None
    if config.dssim or config.ssimulacra2 or config.butteraugli:
        lin = srgb_u8_to_linear(batch_u8)
    if config.psnr:
        out["psnr"] = psnr(ref_cmp, batch_u8)
    if config.dssim:
        vals = dssim_against_reference(pre["dssim"], lin)
        out["dssim"] = torch.where(identical, torch.zeros_like(vals), vals)
    if config.ssimulacra2:
        out["ssimulacra2"] = ssimulacra2_batch_pre(pre["s2"], ref_cmp, batch_u8, lin_planar=lin)
    if config.butteraugli:
        vals = butteraugli_batch(pre["ba"], lin)
        out["butteraugli"] = torch.where(identical, torch.zeros_like(vals), vals)
    return out


def fetch_scores(scores: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{metric: device tensor} -> {metric: f64 numpy}, with ONE
    device-to-host copy of the stacked scores."""
    if not scores:
        return {}
    keys = sorted(scores)
    stacked = torch.stack([scores[k].to(torch.float32) for k in keys]).cpu().numpy()
    return {k: stacked[i].astype(np.float64) for i, k in enumerate(keys)}


class BatchScorer:
    """Scores batches of decoded candidates against a reference image on one
    device.  The reference precompute is cached by (shape, config, content
    crc), so consecutive chunks against one image skip it, and a caller
    that reuses its decode buffer cannot leave stale pyramids behind."""

    def __init__(self, config: MetricConfig, device="cpu"):
        self.config = config
        self.device = resolve_device(device)
        self._ref_key: object = None
        self._ref_pre = None

    def enabled(self) -> bool:
        c = self.config
        return c.dssim or c.ssimulacra2 or c.butteraugli or c.psnr

    def precompute(self, reference_u8: np.ndarray) -> Dict[str, object]:
        contig = np.ascontiguousarray(reference_u8)
        c = self.config
        key = (
            reference_u8.shape,
            (c.dssim, c.ssimulacra2, c.butteraugli, c.psnr, c.xyb_roundtrip),
            zlib.crc32(contig.view(np.uint8).reshape(-1).data),
        )
        if self._ref_key != key:
            ref = torch.from_numpy(contig).to(self.device)
            self._ref_pre = build_precompute(ref, c)
            self._ref_key = key
        return self._ref_pre

    def score_batch(
        self, reference_u8: np.ndarray, candidates_u8: np.ndarray
    ) -> list[MetricResult]:
        """reference (H, W, 3) u8; candidates (N, H, W, 3) u8 -> N results."""
        n = candidates_u8.shape[0]
        if n == 0 or not self.enabled():
            return [MetricResult() for _ in range(n)]
        if candidates_u8.shape[1:] != reference_u8.shape or reference_u8.shape[-1] != 3:
            raise ValueError(
                f"candidates {candidates_u8.shape} do not match reference {reference_u8.shape}"
            )
        pre = self.precompute(reference_u8)
        planar = np.ascontiguousarray(np.moveaxis(candidates_u8, -1, 1))
        batch = torch.from_numpy(planar).to(self.device)
        raw = fetch_scores(score_chunk(pre, batch, self.config))
        return [
            MetricResult(**{k: float(raw[k][i]) if k in raw else None for k in METRICS})
            for i in range(n)
        ]
