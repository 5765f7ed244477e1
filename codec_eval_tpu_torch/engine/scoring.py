"""Batched scoring: one reference image against N decoded u8 candidates.

Port of ``codec_eval_tpu/engine/scoring.py``.  The reference side (XYB
roundtrip, SSIMULACRA2 and DSSIM pyramids, Butteraugli psycho images and
masks) runs once per image and is cached; each batch of candidates is then
copied, as it is, into one reused host buffer (page-locked for a CUDA
device), sent to the device in one copy, made planar (N, 3, H, W) there,
scored by all four metrics on the scorer's device, and fetched to the host
in one copy.  PyTorch runs eagerly, so candidates are scored as they come,
without padding to buckets.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.butteraugli import butteraugli_batch, precompute_butteraugli_reference
from ..kernels.color import srgb_u8_to_linear, xyb_roundtrip
from ..kernels.dssim import dssim_against_reference, precompute_dssim_reference
from ..kernels.psnr import psnr
from ..kernels.ssimulacra2 import precompute_reference, ssimulacra2_batch_pre
from ..metrics import MetricConfig, MetricResult
from ..utils.profiling import count, span

METRICS = ("dssim", "ssimulacra2", "butteraugli", "psnr")


def metric_config(names: Sequence[str]) -> MetricConfig:
    """The ``MetricConfig`` that turns on the metrics named in ``names``
    (names of ``METRICS``); an unknown name is an error."""
    unknown = sorted(set(names) - set(METRICS))
    if unknown:
        raise ValueError(f"unknown metrics {unknown}: the scorer has {list(METRICS)}")
    return MetricConfig(**{m: m in names for m in METRICS})


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
        with span("ce.scorer.psnr"):
            out["psnr"] = psnr(ref_cmp, batch_u8)
    if config.dssim:
        with span("ce.scorer.dssim"):
            vals = dssim_against_reference(pre["dssim"], lin)
            out["dssim"] = torch.where(identical, torch.zeros_like(vals), vals)
    if config.ssimulacra2:
        with span("ce.scorer.ssimulacra2"):
            out["ssimulacra2"] = ssimulacra2_batch_pre(pre["s2"], ref_cmp, batch_u8,
                                                       lin_planar=lin)
    if config.butteraugli:
        with span("ce.scorer.butteraugli"):
            vals = butteraugli_batch(pre["ba"], lin)
            out["butteraugli"] = torch.where(identical, torch.zeros_like(vals), vals)
    return out


def fetch_scores(scores: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{metric: device tensor} -> {metric: f64 numpy}, with ONE
    device-to-host copy of the stacked scores."""
    if not scores:
        return {}
    keys = sorted(scores)
    with span("ce.scorer.fetch"):
        stacked = torch.stack([scores[k].to(torch.float32) for k in keys]).cpu().numpy()
    return {k: stacked[i].astype(np.float64) for i, k in enumerate(keys)}


def _count_copy(out: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``out``, counting its bytes as staging when it is a fresh copy of ``src``."""
    if not np.may_share_memory(out, src):
        count("staging.host_bytes", out.nbytes)
    return out


Candidates = Union[np.ndarray, Sequence[np.ndarray]]


def _check_candidates(candidates_u8: Candidates, reference_u8: np.ndarray) -> None:
    """Each candidate of an (N, H, W, 3) array or of a sequence of (H, W, 3)
    arrays has the (H, W, 3) shape of the reference."""
    n = len(candidates_u8)
    shapes = ([candidates_u8.shape[1:]] if isinstance(candidates_u8, np.ndarray)
              else [np.shape(c) for c in candidates_u8])
    for shape in shapes:
        if shape != reference_u8.shape or reference_u8.shape[-1] != 3:
            raise ValueError(
                f"candidates {(n, *shape)} do not match reference {reference_u8.shape}"
            )


class HostSlot:
    """One reused host buffer that batches go through to reach their
    devices, page-locked when ``pinned`` (a CUDA device among them).
    ``take`` waits for the copies out of the buffer that ``copied`` last
    recorded, grows the buffer to the batch when it is smaller, and hands
    out its prefix; the caller writes it, issues its ``non_blocking``
    copies, then calls ``copied`` with their devices.  On the CPU nothing
    waits.  ``<counter>.buffer_alloc`` counts a growth and
    ``<counter>.buffer_reuse`` a reuse.  One caller at a time."""

    def __init__(self, pinned: bool, counter: str):
        self.pinned = pinned
        self.counter = counter
        self._buf = torch.empty(0, dtype=torch.uint8)
        self._copied: list = []  # CUDA events after the last copies out of the buffer

    def take(self, nbytes: int) -> Tuple[torch.Tensor, bool]:
        """(the buffer's first ``nbytes`` as flat u8, whether it grew)."""
        for event in self._copied:
            event.synchronize()
        self._copied = []
        grew = self._buf.numel() < nbytes
        if grew:
            self._buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pinned)
        count(f"{self.counter}.buffer_alloc" if grew else f"{self.counter}.buffer_reuse")
        return self._buf[:nbytes], grew

    def copied(self, devices) -> None:
        """Mark the copies just issued to ``devices`` as the buffer's last."""
        for device in {d for d in devices if d.type == "cuda"}:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self._copied.append(event)


class _Staging(HostSlot):
    """The scorer's slot: each (H, W, 3) candidate of a batch is copied into
    the buffer as it is (one contiguous copy each), the whole (N, H, W, 3)
    prefix goes to the device in one copy, and the device makes it planar.
    For a CUDA device the buffer is page-locked and the copy asynchronous;
    the next batch waits for that copy to end before it writes.  The buffer
    grows to the largest batch staged and is reused by every smaller one."""

    def __init__(self, device: torch.device):
        super().__init__(pinned=device.type == "cuda", counter="staging")
        self.device = device

    def stage(self, candidates_u8: Candidates, frame: tuple) -> torch.Tensor:
        """(N, H, W, 3) u8 or N (H, W, 3) u8 host candidates of shape
        ``frame`` (H, W, 3) -> planar (N, 3, H, W) u8 on the device."""
        with span("ce.scorer.stage"):
            shape = (len(candidates_u8), *frame)
            nbytes = math.prod(shape)
            flat, grew = self.take(nbytes)
            count("staging.host_bytes", nbytes if grew else 0)
            host = flat.view(shape)
            view = host.numpy()
            for i, candidate in enumerate(candidates_u8):
                np.copyto(view[i], candidate)
            nhwc = host.to(self.device, non_blocking=True)
            self.copied([self.device])
            return nhwc.permute(0, 3, 1, 2).contiguous()


def score_ladder(
    reference_u8: np.ndarray, candidates_u8: Candidates, config: MetricConfig, device="cuda"
) -> Dict[str, np.ndarray]:
    """The command-line tools' scorer: the candidates of one (H, W, 3)
    reference, an (N, H, W, 3) u8 array or N (H, W, 3) u8 arrays, staged
    once through a buffer of the call's own, planar on ``device``, and
    fetched in one copy, as ``{metric: f64 scores}`` for the metrics
    ``config`` asks for.

    The JAX package's ``rd_calibrate`` and ``analysis.comparison`` compose
    the metric functions without zeroing a candidate equal to the
    reference, which they score 0 to within their rounding (< 1e-6); the
    batch scorer's stages, which zero it, serve here as they are."""
    dev = resolve_device(device)
    _check_candidates(candidates_u8, reference_u8)
    with span("ce.scorer.precompute"):
        count("scorer.precompute_miss")
        contig = _count_copy(np.require(reference_u8, requirements="CW"), reference_u8)
        pre = build_precompute(torch.from_numpy(contig).to(dev), config)
    return fetch_scores(score_chunk(pre, _Staging(dev).stage(candidates_u8, reference_u8.shape), config))


class BatchScorer:
    """Scores batches of decoded candidates against a reference image on one
    device.  The reference precompute is cached by (shape, config, content
    crc), so consecutive chunks against one image skip it, and a caller
    that reuses its decode buffer cannot leave stale pyramids behind.  The
    candidates go through one staging buffer that the scorer keeps."""

    def __init__(self, config: MetricConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._ref_key: object = None
        self._ref_pre = None
        self._staging = _Staging(self.device)

    def enabled(self) -> bool:
        c = self.config
        return c.dssim or c.ssimulacra2 or c.butteraugli or c.psnr

    def precompute(self, reference_u8: np.ndarray) -> Dict[str, object]:
        with span("ce.scorer.precompute"):
            contig = _count_copy(np.require(reference_u8, requirements="CW"), reference_u8)
            c = self.config
            key = (
                reference_u8.shape,
                (c.dssim, c.ssimulacra2, c.butteraugli, c.psnr, c.xyb_roundtrip),
                zlib.crc32(contig.view(np.uint8).reshape(-1).data),
            )
            if self._ref_key == key:
                count("scorer.precompute_hit")
            else:
                count("scorer.precompute_miss")
                self._ref_pre = build_precompute(torch.from_numpy(contig).to(self.device), c)
                self._ref_key = key
            return self._ref_pre

    def score_batch(
        self, reference_u8: np.ndarray, candidates_u8: Candidates
    ) -> list[MetricResult]:
        """reference (H, W, 3) u8; candidates (N, H, W, 3) u8, or a sequence
        of N (H, W, 3) u8 -> N results."""
        n = len(candidates_u8)
        if n == 0 or not self.enabled():
            return [MetricResult() for _ in range(n)]
        _check_candidates(candidates_u8, reference_u8)
        with span("ce.scorer.score_batch"):
            pre = self.precompute(reference_u8)
            batch = self._staging.stage(candidates_u8, reference_u8.shape)
            raw = fetch_scores(score_chunk(pre, batch, self.config))
        return [
            MetricResult(**{k: float(raw[k][i]) if k in raw else None for k in METRICS})
            for i in range(n)
        ]

    def score_pair(self, reference_u8: np.ndarray, candidate_u8: np.ndarray) -> MetricResult:
        """One candidate: ``score_batch`` at N = 1, the same route and kernels."""
        return self.score_batch(reference_u8, [candidate_u8])[0]
