"""Device meshes for corpus-scale scoring.

Port of ``codec_eval_tpu/parallel/mesh.py``.  The (image x codec x quality)
score grid is laid out as a batch of decoded pairs, split over the devices
of a mesh's ``batch`` axis, and scored shard by shard; each step returns the
per-pair scores and the corpus means.  On one H100 the mesh is one device,
and the API is kept for more.

The ``space`` axis (spatial sharding of one image's rows over devices) is
not ported: ``n_space > 1`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..engine.scoring import resolve_device

METRICS = ("psnr", "ssimulacra2", "dssim", "butteraugli")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (batch, space) grid of devices."""

    devices: np.ndarray  # (n_batch, n_space) of torch.device
    axis_names: tuple = ("batch", "space")


def make_mesh(n_batch: Optional[int] = None, n_space: int = 1, devices=None) -> Mesh:
    """A (batch, space) mesh over ``devices``: every CUDA device by default,
    and an error when there is none (never a quiet fall back to the CPU).
    ``devices=[torch.device("cpu")]`` scores on the host."""
    if n_space != 1:
        raise NotImplementedError(
            "spatial sharding (n_space > 1) is not ported: ROADMAP queue 1, multi-device"
        )
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices= for the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_batch is None:
        n_batch = len(devices)
    if not 0 < n_batch <= len(devices):
        raise ValueError(f"mesh {n_batch}x{n_space} needs {n_batch} devices, have {len(devices)}")
    grid = np.empty((n_batch, n_space), dtype=object)
    for i, d in enumerate(devices[:n_batch]):
        grid[i, 0] = d
    return Mesh(grid)


def shard_batch(mesh: Mesh, batch: np.ndarray) -> list:
    """Split a host batch (N, ...) over the mesh's batch axis: one tensor
    per device, N divisible by the axis size."""
    n_batch = mesh.devices.shape[0]
    if len(batch) % n_batch:
        raise ValueError(f"batch of {len(batch)} does not split over {n_batch} devices")
    return [
        torch.from_numpy(np.ascontiguousarray(part)).to(dev)
        for part, dev in zip(np.split(batch, n_batch), mesh.devices[:, 0])
    ]


def _gather(mesh: Mesh, shards: list) -> tuple:
    """Per-shard {metric: (n,)} on their devices -> per-pair scores on the
    mesh's first device and the corpus means."""
    first = mesh.devices[0, 0]
    per_pair = {k: torch.cat([s[k].to(first) for s in shards]) for k in shards[0]}
    return per_pair, {f"mean_{k}": torch.mean(v) for k, v in per_pair.items()}


# Steps are cached per (mesh, metric flags), as the JAX package caches its
# jitted steps; PyTorch compiles nothing, so the cache only keeps one step
# object per configuration for the staging calls to share.
_SCORE_FN_CACHE: dict = {}


def _mesh_cache_key(mesh: Mesh):
    return (tuple(str(d) for d in mesh.devices.flat), mesh.devices.shape, mesh.axis_names)


def sharded_score_fn(
    mesh: Mesh, dssim: bool = True, ssimulacra2: bool = True, butteraugli: bool = True,
    psnr: bool = True,
):
    """The (cached) dense scoring step over the mesh.

    Returns ``step(refs, dists) -> (per_pair, aggregates)``, where refs and
    dists are ``shard_batch`` shards of one exact shape (N, H, W, 3) u8,
    each pair scored through the single-pair kernels of ``kernels/``;
    ``per_pair`` maps each metric to (N,) scores and ``aggregates`` each
    ``mean_<metric>`` to the corpus mean.
    """
    key = ("dense", _mesh_cache_key(mesh), dssim, ssimulacra2, butteraugli, psnr)
    cached = _SCORE_FN_CACHE.get(key)
    if cached is not None:
        return cached
    from ..kernels.butteraugli import butteraugli as ba_pair
    from ..kernels.dssim import dssim_u8
    from ..kernels.psnr import psnr as psnr_pair
    from ..kernels.ssimulacra2 import ssimulacra2 as s2_pair

    fns = {"psnr": psnr_pair, "ssimulacra2": s2_pair, "dssim": dssim_u8,
           "butteraugli": ba_pair}
    on = {"psnr": psnr, "ssimulacra2": ssimulacra2, "dssim": dssim, "butteraugli": butteraugli}
    wanted = [k for k in METRICS if on[k]]

    def score_shard(refs: torch.Tensor, dists: torch.Tensor) -> dict:
        return {k: torch.stack([fns[k](r, d) for r, d in zip(refs, dists)]) for k in wanted}

    def step(refs: list, dists: list):
        return _gather(mesh, [score_shard(r, d) for r, d in zip(refs, dists)])

    _SCORE_FN_CACHE[key] = step
    return step


def sharded_masked_score_fn(mesh: Mesh):
    """The (cached) scoring step for mixed-size pairs padded to one bucket.

    Returns ``step(refs, dists, valid_hw) -> (per_pair, aggregates)``, where
    refs and dists are ``shard_batch`` shards of (N, H_pad, W_pad, 3) u8
    padded with ``kernels.masked.pad_to_bucket`` and valid_hw the (N, 2)
    host array of true dims; all four masked metrics
    (``kernels/masked.py``), one batch per shard.
    """
    key = ("masked", _mesh_cache_key(mesh))
    cached = _SCORE_FN_CACHE.get(key)
    if cached is not None:
        return cached
    from ..kernels.masked import _fused_masked_all

    def step(refs: list, dists: list, valid_hw: np.ndarray):
        parts = np.split(np.asarray(valid_hw), len(refs))
        return _gather(mesh, [_fused_masked_all(r, d, torch.from_numpy(hw).to(r.device))
                              for r, d, hw in zip(refs, dists, parts)])

    _SCORE_FN_CACHE[key] = step
    return step


__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "sharded_masked_score_fn",
    "sharded_score_fn",
]
