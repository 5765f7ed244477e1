"""Device meshes for corpus-scale scoring.

Port of ``codec_eval_tpu/parallel/mesh.py``.  The (image x codec x quality)
score grid is laid out as a batch of decoded pairs, split over the devices
of a mesh's ``batch`` axis, and scored shard by shard; each step returns the
per-pair scores and the corpus means.  On one H100 the mesh is one device,
and the API is kept for more.

The ``space`` axis shards one image's rows over devices: with
``spatial=True`` each pair is scored as row bands with a recompute halo
(``parallel/spatial.py``), where XLA's partitioner exchanges halos in JAX.

A global mesh (``multihost.global_batch_mesh``) spans processes: each
process holds its own devices and scores its share of the batch, and each
step all-gathers the per-pair scores over the process group, in process
order, so that every process returns the whole batch's scores and the same
means, as JAX's replicated aggregates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from . import spatial as _spatial

METRICS = ("psnr", "ssimulacra2", "dssim", "butteraugli")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (batch, space) grid of this process's devices.  A global mesh
    (``process_count > 1``) has the same local grid in every process of
    the group, and its batch axis spans them all."""

    devices: np.ndarray  # (n_batch, n_space) of torch.device, this process's
    axis_names: tuple = ("batch", "space")
    process_index: int = 0
    process_count: int = 1


def make_mesh(n_batch: Optional[int] = None, n_space: int = 1, devices=None) -> Mesh:
    """A (batch, space) mesh over ``devices``: every CUDA device by default,
    and an error when there is none (never a quiet fall back to the CPU).
    ``devices=[torch.device("cpu")]`` scores on the host.  A device may be
    named more than once: ``[cuda:0, cuda:0]`` with ``n_space=2`` scores
    a pair's two row bands in turn on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass devices= for the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_space < 1:
        raise ValueError(f"n_space must be at least 1, got {n_space}")
    if n_batch is None:
        n_batch = len(devices) // n_space
    if n_batch < 1 or n_batch * n_space > len(devices):
        raise ValueError(f"mesh {n_batch}x{n_space} needs {n_batch * n_space} devices, "
                         f"have {len(devices)}")
    grid = np.empty((n_batch, n_space), dtype=object)
    for i, d in enumerate(devices[: n_batch * n_space]):
        grid[i // n_space, i % n_space] = d
    return Mesh(grid)


def _local_part(mesh: Mesh, batch: np.ndarray) -> np.ndarray:
    """This process's contiguous slice of a global batch."""
    if mesh.process_count == 1:
        return batch
    if len(batch) % mesh.process_count:
        raise ValueError(f"batch of {len(batch)} does not split over "
                         f"{mesh.process_count} processes")
    per = len(batch) // mesh.process_count
    return batch[mesh.process_index * per : (mesh.process_index + 1) * per]


def _split_local(mesh: Mesh, batch: np.ndarray, spatial: bool) -> list:
    """Split this process's batch (N, ...) over its batch axis: per batch
    row one tensor on the row's first device, or with ``spatial`` one
    ``BandedBatch`` whose row bands lie on the row's space devices."""
    n_batch = mesh.devices.shape[0]
    if len(batch) % n_batch:
        raise ValueError(f"batch of {len(batch)} does not split over {n_batch} devices")
    parts = np.split(batch, n_batch)
    if spatial:
        return [_spatial.shard_rows(part, list(row)) for part, row in zip(parts, mesh.devices)]
    return [
        torch.from_numpy(np.ascontiguousarray(part)).to(dev)
        for part, dev in zip(parts, mesh.devices[:, 0])
    ]


def shard_batch(mesh: Mesh, batch: np.ndarray, spatial: bool = False) -> list:
    """Place a host (N, ...) batch on the mesh, such as (N, H, W, 3) images
    or their (N, 2) true dims: split over the batch axis, one tensor per
    batch row of devices, N divisible by the axis size.  With ``spatial`` each row's share is cut into row bands over the
    space axis (``parallel/spatial.py``).  On a global mesh every process
    passes the same whole batch and keeps its own contiguous slice."""
    return _split_local(mesh, _local_part(mesh, batch), spatial)


def all_gather_host(mesh: Mesh, local: dict) -> dict:
    """Every process's {key: host array}, concatenated on axis 0 in process
    order, over the mesh's process group."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() != mesh.process_count:
        raise RuntimeError("a global mesh needs its process group: call "
                           "multihost.initialize_distributed first")
    every = [None] * mesh.process_count
    dist.all_gather_object(every, local)
    return {k: np.concatenate([p[k] for p in every]) for k in local}


def _gather(mesh: Mesh, shards: list) -> tuple:
    """Per-shard {metric: (n,)} on their devices -> per-pair scores on the
    mesh's first device and the corpus means; on a global mesh, those of
    the whole batch in every process."""
    first = mesh.devices[0, 0]
    per_pair = {k: torch.cat([s[k].to(first) for s in shards]) for k in shards[0]}
    if mesh.process_count > 1:
        every = all_gather_host(mesh, {k: v.cpu().numpy() for k, v in per_pair.items()})
        per_pair = {k: torch.from_numpy(v).to(first) for k, v in every.items()}
    return per_pair, {f"mean_{k}": torch.mean(v) for k, v in per_pair.items()}


# Steps are cached per (mesh, metric flags), as the JAX package caches its
# jitted steps; PyTorch compiles nothing, so the cache only keeps one step
# object per configuration for the staging calls to share.
_SCORE_FN_CACHE: dict = {}


def _mesh_cache_key(mesh: Mesh):
    return (tuple(str(d) for d in mesh.devices.flat), mesh.devices.shape, mesh.axis_names,
            mesh.process_index, mesh.process_count)


def sharded_score_fn(
    mesh: Mesh, dssim: bool = True, ssimulacra2: bool = True, butteraugli: bool = True,
    psnr: bool = True, spatial: bool = False,
):
    """The (cached) dense scoring step over the mesh.

    Returns ``step(refs, dists) -> (per_pair, aggregates)``, where refs and
    dists are ``shard_batch`` shards of one exact shape (N, H, W, 3) u8,
    each pair scored through the single-pair kernels of ``kernels/``;
    ``per_pair`` maps each metric to (N,) scores and ``aggregates`` each
    ``mean_<metric>`` to the corpus mean.  With ``spatial`` the shards are
    ``shard_batch(..., spatial=True)``'s row bands, each pair scored band
    by band on its row of space devices.  On a global mesh both cover the
    whole batch, in every process.
    """
    key = ("dense", _mesh_cache_key(mesh), dssim, ssimulacra2, butteraugli, psnr, spatial)
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

    def score_banded(refs, dists, device: torch.device) -> dict:
        pairs = [_spatial.score_banded_pair(refs, dists, k, wanted, device)
                 for k in range(len(refs))]
        return {k: torch.stack([p[k] for p in pairs]) for k in wanted}

    def step(refs: list, dists: list):
        if any(isinstance(r, _spatial.BandedBatch) != spatial for r in (*refs, *dists)):
            raise TypeError(f"a step with spatial={spatial} takes "
                            f"shard_batch(..., spatial={spatial}) shards")
        if spatial:
            return _gather(mesh, [score_banded(r, d, row[0])
                                  for r, d, row in zip(refs, dists, mesh.devices)])
        return _gather(mesh, [score_shard(r, d) for r, d in zip(refs, dists)])

    _SCORE_FN_CACHE[key] = step
    return step


def sharded_masked_score_fn(mesh: Mesh):
    """The (cached) scoring step for mixed-size pairs padded to one bucket.

    Returns ``step(refs, dists, valid_hw) -> (per_pair, aggregates)``, where
    refs, dists and valid_hw are ``shard_batch`` shards of (N, H_pad, W_pad,
    3) u8 pairs padded with ``kernels.masked.pad_to_bucket`` and of their
    (N, 2) int true dims (the corpus runner stages the three through its
    page-locked slots instead); all four masked metrics
    (``kernels/masked.py``), one batch per shard.
    """
    key = ("masked", _mesh_cache_key(mesh))
    cached = _SCORE_FN_CACHE.get(key)
    if cached is not None:
        return cached
    from ..kernels.masked import _fused_masked_all

    def step(refs: list, dists: list, valid_hw: list):
        return _gather(mesh, [_fused_masked_all(r, d, hw)
                              for r, d, hw in zip(refs, dists, valid_hw)])

    _SCORE_FN_CACHE[key] = step
    return step


__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "sharded_masked_score_fn",
    "sharded_score_fn",
]
