"""Corpus-scale scoring: any list of decoded pairs, bucketed and scored.

Port of ``codec_eval_tpu/parallel/corpus_runner.py``.  Pairs are grouped
into buckets by exact shape, or with ``masked=True`` by padded shape
(multiples of ``granularity``, scored by the masked kernels of
``kernels/masked.py``: one batch per bucket covers every image size inside
it, the right trade for corpora with many distinct sizes).

Unlike the JAX package, which scores a whole bucket as one batch, each
bucket is scored in chunks of at most ``batch`` pairs per device: the
masked pipeline holds tens of f32 planes per pair, so a bucket of hundreds
of 2048 px pairs would not fit on the card in one batch.  The masked path
pads a bucket's short tail chunk to ``batch`` by repeating its last pair
(``kernels.masked.bucket_plan``), and every chunk is padded to a multiple
of the mesh's batch axis the same way; the repeats are dropped from the
results.

The chunks are streamed.  ``stage_pairs_sharded`` plans them, and
``score_staged`` writes each chunk's refs, dists and (masked) true dims
straight into one of two host slots that every call on the mesh reuses
(page-locked for a CUDA mesh; the bucket's slack zeroed and each pair's
valid rectangle copied, with no padded copy in between), sends each tensor
to each device with one asynchronous copy, and issues the chunk's scoring,
then stages the next chunk while the devices score this one.  A slot is
rewritten only after the copies out of it have ended
(``engine.scoring.HostSlot``).  Nothing in the loop waits for the devices:
each chunk's scores stay on them until the call's one fetch, which takes
every chunk's scores to the host in one copy.  On a CPU mesh the same loop
runs, synchronously.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.scoring import HostSlot
from ..utils.profiling import span
from .mesh import (
    Mesh,
    _local_part,
    _mesh_cache_key,
    make_mesh,
    sharded_masked_score_fn,
    sharded_score_fn,
)

# Byte alignment of the true dims after a chunk's refs and dists in a slot.
_ALIGN = 64


@dataclass
class CorpusScores:
    """Per-pair scores (input order) and the corpus mean of each metric."""

    per_pair: List[Dict[str, float]]
    means: Dict[str, float] = field(default_factory=dict)


class Chunk(NamedTuple):
    """One batch of a bucket: the pairs it scores (``indices``), the pair
    of each of its batch rows, repeats included (``rows``), and the (H, W)
    every row is staged at (``frame``: the padded bucket shape, or on the
    exact path the pairs' own)."""

    indices: List[int]
    rows: List[int]
    frame: Tuple[int, int]


@dataclass
class StagedPairs:
    """A corpus slice planned for the mesh (``stage_pairs_sharded``): its
    chunks, which ``score_staged`` copies to the devices and scores, each
    time it is called, from ``pairs`` as they are then."""

    n_pairs: int
    masked: bool
    wanted: frozenset
    step: object
    mesh: Mesh
    pairs: list
    chunks: List[Chunk]


def stage_pairs_sharded(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    mesh=None,
    dssim: bool = True,
    ssimulacra2: bool = True,
    butteraugli: bool = True,
    psnr: bool = True,
    masked: bool = False,
    granularity: int = 128,
    batch: int = 8,
) -> StagedPairs:
    """Check and bucket (ref, dist) (H, W, 3) u8 pairs into chunks of at
    most ``batch`` pairs per device of the mesh (by default every CUDA
    device; an error without one).  The copies to the devices happen chunk
    by chunk in ``score_staged``.

    The masked path always computes all four metrics; the metric flags
    filter the returned scores.
    """
    if mesh is None:
        mesh = make_mesh()
    n_batch = mesh.devices.shape[0]
    flags = {"dssim": dssim, "ssimulacra2": ssimulacra2, "butteraugli": butteraugli,
             "psnr": psnr}
    for i, (ref, dist) in enumerate(pairs):
        if ref.shape != dist.shape:
            raise ValueError(f"pair {i}: reference {ref.shape} and candidate {dist.shape} differ")
        if ref.ndim != 3 or ref.shape[-1] != 3 or not ref.dtype == dist.dtype == np.uint8:
            raise ValueError(f"pair {i}: {ref.shape} {ref.dtype} is not (H, W, 3) uint8")
    if masked:
        from ..kernels.masked import bucket_plan

        step = sharded_masked_score_fn(mesh)
        plan = bucket_plan(pairs, granularity, batch * n_batch)
    else:
        step = sharded_score_fn(mesh, **flags)
        plan = _exact_plan(pairs, batch * n_batch)
    chunks = [Chunk(indices, rows + [rows[-1]] * (-len(rows) % n_batch), frame)
              for indices, rows, frame in plan]
    return StagedPairs(n_pairs=len(pairs), masked=masked,
                       wanted=frozenset(k for k, on in flags.items() if on), step=step,
                       mesh=mesh, pairs=list(pairs), chunks=chunks)


def _exact_plan(pairs, per_chunk: int):
    """Chunks of at most ``per_chunk`` pairs of one exact shape:
    (indices, rows, (H, W))."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, (ref, _) in enumerate(pairs):
        groups.setdefault(ref.shape[:2], []).append(i)
    for frame, idxs in groups.items():
        for start in range(0, len(idxs), per_chunk):
            chunk = idxs[start : start + per_chunk]
            yield chunk, chunk, frame


# Per mesh: the two host slots that every call on it reuses, and the lock
# that keeps one caller at a time in them.
_SLOTS: Dict[tuple, Tuple[threading.Lock, List[HostSlot]]] = {}
_SLOTS_LOCK = threading.Lock()


def _slots(mesh: Mesh) -> Tuple[threading.Lock, List[HostSlot]]:
    key = _mesh_cache_key(mesh)
    with _SLOTS_LOCK:
        if key not in _SLOTS:
            pinned = any(d.type == "cuda" for d in mesh.devices.flat)
            _SLOTS[key] = (threading.Lock(), [HostSlot(pinned, "runner") for _ in range(2)])
        return _SLOTS[key]


def _stage_chunk(slot: HostSlot, staged: StagedPairs, chunk: Chunk) -> tuple:
    """Write this process's rows of ``chunk`` into ``slot`` and issue their
    copies: the step's arguments, (refs, dists) shards and on the masked
    path the per-shard (n, 2) int32 true dims."""
    mesh = staged.mesh
    devices = list(mesh.devices[:, 0])
    rows = _local_part(mesh, np.asarray(chunk.rows))
    n, (h, w) = len(rows), chunk.frame
    if n % len(devices):
        raise ValueError(f"batch of {n} does not split over {len(devices)} devices")
    size = h * w * 3
    hw_at = -(-2 * n * size // _ALIGN) * _ALIGN
    flat, _ = slot.take(hw_at + 8 * n)
    refs = flat[: n * size].view(n, h, w, 3)
    dists = flat[n * size : 2 * n * size].view(n, h, w, 3)
    hw = flat[hw_at : hw_at + 8 * n].view(torch.int32).view(n, 2)
    views, dims = (refs.numpy(), dists.numpy()), hw.numpy()
    for j, i in enumerate(rows):
        vh, vw = dims[j] = staged.pairs[i][0].shape[:2]
        for view, img in zip(views, staged.pairs[i]):
            view[j, :vh, :vw] = img
            view[j, vh:] = 0
            view[j, :vh, vw:] = 0
    per = n // len(devices)

    def shards(t: torch.Tensor) -> list:
        return [part.to(dev, non_blocking=True) for part, dev in zip(t.split(per), devices)]

    args = (shards(refs), shards(dists)) + ((shards(hw),) if staged.masked else ())
    slot.copied(devices)
    return args


def _fetch(issued: List[Dict[str, torch.Tensor]], keys: List[str]) -> Dict[str, np.ndarray]:
    """Every chunk's scores of ``keys`` (on the mesh's first device) to the
    host in one copy: {metric: f64 scores, chunk after chunk}."""
    with span("ce.runner.fetch"):
        stacked = torch.stack([torch.cat([s[k] for s in issued]) for k in keys]).cpu().numpy()
        return {k: stacked[i].astype(np.float64) for i, k in enumerate(keys)}


def score_staged(staged: StagedPairs) -> CorpusScores:
    """Copy each chunk of a planned corpus slice to the devices and score
    it, staging the next chunk while the devices score this one, then
    fetch every score in one copy; the means are taken on the host."""
    lock, slots = _slots(staged.mesh)
    issued: List[Dict[str, torch.Tensor]] = []
    with lock:
        for k, chunk in enumerate(staged.chunks):
            with span("ce.runner.stage"):
                args = _stage_chunk(slots[k % 2], staged, chunk)
            with span("ce.runner.bucket"):
                scores, _ = staged.step(*args)
            issued.append(scores)
    keys = [k for k in issued[0] if k in staged.wanted] if issued else []
    got = _fetch(issued, keys) if keys else {}

    per_pair: List[Optional[Dict[str, float]]] = [None] * staged.n_pairs
    offset = 0
    for chunk in staged.chunks:
        for j, i in enumerate(chunk.indices):
            per_pair[i] = {k: float(got[k][offset + j]) for k in keys}
        offset += len(chunk.rows)
    result = CorpusScores(per_pair=[p for p in per_pair if p is not None])
    if result.per_pair:
        result.means = {k: float(np.mean([p[k] for p in result.per_pair])) for k in keys}
    return result


def score_pairs_sharded(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    mesh=None,
    dssim: bool = True,
    ssimulacra2: bool = True,
    butteraugli: bool = True,
    psnr: bool = True,
    masked: bool = False,
    granularity: int = 128,
    batch: int = 8,
) -> CorpusScores:
    """Plan and score in one call (see ``stage_pairs_sharded``)."""
    with span("ce.runner.score_pairs"):
        return score_staged(
            stage_pairs_sharded(
                pairs, mesh=mesh, dssim=dssim, ssimulacra2=ssimulacra2, butteraugli=butteraugli,
                psnr=psnr, masked=masked, granularity=granularity, batch=batch,
            )
        )


__all__ = [
    "CorpusScores",
    "StagedPairs",
    "score_pairs_sharded",
    "score_staged",
    "stage_pairs_sharded",
]
