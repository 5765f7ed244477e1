"""Corpus-scale scoring: any list of decoded pairs, bucketed and scored.

Port of ``codec_eval_tpu/parallel/corpus_runner.py``.  Pairs are grouped
into buckets by exact shape, or with ``masked=True`` by padded shape
(multiples of ``granularity``, scored by the masked kernels of
``kernels/masked.py``: one batch per bucket covers every image size inside
it, the right trade for corpora with many distinct sizes).  Each bucket's
batch is padded to a multiple of the mesh's batch axis by repeating its last
pair, the repeats dropped from the results, and scored over the mesh.

Unlike the JAX package, which scores a whole masked bucket as one batch,
the masked path scores each bucket in chunks of at most ``batch`` pairs per
device (``kernels.masked._bucketed_chunks``, tail repeats included): the
masked pipeline holds tens of f32 planes per pair, so a bucket of hundreds
of 2048 px pairs would not fit on the card in one batch.

Staging and scoring are split (``stage_pairs_sharded`` / ``score_staged``)
so that a caller can stage the next corpus slice onto the devices while the
current one is scored, and time the scoring alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import span
from .mesh import make_mesh, shard_batch, sharded_masked_score_fn, sharded_score_fn


@dataclass
class CorpusScores:
    """Per-pair scores (input order) and the corpus mean of each metric."""

    per_pair: List[Dict[str, float]]
    means: Dict[str, float] = field(default_factory=dict)


@dataclass
class StagedPairs:
    """A bucketed corpus slice on the mesh's devices (``stage_pairs_sharded``).

    ``buckets`` holds, per exact shape or, on the masked path, per chunk of
    a padded shape: the original pair indices, the sharded batches (refs,
    dists) and, on the masked path, the per-pair true (h, w) array.
    """

    n_pairs: int
    masked: bool
    wanted: frozenset
    step: object
    buckets: List[Tuple[List[int], list, list, Optional[np.ndarray]]]


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
    """Bucket, pad and copy (ref, dist) u8 pairs onto the mesh (by default
    every CUDA device; an error without one).

    The masked path always computes all four metrics; the metric flags
    filter the returned scores.  It scores at most ``batch`` pairs per
    device at a time, so a bucket is staged as one or more chunks.
    """
    if mesh is None:
        mesh = make_mesh()
    n_batch = mesh.devices.shape[0]
    flags = {"dssim": dssim, "ssimulacra2": ssimulacra2, "butteraugli": butteraugli,
             "psnr": psnr}
    wanted = frozenset(k for k, on in flags.items() if on)
    for i, (ref, dist) in enumerate(pairs):
        if ref.shape != dist.shape:
            raise ValueError(f"pair {i}: reference {ref.shape} and candidate {dist.shape} differ")
    with span("ce.runner.stage"):
        if masked:
            from ..kernels.masked import _bucketed_chunks

            step = sharded_masked_score_fn(mesh)
            chunks = _bucketed_chunks(pairs, granularity, batch * n_batch)
        else:
            step = sharded_score_fn(mesh, **flags)
            chunks = _exact_buckets(pairs)

        staged = []
        for indices, refs, dists, hw in chunks:
            n = len(refs)
            padded = -(-n // n_batch) * n_batch
            if padded != n:
                refs = np.concatenate([refs, np.repeat(refs[-1:], padded - n, 0)])
                dists = np.concatenate([dists, np.repeat(dists[-1:], padded - n, 0)])
                if masked:
                    hw = np.concatenate([hw, np.repeat(hw[-1:], padded - n, 0)])
            staged.append((indices, shard_batch(mesh, refs), shard_batch(mesh, dists), hw))
        return StagedPairs(n_pairs=len(pairs), masked=masked, wanted=wanted, step=step,
                           buckets=staged)


def _exact_buckets(pairs):
    """One batch per exact pair shape: (indices, refs, dists, None)."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, (ref, _) in enumerate(pairs):
        groups.setdefault(ref.shape, []).append(i)
    for indices in groups.values():
        yield (indices, np.stack([pairs[i][0] for i in indices]),
               np.stack([pairs[i][1] for i in indices]), None)


def score_staged(staged: StagedPairs) -> CorpusScores:
    """Score a staged corpus slice; the means are taken on the host."""
    per_pair: List[Optional[Dict[str, float]]] = [None] * staged.n_pairs
    for indices, refs, dists, hw in staged.buckets:
        with span("ce.runner.bucket"):
            if staged.masked:
                scores, _ = staged.step(refs, dists, hw)
            else:
                scores, _ = staged.step(refs, dists)
        with span("ce.runner.fetch"):
            scores = {k: v.cpu().numpy().astype(np.float64)
                      for k, v in scores.items() if k in staged.wanted}
        for j, i in enumerate(indices):
            per_pair[i] = {k: float(scores[k][j]) for k in scores}

    result = CorpusScores(per_pair=[p for p in per_pair if p is not None])
    if result.per_pair:
        keys = result.per_pair[0].keys()
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
    """Stage and score in one call (see ``stage_pairs_sharded``)."""
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
