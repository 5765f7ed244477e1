"""Corpus-scale scoring over a mesh of devices (one H100: a mesh of one)."""

from .corpus_runner import (
    CorpusScores,
    StagedPairs,
    score_pairs_sharded,
    score_staged,
    stage_pairs_sharded,
)
from .mesh import Mesh, make_mesh, shard_batch, sharded_masked_score_fn, sharded_score_fn

__all__ = [
    "CorpusScores",
    "Mesh",
    "StagedPairs",
    "make_mesh",
    "score_pairs_sharded",
    "score_staged",
    "shard_batch",
    "sharded_masked_score_fn",
    "sharded_score_fn",
    "stage_pairs_sharded",
]
