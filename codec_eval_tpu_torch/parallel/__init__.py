"""Corpus-scale scoring over a mesh of devices (one H100: a mesh of one),
row bands of one image over its space axis (``spatial``), and meshes that
span processes (``multihost``)."""

from .corpus_runner import (
    CorpusScores,
    StagedPairs,
    score_pairs_sharded,
    score_staged,
    stage_pairs_sharded,
)
from .ladder_runner import CorpusLadders, sweep_corpus_ladders
from .mesh import Mesh, make_mesh, shard_batch, sharded_masked_score_fn, sharded_score_fn

__all__ = [
    "CorpusLadders",
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
    "sweep_corpus_ladders",
]

from . import multihost

__all__ += ["multihost"]
