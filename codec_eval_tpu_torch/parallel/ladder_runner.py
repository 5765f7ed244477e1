"""Corpus-scale tpujpeg ladders on a device mesh.

Port of ``codec_eval_tpu/parallel/ladder_runner.py``: the corpus form of
``engine.tpu_sweep``, whose one per-image ladder it runs for each image,
the device replacement for the reference's
calibration hot path (reference: crates/codec-compare/src/rd_calibrate.rs:
184-216, rayon threads fanning encodes and CPU metrics over a corpus).
Each image's whole ladder (encode, decode, score) runs on a device of the
mesh's batch axis, and only quantized coefficients, or with
``with_sizes="device"`` their packed symbol counts, come back to the host.

On one H100 the mesh is one device.  JAX pads each chunk to a multiple of
the batch axis and unrolls it per shard; eager PyTorch scores no padded
repeat on one process.  With exact sizes a one-worker pool entropy-codes
each image's ladder while the device scores it and the images after it.

``multihost=True`` runs over a global mesh (``multihost.global_batch_mesh``):
every process passes the same images and scores its contiguous slice of
each chunk on its own devices (the chunk padded by repeating its last image
up to a multiple of the process count, as JAX pads to a multiple of the
batch axis); the scores and packed rate statistics are all-gathered over
the process group, so that every process returns the whole
``CorpusLadders``.

Tracing (``utils.profiling``): one ``ce.ladder.sweep`` span per call; in
it, per image, ``ce.ladder.image`` (the encoder's ``ce.jpeg.*`` spans,
``ce.ladder.rate`` and ``ce.ladder.score``), per chunk ``ce.ladder.fetch``
and, with device sizes, ``ce.ladder.sizes``; with exact sizes,
``ce.ladder.entropy_wait`` per image at the end.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.scoring import METRICS
from ..utils.profiling import span
from .mesh import all_gather_host, make_mesh

__all__ = ["CorpusLadders", "sweep_corpus_ladders", "LADDER_SCORE_PX"]

#: Candidate pixels per scoring call: a ladder's quality axis is scored in
#: chunks of at most this many pixels (the JAX package's default), which
#: bounds the scorer's temporaries at large image sizes.
LADDER_SCORE_PX = 21_000_000


@dataclass
class CorpusLadders:
    """Ladder scores and sizes for N images x n_q qualities (input order)."""

    qualities: List[float]
    scores: Dict[str, np.ndarray]  # metric -> (N, n_q)
    sizes: Optional[np.ndarray]  # (N, n_q) int64 bytes, or None
    bits_per_pixel: Optional[np.ndarray]  # (N, n_q), or None

    def mean_curve(self, metric: str) -> List[tuple]:
        """Corpus-mean (bpp, score) per quality: rd-calibrate's aggregation
        (reference: rd_calibrate.rs:240-260)."""
        if self.bits_per_pixel is None:
            raise ValueError("sizes were not computed (with_sizes=False)")
        m = self.scores[metric]
        return [
            (float(self.bits_per_pixel[:, qi].mean()), float(m[:, qi].mean()))
            for qi in range(m.shape[1])
        ]


def _lengths(futures) -> List[int]:
    return [len(f.result()) for f in futures]


def sweep_corpus_ladders(
    images: Sequence[np.ndarray],
    qualities: Sequence[float],
    mesh=None,
    subsampling: str = "420",
    aq_strength: float = 0.30,
    metrics: Sequence[str] = METRICS,
    with_sizes: "bool | str" = True,
    images_per_chunk: int = 8,
    trellis_lambda: float = 0.0,
    multihost: bool = False,
) -> CorpusLadders:
    """tpujpeg quality ladders of a same-size (H, W, 3) u8 corpus, on the
    devices of ``mesh``'s batch axis (every CUDA device by default; an
    error without one; ``make_mesh(devices=[torch.device("cpu")])`` runs on
    the host).  A process's k-th image of a chunk runs on its device k mod n.

    Images go in chunks of ``images_per_chunk`` (scaled down by area above
    512 x 512, as in JAX).  with_sizes="device" reduces each ladder to
    packed symbol counts on its device (entropy-exact sizes, 0xFF stuffing
    estimated); True entropy-codes the fetched coefficients on the host
    for exact bytes; False scores only.

    ``multihost=True`` needs a global mesh and its process group, and
    ``with_sizes`` False or "device": exact sizes would entropy-code on
    the host once per process.
    """
    from ..engine import tpu_sweep
    from ..engine.scoring import fetch_scores
    from ..kernels import jpeg_enc as _je
    from ..kernels import jpeg_rate as _jr

    size_mode = tpu_sweep._size_mode(with_sizes)
    if multihost and size_mode == "exact":
        raise ValueError(
            "multihost ladders need with_sizes=False or 'device' "
            "(host entropy coding would run once per process)"
        )
    if not images:
        raise ValueError("no images")
    h, w = images[0].shape[:2]
    for im in images:
        if im.shape[:2] != (h, w):
            raise ValueError("sweep_corpus_ladders requires same-size images")
    if mesh is None:
        mesh = make_mesh(n_space=1)
    if mesh.process_count > 1 and not multihost:
        raise ValueError("a global mesh runs ladders with multihost=True")
    procs, pid = mesh.process_count, mesh.process_index
    devices = list(mesh.devices[:, 0])
    n_q = len(qualities)
    q_chunk = max(1, min(n_q, LADDER_SCORE_PX // (h * w)))
    qtabs = _je.qtabs_for(qualities)
    if h * w > 512 * 512:
        images_per_chunk = max(1, images_per_chunk * (512 * 512) // (h * w))
    chunk_n = -(-images_per_chunk // procs) * procs

    n = len(images)
    all_scores: Dict[str, List[np.ndarray]] = {}
    sizes = np.zeros((n, n_q), dtype=np.int64) if size_mode != "none" else None
    encodes: List[tuple] = []

    with span("ce.ladder.sweep"), ThreadPoolExecutor(max_workers=1) as size_pool:
        for start in range(0, n, chunk_n):
            real = min(chunk_n, n - start)
            # One process scores the whole chunk; over processes each scores
            # its contiguous slice of the chunk padded to a multiple of them.
            per = -(-real // procs)
            mine = [min(start + i, n - 1) for i in range(pid * per, (pid + 1) * per)]
            # With exact sizes the one-worker pool codes each image's ladder
            # while the device scores it and the next ones.
            rows = [tpu_sweep._image_ladder(
                images[i], devices[k % len(devices)], qtabs, subsampling, aq_strength, "ycbcr",
                False, trellis_lambda, metrics, size_mode, size_pool, q_chunk)
                for k, i in enumerate(mine)]
            # Counted behind the images' own jobs: the runner keeps the sizes,
            # not the bytes.
            encodes += [(i, size_pool.submit(_lengths, pending))
                        for i, (_, _, pending) in zip(mine, rows) if pending]
            with span("ce.ladder.fetch"):
                chunk = fetch_scores({k: torch.stack([s[k].to(devices[0]) for s, _, _ in rows])
                                      for k in rows[0][0]})
                if size_mode == "device":
                    chunk["_stats"] = torch.stack([st.to(devices[0])
                                                   for _, st, _ in rows]).cpu().numpy()
            if multihost:
                chunk = all_gather_host(mesh, chunk)
            for k, v in chunk.items():
                if k != "_stats":
                    all_scores.setdefault(k, []).append(v[:real])
            if size_mode == "device":
                # One native call builds the whole chunk's tables.
                with span("ce.ladder.sizes"):
                    packed = chunk["_stats"][:real].reshape(real * n_q, -1)
                    sizes[start:start + real] = np.reshape(
                        _jr.size_estimates_from_packed(packed), (real, n_q))
        for i, counted in encodes:
            with span("ce.ladder.entropy_wait"):
                sizes[i] = counted.result()

    return CorpusLadders(
        qualities=[float(q) for q in qualities],
        scores={k: np.concatenate(v) for k, v in all_scores.items()},
        sizes=sizes,
        bits_per_pixel=(sizes * 8.0 / (h * w)) if sizes is not None else None,
    )
