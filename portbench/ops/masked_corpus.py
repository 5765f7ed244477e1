"""A mixed-size corpus slice: ``parallel.score_pairs_sharded(pairs,
masked=True)``, one call after another in a closed loop.

Each call scores one image of each shape the traffic lists (aspect ratios
with the configuration's long side) at ``qualities_per_image`` qualities
drawn from the seed out of the ladder: every call has the same shapes and
the same number of pairs, in another mix of qualities.  The calls cycle through ``schedule_calls`` such draws.
The check holds a sample of the distinct pairs scored, drawn from the seed
with every shape in it, to the reference's exact scores at each pair's own
size."""

from __future__ import annotations

import numpy as np

from .. import compare, inputs
from ..reference.score import METRICS, score_ladder


def shapes(long_side: int, aspects) -> list:
    """(h, w) of each aspect [w, h], the longer side ``long_side``."""
    out = []
    for aw, ah in aspects:
        if aw >= ah:
            out.append((long_side * ah // aw, long_side))
        else:
            out.append((long_side, long_side * aw // ah))
    return out


class Op:
    def __init__(self, cell, seed: int, device: str):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.shapes = shapes(int(cfg["long_side"]), tr["aspects"])
        self.qualities = inputs.ladder(cfg["qualities"])
        self.subsampling = cfg["subsampling"]
        per_image = int(tr["qualities_per_image"])
        rng = np.random.default_rng(seed)
        self.schedule = [
            [sorted(rng.choice(self.qualities, per_image, replace=False).tolist())
             for _ in self.shapes]
            for _ in range(int(tr["schedule_calls"]))
        ]
        self._ref: dict = {}
        self._low: dict = {}

    def setup(self) -> None:
        import torch
        from codec_eval_tpu_torch import parallel

        self.images = inputs.make_images(self.seed, self.shapes)
        jobs = sorted({(k, q) for call in self.schedule for k, qs in enumerate(call) for q in qs})
        self.cands = inputs.make_candidates(self.images, jobs, self.subsampling)
        self._score = parallel.score_pairs_sharded
        self.mesh = (None if self.device == "cuda"
                     else parallel.make_mesh(devices=[torch.device(self.device)]))

    def warmup(self) -> None:
        for i in range(int(self.cell.traffic.get("warmup_calls", 1))):
            self.call(i)

    def call(self, i: int):
        keys = [(k, q) for k, qs in enumerate(self.schedule[i % len(self.schedule)]) for q in qs]
        pairs = [(self.images[k], self.cands[(k, q)][1]) for k, q in keys]
        result = self._score(pairs, mesh=self.mesh, masked=True)
        return len(pairs), list(zip(keys, result.per_pair)), {}

    def release(self) -> None:
        import torch

        self.mesh = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, calls, control: bool = False):
        """A sample of the distinct pairs scored (``check_pairs_per_shape``
        of each shape, drawn from the seed), every time it was scored,
        against the reference's exact scores of that pair at its size."""
        chunk = int(self.cell.workload["reference_chunk"])
        per_shape = int(self.cell.workload["check_pairs_per_shape"])
        scored = sorted({key for c in calls for key, _ in c.answer})
        rng = np.random.default_rng(self.seed + 1)
        sample = set()
        for k in range(len(self.shapes)):
            mine = [key for key in scored if key[0] == k]
            picks = rng.permutation(len(mine))[:per_shape]
            sample.update(mine[p] for p in picks)
        ref, low = self._ref, self._low
        for k in range(len(self.shapes)):
            for table, lowp in ((ref, False),) + (((low, True),) if control else ()):
                qs = sorted(q for kk, q in sample if kk == k and (k, q) not in table)
                if not qs:
                    continue
                cands = np.stack([self.cands[(k, q)][1] for q in qs])
                got = score_ladder(self.images[k], cands, METRICS, self.device, lowp, chunk)
                for j, q in enumerate(qs):
                    table[(k, q)] = {m: float(got[m][j]) for m in METRICS}
        triples = []
        for c in calls:
            for key, got in c.answer:
                if key in sample:
                    src = low[key] if control else got
                    triples.extend((m, src[m], ref[key][m]) for m in METRICS)
        return compare.checks(compare.widest(triples), self.cell.workload["limits"])
