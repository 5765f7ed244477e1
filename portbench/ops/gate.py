"""The CI gate: ``assert_quality(reference, candidate, min_ssimulacra2=...,
max_dssim=...)``, one caller in a closed loop with no think time.

Each call takes a (image, quality) pair drawn from the seed out of the
configuration's images and ladder; a threshold miss
(``QualityBelowThreshold``) is a completed gate, not a failure.  The gate
builds a new scorer per call and returns no scores, so the scores it
computed are read from ``BatchScorer.score_pair``'s results through a
recorder the benchmark puts on that method (restored at release)."""

from __future__ import annotations

import numpy as np

from .. import compare, inputs, spans
from ..harness import Check
from ..reference.score import score_ladder

METRICS = ("ssimulacra2", "dssim")
DRAWS = 4096


class Op:
    def __init__(self, cell, seed: int, device: str):
        cfg = cell.config
        self.cell, self.seed, self.device = cell, seed, device
        self.n = int(cfg["images"])
        self.shape = (int(cfg["height"]), int(cfg["width"]))
        self.qualities = inputs.ladder(cfg["qualities"])
        self.subsampling = cfg["subsampling"]
        self.thresholds = cell.workload["thresholds"]
        rng = np.random.default_rng(seed)
        self.draws = list(zip(rng.integers(0, self.n, DRAWS).tolist(),
                              rng.choice(self.qualities, DRAWS).tolist()))
        self.results: list = []
        self._ref: dict = {}
        self._low: dict = {}

    def setup(self) -> None:
        from codec_eval_tpu_torch.engine import helpers, scoring
        from codec_eval_tpu_torch.errors import QualityBelowThreshold

        self.images = inputs.make_images(self.seed, [self.shape] * self.n)
        jobs = [(i, q) for i in range(self.n) for q in self.qualities]
        self.cands = inputs.make_candidates(self.images, jobs, self.subsampling)
        self._miss = QualityBelowThreshold
        self._gate = helpers.assert_quality
        self._scorer_cls = scoring.BatchScorer
        self._score_pair = scoring.BatchScorer.score_pair
        spans.record_results(scoring.BatchScorer, "score_pair", self.results)

    def warmup(self) -> None:
        for i in range(int(self.cell.traffic.get("warmup_calls", 1))):
            self.call(i)

    def call(self, i: int):
        idx, q = self.draws[i % DRAWS]
        passed = True
        try:
            self._gate(self.images[idx], self.cands[(idx, q)][1],
                       min_ssimulacra2=self.thresholds["min_ssimulacra2"],
                       max_dssim=self.thresholds["max_dssim"], device=self.device)
        except self._miss:
            passed = False
        got = self.results.pop()
        return 1, (idx, q, passed, {m: getattr(got, m) for m in METRICS}), {}

    def release(self) -> None:
        import torch

        self._scorer_cls.score_pair = self._score_pair
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def _passes(self, scores: dict) -> bool:
        t = self.thresholds
        return scores["ssimulacra2"] >= t["min_ssimulacra2"] and scores["dssim"] <= t["max_dssim"]

    def _tie(self, scores: dict) -> bool:
        """Whether a reference score lies within its limit of its threshold,
        where rounding may decide the verdict."""
        t, lim = self.thresholds, self.cell.workload["limits"]
        return (compare.gap("ssimulacra2", scores["ssimulacra2"], t["min_ssimulacra2"])
                <= lim["ssimulacra2"]
                or compare.gap("dssim", scores["dssim"], t["max_dssim"]) <= lim["dssim"])

    def check(self, calls, control: bool = False):
        """Each call's two scores against the reference's, and its verdict
        against the verdict the reference's scores give (a verdict within
        rounding of a threshold is not counted)."""
        chunk = int(self.cell.workload["reference_chunk"])
        used: dict = {}
        for c in calls:
            used.setdefault(c.answer[0], set()).add(c.answer[1])
        ref, low = self._ref, self._low
        for idx, qs in used.items():
            for table, lowp in ((ref, False),) + (((low, True),) if control else ()):
                todo = sorted(q for q in qs if (idx, q) not in table)
                if not todo:
                    continue
                cands = np.stack([self.cands[(idx, q)][1] for q in todo])
                got = score_ladder(self.images[idx], cands, METRICS, self.device, lowp, chunk)
                for j, q in enumerate(todo):
                    table[(idx, q)] = {m: float(got[m][j]) for m in METRICS}
        triples, flips = [], 0
        for c in calls:
            idx, q, passed, got = c.answer
            want = ref[(idx, q)]
            if control:
                got = low[(idx, q)]
                passed = self._passes(got)
            triples.extend((m, got[m], want[m]) for m in METRICS)
            if passed != self._passes(want) and not self._tie(want):
                flips += 1
        out = compare.checks(compare.widest(triples), self.cell.workload["limits"])
        return out + [Check("gate_verdicts_wrong", float(flips),
                            float(self.cell.workload["limits"]["gate_verdicts_wrong"]))]
