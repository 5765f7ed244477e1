"""``EvalSession.evaluate_image``, one image after another in a closed loop.

The session has one registered codec whose callbacks replay the set-up's
JPEG streams and decoded pixels, so the codec's own time (the user's, not
the port's) is next to nothing: each call stages the image's whole ladder
of candidates and scores it in one batch with all four metrics.  The
images are the configuration's distinct images, cycled in an order drawn
from the seed.  The scorer's ``score_batch`` carries a timer, so a call's
host time outside the scorer can be read."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import compare, inputs, spans
from ..reference.score import METRICS, score_ladder


class Op:
    def __init__(self, cell, seed: int, device: str):
        cfg = cell.config
        self.cell, self.seed, self.device = cell, seed, device
        self.n = int(cfg["images"])
        self.shape = (int(cfg["height"]), int(cfg["width"]))
        self.qualities = inputs.ladder(cfg["qualities"])
        self.subsampling = cfg["subsampling"]
        self.order = np.random.default_rng(seed).permutation(self.n)
        self.scorer_s: list = []
        self._ref: dict = {}
        self._low: dict = {}

    def setup(self) -> None:
        import codec_eval_tpu_torch as ce

        self.images = inputs.make_images(self.seed, [self.shape] * self.n)
        jobs = [(i, q) for i in range(self.n) for q in self.qualities]
        self.cands = inputs.make_candidates(self.images, jobs, self.subsampling)
        self.image_data = [ce.ImageData.rgb8(img) for img in self.images]
        index = {id(d): i for i, d in enumerate(self.image_data)}
        decoded = {id(s): ce.ImageData.rgb8(px) for s, px in self.cands.values()}

        def encode(image, request):
            return self.cands[(index[id(image)], int(request.quality))][0]

        def decode(data):
            return decoded[id(data)]

        config = (ce.EvalConfig.builder().report_dir(Path(__file__).resolve().parent / "reports")
                  .metrics(ce.MetricConfig.all()).quality_levels(self.qualities).build())
        self.session = ce.EvalSession(config, device=self.device)
        self.session.add_codec_with_decode("libjpeg-replay", "1", encode, decode)
        spans.time_method(self.session._scorer, "score_batch", self.scorer_s)

    def warmup(self) -> None:
        for i in range(int(self.cell.traffic.get("warmup_calls", 1))):
            self.call(i)

    def call(self, i: int):
        idx = int(self.order[i % self.n])
        report = self.session.evaluate_image(f"image-{idx}", self.image_data[idx])
        answer = (idx, [(r.quality, {k: getattr(r.metrics, k) for k in METRICS})
                        for r in report.results])
        return len(report.results), answer, {"score_batch": self.scorer_s.pop()}

    def release(self) -> None:
        import torch

        del self.session, self.image_data
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self, calls, control: bool = False):
        """Every score of every call against the reference's score of that
        image and quality (the reference scores each distinct image's
        ladder once).  ``control`` puts the reference in a lower precision
        in the program's place."""
        chunk = int(self.cell.workload["reference_chunk"])
        ref, low = self._ref, self._low
        for idx in sorted({c.answer[0] for c in calls}):
            cands = np.stack([self.cands[(idx, q)][1] for q in self.qualities])
            if idx not in ref:
                ref[idx] = score_ladder(self.images[idx], cands, device=self.device, chunk=chunk)
            if control and idx not in low:
                low[idx] = score_ladder(self.images[idx], cands, device=self.device,
                                        chunk=chunk, control=True)
        qpos = {q: j for j, q in enumerate(self.qualities)}
        triples = []
        for c in calls:
            idx, results = c.answer
            for q, got in results:
                j = qpos[int(q)]
                for m in METRICS:
                    program = float(low[idx][m][j]) if control else got[m]
                    triples.append((m, program, float(ref[idx][m][j])))
        return compare.checks(compare.widest(triples), self.cell.workload["limits"])
