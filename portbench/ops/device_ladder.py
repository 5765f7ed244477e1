"""rd-calibrate's device sweep: ``cli.rd_calibrate.sweep_images_device``
over the configuration's decoded images, one calibration sweep per call in
a closed loop.

Each call sweeps every image of the configuration, in an order drawn from
the seed, through tpujpeg's trellis (the configuration's ``encoder``) at
every quality of the ladder, with sizes from the device's rate statistics:
the device transform, the trellis DP, the reconstruction, the rate
histograms and the ladder's scores, then the host's Huffman half per
chunk.  The images are made at set-up; no file is read in the window.

The check holds each layer of every call's answer to the plain reference
(``reference/jpeg_ladder.py``; scores by ``reference/score.py``), once per
image after the window, on what the program itself gives for that image
(its encoder, ``kernels.jpeg_enc.reconstruct_sweep``, called as the
ladder runner calls it):

- ``coef_differ_share``, ``sample_differ_share``: the shares of the
  quantized coefficients and of the decoded candidates' u8 samples that
  the program's encoder gives otherwise than the reference's;
- ``ssimulacra2_gap``, ``butteraugli_gap``: each score's relative gap to
  the reference's score of the program's own candidate (``compare.py``);
- ``size_estimate_gap``: each size's relative gap to the reference's
  estimate from its symbol count of the program's own coefficients
  (headers + scan bytes + round(scan bytes / 368) + EOI), which the device
  sizes give exactly.  (How far that estimate lies from the exact stuffed
  bytes is the estimate's documented error, which no fault of the program
  moves; the tests hold it to the reference's exact count.)

``control=True`` puts the reference one precision step below in the
program's place: its encoder with the colour and DCT products in TF32, its
scores in ``score.py``'s control precisions, its sizes its own estimates
(integer counts, which have no lower precision)."""

from __future__ import annotations

import numpy as np

from .. import compare, inputs
from ..harness import Check
from ..reference import jpeg_ladder
from ..reference.score import score_ladder

METRICS = ("ssimulacra2", "butteraugli")


class Op:
    def __init__(self, cell, seed: int, device: str):
        cfg = cell.config
        self.cell, self.seed, self.device = cell, seed, device
        self.n = int(cfg["images"])
        self.shape = (int(cfg["height"]), int(cfg["width"]))
        self.qualities = inputs.ladder(cfg["qualities"])
        self.subsampling = cfg["subsampling"].replace(":", "")
        enc = cfg["encoder"]
        self.lmbda = float(enc["trellis_lambda"])
        self.size_mode = enc["size_mode"]
        rng = np.random.default_rng(seed)
        self.orders = [rng.permutation(self.n) for _ in range(int(cell.traffic["schedule_calls"]))]
        self._ref: dict = {}

    def setup(self) -> None:
        # A program without the entry fails here, before any input is made.
        from codec_eval_tpu_torch.cli.rd_calibrate import sweep_images_device

        self._sweep = sweep_images_device
        self.images = inputs.make_images(self.seed, [self.shape] * self.n)

    def warmup(self) -> None:
        for i in range(int(self.cell.traffic.get("warmup_calls", 1))):
            self.call(i)

    def call(self, i: int):
        order = self.orders[i % len(self.orders)]
        groups = self._sweep([self.images[k] for k in order], self.qualities, self.subsampling,
                             trellis=True, size_mode=self.size_mode, device=self.device)
        answer = {}
        for idx, res in groups:
            for row, j in enumerate(idx):
                answer[int(order[j])] = (res.scores["ssimulacra2"][row],
                                         res.scores["butteraugli"][row], res.sizes[row])
        return self.n * len(self.qualities), answer, {}

    def release(self) -> None:
        import torch

        if self.device == "cuda":
            torch.cuda.empty_cache()

    def _program_ladder(self, k: int) -> dict:
        import torch
        from codec_eval_tpu_torch.kernels.jpeg_enc import reconstruct_sweep

        qtabs = np.stack([np.stack(jpeg_ladder.qtables(q)) for q in self.qualities])
        img = torch.from_numpy(self.images[k]).to(self.device)
        cands, coefs = reconstruct_sweep(img, torch.from_numpy(qtabs.astype(np.float32)).to(
            img.device), 0.0, self.subsampling, trellis_lambda=self.lmbda)
        out = {p: c.cpu().numpy() for p, c in coefs.items()}
        out["candidates"] = np.ascontiguousarray(np.moveaxis(cands.cpu().numpy(), 1, -1))
        return out

    def _truth(self, k: int, control: bool) -> dict:
        """Image k: the encoder side's differences from the reference's
        encoder, and the reference's scores and sizes of that side's own
        candidates and coefficients (and, with ``control``, the control's
        own scores)."""
        chunk = int(self.cell.workload["reference_chunk"])
        want = jpeg_ladder.encode_ladder(self.images[k], self.qualities, self.lmbda, self.device)
        side = (jpeg_ladder.encode_ladder(self.images[k], self.qualities, self.lmbda,
                                          self.device, use_tf32=True)
                if control else self._program_ladder(k))
        coefs = {p: side[p] for p in ("y", "cb", "cr")}
        out = {
            "coefs": (sum(int(np.count_nonzero(coefs[p] != want[p])) for p in coefs),
                      sum(want[p].size for p in coefs)),
            "samples": (int(np.count_nonzero(side["candidates"] != want["candidates"])),
                        want["candidates"].size),
            **score_ladder(self.images[k], side["candidates"], METRICS, self.device, False, chunk),
            **{key: np.array(v) for key, v in jpeg_ladder.count_ladder(coefs, self.device).items()},
        }
        if control:
            out["low"] = score_ladder(self.images[k], side["candidates"], METRICS, self.device,
                                      True, chunk)
        return out

    def check(self, calls, control: bool = False):
        """Every call's scores and sizes, and the encoder's coefficients and
        candidates, against the reference's of each image."""
        limits = self.cell.workload["limits"]
        used = sorted({k for c in calls for k in c.answer})
        truth = {}
        for k in used:
            if control:
                truth[k] = self._truth(k, True)
            else:
                if k not in self._ref:
                    self._ref[k] = self._truth(k, False)
                truth[k] = self._ref[k]
        triples, est_gap = [], 0.0
        for c in calls:
            for k, (s2, ba, sizes) in c.answer.items():
                t = truth[k]
                if control:
                    s2, ba, sizes = t["low"]["ssimulacra2"], t["low"]["butteraugli"], t["estimate"]
                for j in range(len(self.qualities)):
                    triples.append(("ssimulacra2", float(s2[j]), float(t["ssimulacra2"][j])))
                    triples.append(("butteraugli", float(ba[j]), float(t["butteraugli"][j])))
                sizes = np.asarray(sizes, dtype=np.float64)
                est_gap = max(est_gap, float(np.max(np.abs(sizes - t["estimate"]) / t["estimate"])))

        def share(key):
            differ, total = (sum(truth[k][key][i] for k in used) for i in (0, 1))
            return differ / total if total else float("inf")

        return ([Check("coef_differ_share", share("coefs"), float(limits["coef_differ_share"])),
                 Check("sample_differ_share", share("samples"),
                       float(limits["sample_differ_share"]))]
                + compare.checks(compare.widest(triples), limits)
                + [Check("size_estimate_gap", est_gap, float(limits["size_estimate"]))])
