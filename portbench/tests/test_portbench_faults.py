"""The check that decides ``correct`` fails when it should: the control
(the reference one precision step below, in the program's place) and the
faults a cell can have, planted in the program underneath a whole run at a
size the CPU holds.  The look for a card is skipped; everything else runs."""

import math

import numpy as np
import pytest
import torch

from portbench_tiny import CELLS, tiny_run

BATCH_CELLS = ("cid22-512.session", "clic2025-2048.session")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert tiny_run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = tiny_run(cell)
    control = out["op"].check(out["answered"], control=True)
    assert not all(c.ok for c in control), [(c.name, c.value, c.limit) for c in control]


def _stale(monkeypatch, cell):
    """A step that returns its state unchanged: the first result served again."""
    if cell == "clic2025-2048.masked-corpus":
        from codec_eval_tpu_torch.parallel import corpus_runner

        first = []
        real = corpus_runner.score_staged

        def stale(staged):
            if not first:
                first.append(real(staged))
            return first[0]

        monkeypatch.setattr(corpus_runner, "score_staged", stale)
    else:
        from codec_eval_tpu_torch.engine import scoring

        first = []
        real = scoring.build_precompute

        def stale(ref_u8, config):
            if not first:
                first.append(real(ref_u8, config))
            return first[0]

        monkeypatch.setattr(scoring, "build_precompute", stale)


def _half_batch(monkeypatch, cell):
    """Half of the batch left out, the mean taken over the rest."""
    def halve(scores):
        out = {}
        for k, v in scores.items():
            n = v.shape[0]
            keep = max(1, n // 2)
            fill = v[:keep].to(torch.float64).mean().to(v.dtype)
            out[k] = torch.cat([v[:keep], fill.expand(n - keep)])
        return out

    if cell == "clic2025-2048.masked-corpus":
        from codec_eval_tpu_torch.parallel import corpus_runner

        real = corpus_runner.sharded_masked_score_fn

        def factory(mesh):
            step = real(mesh)

            def half_step(refs, dists, hw):
                scores, extra = step(refs, dists, hw)
                return halve(scores), extra

            return half_step

        monkeypatch.setattr(corpus_runner, "sharded_masked_score_fn", factory)
    else:
        from codec_eval_tpu_torch.engine import scoring

        real = scoring.score_chunk
        monkeypatch.setattr(scoring, "score_chunk", lambda pre, b, c: halve(real(pre, b, c)))


def _altered(monkeypatch, cell):
    """One answer altered where it is produced: a score 0.1% off."""
    def alter(scores):
        k = "ssimulacra2"
        v = scores[k].clone()
        v[-1] = v[-1] * 1.001
        return {**scores, k: v}

    if cell == "clic2025-2048.masked-corpus":
        from codec_eval_tpu_torch.parallel import corpus_runner

        real = corpus_runner.sharded_masked_score_fn

        def factory(mesh):
            step = real(mesh)
            return lambda refs, dists, hw: (lambda r: (alter(r[0]), r[1]))(step(refs, dists, hw))

        monkeypatch.setattr(corpus_runner, "sharded_masked_score_fn", factory)
    else:
        from codec_eval_tpu_torch.engine import scoring

        real = scoring.score_chunk
        monkeypatch.setattr(scoring, "score_chunk", lambda pre, b, c: alter(real(pre, b, c)))


FAULTS = {"stale state": _stale, "half the batch": _half_batch, "altered answer": _altered}
# One chip: no cell exchanges anything between chips.  The gate scores one
# candidate per call, so it has no half of a batch to leave out.
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (c == "cid22-512.ci-gate" and f == "half the batch")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    out = tiny_run(cell, seconds=0.5)
    assert not out["correct"], [(c.name, c.value, c.limit) for c in out["checks"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    """A short run of the cell at its own size on the card is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    from portbench.harness import load_cell, run_cell

    out = run_cell(load_cell(cell), 2**31 + 99, 2.0, False, time.perf_counter())
    assert out["correct"], [(c.name, c.value, c.limit) for c in out["checks"]]
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert np.isfinite(out["run"].peak_bytes)
