"""The batch scorer's candidate staging (``engine/scoring.py``): decoded
(H, W, 3) u8 candidates, as one (N, H, W, 3) array or as a list of arrays,
are copied into one reused host buffer, sent to the device in one copy and
made planar there.

- The planar batch is the host transpose of the stacked candidates, byte
  for byte, for both forms, N = 1 and N = 45, and odd shapes.
- Scores of the list form equal those of the stacked array exactly.
- A second batch reuses the buffer; a larger one reallocates it; a smaller
  one reuses its prefix; the counters say which.
- A candidate of another shape raises ``ValueError``.

The tests marked ``chip`` need a CUDA device and skip without one; this
file imports no JAX, so on a machine with a card they run with
``python -m pytest tests/test_torch_staging.py -m chip --noconftest``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import codec_eval_tpu_torch as ce
from codec_eval_tpu_torch.engine import scoring
from codec_eval_tpu_torch.engine.scoring import BatchScorer, score_ladder
from codec_eval_tpu_torch.utils import profiling

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _noisy(img, amount, seed):
    noise = np.random.default_rng(seed).integers(-amount, amount + 1, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _forms(stack, form):
    """``stack`` as the scorer's caller gives it: the array, a list of its
    rows, or a list of strided views of equal content."""
    if form == "array":
        return stack
    if form == "list":
        return [c.copy() for c in stack]
    return [np.asfortranarray(c) for c in stack]


def _counted(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.counters()


@pytest.mark.parametrize("form", ["array", "list", "strided"])
@pytest.mark.parametrize("n,h,w", [(1, 24, 32), (45, 24, 32), (1, 37, 53), (45, 37, 53)])
def test_planar_batch_is_the_host_transpose(form, n, h, w):
    stack = _images(n, h, w, seed=n + h)
    planar = scoring._Staging(CPU).stage(_forms(stack, form), (h, w, 3))
    want = np.ascontiguousarray(np.moveaxis(stack, -1, 1))
    assert planar.dtype == torch.uint8 and planar.is_contiguous()
    assert planar.numpy().tobytes() == want.tobytes() and planar.shape == want.shape


@pytest.mark.parametrize("entry", ["score_batch", "score_ladder"])
def test_list_scores_equal_the_stacked_array_scores(entry):
    ref = _images(1, 24, 32, seed=3)[0]
    stack = np.stack([_noisy(ref, a, seed=a) for a in (2, 9, 40)] + [ref])
    if entry == "score_batch":
        def scores(cands):
            return BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(ref, cands)
    else:
        def scores(cands):
            return {k: v.tolist() for k, v in
                    score_ladder(ref, cands, ce.MetricConfig.all(), device="cpu").items()}
    assert scores(list(stack)) == scores(stack)


def test_a_second_batch_of_one_shape_reuses_the_buffer():
    staging = scoring._Staging(CPU)
    stack = _images(5, 16, 24)
    _, first = _counted(lambda: staging.stage(stack, (16, 24, 3)))
    assert first == {"staging.buffer_alloc": 1, "staging.host_bytes": stack.nbytes}
    profiling.reset_counters()
    buf = staging._buf
    planar, second = _counted(lambda: staging.stage(list(stack[::-1]), (16, 24, 3)))
    assert second == {"staging.buffer_reuse": 1, "staging.host_bytes": 0}
    assert staging._buf is buf
    assert torch.equal(planar, torch.from_numpy(stack[::-1].copy()).permute(0, 3, 1, 2))


def test_a_larger_batch_reallocates_and_a_smaller_one_reuses_a_prefix():
    staging = scoring._Staging(CPU)
    frame = (16, 24, 3)
    small, large = _images(3, *frame[:2], seed=1), _images(7, *frame[:2], seed=2)

    def three_batches():
        out = [staging.stage(small, frame)]
        first = staging._buf
        out.append(staging.stage(large, frame))
        grown = staging._buf
        out.append(staging.stage(list(small), frame))
        return out, first, grown

    (planars, first, grown), got = _counted(three_batches)
    assert first.numel() == small.nbytes and grown.numel() == large.nbytes
    assert staging._buf is grown
    assert got == {"staging.buffer_alloc": 2, "staging.buffer_reuse": 1,
                   "staging.host_bytes": small.nbytes + large.nbytes}
    for planar, stack in zip(planars, (small, large, small)):
        assert torch.equal(planar, torch.from_numpy(stack).permute(0, 3, 1, 2))


@pytest.mark.parametrize("bad", [(23, 32, 3), (24, 31, 3), (24, 32, 4), (24, 32)])
@pytest.mark.parametrize("entry", ["score_batch", "score_pair", "score_ladder"])
def test_a_candidate_of_another_shape_raises(bad, entry):
    ref = _images(1, 24, 32)[0]
    odd = np.zeros(bad, np.uint8)
    cands = [ref, odd, ref]
    with pytest.raises(ValueError, match="do not match reference"):
        if entry == "score_batch":
            BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(ref, cands)
        elif entry == "score_pair":
            BatchScorer(ce.MetricConfig.all(), device="cpu").score_pair(ref, odd)
        else:
            score_ladder(ref, cands, ce.MetricConfig.all(), device="cpu")


def test_the_array_form_keeps_its_message():
    ref = _images(1, 24, 32)[0]
    with pytest.raises(ValueError, match=r"candidates \(2, 24, 31, 3\) do not match "
                                         r"reference \(24, 32, 3\)"):
        BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(
            ref, np.zeros((2, 24, 31, 3), np.uint8))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.chip
def test_back_to_back_batches_on_the_card_keep_their_own_content(card):
    """Two stagings with no synchronisation between them: the second waits
    for the first's copy out of the buffer before it writes, so each planar
    batch holds its own candidates; then two ``score_batch`` calls on other
    content through one scorer give each call's own scores."""
    side, n = 512, 45
    a, b = _images(n, side, side, seed=5), _images(n, side, side, seed=6)
    staging = scoring._Staging(card)
    for _ in range(3):
        pa = staging.stage(list(a), (side, side, 3))
        pb = staging.stage(b, (side, side, 3))
        assert torch.equal(pa.cpu(), torch.from_numpy(a).permute(0, 3, 1, 2))
        assert torch.equal(pb.cpu(), torch.from_numpy(b).permute(0, 3, 1, 2))

    ref = a[0]
    first, second = [_noisy(ref, 3, seed=k) for k in range(n)], list(b)
    scorer = BatchScorer(ce.MetricConfig.all(), device=card)
    got = [scorer.score_batch(ref, first), scorer.score_batch(ref, second)]
    want = [BatchScorer(ce.MetricConfig.all(), device=card).score_batch(ref, np.stack(c))
            for c in (first, second)]
    assert got == want


@pytest.mark.chip
def test_staging_on_the_card_adds_nothing_to_the_peak(card):
    """``max_memory_allocated`` over a 512 px x 45 ``score_batch`` is no
    higher than with the candidates made planar on the host and copied
    planar: the NHWC device tensor is freed before the metrics run."""
    side, n = 512, 45
    ref = _images(1, side, side, seed=7)[0]
    cands = [_noisy(ref, 1 + k, seed=k) for k in range(n)]
    scorer = BatchScorer(ce.MetricConfig.all(), device=card)
    scorer.score_batch(ref, cands)

    def peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results = scorer.score_batch(ref, cands)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), results

    on_card, results = peak()
    staging = scorer._staging
    try:
        scorer._staging = _HostPlanar(card)
        on_host, host_results = peak()
    finally:
        scorer._staging = staging
    assert results == host_results
    assert on_card <= on_host, (on_card, on_host)


class _HostPlanar:
    """The staging this file holds the card's against: the candidates
    stacked and made planar on the host, then one pageable copy."""

    def __init__(self, device):
        self.device = device

    def stage(self, candidates_u8, frame):
        planar = np.ascontiguousarray(np.moveaxis(np.stack(candidates_u8), -1, 1))
        return torch.from_numpy(planar).to(self.device)
