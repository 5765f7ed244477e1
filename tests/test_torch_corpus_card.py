"""The streamed corpus runner on the card (``parallel/corpus_runner.py``).

One masked ``score_pairs_sharded`` call over the five shapes of the
masked-corpus workload (1:1, 4:3, 3:4, 3:2 and 2:3 at a 2048 px long side,
four candidates each, five 128 px buckets) runs under
``torch.cuda.set_sync_debug_mode("error")`` until its one fetch: nothing
between the call's first chunk and the fetch waits for the device (a
pageable copy, ``.cpu()`` or ``.item()`` raises there).  Its scores equal
``score_mixed_sizes_all``'s bit for bit, and a second call on the same
pairs gives the same scores.

Marked ``chip``: each test needs a CUDA device and skips without one; this
file imports no JAX, so on a machine with a card they run with
``python -m pytest tests/test_torch_corpus_card.py -m chip --noconftest``.
"""

import numpy as np
import pytest
import torch

from codec_eval_tpu_torch import parallel
from codec_eval_tpu_torch.kernels.masked import METRICS, score_mixed_sizes_all
from codec_eval_tpu_torch.parallel import corpus_runner

SHAPES = [(2048, 2048), (1536, 2048), (2048, 1536), (1365, 2048), (2048, 1365)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pairs(seed=0):
    """Four candidates of each shape: a smooth reference plus noise, each
    candidate with its own noise amplitude."""
    rng = np.random.default_rng(seed)
    pairs = []
    for h, w in SHAPES:
        ramp = np.linspace(20, 220, w)[None, :, None] + np.linspace(0, 30, h)[:, None, None]
        ref = np.clip(ramp + rng.integers(0, 24, (h, w, 3)), 0, 255).astype(np.uint8)
        for amount in (2, 5, 11, 23):
            noise = rng.integers(-amount, amount + 1, ref.shape)
            pairs.append((ref, np.clip(ref + noise, 0, 255).astype(np.uint8)))
    return pairs


@pytest.mark.chip
def test_a_masked_call_waits_for_the_card_only_at_its_fetch(card, monkeypatch):
    pairs = _pairs()
    want = score_mixed_sizes_all(pairs, granularity=128)
    # A first call builds the kernels, the blur operators and the host slots.
    first = parallel.score_pairs_sharded(pairs, masked=True)

    real, fetches = corpus_runner._fetch, []

    def fetch(issued, keys):
        torch.cuda.set_sync_debug_mode(0)
        fetches.append(len(issued))
        return real(issued, keys)

    monkeypatch.setattr(corpus_runner, "_fetch", fetch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.zeros(1, device=card).cpu()
        got = parallel.score_pairs_sharded(pairs, masked=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fetches == [5]
    for metric in METRICS:
        assert [p[metric] for p in got.per_pair] == want[metric].astype(np.float64).tolist()
    assert got.per_pair == first.per_pair
