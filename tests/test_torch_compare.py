"""The kernel comparison tool (``codec_eval_tpu_torch/kernels/cuda/compare.py``)
on the CPU: it loads a checkout's port from its own files, its stand-ins
give the outputs of the wrappers they stand in for, and its cases name
wrappers that exist.  Its timings need the card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from codec_eval_tpu_torch.kernels.cuda import WRAPPERS
from codec_eval_tpu_torch.kernels.cuda import compare as tc

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def checkout():
    name = "checkout_under_test"
    yield tc.load_checkout(REPO, name)
    for key in [k for k in sys.modules if k == name or k.startswith(name + ".")]:
        del sys.modules[key]


def test_a_checkout_loads_from_its_own_files(checkout):
    assert checkout.__name__ == "checkout_under_test.kernels.cuda"
    assert set(checkout.WRAPPERS) == set(WRAPPERS)
    assert checkout._lib.CSRC == REPO / "codec_eval_tpu_torch" / "csrc"
    assert checkout.WRAPPERS["opsin_xyb"] is not WRAPPERS["opsin_xyb"]


def test_cases_name_wrappers_or_their_stand_ins():
    names = tc.cases(torch.device("cpu"))
    assert set(names) <= set(WRAPPERS)
    for name, (stand_in, _, _) in tc.STAND_INS.items():
        assert name in WRAPPERS and stand_in in WRAPPERS
    # Both K9 forms at every scale of the 512 and 2048 px buckets.
    labels = [label for label, _ in names["reference_moments"]]
    assert labels == [label for label, _ in names["candidate_moments"]]
    assert labels[0] == "512x512, N=8" and labels[-1] == "64x64, N=2" and len(labels) == 12


def test_reference_stand_in_gives_the_reference_form(checkout):
    stand_in, args_from, out_from = tc.STAND_INS["reference_moments"]
    x1 = torch.from_numpy(np.random.default_rng(5).random((2, 3, 21, 34), np.float32))
    calls = [(x1,), (x1[:1].contiguous(),)]
    want = tc._outputs(tc._call(WRAPPERS["reference_moments"], calls))
    got = tc._outputs(tc._call(checkout.WRAPPERS[stand_in], calls, args_from, out_from))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_without_a_card_it_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tc.main([str(REPO)]) == 1


def test_launches_per_call_reads_the_counters():
    class Wrapper:
        launches = 0

    class Package:
        WRAPPERS = {"a": Wrapper(), "b": Wrapper()}

    def call():
        Package.WRAPPERS["a"].launches += 2
        Package.WRAPPERS["b"].launches += 1

    assert tc.launches_per_call(call, Package) == 3
