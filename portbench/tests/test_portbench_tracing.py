"""The readers of the program's own spans and counters: each on a
hand-built run, None where the run has no trace or the program records no
such span or counter, and each in a traced run of its cells at a tiny size
on the CPU."""

import pytest

from portbench.harness import Run, load_reader
from portbench.trace import Trace
from portbench_tiny import tiny_run

from codec_eval_tpu_torch.utils import profiling

HOST = [
    ("portbench.call", 0.0, 900.0),
    ("ce.session.batch", 10.0, 40.0),
    ("ce.scorer.stage", 50.0, 70.0),
    ("ce.runner.fetch", 100.0, 160.0),
    ("ce.session.batch", 200.0, 250.0),
    ("ce.scorer.stage", 300.0, 330.0),
    ("ce.runner.fetch", 400.0, 420.0),
    ("ce.runner.bucket", 500.0, 700.0),
    ("cudaStreamSynchronize", 520.0, 560.0),  # the host waits inside a bucket
    ("cudaLaunchKernel", 600.0, 610.0),
    ("cudaStreamSynchronize", 800.0, 810.0),  # outside any bucket
    ("ce.scorer.stage", 2000.0, 2100.0),  # outside the traced window
]


def _run(trace=True, host=HOST, calls=2, pairs=10) -> Run:
    t = Trace(window=(0.0, 1000.0), device=[], host=list(host), calls=calls, pairs=pairs)
    return Run(cell=None, seed=0, setup_s=0.0, window=(0.0, 1.0), calls=[], peak_bytes=0,
               trace=t if trace else None)


@pytest.fixture
def program_counters(monkeypatch):
    """Set the program's counters as a traced run would leave them."""
    def set_to(values):
        monkeypatch.setattr(profiling, "counters", lambda: dict(values))
    return set_to


@pytest.mark.parametrize("metric, want", [
    ("scorer.stage_ms_per_pair", (0.020 + 0.030) / 10),
    ("session.batch_ms_per_image", (0.030 + 0.050) / 2),
    ("runner.fetch_ms_per_pair", (0.060 + 0.020 + 0.040) / 10),
])
def test_span_readers(metric, want):
    read = load_reader(metric)
    assert read(_run()) == pytest.approx(want)
    assert read(_run(trace=False)) is None
    assert read(_run(host=[ev for ev in HOST if not ev[0].startswith("ce.")])) is None
    assert read(_run(calls=0, pairs=0)) is None


def test_runner_fetch_waits_are_the_fetches_and_the_syncs_inside_buckets():
    read = load_reader("runner.fetch_ms_per_pair")
    no_bucket = [ev for ev in HOST if ev[0] != "ce.runner.bucket"]
    assert read(_run(host=no_bucket)) == pytest.approx((0.060 + 0.020) / 10)
    no_fetch = [ev for ev in HOST if ev[0] != "ce.runner.fetch"]
    assert read(_run(host=no_fetch)) is None  # not the corpus runner's trace


def test_staging_host_mib_per_pair(program_counters, monkeypatch):
    read = load_reader("staging.host_mib_per_pair")
    program_counters({"staging.host_bytes": 10 * 3 * 2**20})
    assert read(_run()) == pytest.approx(3.0)
    assert read(_run(trace=False)) is None
    program_counters({"staging.host_bytes": 0})
    assert read(_run()) == 0.0
    program_counters({})
    assert read(_run()) is None
    monkeypatch.delattr(profiling, "counters")  # a program without counters
    assert read(_run()) is None


def test_gate_precomputes_per_pair(program_counters, monkeypatch):
    read = load_reader("gate.precomputes_per_pair")
    program_counters({"scorer.precompute_miss": 2})
    assert read(_run()) == 1.0
    program_counters({"scorer.precompute_hit": 2})
    assert read(_run()) == 0.0
    program_counters({"scorer.precompute_miss": 1, "scorer.precompute_hit": 1})
    assert read(_run()) == 0.5
    assert read(_run(trace=False)) is None
    program_counters({})
    assert read(_run()) is None
    monkeypatch.delattr(profiling, "counters")
    assert read(_run()) is None


@pytest.mark.parametrize("cell, want", [
    ("cid22-512.session", {"staging.host_mib_per_pair": 2 * 64 * 64 * 3 / 2**20,
                           "scorer.stage_ms_per_pair": None, "session.batch_ms_per_image": None}),
    ("cid22-512.ci-gate", {"gate.precomputes_per_pair": 1.0}),
    ("clic2025-2048.masked-corpus", {"runner.fetch_ms_per_pair": None}),
])
def test_traced_tiny_run_reads_the_program(cell, want):
    """A traced run on the CPU reports each new metric of its cell (a
    count exactly; a time, which the CPU cannot give for the card, only as
    present and positive)."""
    profiling.reset_counters()
    out = tiny_run(cell, trace=True)
    assert out["correct"]
    for name, value in want.items():
        got = out["metrics"][name]["value"]
        assert got > 0 if value is None else got == pytest.approx(value), name
