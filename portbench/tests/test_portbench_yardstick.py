"""The frozen counts against the bounds PERF.md's kernel table gives, the
work table against the port's wrappers, and the trace reduction."""

import importlib

import pytest

from portbench.spans import load_work_table
from portbench.trace import Trace, merge
from portbench.yardstick.counts import COUNTS, call_bound_ms


def _k1(n, size):
    """K1 over six scales: sum of the per-scale calls' bounds."""
    total, h = 0.0, size
    for _ in range(6):
        total += call_bound_ms("scale_features",
                               [(3, h, h)] * 3 + [(n, 3, h, h) if n else (3, h, h)], [])
        h = (h + 1) // 2
    return total


# (what, bound ms, PERF.md's bound column at commit 80b80d3)
CASES = [
    ("K1 512 B=25", lambda: _k1(25, 512), 0.0821),
    ("K1 2048 B=10", lambda: _k1(10, 2048), 0.526),
    ("K2 512 B=25", lambda: call_bound_ms("opsin_xyb", [(25, 3, 512, 512)], []), 0.0473),
    ("K2 2048 B=10", lambda: call_bound_ms("opsin_xyb", [(10, 3, 2048, 2048)], []), 0.306),
    ("K3 512 B=25", lambda: call_bound_ms("bands", [(25, 3, 512, 512)] * 2, []), 0.102),
    ("K3 2048 B=10", lambda: call_bound_ms("bands", [(10, 3, 2048, 2048)] * 2, []), 0.661),
    ("K4 512 B=25", lambda: call_bound_ms("malta_ac", [(25, 6, 512, 512)], []), 0.0626),
    ("K4 1024 B=10", lambda: call_bound_ms("malta_ac", [(10, 6, 1024, 1024)], []), 0.100),
    ("K4 2048x1408 N=2", lambda: call_bound_ms("malta_ac", [(2, 6, 1408, 2048)], []), 0.0551),
    ("K5 2048 B=10", lambda: call_bound_ms(
        "malta_diffmap", [(10, 6, 2048, 2048), (6, 2048, 2048), (10, 4, 2048, 2048),
                          (4, 2048, 2048), (10, 2048, 2048), (2, 2048, 2048)], []), 0.661),
    ("K6 2048 B=10", lambda: call_bound_ms("blur", [(10, 1, 2048, 2048)], [2.7]), 0.105),
    ("K6 1024 B=10", lambda: call_bound_ms("blur", [(10, 1, 1024, 1024)], [2.7]), 0.0263),
    ("K7 512 B=1", lambda: call_bound_ms("mask_diff_ac", [(1, 512, 512), (512, 512)],
                                         [10.0, 2.7]), 0.00125),
    ("K7 2048 B=1", lambda: call_bound_ms("mask_diff_ac", [(1, 2048, 2048), (2048, 2048)],
                                          [10.0, 2.7]), 0.0200),
    ("K8 512 pair", lambda: _k1(0, 512), 0.00502),
    ("K8 2048 pair", lambda: _k1(0, 2048), 0.0801),
    ("K9 512 N=8", lambda: call_bound_ms("candidate_moments", [(8, 3, 512, 512)] * 2, []),
     0.0376),
    ("K9 2048 N=2", lambda: call_bound_ms("candidate_moments", [(2, 3, 2048, 2048)] * 2, []),
     0.150),
    ("K9 ref 512 N=8", lambda: call_bound_ms("reference_moments", [(8, 3, 512, 512)], []),
     0.0225),
    ("K9 ref 2048 N=2", lambda: call_bound_ms("reference_moments", [(2, 3, 2048, 2048)], []),
     0.0901),
]


@pytest.mark.parametrize("what,fn,want", CASES, ids=[c[0] for c in CASES])
def test_bounds_equal_the_kernel_table(what, fn, want):
    assert fn() == pytest.approx(want, rel=6e-3, abs=6e-6), what


def test_work_table_names_real_wrappers_and_counts():
    for work, spec in load_work_table().items():
        assert spec["kernels"] and spec["calls"], work
        for target, count in spec["calls"].items():
            mod, attr = target.split(":")
            assert callable(getattr(importlib.import_module(mod), attr)), target
            assert count in COUNTS, (work, count)


def test_trace_reduction():
    assert merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    t = Trace(window=(0.0, 100.0),
              device=[("k_a", 10.0, 30.0), ("Memcpy HtoD (Pageable -> Device)", 25.0, 40.0),
                      ("k_b", 60.0, 70.0)],
              host=[("outer", 0.0, 100.0), ("aten::copy_", 40.0, 60.0), ("stage", 70.0, 95.0)],
              calls=2, pairs=4)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert [n for n, _, _ in t.kernels()] == ["k_a", "k_b"]
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"outer": 10e-6, "aten::copy_": 20e-6, "stage": 30e-6})
    assert t.time_matching([r"\bk_a\b"]) == pytest.approx(20e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "k_a" and len(b["idle_gaps"]) == 3


@pytest.mark.parametrize("metric", ["device.idle_pct", "device.idle_pct.gate"])
def test_idle_share_is_taken_against_the_untraced_calls(metric):
    from types import SimpleNamespace

    from portbench.harness import load_reader

    # 2 traced calls, 40 us busy in all; the window: 4 calls in 100 us.
    t = Trace(window=(0.0, 1000.0), device=[("k_a", 10.0, 30.0), ("k_b", 60.0, 80.0)],
              host=[], calls=2, pairs=2)
    run = SimpleNamespace(trace=t, calls=[None] * 4, window_s=100e-6)
    assert load_reader(metric)(run) == pytest.approx(20.0)
    assert load_reader(metric)(SimpleNamespace(trace=None, calls=[], window_s=0.0)) is None
