"""The port's crate-root helpers against the JAX package, on the CPU.

``evaluate_single``, ``assert_quality`` and ``assert_perception_level``
(``codec_eval_tpu_torch/engine/helpers.py``) take ``device="cpu"`` here and
are held to the JAX package's at the port's score tiers: SSIMULACRA2 and
PSNR rtol=1e-5, DSSIM rtol=1e-5 with atol=1e-5 (``1/ssim - 1`` amplifies
the JAX package's f32 rounding; the port's DSSIM is f64, as
``tests/test_torch_dssim.py`` says), Butteraugli rtol=5e-4, with and
without viewing simulation (where the scores' tolerance also covers the
resize's one code value).  The DSSIM perception-level pins of
``tests/test_perception_levels.py`` are reproduced by the port, the
``viewing`` field of ``EvalConfig`` is stored as in JAX, and the root
``xyb_roundtrip`` gives JAX's bytes in both forms.
"""

import io

import numpy as np
import pytest
from PIL import Image

import codec_eval_tpu as jce
import codec_eval_tpu_torch as ce
from codec_eval_tpu.iter.source import photo_sources

TOL = {
    "ssimulacra2": dict(rel=1e-5, abs=0.0),
    "dssim": dict(rel=1e-5, abs=1e-5),
    "psnr": dict(rel=1e-5, abs=0.0),
    "butteraugli": dict(rel=5e-4, abs=0.0),
}
SIDE = 64


def _pair(side=SIDE, seed=5):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:side, 0:side]
    ref = np.stack([x * 255 // side, y * 255 // side, (x + y) * 127 // side], -1)
    ref = np.clip(ref + rng.integers(0, 40, (side, side, 3)), 0, 255).astype(np.uint8)
    cand = np.clip(ref.astype(int) + rng.integers(-12, 13, ref.shape), 0, 255).astype(np.uint8)
    return ref, cand


def _assert_close(got, want):
    for metric, tol in TOL.items():
        g, w = getattr(got, metric), getattr(want, metric)
        assert g == pytest.approx(w, **tol), (metric, g, w)


def test_evaluate_single_matches_jax():
    ref, cand = _pair()
    got = ce.evaluate_single(ref, cand, ce.MetricConfig.all(), device="cpu")
    want = jce.evaluate_single(ref, cand, jce.MetricConfig.all())
    _assert_close(got, want)
    same = ce.evaluate_single(ref, ref.copy(), ce.MetricConfig.all(), device="cpu")
    assert (same.ssimulacra2, same.dssim, same.butteraugli, same.psnr) == (
        100.0, 0.0, 0.0, float("inf"))
    only = ce.evaluate_single(ce.ImageData.rgb8(ref), cand, ce.MetricConfig(psnr=True),
                              device="cpu")
    assert only.psnr == got.psnr and only.dssim is None and only.ssimulacra2 is None


def test_evaluate_single_with_viewing_simulation_matches_jax():
    """A 48 px pair through the 2x-srcset-on-a-1.5x-laptop preset: both
    images resized to 64 px in linear light, then scored."""
    ref, cand = _pair(48, seed=9)
    cond = "srcset_2x_on_laptop_1_5x"
    p = getattr(ce.presets, cond)().simulation_params(48, 48, ce.SimulationMode.ACCURATE)
    jp = getattr(jce.presets, cond)().simulation_params(48, 48, jce.SimulationMode.ACCURATE)
    assert (p.target_height, p.target_width, p.requires_scaling()) == (SIDE, SIDE, True)
    got = ce.evaluate_single(ref, cand, ce.MetricConfig.all(), viewing_simulation=p,
                             device="cpu")
    want = jce.evaluate_single(ref, cand, jce.MetricConfig.all(), viewing_simulation=jp)
    _assert_close(got, want)
    # The helper adds nothing but the resize: the same scores as scoring the
    # resized pair directly.
    resized = [ce.viewing.simulate_viewing(i, p, device="cpu") for i in (ref, cand)]
    direct = ce.BatchScorer(ce.MetricConfig.all(), device="cpu").score_pair(*resized)
    assert got == direct


def test_score_pair_is_score_batch_of_one():
    ref, cand = _pair(32, seed=3)
    scorer = ce.BatchScorer(ce.MetricConfig.all(), device="cpu")
    assert scorer.score_pair(ref, cand) == scorer.score_batch(ref, cand[None])[0]


def test_dimension_mismatch_as_jax():
    ref, _ = _pair(32)
    wide = np.zeros((32, 40, 3), np.uint8)
    with pytest.raises(ce.DimensionMismatch) as got:
        ce.evaluate_single(ref, wide, ce.MetricConfig.all(), device="cpu")
    with pytest.raises(jce.DimensionMismatch) as want:
        jce.evaluate_single(ref, wide, jce.MetricConfig.all())
    assert (got.value.expected, got.value.actual) == ((32, 32), (40, 32))
    assert (got.value.expected, got.value.actual) == (want.value.expected, want.value.actual)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="expected"):
        ce.evaluate_single(np.zeros((4, 4)), np.zeros((4, 4)), ce.MetricConfig.all(),
                           device="cpu")


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return e
    return None


@pytest.mark.parametrize("gate", [
    dict(min_ssimulacra2=99.0), dict(min_ssimulacra2=50.0), dict(max_dssim=1e-4),
    dict(max_dssim=0.5), dict(min_ssimulacra2=99.0, max_dssim=1e-4),
])
def test_assert_quality_raises_as_jax(gate):
    ref, cand = _pair()
    got = _raised(ce.assert_quality, ref, cand, device="cpu", **gate)
    want = _raised(jce.assert_quality, ref, cand, **gate)
    assert (got is None) == (want is None)
    if want is None:
        return
    assert isinstance(got, ce.QualityBelowThreshold)
    assert (got.metric, got.threshold) == (want.metric, want.threshold)
    assert got.value == pytest.approx(want.value, **TOL[got.metric.lower()])
    # The message is JAX's, with the port's value.
    assert str(got) == str(jce.QualityBelowThreshold(want.metric, got.value, want.threshold))


@pytest.mark.parametrize("level", ["IMPERCEPTIBLE", "MARGINAL", "SUBTLE", "NOTICEABLE",
                                   "DEGRADED"])
def test_assert_perception_level_raises_as_jax(level):
    ref, cand = _pair()
    got = _raised(ce.assert_perception_level, ref, cand, getattr(ce.PerceptionLevel, level),
                  device="cpu")
    want = _raised(jce.assert_perception_level, ref, cand, getattr(jce.PerceptionLevel, level))
    assert (got is None) == (want is None)
    assert _raised(ce.assert_perception_level, ref, ref, ce.PerceptionLevel.IMPERCEPTIBLE,
                   device="cpu") is None
    if want is None:
        return
    assert isinstance(got, ce.QualityBelowThreshold)
    assert (got.value, got.threshold) == (want.value, want.threshold)
    dssim = ce.evaluate_single(ref, cand, ce.MetricConfig(dssim=True), device="cpu").dssim
    assert got.metric == f"PerceptionLevel (DSSIM {dssim:.6f})"
    assert str(got) == str(jce.QualityBelowThreshold(got.metric, want.value, want.threshold))


def test_helpers_default_to_the_card(monkeypatch):
    import torch

    ref, cand = _pair(16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ce.evaluate_single(ref, cand, ce.MetricConfig.all()),
                 lambda: ce.assert_quality(ref, cand, min_ssimulacra2=10.0),
                 lambda: ce.assert_perception_level(ref, cand, ce.PerceptionLevel.DEGRADED),
                 lambda: ce.xyb_roundtrip(ref)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# The DSSIM pins of tests/test_perception_levels.py, reproduced by the port.
QUALITIES = (55, 75, 88, 92, 95, 97, 98)
PINS = {
    0: (0.01345, 0.00732, 0.00304, 0.00195, 0.00129, 0.00087, 0.00069),
    1: (0.01834, 0.00956, 0.00443, 0.00328, 0.00243, 0.00158, 0.00108),
}
THRESHOLDS = (0.0003, 0.0007, 0.0015, 0.003)


def _near_boundary(v: float, margin: float = 0.15) -> bool:
    return any(abs(v - t) / t < margin for t in THRESHOLDS)


def test_perception_level_pins_reproduced():
    srcs = photo_sources(n=2, size=256, seed=2026)
    for i, pins in PINS.items():
        ranks = []
        for q, pin in zip(QUALITIES, pins):
            buf = io.BytesIO()
            Image.fromarray(srcs[i].rgb).save(buf, "JPEG", quality=q, subsampling=2)
            dec = np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
            got = ce.evaluate_single(srcs[i].rgb, dec, ce.MetricConfig(dssim=True),
                                     device="cpu").dssim
            assert got == pytest.approx(pin, rel=0.10), (i, q, got, pin)
            if not _near_boundary(pin):
                assert ce.PerceptionLevel.from_dssim(got) is ce.PerceptionLevel.from_dssim(pin)
            ranks.append(ce.PerceptionLevel.from_dssim(got).rank())
        assert ranks == sorted(ranks, reverse=True), ranks


def test_eval_config_viewing_stored_as_jax():
    cond = ce.presets.srcset_2x_on_phone()
    built = ce.EvalConfig.builder().report_dir("unused").viewing(cond).build()
    want = jce.EvalConfig.builder().report_dir("unused").viewing(
        jce.presets.srcset_2x_on_phone()).build()
    assert built.viewing is cond
    assert built.viewing.to_json() == want.viewing.to_json()
    default = ce.EvalConfig.builder().report_dir("unused").build().viewing
    assert default == ce.ViewingCondition.desktop()
    assert default.to_json() == jce.EvalConfig.builder().report_dir("unused").build(
        ).viewing.to_json()
    assert ce.EvalConfig("unused").viewing.to_json() == jce.EvalConfig("unused").viewing.to_json()


def test_root_xyb_roundtrip_equals_jax():
    ref, _ = _pair(24, seed=11)
    got = ce.xyb_roundtrip(ref, device="cpu")
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, jce.xyb_roundtrip(ref))
    flat = ce.xyb_roundtrip(ref.tobytes(), 24, 24, device="cpu")
    assert isinstance(flat, bytes) and flat == jce.xyb_roundtrip(ref.tobytes(), 24, 24)
