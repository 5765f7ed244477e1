"""The port's stats layer (``codec_eval_tpu_torch/stats``) against the JAX
package's ``codec_eval_tpu/stats``: every public function, class and method
of the seven modules runs on the same inputs through both copies, the inputs
of ``tests/test_stats.py``, ``test_abtest.py``, ``test_rd_knee.py`` and
``test_interpolation_chart.py`` (and seeded numpy draws).  The two copies
are the same numpy code, so the results must be equal: floats with ``==``,
dataclasses field by field, SVG text character by character, and raised
errors by type and message.
"""

import dataclasses
import enum
import importlib
import inspect
import math

import numpy as np
import pytest

MODULES = ("summary", "pareto", "interpolation", "chart", "rd_knee", "rd_plot", "abtest")


def _modules(name):
    return (importlib.import_module(f"codec_eval_tpu.stats.{name}"),
            importlib.import_module(f"codec_eval_tpu_torch.stats.{name}"))


def plain(obj):
    """A comparable form of a result: the class name with the fields of a
    dataclass or an object, enums by value, arrays as nested tuples, NaN as
    a string (so NaN equals NaN), numpy scalars as Python numbers."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name))) for f in dataclasses.fields(obj)))
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, np.ndarray):
        return ("ndarray", str(obj.dtype), obj.shape, plain(obj.tolist()))
    if isinstance(obj, np.generic):
        return plain(obj.item())
    if isinstance(obj, float):
        return "nan" if math.isnan(obj) else obj
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(plain(x) for x in obj))
    if isinstance(obj, dict):
        return ("dict", tuple((plain(k), plain(v)) for k, v in obj.items()))
    if callable(obj) or obj is None or isinstance(obj, (bool, int, str)):
        return obj if not callable(obj) else ("callable", getattr(obj, "__name__", "?"))
    return (type(obj).__name__, plain(vars(obj)))


def outcome(fn, mod):
    try:
        return ("ok", plain(fn(mod)))
    except Exception as e:  # noqa: BLE001 - the error itself is the result compared
        return ("raises", type(e).__name__, str(e))


def _seeded(seed, n, loc=3.2, scale=1.0):
    return np.random.default_rng(seed).normal(loc, scale, n)


_SATURATING = [
    (0.2 + 0.18 * i, 90.0 * (1.0 - 2.718 ** (-1.2 * (0.2 + 0.18 * i))),
     10.0 * 2.718 ** (-0.8 * (0.2 + 0.18 * i)) + 1.0)
    for i in range(20)
]
_FIVE = [1.0, 2.0, 3.0, 4.0, 5.0]
_REF_CURVE = [(1.0, 60.0), (2.0, 70.0), (4.0, 80.0), (8.0, 90.0)]
_POINTS = [("a", 50.0, 0.5, 60.0), ("a", 80.0, 1.0, 80.0), ("b", 80.0, 1.5, 75.0),
           ("b", 95.0, 2.0, 90.0)]
_GAPS = [(30, 0.010), (50, 0.005), (70, 0.002), (80, 0.001), (90, 0.0005)]


def _front(m, points=_POINTS):
    return m.ParetoFront.compute([m.RDPoint(*p) for p in points])


def _configured(m):
    points = [
        m.ConfiguredRDPoint(position=m.WEB_FRAME.position(b, s, a),
                            config=m.CodecConfig("test", "1.0"))
        for b, s, a in [(0.5, 60.0, 5.0), (1.0, 75.0, 3.0), (1.5, 70.0, 4.0)]
    ]
    return m.ConfiguredParetoFront.compute(points, m.defaults.mozjpeg_cid22(),
                                           m.BinScheme.default_18())


def _series(m):
    return [m.ChartSeries(name="Codec A", color="#e74c3c",
                          points=[m.ChartPoint(0.5, 80.0), m.ChartPoint(1.0, 90.0, "q90")]),
            m.ChartSeries("B <&>", "#000", [m.ChartPoint(0.7, 70.0), m.ChartPoint(1.3, 88.0)])]


def _records(m):
    return [
        m.ParticipantRecord("ok", 10, 1, 10, 8, [500.0] * 20, 100, 100),
        m.ParticipantRecord("attn", 10, 3, 10, 8, [500.0] * 20, 100, 100),
        m.ParticipantRecord("dupe", 10, 0, 10, 5, [500.0] * 20, 100, 100),
        m.ParticipantRecord("fast", 10, 0, 10, 8, [150.0] * 5 + [500.0] * 15, 100, 100),
        m.ParticipantRecord("quit", 10, 0, 10, 8, [500.0] * 20, 70, 100),
    ]


def _knee(m, direction, column):
    bpps = [p[0] for p in _SATURATING]
    qs = [p[column] for p in _SATURATING]
    norm = m.NormalizationContext(m.AxisRange(min(bpps), max(bpps)),
                                  m.AxisRange(min(qs), max(qs)), direction)
    angle = m.WEB_FRAME.s2_angle if column == 1 else m.WEB_FRAME.ba_angle
    return m.find_knee(_SATURATING, norm, lambda p: p[column], angle)


# Each case: (label, the public names it exercises, fn(module) -> result).
CASES = {
    "summary": [
        ("percentile_sorted", {"percentile_sorted"},
         lambda m: [m.percentile_sorted(np.array(_FIVE), p) for p in (0.0, 0.25, 0.5, 0.9, 1.0)]),
        ("percentile", {"percentile"},
         lambda m: [m.percentile(_FIVE, p) for p in (0.5, 0.25, 0.75, 50, 99.5)]
         + [m.percentile([], 0.5), m.percentile(_seeded(1, 37).tolist(), 0.33)]),
        ("percentile_u32", {"percentile_u32"},
         lambda m: [m.percentile_u32([10, 20, 30, 40, 50], p) for p in (0.5, 0.1, 0.95)]),
        ("mean_median", {"mean", "median"},
         lambda m: [m.mean(_FIVE), m.mean([]), m.median(_FIVE), m.median([1.0, 2.0, 3.0, 4.0]),
                    m.median([]), m.mean(_seeded(2, 41).tolist())]),
        ("std_dev", {"std_dev"},
         lambda m: [m.std_dev([2.0, 4.0, 4.0, 4.0, 5.0, 5.0, 7.0, 9.0]), m.std_dev([1.0]),
                    m.std_dev(_seeded(3, 29).tolist())]),
        ("trimmed_mean_iqr", {"trimmed_mean", "iqr"},
         lambda m: [m.trimmed_mean([1.0, 10.0, 11.0, 12.0, 13.0, 100.0], 0.2),
                    m.trimmed_mean(_seeded(4, 50).tolist(), 0.1), m.iqr(_FIVE),
                    m.iqr(_seeded(5, 33).tolist())]),
        ("Summary", {"Summary", "Summary.compute", "Summary.to_json"},
         lambda m: [m.Summary.compute(_FIVE), m.Summary.compute([]),
                    m.Summary.compute(_seeded(6, 64).tolist()).to_json()]),
        ("bd_rate", {"bd_rate"},
         lambda m: [
             m.bd_rate(_REF_CURVE, [(0.5, 60.0), (1.0, 70.0), (2.0, 80.0), (4.0, 90.0)]),
             m.bd_rate(_REF_CURVE, _REF_CURVE), m.bd_rate(_REF_CURVE[:3], _REF_CURVE),
             m.bd_rate([(1.0, 10.0), (2.0, 20.0), (3.0, 30.0), (4.0, 40.0)],
                       [(1.0, 50.0), (2.0, 60.0), (3.0, 70.0), (4.0, 80.0)]),
             m.bd_rate(_REF_CURVE, [(1.1, 61.0), (2.3, 72.0), (3.9, 79.0), (7.0, 91.0)])]),
    ],
    "pareto": [
        ("RDPoint", {"RDPoint", "RDPoint.dominates", "RDPoint.to_json", "RDPoint.from_json"},
         lambda m: [m.RDPoint("a", 80.0, 1.0, 90.0).dominates(m.RDPoint("b", 80.0, 2.0, 85.0)),
                    m.RDPoint("b", 80.0, 2.0, 85.0).dominates(m.RDPoint("a", 80.0, 1.0, 90.0)),
                    m.RDPoint("a", 80.0, 1.0, 90.0).dominates(m.RDPoint("c", 80.0, 1.0, 90.0)),
                    m.RDPoint.from_json(m.RDPoint("x", 70.0, 0.8, 81.5).to_json())]),
        ("ParetoFront", {"ParetoFront", "ParetoFront.compute", "ParetoFront.__len__",
                         "ParetoFront.is_empty", "ParetoFront.to_json", "ParetoFront.from_json"},
         lambda m: [_front(m), len(_front(m)), _front(m).is_empty(),
                    m.ParetoFront.compute([]).is_empty(),
                    m.ParetoFront.from_json(_front(m).to_json())]),
        ("ParetoFront queries", {"ParetoFront.best_at_bpp", "ParetoFront.best_at_quality",
                                 "ParetoFront.codecs", "ParetoFront.at_quality",
                                 "ParetoFront.at_bpp", "ParetoFront.filter_codec",
                                 "ParetoFront.per_codec"},
         lambda m: [_front(m).best_at_bpp(1.2), _front(m).best_at_quality(70.0),
                    _front(m).codecs(), _front(m).at_quality(80.0), _front(m).at_bpp(1.0),
                    _front(m).filter_codec("b"),
                    sorted(m.ParetoFront.per_codec([m.RDPoint(*p) for p in _POINTS]).items()),
                    m.ParetoFront.compute([]).best_at_bpp(1.0)]),
        ("seeded ladder", {"ParetoFront.compute"},
         lambda m: _front(m, [(c, float(q), float(b), float(s)) for c, q, b, s in zip(
             "abcabcabcabc", range(40, 100, 5), np.random.default_rng(7).uniform(0.1, 3, 12),
             np.random.default_rng(8).uniform(30, 95, 12))])),
    ],
    "interpolation": [
        ("fit_power_law", {"fit_power_law", "InterpolationConfig"},
         lambda m: [m.fit_power_law([(x, 2.0 * x**1.5 + 3.0) for x in (1.0, 2.0, 4.0, 8.0, 16.0)],
                                    m.InterpolationConfig()),
                    m.fit_power_law([(1.0, 1.0), (2.0, 2.0)], m.InterpolationConfig())]),
        ("GapPolynomial", {"GapPolynomial", "GapPolynomial.covers", "GapPolynomial.interpolate"},
         lambda m: [m.GapPolynomial(50, 90, 0.001, 2.0, 0.5, 0.98, 0.001).covers(q)
                    for q in (70, 95)]
         + [m.GapPolynomial(50, 90, 0.001, 2.0, 0.5, 0.98, 0.001).interpolate(70.0),
            m.GapPolynomial(0, 100, 1000.0, 2.0, 0.0, 1.0, 0.0).interpolate(50.0)]),
        ("fit_gap_polynomial", {"fit_gap_polynomial", "compute_gap_polynomials"},
         lambda m: [m.fit_gap_polynomial(_GAPS, 2, m.InterpolationConfig()),
                    m.compute_gap_polynomials(_GAPS, m.InterpolationConfig()),
                    m.compute_gap_polynomials(_GAPS[:3], m.InterpolationConfig())]),
        ("InterpolationTable", {"InterpolationTable", "InterpolationTable.find_polynomial",
                                "InterpolationTable.interpolate"},
         lambda m: (lambda t: (t.polynomials.append(m.GapPolynomial(50, 90, 0.5, 1.0, 10.0,
                                                                    0.99, 0.0)),
                               [t.find_polynomial(70), t.find_polynomial(95),
                                t.interpolate(70.0), t.interpolate(95.0), t])[1])(
             m.InterpolationTable("mozjpeg", "desktop-1x"))),
        ("linear_interpolate", {"linear_interpolate"},
         lambda m: [m.linear_interpolate(y, [(50, 0.010), (70, 0.005), (90, 0.001)])
                    for y in (0.0075, 0.003, 0.1)]
         + [m.linear_interpolate(0.005, [(70, 0.005)]), m.linear_interpolate(0.005, [])]),
    ],
    "chart": [
        ("generate_svg", {"generate_svg", "ChartSeries", "ChartPoint", "ChartConfig",
                          "ChartConfig.new"},
         lambda m: [m.generate_svg(_series(m), m.ChartConfig.new("Quality vs Size")),
                    m.generate_svg([], m.ChartConfig()),
                    m.generate_svg([m.ChartSeries("x", "#fff", [])], m.ChartConfig())]),
        ("generate_svg builders", {"ChartConfig.with_x_label", "ChartConfig.with_y_label",
                                   "ChartConfig.with_lower_is_better",
                                   "ChartConfig.with_dimensions"},
         lambda m: m.generate_svg(
             _series(m), m.ChartConfig.new("Butteraugli").with_x_label("bpp")
             .with_y_label("distance").with_lower_is_better(True).with_dimensions(640, 400))),
    ],
    "rd_knee": [
        ("FixedFrame", {"FixedFrame", "FixedFrame.s2_angle", "FixedFrame.ba_angle",
                        "FixedFrame.position", "WEB_FRAME", "RDPosition"},
         lambda m: [m.WEB_FRAME, m.WEB_FRAME.s2_angle(0.7274, 65.10),
                    m.WEB_FRAME.ba_angle(0.7048, 4.378), m.WEB_FRAME.ba_angle(1.0, 15.0),
                    m.WEB_FRAME.position(0.7274, 65.10, 4.378), m.FixedFrame(bpp_max=2.0)]),
        ("AxisRange", {"AxisRange", "AxisRange.normalize", "AxisRange.denormalize",
                       "AxisRange.span", "QualityDirection", "NormalizationContext",
                       "NormalizationContext.normalize_bpp",
                       "NormalizationContext.normalize_quality"},
         lambda m: [m.AxisRange(0.2, 3.6).normalize(1.0), m.AxisRange(0.2, 3.6).denormalize(0.4),
                    m.AxisRange(0.2, 3.6).span()]
         + [m.NormalizationContext(m.AxisRange(0.2, 3.6), m.AxisRange(1.8, 11.6), d)
            .normalize_quality(4.4) for d in (m.QualityDirection.HIGHER_IS_BETTER,
                                              m.QualityDirection.LOWER_IS_BETTER)]
         + [m.NormalizationContext(m.AxisRange(0.2, 3.6), m.AxisRange(1.8, 11.6),
                                   m.QualityDirection.HIGHER_IS_BETTER).normalize_bpp(0.9)]),
        ("find_knee", {"find_knee", "RDKnee"},
         lambda m: [_knee(m, m.QualityDirection.HIGHER_IS_BETTER, 1),
                    _knee(m, m.QualityDirection.LOWER_IS_BETTER, 2)]),
        ("CorpusAggregate", {"CorpusAggregate", "CorpusAggregate.ssimulacra2_knee",
                             "CorpusAggregate.butteraugli_knee", "CorpusAggregate.calibrate",
                             "RDCalibration", "RDCalibration.disagreement_range",
                             "RDCalibration.position"},
         lambda m: (lambda cal: [cal, cal.disagreement_range(), cal.position(1.0, 70.0, 3.0),
                                 m.CorpusAggregate("x", "y", [(0.5, 50.0, 5.0),
                                                              (1.0, 70.0, 3.0)], 1)
                                 .ssimulacra2_knee(m.WEB_FRAME),
                                 m.CorpusAggregate("s", "t", _SATURATING, 10)
                                 .butteraugli_knee(m.WEB_FRAME)])(
             m.CorpusAggregate("synthetic", "test", _SATURATING, 10).calibrate(m.WEB_FRAME))),
        ("BinScheme", {"BinScheme", "BinScheme.default_18", "BinScheme.fine_36",
                       "BinScheme.range", "BinScheme.bin_for", "BinScheme.bins", "AngleBin",
                       "AngleBin.lo", "AngleBin.hi", "AngleBin.contains"},
         lambda m: [m.BinScheme.default_18().bins(), m.BinScheme.fine_36(),
                    m.BinScheme.range(10.0, 80.0, 7).bins(),
                    [m.BinScheme.default_18().bin_for(a) for a in (-10.0, 45.0, 200.0)],
                    [(b.lo(), b.hi(), b.contains(45.0)) for b in m.BinScheme.fine_36().bins()]]),
        ("RDPosition", {"RDPosition.in_disagreement_zone", "RDPosition.bin",
                        "RDPosition.dual_bin", "DualAngleBin"},
         lambda m: [(p.in_disagreement_zone(m.defaults.mozjpeg_cid22()),
                     p.bin(m.BinScheme.default_18()), p.dual_bin(m.BinScheme.fine_36()))
                    for p in (m.WEB_FRAME.position(b, s, a) for b, s, a in _SATURATING)]),
        ("ParamValue", {"ParamValue", "ParamValue.int", "ParamValue.float", "ParamValue.bool",
                        "ParamValue.text", "ParamValue.__str__", "ParamValue.to_json",
                        "CodecConfig", "CodecConfig.with_param", "CodecConfig.fingerprint"},
         lambda m: [[str(v), v.to_json()] for v in (
             m.ParamValue.int(6), m.ParamValue.float(1.0), m.ParamValue.float(0.125),
             m.ParamValue.bool(True), m.ParamValue.bool(False), m.ParamValue.text("qm"))]
         + [m.CodecConfig("ravif", "0.11").with_param("speed", m.ParamValue.int(6))
            .with_param("qm", m.ParamValue.bool(True)).fingerprint(),
            m.CodecConfig("mozjpeg", "4.1").with_param("subsampling", "420")
            .with_param("progressive", True).fingerprint()]),
        ("ConfiguredParetoFront", {"ConfiguredParetoFront", "ConfiguredParetoFront.compute",
                                   "ConfiguredRDPoint", "ConfiguredParetoFront.best_config_for_s2",
                                   "ConfiguredParetoFront.best_config_for_ba",
                                   "ConfiguredParetoFront.best_config_for_bpp",
                                   "ConfiguredParetoFront.in_bin",
                                   "ConfiguredParetoFront.coverage",
                                   "ConfiguredParetoFront.empty_bins"},
         lambda m: (lambda f: [f, f.best_config_for_s2(70.0), f.best_config_for_ba(3.5),
                               f.best_config_for_bpp(0.7), f.coverage(), f.empty_bins(),
                               f.in_bin(m.BinScheme.default_18().bin_for(40.0))])(
             _configured(m))),
        ("EncodeResult", {"EncodeResult"},
         lambda m: m.EncodeResult(0.9, 71.5, 3.2, "img", m.CodecConfig("c", "1"))),
        ("interpolate_s2_at", {"interpolate_s2_at"},
         lambda m: [m.interpolate_s2_at([(0.5, 50.0, 5.0), (1.0, 70.0, 3.0), (2.0, 80.0, 2.0)], b)
                    for b in (0.75, 1.5, 3.0)] + [m.interpolate_s2_at(_SATURATING, 1.1)]),
        ("defaults", {"defaults", "defaults.mozjpeg_cid22", "defaults.mozjpeg_clic2025"},
         lambda m: [m.defaults.mozjpeg_cid22(), m.defaults.mozjpeg_clic2025()]),
    ],
    "rd_plot": [
        ("plot_rd_svg", {"plot_rd_svg"},
         lambda m: (lambda k: [
             m.plot_rd_svg(_SATURATING, k.WEB_FRAME,
                           k.CorpusAggregate("s", "t", _SATURATING, 10).calibrate(k.WEB_FRAME),
                           title="T"),
             m.plot_rd_svg(_SATURATING[:6], k.WEB_FRAME, None, angle_step_deg=10.0)])(
             importlib.import_module(m.__name__.rsplit(".", 1)[0] + ".rd_knee"))),
    ],
    "abtest": [
        ("binomial", {"binomial_test_two_sided"},
         lambda m: [m.binomial_test_two_sided(k, n) for k, n in
                    [(60, 100), (50, 100), (0, 10), (10, 10), (7, 9)]]
         + [m.binomial_test_two_sided(5, 10, 0.5), m.binomial_test_two_sided(3, 20, 0.3)]),
        ("binomial raises", {"binomial_test_two_sided"},
         lambda m: m.binomial_test_two_sided(11, 10)),
        ("two_afc", {"two_afc_test", "TwoAfcResult", "TwoAfcResult.report"},
         lambda m: [m.two_afc_test(67, 100), m.two_afc_test(67, 100).report("Codec A"),
                    m.two_afc_test(12, 30).report()]),
        ("corrections", {"holm_bonferroni", "benjamini_hochberg"},
         lambda m: [f(p) for f in (m.holm_bonferroni, m.benjamini_hochberg)
                    for p in ([0.01, 0.04, 0.03, 0.005], [], [0.9, 0.8])]),
        ("bootstrap_ci", {"bootstrap_ci"},
         lambda m: [m.bootstrap_ci(_seeded(3, 200), seed=7),
                    m.bootstrap_ci(_seeded(4, 50), statistic=np.median, n_boot=500, seed=1)]),
        ("mos_summary", {"mos_summary", "MosSummary"},
         lambda m: [m.mos_summary([4, 4, 5, 3, 4, 4, 5, 4, 3, 4]),
                    m.mos_summary(np.round(_seeded(9, 40, 3.5)).tolist(), alpha=0.1, seed=3)]),
        ("cohens_d", {"cohens_d"},
         lambda m: [m.cohens_d([5.0, 6.0, 7.0, 8.0], [3.0, 4.0, 5.0, 6.0]),
                    m.cohens_d([1.0, 1.0, 1.0], [1.0, 1.0, 1.0]),
                    m.cohens_d(_seeded(10, 30).tolist(), _seeded(11, 25, 2.9).tolist())]),
        ("wilcoxon", {"wilcoxon_signed_rank"},
         lambda m: [m.wilcoxon_signed_rank([2.0, 3.0, 4.0, 5.0, 6.0], [1.0] * 5),
                    m.wilcoxon_signed_rank([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]),
                    m.wilcoxon_signed_rank(_seeded(12, 20).tolist(), _seeded(13, 20).tolist())]),
        ("position_bias", {"position_bias", "PositionBias"},
         lambda m: [m.position_bias(80, 100), m.position_bias(55, 100), m.position_bias(3, 4)]),
        ("screening", {"screen_participants", "ParticipantRecord", "ScreeningCriteria",
                       "ScreeningResult"},
         lambda m: [m.screen_participants(_records(m)),
                    m.screen_participants([m.ParticipantRecord("p", 10, 2, 0, 0, [], 100, 100)],
                                          m.ScreeningCriteria(max_attention_failure_rate=0.10))]),
        ("sample sizes", {"required_sample_size", "recommended_sample_size"},
         lambda m: [m.required_sample_size(0.5, 1.0), m.required_sample_size(0.25, 1.0),
                    m.required_sample_size(0.3, 0.8, power=0.9, alpha=0.01)]
         + [m.recommended_sample_size(d) for d in ("large", "Medium", "small")]),
        ("sample size raises", {"required_sample_size"},
         lambda m: m.required_sample_size(0.0, 1.0)),
        ("recommended raises", {"recommended_sample_size"},
         lambda m: m.recommended_sample_size("huge")),
        ("fatigue", {"fatigue_check", "FatigueCheck"},
         lambda m: [m.fatigue_check(38, 40, 24, 40), m.fatigue_check(24, 40, 38, 40),
                    m.fatigue_check(38, 40, 36, 40)]),
        ("fatigue raises", {"fatigue_check"}, lambda m: m.fatigue_check(1, 0, 1, 1)),
        ("scale_usage", {"scale_usage", "ScaleUsage"},
         lambda m: [m.scale_usage([3, 4, 3, 4, 3, 4, 3, 3, 4, 3] * 5),
                    m.scale_usage([1, 2, 3, 4, 5, 1, 5, 3, 2, 4]),
                    m.scale_usage([1, 7, 4, 4, 2], scale_min=1, scale_max=7)]),
        ("scale_usage raises", {"scale_usage"}, lambda m: m.scale_usage([])),
    ],
}


def _cases(module):
    return [pytest.param(fn, id=label) for label, _names, fn in CASES[module]]


def _check(module, fn):
    jax_mod, port_mod = _modules(module)
    want, got = outcome(fn, jax_mod), outcome(fn, port_mod)
    assert got == want


@pytest.mark.parametrize("fn", _cases("summary"))
def test_summary_equal(fn):
    _check("summary", fn)


@pytest.mark.parametrize("fn", _cases("pareto"))
def test_pareto_equal(fn):
    _check("pareto", fn)


@pytest.mark.parametrize("fn", _cases("interpolation"))
def test_interpolation_equal(fn):
    _check("interpolation", fn)


@pytest.mark.parametrize("fn", _cases("chart"))
def test_chart_equal(fn):
    _check("chart", fn)


@pytest.mark.parametrize("fn", _cases("rd_knee"))
def test_rd_knee_equal(fn):
    _check("rd_knee", fn)


@pytest.mark.parametrize("fn", _cases("rd_plot"))
def test_rd_plot_equal(fn):
    _check("rd_plot", fn)


@pytest.mark.parametrize("fn", _cases("abtest"))
def test_abtest_equal(fn):
    _check("abtest", fn)


def _public(mod):
    """Public functions, classes and their public methods, and module
    constants defined in ``mod``."""
    names = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        if inspect.isclass(obj) or inspect.isfunction(obj):
            if obj.__module__ != mod.__name__:
                continue
            names.add(name)
            if inspect.isclass(obj):
                names |= {f"{name}.{m}" for m, v in vars(obj).items()
                          if (not m.startswith("_") or m in ("__len__", "__str__"))
                          and (callable(v) or isinstance(v, (classmethod, staticmethod)))}
        elif name.isupper():
            names.add(name)
    return names


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_is_exercised(module):
    jax_mod, port_mod = _modules(module)
    assert _public(port_mod) == _public(jax_mod)
    covered = set().union(*(names for _label, names, _fn in CASES[module]))
    assert _public(jax_mod) - covered == set()


@pytest.mark.parametrize("module", MODULES)
def test_port_stats_module_is_the_jax_code(module):
    """Beyond its docstring, each port module is the JAX file's text."""
    import ast

    jax_mod, port_mod = _modules(module)

    def body(m):
        tree = ast.parse(inspect.getsource(m))
        tree.body = tree.body[1:]  # the module docstring
        return ast.dump(tree)

    assert body(port_mod) == body(jax_mod)


def test_stats_package_reexports_equal_jax():
    import codec_eval_tpu.stats as jst
    import codec_eval_tpu_torch.stats as tst

    public = {n for n in vars(jst) if not n.startswith("_") and n not in MODULES}
    assert public == {n for n in vars(tst) if not n.startswith("_") and n not in MODULES}
