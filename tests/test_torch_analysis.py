"""The port's ``analysis/`` and the command-line tools' ladder scorers
against the JAX package, on the CPU.

- ``predictor.py`` and ``quality_predictor.py`` are the JAX files' code,
  and so are the host parts of ``comparison.py`` (the rows, the CSV, the
  outlier and matched-bpp analyses), docstrings aside;
- the cases of ``tests/test_analysis.py``, run against the port;
- the heuristics against JAX's jitted ``compute_heuristics``,
  ``heuristics_one`` and ``heuristics_batch`` on ``tests/test_analysis.py``'s
  images and 512 px ``photo_sources`` images: continuous features within
  1e-5 relative, or 1e-5 of their full range where they sit near zero or
  where JAX's f32 sums drift from exact arithmetic (the checkerboard's
  colour variance, 1.1e-5 relative off); shares of pixels or blocks past a
  threshold within one pixel or block of the count;
- ``score_sweep`` (``analysis.comparison``) and ``score_ladder``
  (``cli.rd_calibrate``) against JAX's ``_score_sweep_fn()`` and
  ``rd_calibrate``'s ``score_sweep`` at the tiers (SSIMULACRA2 1e-5,
  Butteraugli 5e-4, DSSIM 1e-6 of JAX's f64 form), with a candidate equal
  to the reference among them;
- ``sweep_codecs`` against JAX's, and its JSONL checkpoint resume.
"""

import ast
import importlib
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import codec_eval_tpu.analysis as ja
from codec_eval_tpu.analysis import heuristics as jh
from codec_eval_tpu.iter.source import photo_sources
from codec_eval_tpu_torch.analysis import (
    ComparisonRow,
    default_rules,
    determine_winners,
    evaluate_rules,
    find_outliers,
    fit_logistic_rule,
    heuristics_one,
    quality_predictor as qp,
    rd_compare,
)
from codec_eval_tpu_torch.analysis import comparison as tc
from codec_eval_tpu_torch.analysis import heuristics as th
from codec_eval_tpu_torch.iter.codecs import build_codec
from test_torch_corpus_io import assert_jax_code
from test_torch_dssim import jax_dssim_x64


def top_level_code(module: str) -> dict:
    """{name: AST dump} of each top-level function, class and assignment of
    ``module``, docstrings taken out."""
    tree = ast.parse(inspect.getsource(importlib.import_module(module)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0]
            if (isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                node.body = node.body[1:] or [ast.Pass()]
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                out[t.id] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", ["analysis.predictor", "analysis.quality_predictor"])
def test_host_module_is_the_jax_code(name):
    assert_jax_code(name)


#: The host parts of ``analysis/comparison.py``, the JAX file's code.
COMPARISON_COPIES = [
    "ComparisonRow", "CSV_HEADER", "write_comparison_csv", "read_comparison_csv",
    "OutlierReport", "find_outliers", "outlier_report_json", "DEFAULT_BPP_TARGETS",
    "_interp_at_bpp", "RdCompareResult", "rd_compare",
]


def test_comparison_host_parts_are_the_jax_code():
    port = top_level_code("codec_eval_tpu_torch.analysis.comparison")
    jax_defs = top_level_code("codec_eval_tpu.analysis.comparison")
    for name in COMPARISON_COPIES:
        assert port[name] == jax_defs[name], name
    # What differs: the scorer, and the loop split from its PIL loader.
    assert set(port) - set(jax_defs) == {"score_sweep", "sweep_images"}
    assert set(jax_defs) - set(port) == {"_score_sweep_fn"}


def test_analysis_exports_follow_jax():
    import codec_eval_tpu_torch.analysis as ta

    public = {n for n in dir(ja) if not n.startswith("_")}
    assert public - {n for n in dir(ta) if not n.startswith("_")} == set()


# -- the cases of tests/test_analysis.py --------------------------------------


def test_heuristics_flat_image():
    flat = np.full((64, 64, 3), 128, np.uint8)
    f = heuristics_one(flat, device="cpu")
    assert f["mean_luminance"] == pytest.approx(128.0, abs=0.5)
    assert f["luminance_variance"] == pytest.approx(0.0, abs=1e-3)
    assert f["flat_block_pct"] == 100.0
    assert f["edge_strength_mean"] == pytest.approx(0.0, abs=1e-3)
    assert f["edge_density"] == 0.0
    assert f["saturation_mean"] == pytest.approx(0.0, abs=1e-6)
    assert f["high_freq_energy"] == 0.0
    assert f["low_freq_energy"] == 1.0


def _checkerboard(cell=1, n=64):
    y, x = np.mgrid[0:n, 0:n]
    check = ((((x // cell) + (y // cell)) % 2) * 255).astype(np.uint8)
    return np.stack([check] * 3, -1)


def _gradient():
    y, x = np.mgrid[0:64, 0:64]
    return np.stack([(x * 4).astype(np.uint8)] * 3, -1)


def test_heuristics_checkerboard():
    f = heuristics_one(_checkerboard(), device="cpu")
    assert f["edge_strength_mean"] == pytest.approx(0.0, abs=1e-3)
    assert f["detail_block_pct"] == 100.0
    assert f["high_freq_energy"] > 0.9
    assert f["local_contrast_mean"] == pytest.approx(255.0, abs=1.0)


def test_heuristics_block_checkerboard_edges():
    assert heuristics_one(_checkerboard(2), device="cpu")["edge_density"] > 0.5


def test_heuristics_gradient_low_freq():
    f = heuristics_one(_gradient(), device="cpu")
    assert f["high_freq_energy"] < 0.05
    assert f["flat_block_pct"] == 100.0
    assert f["horizontal_complexity"] > f["vertical_complexity"]


def test_quality_equivalence():
    assert abs(qp.mozjpeg_to_jpegli_quality(90) - 80) <= 5
    assert abs(qp.mozjpeg_to_jpegli_quality(85) - 70) <= 5
    assert qp.jpegli_to_mozjpeg_quality(80) == 90


def test_butteraugli_estimation():
    assert qp.estimate_butteraugli(75, "jpegli") < qp.estimate_butteraugli(75, "mozjpeg")
    assert qp.quality_for_butteraugli(2.0, "mozjpeg") > 90


def test_unified_quality():
    assert qp.unified_quality_to_butteraugli(75) == pytest.approx(2.0, abs=0.5)
    assert qp.unified_quality_to_butteraugli(50) == pytest.approx(4.0, abs=0.5)
    assert qp.unified_quality_to_butteraugli(100) == 0.0


def test_encoder_selection():
    enc, _ = qp.predict_encoder_for_quality(2.0, 50.0, 15.0, 15.0)
    assert enc == "jpegli"
    enc, _ = qp.predict_encoder_for_quality(5.0, 85.0, 5.0, 5.0)
    assert enc == "mozjpeg"


def _rows():
    rows = []
    for image, bias in [("easy", -0.5), ("hard", 0.8), ("avg", 0.1)]:
        for q in (50, 70, 90):
            rows.append(ComparisonRow(image, "a", q, q / 40.0, 50 + q / 2,
                                      0.001, 6.0 - q / 20.0, 1))
            rows.append(ComparisonRow(image, "b", q, q / 45.0, 52 + q / 2,
                                      0.001, 6.0 - q / 20.0 + bias, 1))
    return rows


def test_find_outliers():
    report = find_outliers(_rows(), "a", "b", top_n=2)
    assert report.corpus_mean_advantage == pytest.approx(-0.4 / 3, abs=1e-6)
    assert len(report.images) == 2
    assert report.images[0][0] == "hard"


def test_rd_compare():
    result = rd_compare(_rows(), "a", "b", targets=[1.5])
    va, vb, n = result.by_target[1.5]
    assert n == 3 and vb > va


def test_determine_winners_and_rules():
    rows = _rows()
    heur = {
        "easy": {"flat_block_pct": 90.0, "edge_density": 0.01, "freq_ratio": 0.01,
                 "local_contrast_mean": 5.0, "block_variance_mean": 50.0},
        "hard": {"flat_block_pct": 10.0, "edge_density": 0.5, "freq_ratio": 0.5,
                 "local_contrast_mean": 60.0, "block_variance_mean": 6000.0},
        "avg": {"flat_block_pct": 50.0, "edge_density": 0.1, "freq_ratio": 0.1,
                "local_contrast_mean": 20.0, "block_variance_mean": 800.0},
    }
    samples = determine_winners(rows, heur, "a", "b", buckets=[1.5])
    assert len(samples) == 3 and all(s.winner == "b" for s in samples)
    assert evaluate_rules(samples, default_rules("a", "b"))[0].accuracy == 1.0
    fitted = fit_logistic_rule(samples * 3, "a", "b")
    assert fitted is not None and fitted.predict(heur["avg"], 1.5) == "b"


# -- heuristics against JAX ----------------------------------------------------

#: The full range of each continuous feature, for its absolute tolerance.
RANGE = {
    **dict.fromkeys(["mean_luminance", "luminance_std", "edge_strength_mean",
                     "edge_strength_max", "local_contrast_mean", "local_contrast_std",
                     "horizontal_complexity", "vertical_complexity",
                     "diagonal_complexity"], 255.0),
    **dict.fromkeys(["luminance_variance", "block_variance_mean", "block_variance_std",
                     "color_variance"], 255.0 ** 2),
    **dict.fromkeys(["saturation_mean", "saturation_std"], 1.0),
}


def _one_unit(name: str, h: int, w: int) -> float:
    """One pixel or block of a thresholded share."""
    if name == "edge_density":
        return 1.0 / ((h - 2) * (w - 2))
    if name in ("low_freq_energy", "high_freq_energy"):
        return 1.0 / (h * (w - 1))
    return 100.0 / ((h // 8) * (w // 8))  # the block buckets, in percent


def assert_features_agree(got: dict, want: dict, shape) -> None:
    h, w = shape[:2]
    assert set(got) == set(want) == set(th.FEATURE_NAMES)
    for k, g in got.items():
        g, v = float(g), float(want[k])
        if k in RANGE:
            assert abs(g - v) <= max(1e-5 * abs(v), 1e-5 * RANGE[k]), (k, g, v)
        elif k == "freq_ratio":
            # high / low of each side's own shares, which are held below.
            low, high = float(got["low_freq_energy"]), float(got["high_freq_energy"])
            assert g == float(np.float32(high) / np.float32(low) if low > 0 else high), k
        else:
            assert abs(g - v) <= 1.0001 * _one_unit(k, h, w), (k, g, v)


def _images():
    return {
        "flat": np.full((64, 64, 3), 128, np.uint8),
        "checkerboard": _checkerboard(),
        "checkerboard2": _checkerboard(2),
        "gradient": _gradient(),
        "photo512": photo_sources(n=1, size=512)[0].rgb,
    }


@pytest.mark.parametrize("name", list(_images()))
def test_heuristics_match_jax(name):
    img = _images()[name]
    want = jax.jit(jh.compute_heuristics)(jnp.asarray(img))
    got = th.compute_heuristics(torch.from_numpy(img))
    assert all(v.dim() == 0 for v in got.values())
    assert_features_agree({k: v.item() for k, v in got.items()},
                          {k: float(v) for k, v in want.items()}, img.shape)
    one = heuristics_one(img, device="cpu")
    assert_features_agree(one, jh.heuristics_one(img), img.shape)
    assert list(one) == list(jh.heuristics_one(img))


def test_heuristics_batch_matches_jax():
    """A batch of three 512 px photo-statistics images, one device pass."""
    batch = np.stack([s.rgb for s in photo_sources(n=3, size=512, seed=7)])
    got = th.heuristics_batch(batch, device="cpu")
    want = jh.heuristics_batch(batch)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_features_agree(g, w, batch.shape[1:])
    for img, g in zip(batch, got):
        assert_features_agree(heuristics_one(img, device="cpu"), g, img.shape)


def test_heuristics_gray_is_the_jitted_rounding():
    """XLA's CPU code fuses the gray expression into two multiply-adds; the
    port rounds the same way, so a pixel step of exactly 30 or 10 code
    values (r = g = b) lands on the same side of its threshold."""
    rgb = jnp.asarray(photo_sources(n=1, size=128, seed=3)[0].rgb)
    want = jax.jit(lambda x: (lambda f: 0.299 * f[..., 0] + 0.587 * f[..., 1]
                              + 0.114 * f[..., 2])(x.astype(jnp.float32)))(rgb)
    got = th._gray(torch.from_numpy(np.array(rgb)).to(torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_heuristics_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        heuristics_one(np.zeros((16, 16, 3), np.uint8))


# -- the ladder scorers -----------------------------------------------------


def _jax_rd_score_sweep():
    """``codec_eval_tpu/cli/rd_calibrate.py``'s ``score_sweep``, a closure
    there, built as the JAX module builds it."""
    from codec_eval_tpu.kernels.butteraugli import (
        butteraugli_against_reference,
        precompute_butteraugli_reference,
    )
    from codec_eval_tpu.kernels.ssimulacra2 import (
        features_against_reference,
        precompute_reference,
        score_from_features,
    )

    @jax.jit
    def score_sweep(ref_u8, batch_u8):
        pre = precompute_reference(ref_u8)
        s2 = jax.vmap(lambda d: score_from_features(features_against_reference(pre, d)))(batch_u8)
        bref = precompute_butteraugli_reference(ref_u8)
        ba = jax.vmap(lambda d: butteraugli_against_reference(bref, d))(batch_u8)
        return s2, ba

    return score_sweep


@pytest.fixture(scope="module")
def ladder():
    """A 64 px photo-statistics image and its PIL JPEG ladder, with the
    reference itself as the last candidate."""
    ref = photo_sources(n=1, size=64, seed=11)[0].rgb
    codec = build_codec("jpeg")
    cands = [codec.decode(codec.encode(ref, q)) for q in (20, 50, 80, 95)]
    return ref, np.stack(cands + [ref])


def test_comparison_scorer_matches_jax(ladder):
    ref, batch = ladder
    s2, ds, ba = tc.score_sweep(ref, batch, device="cpu")
    js2, jds, jba = (np.asarray(v) for v in ja.comparison._score_sweep_fn()(
        jnp.asarray(ref), jnp.asarray(batch)))
    for got in (s2, ds, ba):
        assert got.dtype == np.float64 and got.shape == (len(batch),)
    np.testing.assert_allclose(s2, js2, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ds, jax_dssim_x64(ref, batch), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ds, jds, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ba[:-1], jba[:-1], rtol=5e-4, atol=0)
    # The reference as a candidate: SSIMULACRA2 100 and DSSIM 0 exactly, as
    # JAX's f64 form has it; Butteraugli as computed, which is 0 here,
    # where JAX's f32 run leaves its rounding (< 1e-6).
    assert (s2[-1], ds[-1], ba[-1]) == (100.0, 0.0, 0.0)
    assert js2[-1] == 100.0 and abs(jba[-1]) < 1e-6


def test_rd_calibrate_scorer_matches_jax(ladder):
    from codec_eval_tpu_torch.cli.rd_calibrate import score_ladder

    ref, batch = ladder
    s2, ba = score_ladder(ref, batch, device="cpu")
    js2, jba = (np.asarray(v) for v in _jax_rd_score_sweep()(jnp.asarray(ref), jnp.asarray(batch)))
    np.testing.assert_allclose(s2, js2, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ba[:-1], jba[:-1], rtol=5e-4, atol=0)
    assert (s2[-1], ba[-1]) == (100.0, 0.0) and abs(jba[-1]) < 1e-6
    same = tc.score_sweep(ref, batch, device="cpu")
    np.testing.assert_array_equal(s2, same[0])
    np.testing.assert_array_equal(ba, same[2])


def test_ladder_scorer_composes_the_batch_scorer_without_zeroing(ladder):
    """The CLIs' scorer is the batch scorer's stages: equal to
    ``score_batch`` on every candidate, and to the metric functions composed
    without the identical-candidate zeroing, as the JAX CLIs compose them,
    the reference itself as a candidate included."""
    from codec_eval_tpu_torch import BatchScorer, MetricConfig
    from codec_eval_tpu_torch.engine.scoring import build_precompute, score_ladder
    from codec_eval_tpu_torch.kernels.butteraugli import butteraugli_batch
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu_torch.kernels.dssim import dssim_against_reference

    ref, batch = ladder
    config = MetricConfig.perceptual()
    got = score_ladder(ref, batch, config, device="cpu")
    want = BatchScorer(config, device="cpu").score_batch(ref, batch)
    for k in ("ssimulacra2", "dssim", "butteraugli"):
        np.testing.assert_array_equal(got[k], [getattr(r, k) for r in want])
    pre = build_precompute(torch.from_numpy(ref), config)
    lin = srgb_u8_to_linear(torch.from_numpy(np.ascontiguousarray(np.moveaxis(batch, -1, 1))))
    np.testing.assert_array_equal(got["dssim"], dssim_against_reference(pre["dssim"], lin).numpy())
    np.testing.assert_array_equal(got["butteraugli"], butteraugli_batch(pre["ba"], lin).numpy())


def test_ladder_scorers_default_to_the_card(ladder, monkeypatch):
    from codec_eval_tpu_torch.cli.rd_calibrate import score_ladder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, batch = ladder
    for call in (tc.score_sweep, score_ladder):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call(ref, batch)


# -- sweep_codecs -------------------------------------------------------------


@pytest.fixture(scope="module")
def png_corpus(tmp_path_factory):
    from codec_eval_tpu_torch.corpus import Corpus

    root = tmp_path_factory.mktemp("sweep")
    for i, src in enumerate(photo_sources(n=2, size=48, seed=5)):
        Image.fromarray(src.rgb).save(root / f"p{i}.png")
    # A PNG whose header the corpus reads but whose pixels PIL cannot decode.
    (root / "broken.png").write_bytes((root / "p0.png").read_bytes()[:40])
    return root, Corpus.discover(root)


SWEEP_CODECS = ("jpeg", "webp")
SWEEP_QUALITIES = [40, 80]


def test_sweep_codecs_matches_jax(png_corpus, tmp_path):
    import codec_eval_tpu.corpus as jcorpus
    from codec_eval_tpu.iter.codecs import build_codec as jax_build_codec

    root, corpus = png_corpus
    msgs, jmsgs = [], []
    rows = tc.sweep_codecs(corpus, [build_codec(f) for f in SWEEP_CODECS], SWEEP_QUALITIES,
                           progress=msgs.append, device="cpu")
    want = ja.sweep_codecs(jcorpus.Corpus.discover(root),
                           [jax_build_codec(f) for f in SWEEP_CODECS], SWEEP_QUALITIES,
                           progress=jmsgs.append)
    assert msgs == jmsgs
    assert any(m.startswith("SKIP broken.png") for m in msgs)
    assert len(rows) == len(want) == 2 * 2 * 2
    for r, w in zip(rows, want):
        assert (r.image, r.codec, r.quality, r.bpp) == (w.image, w.codec, w.quality, w.bpp)
        np.testing.assert_allclose(r.ssimulacra2, w.ssimulacra2, rtol=1e-5)
        np.testing.assert_allclose(r.dssim, w.dssim, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r.butteraugli, w.butteraugli, rtol=5e-4)
        assert isinstance(r.ssimulacra2, float) and isinstance(r.encode_ms, int)


def test_sweep_codecs_resumes_from_its_checkpoint(png_corpus, tmp_path, monkeypatch):
    root, corpus = png_corpus
    codecs = [build_codec(f) for f in SWEEP_CODECS]
    ckpt = tmp_path / "ck.jsonl"
    first = tc.sweep_codecs(corpus, codecs, SWEEP_QUALITIES, checkpoint=ckpt, device="cpu")
    records = [json.loads(line) for line in ckpt.read_text().splitlines()]
    assert [(r["image"], r["codec"]) for r in records] == [
        (img, c.summary) for img in ("p0", "p1") for c in codecs]

    def no_scoring(*args, **kwargs):
        raise AssertionError("a completed unit was scored again")

    monkeypatch.setattr(tc, "score_sweep", no_scoring)
    msgs = []
    again = tc.sweep_codecs(corpus, codecs, SWEEP_QUALITIES, checkpoint=ckpt,
                            progress=msgs.append, device="cpu")
    assert again == first
    assert msgs[0] == f"resumed 4 completed units from {ckpt}"
    assert ckpt.read_text().count("\n") == 4


def test_sweep_images_is_the_loop_without_the_loader(png_corpus):
    """In-memory images through ``sweep_images`` give ``sweep_codecs``' rows."""
    root, corpus = png_corpus
    codec = build_codec("webp")
    via_corpus = tc.sweep_codecs(corpus, [codec], [60], device="cpu")
    images = [(f"p{i}", np.asarray(Image.open(root / f"p{i}.png").convert("RGB")))
              for i in range(2)]
    msgs = []
    direct = tc.sweep_images(images, [codec], [60], total_images=2, progress=msgs.append,
                             device="cpu")
    strip = [(r.image, r.codec, r.quality, r.bpp, r.ssimulacra2, r.dssim, r.butteraugli)
             for r in direct]
    assert strip == [(r.image, r.codec, r.quality, r.bpp, r.ssimulacra2, r.dssim,
                      r.butteraugli) for r in via_corpus]
    assert msgs == ["[1/2] p0 x webp-m4", "[2/2] p1 x webp-m4"]
