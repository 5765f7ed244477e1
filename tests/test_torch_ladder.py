"""The port's corpus ladder runner (``parallel/ladder_runner.py``), the
session's device fast paths and ``iter.run_eval_device`` against the JAX
package's, on the CPU:

- ``sweep_corpus_ladders`` equals each image's ``evaluate_tpujpeg_sweep``
  (the same code on the same device) and JAX's runner: exact sizes and
  device estimates equal, scores at the port's tiers; the quality axis
  scored in chunks gives the same scores;
- ``EvalSession`` with a tpujpeg adapter runs one device sweep per codec
  and image (and a JPEG adapter without one the device decode), and its
  rows equal JAX's session's: sizes, artifacts and perception levels
  exactly, scores at the tiers; a fast path that raises falls back to the
  host cells with a ``RuntimeWarning`` and counts it;
- ``run_eval_device`` equals JAX's points.
"""

import numpy as np
import pytest
import torch

import codec_eval_tpu as jce
import codec_eval_tpu_torch as ce
from codec_eval_tpu.codecs.tpujpeg import TpuJpegCodec as JaxCodec
from codec_eval_tpu.iter import eval as jax_iter_eval
from codec_eval_tpu.parallel import ladder_runner as jlr
from codec_eval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codec_eval_tpu_torch.codecs import JpegCodec, TpuJpegCodec
from codec_eval_tpu_torch.engine import evaluate_tpujpeg_sweep
from codec_eval_tpu_torch.iter.eval import SourceImage, run_eval_device
from codec_eval_tpu_torch.parallel import CorpusLadders, make_mesh, sweep_corpus_ladders
from codec_eval_tpu_torch.parallel import ladder_runner as tlr
from test_torch_jpeg_enc import photo
from test_torch_tpujpeg import TIERS, assert_scores

IMAGES = [photo(48, 48, seed=s) for s in (1, 2, 3)]
QUALITIES = [30.0, 60.0, 90.0]
CPU = make_mesh(devices=[torch.device("cpu")])


def jax_mesh():
    import jax

    return jax_make_mesh(n_batch=1, devices=jax.devices()[:1])


@pytest.mark.parametrize("with_sizes", [True, "device", False])
def test_corpus_ladders_equal_the_per_image_sweeps_and_jax(with_sizes):
    got = sweep_corpus_ladders(IMAGES, QUALITIES, mesh=CPU, with_sizes=with_sizes,
                               images_per_chunk=2)
    assert isinstance(got, CorpusLadders) and got.qualities == QUALITIES
    for i, img in enumerate(IMAGES):
        pts = evaluate_tpujpeg_sweep(img, QUALITIES, with_sizes=with_sizes, device="cpu")
        for qi, p in enumerate(pts):
            for k, v in p.metrics.items():
                assert got.scores[k][i, qi] == v, (i, qi, k)
            if with_sizes:
                assert got.sizes[i, qi] == p.file_size
    # One image per JAX step: JAX unrolls a step's images, and compiles each.
    want = jlr.sweep_corpus_ladders(IMAGES, QUALITIES, mesh=jax_mesh(), with_sizes=with_sizes,
                                    images_per_chunk=1)
    assert got.scores.keys() == want.scores.keys()
    for k in want.scores:
        np.testing.assert_allclose(got.scores[k], want.scores[k], err_msg=k, **TIERS[k])
    if with_sizes:
        assert np.array_equal(got.sizes, want.sizes) and got.sizes.dtype == np.int64
        assert np.array_equal(got.bits_per_pixel, want.bits_per_pixel)
        curve = got.mean_curve("ssimulacra2")
        assert len(curve) == len(QUALITIES)
        np.testing.assert_allclose(curve, want.mean_curve("ssimulacra2"), rtol=1e-5)
    else:
        assert got.sizes is None and got.bits_per_pixel is None
        with pytest.raises(ValueError, match="sizes were not computed"):
            got.mean_curve("ssimulacra2")


def test_quality_axis_scored_in_chunks(monkeypatch):
    """Ladders past the pixel budget score their qualities in chunks, with
    the same scores; trellis runs the device DP."""
    whole = sweep_corpus_ladders(IMAGES[:1], QUALITIES, mesh=CPU, trellis_lambda=0.1,
                                 aq_strength=0.0, metrics=("ssimulacra2", "psnr"))
    monkeypatch.setattr(tlr, "LADDER_SCORE_PX", 2 * 48 * 48)
    chunked = sweep_corpus_ladders(IMAGES[:1], QUALITIES, mesh=CPU, trellis_lambda=0.1,
                                   aq_strength=0.0, metrics=("ssimulacra2", "psnr"))
    for k in whole.scores:
        np.testing.assert_allclose(chunked.scores[k], whole.scores[k], rtol=1e-6, err_msg=k)
    assert np.array_equal(chunked.sizes, whole.sizes)
    pts = evaluate_tpujpeg_sweep(IMAGES[0], QUALITIES, metrics=("psnr",), trellis_lambda=0.1,
                                 aq_strength=0.0, device="cpu")
    assert whole.sizes[0].tolist() == [p.file_size for p in pts]


def test_corpus_ladders_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="same-size"):
        sweep_corpus_ladders([IMAGES[0], photo(32, 48)], QUALITIES, mesh=CPU)
    with pytest.raises(ValueError, match="no images"):
        sweep_corpus_ladders([], QUALITIES, mesh=CPU)
    with pytest.raises(ValueError, match="with_sizes"):
        sweep_corpus_ladders(IMAGES, QUALITIES, mesh=CPU, with_sizes="estimate")
    with pytest.raises(ValueError, match="host entropy coding would run once per process"):
        sweep_corpus_ladders(IMAGES, QUALITIES, mesh=CPU, multihost=True)


# -- the session's fast paths ----------------------------------------------------


def sessions(tmp_path, codecs, **config):
    """The port's session and JAX's, each with its own codecs, evaluating
    the same image."""
    out = []
    for name, pkg, kw in (("jax", jce, {}), ("port", ce, {"device": "cpu"})):
        b = (pkg.EvalConfig.builder().report_dir(tmp_path / name / "reports")
             .quality_levels(QUALITIES))
        if "cache" in config:
            b = b.cache_dir(tmp_path / name / "cache")
        if "size_mode" in config:
            b = b.device_size_mode(config["size_mode"])
        b = b.metrics(pkg.MetricConfig.all())
        session = pkg.EvalSession(b.build(), **kw)
        for codec in codecs(name):
            session.add_codec_impl(codec)
        report = session.evaluate_image("img", pkg.ImageData.rgb8(IMAGES[0]))
        out.append((session, report))
    return out


def assert_same_rows(got, want):
    assert len(got.results) == len(want.results)
    for g, w in zip(got.results, want.results):
        assert (g.codec_id, g.quality, g.file_size, g.bits_per_pixel) == (
            w.codec_id, w.quality, w.file_size, w.bits_per_pixel)
        assert (g.perception and g.perception.value) == (w.perception and w.perception.value)
        assert (g.cached_path is None) == (w.cached_path is None)
        assert_scores({k: getattr(g.metrics, k) for k in TIERS if getattr(w.metrics, k) is not None},
                      {k: getattr(w.metrics, k) for k in TIERS if getattr(w.metrics, k) is not None})


@pytest.mark.parametrize("config", [{}, {"size_mode": "device"}, {"cache": True}],
                         ids=["exact", "device-sizes", "cache-dir"])
def test_session_device_sweep_matches_jax(tmp_path, config):
    def codecs(side):
        if side == "jax":
            return [JaxCodec(), JaxCodec(trellis=True)]
        return [TpuJpegCodec(device="cpu"), TpuJpegCodec(trellis=True, device="cpu")]

    (js, jr), (ts, tr) = sessions(tmp_path, codecs, **config)
    assert (ts.device_sweeps_run, ts.device_sweep_fallbacks) == (js.device_sweeps_run, 0) == (2, 0)
    assert ts.jpeg_device_decodes_run == js.jpeg_device_decodes_run == 0
    assert_same_rows(tr, jr)
    assert all(r.decode_time_ms == 0 for r in tr.results)
    if "cache" in config:
        for r in tr.results:
            data = open(r.cached_path, "rb").read()
            assert len(data) == r.file_size
            assert data == open(r.cached_path.replace("/port/", "/jax/"), "rb").read()
    if config.get("size_mode") == "device":
        exact = evaluate_tpujpeg_sweep(IMAGES[0], QUALITIES, with_sizes="device", device="cpu")
        assert [r.file_size for r in tr.results[:3]] == [p.file_size for p in exact]


def test_session_jpeg_device_decode_matches_jax(tmp_path):
    """A JPEG adapter without a device sweep: host encodes, one device
    decode and scoring batch, in both packages."""
    from codec_eval_tpu.codecs import JpegCodec as JaxJpeg

    (js, jr), (ts, tr) = sessions(
        tmp_path, lambda side: [JaxJpeg("420", True)] if side == "jax" else [JpegCodec("420", True)])
    assert ts.jpeg_device_decodes_run == js.jpeg_device_decodes_run == 1
    assert ts.jpeg_device_decode_fallbacks == ts.device_sweeps_run == 0
    assert_same_rows(tr, jr)


def test_session_fast_paths_gated_and_fallback(tmp_path):
    """The XYB roundtrip keeps both fast paths off (as in JAX); a device
    sweep that raises falls back to the host cells, loudly."""
    (_, jr), (ts, tr) = sessions(
        tmp_path, lambda side: [JaxCodec()] if side == "jax" else [TpuJpegCodec(device="cpu")])
    assert ts.device_sweeps_run == 1
    config = (ce.EvalConfig.builder().report_dir(tmp_path / "x").quality_levels(QUALITIES)
              .metrics(ce.MetricConfig.perceptual_xyb()).build())
    session = ce.EvalSession(config, device="cpu")
    session.add_codec_impl(TpuJpegCodec(device="cpu"))
    report = session.evaluate_image("img", ce.ImageData.rgb8(IMAGES[0]))
    assert session.device_sweeps_run == session.jpeg_device_decodes_run == 0
    assert [r.file_size for r in report.results] == [r.file_size for r in tr.results]

    class Broken(TpuJpegCodec):
        def device_sweep(self, *args, **kwargs):
            raise RuntimeError("no ladder today")

    session = ce.EvalSession(ce.EvalConfig.builder().report_dir(tmp_path / "b")
                             .quality_levels(QUALITIES).build(), device="cpu")
    session.add_codec_impl(Broken(device="cpu"))
    with pytest.warns(RuntimeWarning, match="no ladder today"):
        report = session.evaluate_image("img", ce.ImageData.rgb8(IMAGES[0]))
    assert (session.device_sweeps_run, session.device_sweep_fallbacks) == (0, 1)
    # The fallback took the device decode of the host encodes.
    assert session.jpeg_device_decodes_run == 1
    assert [r.file_size for r in report.results] == [r.file_size for r in tr.results]
    assert_same_rows(report, tr)


def test_device_size_mode_is_validated():
    with pytest.raises(ValueError, match="device_size_mode"):
        ce.EvalConfig.builder().report_dir("r").device_size_mode("estimate").build()
    assert ce.EvalConfig.builder().report_dir("r").build().device_size_mode == "exact"


@pytest.mark.parametrize("size_mode", ["exact", "device"])
def test_run_eval_device_matches_jax(size_mode):
    images = [SourceImage(f"im{i}", img) for i, img in enumerate(IMAGES[:2])]
    got = run_eval_device(images, [40, 80], size_mode=size_mode, trellis=size_mode == "device",
                          device="cpu")
    want = jax_iter_eval.run_eval_device(
        [jax_iter_eval.SourceImage(s.name, s.rgb) for s in images], [40, 80],
        size_mode=size_mode, trellis=size_mode == "device")
    assert got.config_summary == want.config_summary
    assert len(got.points) == len(want.points) == 4
    for g, w in zip(got.points, want.points):
        assert (g.image, g.quality, g.size_bytes, g.bpp) == (w.image, w.quality, w.size_bytes, w.bpp)
        np.testing.assert_allclose(g.ssim2, w.ssim2, **TIERS["ssimulacra2"])
    with pytest.raises(ValueError, match="size_mode"):
        run_eval_device(images, [40], size_mode="estimate", device="cpu")
