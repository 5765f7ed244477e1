"""The port's codec layer: ``codecs/`` against the JAX package.

- ``base``, ``pil_codecs``, ``jxl``, ``report`` and ``html_report`` are the
  JAX files' code, docstrings aside;
- the cases of ``tests/test_codec_adapters.py`` and
  ``tests/test_html_report.py``, run against the port;
- ``CompareAgainstAll.run`` on a two-image PNG corpus through both
  packages: the same corpus rows, scores at the port's tiers (SSIMULACRA2
  rtol 1e-5, DSSIM rtol 1e-5 with atol 1e-5, Butteraugli rtol 5e-4), the
  same Pareto fronts up to ties that tier cannot decide, BD-rates as the
  scores carry them (1e-4);
- ``CodecRegistry`` and ``CompareAgainstAll`` score on the card unless the
  caller asks for the CPU, and the zenjpeg slot, which needs the device
  JPEG encoder, raises instead of being dropped.
"""

import io
import math

import numpy as np
import pytest
import torch

import codec_eval_tpu as jce
import codec_eval_tpu_torch as ce
from codec_eval_tpu_torch.codecs import (
    AvifCodec,
    JpegCodec,
    JpegXlCodec,
    Metric,
    PngCodec,
    ReportGenerator,
    WebPCodec,
    generate_html,
)
from codec_eval_tpu_torch.codecs.html_report import _metrics_with_data
from codec_eval_tpu_torch.engine import EncodeRequest, ImageData
from codec_eval_tpu_torch.engine.report import CodecResult, CorpusReport, ImageReport
from codec_eval_tpu_torch.metrics import MetricResult, PerceptionLevel
from test_torch_corpus_io import assert_jax_code


@pytest.mark.parametrize("name", ["base", "pil_codecs", "jxl", "report", "html_report"])
def test_codec_module_is_the_jax_code(name):
    assert_jax_code(f"codecs.{name}")


def test_codecs_exports_follow_jax_without_the_device_jpeg_codec():
    """The exports are JAX's, the device JPEG codec's included."""
    import codec_eval_tpu.codecs as jc
    import codec_eval_tpu_torch.codecs as tc

    device_jpeg = {"TpuJpegCodec", "decode_jpeg_device", "score_jpeg_files"}
    assert set(tc.__all__) == set(jc.__all__)
    assert all(hasattr(tc, name) for name in device_jpeg)


# -- the cases of tests/test_codec_adapters.py ------------------------------


def _img(n=32):
    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:n, 0:n]
    base = 120 + 50 * np.sin(x / 5.0) + 40 * np.cos(y / 7.0)
    return np.clip(
        np.stack([base, base * 0.9, base * 0.8], -1) + rng.normal(0, 5, (n, n, 3)),
        0, 255,
    ).astype(np.uint8)


@pytest.mark.parametrize(
    "codec",
    [
        JpegCodec("420", True),
        JpegCodec("444", False),
        WebPCodec(),
        AvifCodec(speed=8),
        PngCodec(),
        JpegXlCodec(),
    ],
    ids=lambda c: c.id(),
)
def test_adapter_roundtrip(codec):
    if not codec.is_available():
        pytest.skip(f"{codec.id()} unavailable")
    img = ImageData.rgb8(_img())
    data = codec.encode(img, EncodeRequest(quality=80.0))
    assert len(data) > 0
    decoded = codec.decode(data)
    assert decoded.width == 32 and decoded.height == 32
    # Lossy decode should still be in the neighborhood of the source.
    diff = np.abs(
        decoded.to_rgb8().astype(int) - img.to_rgb8().astype(int)
    ).mean()
    assert diff < 40.0, diff


def test_png_lossless():
    codec = PngCodec()
    img = ImageData.rgb8(_img())
    decoded = codec.decode(codec.encode(img, EncodeRequest(quality=100.0)))
    assert np.array_equal(decoded.to_rgb8(), img.to_rgb8())


def test_quality_affects_size():
    codec = JpegCodec("420", True)
    img = ImageData.rgb8(_img(64))
    low = codec.encode(img, EncodeRequest(quality=30.0))
    high = codec.encode(img, EncodeRequest(quality=95.0))
    assert len(low) < len(high)


def test_avif_presets_distinct():
    presets = AvifCodec.presets()
    ids = [c.id() for c in presets]
    assert len(set(ids)) == len(ids)
    assert any("444" in i for i in ids)


def test_jxl_quality_maps_to_distance_and_size():
    codec = JpegXlCodec()
    if not codec.is_available():
        pytest.skip("libjxl unavailable")
    from codec_eval_tpu_torch.codecs.jxl import quality_to_distance

    # The public cjxl mapping anchors: q90 -> distance 1.0, q100 -> lossless.
    assert quality_to_distance(90.0) == pytest.approx(1.0)
    assert quality_to_distance(100.0) == 0.0
    img = ImageData.rgb8(_img(64))
    low = codec.encode(img, EncodeRequest(quality=40.0))
    high = codec.encode(img, EncodeRequest(quality=95.0))
    assert len(low) < len(high)
    # Decode of externally-produced bytes (the VERDICT item): a .jxl stream
    # from the encoder round-trips through the standalone decode path.
    from codec_eval_tpu_torch.codecs.jxl import decode_jxl

    arr = decode_jxl(high)
    assert arr.shape == (64, 64, 3)
    assert np.abs(arr.astype(int) - img.to_rgb8().astype(int)).mean() < 12.0


def test_jxl_registry_registration():
    from codec_eval_tpu_torch.codecs import CodecRegistry, CompareConfig, FormatSelection

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        config = CompareConfig.new(td).with_formats(
            FormatSelection(jpeg=False, webp=False, avif=False, jpegxl=True)
        )
        registry = CodecRegistry(config, device="cpu")
        registry.register_all()
        assert "jpegxl" in registry.codec_ids()


# -- the cases of tests/test_html_report.py ---------------------------------


def _result(codec, q, bpp, s2, dssim=None, ba=None, psnr=None, level=None):
    return CodecResult(
        codec_id=codec,
        codec_version="1.0",
        quality=q,
        file_size=int(bpp * 512 * 512 / 8),
        bits_per_pixel=bpp,
        encode_time_ms=12,
        decode_time_ms=3,
        metrics=MetricResult(dssim=dssim, ssimulacra2=s2, butteraugli=ba, psnr=psnr),
        perception=level,
    )


@pytest.fixture
def report():
    # Two codecs x 4 qualities (>=4 overlapping points so BD-rate computes),
    # two images; image names exercise HTML escaping and subdir sanitization.
    qs = [50.0, 70.0, 85.0, 95.0]
    images = []
    for name, off in [("kodim<01> & co", 0.0), ("cat-photo", 0.15)]:
        results = []
        for i, q in enumerate(qs):
            s2 = 55 + 10 * i + off
            results.append(
                _result("aaa-jpeg", q, 0.5 + 0.4 * i + off, s2,
                        dssim=0.004 / (i + 1), ba=4.0 - i,
                        psnr=30.0 + 3 * i,
                        level=PerceptionLevel.NOTICEABLE)
            )
            results.append(
                _result("zzz-avif", q, 0.4 + 0.3 * i + off, s2 + 4,
                        dssim=0.003 / (i + 1), ba=3.5 - i,
                        psnr=31.0 + 3 * i,
                        level=PerceptionLevel.SUBTLE)
            )
        images.append(
            ImageReport(name=name, width=512, height=512,
                        uncompressed_size=512 * 512 * 3, results=results)
        )
    return CorpusReport(name="synthetic & <corpus>", images=images,
                        config_summary="q50-95, 2 codecs")


def test_generate_html_content(report):
    html_doc = generate_html(report)
    # Self-contained document with escaped strings everywhere.
    assert html_doc.startswith("<!DOCTYPE html>")
    assert "synthetic &amp; &lt;corpus&gt;" in html_doc
    assert "kodim&lt;01&gt; &amp; co" in html_doc
    assert "<b>" not in html_doc
    # Stat tiles reflect the corpus shape.
    assert ">2</div>" in html_doc  # 2 images / 2 codecs tiles
    assert ">16</div>" in html_doc  # 16 results
    # All four metrics have data -> four metric sections with inline SVG.
    for metric in Metric:
        assert f"<h2>{metric.value.upper()}</h2>" in html_doc
    assert html_doc.count("<svg") >= 4
    # BD-rate renders for the non-baseline codec; baseline labeled.
    assert "baseline" in html_doc
    assert "%" in html_doc
    # Perception badges use the 3-letter codes.
    assert ">NOT</span>" in html_doc and ">SUB</span>" in html_doc
    # Per-image drilldown exists for both images.
    assert html_doc.count("<details>") == 2


def test_metric_sections_omitted_without_data(report):
    for img in report.images:
        for r in img.results:
            r.metrics.psnr = None
            r.metrics.butteraugli = None
    metrics = _metrics_with_data(report)
    assert Metric.PSNR not in metrics and Metric.BUTTERAUGLI not in metrics
    html_doc = generate_html(report)
    assert "<h2>PSNR</h2>" not in html_doc
    assert "<h2>BUTTERAUGLI</h2>" not in html_doc
    assert "<h2>SSIMULACRA2</h2>" in html_doc


def test_report_generator_writes_html(report, tmp_path):
    out = ReportGenerator(tmp_path).generate(report)
    html_path = tmp_path / "report.html"
    assert html_path.exists()
    html_doc = html_path.read_text()
    # The stats table in the HTML matches compute_statistics output.
    stats = out["stats"]
    for c in stats.codecs:
        assert f"{c.avg_bpp:.3f}" in html_doc
        if c.bd_rate_vs_baseline is not None:
            assert math.isfinite(c.bd_rate_vs_baseline)
            assert f"{c.bd_rate_vs_baseline:+.1f}%" in html_doc
    # Pareto points surface with their de-negated metric values.
    front = out["pareto"]
    assert len(front.points) >= 1
    for p in front.points[:3]:
        assert f"{p.bpp:.3f}" in html_doc


def test_empty_report_renders():
    html_doc = generate_html(CorpusReport(name="empty"))
    assert "<h1>empty</h1>" in html_doc
    assert "<svg" not in html_doc


# -- the registry and CompareAgainstAll through both packages ---------------

COMPARE_QUALITIES = [40.0, 60.0, 80.0, 95.0]
TIERS = {
    "ssimulacra2": dict(rtol=1e-5, atol=0.0),
    "dssim": dict(rtol=1e-5, atol=1e-5),
    "butteraugli": dict(rtol=5e-4, atol=0.0),
}


def _pil_jpeg_444(pkg):
    """The subject codec: PIL JPEG at 4:4:4 with its own quality scale."""
    from PIL import Image

    def encode(image, request):
        buf = io.BytesIO()
        Image.fromarray(image.to_rgb8()).save(buf, "JPEG", quality=int(request.quality * 0.9),
                                              subsampling=0)
        return buf.getvalue()

    def decode(data):
        return pkg.ImageData.rgb8(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))

    return encode, decode


@pytest.fixture(scope="module")
def compared(tmp_path_factory):
    """One ``CompareAgainstAll.run`` per package on the same two PNGs, the
    subject against the four PIL JPEG variants (``same_format_only`` on
    format "jpeg"; registered as callbacks, so both packages decode them
    with PIL)."""
    from PIL import Image

    import codec_eval_tpu.codecs as jc
    import codec_eval_tpu_torch.codecs as tc

    root = tmp_path_factory.mktemp("compare")
    corpus = root / "corpus"
    corpus.mkdir()
    Image.fromarray(_img(32)).save(corpus / "img1.png")
    Image.fromarray(np.ascontiguousarray(_img(32)[::-1, ::-1])).save(corpus / "img2.png")
    out = {}
    for name, codecs, pkg, kw in (("jax", jc, jce, {}), ("port", tc, ce, {"device": "cpu"})):
        encode, decode = _pil_jpeg_444(pkg)
        result = (codecs.CompareAgainstAll("subject-jpeg", "1.0", **kw)
                  .with_encode(encode).with_decode(decode).with_format("jpeg")
                  .same_format_only().on_corpus(corpus).output_to(root / name)
                  .with_quality_levels(COMPARE_QUALITIES).run())
        out[name] = result
    return root, out


def _result_rows(result):
    return [(img.name, r) for img in result.corpus_report.images for r in img.results]


def _points(result):
    from codec_eval_tpu_torch.codecs.report import extract_rd_points

    return {(p.codec, p.quality_setting, p.bpp, p.image): p.quality
            for p in extract_rd_points(result.corpus_report, Metric.SSIMULACRA2)}


def _assert_fronts_agree(got, want):
    """The Pareto fronts agree up to ties that the scores' tier cannot
    decide: the port's front is the JAX Pareto code's on the port's points,
    and no point of either front is dominated, in either package's scores,
    by a point better in quality by more than the tier."""
    import codec_eval_tpu.stats as jst

    key = lambda p: (p.codec, p.quality_setting, p.bpp, p.image)  # noqa: E731
    front = [key(p) for p in got.pareto.points]
    jax_front = jst.ParetoFront.compute([jst.RDPoint(*k[:2], k[2], q, image=k[3])
                                         for k, q in _points(got).items()])
    assert sorted(front) == sorted(key(p) for p in jax_front.points)
    tol = TIERS["ssimulacra2"]["rtol"]
    fronts = set(front) | {key(p) for p in want.pareto.points}
    for scores in (_points(got), _points(want)):
        for k in fronts:
            assert not any(o[2] <= k[2] and q > scores[k] + tol * abs(scores[k])
                           for o, q in scores.items()), k
    shared = set(front) & {key(p) for p in want.pareto.points}
    assert len(shared) >= len(front) - 2


def test_compare_against_all_equals_jax(compared):
    root, out = compared
    got, want = out["port"], out["jax"]
    assert got.subject_codec == want.subject_codec == "subject-jpeg"
    assert got.corpus_report.codec_ids() == want.corpus_report.codec_ids() == [
        "jpeg-420-base", "jpeg-420-prog", "jpeg-444-base", "jpeg-444-prog", "subject-jpeg"]
    assert len(_result_rows(got)) == len(_result_rows(want)) == 2 * 5 * 4
    for (name, r), (jname, j) in zip(_result_rows(got), _result_rows(want)):
        assert (name, r.codec_id, r.quality, r.file_size) == (jname, j.codec_id, j.quality,
                                                              j.file_size)
        assert r.metrics.psnr is None and j.metrics.psnr is None  # the perceptual set
        for metric, tol in TIERS.items():
            np.testing.assert_allclose(getattr(r.metrics, metric), getattr(j.metrics, metric),
                                       err_msg=metric, **tol)
    _assert_fronts_agree(got, want)
    jpegs = {"jpeg-420-prog", "jpeg-420-base", "jpeg-444-prog", "jpeg-444-base"}
    assert set(got.bd_rates) == set(want.bd_rates) == jpegs
    # The same BD-rate code on the port's rows gives the port's BD-rates...
    import codec_eval_tpu.codecs as jc

    assert jc.CompareAgainstAll("subject-jpeg", "1.0")._compute_bd_rates(
        got.corpus_report) == got.bd_rates
    # ... and against JAX's rows they differ only as the scores do: the
    # cubic fit of log-rate over a few SSIMULACRA2 points amplifies the
    # scores' 1e-5 tier to at most ~6e-5 here (measured on the CPU).
    for codec in jpegs:
        assert math.isfinite(got.bd_rates[codec])
        assert got.bd_rates[codec] == pytest.approx(want.bd_rates[codec], rel=1e-4)
    assert got.subject_on_pareto() == want.subject_on_pareto()
    for name in ("pareto.svg", "stats.json", "pareto.json", "report.html"):
        assert (root / "port" / name).is_file(), name


def test_compare_against_all_needs_callbacks_and_a_corpus(tmp_path):
    from codec_eval_tpu_torch.codecs import CompareAgainstAll
    from codec_eval_tpu_torch.errors import CodecEvalError

    with pytest.raises(CodecEvalError, match="encode/decode"):
        CompareAgainstAll("x", "1", device="cpu").run()
    with pytest.raises(CodecEvalError, match="corpus path"):
        CompareAgainstAll("x", "1", device="cpu").with_encode(id).with_decode(id).run()


def test_registry_zenjpeg_waits_for_the_device_jpeg_ladder(tmp_path):
    """The zenjpeg slot registers tpujpeg's eight presets, as JAX's does,
    on the registry's device; selections without it register none."""
    import codec_eval_tpu.codecs as jc
    from codec_eval_tpu_torch.codecs import (
        CodecRegistry,
        CompareConfig,
        FormatSelection,
        TpuJpegCodec,
    )

    for formats, jformats in ((FormatSelection.all(), jc.FormatSelection.all()),
                              (FormatSelection.jpeg_only(), jc.FormatSelection.jpeg_only()),
                              (FormatSelection(zenjpeg=True), jc.FormatSelection(zenjpeg=True))):
        registry = CodecRegistry(CompareConfig.new(tmp_path).with_formats(formats), device="cpu")
        want = jc.CodecRegistry(jc.CompareConfig.new(tmp_path / "jax").with_formats(jformats))
        assert registry.register_all() == want.register_all()
        assert registry.codec_ids() == want.codec_ids()
        tpujpeg = [c for c in registry.codecs if isinstance(c, TpuJpegCodec)]
        assert len(tpujpeg) == 8 and {c.device for c in tpujpeg} == {"cpu"}
    registry = CodecRegistry(CompareConfig.new(tmp_path).with_formats(FormatSelection.next_gen()),
                             device="cpu")
    assert registry.register_all() == len(registry.codec_ids()) > 0
    assert not any(i.startswith("tpujpeg") for i in registry.codec_ids())


def test_registry_evaluates_and_writes_like_jax(tmp_path):
    """WebP through both registries.  (JPEG adapters, which both sessions
    decode on their devices, are compared in ``test_torch_ladder.py``.)"""
    import codec_eval_tpu.codecs as jc
    import codec_eval_tpu_torch.codecs as tc

    reports = {}
    for name, codecs, kw in (("jax", jc, {}), ("port", tc, {"device": "cpu"})):
        cfg = codecs.CompareConfig.new(tmp_path / name).with_quality_levels([50.0, 90.0])
        registry = codecs.CodecRegistry(cfg, **kw)
        assert registry.register_codec(codecs.WebPCodec())
        assert not registry.register_codec(codecs.jpegli_stub())
        assert [c.id() for c in registry.skipped] == ["jpegli"]
        pkg = jce if name == "jax" else ce
        image = pkg.ImageData.rgb8(_img(32))
        report = registry.evaluate_image("img", image)
        registry.write_image_report(report)
        corpus = pkg.CorpusReport(name="reg", images=[report])
        registry.write_corpus_report(corpus)
        reports[name] = report
        assert registry.session.codec_count == 1 and registry.session._codecs[0].impl is not None
        assert (tmp_path / name / "reg.csv").is_file()
    got, want = reports["port"], reports["jax"]
    assert [r.file_size for r in got.results] == [r.file_size for r in want.results]
    for r, j in zip(got.results, want.results):
        for metric, tol in TIERS.items():
            np.testing.assert_allclose(getattr(r.metrics, metric), getattr(j.metrics, metric),
                                       err_msg=metric, **tol)


def test_registry_and_compare_default_to_the_card(monkeypatch, tmp_path):
    from codec_eval_tpu_torch.codecs import CodecRegistry, CompareAgainstAll, CompareConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CodecRegistry(CompareConfig.new(tmp_path))
    assert CompareAgainstAll("x", "1").device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert CodecRegistry(CompareConfig.new(tmp_path)).session._scorer.device == torch.device(
        "cuda")
