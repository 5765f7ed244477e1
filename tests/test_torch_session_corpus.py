"""The port's corpus session and report types against the JAX package.

- the cases of ``tests/test_session_corpus.py`` and the session, report and
  ``ImageData`` cases of ``tests/test_engine.py``, run against the port on
  the CPU;
- ``evaluate_corpus`` and ``write_corpus_report`` through both packages on
  the same 3 images x 2 callback codecs x 3 qualities, one cell failing:
  sizes, rows, errors, progress messages, ``cache_dir`` artifacts and the
  CSV's layout equal; scores at the port's tiers (SSIMULACRA2 and PSNR
  rtol 1e-5, DSSIM rtol 1e-5 with atol 1e-5, Butteraugli rtol 5e-4); the
  JSON back through ``from_json``;
- ``engine/report.py`` and ``engine/image.py`` are the JAX files' code.
"""

import csv
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

import codec_eval_tpu as jce
import codec_eval_tpu_torch as ce
from codec_eval_tpu_torch import (
    EvalConfig,
    EvalSession,
    ImageData,
    MetricConfig,
    MetricResult,
    PerceptionLevel,
)
from codec_eval_tpu_torch.engine.report import (
    CSV_COLUMNS,
    CodecResult,
    CorpusReport,
    ImageReport,
    write_json,
)
from codec_eval_tpu_torch.errors import CodecError
from test_torch_corpus_io import assert_jax_code

TIERS = {
    "ssimulacra2": dict(rtol=1e-5, atol=0.0),
    "psnr": dict(rtol=1e-5, atol=0.0),
    "dssim": dict(rtol=1e-5, atol=1e-5),
    "butteraugli": dict(rtol=5e-4, atol=0.0),
}
# The CSV's score columns and the decimals it writes them with.
CSV_DECIMALS = {"dssim": 6, "ssimulacra2": 2, "butteraugli": 4, "psnr": 2}


@pytest.mark.parametrize("module", ["engine.report", "engine.image"])
def test_engine_module_is_the_jax_code(module):
    assert_jax_code(module)


# -- the cases of tests/test_session_corpus.py ------------------------------


def _img(seed=0, n=24):
    return np.random.default_rng(seed).integers(0, 256, (n, n, 3)).astype(np.uint8)


def _identity_session(tmp_path, cache=False):
    b = EvalConfig.builder().report_dir(tmp_path).metrics(MetricConfig.fast()).quality_levels([80])
    if cache:
        b = b.cache_dir(tmp_path / "cache")
    session = EvalSession(b.build(), device="cpu")
    session.add_codec_with_decode(
        "identity", "1.0",
        lambda img, req: img.to_rgb8().tobytes(),
        lambda data: ImageData.rgb_slice(data, 24, 24),
    )
    return session


def test_evaluate_corpus_pipeline(tmp_path):
    session = _identity_session(tmp_path)
    items = [(f"img{i}", ImageData.rgb8(_img(i))) for i in range(3)]
    seen = []
    report = session.evaluate_corpus(items, name="demo", progress=seen.append)
    assert len(report.images) == 3
    assert report.codec_ids() == ["identity"]
    assert seen == [f"[{i}/3] img{i - 1} OK" for i in (1, 2, 3)]
    assert session.evaluate_corpus([], name="empty").images == []


def test_evaluate_corpus_skip_and_continue(tmp_path):
    session = _identity_session(tmp_path)

    def flaky_encode(img, req):
        if img.to_rgb8()[0, 0, 0] % 2 == 1:
            raise CodecError("identity", "simulated failure")
        return img.to_rgb8().tobytes()

    session._codecs[0].encode = flaky_encode
    items = [(f"img{i}", ImageData.rgb8(_img(i))) for i in range(4)]
    failing = [im.to_rgb8()[0, 0, 0] % 2 == 1 for _, im in items]
    assert any(failing) and not all(failing)
    report = session.evaluate_corpus(items, on_error="skip")
    assert len(report.images) == len(items)
    for img_report, failed in zip(report.images, failing):
        assert len(img_report.results) == 1
        assert (img_report.results[0].metrics.psnr is not None) == (not failed)
    with pytest.raises(CodecError):
        session.evaluate_corpus(items, on_error="raise")


def test_per_cell_failure_keeps_other_codec(tmp_path):
    session = _identity_session(tmp_path)

    def broken_decode(data):
        raise CodecError("broken", "decode exploded")

    session.add_codec_with_decode(
        "broken", "0.0", lambda img, req: img.to_rgb8().tobytes(), broken_decode
    )
    report = session.evaluate_image("img0", ImageData.rgb8(_img(0)), on_error="skip")
    by_codec = {r.codec_id: r for r in report.results}
    assert set(by_codec) == {"identity", "broken"}
    assert by_codec["identity"].metrics.psnr is not None
    assert by_codec["broken"].metrics.psnr is None
    assert by_codec["broken"].file_size == 0
    with pytest.raises(CodecError):
        session.evaluate_image("img0", ImageData.rgb8(_img(0)))


def test_cache_dir_writes_artifacts(tmp_path):
    session = _identity_session(tmp_path, cache=True)
    assert session.config.cache_dir == tmp_path / "cache"
    report = session.evaluate_image("x", ImageData.rgb8(_img()))
    r = report.results[0]
    p = Path(r.cached_path)
    assert p == tmp_path / "cache" / "x-identity-q80.bin"
    assert p.read_bytes() == _img().tobytes() and p.stat().st_size == r.file_size


def test_eval_config_fields_follow_jax():
    """``cache_dir`` is the second field, so positional construction means
    the same in both packages."""
    import dataclasses

    port_fields = [f.name for f in dataclasses.fields(EvalConfig)]
    jax_fields = [f.name for f in dataclasses.fields(jce.EvalConfig)]
    assert port_fields[:2] == jax_fields[:2] == ["report_dir", "cache_dir"]
    assert port_fields == jax_fields
    assert EvalConfig(Path("r"), Path("c")).cache_dir == Path("c")


def test_xyb_roundtrip_config_path():
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    dist = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255).astype(np.uint8)
    plain = ce.evaluate_single(ref, dist, MetricConfig(ssimulacra2=True), device="cpu")
    xyb = ce.evaluate_single(ref, dist, MetricConfig(ssimulacra2=True, xyb_roundtrip=True),
                             device="cpu")
    assert plain.ssimulacra2 != xyb.ssimulacra2
    assert abs(plain.ssimulacra2 - xyb.ssimulacra2) < 20.0


# -- the session, report and ImageData cases of tests/test_engine.py --------


def _image(w=32, h=32):
    return np.random.default_rng(11).integers(0, 256, (h, w, 3)).astype(np.uint8)


def test_image_data_variants():
    arr = _image(8, 4)
    img = ImageData.rgb8(arr)
    assert img.width == 8 and img.height == 4
    assert np.array_equal(img.to_rgb8(), arr)
    assert img.to_rgb8_vec() == arr.tobytes()
    assert img.color_profile().is_srgb

    rgba = np.concatenate([arr, np.full((4, 8, 1), 255, np.uint8)], axis=2)
    img = ImageData.rgba8(rgba)
    assert np.array_equal(img.to_rgb8(), arr)  # alpha dropped
    assert np.array_equal(ImageData.rgba_slice(rgba.tobytes(), 8, 4).data, rgba)

    img = ImageData.rgb_slice(arr.tobytes(), 8, 4)
    assert np.array_equal(img.to_rgb8(), arr)

    img = ImageData.rgb_slice_with_icc(arr.tobytes(), 8, 4, b"fake-icc")
    assert img.icc_profile == b"fake-icc"
    assert not img.color_profile().is_srgb
    with pytest.raises(ce.errors.ImageLoadError):
        ImageData(arr.astype(np.float32))


def test_session_encode_only_codec(tmp_path):
    config = (EvalConfig.builder().report_dir(tmp_path).metrics(MetricConfig.fast())
              .quality_levels([50, 80]).build())
    session = EvalSession(config, device="cpu")
    session.add_codec("fake", "1.0", lambda img, req: b"\x00" * 100)
    assert session.codec_count == 1

    report = session.evaluate_image("test", ImageData.rgb8(_image()))
    assert len(report.results) == 2
    r = report.results[0]
    assert r.file_size == 100
    assert r.bits_per_pixel == pytest.approx(100 * 8 / (32 * 32))
    assert r.compression_ratio(32 * 32 * 3) == pytest.approx(30.72)
    assert r.metrics.psnr is None
    assert r.perception is None


def test_session_identity_codec_json_csv(tmp_path):
    config = (EvalConfig.builder().report_dir(tmp_path).metrics(MetricConfig.fast())
              .quality_levels([80]).build())
    session = EvalSession(config, device="cpu")
    session.add_codec_with_decode(
        "identity", "1.0",
        lambda img, req: img.to_rgb8().tobytes(),
        lambda data: ImageData.rgb_slice(data, 32, 32),
    )
    report = session.evaluate_image("demo", ImageData.rgb8(_image()))
    assert report.results[0].metrics.psnr > 1e6

    session.write_image_report(report)
    d = json.loads((tmp_path / "demo.json").read_text())
    assert set(d) == {"name", "source_path", "width", "height", "uncompressed_size",
                      "results", "timestamp"}
    r0 = d["results"][0]
    assert set(r0) == {"codec_id", "codec_version", "quality", "file_size", "bits_per_pixel",
                       "encode_time", "decode_time", "metrics", "perception", "cached_path",
                       "codec_params"}
    assert set(r0["metrics"]) == {"dssim", "ssimulacra2", "butteraugli", "psnr"}

    corpus = CorpusReport(name="corpus_demo")
    corpus.images.append(report)
    session.write_corpus_report(corpus)
    with open(tmp_path / "corpus_demo.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == CSV_COLUMNS and len(CSV_COLUMNS) == 13
    assert len(rows) == 2
    assert rows[1][0] == "demo" and rows[1][1] == "identity"
    assert rows[1][3] == "80"  # integral quality rendered without decimals
    assert corpus.total_results() == 1
    assert corpus.codec_ids() == ["identity"]
    assert json.loads((tmp_path / "corpus_demo.json").read_text())["name"] == "corpus_demo"


def test_report_queries():
    report = ImageReport(name="x", width=10, height=10)
    for size, dssim in [(1000, 0.001), (500, 0.005), (2000, 0.0005)]:
        report.results.append(CodecResult(
            codec_id="c", codec_version="1", quality=80.0, file_size=size,
            bits_per_pixel=size * 8 / 100, encode_time_ms=1, decode_time_ms=1,
            metrics=MetricResult(dssim=dssim), perception=None,
        ))
    report.results.append(CodecResult(
        codec_id="d", codec_version="1", quality=80.0, file_size=0, bits_per_pixel=0.0,
        encode_time_ms=0, decode_time_ms=None, metrics=MetricResult(), perception=None,
    ))
    assert report.best_at_size(1500).file_size == 1000  # lowest dssim <= 1500
    assert report.best_at_size(100).codec_id == "d"  # unscored, the only one that fits
    assert report.smallest_at_quality(0.002).file_size == 1000
    assert report.smallest_at_quality(0.0001) is None
    assert [r.file_size for r in report.results_for_codec("c")] == [1000, 500, 2000]
    assert report.results_for_codec("e") == []
    assert report.uncompressed_size == 300
    assert report.results[-1].compression_ratio(300) == 0.0


def test_json_inf_clamped(tmp_path):
    report = ImageReport(name="inf", width=4, height=4)
    report.results.append(CodecResult(
        codec_id="c", codec_version="1", quality=80.0, file_size=10, bits_per_pixel=5.0,
        encode_time_ms=0, decode_time_ms=None, metrics=MetricResult(psnr=float("inf")),
        perception=None,
    ))
    write_json(report, tmp_path / "inf.json")
    d = json.loads((tmp_path / "inf.json").read_text())
    assert d["results"][0]["metrics"]["psnr"] == 1e308
    assert ImageReport.from_json(d).results[0].metrics.psnr == 1e308


def test_arbitrary_codec_exception_becomes_codec_error_and_skips(tmp_path):
    img = ImageData.rgb8(np.full((32, 32, 3), 128, np.uint8))

    def bad_encode(image, request):
        raise ValueError("third-party blowup")

    cfg = (EvalConfig.builder().report_dir(tmp_path).metrics(MetricConfig.fast())
           .quality_levels([50.0]).build())
    session = EvalSession(cfg, device="cpu")
    session.add_codec("bad", "1", bad_encode)
    with pytest.raises(CodecError, match="third-party blowup"):
        session.evaluate_image("x", img)
    report = session.evaluate_corpus([("x", img)], on_error="skip")
    rows = [r for ir in report.images for r in ir.results]
    assert len(rows) == 1 and rows[0].metrics.ssimulacra2 is None


def test_codec_impl_registration_keeps_the_adapter(tmp_path):
    from codec_eval_tpu_torch.codecs import PngCodec

    session = EvalSession(EvalConfig.builder().report_dir(tmp_path).build(), device="cpu")
    png = PngCodec()
    session.add_codec_impl(png)
    assert session.codec_count == 1
    entry = session._codecs[0]
    assert (entry.id, entry.version, entry.impl) == (png.id(), png.version(), png)


def test_corpus_report_from_json_round_trip():
    d = {
        "name": "c", "timestamp": "2026-01-01T00:00:00+00:00", "config_summary": "s",
        "images": [{
            "name": "i", "width": 4, "height": 2, "results": [{
                "codec_id": "x", "codec_version": "1", "quality": 50.5, "file_size": 3,
                "bits_per_pixel": 3.0, "encode_time": 2, "decode_time": None,
                "metrics": {"dssim": 0.01, "ssimulacra2": None, "butteraugli": 1.5,
                            "psnr": 30.0},
                "perception": "Noticeable", "cached_path": "p", "codec_params": {"k": "v"},
            }],
        }],
    }
    report = CorpusReport.from_json(d)
    r = report.images[0].results[0]
    assert r.perception == PerceptionLevel.NOTICEABLE
    assert report.images[0].uncompressed_size == 24
    again = report.to_json()
    again["images"][0].pop("uncompressed_size")
    again["images"][0].pop("source_path")
    again["images"][0].pop("timestamp")
    assert again == d


# -- evaluate_corpus through both packages ----------------------------------

QUALITIES = [20.0, 45.0, 70.0]
N = 32


def _shift_codec(pkg):
    """Keep the top bits of every sample, fewer at lower quality."""
    def encode(image, request):
        shift = int(round((100.0 - request.quality) / 25.0))
        kept = (image.to_rgb8() >> shift).astype(np.uint8)
        return bytes([shift]) + zlib.compress(kept.tobytes())

    def decode(data):
        shift = data[0]
        kept = np.frombuffer(zlib.decompress(data[1:]), np.uint8).reshape(N, N, 3)
        return pkg.ImageData.rgb8(((kept.astype(np.uint16) << shift) + ((1 << shift) >> 1))
                                  .astype(np.uint8))

    return encode, decode


def _step_codec(pkg):
    """Uniform quantization in steps of 2..16 code values; raises on the
    second image at q45, so one cell of the corpus fails."""
    def encode(image, request):
        rgb = image.to_rgb8()
        if request.quality == 45.0 and int(rgb[0, 0, 0]) == FAILING_PIXEL:
            raise ValueError("simulated encoder crash")
        step = 2 * max(1, int((100.0 - request.quality) / 10.0))
        return bytes([step]) + zlib.compress((rgb // step).astype(np.uint8).tobytes())

    def decode(data):
        step = data[0]
        q = np.frombuffer(zlib.decompress(data[1:]), np.uint8).reshape(N, N, 3)
        return pkg.ImageData.rgb8(np.clip(q.astype(int) * step + step // 2, 0, 255)
                                  .astype(np.uint8))

    return encode, decode


def _corpus_images():
    out = []
    for seed in (3, 4, 5):
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[0:N, 0:N]
        base = np.stack([x * 255 // N, y * 255 // N, (x + y) * 255 // (2 * N)], -1)
        out.append(np.clip(base + rng.integers(0, 40, (N, N, 3)), 0, 255).astype(np.uint8))
    return out


IMAGES = _corpus_images()
FAILING_PIXEL = int(IMAGES[1][0, 0, 0])
assert FAILING_PIXEL not in (int(IMAGES[0][0, 0, 0]), int(IMAGES[2][0, 0, 0]))


def _run(pkg, root: Path, **kwargs):
    config = (pkg.EvalConfig.builder().report_dir(root / "reports").cache_dir(root / "cache")
              .metrics(pkg.MetricConfig.all()).quality_levels(QUALITIES).build())
    session = pkg.EvalSession(config, **kwargs)
    session.add_codec_with_decode("shift", "1.0", *_shift_codec(pkg))
    session.add_codec_with_decode("step", "2.1", *_step_codec(pkg))
    seen = []
    items = [(f"img{i}", pkg.ImageData.rgb8(a)) for i, a in enumerate(IMAGES)]
    report = session.evaluate_corpus(items, name="both", progress=seen.append)
    session.write_corpus_report(report)
    errors = [e["error"] for e in session._stage_image("img1", items[1][1], on_error="skip")]
    return report, seen, errors


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return (root / "jax", _run(jce, root / "jax")), (root / "port", _run(ce, root / "port",
                                                                         device="cpu"))


def _rows(report):
    return [(img.name, r) for img in report.images for r in img.results]


def test_corpus_rows_equal_jax(both):
    (_, (jrep, jseen, jerr)), (_, (rep, seen, err)) = both
    assert seen == jseen == [f"[{i}/3] img{i - 1} OK" for i in (1, 2, 3)]
    assert err == jerr
    assert [e is None for e in err] == [True] * 4 + [False] + [True]
    assert err[4] == "codec 'step': encode failed at q45: ValueError: simulated encoder crash"
    assert (rep.name, rep.codec_ids(), rep.total_results()) == ("both", ["shift", "step"], 18)
    assert len(_rows(rep)) == len(_rows(jrep))
    for (name, r), (jname, j) in zip(_rows(rep), _rows(jrep)):
        assert (name, r.codec_id, r.codec_version, r.quality, r.file_size, r.bits_per_pixel,
                r.codec_params) == (jname, j.codec_id, j.codec_version, j.quality, j.file_size,
                                    j.bits_per_pixel, j.codec_params)
        assert (r.perception is None) == (j.perception is None)
        assert (r.cached_path is None) == (j.cached_path is None)
    failed = [(name, r) for name, r in _rows(rep) if r.file_size == 0]
    assert [(name, r.codec_id, r.quality) for name, r in failed] == [("img1", "step", 45.0)]
    r = failed[0][1]
    assert r.metrics == MetricResult() and r.perception is None and r.cached_path is None
    assert r.decode_time_ms is None and r.encode_time_ms == 0


def test_corpus_scores_match_jax(both):
    (_, (jrep, _, _)), (_, (rep, _, _)) = both
    for metric, tol in TIERS.items():
        got = np.array([getattr(r.metrics, metric) for _, r in _rows(rep)], dtype=float)
        want = np.array([getattr(r.metrics, metric) for _, r in _rows(jrep)], dtype=float)
        assert np.isnan(got).sum() == 1  # the failed cell, None
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], err_msg=metric, **tol)
    assert [r.perception and r.perception.value for _, r in _rows(rep)] == [
        r.perception and r.perception.value for _, r in _rows(jrep)
    ]


def test_cache_dir_artifacts_equal_jax(both):
    (jroot, (jrep, _, _)), (root, (rep, _, _)) = both
    files = sorted(p.name for p in (root / "cache").iterdir())
    assert files == sorted(p.name for p in (jroot / "cache").iterdir())
    assert len(files) == 17 and "img1-step-q45.bin" not in files
    assert "img0-shift-q20.bin" in files
    for name in files:
        assert (root / "cache" / name).read_bytes() == (jroot / "cache" / name).read_bytes()
    for _, r in _rows(rep):
        if r.cached_path is not None:
            assert Path(r.cached_path).stat().st_size == r.file_size


def _csv(root):
    with open(root / "reports" / "both.csv", newline="") as f:
        return list(csv.reader(f))


def test_corpus_csv_equals_jax(both):
    (jroot, (jrep, _, _)), (root, _) = both
    rows, jrows = _csv(root), _csv(jroot)
    assert rows[0] == jrows[0] == CSV_COLUMNS
    assert len(rows) == len(jrows) == 19
    col = {name: i for i, name in enumerate(CSV_COLUMNS)}
    timing = {"encode_ms", "decode_ms"}
    for row, jrow, (_, j) in zip(rows[1:], jrows[1:], _rows(jrep)):
        assert len(row) == 13
        for name in CSV_COLUMNS:
            if name in timing or name in CSV_DECIMALS:
                continue
            assert row[col[name]] == jrow[col[name]], name
        assert (row[col["decode_ms"]] == "") == (jrow[col["decode_ms"]] == "")
        for name, decimals in CSV_DECIMALS.items():
            want = getattr(j.metrics, name)
            if want is None:
                assert row[col[name]] == jrow[col[name]] == ""
                continue
            # The written value is the port's score rounded to the column's
            # decimals: within the tier of JAX's score plus half a step.
            tol = TIERS[name]
            slack = tol["rtol"] * abs(want) + tol["atol"] + 0.5 * 10.0 ** -decimals
            assert abs(float(row[col[name]]) - want) <= slack + 1e-12, name


def test_corpus_json_round_trips(both):
    (jroot, _), (root, (rep, _, _)) = both
    written = json.loads((root / "reports" / "both.json").read_text())
    back = CorpusReport.from_json(written)
    assert back == rep
    assert back.to_json() == written
    jwritten = json.loads((jroot / "reports" / "both.json").read_text())
    assert set(written) == set(jwritten)
    assert [set(i) for i in written["images"]] == [set(i) for i in jwritten["images"]]
    assert CorpusReport.from_json(jwritten).total_results() == back.total_results()
