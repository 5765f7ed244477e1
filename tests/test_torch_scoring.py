"""The PyTorch port's BatchScorer and EvalSession against the JAX package.

The same reference and candidates (one of them byte-identical to the
reference) go through the JAX ``BatchScorer`` and the port's, on the CPU.
Tolerances: SSIMULACRA2 and PSNR rtol=1e-5; DSSIM rtol=1e-5, atol=1e-5
(the JAX package's f32 rounding of ``1/ssim - 1``; against its f64 form the
port's DSSIM holds at rtol=1e-6);
Butteraugli rtol=5e-4, a bound that covers only FIR summation order (the
port's renormalized FIRs against the JAX CPU path's dense operators).  The
JAX reference precompute is also carried into the port through
``interop.references_from_numpy``, so the candidate side is compared alone.
"""

import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import codec_eval_tpu as jce
import codec_eval_tpu_torch as port
from codec_eval_tpu.engine.scoring import _build_chunk_scorer, _build_precompute
from codec_eval_tpu_torch import interop
from codec_eval_tpu_torch.engine.scoring import fetch_scores, metric_config, score_chunk
from codec_eval_tpu_torch.kernels import dssim as td

H, W = 48, 64
TOL = {
    "ssimulacra2": dict(rtol=1e-5, atol=0.0),
    "dssim": dict(rtol=1e-5, atol=1e-5),
    "psnr": dict(rtol=1e-5, atol=0.0),
    "butteraugli": dict(rtol=5e-4, atol=0.0),
}


def _reference(seed=41):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([x * 255 // W, y * 255 // H, (x + y) * 255 // (H + W)], -1)
    base[:, W // 2 :] = 255 - base[:, W // 2 :]  # an edge
    return np.clip(base + rng.integers(0, 30, (H, W, 3)), 0, 255).astype(np.uint8)


def _candidates(ref, seed=42):
    rng = np.random.default_rng(seed)
    soft = np.clip(ref.astype(int) + rng.integers(-6, 7, ref.shape), 0, 255)
    hard = np.clip((ref.astype(int) // 24) * 24 + 12, 0, 255)
    return np.stack([soft, hard, ref]).astype(np.uint8)  # the last is identical


def _assert_scores(got: dict, want: dict, n: int):
    for metric, tol in TOL.items():
        g, w = np.asarray(got[metric][:n], np.float64), np.asarray(want[metric][:n], np.float64)
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=metric)
        np.testing.assert_allclose(g[finite], w[finite], err_msg=metric, **tol)


def _columns(results):
    return {m: [getattr(r, m) for r in results] for m in TOL}


@pytest.fixture(scope="module")
def pair():
    ref = _reference()
    return ref, _candidates(ref)


@pytest.fixture(scope="module")
def jax_results(pair):
    ref, cands = pair
    return _columns(jce.BatchScorer(jce.MetricConfig.all()).score_batch(ref, cands))


def test_batch_scorer_matches_jax(pair, jax_results):
    ref, cands = pair
    got = _columns(port.BatchScorer(port.MetricConfig.all(), device="cpu").score_batch(ref, cands))
    _assert_scores(got, jax_results, len(cands))
    # The byte-identical candidate scores exactly, on both sides.
    assert got["ssimulacra2"][2] == 100.0 == jax_results["ssimulacra2"][2]
    assert got["dssim"][2] == 0.0 == jax_results["dssim"][2]
    assert got["butteraugli"][2] == 0.0 == jax_results["butteraugli"][2]
    assert got["psnr"][2] == np.inf
    assert got["ssimulacra2"][0] > got["ssimulacra2"][1]
    assert got["butteraugli"][0] < got["butteraugli"][1]


def test_dssim_matches_jax_in_f64(pair):
    """The scorer's three pairs through the port's DSSIM and the JAX
    package's run in f64: the f32 gap above is JAX's own rounding."""
    from test_torch_dssim import _lin, jax_dssim_x64

    ref, cands = pair
    got = td.dssim_against_reference(td.precompute_dssim_reference(_lin(ref)), _lin(cands))
    want = jax_dssim_x64(ref, cands)
    assert want[2] == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_jax_reference_through_interop(pair):
    """One reference precompute (the JAX package's) for both chunk scorers."""
    ref, cands = pair
    pre = _build_precompute(H, W, True, True, True, False)(jnp.asarray(ref))
    pre_np = jax.tree_util.tree_map(np.asarray, pre)
    planar = np.ascontiguousarray(np.moveaxis(cands, -1, 1))
    chunk = _build_chunk_scorer(H, W, len(cands), True, True, True, True, planar=True)
    want = {k: np.asarray(v) for k, v in chunk(pre, jnp.asarray(planar)).items()}
    config = port.MetricConfig.all()
    got = fetch_scores(
        score_chunk(interop.references_from_numpy(pre_np, device="cpu"),
                    torch.from_numpy(planar), config)
    )
    assert sorted(got) == sorted(want)
    _assert_scores(got, want, len(cands))


def test_metric_config_takes_the_scorer_names_and_rejects_others():
    """The one metric vocabulary of the scorer's callers (the device ladder,
    ``score_jpeg_files``): each name of ``METRICS`` turns on its metric."""
    assert metric_config(("psnr", "ssimulacra2")) == port.MetricConfig(psnr=True, ssimulacra2=True)
    assert metric_config(port.engine.scoring.METRICS) == port.MetricConfig.all()
    with pytest.raises(ValueError, match=r"unknown metrics \['ssim2'\]"):
        metric_config(("ssimulacra2", "ssim2"))

def test_scorer_caches_reference_by_content(pair):
    ref, cands = pair
    scorer = port.BatchScorer(port.MetricConfig.all(), device="cpu")
    first = scorer.precompute(ref)
    assert scorer.precompute(ref.copy()) is first
    changed = ref.copy()
    changed[0, 0, 0] ^= 1
    assert scorer.precompute(changed) is not first
    with pytest.raises(ValueError, match="do not match"):
        scorer.score_batch(ref, cands[:, :-1])
    assert scorer.score_batch(ref, cands[:0]) == []


def _encode(image, request):
    """A lossy host codec: keep the top bits of every sample, fewer at lower
    quality; the bytes are the zlib-compressed kept values."""
    shift = int(round((100.0 - request.quality) / 25.0))
    kept = (image.to_rgb8() >> shift).astype(np.uint8)
    header = np.array([shift, kept.shape[0], kept.shape[1]], np.uint16).tobytes()
    return header + zlib.compress(kept.tobytes())


def _decode_with(image_cls):
    def decode(data):
        shift, h, w = (int(v) for v in np.frombuffer(data[:6], np.uint16))
        kept = np.frombuffer(zlib.decompress(data[6:]), np.uint8).reshape(h, w, 3)
        return image_cls.rgb8(((kept.astype(np.uint16) << shift) + ((1 << shift) >> 1)).astype(np.uint8))

    return decode


def _session(ce, tmp_path, qualities, **kwargs):
    config = (
        ce.EvalConfig.builder().report_dir(tmp_path).metrics(ce.MetricConfig.all())
        .quality_levels(qualities).build()
    )
    session = ce.EvalSession(config, **kwargs)
    session.add_codec_with_decode("shift", "1", _encode, _decode_with(ce.ImageData))
    return session


def test_session_report_matches_jax(pair, tmp_path):
    ref, _ = pair
    qualities = [25.0, 75.0, 100.0]
    jreport = _session(jce, tmp_path / "jax", qualities).evaluate_image(
        "img", jce.ImageData.rgb8(ref)
    )
    session = _session(port, tmp_path / "port", qualities, device="cpu")
    report = session.evaluate_image("img", port.ImageData.rgb8(ref))
    session.write_image_report(report)
    assert [r.file_size for r in report.results] == [r.file_size for r in jreport.results]
    got = _columns([r.metrics for r in report.results])
    want = _columns([r.metrics for r in jreport.results])
    _assert_scores(got, want, len(qualities))
    assert [r.perception.name for r in report.results] == [
        r.perception.name for r in jreport.results
    ]
    written = json.loads((tmp_path / "port" / "img.json").read_text())
    assert set(written) == set(jreport.to_json())
    assert set(written["results"][0]) == set(jreport.to_json()["results"][0])
    assert written["results"][2]["metrics"]["ssimulacra2"] == 100.0


def test_session_wraps_callback_errors(pair, tmp_path):
    ref, _ = pair

    def broken(image, request):
        if request.quality < 50:
            raise OSError("disk full")
        return _encode(image, request)

    config = port.EvalConfig.builder().report_dir(tmp_path).quality_levels([25, 75]).build()
    session = port.EvalSession(config, device="cpu")
    session.add_codec_with_decode("broken", "1", broken, _decode_with(port.ImageData))
    with pytest.raises(port.CodecError, match="encode failed at q25: OSError: disk full"):
        session.evaluate_image("img", port.ImageData.rgb8(ref))
    report = session.evaluate_image("img", port.ImageData.rgb8(ref), on_error="skip")
    assert report.results[0].metrics.ssimulacra2 is None
    assert report.results[0].perception is None
    assert report.results[1].metrics.ssimulacra2 is not None

    def wrong_size(data):
        return port.ImageData.rgb8(np.zeros((H // 2, W, 3), np.uint8))

    session = port.EvalSession(config, device="cpu")
    session.add_codec_with_decode("resizer", "1", _encode, wrong_size)
    with pytest.raises(port.DimensionMismatch):
        session.evaluate_image("img", port.ImageData.rgb8(ref))
