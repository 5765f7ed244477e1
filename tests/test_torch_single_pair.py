"""The port's single-pair metric API against the JAX package.

- each ``calculate_*`` with ``device="cpu"`` (the plain versions) against
  the JAX single-pair function that the JAX ``calculate_*`` wraps, jitted,
  at 1e-5 relative for SSIMULACRA2, DSSIM and PSNR and 5e-4 for Butteraugli
  (FIR summation order only), including Butteraugli at 250 nits and the
  sRGB ``_icc`` variants; PSNR against the JAX ``calculate_psnr`` itself.
  DSSIM also takes 1e-5 absolute: the port keeps its Lab planes in f64, and
  the JAX package's f32 SSIM means carry ~1e-5 of cancellation error
  (``kernels/dssim.py`` of the port).
  (The JAX ``calculate_*`` run their functions op by op, which costs tens
  of seconds of compiles per shape on the CPU; jitted, a few.)
- bytes with width/height, 1-D and (H, W, 3[+]) arrays agree; shapes that
  differ raise ``DimensionMismatch``; identical pairs give 100 / 0 / 0 / inf;
- K8's wrapper on CPU tensors is ``scale_features_plain``;
- ``butteraugli_pnorm`` and ``butteraugli_distmap`` against JAX;
- ``butteraugli_batch`` gives what it gave before the single pair shared its
  code (scores recorded from the batch path as it stood then);
- ``rgb8_to_dssim_image`` / ``rgba8_to_dssim_image`` equal JAX's exactly.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.metrics import calculate as jcalc
from codec_eval_tpu_torch import metrics as tm
from codec_eval_tpu_torch.color import ColorProfile
from codec_eval_tpu_torch.errors import DimensionMismatch, MetricCalculationError
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.blur import blur_separable
from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
from codec_eval_tpu_torch.kernels.cuda import WRAPPERS
from codec_eval_tpu_torch.kernels.cuda import scale_features as tsf

jba = importlib.import_module("codec_eval_tpu.kernels.butteraugli")
jds = importlib.import_module("codec_eval_tpu.kernels.dssim")
js2 = importlib.import_module("codec_eval_tpu.kernels.ssimulacra2")
ts2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")

SHAPES = [(24, 24), (37, 53)]
RTOL = {"ssimulacra2": 1e-5, "dssim": 1e-5, "psnr": 1e-5, "butteraugli": 5e-4,
        "butteraugli_250": 5e-4}
ATOL = {"dssim": 1e-5}


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    ref = np.clip(base + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    dist = np.clip(ref.astype(int) + rng.integers(-12, 13, ref.shape), 0, 255).astype(np.uint8)
    return ref, dist


# The function each JAX calculate_* calls, jitted, by metric.
_JAX = {
    "ssimulacra2": jax.jit(js2.ssimulacra2),
    "dssim": jax.jit(jds.dssim_u8),
    "butteraugli": jax.jit(jba.butteraugli),
    "butteraugli_250": jax.jit(lambda r, d: jba.butteraugli(r, d, intensity_target=250.0)),
    "psnr": lambda r, d: jcalc.calculate_psnr(np.asarray(r), np.asarray(d)),
}
_PORT = {
    "ssimulacra2": tm.calculate_ssimulacra2,
    "dssim": tm.calculate_dssim,
    "butteraugli": tm.calculate_butteraugli,
    "butteraugli_250": functools.partial(tm.calculate_butteraugli_with_intensity,
                                         intensity_target=250.0),
    "psnr": tm.calculate_psnr,
}


@functools.lru_cache(maxsize=None)
def _jax_score(metric, shape):
    ref, dist = _pair(*shape)
    return float(_JAX[metric](jnp.asarray(ref), jnp.asarray(dist)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", sorted(_PORT))
def test_calculate_matches_jax(metric, shape):
    for fn in WRAPPERS.values():
        fn.launches = 0
    ref, dist = _pair(*shape)
    got = _PORT[metric](ref, dist, device="cpu")
    assert isinstance(got, float)
    want = _jax_score(metric, shape)
    assert got == pytest.approx(want, rel=RTOL[metric], abs=ATOL.get(metric, 0.0))
    assert all(fn.launches == 0 for fn in WRAPPERS.values())


@pytest.mark.parametrize("metric", ["ssimulacra2", "dssim", "butteraugli"])
def test_srgb_icc_variants_match_jax(metric):
    icc = {"ssimulacra2": tm.calculate_ssimulacra2_icc, "dssim": tm.calculate_dssim_icc,
           "butteraugli": tm.calculate_butteraugli_icc}[metric]
    ref, dist = _pair(*SHAPES[0])
    got = icc(ref, dist, device="cpu")
    srgb = ColorProfile.from_icc_bytes(b"")
    assert srgb.is_srgb
    assert icc(ref, dist, reference_profile=srgb, test_profile=srgb, device="cpu") == got
    assert got == _PORT[metric](ref, dist, device="cpu")
    want = _jax_score(metric, SHAPES[0])
    assert got == pytest.approx(want, rel=RTOL[metric], abs=ATOL.get(metric, 0.0))


def test_non_srgb_profile_needs_a_working_transform():
    ref, dist = _pair(*SHAPES[0])
    with pytest.raises(MetricCalculationError, match="ICC"):
        tm.calculate_ssimulacra2_icc(ref, dist, reference_profile=ColorProfile.icc(b"junk"),
                                     device="cpu")


@pytest.mark.parametrize("fn", [tm.calculate_ssimulacra2, tm.calculate_psnr])
def test_bytes_and_arrays_agree(fn):
    ref, dist = _pair(37, 53)
    want = fn(ref, dist, device="cpu")
    h, w = ref.shape[:2]
    assert fn(ref.tobytes(), dist.tobytes(), w, h, device="cpu") == want
    assert fn(bytearray(ref.tobytes()), memoryview(dist.tobytes()), w, h, device="cpu") == want
    assert fn(ref.reshape(-1), dist.reshape(-1), w, h, device="cpu") == want
    alpha = np.full((h, w, 1), 7, np.uint8)
    assert fn(np.concatenate([ref, alpha], -1), dist, device="cpu") == want
    assert jcalc.calculate_psnr(ref.tobytes(), dist.tobytes(), w, h) == pytest.approx(
        tm.calculate_psnr(ref.tobytes(), dist.tobytes(), w, h, device="cpu"), rel=1e-5
    )
    with pytest.raises(ValueError, match="width and height"):
        fn(ref.tobytes(), dist.tobytes(), device="cpu")


@pytest.mark.parametrize("name", sorted(n for n in tm.calculate.__all__ if "calculate" in n))
def test_dimension_mismatch(name):
    ref, _ = _pair(24, 24)
    _, small = _pair(12, 16)
    with pytest.raises(DimensionMismatch) as err:
        getattr(tm, name)(ref, small, device="cpu")
    assert err.value.expected == (24, 24) and err.value.actual == (16, 12)


def test_identical_pairs_score_exactly():
    ref, _ = _pair(37, 53)
    assert tm.calculate_ssimulacra2(ref, ref.copy(), device="cpu") == 100.0
    assert tm.calculate_dssim(ref, ref.copy(), device="cpu") == 0.0
    assert tm.calculate_butteraugli(ref, ref.copy(), device="cpu") == 0.0
    assert tm.calculate_butteraugli_with_intensity(ref, ref, intensity_target=250.0,
                                                   device="cpu") == 0.0
    assert tm.calculate_psnr(ref, ref, device="cpu") == float("inf")


def test_cuda_without_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, dist = _pair(24, 24)
    for name in ("calculate_ssimulacra2", "calculate_dssim", "calculate_butteraugli",
                 "calculate_psnr"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(tm, name)(ref, dist)


def test_k8_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    xyb1 = torch.from_numpy(rng.random((3, 37, 53), np.float32))
    mu1 = blur_separable(xyb1, tsf.SIGMA)
    s11 = blur_separable(xyb1 * xyb1, tsf.SIGMA)
    xyb2 = xyb1 + 0.05 * torch.from_numpy(rng.random((3, 37, 53), np.float32))
    tsf.scale_features.launches = 0
    got = tsf.scale_features(xyb1, mu1, s11, xyb2)
    assert got.shape == (3, 2, 3)
    assert torch.equal(got, tsf.scale_features_plain(xyb1, mu1, s11, xyb2))
    assert torch.equal(got, tsf.scale_features_batch(xyb1, mu1, s11, xyb2[None])[0])
    assert tsf.scale_features.launches == 0
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        m = torch.device("meta")
        tsf.scale_features(*(torch.empty(3, 16, 16, device=m) for _ in range(4)))


def test_single_pair_ssimulacra2_equals_the_batch():
    ref, dist = _pair(37, 53)
    r, d = torch.from_numpy(ref), torch.from_numpy(dist)
    one = ts2.ssimulacra2(r, d)
    batch = ts2.ssimulacra2_batch(r, torch.stack([d, r]))
    assert float(one) == pytest.approx(float(batch[0]), rel=1e-6)
    assert float(batch[1]) == 100.0


@pytest.mark.parametrize("shape", SHAPES)
def test_butteraugli_distmap_and_pnorm_match_jax(shape):
    ref, dist = _pair(*shape, seed=3)
    r, d = torch.from_numpy(ref), torch.from_numpy(dist)
    want = np.asarray(jax.jit(jba.butteraugli_distmap)(jnp.asarray(ref), jnp.asarray(dist)))
    got = tba.butteraugli_distmap(r, d).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * float(want.max()))
    want_p = float(jax.jit(jba.butteraugli_pnorm)(jnp.asarray(ref), jnp.asarray(dist)))
    assert float(tba.butteraugli_pnorm(r, d)) == pytest.approx(want_p, rel=5e-4)


def test_butteraugli_against_a_precomputed_reference():
    ref, dist = _pair(37, 53, seed=4)
    r, d = torch.from_numpy(ref), torch.from_numpy(dist)
    lin = torch.movedim(srgb_u8_to_linear(r), -1, 0).contiguous()
    pre = tba.precompute_butteraugli_reference(lin)
    assert torch.equal(tba.butteraugli_distmap_against(pre, d), tba.butteraugli_distmap(r, d))
    assert float(tba.butteraugli_against_reference(pre, d)) == float(tba.butteraugli(r, d))
    # hf_asymmetry is taken per call, as in the JAX package.
    skewed = tba.butteraugli_against_reference(pre, d, hf_asymmetry=1.0)
    assert float(skewed) == float(tba.butteraugli(r, d, hf_asymmetry=1.0))
    assert pre.params.hf_asymmetry == 0.8


def test_small_images_give_a_zero_map():
    ref, dist = _pair(7, 20)
    dmap = tba.butteraugli_distmap(torch.from_numpy(ref), torch.from_numpy(dist))
    assert dmap.shape == (7, 20) and float(dmap.abs().max()) == 0.0


def _images(seed, h, w, n):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    ref = np.clip(base + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    noise = rng.integers(-18, 19, (n, h, w, 3))
    return ref, np.clip(ref[None].astype(int) + noise, 0, 255).astype(np.uint8)


def _tlin(u8):
    return torch.movedim(srgb_u8_to_linear(torch.from_numpy(u8)), -1, -3).contiguous()


# butteraugli_batch's scores before the single pair shared its code, on the
# inputs of tests/test_torch_butteraugli.py and tests/test_torch_malta_diffmap.py,
# at the default routes and with both route thresholds lowered to 16.
_BATCH_BEFORE = [
    ((34, 37, 53, 2), False, [3.7536401748657227, 3.2730166912078857]),
    ((34, 37, 53, 2), True, [3.753640651702881, 3.2730166912078857]),
    ((36, 48, 64, 3), False, [3.2908029556274414, 3.435702323913574, 3.8199634552001953]),
    ((36, 48, 64, 3), True, [3.2908029556274414, 3.435702323913574, 3.8199639320373535]),
]


@pytest.mark.parametrize("images,lowered,want", _BATCH_BEFORE)
def test_butteraugli_batch_is_unchanged(images, lowered, want, monkeypatch):
    if lowered:
        monkeypatch.setattr(tba, "_FUSED_EPI_MIN_SIDE", 16)
        monkeypatch.setattr(tba, "_BLUR_PALLAS_MIN_SIDE", 16)
    ref, cands = _images(*images)
    got = tba.butteraugli_batch(tba.precompute_butteraugli_reference(_tlin(ref)), _tlin(cands))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_dssim_images_equal_jax():
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (9, 11, 4), dtype=np.uint8)
    got = tm.rgb8_to_dssim_image(rgb.reshape(-1), 11, 9)
    assert got.dtype == np.float32 and got.shape == (9, 11, 4)
    np.testing.assert_array_equal(got, jcalc.rgb8_to_dssim_image(rgb.reshape(-1), 11, 9))
    np.testing.assert_array_equal(tm.rgba8_to_dssim_image(rgba, 11, 9),
                                  jcalc.rgba8_to_dssim_image(rgba, 11, 9))
