"""The PyTorch port's colour, PSNR and blur functions against the JAX package.

Both sides see the same numpy inputs, made from a seed; tolerance
rtol=1e-5, atol=1e-6 (f32 rounding of pow/cbrt and summation order).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import blur as jblur
from codec_eval_tpu.kernels import color as jcolor
from codec_eval_tpu.kernels.psnr import psnr as jax_psnr
from codec_eval_tpu_torch.kernels import blur as tblur
from codec_eval_tpu_torch.kernels import color as tcolor
from codec_eval_tpu_torch.kernels import psnr as tpsnr

SHAPES = [(48, 64), (37, 53)]
TOL = dict(rtol=1e-5, atol=1e-6)
GOLDENS = Path(__file__).parent / "goldens"


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES)
def test_srgb_u8_to_linear_matches_jax(shape):
    img = _u8(1, shape + (3,))
    want = np.asarray(jcolor.srgb_u8_to_linear(jnp.asarray(img)))
    got = tcolor.srgb_u8_to_linear(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_linear_rgb_to_xyb_matches_jax(shape):
    lin = np.random.default_rng(2).random(shape + (3,)).astype(np.float32)
    want = np.asarray(jcolor.linear_rgb_to_xyb(jnp.asarray(lin)))
    got = tcolor.linear_rgb_to_xyb(torch.from_numpy(lin)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_xyb_roundtrip_matches_jax(shape):
    img = _u8(3, shape + (3,))
    want = np.asarray(jcolor.xyb_roundtrip(jnp.asarray(img))).astype(np.int16)
    got = tcolor.xyb_roundtrip(torch.from_numpy(img)).numpy().astype(np.int16)
    # A u8 result: the only allowed difference is one code at a rounding tie.
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 1e-3


@pytest.mark.parametrize("shape", SHAPES)
def test_psnr_matches_jax(shape):
    a, b = _u8(4, (3,) + shape), _u8(5, (3,) + shape)
    want = float(jax_psnr(jnp.asarray(a), jnp.asarray(b)))
    got = float(tpsnr.psnr(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(want, rel=1e-5)
    assert float(tpsnr.psnr(torch.from_numpy(a), torch.from_numpy(a))) == np.inf


@pytest.mark.parametrize("sigma", [1.5, 2.7])
def test_gaussian_taps_equal_jax(sigma):
    np.testing.assert_array_equal(tblur.gaussian_taps(sigma), jblur.gaussian_taps(sigma))


@pytest.mark.parametrize("shape", SHAPES)
def test_blur_separable_matches_jax(shape):
    planes = np.random.default_rng(6).random((4,) + shape).astype(np.float32)
    want = np.asarray(jblur.blur_separable(jnp.asarray(planes), 1.5))
    got = tblur.blur_separable(torch.from_numpy(planes), 1.5).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # Leading axes are batch axes: a (2, 2, H, W) stack blurs plane by plane.
    batched = tblur.blur_separable(torch.from_numpy(planes).reshape((2, 2) + shape), 1.5)
    np.testing.assert_array_equal(batched.reshape((4,) + shape).numpy(), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_downscale_by_2_matches_jax(shape):
    planes = np.random.default_rng(7).random((3,) + shape).astype(np.float32)
    want = np.asarray(jblur.downscale_by_2(jnp.asarray(planes)))
    got = tblur.downscale_by_2(torch.from_numpy(planes)).numpy()
    assert got.shape == ((3, (shape[0] + 1) // 2, (shape[1] + 1) // 2))
    np.testing.assert_allclose(got, want, **TOL)


def test_linear_stage_golden():
    golden = np.load(GOLDENS / "ssim2_stages.npz")
    got = tcolor.srgb_u8_to_linear(torch.from_numpy(golden["ref_u8"])).numpy()
    np.testing.assert_allclose(got, golden["linear_ref"], atol=1e-5, rtol=0)
