"""The PyTorch port's DSSIM against the JAX package and its goldens.

Scores at rtol=1e-5, atol=1e-4 (``1/ssim - 1`` amplifies f32 rounding in
the SSIM means); per-stage goldens at 1e-5.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import dssim as jd
from codec_eval_tpu.kernels.color import srgb_u8_to_linear as jax_to_linear
from codec_eval_tpu_torch.kernels import dssim as td
from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear

GOLDEN = Path(__file__).parent / "goldens" / "dssim_stages.npz"
SHAPES = [(48, 64), (37, 53)]


def _lin(img_u8) -> torch.Tensor:
    return torch.movedim(srgb_u8_to_linear(torch.from_numpy(img_u8)), -1, -3)


def _jlin(img_u8):
    return jnp.moveaxis(jax_to_linear(jnp.asarray(img_u8)), -1, -3)


def test_semantic_defaults_match_jax():
    assert td.BLUR_PASSES == jd.DEFAULT_BLUR_PASSES
    assert td.DOWNSCALE == jd.DEFAULT_DOWNSCALE


@pytest.mark.parametrize("shape", SHAPES)
def test_batch_scores_match_jax(shape):
    rng = np.random.default_rng(21)
    h, w = shape
    ref = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    noise = rng.integers(-25, 26, (3, h, w, 3))
    cands = np.clip(ref[None].astype(int) + noise, 0, 255).astype(np.uint8)
    ref_j = jd.precompute_dssim_reference(_jlin(ref))
    one = jax.jit(lambda lin: jd.dssim_against_reference(ref_j, lin))
    want = np.array([float(one(_jlin(c))) for c in cands])
    got = td.dssim_against_reference(td.precompute_dssim_reference(_lin(ref)), _lin(cands))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_stages_golden(golden):
    lin0, lin1 = _lin(golden["ref_u8"]), _lin(golden["dist_u8"])
    lab0 = td._linear_rgb_to_lab_planes(lin0)
    lab1 = td._linear_rgb_to_lab_planes(lin1)
    np.testing.assert_allclose(lab0.numpy(), golden["lab_ref"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(lab1.numpy(), golden["lab_dist"], atol=1e-5, rtol=0)
    ref = td.precompute_dssim_reference(lin0)
    luma_means, chroma_means = [], []
    for s, (luma2, chroma2) in enumerate(td._lab_channel_pyramids(lab1)):
        np.testing.assert_allclose(
            ref.planes[s][0].numpy(), golden[f"ref_luma_s{s}"], atol=1e-5, rtol=0
        )
        np.testing.assert_allclose(
            ref.planes[s][1].numpy(), golden[f"ref_chroma_s{s}"], atol=1e-5, rtol=0
        )
        luma_means.append(td._ssim_means(ref.planes[s][0], ref.mu[s][0], ref.sqblur[s][0], luma2))
        chroma_means.append(
            td._ssim_means(ref.planes[s][1], ref.mu[s][1], ref.sqblur[s][1], chroma2)
        )
    np.testing.assert_allclose(
        torch.stack(luma_means).numpy(), golden["luma_means"], atol=1e-5, rtol=0
    )
    np.testing.assert_allclose(
        torch.stack(chroma_means).numpy(), golden["chroma_means"], atol=1e-5, rtol=0
    )
    score = float(td.dssim_against_reference(ref, lin1))
    assert score == pytest.approx(float(golden["score"]), rel=1e-4)
