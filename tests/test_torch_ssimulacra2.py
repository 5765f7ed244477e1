"""The PyTorch port's SSIMULACRA2 against the JAX package and its goldens.

K1's plain version (``scale_features_plain``, the CPU path of the kernel
wrapper) is held to the JAX ``_scale_features`` at rtol=1e-5, atol=1e-6;
scores to the JAX batch scorer at rtol=1e-5, atol=1e-4; the per-stage
goldens at 1e-5.  The feature weights are one cached tensor per (device,
dtype), and the golden pair's batch and masked scores are bit for bit
those of weights built anew in every call.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels.blur import blur_separable as jax_blur
from codec_eval_tpu.kernels.ssimulacra2 import _scale_features as jax_scale_features
from codec_eval_tpu.kernels.ssimulacra2 import precompute_reference as jax_precompute
from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2_batch as jax_batch
from codec_eval_tpu_torch.kernels import masked as tm
from codec_eval_tpu_torch.kernels import ssimulacra2_weights as W
from codec_eval_tpu_torch.kernels.cuda import scale_features as tsf

ts2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")

GOLDEN = Path(__file__).parent / "goldens" / "ssim2_stages.npz"
SHAPES = [(48, 64), (37, 53)]


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    h, w = shape
    base = (np.linspace(0, 200, w)[None, :, None] + np.linspace(0, 40, h)[:, None, None])
    ref = np.clip(base + rng.integers(0, 50, (h, w, 3)), 0, 255).astype(np.uint8)
    noise = rng.integers(-20, 21, (2, h, w, 3))
    cands = np.clip(ref[None].astype(int) + noise, 0, 255).astype(np.uint8)
    return ref, cands


@pytest.mark.parametrize("shape", SHAPES)
def test_scale_features_plain_matches_jax(shape):
    rng = np.random.default_rng(11)
    h, w = shape
    xyb1 = rng.random((3, h, w)).astype(np.float32)
    xyb2 = (xyb1 + 0.05 * rng.standard_normal((3, h, w))).astype(np.float32)
    mu1 = np.asarray(jax_blur(jnp.asarray(xyb1), 1.5))
    s11 = np.asarray(jax_blur(jnp.asarray(xyb1 * xyb1), 1.5))
    want = np.asarray(
        jax_scale_features(*(jnp.asarray(a) for a in (xyb1, mu1, s11, xyb2)))
    )
    t = [torch.from_numpy(np.array(a)) for a in (xyb1, mu1, s11, xyb2)]
    got = tsf.scale_features_plain(*t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # The wrapper on CPU tensors takes the plain version and launches nothing.
    batched = tsf.scale_features_batch(t[0], t[1], t[2], t[3][None]).numpy()
    np.testing.assert_array_equal(batched[0], got)
    assert tsf.scale_features_batch.launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_pyramid_matches_jax(shape):
    ref, _ = _pair(12, shape)
    want = jax_precompute(jnp.asarray(ref))
    got = ts2.precompute_reference(torch.from_numpy(ref))
    for s in range(ts2.NUM_SCALES):
        for a, b in ((got.xyb, want.xyb), (got.mu, want.mu), (got.sqblur, want.sqblur)):
            np.testing.assert_allclose(a[s].numpy(), np.asarray(b[s]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_scores_match_jax_batch(shape):
    ref, cands = _pair(13, shape)
    cands = np.concatenate([cands, ref[None]])  # the last is byte-identical
    want = np.asarray(
        jax.jit(jax_batch)(jnp.asarray(ref), jnp.asarray(cands))
    )
    pre = ts2.precompute_reference(torch.from_numpy(ref))
    got = ts2.ssimulacra2_batch_pre(pre, torch.from_numpy(ref), torch.from_numpy(cands)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert got[-1] == 100.0
    assert np.all(got[:-1] < 100.0)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_pyramid_stages_golden(golden):
    ref = ts2.precompute_reference(torch.from_numpy(golden["ref_u8"]))
    for s in range(ts2.NUM_SCALES):
        for name, planes in (("xyb", ref.xyb), ("mu", ref.mu), ("sqblur", ref.sqblur)):
            np.testing.assert_allclose(
                planes[s].numpy(), golden[f"{name}_s{s}"], atol=1e-5, rtol=0, err_msg=name
            )


def test_features_and_score_golden(golden):
    ref_u8 = torch.from_numpy(golden["ref_u8"])
    dist = torch.from_numpy(golden["dist_u8"])
    ref = ts2.precompute_reference(ref_u8)
    lin = torch.movedim(ts2.srgb_u8_to_linear(dist), -1, 0)
    feats = []
    for s in range(ts2.NUM_SCALES):
        if s:
            lin = ts2.downscale_by_2(lin)
        xyb2 = ts2._to_positive_xyb(lin)
        feats.append(ts2._scale_features(ref.xyb[s], ref.mu[s], ref.sqblur[s], xyb2))
    flat = torch.stack(feats, dim=1).reshape(-1)
    np.testing.assert_allclose(flat.numpy(), golden["features"], atol=1e-5, rtol=0)
    score = float(ts2.score_from_features(flat))
    assert score == pytest.approx(float(golden["score"]), abs=1e-3)
    batch = ts2.ssimulacra2_batch_pre(ref, ref_u8, dist[None])
    assert float(batch[0]) == pytest.approx(float(golden["score"]), abs=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_feature_weights_are_one_cached_tensor_per_device_and_dtype(dtype):
    cpu = torch.device("cpu")
    weights = ts2._weights(cpu, dtype)
    assert ts2._weights(cpu, dtype) is weights
    assert weights.dtype == dtype and weights.device == cpu
    assert torch.equal(weights, torch.as_tensor(W.WEIGHTS_V21, dtype=dtype))
    other = torch.float64 if dtype == torch.float32 else torch.float32
    assert ts2._weights(cpu, other) is not weights


@pytest.mark.parametrize("path", ["batch", "masked"])
def test_cached_weights_leave_the_scores_bit_for_bit(golden, monkeypatch, path):
    ref, dist = golden["ref_u8"], golden["dist_u8"]

    def score():
        if path == "batch":
            ref_u8 = torch.from_numpy(ref)
            return ts2.ssimulacra2_batch_pre(ts2.precompute_reference(ref_u8), ref_u8,
                                             torch.from_numpy(dist)[None])
        pad = [torch.from_numpy(tm.pad_to_bucket(x, 128, 96))[None] for x in (ref, dist)]
        return tm.ssimulacra2_masked_batch(*pad, [ref.shape[:2]])

    cached = score()
    monkeypatch.setattr(ts2, "_weights", lambda device, dtype: torch.as_tensor(
        W.WEIGHTS_V21, dtype=dtype, device=device))
    fresh = score()
    assert cached.item() < 100.0 and torch.equal(cached, fresh)
