"""K6, the port's batched border-renormalized blur, against the JAX package.

- ``blur_batch`` on CPU tensors (its plain version: a zero-padded FIR times
  the reciprocal plane) against ``blur_batch_pallas`` in interpret mode and
  the JAX ``_blur`` (a dense row-normalized operator product), at the shapes
  and sigmas of tests/test_pallas_blur.py, rtol=2e-5, atol=2e-4: the FIR
  and the operator product add the same terms in another order;
- the size route: K6 takes the candidate's mask blur on planes of 1024 px
  and more, for filters of at most 16 taps, and with the threshold lowered
  the routed Butteraugli scores still match the JAX package's at 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import butteraugli as jba
from codec_eval_tpu.kernels.pallas.blur import blur_batch_pallas
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
from codec_eval_tpu_torch.kernels.cuda import blur as tbl

BLUR_TOL = dict(rtol=2e-5, atol=2e-4)


def _planes(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 80.0).astype(np.float32)


@pytest.mark.parametrize(
    "shape,sigma",
    [
        ((2, 3, 32, 48), jba.SIGMA_LF),
        ((1, 3, 27, 41), jba.SIGMA_LF),
        ((2, 1, 37, 53), jba.SIGMA_MASK),
        ((1, 3, 24, 1030), jba.SIGMA_LF),
        ((1, 1, 17, 653), jba.SIGMA_LF),
    ],
)
def test_blur_plain_matches_pallas_and_operator(shape, sigma):
    planes = _planes(11, shape)
    got = tbl.blur_batch(torch.from_numpy(planes), sigma).numpy()
    want_pallas = np.asarray(blur_batch_pallas(jnp.asarray(planes), sigma, interpret=True))
    want_op = np.asarray(jax.vmap(lambda p: jba._blur(p, sigma))(jnp.asarray(planes)))
    assert got.shape == shape
    np.testing.assert_allclose(got, want_pallas, **BLUR_TOL)
    np.testing.assert_allclose(got, want_op, **BLUR_TOL)
    assert tbl.blur_batch.launches == 0


def test_blur_plain_matches_the_port_operator():
    """The FIR form against the port's own dense operator product."""
    planes = torch.from_numpy(_planes(12, (2, 1, 40, 36)))
    got = tbl.blur_batch(planes, tba.SIGMA_MASK)
    np.testing.assert_allclose(got.numpy(), tba._blur(planes, tba.SIGMA_MASK).numpy(), **BLUR_TOL)


def test_blur_refuses_too_many_taps():
    with pytest.raises(ValueError, match="at most 33 taps"):
        tbl._host_taps(7.6)  # radius 17: 35 taps
    assert len(tbl._host_taps(tba.SIGMA_LF)) == 33
    assert len(tbl._host_taps(tba.SIGMA_MASK)) == 13


@pytest.mark.parametrize(
    "h,w,sigma,routed",
    [
        (1024, 1024, tba.SIGMA_MASK, True),
        (2048, 2048, tba.SIGMA_MASK, True),
        (1024, 4000, tba.SIGMA_MASK, True),
        (1023, 2048, tba.SIGMA_MASK, False),
        (2048, 1023, tba.SIGMA_MASK, False),
        (2048, 2048, tba.SIGMA_LF, False),
        (4096, 4096, tba.SIGMA_LF, False),
    ],
)
def test_blur_route_is_a_function_of_the_shape(h, w, sigma, routed):
    assert tba._blur_batch_ok(h, w, sigma) is routed


def test_route_thresholds_equal_jax():
    assert tba._BLUR_PALLAS_MIN_SIDE == 1024 and tba._BLUR_PALLAS_MAX_TAPS == 16
    assert tba._FUSED_EPI_MIN_SIDE == 1400


def _images(seed, h, w, n):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    ref = np.clip(base + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    noise = rng.integers(-18, 19, (n, h, w, 3))
    return ref, np.clip(ref[None].astype(int) + noise, 0, 255).astype(np.uint8)


def _tlin(u8):
    return torch.movedim(srgb_u8_to_linear(torch.from_numpy(u8)), -1, -3).contiguous()


def test_routed_mask_blur_scores_match_jax(monkeypatch):
    """K6's threshold lowered to 16: at 37x53 the full (37x53) and half
    (19x27) resolution passes both blur the candidate's mask through K6's
    plain version, and the scores still match the JAX package's."""
    monkeypatch.setattr(tba, "_BLUR_PALLAS_MIN_SIDE", 16)
    seen = []

    def spy(planes, sigma):
        seen.append((tuple(planes.shape), sigma))
        return tbl.blur_batch(planes, sigma)

    monkeypatch.setattr(tba, "blur_batch", spy)
    ref, cands = _images(34, 37, 53, 2)
    jref = jba.precompute_butteraugli_reference(jnp.asarray(ref))
    want = np.asarray(jax.jit(lambda b: jba.butteraugli_batch(jref, b))(jnp.asarray(cands)))
    tref = tba.precompute_butteraugli_reference(_tlin(ref))
    got = tba.butteraugli_batch(tref, _tlin(cands)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert seen == [((2, 1, 37, 53), tba.SIGMA_MASK), ((2, 1, 19, 27), tba.SIGMA_MASK)]
    assert tbl.blur_batch.launches == 0
