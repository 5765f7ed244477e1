"""K7, the port's fused candidate-side masking kernel, against the JAX package.

- ``mask_diff_ac_batch`` on CPU tensors (its plain version) against the
  Pallas kernel ``mask_diff_ac_batch_pallas`` in interpret mode, on the same
  ``d1`` planes, and against the JAX ``_mask_candidate_side`` from the same
  band planes, at rtol=1e-4, atol=1e-5, the tolerance of
  tests/test_pallas_maskac.py (FIR summation order against the dense
  row-normalized operator);
- the plain version is K6's plain blur followed by the eager epilogue of the
  batch path, bit for bit: on the card K7 is held to that same identity;
- the routes: a single pair's masking term takes K7 at every size, and the
  batch path never does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import butteraugli as jba
from codec_eval_tpu.kernels.pallas.maskac import mask_diff_ac_batch_pallas
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
from codec_eval_tpu_torch.kernels.cuda import WRAPPERS
from codec_eval_tpu_torch.kernels.cuda import blur as tbl
from codec_eval_tpu_torch.kernels.cuda import maskac as tmk

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(2, 48, 64), (1, 37, 53)]


def _bands(seed, b, h, w):
    """Band planes and a reference blur, as tests/test_pallas_maskac.py makes them."""
    rng = np.random.default_rng(seed)
    pi = {k: rng.normal(0, 2, (b, c, h, w)).astype(np.float32)
          for k, c in (("uhf", 2), ("hf", 2), ("mf", 3), ("lf", 3))}
    return pi, rng.normal(0.5, 0.3, (h, w)).astype(np.float32)


def _d1(pi):
    """The diff-precomputed contrast planes, from the JAX package."""
    jpi = jba.PsychoImage(**{k: jnp.asarray(v) for k, v in pi.items()})
    return np.array(
        jax.vmap(lambda p: jba._diff_precompute(jba._combine_channels_for_masking(p)))(jpi)
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    pi, b0 = _bands(11, *shape)
    d1 = _d1(pi)
    want = np.asarray(mask_diff_ac_batch_pallas(
        jnp.asarray(d1), jnp.asarray(b0), jba._MASK_DIFF_AC_MUL, sigma=jba.SIGMA_MASK,
        interpret=True,
    ))
    tmk.mask_diff_ac_batch.launches = 0
    got = tmk.mask_diff_ac_batch(
        torch.from_numpy(d1), torch.from_numpy(b0), tba._MASK_DIFF_AC_MUL, tba.SIGMA_MASK
    ).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, **TOL)
    assert tmk.mask_diff_ac_batch.launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_pair_term_matches_jax_candidate_side(shape):
    pi, b0 = _bands(12, *shape)
    jpi = jba.PsychoImage(**{k: jnp.asarray(v) for k, v in pi.items()})
    want = np.asarray(jax.vmap(lambda p: jba._mask_candidate_side(jnp.asarray(b0), p))(jpi))
    tpi = tba.PsychoImage(**{k: torch.from_numpy(v) for k, v in pi.items()})
    got = tba._mask_diff_ac_pair(tpi, torch.from_numpy(b0)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_is_k6_then_the_eager_epilogue(shape):
    """Bit for bit what the batch path computes when it takes K6."""
    pi, b0 = _bands(13, *shape)
    d1, b0 = torch.from_numpy(_d1(pi)), torch.from_numpy(b0)
    b1 = tbl.blur_batch_plain(d1[:, None], tba.SIGMA_MASK)[:, 0]
    want = tba._MASK_DIFF_AC_MUL * (b0 - b1) * (b0 - b1)
    got = tmk.mask_diff_ac_plain(d1, b0, tba._MASK_DIFF_AC_MUL, tba.SIGMA_MASK)
    assert torch.equal(got, want)


def test_wrapper_checks_its_arguments():
    m = torch.device("meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmk.mask_diff_ac_batch(torch.empty(1, 16, 16, device=m), torch.empty(16, 16, device=m),
                               10.0)
    with pytest.raises(ValueError, match="at most 33 taps"):
        tbl._host_taps(16.0)
    assert tmk.mask_diff_ac_batch.launches == 0


def _lin(u8):
    return torch.movedim(srgb_u8_to_linear(torch.from_numpy(u8)), -1, -3).contiguous()


@pytest.fixture
def spies(monkeypatch):
    """Every K6 and K7 call, by the plane size it blurs."""
    seen = []

    def spy(name, fn):
        def call(*args):
            seen.append((name, tuple(args[0].shape[-2:])))
            return fn(*args)

        return call

    monkeypatch.setattr(tba, "mask_diff_ac_batch", spy("K7", tmk.mask_diff_ac_batch))
    monkeypatch.setattr(tba, "blur_batch", spy("K6", tbl.blur_batch))
    return seen


def test_single_pair_takes_k7_and_the_batch_keeps_its_route(spies, monkeypatch):
    """With K6's size threshold lowered to 16, the batch path blurs with K6
    and the single pair with K7; the two scores are then equal bit for bit."""
    monkeypatch.setattr(tba, "_BLUR_PALLAS_MIN_SIDE", 16)
    rng = np.random.default_rng(14)
    ref = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    dist = np.clip(ref.astype(int) + rng.integers(-20, 21, ref.shape), 0, 255).astype(np.uint8)
    pair = tba.butteraugli(torch.from_numpy(ref), torch.from_numpy(dist))
    assert spies == [("K7", (37, 53)), ("K7", (19, 27))]
    spies.clear()
    pre = tba.precompute_butteraugli_reference(_lin(ref))
    batch = tba.butteraugli_batch(pre, _lin(dist[None]))
    assert spies == [("K6", (37, 53)), ("K6", (19, 27))]
    assert float(pair) == float(batch[0])
    assert all(fn.launches == 0 for fn in WRAPPERS.values())
