"""The PyTorch port's Butteraugli against the JAX package, its goldens and
the committed libjxl oracle scores.

- K2/K3/K4 plain versions (the CPU path of each kernel wrapper) against the
  Pallas kernels run in interpret mode, as tests/test_pallas_freqsep.py and
  tests/test_pallas_malta.py run them;
- batch scores against the JAX ``butteraugli_batch`` at rtol=5e-4, a bound
  that covers only FIR summation order (the port's renormalized FIRs
  against the JAX CPU path's dense row-normalized operators);
- the per-stage goldens at atol=1e-4, rtol=1e-5;
- the libjxl oracle fixture at median <= 0.5%, p90 <= 2%, max <= 8%.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import butteraugli as jba
from codec_eval_tpu.kernels.color import srgb_u8_to_linear as jax_to_linear
from codec_eval_tpu.kernels.pallas.freqsep import bands_batch_pallas, opsin_xyb_batch_pallas
from codec_eval_tpu.kernels.pallas.malta import malta_ac_batch_pallas
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
from codec_eval_tpu_torch.kernels.cuda import freqsep as tfs
from codec_eval_tpu_torch.kernels.cuda import malta as tml

GOLDENS = Path(__file__).parent / "goldens"
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(1, 48, 64), (2, 37, 53)]


def _lin_scaled(seed, shape):
    b, h, w = shape
    return (np.random.default_rng(seed).random((b, 3, h, w)) * 80.0).astype(np.float32)


def _xyb_lf(seed, shape):
    lin = jnp.asarray(_lin_scaled(seed, shape))
    xyb = jax.vmap(jba._opsin_dynamics)(lin)
    lf = jax.vmap(lambda p: jba._blur(p, jba.SIGMA_LF))(xyb)
    return np.asarray(xyb), np.asarray(lf)


@pytest.mark.parametrize("shape", SHAPES)
def test_opsin_plain_matches_pallas(shape):
    lin = _lin_scaled(31, shape)
    want = np.asarray(opsin_xyb_batch_pallas(jnp.asarray(lin), jba._OPSIN_CONSTS, interpret=True))
    got = tfs.opsin_xyb_batch(torch.from_numpy(lin), tba._OPSIN_CONSTS).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    assert tfs.opsin_xyb_batch.launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_bands_plain_matches_pallas(shape):
    xyb, lf = _xyb_lf(32, shape)
    want = np.asarray(
        bands_batch_pallas(jnp.asarray(xyb), jnp.asarray(lf), jba._BAND_CONSTS, interpret=True)
    )
    got = tfs.bands_batch(torch.from_numpy(xyb), torch.from_numpy(lf), tba._BAND_CONSTS).numpy()
    assert got.shape == want.shape
    for i, name in enumerate(["uhf_x", "uhf_y", "hf_x", "hf_y", "mf_x", "mf_y", "mf_b"]):
        np.testing.assert_allclose(got[:, i], want[:, i], err_msg=name, **KERNEL_TOL)
    assert tfs.bands_batch.launches == 0


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 37, 53)])
def test_malta_plain_matches_pallas(shape):
    b, h, w = shape
    diffs = np.random.default_rng(33).normal(0.0, 1.0, (b, 6, h, w)).astype(np.float32)
    want = np.asarray(
        malta_ac_batch_pallas(
            jnp.asarray(diffs), jba._MALTA_LINES_FULL, jba._MALTA_LINES_LF, interpret=True
        )
    )
    got = tml.malta_ac_batch(
        torch.from_numpy(diffs), tba._MALTA_LINES_FULL, tba._MALTA_LINES_LF
    ).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    assert tml.malta_ac_batch.launches == 0


def _images(seed, h, w, n):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    ref = np.clip(base + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    noise = rng.integers(-18, 19, (n, h, w, 3))
    return ref, np.clip(ref[None].astype(int) + noise, 0, 255).astype(np.uint8)


def _jlin(u8):
    return jnp.moveaxis(jax_to_linear(jnp.asarray(u8)), -1, -3)


def _tlin(u8):
    return torch.movedim(srgb_u8_to_linear(torch.from_numpy(u8)), -1, -3).contiguous()


@pytest.mark.parametrize("hw", [(37, 53)])
def test_batch_scores_match_jax(hw):
    h, w = hw
    ref, cands = _images(34, h, w, 2)
    jref = jba.precompute_butteraugli_reference(jnp.asarray(ref))
    want = np.asarray(jax.jit(lambda b: jba.butteraugli_batch(jref, b))(jnp.asarray(cands)))
    tref = tba.precompute_butteraugli_reference(_tlin(ref))
    got = tba.butteraugli_batch(tref, _tlin(cands)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert tref.pi0_sub is not None  # 19x27: the half-resolution pass runs


def test_small_images_score_zero_and_skip_half_resolution():
    ref, cands = _images(35, 7, 20, 1)
    tref = tba.precompute_butteraugli_reference(_tlin(ref))
    assert float(tba.butteraugli_batch(tref, _tlin(cands))[0]) == 0.0
    ref, _ = _images(35, 15, 20, 1)  # half side 8x10: both >= 8 -> runs
    assert tba.precompute_butteraugli_reference(_tlin(ref)).pi0_sub is not None
    ref, _ = _images(35, 14, 20, 1)  # half side 7: skipped
    assert tba.precompute_butteraugli_reference(_tlin(ref)).pi0_sub is None


@pytest.fixture(scope="module")
def ba_golden():
    return np.load(GOLDENS / "ba_stages.npz")


def _close(actual, expected):
    np.testing.assert_allclose(actual, expected, atol=1e-4, rtol=1e-5)


def test_ba_stages_golden(ba_golden):
    it = 80.0
    lin0 = _tlin(ba_golden["ref_u8"])[None] * it
    lin1 = _tlin(ba_golden["dist_u8"])[None] * it
    xyb0 = tfs.opsin_xyb_batch(lin0, tba._OPSIN_CONSTS)
    xyb1 = tfs.opsin_xyb_batch(lin1, tba._OPSIN_CONSTS)
    _close(xyb0[0].numpy(), ba_golden["xyb0"])
    _close(xyb1[0].numpy(), ba_golden["xyb1"])
    pi0 = tba._psycho_batch(lin0)
    for band in ("uhf", "hf", "mf", "lf"):
        _close(getattr(pi0, band)[0].numpy(), ba_golden[f"pi0_{band}"])


def _jax_psycho(u8):
    """The JAX reference's psycho image (its CPU formulation, which wrote
    the goldens), as the port's PsychoImage with a batch axis of 1."""
    lin = jnp.moveaxis(jax_to_linear(jnp.asarray(u8)), -1, 0) * jnp.float32(80.0)
    pi = jba._separate_frequencies(jba._opsin_dynamics(lin))
    return tba.PsychoImage(
        *(torch.from_numpy(np.array(getattr(pi, b)))[None] for b in ("uhf", "hf", "mf", "lf"))
    )


def test_ba_malta_and_mask_stages_golden(ba_golden):
    """Each stage on the reference output of the stage before it: the
    Malta accumulators and the masks amplify the ~1e-6 difference between
    the port's renormalized FIRs and the JAX CPU path's dense operators."""
    pi0 = _jax_psycho(ba_golden["ref_u8"])
    pi1 = _jax_psycho(ba_golden["dist_u8"])
    stacks = tba._malta_diffs_stack(tba._index(pi0, 0), pi1, 0.8)
    malta = tml.malta_ac_batch(stacks, tba._MALTA_LINES_FULL, tba._MALTA_LINES_LF)
    _close(malta[0].numpy(), ba_golden["malta_ac"])
    b0, mask_y, mask_dc_y = tba._mask_pre_of(tba._index(pi0, 0))
    _close(mask_y.numpy(), ba_golden["mask_y"])
    _close(mask_dc_y.numpy(), ba_golden["mask_dc_y"])
    _close(tba._mask_diff_ac_batch(pi1, b0)[0].numpy(), ba_golden["mask_diff_ac"])
    dmap = tba._diffmap_psycho(
        tba._index(pi0, 0), pi1, 0.8, 1.0, malta, (b0, mask_y, mask_dc_y),
        tba._mask_diff_ac_batch(pi1, b0),
    )
    assert dmap.shape == (1,) + ba_golden["distmap"].shape


def test_ba_score_golden(ba_golden):
    tref = tba.precompute_butteraugli_reference(_tlin(ba_golden["ref_u8"]))
    score = float(tba.butteraugli_batch(tref, _tlin(ba_golden["dist_u8"][None]))[0])
    assert score == pytest.approx(float(ba_golden["score"]), abs=1e-4)


def test_libjxl_oracle_gates():
    fx = np.load(GOLDENS / "butteraugli_oracle.npz")
    bases, ridx, dists, gold = fx["bases"], fx["ref_index"], fx["dists"], fx["gold"]
    ours = np.zeros(len(gold))
    for r in np.unique(ridx):
        idx = np.flatnonzero(ridx == r)
        tref = tba.precompute_butteraugli_reference(_tlin(bases[r]))
        ours[idx] = tba.butteraugli_batch(tref, _tlin(dists[idx])).numpy()
    rel = np.abs(ours - gold) / np.maximum(gold, 1e-9)
    assert np.median(rel) <= 0.005
    assert np.quantile(rel, 0.9) <= 0.02
    assert rel.max() <= 0.08
