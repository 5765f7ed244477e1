"""K5, the port's whole-diffmap Malta kernel, against the JAX package.

- ``malta_diffmap_batch`` on CPU tensors (its plain version) against the
  JAX ``_diffmap_fused_batch`` with the Pallas kernel in interpret mode, and
  against the JAX unfused composition (diff stack, XLA sweeps,
  ``_diffmap_psycho``), at rtol=1e-5, atol=1e-5, the JAX package's own
  tolerance between the two (tests/test_malta_fused_epilogue.py);
- the size route: K5 takes the diffmap of planes of 1400 px and more, and
  with both route thresholds lowered to 16 the port's Butteraugli and its
  all-metric ``BatchScorer`` still match the JAX package's at the tiers of
  ROADMAP.md.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import codec_eval_tpu as jce
import codec_eval_tpu_torch as port
from codec_eval_tpu.kernels import butteraugli as jba
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
from codec_eval_tpu_torch.kernels.cuda import WRAPPERS
from codec_eval_tpu_torch.kernels.cuda import blur as tbl
from codec_eval_tpu_torch.kernels.cuda import malta as tml

DIFFMAP_TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = {
    "ssimulacra2": dict(rtol=1e-5, atol=1e-4),
    "dssim": dict(rtol=1e-5, atol=1e-4),
    "psnr": dict(rtol=1e-5, atol=0.0),
    "butteraugli": dict(rtol=5e-4, atol=0.0),
}


def _pi(seed, h, w, batch=None):
    """Random band planes, as tests/test_malta_fused_epilogue.py makes them."""
    r = np.random.default_rng(seed)

    def f(c):
        shape = (batch, c, h, w) if batch else (c, h, w)
        return r.normal(0.0, 1.0, shape).astype(np.float32)

    return {"uhf": f(2), "hf": f(2), "mf": f(3), "lf": f(3)}


def _jpi(d):
    return jba.PsychoImage(**{k: jnp.asarray(v) for k, v in d.items()})


def _tpi(d):
    return tba.PsychoImage(**{k: torch.from_numpy(v) for k, v in d.items()})


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 37, 53)])
def test_diffmap_plain_matches_pallas_and_unfused(shape):
    b, h, w = shape
    pi0, pi1 = _pi(1, h, w), _pi(2, h, w, batch=b)
    jpi0, jpi1 = _jpi(pi0), _jpi(pi1)
    a, xmul = 0.8, 1.0
    mask_pre = jba._mask_pre_of(jpi0)
    dac = jba._mask_diff_ac_batch(jpi1, mask_pre[0])

    fused = np.asarray(jba._diffmap_fused_batch(jpi0, jpi1, a, xmul, mask_pre, dac, interpret=True))
    stacks = jax.vmap(lambda p1: jba._malta_diffs_stack(jpi0, p1, a))(jpi1)
    ac = jax.vmap(jba._malta_ac_stack_xla)(stacks)
    unfused = np.asarray(
        jax.vmap(
            lambda pi1, acb, d: jba._diffmap_psycho(
                jpi0, pi1, a, xmul, malta_ac=acb, mask_pre=mask_pre, diff_ac=d
            )
        )(jpi1, ac, dac)
    )

    # The same reference masks and candidate term, so K5 is compared alone.
    t_mask = tuple(torch.from_numpy(np.array(m)) for m in mask_pre)
    t_dac = torch.from_numpy(np.array(dac))
    args = tba._fused_diffmap_args(_tpi(pi0), _tpi(pi1), a, xmul, t_mask, t_dac)
    got = tml.malta_diffmap_batch(*args).numpy()
    assert got.shape == (b, h, w)
    np.testing.assert_allclose(got, fused, **DIFFMAP_TOL)
    np.testing.assert_allclose(got, unfused, **DIFFMAP_TOL)
    assert tml.malta_diffmap_batch.launches == 0


def test_fused_constants_equal_jax():
    for a, xmul in ((0.8, 1.0), (1.0, 0.5)):
        assert tba._fused_diffmap_consts(a, xmul) == jba._fused_diffmap_consts(a, xmul)


def test_diffmap_args_round_the_jax_weights_once():
    ch_consts, epi = tba._fused_diffmap_consts(0.8, 1.0)
    ch, ep = tml._diffmap_args(ch_consts, epi)
    assert ch.dtype == ep.dtype == np.float32 and ch.shape == (18,) and ep.shape == (11,)
    assert ep[0] == np.float32(0.8 * epi[0]) and ep[4] == np.float32(epi[4])
    with pytest.raises(ValueError, match="6 channel triples and 11 weights"):
        tml._diffmap_args(ch_consts[:5], epi)


@pytest.mark.parametrize(
    "h,w,routed",
    [(1400, 2000, True), (2048, 2048, True), (1399, 4000, False), (1024, 1024, False)],
)
def test_diffmap_route_is_a_function_of_the_shape(h, w, routed):
    assert tba._fused_diffmap_ok(h, w) is routed


def _images(seed, h, w, n):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
    ref = np.clip(base + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    noise = rng.integers(-18, 19, (n, h, w, 3))
    return ref, np.clip(ref[None].astype(int) + noise, 0, 255).astype(np.uint8)


def _tlin(u8):
    return torch.movedim(srgb_u8_to_linear(torch.from_numpy(u8)), -1, -3).contiguous()


@pytest.fixture
def routed(monkeypatch):
    """Both size thresholds at 16, and a record of every K5 and K6 call."""
    monkeypatch.setattr(tba, "_FUSED_EPI_MIN_SIDE", 16)
    monkeypatch.setattr(tba, "_BLUR_PALLAS_MIN_SIDE", 16)
    seen = []

    def spy(name, fn):
        def call(*args):
            seen.append((name, tuple(args[0].shape[-2:])))
            return fn(*args)

        return call

    monkeypatch.setattr(tba, "malta_diffmap_batch", spy("K5", tml.malta_diffmap_batch))
    monkeypatch.setattr(tba, "blur_batch", spy("K6", tbl.blur_batch))
    for fn in WRAPPERS.values():
        fn.launches = 0
    return seen


def test_routed_butteraugli_matches_jax(routed):
    ref, cands = _images(34, 37, 53, 2)
    jref = jba.precompute_butteraugli_reference(jnp.asarray(ref))
    want = np.asarray(jax.jit(lambda b: jba.butteraugli_batch(jref, b))(jnp.asarray(cands)))
    tref = tba.precompute_butteraugli_reference(_tlin(ref))
    got = tba.butteraugli_batch(tref, _tlin(cands)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4)
    assert routed == [("K6", (37, 53)), ("K5", (37, 53)), ("K6", (19, 27)), ("K5", (19, 27))]
    assert all(fn.launches == 0 for fn in WRAPPERS.values())


def test_routed_batch_scorer_matches_jax(routed):
    ref, cands = _images(36, 48, 64, 3)
    cands[2] = ref  # the byte-identical candidate scores exactly
    want = jce.BatchScorer(jce.MetricConfig.all()).score_batch(ref, cands)
    got = port.BatchScorer(port.MetricConfig.all(), device="cpu").score_batch(ref, cands)
    for metric, tol in SCORE_TOL.items():
        g = np.array([getattr(r, metric) for r in got], np.float64)
        w = np.array([getattr(r, metric) for r in want], np.float64)
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=metric)
        np.testing.assert_allclose(g[finite], w[finite], err_msg=metric, **tol)
    assert got[2].butteraugli == 0.0 and got[2].ssimulacra2 == 100.0
    assert {name for name, _ in routed} == {"K5", "K6"}
    assert all(fn.launches == 0 for fn in WRAPPERS.values())
