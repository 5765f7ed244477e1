"""K9, the SSIM moments of the masked scorer, against the JAX package.

- the plain version (what the wrapper runs on CPU tensors) against JAX's
  ``fused_candidate_moments`` (``pallas/moments.py:136``), which off the
  TPU takes its XLA formulation, as the JAX package's own
  ``tests/test_pallas_moments.py`` runs it: atol 1e-6, the JAX test's own
  tolerance (the same 15 taps in the same order; XLA may fuse the products
  into the first pass);
- a batch of pairs, each with its own x1, against JAX pair by pair;
- x1 given as both inputs gives blur(x1) and blur(x1 * x1), the planes of
  the plain stacked blur, exactly; the one-input reference form
  (``reference_moments_plain``) gives the same two planes bit for bit, and
  agrees with the JAX package's own reference blur
  (``codec_eval_tpu/kernels/masked.py:158``, ``blur_separable`` of
  ``[x1, x1 * x1]``) at the same tolerance;
- on CPU tensors the wrapper is the plain version and launches nothing; on
  any other device it must be a CUDA tensor of the right shape, or it
  raises before touching the library (the kernel itself runs on the card,
  in ``chip_smoke.py``).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels.blur import blur_separable as jax_blur_separable
from codec_eval_tpu.kernels.pallas.moments import fused_candidate_moments
from codec_eval_tpu_torch.kernels import masked as tmk
from codec_eval_tpu_torch.kernels.blur import blur_separable
from codec_eval_tpu_torch.kernels.cuda import WRAPPERS, _lib
from codec_eval_tpu_torch.kernels.cuda import moments as tmo

ATOL = 1e-6
SHAPES = [(3, 64, 96), (3, 37, 53), (1, 3, 67, 653), (3, 3, 29, 41)]


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


def _jax_moments(x1, x2):
    """JAX's three planes, pair by pair for a batch."""
    if x1.ndim == 3:
        return [np.asarray(p) for p in fused_candidate_moments(jnp.asarray(x1), jnp.asarray(x2), 1.5)]
    pairs = [_jax_moments(a, b) for a, b in zip(x1, x2)]
    return [np.stack([p[k] for p in pairs]) for k in range(3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax(shape):
    x1, x2 = _planes(shape, seed=sum(shape))
    got = tmo.candidate_moments_plain(torch.from_numpy(x1), torch.from_numpy(x2))
    for name, g, w in zip(("mu2", "s22", "s12"), got, _jax_moments(x1, x2)):
        assert g.shape == shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 3, 40, 24)], ids=lambda s: "x".join(map(str, s)))
def test_reference_side_is_the_plain_stack(shape):
    x1, _ = _planes(shape, seed=7)
    t = torch.from_numpy(x1)
    mu, s11, s11_again = tmo.candidate_moments_plain(t, t)
    stacked = blur_separable(torch.cat([t, t * t], dim=-3), 1.5)
    assert torch.equal(mu, stacked[..., :3, :, :])
    assert torch.equal(s11, stacked[..., 3:, :, :]) and torch.equal(s11, s11_again)


def test_cpu_route_is_the_plain_version():
    x1, x2 = (torch.from_numpy(a) for a in _planes((2, 3, 33, 47), seed=3))
    tmo.candidate_moments.launches = 0
    got = tmo.candidate_moments(x1, x2)
    want = tmo.candidate_moments_plain(x1, x2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tmo.candidate_moments.launches == 0


def test_cuda_route_requires_cuda_tensors():
    m = torch.device("meta")
    for x1, x2 in (
        (torch.empty(2, 3, 16, 16, device=m), torch.empty(2, 3, 16, 16, device=m)),
        (torch.empty(3, 16, 16, device=m), torch.empty(3, 16, 16, device=m)),
    ):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            tmo.candidate_moments(x1, x2)
    assert tmo.candidate_moments.launches == 0


def _jax_reference(x1):
    """JAX's masked reference side: the blur of ``[x1, x1 * x1]``, pair by
    pair for a batch."""
    if x1.ndim == 3:
        pre = np.asarray(jax_blur_separable(jnp.concatenate([x1, x1 * x1], axis=0), 1.5))
        return [pre[:3], pre[3:]]
    pairs = [_jax_reference(a) for a in x1]
    return [np.stack([p[k] for p in pairs]) for k in range(2)]


@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 3, 40, 24)], ids=lambda s: "x".join(map(str, s)))
def test_reference_form_is_the_candidate_form_with_x1_twice(shape):
    x1, _ = _planes(shape, seed=11)
    t = torch.from_numpy(x1)
    mu, s11 = tmo.reference_moments_plain(t)
    want = tmo.candidate_moments_plain(t, t)
    assert torch.equal(mu, want[0]) and torch.equal(s11, want[1])
    for name, g, w in zip(("mu1", "s11"), (mu, s11), _jax_reference(x1)):
        assert g.shape == shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL, err_msg=name)


def test_reference_form_on_cpu_is_the_plain_version():
    x1 = torch.from_numpy(_planes((2, 3, 33, 47), seed=5)[0])
    before = (tmo.candidate_moments.launches, tmo.reference_moments.launches)
    got = tmo.reference_moments(x1)
    want = tmo.reference_moments_plain(x1)
    assert len(got) == 2 and all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tmo.candidate_moments.launches, tmo.reference_moments.launches) == before


def test_mixed_devices_raise():
    m, c = torch.device("meta"), torch.device("cpu")
    for d1, d2 in ((c, m), (m, c)):
        x1, x2 = torch.empty(2, 3, 16, 16, device=d1), torch.empty(2, 3, 16, 16, device=d2)
        with pytest.raises(ValueError):
            tmo.candidate_moments(x1, x2)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tmo.reference_moments(torch.empty(2, 3, 16, 16, device=m))
    assert tmo.candidate_moments.launches == 0 and tmo.reference_moments.launches == 0


def test_masked_scorer_takes_the_reference_form(monkeypatch):
    """The masked SSIMULACRA2 takes each scale's reference moments from the
    one-input form and its candidate moments from the two-input form."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, len(args)))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tmk, "reference_moments", spy("reference", tmo.reference_moments))
    monkeypatch.setattr(tmk, "candidate_moments", spy("candidate", tmo.candidate_moments))
    rng = np.random.default_rng(3)
    refs = torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
    dists = torch.from_numpy(np.clip(refs.numpy().astype(int) + 3, 0, 255).astype(np.uint8))
    tmk.ssimulacra2_masked_batch(refs, dists, [[50, 60]])
    assert calls == [("reference", 1), ("candidate", 2)] * 6


def test_wrapper_is_registered_as_k9():
    fn = WRAPPERS["candidate_moments"]
    assert fn is tmo.candidate_moments
    assert fn.source == "codec_eval_tpu_torch/csrc/moments.cu"
    assert fn.replaces == "codec_eval_tpu/kernels/pallas/moments.py:76"
    # x1, x2, out, planes, h, w, walk, seg, taps, stream
    assert _lib.SIGNATURES["ce_candidate_moments"] == (
        _lib.P, _lib.P, _lib.P, _lib.I, _lib.I, _lib.I, _lib.I, _lib.I, _lib.P, _lib.P
    )
    # The reference form: x1, out, planes, h, w, walk, seg, taps, stream.
    assert _lib.SIGNATURES["ce_reference_moments"] == (
        _lib.P, _lib.P, _lib.I, _lib.I, _lib.I, _lib.I, _lib.I, _lib.P, _lib.P
    )
    ref = WRAPPERS["reference_moments"]
    assert ref is tmo.reference_moments
    assert (ref.source, ref.replaces) == (fn.source, fn.replaces)
    assert tmo.SIGMA == 1.5 and len(tmo.gaussian_taps(tmo.SIGMA)) == 15


def test_kernel_source_shares_k1s_moment_tile():
    """K1 and K9 share ``moments.cuh``'s stage A and row walk
    (``strip_walk``): K1 in its features form, K9 in its candidate and
    reference forms; each keeps its own stage B.  K1 no longer carries a
    vertical pass or copy ring of its own."""
    csrc = _lib.CSRC
    shared = (csrc / "moments.cuh").read_text()
    assert "__device__ __forceinline__ void strip_walk(" in shared
    assert "horizontal_quad(" in shared
    k9 = (csrc / "moments.cu").read_text()
    k1 = (csrc / "scale_features.cu").read_text()
    for name, text in (("moments.cu", k9), ("scale_features.cu", k1)):
        assert '#include "moments.cuh"' in text, name
        assert "horizontal_quad(" in text, name
    assert "strip_walk<kFeatures>(" in k1
    assert re.search(r"strip_walk<FORM>\(", k9)
    assert "launch<kCandidate>(" in k9 and "launch<kReference>(" in k9
    assert "cp_async4(" not in k1 and "fir(taps.v, win" not in k1
    assert "ce_candidate_moments" in k9 and "ce_reference_moments" in k9
