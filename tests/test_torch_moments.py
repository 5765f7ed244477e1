"""K9, the candidate-side SSIM moments, against the JAX package.

- the plain version (what the wrapper runs on CPU tensors) against JAX's
  ``fused_candidate_moments`` (``pallas/moments.py:136``), which off the
  TPU takes its XLA formulation, as the JAX package's own
  ``tests/test_pallas_moments.py`` runs it: atol 1e-6, the JAX test's own
  tolerance (the same 15 taps in the same order; XLA may fuse the products
  into the first pass);
- a batch of pairs, each with its own x1, against JAX pair by pair;
- x1 given as both inputs (the masked scorer's reference side) gives
  blur(x1) and blur(x1 * x1), the planes of the plain stacked blur, exactly;
- on CPU tensors the wrapper is the plain version and launches nothing; on
  any other device it must be a CUDA tensor of the right shape, or it
  raises before touching the library (the kernel itself runs on the card,
  in ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels.pallas.moments import fused_candidate_moments
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


def test_wrapper_is_registered_as_k9():
    fn = WRAPPERS["candidate_moments"]
    assert fn is tmo.candidate_moments
    assert fn.source == "codec_eval_tpu_torch/csrc/moments.cu"
    assert fn.replaces == "codec_eval_tpu/kernels/pallas/moments.py:76"
    assert _lib.SIGNATURES["ce_candidate_moments"] == (
        _lib.P, _lib.P, _lib.P, _lib.I, _lib.I, _lib.I, _lib.P, _lib.P
    )
    assert tmo.SIGMA == 1.5 and len(tmo.gaussian_taps(tmo.SIGMA)) == 15


def test_kernel_source_shares_k1s_moment_tile():
    """K9 calls the staging and FIR passes of ``moments.cuh``; K1, which
    streams rows through register windows instead, takes the same sigma-1.5
    radius and tap count from it."""
    csrc = _lib.CSRC
    for name in ("moments.cu", "scale_features.cu"):
        assert '#include "moments.cuh"' in (csrc / name).read_text()
    k9 = (csrc / "moments.cu").read_text()
    assert "stage_vertical(" in k9 and "horizontal(" in k9
    k1 = (csrc / "scale_features.cu").read_text()
    assert "using ce::moments::K;" in k1 and "using ce::moments::R;" in k1
    assert "ce_candidate_moments" in (csrc / "moments.cu").read_text()
