"""Spatial sharding in the port (``parallel/spatial.py``): row bands with a
recompute halo, against the unsharded port and the JAX package, on the CPU.

- the band layout: boundaries and halo are multiples of 32, the bands tile
  the rows, and the halo covers each metric's receptive field, recomputed
  here from the JAX package's own constants;
- the windowed plain SSIMULACRA2 features (K1/K8's plain version with a row
  window), combined over bands, equal the whole-plane features (1e-6);
- ``sharded_score_fn(spatial=True)`` equals the unsharded port step on tall
  narrow pairs whose halo ends inside the image, at an odd height too
  (H = 800 and 333, W = 40, ``n_space`` 2 and 3): 1e-6 relative,
  Butteraugli 1e-5;
- one pair at H = 333 against JAX's single-pair functions at the port's
  tiers (1e-5, DSSIM 1e-5 absolute besides, Butteraugli 5e-4);
- ``tests/test_parallel.py``'s JAX spatial step (4 x 48 px, ``n_space=2``,
  SSIMULACRA2 and PSNR) against the port's at JAX's own tolerance.
"""

import functools
import math

import numpy as np
import pytest
import torch

from codec_eval_tpu_torch import parallel as tp
from codec_eval_tpu_torch.kernels.blur import blur_separable
from codec_eval_tpu_torch.kernels.cuda import scale_features as k1
from codec_eval_tpu_torch.parallel import spatial

CPU = torch.device("cpu")
METRICS = ("psnr", "ssimulacra2", "dssim", "butteraugli")
RTOL = {"psnr": 1e-6, "ssimulacra2": 1e-6, "dssim": 1e-6, "butteraugli": 1e-5}
JAX_RTOL = {"psnr": 1e-5, "ssimulacra2": 1e-5, "dssim": 1e-5, "butteraugli": 5e-4}
# The JAX package's DSSIM keeps its SSIM means in f32 (~1e-5 of cancellation
# error); the port's are f64 (tests/test_torch_corpus.py).
JAX_ATOL = {"psnr": 0.0, "ssimulacra2": 0.0, "dssim": 1e-5, "butteraugli": 0.0}
WIDTH = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its planes are small and
    its eager ops many, and when the suite runs several processes at once
    the ops' threads otherwise wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(n: int, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    refs = rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)
    dists = np.clip(refs.astype(np.int16) + rng.integers(-8, 9, refs.shape), 0, 255)
    return refs, dists.astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _tall(h: int):
    """Two tall narrow pairs and a third, byte-identical one, with the
    unsharded port's scores."""
    refs, dists = _pairs(2, h, WIDTH, seed=h)
    refs = np.concatenate([refs, refs[:1]])
    dists = np.concatenate([dists, refs[:1]])
    mesh = tp.make_mesh(devices=[CPU])
    per_pair, means = tp.sharded_score_fn(mesh)(tp.shard_batch(mesh, refs),
                                                tp.shard_batch(mesh, dists))
    return refs, dists, per_pair, means


def _spatial_step(n_space: int, refs, dists, **flags):
    mesh = tp.make_mesh(n_batch=1, n_space=n_space, devices=[CPU] * n_space)
    step = tp.sharded_score_fn(mesh, spatial=True, **flags)
    return step(tp.shard_batch(mesh, refs, spatial=True), tp.shard_batch(mesh, dists, spatial=True))


# -- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("height,n_space", [(800, 2), (333, 3), (2048, 2), (512, 2), (48, 2),
                                            (96, 3), (33, 2), (4000, 5)])
def test_bands_are_aligned_and_tile_the_rows(height, n_space):
    bands = spatial.row_bands(height, n_space)
    halo = spatial.halo_rows()
    assert spatial.ALIGN == 32 and halo % 32 == 0
    assert len(bands) == n_space
    assert bands[0].lo == 0 and bands[-1].hi == height
    for a, b in zip(bands, bands[1:]):
        assert a.hi == b.lo
    for b in bands:
        assert b.lo % 32 == 0 and (b.hi % 32 == 0 or b.hi == height) and b.lo < b.hi
        assert b.start == max(0, b.lo - halo) and b.stop == min(height, b.hi + halo)
        assert b.start % 32 == 0 and (b.stop % 32 == 0 or b.stop == height)
    blocks = [-(-(b.hi - b.lo) // 32) for b in bands]  # the last block may be short
    assert max(blocks) - min(blocks) <= 1


def test_too_many_bands_raise():
    with pytest.raises(ValueError, match="do not split into 3 bands"):
        spatial.row_bands(64, 3)


def test_halo_covers_each_metrics_receptive_field():
    """The reach of each metric, recomputed from the JAX package's constants:
    a stencil of radius r at 2x-downscale level s reaches r * 2^s rows, plus
    the 2^s - 1 other rows of its own pixel."""
    from codec_eval_tpu.kernels import butteraugli as jba
    from codec_eval_tpu.kernels import dssim as jdssim
    from codec_eval_tpu.kernels.ssimulacra2 import NUM_SCALES

    def reach(r, s):
        return r * 2**s + 2**s - 1

    def ba_radius(sigma):
        return max(1, int(2.25 * sigma))

    s2 = max(reach(math.ceil(4.5 * 1.5), s) for s in range(NUM_SCALES))
    n_dssim = len(jdssim.SCALE_WEIGHTS)
    dssim = reach(1, n_dssim)  # chroma: half resolution, then n_dssim - 1 more
    one_res = sum(ba_radius(s) for s in (1.2, jba.SIGMA_LF, 3.2248991, 1.5641633)) + max(
        4, ba_radius(2.7) + 3)
    want = {"ssimulacra2": s2, "dssim": dssim, "butteraugli": reach(one_res, 1)}
    assert want == {"ssimulacra2": 255, "dssim": 63, "butteraugli": 75}
    got = spatial.receptive_fields()
    for k, v in want.items():
        assert got[k] >= v, k
    assert spatial.halo_rows() == 256 >= max(got.values())


def test_shard_batch_cuts_row_bands():
    refs, _ = _pairs(4, 333, 8, seed=1)
    mesh = tp.make_mesh(n_batch=2, n_space=3, devices=[CPU] * 6)
    shards = tp.shard_batch(mesh, refs, spatial=True)
    assert len(shards) == 2
    for i, shard in enumerate(shards):
        assert isinstance(shard, spatial.BandedBatch) and len(shard) == 2
        assert (shard.height, shard.width) == (333, 8)
        for band, px in zip(shard.bands, shard.pixels):
            np.testing.assert_array_equal(px.numpy(), refs[2 * i : 2 * i + 2, band.start:band.stop])
    step = tp.sharded_score_fn(mesh, spatial=True)
    with pytest.raises(TypeError, match="spatial=True"):
        step(tp.shard_batch(mesh, refs), tp.shard_batch(mesh, refs))
    with pytest.raises(TypeError, match="spatial=False"):
        tp.sharded_score_fn(mesh)(shards, shards)


# -- the windowed features -------------------------------------------------------


@pytest.mark.parametrize("h,w,cuts", [(40, 24, (0, 13, 27, 40)), (17, 9, (0, 5, 17)),
                                      (64, 32, (0, 32, 64))])
def test_windowed_features_combine_to_the_whole_plane(h, w, cuts):
    rng = np.random.default_rng(h)
    x1 = torch.from_numpy(rng.uniform(0, 1, (3, h, w)).astype(np.float32))
    x2 = torch.from_numpy(rng.uniform(0, 1, (2, 3, h, w)).astype(np.float32))
    mu1, s11 = blur_separable(x1, k1.SIGMA), blur_separable(x1 * x1, k1.SIGMA)
    whole = k1.scale_features_plain(x1, mu1, s11, x2).double()
    one = four = 0.0
    for lo, hi in zip(cuts, cuts[1:]):
        f = k1.scale_features_batch(x1, mu1, s11, x2, rows=(lo, hi)).double()
        assert torch.equal(f[0], k1.scale_features(x1, mu1, s11, x2[0], rows=(lo, hi)).double())
        one = one + f[..., 0, :] * (hi - lo) * w
        four = four + f[..., 1, :] ** 4 * (hi - lo) * w
    combined = torch.stack([one / (h * w), (four / (h * w)) ** 0.25], dim=-2)
    np.testing.assert_allclose(combined.numpy(), whole.numpy(), rtol=1e-6, atol=1e-9)
    # The full window is the whole plane, bit for bit.
    assert torch.equal(k1.scale_features_plain(x1, mu1, s11, x2, rows=(0, h)),
                       k1.scale_features_plain(x1, mu1, s11, x2))
    with pytest.raises(ValueError, match="row window"):
        k1.scale_features_plain(x1, mu1, s11, x2, rows=(3, 3))


# -- the spatial step ------------------------------------------------------------


@pytest.mark.parametrize("h,n_space", [(800, 2), (800, 3), (333, 2), (333, 3)])
def test_spatial_step_equals_the_unsharded_port(h, n_space):
    refs, dists, want, want_means = _tall(h)
    bands = spatial.row_bands(h, n_space)
    if h == 800:  # every band's halo ends inside the image on one side at least
        assert all(0 < b.start or b.stop < h for b in bands)
    got, means = _spatial_step(n_space, refs, dists)
    assert got.keys() == want.keys() == set(METRICS)
    for k in METRICS:
        g, w = got[k].numpy(), want[k].numpy()
        assert g[2] == w[2] == {"psnr": math.inf, "ssimulacra2": 100.0, "dssim": 0.0,
                                "butteraugli": 0.0}[k]
        np.testing.assert_allclose(g[:2], w[:2], rtol=RTOL[k], err_msg=k)
        np.testing.assert_allclose(float(means[f"mean_{k}"]), float(want_means[f"mean_{k}"]),
                                   rtol=RTOL[k])


@functools.lru_cache(maxsize=None)
def _spatial_333():
    refs, dists, _, _ = _tall(333)
    got, _ = _spatial_step(3, refs[:1], dists[:1])
    return refs[0], dists[0], {k: float(v[0]) for k, v in got.items()}


@pytest.mark.parametrize("metric", METRICS)
def test_spatial_pair_equals_jax_single_pair_functions(metric):
    """One JAX function per case keeps each case's compile time short."""
    import jax.numpy as jnp

    from codec_eval_tpu.kernels.butteraugli import butteraugli
    from codec_eval_tpu.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu.kernels.dssim import dssim
    from codec_eval_tpu.kernels.psnr import psnr
    from codec_eval_tpu.kernels.ssimulacra2 import ssimulacra2

    ref, dist, got = _spatial_333()
    r, d = jnp.asarray(ref), jnp.asarray(dist)
    fn = {
        "psnr": psnr,
        "ssimulacra2": ssimulacra2,
        "dssim": lambda a, b: dssim(srgb_u8_to_linear(a), srgb_u8_to_linear(b)),
        "butteraugli": butteraugli,
    }[metric]
    np.testing.assert_allclose(got[metric], float(fn(r, d)), rtol=JAX_RTOL[metric],
                               atol=JAX_ATOL[metric])


def test_spatial_step_equals_jax_spatial_step():
    """``tests/test_parallel.py``'s spatial case, at its tolerance."""
    import jax

    from codec_eval_tpu.parallel import make_mesh, shard_batch, sharded_score_fn

    rng = np.random.default_rng(0)
    refs = rng.integers(0, 256, (4, 48, 48, 3)).astype(np.uint8)
    dists = np.clip(refs.astype(np.int16) + rng.integers(-8, 9, refs.shape), 0, 255).astype(
        np.uint8)
    jmesh = make_mesh(n_batch=4, n_space=2, devices=jax.devices()[:8])
    jstep = sharded_score_fn(jmesh, dssim=False, butteraugli=False, spatial=True)
    want, wagg = jstep(shard_batch(jmesh, refs, spatial=True),
                       shard_batch(jmesh, dists, spatial=True))
    mesh = tp.make_mesh(n_batch=4, n_space=2, devices=[CPU] * 8)
    step = tp.sharded_score_fn(mesh, dssim=False, butteraugli=False, spatial=True)
    got, agg = step(tp.shard_batch(mesh, refs, spatial=True),
                    tp.shard_batch(mesh, dists, spatial=True))
    assert set(got) == {"ssimulacra2", "psnr"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-3)
        assert float(agg[f"mean_{k}"]) == pytest.approx(float(wagg[f"mean_{k}"]), abs=1e-3)
