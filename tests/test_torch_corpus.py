"""The port's corpus runner and device mesh against the JAX package.

- ``score_pairs_sharded`` with ``masked=False`` (exact shapes, the
  single-pair kernels) and ``masked=True`` (padded buckets of granularity
  32) on a one-device CPU mesh, against the JAX ``corpus_runner`` on a
  one-device CPU mesh (``jax.devices()[:1]``; the suite forces 8 virtual
  devices), on the pairs of ``tests/test_parallel.py``: per-pair scores and
  means at 1e-5 relative (SSIMULACRA2, PSNR), 1e-5 relative plus 1e-5
  absolute (DSSIM: the port keeps Lab in f64, the JAX package's f32 SSIM
  means carry ~1e-5 of cancellation error) and 5e-4 (Butteraugli);
- the masked scores against the port's exact path at ``test_parallel.py``'s
  tolerance (rel 2e-3, abs 1e-4);
- ``stage_pairs_sharded`` then ``score_staged`` equals the one-shot call and
  staged buckets are reusable; padding repeats on a two-device mesh are
  dropped from results and means; the masked metric filter;
- the mesh: the card by default and an error without one, ``n_space > 1``
  not ported, shards that split the batch, steps cached per mesh and flags.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from codec_eval_tpu import parallel as jp
from codec_eval_tpu_torch import parallel as tp

METRICS = ("ssimulacra2", "dssim", "butteraugli", "psnr")
RTOL = {"ssimulacra2": 1e-5, "dssim": 1e-5, "psnr": 1e-5, "butteraugli": 5e-4}
ATOL = {"ssimulacra2": 0.0, "dssim": 1e-5, "psnr": 0.0, "butteraugli": 0.0}
CPU = torch.device("cpu")


def _pairs(seed=2, shapes=((32, 32), (24, 40), (17, 29))):
    """The mixed-size pairs of ``tests/test_parallel.py``."""
    rng = np.random.default_rng(seed)
    pairs = []
    for shape in shapes:
        ref = rng.integers(0, 256, (*shape, 3)).astype(np.uint8)
        dist = np.clip(ref.astype(np.int16) + rng.integers(-6, 7, ref.shape), 0, 255).astype(
            np.uint8
        )
        pairs.append((ref, dist))
    return pairs


def _cpu_mesh(n=1):
    return tp.make_mesh(devices=[CPU] * n)


@functools.lru_cache(maxsize=None)
def _scores(masked: bool):
    """(JAX, port) corpus scores of the pairs, computed once per module."""
    pairs = _pairs()
    jmesh = jp.make_mesh(devices=jax.devices()[:1])
    want = jp.score_pairs_sharded(pairs, mesh=jmesh, masked=masked, granularity=32)
    got = tp.score_pairs_sharded(pairs, mesh=_cpu_mesh(), masked=masked, granularity=32)
    return want, got


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "masked"])
@pytest.mark.parametrize("metric", METRICS)
def test_corpus_scores_match_jax(metric, masked):
    want, got = _scores(masked)
    assert len(got.per_pair) == len(want.per_pair) == 3
    for g, w in zip(got.per_pair, want.per_pair):
        assert set(g) == set(w) == set(METRICS)
        assert g[metric] == pytest.approx(w[metric], rel=RTOL[metric], abs=ATOL[metric])
    assert got.means[metric] == pytest.approx(want.means[metric], rel=RTOL[metric],
                                              abs=ATOL[metric])


def test_masked_matches_the_exact_path():
    (_, exact), (_, masked) = _scores(False), _scores(True)
    for g, e in zip(masked.per_pair, exact.per_pair):
        for k in METRICS:
            assert g[k] == pytest.approx(e[k], rel=2e-3, abs=1e-4), (k, g, e)


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "masked"])
def test_stage_then_score_matches_one_shot(masked):
    pairs, mesh = _pairs(seed=4), _cpu_mesh()
    staged = tp.stage_pairs_sharded(pairs, mesh=mesh, masked=masked, granularity=32)
    got = tp.score_staged(staged)
    again = tp.score_staged(staged)
    want = tp.score_pairs_sharded(pairs, mesh=mesh, masked=masked, granularity=32)
    assert got.per_pair == want.per_pair == again.per_pair
    assert got.means == want.means
    assert staged.step is tp.stage_pairs_sharded(pairs, mesh=mesh, masked=masked,
                                                 granularity=32).step


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "masked"])
def test_padding_repeats_are_dropped(masked):
    """Two pairs per bucket shape, three buckets, on a mesh of two: every
    bucket of one is padded by a repeat, which leaves results and means."""
    pairs = _pairs(seed=1, shapes=((32, 32), (32, 32), (24, 40), (17, 29), (17, 29)))
    kw = dict(masked=masked, granularity=32, dssim=False, butteraugli=False)
    two = tp.score_pairs_sharded(pairs, mesh=_cpu_mesh(2), **kw)
    one = tp.score_pairs_sharded(pairs, mesh=_cpu_mesh(1), **kw)
    assert len(two.per_pair) == len(pairs)
    assert two.per_pair == one.per_pair
    for k in ("psnr", "ssimulacra2"):
        assert two.means[k] == pytest.approx(np.mean([p[k] for p in two.per_pair]))


@pytest.mark.parametrize("n_dev,batch", [(1, 1), (1, 2), (2, 2)])
def test_masked_buckets_are_scored_in_chunks(n_dev, batch):
    """Five pairs in one 32x32 bucket, scored at most ``batch`` pairs per
    device at a time: the tail chunk is padded by repeats, which leave the
    results, and the scores equal those of one batch of five at 1e-5
    relative (the dense masked blurs' GEMMs may add in another order at
    another batch size)."""
    pairs = _pairs(seed=6, shapes=((32, 32), (30, 31), (17, 29), (32, 20), (25, 32)))
    mesh, chunk = _cpu_mesh(n_dev), batch * n_dev
    staged = tp.stage_pairs_sharded(pairs, mesh=mesh, masked=True, granularity=32, batch=batch)
    assert [ix for ix, _, _, _ in staged.buckets] == [
        list(range(5))[i : i + chunk] for i in range(0, 5, chunk)
    ]
    assert all(sum(len(r) for r in refs) == chunk for _, refs, _, _ in staged.buckets)
    got = tp.score_staged(staged)
    whole = tp.score_pairs_sharded(pairs, mesh=_cpu_mesh(), masked=True, granularity=32)
    assert len(got.per_pair) == 5
    for g, w in zip(got.per_pair, whole.per_pair):
        for k in METRICS:
            assert g[k] == pytest.approx(w[k], rel=1e-5), (k, g, w)


def test_masked_metric_filter_matches_jax():
    # A 24x40 pair alone fills a 32x64 bucket, the shape JAX compiled above.
    ref = np.random.default_rng(3).integers(0, 256, (24, 40, 3)).astype(np.uint8)
    kw = dict(masked=True, granularity=32, dssim=False, butteraugli=False)
    got = tp.score_pairs_sharded([(ref, ref)], mesh=_cpu_mesh(), **kw)
    want = jp.score_pairs_sharded([(ref, ref)], mesh=jp.make_mesh(devices=jax.devices()[:1]),
                                  **kw)
    assert set(got.per_pair[0]) == set(want.per_pair[0]) == {"psnr", "ssimulacra2"}
    assert got.per_pair == want.per_pair == [{"psnr": float("inf"), "ssimulacra2": 100.0}]


def test_pair_shapes_must_match():
    ref = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="differ"):
        tp.stage_pairs_sharded([(ref, ref[:8])], mesh=_cpu_mesh())


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.score_pairs_sharded(_pairs())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_mesh(devices=[torch.device("cuda", 0)])


def test_mesh_shape_and_spatial_sharding():
    with pytest.raises(NotImplementedError, match="n_space > 1"):
        tp.make_mesh(n_space=2, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="needs 3 devices"):
        tp.make_mesh(n_batch=3, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="unsupported device"):
        tp.make_mesh(devices=[torch.device("meta")])
    mesh = tp.make_mesh(devices=[CPU, CPU])
    assert mesh.devices.shape == (2, 1) and mesh.axis_names == ("batch", "space")
    assert tp.make_mesh(n_batch=1, devices=[CPU, CPU]).devices.shape == (1, 1)


def test_shard_batch_splits_over_the_batch_axis():
    mesh = _cpu_mesh(2)
    batch = np.arange(4 * 2 * 2 * 3, dtype=np.uint8).reshape(4, 2, 2, 3)
    shards = tp.shard_batch(mesh, batch)
    assert [s.shape[0] for s in shards] == [2, 2]
    np.testing.assert_array_equal(torch.cat(shards).numpy(), batch)
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_batch(mesh, batch[:3])


def test_steps_are_cached_per_mesh_and_flags():
    mesh = _cpu_mesh()
    assert tp.sharded_score_fn(mesh) is tp.sharded_score_fn(_cpu_mesh())
    assert tp.sharded_score_fn(mesh, dssim=False) is not tp.sharded_score_fn(mesh)
    assert tp.sharded_masked_score_fn(mesh) is tp.sharded_masked_score_fn(_cpu_mesh())
    assert tp.sharded_masked_score_fn(mesh) is not tp.sharded_masked_score_fn(_cpu_mesh(2))


def test_dense_step_returns_per_pair_scores_and_means():
    mesh = _cpu_mesh()
    pairs = _pairs(seed=5, shapes=((24, 24), (24, 24)))
    refs, dists = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    per_pair, agg = tp.sharded_score_fn(mesh, dssim=False, butteraugli=False)(
        tp.shard_batch(mesh, refs), tp.shard_batch(mesh, dists)
    )
    assert set(per_pair) == {"psnr", "ssimulacra2"}
    assert set(agg) == {"mean_psnr", "mean_ssimulacra2"}
    for k, v in per_pair.items():
        assert v.shape == (2,) and float(agg[f"mean_{k}"]) == pytest.approx(float(v.mean()))
