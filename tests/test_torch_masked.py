"""The port's masked (mixed-size) scorer against the JAX package.

- each masked metric against its JAX twin on the same padded inputs, at the
  shapes of ``tests/test_masked_scoring.py`` in buckets of granularity 128
  and 32: SSIMULACRA2 and PSNR at 1e-5 relative, DSSIM at 1e-5 relative
  plus 1e-5 absolute (the port keeps Lab in f64; the JAX package's f32 SSIM
  means carry ~1e-5 of cancellation error, ``kernels/dssim.py`` of the
  port), Butteraugli at 5e-4 (FIR summation order only) on two shapes;
- the exactness claim inside the port: the masked score equals the port's
  exact-shape score at the tolerances of ``test_masked_scoring.py``
  (SSIMULACRA2 abs 5e-3, DSSIM rel 1e-3, Butteraugli rel 1e-4, PSNR abs
  1e-3);
- identical padded pairs give exactly 100 / 0 / 0 / inf, and valid dims
  larger than the bucket clamp to it;
- the helpers (``bucket_shapes``, ``pad_to_bucket``, the masked downscale,
  ``_bucketed_chunks``' tail repeat) and ``score_mixed_sizes`` /
  ``score_mixed_sizes_all`` against JAX's, in input order.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu_torch import kernels as tk
from codec_eval_tpu_torch.kernels import butteraugli as tba
from codec_eval_tpu_torch.kernels import dssim as tds
from codec_eval_tpu_torch.kernels import masked as tm

jm = importlib.import_module("codec_eval_tpu.kernels.masked")
tps = importlib.import_module("codec_eval_tpu_torch.kernels.psnr")
ts2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")

METRICS = ("ssimulacra2", "dssim", "butteraugli", "psnr")
RTOL = {"ssimulacra2": 1e-5, "dssim": 1e-5, "psnr": 1e-5, "butteraugli": 5e-4}
ATOL = {"ssimulacra2": 0.0, "dssim": 1e-5, "psnr": 0.0, "butteraugli": 0.0}
# (h, w, granularity): the JAX test's shapes in 128-buckets, and two in
# 32-buckets (128x128 and 160x192).
CASES = [(96, 128, 128), (97, 111, 128), (130, 190, 128), (64, 64, 128), (97, 111, 32),
         (130, 190, 32)]
BA_CASES = [(97, 111, 128), (64, 64, 128)]


def _pair(h, w, seed=0, amp=10):
    """The pairs of ``tests/test_masked_scoring.py``."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 70 * np.sin(x / 11.0) + 50 * np.cos(y / 7.0)
    ref = np.clip(
        np.stack([base, base * 0.85, base * 0.7], -1) + r.normal(0, 8, (h, w, 3)), 0, 255
    ).astype(np.uint8)
    dist = np.clip(ref.astype(np.int16) + r.integers(-amp, amp + 1, ref.shape), 0, 255).astype(
        np.uint8
    )
    return ref, dist


def _padded(h, w, g):
    ref, dist = _pair(h, w, seed=h * 1000 + w)
    hp, wp = tm.bucket_shapes([(h, w)], granularity=g)[0]
    return tm.pad_to_bucket(ref, hp, wp), tm.pad_to_bucket(dist, hp, wp)


@functools.lru_cache(maxsize=None)
def _jax_fn(metric):
    return jax.jit(getattr(jm, f"{metric}_masked"))


@functools.lru_cache(maxsize=None)
def _jax_score(metric, h, w, g):
    rp, dp = _padded(h, w, g)
    return float(_jax_fn(metric)(jnp.asarray(rp), jnp.asarray(dp), h, w))


def _port(metric, rp, dp, h, w):
    return float(getattr(tm, f"{metric}_masked")(torch.from_numpy(rp), torch.from_numpy(dp), h, w))


def _case_id(c):
    return f"{c[0]}x{c[1]}-g{c[2]}"


@pytest.mark.parametrize("metric", ["ssimulacra2", "dssim", "psnr"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_masked_metric_matches_jax(metric, case):
    h, w, g = case
    got = _port(metric, *_padded(h, w, g), h, w)
    want = _jax_score(metric, h, w, g)
    assert got == pytest.approx(want, rel=RTOL[metric], abs=ATOL[metric]), (got, want)


@pytest.mark.parametrize("case", BA_CASES, ids=_case_id)
def test_butteraugli_masked_matches_jax(case):
    h, w, g = case
    got = _port("butteraugli", *_padded(h, w, g), h, w)
    want = _jax_score("butteraugli", h, w, g)
    assert got == pytest.approx(want, rel=RTOL["butteraugli"]), (got, want)


def _exact(metric, ref, dist):
    r, d = torch.from_numpy(ref), torch.from_numpy(dist)
    fn = {"ssimulacra2": ts2.ssimulacra2, "dssim": tds.dssim_u8, "butteraugli": tba.butteraugli,
          "psnr": tps.psnr}[metric]
    return float(fn(r, d))


@pytest.mark.parametrize("h,w", [(96, 128), (97, 111), (130, 190), (64, 64)])
def test_ssimulacra2_masked_equals_exact_shape(h, w):
    ref, dist = _pair(h, w, seed=h * 1000 + w)
    hp, wp = tm.bucket_shapes([(h, w)], granularity=128)[0]
    masked = _port("ssimulacra2", tm.pad_to_bucket(ref, hp, wp), tm.pad_to_bucket(dist, hp, wp),
                   h, w)
    assert masked == pytest.approx(_exact("ssimulacra2", ref, dist), abs=5e-3)


@pytest.mark.parametrize(
    "metric,h,w,bucket,tol",
    [("dssim", 130, 190, (256, 256), dict(rel=1e-3)),
     ("butteraugli", 97, 131, (128, 160), dict(rel=1e-4)),
     ("psnr", 97, 130, (128, 256), dict(abs=1e-3))],
)
def test_masked_equals_exact_shape(metric, h, w, bucket, tol):
    ref, dist = _pair(h, w, seed={"dssim": 21, "butteraugli": 22, "psnr": 9}[metric])
    masked = _port(metric, tm.pad_to_bucket(ref, *bucket), tm.pad_to_bucket(dist, *bucket), h, w)
    assert masked == pytest.approx(_exact(metric, ref, dist), **tol)


@pytest.mark.parametrize("metric,want", [("ssimulacra2", 100.0), ("dssim", 0.0),
                                         ("butteraugli", 0.0), ("psnr", float("inf"))])
def test_identical_padded_pair(metric, want):
    ref, _ = _pair(90, 90, seed=3)
    p = tm.pad_to_bucket(ref, 128, 128)
    assert _port(metric, p, p, 90, 90) == want


@pytest.mark.parametrize("metric", METRICS)
def test_valid_dims_beyond_the_bucket_clamp(metric):
    rp, dp = _padded(97, 111, 128)
    assert _port(metric, rp, dp, 500, 129) == _port(metric, rp, dp, 128, 128)


def test_bucket_shapes_rounding_and_errors():
    assert tm.bucket_shapes([(97, 111), (128, 128), (129, 1)], granularity=128) == [
        (128, 128), (128, 128), (256, 128)
    ]
    assert tm.bucket_shapes([(17, 29), (24, 40)], granularity=32) == [(32, 32), (32, 64)]
    with pytest.raises(ValueError, match="multiple of 32"):
        tm.bucket_shapes([(10, 10)], granularity=100)


def test_pad_to_bucket_matches_jax_and_rejects_oversize():
    ref, _ = _pair(37, 53, seed=5)
    np.testing.assert_array_equal(tm.pad_to_bucket(ref, 64, 96), jm.pad_to_bucket(ref, 64, 96))
    with pytest.raises(ValueError, match="larger than bucket"):
        tm.pad_to_bucket(np.zeros((200, 10, 3), np.uint8), 128, 128)


def test_downscale_masked_matches_jax_per_pair():
    rng = np.random.default_rng(11)
    dims = [(37, 53), (64, 63), (20, 64)]
    planes = np.zeros((len(dims), 3, 64, 64), np.float32)
    for i, (h, w) in enumerate(dims):
        planes[i, :, :h, :w] = rng.random((3, h, w))
    vh, vw = (torch.tensor([d[k] for d in dims]) for k in (0, 1))
    got, gh, gw = tm._downscale_masked(torch.from_numpy(planes), vh, vw)
    for i, (h, w) in enumerate(dims):
        want, wh, ww = jm._downscale_masked(jnp.asarray(planes[i]), jnp.int32(h), jnp.int32(w))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        assert (int(gh[i]), int(gw[i])) == (int(wh), int(ww))


def test_bucketed_chunks_repeat_the_tail_as_jax_does():
    sizes = [(96, 128), (97, 111), (200, 150), (64, 64), (128, 128), (33, 40), (50, 60)]
    pairs = [_pair(h, w, seed=i) for i, (h, w) in enumerate(sizes)]
    got = list(tm._bucketed_chunks(pairs, 128, 4))
    want = list(jm._bucketed_chunks(pairs, 128, 4))
    assert len(got) == len(want) == 3
    for (gi, gr, gd, ghw), (wi, wr, wd, whw) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(ghw, whw)
    # The 128x128 bucket holds six pairs: chunks of 4 and 2, the 2 padded to 4.
    assert [len(c[0]) for c in got] == [4, 2, 1] and [len(c[1]) for c in got] == [4, 4, 1]


def test_score_mixed_sizes_matches_jax_in_input_order():
    pairs = [_pair(h, w, seed=i) for i, (h, w) in
             enumerate([(96, 128), (97, 111), (200, 150), (64, 64), (128, 128)])]
    got = tm.score_mixed_sizes(pairs, granularity=128, batch=2, device="cpu")
    want = jm.score_mixed_sizes(pairs, granularity=128, batch=2)
    np.testing.assert_allclose(got, want, rtol=RTOL["ssimulacra2"])
    assert tm.score_mixed_sizes([], device="cpu").shape == (0,)


def test_score_mixed_sizes_all_matches_jax_in_input_order():
    pairs = [_pair(h, w, seed=40 + i) for i, (h, w) in enumerate([(97, 111), (128, 128)])]
    got = tm.score_mixed_sizes_all(pairs, granularity=128, batch=2, device="cpu")
    want = jm.score_mixed_sizes_all(pairs, granularity=128, batch=2)
    assert set(got) == set(want) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL[k], atol=ATOL[k], err_msg=k)
    assert all(v.shape == (0,) for v in tm.score_mixed_sizes_all([], device="cpu").values())


def test_mixed_sizes_default_to_the_card(monkeypatch):
    """With no ``device`` the scorers take the card; without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = [_pair(40, 40)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.score_mixed_sizes(pairs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.score_mixed_sizes_all(pairs)


def test_kernels_package_reexports_the_masked_names():
    for name in ("butteraugli_masked", "dssim_masked", "pad_to_bucket", "psnr_masked",
                 "score_mixed_sizes", "score_mixed_sizes_all", "ssimulacra2_masked",
                 "ssimulacra2_masked_batch"):
        assert getattr(tk, name) is getattr(tm, name)
