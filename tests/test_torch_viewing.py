"""The port's viewing model and viewing resize against the JAX package.

- ``codec_eval_tpu_torch.viewing`` is a host copy of
  ``codec_eval_tpu.viewing``: every preset at three image sizes in both
  simulation modes gives equal ``SimulationParams``, field by field, and the
  JSON round trips are equal;
- the port's f32 linear-light resize (``kernels/resize.py``, two weight
  matrices) against ``jax.image.resize(..., antialias=True)`` on the same
  planes, within 1e-6 absolute, for every method at ratios 0.5, 0.75, 1/3,
  1.5 and 2 on a 37 x 53 image, both axes and one axis left unchanged;
- ``resize_u8`` against JAX's: at most 1 code value apart, at least 99.9 %
  of the samples equal;
- the identity case and the antialiased checkerboard of
  ``tests/test_viewing.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import codec_eval_tpu.viewing as jv
import codec_eval_tpu_torch.viewing as tv
from codec_eval_tpu.kernels import resize as jr
from codec_eval_tpu_torch.kernels import resize as tr

PRESETS = ("native_desktop", "native_laptop", "native_phone", "srcset_1x_on_phone",
           "srcset_1x_on_laptop", "srcset_2x_on_phone", "srcset_2x_on_desktop",
           "srcset_2x_on_laptop_1_5x", "srcset_3x_on_phone")
SIZES = ((64, 48), (1920, 1080), (333, 517))  # (width, height)
METHODS = ("linear", "cubic", "lanczos3", "lanczos5", "nearest")
RATIOS = (0.5, 0.75, 1 / 3, 1.5, 2.0)
H, W = 37, 53


def _fields(obj):
    return dataclasses.asdict(obj)


def _params_and_thresholds(mod, cond, width, height, mode):
    p = cond.simulation_params(width, height, getattr(mod.SimulationMode, mode))
    return _fields(p), (
        p.requires_scaling(), p.downscale_only_factor(), p.threshold_multiplier(),
        p.adjust_dssim_threshold(0.0015), p.adjust_butteraugli_threshold(1.5),
        p.adjust_ssimulacra2_threshold(70.0), p.dssim_acceptable(0.001, 0.0015),
        p.butteraugli_acceptable(1.2, 1.5), p.ssimulacra2_acceptable(72.0, 70.0),
    )


@pytest.mark.parametrize("name", PRESETS)
def test_preset_simulation_params_equal_jax(name):
    jc, tc = getattr(jv.presets, name)(), getattr(tv.presets, name)()
    assert _fields(tc) == _fields(jc)
    assert (tc.effective_ppd(), tc.srcset_ratio()) == (jc.effective_ppd(), jc.srcset_ratio())
    for width, height in SIZES:
        for mode in ("ACCURATE", "DOWNSAMPLE_ONLY"):
            assert (_params_and_thresholds(tv, tc, width, height, mode)
                    == _params_and_thresholds(jv, jc, width, height, mode)), (width, mode)
    assert tc.to_json() == jc.to_json()
    assert tv.ViewingCondition.from_json(tc.to_json()) == tc
    assert _fields(tv.ViewingCondition.from_json(jc.to_json())) == _fields(
        jv.ViewingCondition.from_json(jc.to_json()))


def test_preset_groups_and_constructors_equal_jax():
    for group in ("all", "key"):
        assert ([_fields(c) for c in getattr(tv.presets, group)()]
                == [_fields(c) for c in getattr(jv.presets, group)()])
    for single in ("baseline", "demanding"):
        assert _fields(getattr(tv.presets, single)()) == _fields(getattr(jv.presets, single)())
    for ctor in ("desktop", "laptop", "smartphone"):
        assert _fields(getattr(tv.ViewingCondition, ctor)()) == _fields(
            getattr(jv.ViewingCondition, ctor)())
    override = tv.ViewingCondition(60.0).with_ppd_override(33.0)
    assert override.effective_ppd() == jv.ViewingCondition(60.0).with_ppd_override(
        33.0).effective_ppd()
    assert tv.REFERENCE_PPD == jv.REFERENCE_PPD
    assert [m.value for m in tv.SimulationMode] == [m.value for m in jv.SimulationMode]
    assert tv.__all__ == jv.__all__


def _jax_resize(x, th, tw, method):
    out = jax.image.resize(jnp.asarray(x), (th, tw, 3), method=method, antialias=True)
    return np.asarray(out)


def _port_resize(x, th, tw, method):
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 0)))
    return np.moveaxis(tr.resize_linear(planes, th, tw, method).numpy(), 0, -1)


@pytest.mark.parametrize("ratio", RATIOS, ids=("0.5", "0.75", "1/3", "1.5", "2"))
@pytest.mark.parametrize("method", METHODS)
def test_f32_resize_matches_jax_image_resize(method, ratio):
    x = np.random.default_rng(17).random((H, W, 3), dtype=np.float32)
    th, tw = round(H * ratio), round(W * ratio)
    for shape in ((th, tw), (th, W), (H, tw)):
        got, want = _port_resize(x, *shape, method), _jax_resize(x, *shape, method)
        assert got.shape == want.shape == (*shape, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=str(shape))


def test_method_names_follow_jax():
    x = np.random.default_rng(3).random((H, W, 3), dtype=np.float32)
    for alias, base in (("bilinear", "linear"), ("trilinear", "linear"), ("triangle", "linear"),
                        ("bicubic", "cubic"), ("tricubic", "cubic")):
        np.testing.assert_array_equal(_port_resize(x, 20, 30, alias),
                                      _port_resize(x, 20, 30, base))
    for bad in ("area", "gaussian", "Linear"):
        with pytest.raises(ValueError, match="Unknown resize method"):
            tr.resize_linear(torch.zeros(3, 4, 4), 2, 2, bad)
        with pytest.raises(ValueError):
            jax.image.resize(jnp.zeros((4, 4, 3)), (2, 2, 3), method=bad)


def test_weight_matrices_are_cached_per_axis_and_method():
    cpu = torch.device("cpu")
    a = tr.weight_matrix(53, 40, "linear", cpu)
    assert tr.weight_matrix(53, 40, "linear", cpu) is a
    assert tr.weight_matrix(53, 40, "cubic", cpu) is not a
    assert a.shape == (53, 40) and a.dtype == torch.float32 and a.device == cpu
    np.testing.assert_allclose(a.sum(0).numpy(), np.ones(40), atol=1e-6)


# The last is a path size: 512 -> 683, the 2x-srcset-on-1.5x-laptop preset.
@pytest.mark.parametrize("shape", [(37, 53, 18, 26), (64, 64, 32, 32), (40, 60, 80, 120),
                                   (37, 53, 56, 80), (96, 128, 72, 96), (37, 53, 37, 26),
                                   (512, 512, 683, 683)])
@pytest.mark.parametrize("method", ("linear", "cubic", "lanczos3"))
def test_resize_u8_matches_jax(shape, method):
    h, w, th, tw = shape
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3)).astype(np.uint8)
    want = np.asarray(jr.resize_u8(jnp.asarray(img), th, tw, method=method)).astype(int)
    got = tr.resize_u8(img, th, tw, method=method, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (th, tw, 3)
    diff = np.abs(got.numpy().astype(int) - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_simulate_viewing_matches_jax_and_keeps_the_identity():
    img = np.random.default_rng(0).integers(0, 256, (40, 60, 3)).astype(np.uint8)
    cond = tv.ViewingCondition.desktop().with_browser_dppx(1.0).with_image_intrinsic_dppx(2.0)
    p = cond.simulation_params(60, 40, tv.SimulationMode.ACCURATE)
    out = tv.simulate_viewing(img, p, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == (80, 120, 3) and out.dtype == np.uint8
    jp = jv.ViewingCondition.desktop().with_browser_dppx(1.0).with_image_intrinsic_dppx(
        2.0).simulation_params(60, 40, jv.SimulationMode.ACCURATE)
    want = jv.simulate_viewing(img, jp)
    assert np.abs(out.astype(int) - want.astype(int)).max() <= 1
    # A tensor in, a tensor out.
    assert isinstance(tv.simulate_viewing(torch.from_numpy(img), p, device="cpu"), torch.Tensor)
    # No scaling required -> the input object itself.
    p1 = tv.ViewingCondition.desktop().simulation_params(60, 40, tv.SimulationMode.ACCURATE)
    assert tv.simulate_viewing(img, p1) is img
    assert tv.simulate_viewing(img, p1, device="cpu") is img


def test_simulate_viewing_downscale_antialiased():
    # 1px checkerboard downscaled 2x must average toward mid-gray, not alias.
    y, x = np.mgrid[0:64, 0:64]
    img = np.stack([(((x + y) % 2) * 255).astype(np.uint8)] * 3, -1)
    cond = tv.ViewingCondition.desktop().with_browser_dppx(2.0).with_image_intrinsic_dppx(1.0)
    p = cond.simulation_params(64, 64, tv.SimulationMode.ACCURATE)
    out = tv.simulate_viewing(img, p, device="cpu")
    assert out.shape == (32, 32, 3)
    mean = out.astype(np.float64).mean()
    assert 150 < mean < 210  # linear-light average of 0/255 checker ~ 188
    want = jv.simulate_viewing(img, p)
    np.testing.assert_array_equal(out, want)


def test_resize_defaults_to_the_card(monkeypatch):
    img = np.zeros((8, 8, 3), np.uint8)
    p = tv.ViewingCondition.desktop().with_browser_dppx(2.0).simulation_params(
        8, 8, tv.SimulationMode.ACCURATE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.resize_u8(img, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tv.simulate_viewing(img, p)
