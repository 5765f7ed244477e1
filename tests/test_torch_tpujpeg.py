"""The port's tpujpeg codec (``codecs/tpujpeg.py``) and device ladder
(``engine/tpu_sweep.py``) against the JAX package's, on the CPU:

- the bytes of all eight presets equal JAX's, at 64 x 64 and 37 x 53;
- ``evaluate_tpujpeg_sweep``: exact sizes and bytes equal JAX's, device
  size estimates equal JAX's estimates, scores at the port's tiers
  (SSIMULACRA2 and PSNR rtol 1e-5, DSSIM rtol 1e-5 with atol 1e-5 against
  JAX's f32 form, Butteraugli rtol 5e-4);
- ``encode_to_target`` picks JAX's quality and bytes, and raises JAX's
  ``QualityBelowThreshold`` naming the same constraint.
"""

import numpy as np
import pytest
import torch

from codec_eval_tpu.codecs.tpujpeg import TpuJpegCodec as JaxCodec
from codec_eval_tpu.engine import tpu_sweep as jts
from codec_eval_tpu.engine.image import ImageData as JaxImage
from codec_eval_tpu.engine.session import EncodeRequest as JaxRequest
from codec_eval_tpu.errors import QualityBelowThreshold as JaxBelow
from codec_eval_tpu_torch.codecs import TpuJpegCodec
from codec_eval_tpu_torch.engine import encode_to_target, evaluate_tpujpeg_sweep
from codec_eval_tpu_torch.engine.image import ImageData
from codec_eval_tpu_torch.engine.session import EncodeRequest
from codec_eval_tpu_torch.errors import CodecError, QualityBelowThreshold
from test_torch_jpeg_enc import photo, tie_flips

TIERS = {
    "ssimulacra2": dict(rtol=1e-5, atol=0.0),
    "psnr": dict(rtol=1e-5, atol=0.0),
    "dssim": dict(rtol=1e-5, atol=1e-5),
    "butteraugli": dict(rtol=5e-4, atol=0.0),
}
IMG = photo(64, 64)
SWEEP_QUALITIES = [35.0, 70.0, 92.0]
PRESET_IDS = [c.id() for c in JaxCodec.presets()]


def assert_scores(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TIERS[k])


@pytest.mark.parametrize("shape", [(64, 64), (37, 53)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("index", range(8), ids=PRESET_IDS)
def test_preset_bytes_equal_jax(shape, index):
    img = photo(*shape)
    codec = TpuJpegCodec.presets(device="cpu")[index]
    jax_codec = JaxCodec.presets()[index]
    assert codec.id() == jax_codec.id() and codec.format() == "jpg"
    for q in (40.0, 85.0):
        got = codec.encode(ImageData.rgb8(img), EncodeRequest(q))
        assert got == jax_codec.encode(JaxImage.rgb8(img), JaxRequest(q)), (codec.id(), q)
    # One analysis pass for the sweep; the memo keyed by the pixels.
    assert codec.encode_sweep(ImageData.rgb8(img), [40.0, 85.0]) == [
        codec.encode(ImageData.rgb8(img), EncodeRequest(q)) for q in (40.0, 85.0)]


def test_codec_options_and_decode():
    with pytest.raises(CodecError):
        TpuJpegCodec(trellis=True, progressive=True, device="cpu")
    with pytest.raises(CodecError):
        TpuJpegCodec(subsampling="411", device="cpu")
    codec = TpuJpegCodec(trellis=True, device="cpu")
    assert codec.adaptive is False and codec.id() == "tpujpeg-420-trellis"
    assert TpuJpegCodec(colorspace="xyb", subsampling="420").subsampling == "444"
    assert codec.is_available() and codec.version() == "1.0"
    data = codec.encode(ImageData.rgb8(IMG), EncodeRequest(80.0))
    out = codec.decode(data).to_rgb8()
    assert out.shape == IMG.shape and np.abs(out.astype(int) - IMG).mean() < 8
    with pytest.raises(CodecError, match="decode failed"):
        codec.decode(b"\xff\xd8\xff\xdb junk")
    # A different image misses the one-slot memo.
    other = photo(64, 64, seed=8)
    assert codec.encode(ImageData.rgb8(other), EncodeRequest(80.0)) != data


# (kwargs of both sweeps, size mode)
SWEEPS = [
    dict(return_bytes=True),
    dict(subsampling="444", aq_strength=0.0, with_sizes="device"),
    dict(colorspace="xyb", return_bytes=True),
    dict(progressive=True, with_sizes="device"),
    dict(progressive=True, with_sizes=True),
    dict(aq_strength=0.0, trellis_lambda=0.1, return_bytes=True),
    dict(metrics=("ssimulacra2", "psnr"), with_sizes=False),
]


# Coefficients at a tie that round the other way in the port, counted on
# this file's image: one, in the XYB ladder at q92 (a Cb coefficient
# 2.4e-6 from its rounding boundary).  That quality's bytes then differ,
# and its scores are held to JAX's scores of the port's own bytes.
TIE_FLIPS = {"xyb": [0, 0, 1]}


@pytest.mark.parametrize("kwargs", SWEEPS, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_sweep_matches_jax(kwargs):
    got = evaluate_tpujpeg_sweep(IMG, SWEEP_QUALITIES, device="cpu", **kwargs)
    want = jts.evaluate_tpujpeg_sweep(IMG, SWEEP_QUALITIES, **kwargs)
    cs = kwargs.get("colorspace", "ycbcr")
    flips, _, _ = tie_flips(IMG, SWEEP_QUALITIES, "444" if cs == "xyb" else kwargs.get(
        "subsampling", "420"), cs, kwargs.get("aq_strength", 0.3), kwargs.get("trellis_lambda", 0.0))
    assert flips == TIE_FLIPS.get(cs, [0] * len(SWEEP_QUALITIES))
    assert len(got) == len(want) == len(SWEEP_QUALITIES)
    for g, w, n in zip(got, want, flips):
        assert g.quality == w.quality
        if n == 0:
            assert (g.file_size, g.bits_per_pixel, g.data) == (w.file_size, w.bits_per_pixel,
                                                                w.data)
            assert_scores(g.metrics, w.metrics)
        else:
            from codec_eval_tpu.codecs.jpeg_device import score_jpeg_files

            assert abs(g.file_size - w.file_size) <= 8
            assert_scores(g.metrics, score_jpeg_files(IMG, [g.data])[0])
    if kwargs.get("with_sizes") == "device":
        # Within the estimate's bound of the exact sizes.
        exact = evaluate_tpujpeg_sweep(IMG, SWEEP_QUALITIES, device="cpu",
                                       **{**kwargs, "with_sizes": True})
        for g, e in zip(got, exact):
            assert abs(g.file_size - e.file_size) <= max(6, 0.004 * e.file_size)


def test_sweep_bytes_are_the_codec_bytes():
    """The ladder's bytes are the codec's encodes at the same settings, and
    its scores those of ``score_jpeg_files`` on them."""
    from codec_eval_tpu_torch.codecs import score_jpeg_files

    for codec in TpuJpegCodec.presets(device="cpu"):
        pts = codec.device_sweep(ImageData.rgb8(IMG), SWEEP_QUALITIES, ("ssimulacra2", "psnr"),
                                 with_bytes=True)
        for p in pts:
            assert p.data == codec.encode(ImageData.rgb8(IMG), EncodeRequest(p.quality))
            assert p.file_size == len(p.data)
        rescored = score_jpeg_files(IMG, [p.data for p in pts], ("ssimulacra2", "psnr"),
                                    device="cpu")
        for p, r in zip(pts, rescored):
            assert r == p.metrics, codec.id()


def test_sweep_rejects_a_bad_size_mode_and_the_absent_card(monkeypatch):
    with pytest.raises(ValueError, match="with_sizes"):
        evaluate_tpujpeg_sweep(IMG, [50.0], with_sizes="estimate", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_tpujpeg_sweep(IMG, [50.0])


TARGETS = [
    dict(min_ssimulacra2=80.0),
    dict(min_ssimulacra2=50.0, max_bits_per_pixel=1.0),
    dict(max_butteraugli=3.0, progressive=True),
]


@pytest.mark.parametrize("target", TARGETS, ids=lambda k: ",".join(k))
def test_encode_to_target_matches_jax(target):
    grid = range(30, 99, 4)
    got = encode_to_target(IMG, qualities=grid, device="cpu", **target)
    want = jts.encode_to_target(IMG, qualities=grid, **target)
    assert (got.quality, got.file_size, got.data) == (want.quality, want.file_size, want.data)
    assert got.file_size == len(got.data)
    assert_scores(got.metrics, want.metrics)


@pytest.mark.parametrize("target, metric", [
    (dict(min_ssimulacra2=99.9, qualities=[30, 50]), "SSIMULACRA2"),
    (dict(min_ssimulacra2=60.0, max_bits_per_pixel=0.02, qualities=[50, 70, 90]),
     "bits_per_pixel"),
])
def test_encode_to_target_raises_like_jax(target, metric):
    with pytest.raises(QualityBelowThreshold) as got:
        encode_to_target(IMG, device="cpu", **target)
    with pytest.raises(JaxBelow) as want:
        jts.encode_to_target(IMG, **target)
    assert got.value.metric == want.value.metric == metric
    np.testing.assert_allclose(got.value.value, want.value.value, rtol=1e-5)
    with pytest.raises(ValueError, match="no target"):
        encode_to_target(IMG, device="cpu")
