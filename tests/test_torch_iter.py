"""The port's codec-iter layer (``codec_eval_tpu_torch.iter``) against the
JAX package's: ``run_eval`` with one numpy "codec" (quantize to a step) on
two 24x24 images x 3 qualities, the baseline JSON and its comparison table,
and the sweep's ranking and printed table."""

import json

import numpy as np
import pytest
import torch

from codec_eval_tpu import iter as jiter
from codec_eval_tpu_torch import iter as titer

QUALITIES = [20, 60, 90]
H = W = 24


def _images(mod):
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([xx * 255 // W, yy * 255 // H, (xx + yy) * 255 // (H + W)], -1)
    return [
        mod.SourceImage(f"img{i}", np.clip(base + rng.integers(0, 60, (H, W, 3)), 0, 255)
                        .astype(np.uint8))
        for i in range(2)
    ]


def _codec(mod, coarse=1.0):
    """Quantize every sample to a step that shrinks as the quality rises;
    the bytes are the quantized pixels."""
    def encode(rgb, q):
        step = coarse * (101 - q) / 4.0
        return (np.round(rgb / step) * step).clip(0, 255).astype(np.uint8).tobytes()

    def decode(data):
        return np.frombuffer(data, np.uint8).reshape(H, W, 3)

    return mod.Codec(encode, decode, f"quantize-x{coarse}")


@pytest.fixture(scope="module")
def results():
    port = titer.run_eval(_images(titer), _codec(titer), QUALITIES, device="cpu")
    jax_ = jiter.run_eval(_images(jiter), _codec(jiter), QUALITIES)
    return port, jax_


def test_run_eval_matches_jax(results):
    port, jax_ = results
    assert port.config_summary == jax_.config_summary
    assert len(port.points) == len(jax_.points) == 2 * len(QUALITIES)
    for p, j in zip(port.points, jax_.points):
        assert (p.image, p.quality, p.bpp, p.size_bytes) == (j.image, j.quality, j.bpp,
                                                             j.size_bytes)
        assert isinstance(p.ssim2, float)
        assert p.ssim2 == pytest.approx(j.ssim2, rel=1e-5)
    assert [p.ssim2 for p in port.points[:3]] == sorted(p.ssim2 for p in port.points[:3])


def test_run_eval_progress_empty_and_device():
    seen = []
    out = titer.run_eval(_images(titer)[:1], _codec(titer), [50], progress=seen.append,
                         device="cpu")
    assert seen == ["[1/1] img0"] and len(out.points) == 1
    empty = titer.run_eval([], _codec(titer), QUALITIES, device="cpu")
    assert empty.points == [] and empty.total_ms == 0


def test_run_eval_on_cuda_without_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        titer.run_eval(_images(titer), _codec(titer), QUALITIES)


def _jax_points(points):
    return [jiter.EvalPoint.from_json(p.to_json()) for p in points]


def test_baseline_json_matches_jax(results, tmp_path):
    port, jax_ = results
    tb = titer.make_baseline("jpeg", port.config_summary, "corpus/x", port.points)
    jb = jiter.make_baseline("jpeg", port.config_summary, "corpus/x", _jax_points(port.points))
    tj, jj = tb.to_json(), jb.to_json()
    assert tj.pop("created_at") and jj.pop("created_at")
    assert tj == jj
    # The port writes a file the JAX package reads back, and the reverse.
    jiter.load_baseline(titer.save_baseline(tmp_path / "port", tb).parent, "jpeg")
    back = titer.load_baseline(jiter.save_baseline(tmp_path / "jax", jb).parent, "jpeg")
    assert back.to_json() == json.loads(json.dumps(jb.to_json()))
    assert titer.load_baseline(tmp_path, "missing") is None
    # The comparison table against a shifted baseline.
    shifted = [titer.EvalPoint(**{**p.to_json(), "bpp": p.bpp + 0.1, "ssim2": p.ssim2 - 1.0})
               for p in port.points if p.quality != 90]
    trows = titer.compare_with_baseline(
        port.points, titer.make_baseline("jpeg", "", "", shifted)
    )
    jrows = jiter.compare_with_baseline(
        _jax_points(port.points), jiter.make_baseline("jpeg", "", "", _jax_points(shifted))
    )
    assert [vars(r) for r in trows] == [vars(r) for r in jrows]
    assert [r.quality for r in trows] == QUALITIES and trows[-1].delta_bpp == 0.0


def test_run_sweep_ranking_matches_jax(capsys):
    codecs = [1.0, 3.0]
    port = titer.run_sweep(_images(titer), [_codec(titer, c) for c in codecs], QUALITIES,
                           device="cpu")
    jax_ = jiter.run_sweep(_images(jiter), [_codec(jiter, c) for c in codecs], QUALITIES)
    tr, jr = port.ranked(), jax_.ranked()
    assert [r[0] for r in tr] == [r[0] for r in jr] == ["quantize-x1.0", "quantize-x3.0"]
    for t, j in zip(tr, jr):
        assert t[1] == j[1] and t[2] == pytest.approx(j[2], rel=1e-5)
    # The printed table, with the wall times made equal.
    for name in port.configs:
        port.configs[name].total_ms = jax_.configs[name].total_ms = 7
    titer.print_sweep(port)
    ours = capsys.readouterr().out
    jiter.print_sweep(jax_)
    assert ours == capsys.readouterr().out and "quantize-x1.0" in ours
