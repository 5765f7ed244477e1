"""The port's codec-iter sources and codecs, PPM IO and profiling
utilities against the JAX package, on the CPU.

- ``utils.native.write_ppm`` writes the JAX function's bytes (which go
  through the native library when it is built), and ``read_ppm`` reads
  them back;
- ``iter/source.py`` is the JAX file's code, and its procedural corpora,
  tiers, PPM cache and errors give what JAX's give, compared with ``==``;
- ``iter/codecs.py`` is the JAX file's code for the PIL encoders, with the
  same summaries and bytes; ``build_codec`` and ``TpuJpegIterConfig`` take
  a ``device`` (tpujpeg's analysis and decode run there), and
  ``build_codec("tpujpeg")`` gives JAX's summaries and bytes;
- ``utils/profiling.py``'s ``device_trace(None)`` does nothing and
  ``device_trace(dir)`` writes a ``torch.profiler`` Chrome trace there.
"""

import inspect
import json

import numpy as np
import pytest
import torch
from PIL import Image

import codec_eval_tpu.iter as jiter
import codec_eval_tpu.iter.codecs as jcodecs
import codec_eval_tpu.iter.source as jsource
import codec_eval_tpu_torch.iter as titer
import codec_eval_tpu_torch.iter.codecs as tcodecs
import codec_eval_tpu_torch.iter.source as tsource
from codec_eval_tpu.utils import native as jnative
from codec_eval_tpu_torch.errors import ImageLoadError, UnsupportedFormat
from codec_eval_tpu_torch.utils import native as tnative
from test_torch_analysis import top_level_code
from test_torch_corpus_io import assert_jax_code


def _rgb(h=19, w=23, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


# -- PPM IO -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(19, 23), (1, 1), (64, 48)])
def test_write_ppm_bytes_equal_jax(tmp_path, shape):
    rgb = _rgb(*shape)
    tnative.write_ppm(tmp_path / "port.ppm", rgb)
    jnative.write_ppm(tmp_path / "jax.ppm", rgb)
    data = (tmp_path / "port.ppm").read_bytes()
    assert data == (tmp_path / "jax.ppm").read_bytes()
    assert data.startswith(f"P6\n{shape[1]} {shape[0]}\n255\n".encode())


def test_read_ppm_round_trips(tmp_path):
    rgb = _rgb()
    tnative.write_ppm(tmp_path / "a.ppm", rgb[:, ::-1])  # a strided view is written as its pixels
    back = tnative.read_ppm(tmp_path / "a.ppm")
    np.testing.assert_array_equal(back, rgb[:, ::-1])
    assert back.dtype == np.uint8 and back.flags.writeable
    jnative.write_ppm(tmp_path / "j.ppm", rgb)
    np.testing.assert_array_equal(tnative.read_ppm(tmp_path / "j.ppm"), rgb)
    np.testing.assert_array_equal(jnative.read_ppm(tmp_path / "a.ppm"), rgb[:, ::-1])


def test_read_ppm_refuses_other_files(tmp_path):
    """IOError, as the JAX binding raises it, so the source cache falls back
    to decoding the image."""
    (tmp_path / "p3.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(IOError, match="not a P6 PPM"):
        tnative.read_ppm(tmp_path / "p3.ppm")
    (tmp_path / "16bit.ppm").write_bytes(b"P6\n1 1\n65535\n" + bytes(6))
    with pytest.raises(IOError, match="not an 8-bit PPM"):
        tnative.read_ppm(tmp_path / "16bit.ppm")


# -- iter/source.py ---------------------------------------------------------


def test_source_module_is_the_jax_code():
    assert_jax_code("iter.source")


@pytest.mark.parametrize("n,size", [(3, 256), (2, 40)])
def test_synthetic_sources_equal_jax(n, size):
    got, want = tsource.synthetic_sources(n, size), jsource.synthetic_sources(n, size)
    assert [s.name for s in got] == [s.name for s in want]
    assert all(np.array_equal(g.rgb, w.rgb) for g, w in zip(got, want))


@pytest.mark.parametrize("n,size,seed", [(2, 64, 2026), (1, 96, 7)])
def test_photo_sources_equal_jax(n, size, seed):
    got, want = tsource.photo_sources(n, size, seed), jsource.photo_sources(n, size, seed)
    assert [s.name for s in got] == [s.name for s in want]
    assert all(np.array_equal(g.rgb, w.rgb) for g, w in zip(got, want))


@pytest.mark.parametrize("corpus,limit", [("synthetic-v1", 2), ("synthetic-v1", 0),
                                          ("synthetic-photo-v1", 1)])
def test_virtual_corpora_equal_jax(corpus, limit):
    got, want = tsource.load_sources(corpus, limit), jsource.load_sources(corpus, limit)
    assert len(got) == len(want) == (limit or 3)
    assert [s.name for s in got] == [s.name for s in want]
    assert all(np.array_equal(g.rgb, w.rgb) for g, w in zip(got, want))


def _tier_corpus(root, names):
    root.mkdir(parents=True)
    for i, name in enumerate(names):
        Image.fromarray(_rgb(12, 16, seed=i)).save(root / name)
    return root


@pytest.mark.parametrize("limit", [1, 3, 4, 5, 12, 16])
def test_tiers_and_ppm_cache_equal_jax(tmp_path, limit):
    """Tier files by ``--limit`` (some of MEDIUM absent, one extra file), a
    PPM cache written on the first load and read on the second."""
    names = tsource.MEDIUM[:9] + ["zz-extra.png"]
    loads = {}
    for side, mod in (("jax", jsource), ("port", tsource)):
        root = _tier_corpus(tmp_path / side, names)
        first = mod.load_sources(root, limit)
        cached = sorted(p.name for p in (root / tsource.CACHE_DIR_NAME).iterdir())
        second = mod.load_sources(root, limit)
        loads[side] = (root, first, second, cached)
    (jroot, jfirst, jsecond, jcached), (root, first, second, cached) = loads["jax"], loads["port"]
    assert cached == jcached and len(cached) == len(first)
    for name in cached:
        assert (root / tsource.CACHE_DIR_NAME / name).read_bytes() == (
            jroot / tsource.CACHE_DIR_NAME / name).read_bytes()
    for got, want in ((first, jfirst), (second, jsecond), (second, first)):
        assert [s.name for s in got] == [s.name for s in want]
        assert all(np.array_equal(g.rgb, w.rgb) for g, w in zip(got, want))


def test_source_errors_equal_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    for arg in (tmp_path / "missing", tmp_path / "empty"):
        with pytest.raises(ImageLoadError) as got:
            tsource.load_sources(arg, 2)
        with pytest.raises(jsource.ImageLoadError) as want:
            jsource.load_sources(arg, 2)
        assert str(got.value) == str(want.value)
    with pytest.raises(ImageLoadError, match="source image not found"):
        tsource.load_image(tmp_path, "nope.png")


# -- iter/codecs.py ---------------------------------------------------------

#: What the port's ``iter/codecs.py`` has that JAX's does not, and the reverse.
CODECS_ONLY_PORT = set()
CODECS_ONLY_JAX = set()


def test_codecs_module_is_the_jax_code_but_tpujpeg():
    port = top_level_code("codec_eval_tpu_torch.iter.codecs")
    jax_defs = top_level_code("codec_eval_tpu.iter.codecs")
    assert set(port) - set(jax_defs) == CODECS_ONLY_PORT
    assert set(jax_defs) - set(port) == CODECS_ONLY_JAX
    differ = {k for k in port if k in jax_defs and port[k] != jax_defs[k]}
    # Both take a device; the JAX config also checks for its native coder,
    # which the port builds at first use.
    assert differ == {"build_codec", "TpuJpegIterConfig"}


@pytest.mark.parametrize("fmt,kw", [("jpeg", {}), ("jpg", {"subsampling": "444"}),
                                    ("JPEG", {"progressive": False}), ("webp", {}),
                                    ("webp", {"webp_method": 6}), ("avif", {"preset": "fast"})])
def test_build_codec_equals_jax(fmt, kw):
    got, want = tcodecs.build_codec(fmt, **kw), jcodecs.build_codec(fmt, **kw)
    assert got.summary == want.summary
    rgb = _rgb(32, 32)
    data = got.encode(rgb, 70)
    assert data == want.encode(rgb, 70)
    np.testing.assert_array_equal(got.decode(data), want.decode(data))


def test_build_codec_errors():
    """The errors are JAX's; ``tpujpeg``, which raised while the device
    JPEG ladder was not ported, builds JAX's codecs."""
    rgb = _rgb(32, 32)
    for kw in ({}, {"xyb": True, "trellis": True}, {"subsampling": "444", "progressive": False}):
        got = tcodecs.build_codec("tpujpeg", device="cpu", **kw)
        want = jcodecs.build_codec("tpujpeg", **kw)
        assert got.summary == want.summary
        data = got.encode(rgb, 70)
        assert data == want.encode(rgb, 70)
        assert np.abs(got.decode(data).astype(int) - want.decode(data)).max() <= 1
    for args in (("gif",), ("jpeg", "440"), ("avif",)):
        kw = {"preset": "nope"} if args == ("avif",) else {}
        with pytest.raises(UnsupportedFormat) as got:
            tcodecs.build_codec(*args, **kw)
        with pytest.raises(jcodecs.UnsupportedFormat) as want:
            jcodecs.build_codec(*args, **kw)
        assert str(got.value) == str(want.value)


def test_iter_exports_follow_jax_without_the_device_ladder():
    """JAX's exports, ``TpuJpegIterConfig`` (the device ladder's) included."""
    jax_names = {n for n, v in vars(jiter).items()
                 if not n.startswith("_") and not inspect.ismodule(v)}
    assert jax_names - set(titer.__all__) == set()
    assert all(hasattr(titer, n) for n in titer.__all__)
    assert titer.TpuJpegIterConfig is tcodecs.TpuJpegIterConfig


# -- utils/profiling.py -----------------------------------------------------


def test_device_trace_none_is_a_no_op(tmp_path):
    from codec_eval_tpu_torch.utils.profiling import device_trace

    with device_trace(None):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from codec_eval_tpu_torch.utils.profiling import device_trace

    with device_trace(tmp_path / "trace"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    # The trace is written when the block raises, too.
    with pytest.raises(ValueError):
        with device_trace(tmp_path / "raised"):
            raise ValueError("inside")
    assert len(list((tmp_path / "raised").iterdir())) == 1
