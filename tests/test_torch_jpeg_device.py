"""The port's device JPEG decoding (``codecs/jpeg_device.py``) against the
JAX package's, on the CPU: the parse is the same native code; the decode of
baseline, progressive, 4:2:2, XYB and grayscale streams is within one code
value of JAX's and at least 99.99% equal; ``score_jpeg_files`` on a mixed
batch at the port's score tiers; corrupt and unsupported streams raise
JAX's error classes.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from codec_eval_tpu.codecs import jpeg_device as jd
from codec_eval_tpu.errors import UnsupportedFormat as JaxUnsupported
from codec_eval_tpu_torch.codecs import jpeg_device as td
from codec_eval_tpu_torch.codecs.tpujpeg import TpuJpegCodec
from codec_eval_tpu_torch.engine.image import ImageData
from codec_eval_tpu_torch.engine.session import EncodeRequest
from codec_eval_tpu_torch.errors import DimensionMismatch, UnsupportedFormat
from test_torch_jpeg_enc import assert_candidates_close, photo
from test_torch_tpujpeg import assert_scores

IMG = photo(48, 56)


def pil_bytes(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def tpujpeg_bytes(img, q=80.0, **kw) -> bytes:
    return TpuJpegCodec(device="cpu", **kw).encode(ImageData.rgb8(img), EncodeRequest(q))


STREAMS = {
    "pil-420": lambda: pil_bytes(IMG, quality=75),
    "pil-444-progressive": lambda: pil_bytes(IMG, quality=85, subsampling=0, progressive=True),
    "pil-422": lambda: pil_bytes(IMG, quality=60, subsampling=1),
    "tpujpeg-xyb": lambda: tpujpeg_bytes(IMG, colorspace="xyb"),
    "tpujpeg-440-prog": lambda: tpujpeg_bytes(IMG, subsampling="440", progressive=True),
    "gray": lambda: pil_bytes(np.asarray(Image.fromarray(IMG).convert("L")), quality=80),
    "gray-progressive": lambda: pil_bytes(np.asarray(Image.fromarray(IMG).convert("L")),
                                          quality=80, progressive=True),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_parse_and_decode_match_jax(name):
    data = STREAMS[name]()
    got, want = td.parse_jpeg(data), jd.parse_jpeg(data)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]) if isinstance(want[k], np.ndarray) else (
            got[k] == want[k]), k
    dec = td.decode_jpeg_device(data, device="cpu")
    assert dec.dtype == np.uint8 and dec.shape == IMG.shape
    assert_candidates_close(dec, jd.decode_jpeg_device(data))
    planar = td.decode_jpeg_to_device(data, device="cpu")
    assert isinstance(planar, torch.Tensor) and np.array_equal(planar.permute(1, 2, 0).numpy(), dec)
    if name.startswith("gray"):
        assert got["subsampling"] == "400"
        assert (dec[..., 0] == dec[..., 1]).all() and (dec[..., 1] == dec[..., 2]).all()


def test_score_jpeg_files_matches_jax():
    """A batch mixing decode configurations, in input order, all four
    metrics and a subset."""
    batch = [STREAMS[k]() for k in ("pil-420", "tpujpeg-xyb", "pil-444-progressive",
                                    "gray", "tpujpeg-440-prog")]
    batch.insert(2, tpujpeg_bytes(IMG, q=40.0))
    got = td.score_jpeg_files(IMG, batch, device="cpu")
    want = jd.score_jpeg_files(IMG, batch)
    assert len(got) == len(want) == len(batch)
    for g, w in zip(got, want):
        assert_scores(g, w)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        some = td.score_jpeg_files(IMG, batch[:2], metrics=("psnr", "ssimulacra2"),
                                   parse_pool=pool, device="cpu")
    assert [set(s) for s in some] == [{"psnr", "ssimulacra2"}] * 2
    assert [s["psnr"] for s in some] == [g["psnr"] for g in got[:2]]


def test_unsupported_and_corrupt_streams_raise_like_jax():
    cmyk = io.BytesIO()
    Image.fromarray(IMG).convert("CMYK").save(cmyk, "JPEG")
    for parse, unsupported in ((td.parse_jpeg, UnsupportedFormat),
                               (jd.parse_jpeg, JaxUnsupported)):
        with pytest.raises(unsupported):
            parse(cmyk.getvalue())
        for junk in (b"\xff\xd8\xff\xdb junk", bytes([0xFF, 0xD8, 0xFF, 0xDB])):
            with pytest.raises((ValueError, unsupported)):
                parse(junk)
    with pytest.raises(DimensionMismatch):
        td.score_jpeg_files(IMG, [pil_bytes(IMG[:32, :32], quality=75)], device="cpu")
    # Truncated entropy data decodes leniently, as in JAX.
    good = pil_bytes(IMG, quality=75)
    sos = good.index(b"\xff\xda")
    cut = good[: (sos + len(good)) // 2]
    assert_candidates_close(td.decode_jpeg_device(cut, device="cpu"), jd.decode_jpeg_device(cut))


def test_parser_survives_mutations():
    """``tests/test_jpeg_device_decode.py``'s mutation fuzz through the
    port's binding: every mutated stream parses or raises."""
    rng = np.random.default_rng(7)
    for data in (pil_bytes(IMG, quality=70), pil_bytes(IMG, quality=70, progressive=True)):
        raw = bytearray(data)
        for _ in range(100):
            mut = bytearray(raw)
            for _ in range(int(rng.integers(1, 4))):
                mut[int(rng.integers(2, len(mut)))] = int(rng.integers(0, 256))
            try:
                assert td.parse_jpeg(bytes(mut))["y"].shape[2] == 64
            except (ValueError, UnsupportedFormat):
                pass


def test_decode_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.decode_jpeg_device(STREAMS["pil-420"]())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.score_jpeg_files(IMG, [STREAMS["pil-420"]()])
