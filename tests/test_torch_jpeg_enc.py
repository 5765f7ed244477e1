"""The port's tpujpeg encoder half (``kernels/jpeg_enc.py``) against the JAX
package's, on the CPU, at 64 x 64 and at 37 x 53 (partial MCUs):

- the tables, the DCT operators and the quality scaling equal JAX's;
- the transform's planes (DCTs, activity) within 1e-5 of JAX's, relative to
  each plane's largest value, for 4:2:0, 4:4:4, 4:2:2, 4:4:0 and XYB;
- the ladder's quantized coefficient planes equal JAX's except at ties,
  where ``|F| / q + bias`` lies within 1e-4 of an integer (the rounding
  boundary): the two DCTs add in different orders, so a coefficient there
  may round the other way.  The differing coefficients are counted, and
  every one must be a tie; on these images there are none;
- the ladder's candidates within one code value of JAX's, at least 99.99%
  equal (the chroma upsampling and the XYB inverse add in another order);
- the coefficient decode against JAX's, grayscale and batches included;
- the host quantizers equal JAX's; the device trellis DP equal to JAX's and
  to the native DP on JAX's own inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.engine.tpu_sweep import _qtabs_for as jax_qtabs
from codec_eval_tpu.kernels import jpeg_enc as je
from codec_eval_tpu_torch.kernels import jpeg_enc as te
from codec_eval_tpu_torch.utils import native

SHAPES = [(64, 64), (37, 53)]
QUALITIES = [30.0, 55.0, 80.0, 95.0]
# (subsampling, colorspace, aq_strength, trellis_lambda)
LADDERS = [
    ("420", "ycbcr", 0.3, 0.0),
    ("444", "ycbcr", 0.0, 0.0),
    ("422", "ycbcr", 0.3, 0.0),
    ("440", "ycbcr", 0.3, 0.0),
    ("444", "xyb", 0.3, 0.0),
    ("420", "ycbcr", 0.0, 0.1),
    ("444", "xyb", 0.0, 0.1),
]
TIE = 1e-4


def photo(h: int, w: int, seed: int = 7) -> np.ndarray:
    """``tests/test_tpujpeg.py``'s synthetic photo: smooth waves and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 70 * np.sin(x / 17.0) + 40 * np.cos(y / 11.0)
    img = np.stack([base, base * 0.9 + 10, base * 0.8 + 20], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def port_ladder(img, qualities, sub, cs, aq, lam, with_coefs=True):
    qt = jax_qtabs(qualities, cs)
    cands, coefs = te.reconstruct_sweep(torch.from_numpy(img), torch.from_numpy(qt), aq, sub, cs,
                                        with_coefs, lam)
    return cands.numpy(), {k: v.numpy() for k, v in coefs.items()}


def jax_ladder(img, qualities, sub, cs, aq, lam):
    fn = je.build_reconstruct_sweep(img.shape[0], img.shape[1], len(qualities), sub, cs,
                                    planar_candidates=True, with_coefs=True,
                                    trellis_lambda=lam)
    cands, coefs = fn(jnp.asarray(img), jnp.asarray(jax_qtabs(qualities, cs)), aq)
    return np.asarray(cands), {k: np.asarray(v) for k, v in coefs.items()}


def assert_candidates_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.9999, (diff.max(), np.mean(diff == 0))


# -- tables ------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "ZIGZAG", "ANNEX_K_LUMA", "ANNEX_K_CHROMA", "XYB_LUMA_BASE", "XYB_CHROMA_BASE",
    "XYB_ENC_RANGES", "DEFAULT_AC_LENGTHS_LUMA", "DEFAULT_AC_LENGTHS_CHROMA"])
def test_tables_equal_jax(name):
    got, want = getattr(te, name), getattr(je, name)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dct_operators_equal_jax():
    assert np.array_equal(te.dct8_matrix(), je.dct8_matrix())
    assert np.array_equal(te._zigzag_dct_matrix(), je._zigzag_dct_matrix())
    assert sorted(te.ZIGZAG.tolist()) == list(range(64))


@pytest.mark.parametrize("quality", [1, 10, 49.5, 50, 75, 95, 100, 120])
def test_quality_to_qtables_equal_jax(quality):
    for bases in ((te.ANNEX_K_LUMA, te.ANNEX_K_CHROMA), (te.XYB_LUMA_BASE, te.XYB_CHROMA_BASE)):
        got = te.quality_to_qtables(quality, *bases)
        want = je.quality_to_qtables(quality, *bases)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint16 and np.array_equal(g, w)


# -- the transform ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sub, cs", [("420", "ycbcr"), ("444", "ycbcr"), ("422", "ycbcr"),
                                     ("440", "ycbcr"), ("444", "xyb")])
def test_transform_planes_match_jax(shape, sub, cs):
    img = photo(*shape)
    got = te.jpeg_transform(img, sub, cs, device="cpu")
    want = je.jpeg_transform(img, sub, cs)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        scale = max(float(np.abs(want[k]).max()), 1.0)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5 * scale, err_msg=k)


def test_transform_rejects_what_jax_rejects():
    img = torch.zeros((16, 16, 3), dtype=torch.uint8)
    for sub, cs in (("411", "ycbcr"), ("444", "lab"), ("420", "xyb")):
        with pytest.raises(ValueError):
            te.transform(img, sub, cs)


# -- the ladder ------------------------------------------------------------------


def ties(img, qualities, sub, cs, aq) -> np.ndarray:
    """Where ``|F| / q + bias`` is within ``TIE`` of an integer, on JAX's
    planes: (n_q, ...) masks per plane, keyed "y", "cb", "cr"."""
    planes = je.jpeg_transform(img, sub, cs)
    qt = jax_qtabs(qualities, cs)[:, :, je.ZIGZAG]
    out = {}
    for key, q_i, act in (("y", 0, "act_y"), ("cb", 1, "act_c"), ("cr", 1, "act_c")):
        dct = planes[f"dct_{key}"]
        bias = np.clip(np.float32(0.5) - np.float32(aq) * planes[act], 0.2, 0.5)[..., None]
        bias = np.where(np.arange(64) == 0, np.float32(0.5), bias).astype(np.float32)
        v = np.abs(dct)[None] / qt[:, q_i, None, None, :] + bias[None]
        out[key] = np.abs(v - np.round(v)) < TIE
    return out


def tie_flips(img, qualities, sub="420", cs="ycbcr", aq=0.3, lam=0.0) -> list:
    """The number of quantized coefficients of each quality where the
    port's ladder and JAX's differ, asserting that each is at a tie (the
    trellis DP has no single rounding boundary: there every count must be
    0).  Also returns both ladders' candidates."""
    cands, coefs = port_ladder(img, qualities, sub, cs, aq, lam)
    jcands, jcoefs = jax_ladder(img, qualities, sub, cs, aq, lam)
    at_tie = ties(img, qualities, sub, cs, aq) if lam == 0.0 else None
    counts = np.zeros(len(qualities), np.int64)
    for k in jcoefs:
        assert coefs[k].dtype == np.int16 and coefs[k].shape == jcoefs[k].shape, k
        differ = coefs[k] != jcoefs[k]
        if at_tie is not None:
            assert not np.any(differ & ~at_tie[k]), k
        counts += differ.reshape(len(qualities), -1).sum(axis=1)
    return counts.tolist(), cands, jcands


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ladder", LADDERS, ids=lambda c: "-".join(map(str, c)))
def test_ladder_coefficients_and_candidates_match_jax(shape, ladder):
    sub, cs, aq, lam = ladder
    img = photo(*shape)
    flips, cands, jcands = tie_flips(img, QUALITIES, sub, cs, aq, lam)
    assert flips == [0] * len(QUALITIES)
    assert_candidates_close(cands, jcands)
    # Scores-only ladders give the same candidates and no coefficients.
    again, none = port_ladder(img, QUALITIES, sub, cs, aq, lam, with_coefs=False)
    assert none == {} and np.array_equal(again, cands)


def test_ladder_is_the_per_quality_ladder():
    """The quality axis is a batch dimension: each quality alone gives the
    same coefficients and candidates as in the whole ladder."""
    img = photo(64, 64)
    cands, coefs = port_ladder(img, QUALITIES, "420", "ycbcr", 0.3, 0.0)
    for qi, q in enumerate(QUALITIES):
        one, one_coefs = port_ladder(img, [q], "420", "ycbcr", 0.3, 0.0)
        assert np.array_equal(one[0], cands[qi])
        for k in coefs:
            assert np.array_equal(one_coefs[k][0], coefs[k][qi])


# -- the coefficient decode ------------------------------------------------------


@pytest.mark.parametrize("sub, cs", [("420", "ycbcr"), ("422", "ycbcr"), ("440", "ycbcr"),
                                     ("444", "xyb"), ("400", "ycbcr")])
def test_jpeg_decode_matches_jax(sub, cs):
    """Parsed streams of the port's encoder, decoded by both; batch=True
    against a stacked batch.  "400" decodes the luma of a 4:2:0 stream."""
    img = photo(37, 53)
    planes_sub = "420" if sub == "400" else sub
    _, coefs = port_ladder(img, [40.0, 90.0], planes_sub, cs, 0.3, 0.0)
    qt = jax_qtabs([40.0, 90.0], cs)[:, :, je.ZIGZAG]
    h, w = img.shape[:2]
    args = (coefs["y"], coefs["cb"], coefs["cr"], qt[:, 0], qt[:, 1])
    got = te.jpeg_decode(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), h, w, sub, cs)
    batch = je.build_jpeg_decode(h, w, sub, cs, planar=True, batch=True)
    want = np.asarray(batch(*(jnp.asarray(a) for a in args)))
    assert got.dtype == torch.uint8 and got.shape == (2, 3, h, w)
    assert_candidates_close(got.numpy(), want)
    single = je.build_jpeg_decode(h, w, sub, cs, planar=False)
    one = te.jpeg_decode(*(torch.from_numpy(np.ascontiguousarray(a[1])) for a in args), h, w,
                         sub, cs)
    assert np.array_equal(one.numpy(), got[1].numpy())
    assert_candidates_close(one.permute(1, 2, 0).numpy(),
                            np.asarray(single(*(jnp.asarray(a[1]) for a in args))))
    if sub == "400":
        assert (got[:, 0] == got[:, 1]).all() and (got[:, 1] == got[:, 2]).all()


def test_decode_of_the_ladder_coefficients_is_the_ladder():
    """A ladder's candidates are the decode of its own coefficients."""
    img = photo(37, 53)
    for sub, cs in (("420", "ycbcr"), ("444", "xyb")):
        cands, coefs = port_ladder(img, QUALITIES, sub, cs, 0.3, 0.0)
        qt = torch.from_numpy(jax_qtabs(QUALITIES, cs)[:, :, je.ZIGZAG])
        dec = te.jpeg_decode(*(torch.from_numpy(coefs[k]) for k in ("y", "cb", "cr")),
                             qt[:, 0], qt[:, 1], 37, 53, sub, cs)
        assert np.array_equal(dec.numpy(), cands)


# -- host quantizers and the trellis DP -----------------------------------------


def test_host_quantizers_equal_jax():
    img = photo(64, 64)
    planes = je.jpeg_transform(img, "420")
    ql, qc = je.quality_to_qtables(60)
    bias = np.clip(0.5 - 0.3 * planes["act_y"], 0.2, 0.5).astype(np.float32)
    for b in (0.5, 0.35, bias):
        got = te.quantize_blocks(planes["dct_y"], ql, b)
        assert got.dtype == np.int16 and np.array_equal(got, je.quantize_blocks(planes["dct_y"], ql, b))
    qz = [te.quantize_blocks(planes[k], q, 0.5)
          for k, q in (("dct_y", ql), ("dct_cb", qc), ("dct_cr", qc))]
    assert np.array_equal(te.ac_symbol_histogram(qz[0]), je.ac_symbol_histogram(qz[0]))
    hist = je.ac_symbol_histogram(qz[0])
    assert np.array_equal(te.huffman_code_lengths(hist), je.huffman_code_lengths(hist))
    for freq in (np.zeros(256, np.int64), np.eye(256, dtype=np.int64)[7]):
        assert np.array_equal(te.huffman_code_lengths(freq), je.huffman_code_lengths(freq))
    assert np.array_equal(te.ac_code_lengths(qz[1:]), je.ac_code_lengths(qz[1:]))
    # The numpy DP (a per-block lambda) and the native DP (a scalar one).
    lam = np.linspace(0.05, 0.3, planes["dct_y"].shape[0] * planes["dct_y"].shape[1]).reshape(
        planes["dct_y"].shape[:2]).astype(np.float32)
    for lmbda in (lam, 0.1):
        got = te.trellis_quantize_blocks(planes["dct_y"], ql, te.DEFAULT_AC_LENGTHS_LUMA, lmbda)
        want = je.trellis_quantize_blocks(planes["dct_y"], ql, je.DEFAULT_AC_LENGTHS_LUMA, lmbda)
        assert np.array_equal(got, want)


def trellis_inputs():
    """``tests/test_tpujpeg.py::test_trellis_device_dp_matches_host_dp``'s."""
    rng = np.random.default_rng(23)
    dct = rng.normal(0, 22, (14, 11, 64)).astype(np.float32)
    dct[..., 0] = rng.normal(0, 140, (14, 11))
    q = np.clip(np.linspace(2, 55, 64), 1, 255)
    return dct, q


@pytest.mark.parametrize("lengths", ["LUMA", "CHROMA"])
def test_trellis_dev_equals_jax_and_native(lengths):
    dct, q = trellis_inputs()
    table = getattr(te, f"DEFAULT_AC_LENGTHS_{lengths}")
    qzz = q.astype(np.float32)[je.ZIGZAG]
    got = te.trellis_quantize_dev(torch.from_numpy(dct), torch.from_numpy(qzz), table, 0.10)
    want = np.asarray(je.trellis_quantize_dev(jnp.asarray(dct), jnp.asarray(qzz), table, 0.10))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy().astype(np.int16),
                          native.trellis_quantize_native(dct, qzz, table, 0.10))
    assert np.array_equal(got.numpy().astype(np.int16),
                          je.trellis_quantize_blocks(dct, q, table, 0.10))


def test_trellis_dev_runs_a_ladder_in_one_dp():
    """Steps of shape (n_q, 1, 1, 64) give each quality's own DP."""
    dct, q = trellis_inputs()
    steps = np.stack([q * s for s in (0.5, 1.0, 2.0)]).astype(np.float32)[:, je.ZIGZAG]
    got = te.trellis_quantize_dev(torch.from_numpy(dct), torch.from_numpy(steps[:, None, None]),
                                  te.DEFAULT_AC_LENGTHS_LUMA, 0.2)
    assert got.shape == (3, 14, 11, 64)
    for i in range(3):
        one = native.trellis_quantize_native(dct, steps[i], te.DEFAULT_AC_LENGTHS_LUMA, 0.2)
        assert np.array_equal(got[i].numpy().astype(np.int16), one)
