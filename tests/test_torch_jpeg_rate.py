"""The port's device rate accounting (``kernels/jpeg_rate.py``) against the
JAX package's and against the native coder's own statistics export, on the
CPU.  Fed the same quantized coefficient planes, the packed baseline and
progressive histograms equal JAX's and the oracle's exactly, and so do the
size estimates; the host half is JAX's code and closes the file length to
the byte given the oracle's stuffing count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codec_eval_tpu.kernels import jpeg_enc as je
from codec_eval_tpu.kernels import jpeg_rate as jr
from codec_eval_tpu_torch.kernels import jpeg_enc as te
from codec_eval_tpu_torch.kernels import jpeg_rate as tr
from codec_eval_tpu_torch.utils import native
from test_torch_jpeg_enc import photo

IMG = photo(64, 64)


def quantized(img, sub: str, q: int, bias=0.5):
    planes = te.jpeg_transform(img, sub, device="cpu")
    ql, qc = te.quality_to_qtables(q)
    return (te.quantize_blocks(planes["dct_y"], ql, bias),
            te.quantize_blocks(planes["dct_cb"], qc, bias),
            te.quantize_blocks(planes["dct_cr"], qc, bias), ql, qc)


def port_stats(planes, sub, hw=None):
    args = [torch.from_numpy(p[None]) for p in planes]
    if hw is None:
        return tr.ladder_rate_stats(*args, sub).numpy()[0]
    return tr.progressive_ladder_rate_stats(*args, *hw, sub).numpy()[0]


def jax_stats(planes, sub, hw=None):
    fn = (jr.build_ladder_rate_stats(sub) if hw is None
          else jr.build_progressive_ladder_rate_stats(*hw, sub))
    return np.asarray(fn(*(jnp.asarray(p[None]) for p in planes)))[0]


@pytest.mark.parametrize("sub", ["420", "444", "422", "440"])
@pytest.mark.parametrize("q", [50, 90])
def test_baseline_stats_equal_jax_and_the_coder(sub, q):
    cy, ccb, ccr, ql, qc = quantized(IMG, sub, q, bias=0.35)
    got = port_stats((cy, ccb, ccr), sub)
    assert got.dtype == np.int64 and got.shape == (tr.PACKED_STATS_WIDTH,)
    assert np.array_equal(got, jax_stats((cy, ccb, ccr), sub))
    oracle = native.jpeg_scan_stats(sub, cy, ccb, ccr)
    assert np.array_equal(got[:16], oracle["dc_freq"][0][:16])
    assert np.array_equal(got[16:32], oracle["dc_freq"][1][:16])
    assert np.array_equal(got[32:288], oracle["ac_freq"][0])
    assert np.array_equal(got[288:544], oracle["ac_freq"][1])
    # The estimate is JAX's, and exact but for the stuffing.
    assert tr.size_estimates_from_packed(got[None]) == jr.size_estimates_from_packed(got[None])
    bits, _ = tr.scan_bits_from_hists(got[:16], got[16:32], got[32:288], got[288:544])
    assert (bits + 7) // 8 == oracle["scan_bytes"] - oracle["stuffed"]
    data = native.jpeg_encode_baseline(64, 64, sub, cy, ccb, ccr, ql[te.ZIGZAG], qc[te.ZIGZAG])
    est = tr.size_estimates_from_packed(got[None])[0]
    assert est - int(round((bits + 7) // 8 / 368.0)) + oracle["stuffed"] == len(data)


@pytest.mark.parametrize("sub", ["420", "444", "422", "440"])
def test_progressive_stats_equal_jax_and_the_coder(sub):
    img = photo(37, 53)
    cy, ccb, ccr, ql, qc = quantized(img, sub, 75)
    hw = img.shape[:2]
    got = port_stats((cy, ccb, ccr), sub, hw)
    assert got.shape == (tr.PACKED_STATS_WIDTH_PROGRESSIVE,)
    assert np.array_equal(got, jax_stats((cy, ccb, ccr), sub, hw))
    oracle = native.jpeg_scan_stats_progressive(hw[1], hw[0], sub, cy, ccb, ccr)
    assert np.array_equal(got[32:288], oracle["ac_freq"][0])
    assert np.array_equal(got[288:544] + got[544:800], oracle["ac_freq"][1])
    assert np.array_equal(got[800:1056], oracle["ac_freq"][2])
    assert (tr.progressive_size_estimates_from_packed(got[None])
            == jr.progressive_size_estimates_from_packed(got[None]))
    data = native.jpeg_encode_baseline(hw[1], hw[0], sub, cy, ccb, ccr, ql[te.ZIGZAG],
                                       qc[te.ZIGZAG], progressive=True)
    est = tr.progressive_size_estimates_from_packed(got[None])[0]
    scan = oracle["scan_bytes"] - oracle["stuffed"]
    assert est - int(round(scan / 368.0)) + oracle["stuffed"] == len(data)


def test_progressive_eobrun_cap_and_long_runs():
    """``tests/test_jpeg_rate.py``'s sparse 256 px image: EOB runs of
    hundreds of blocks, bucketed as the coder does."""
    rng = np.random.default_rng(3)
    img = np.full((256, 256, 3), 128, np.uint8)
    for _ in range(5):
        yy, xx = rng.integers(0, 256 - 8, 2)
        img[yy:yy + 8, xx:xx + 8] = rng.integers(0, 255, (8, 8, 3))
    cy, ccb, ccr, _, _ = quantized(img, "444", 85)
    got = port_stats((cy, ccb, ccr), "444", (256, 256))
    oracle = native.jpeg_scan_stats_progressive(256, 256, "444", cy, ccb, ccr)
    assert np.array_equal(got[32:288], oracle["ac_freq"][0])
    assert np.array_equal(got[800:1056], oracle["ac_freq"][2])
    assert np.array_equal(got, jax_stats((cy, ccb, ccr), "444", (256, 256)))


def test_eobrun_cap_at_0x7fff():
    """More than 32767 consecutive empty bands: an EOBRUN(32767) symbol
    (0xE0) and the remainder's bucket, as the coder counts them."""
    by, bx = 180, 184  # 33120 blocks of 4:4:4
    cy = np.zeros((by, bx, 64), np.int16)
    cy[0, 0, 10] = 1  # outside band 1..5, inside 6..63
    ccb = np.zeros_like(cy)
    got = port_stats((cy, ccb, ccb), "444", (by * 8, bx * 8))
    oracle = native.jpeg_scan_stats_progressive(bx * 8, by * 8, "444", cy, ccb, ccb)
    assert got[32 + 0xE0] == 1 and got[32 + 0x80] == 1  # 33120 = 32767 + 353
    assert np.array_equal(got[32:288], oracle["ac_freq"][0])
    assert np.array_equal(got[288:544] + got[544:800], oracle["ac_freq"][1])
    assert np.array_equal(got[800:1056], oracle["ac_freq"][2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_random_planes_match_the_coder(seed):
    """``tests/test_jpeg_rate.py``'s adversarial planes: dense large
    magnitudes, empty blocks, isolated spikes, long zero runs."""
    rng = np.random.default_rng(seed)
    by, bx = 6, 8
    h, w = by * 8, bx * 8

    def plane(shape, density, mag):
        p = rng.integers(-mag, mag + 1, (*shape, 64)).astype(np.int16)
        mask = rng.random((*shape, 64)) < density
        p = np.where(mask, p, 0).astype(np.int16)
        p[..., 0] = rng.integers(-1023, 1024, shape)
        return np.clip(p, -1023, 1023).astype(np.int16)

    density = [0.02, 0.5, 0.95][seed]
    mag = [1023, 37, 3][seed]
    cy = plane((by, bx), density, mag)
    ccb = plane((by // 2, bx // 2), density, mag)
    ccr = plane((by // 2, bx // 2), density, mag)
    cy[0] = 0
    cy[0, :, 0] = 7
    got = port_stats((cy, ccb, ccr), "420")
    o = native.jpeg_scan_stats("420", cy, ccb, ccr)
    assert np.array_equal(got[32:288], o["ac_freq"][0])
    assert np.array_equal(got[:16], o["dc_freq"][0][:16])
    assert np.array_equal(got, jax_stats((cy, ccb, ccr), "420"))
    prog = port_stats((cy, ccb, ccr), "420", (h, w))
    op = native.jpeg_scan_stats_progressive(w, h, "420", cy, ccb, ccr)
    assert np.array_equal(prog[32:288], op["ac_freq"][0])
    assert np.array_equal(prog[288:544] + prog[544:800], op["ac_freq"][1])
    assert np.array_equal(prog[800:1056], op["ac_freq"][2])


def test_ladder_stats_are_the_per_quality_stats():
    """A whole ladder in one call equals each quality's own statistics."""
    rows = [quantized(IMG, "420", q)[:3] for q in (30, 60, 90)]
    ladder = tr.ladder_rate_stats(*(torch.from_numpy(np.stack(p)) for p in zip(*rows)), "420")
    for i, planes in enumerate(rows):
        assert np.array_equal(ladder[i].numpy(), port_stats(planes, "420"))


def test_t81_code_sizes_degenerate_histograms():
    freq = np.zeros(256, dtype=np.int64)
    freq[0] = 100
    sizes, n = tr.t81_code_sizes(freq)
    assert n == 1 and sizes[0] == 1
    sizes, n = tr.t81_code_sizes(np.zeros(256, dtype=np.int64))
    assert n == 0 and sizes.sum() == 0
    hist = je.ac_symbol_histogram(quantized(IMG, "444", 70)[0])
    for g, w in zip(tr.t81_code_sizes(hist), jr.t81_code_sizes(hist)):
        assert np.array_equal(g, w)
