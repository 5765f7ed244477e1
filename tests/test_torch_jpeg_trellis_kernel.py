"""K10, the trellis DP kernel (``csrc/jpeg_trellis.cu``), its launcher
``kernels.cuda.jpeg_trellis.trellis_dp`` and the function that takes it,
``kernels.jpeg_enc.trellis_quantize_dev``.

On the CPU:

- ``ladder_form`` maps the two ladder broadcasts the port uses, and one
  quality's steps, onto the kernel's (n_blocks, 64) x (n_q, 64) form and
  refuses every other one;
- ``LAUNCHERS`` holds the wrappers' counters and K10's;
- CPU tensors take the plain version (``trellis_quantize_plain``) and
  launch nothing; a tensor on another device raises;
- K10's rate table holds the plain version's f32 products lam * RT;
- ``ladder.trellis_dp_ns_per_block`` reads the kernel's device time over
  the program's ``jpeg.trellis_blocks`` counter, and None without either.

The tests marked ``chip`` need a CUDA device and skip without one; they
hold the kernel to the plain version on the card bit for bit
(``torch.equal``), and to the plain version on the CPU, the one
``tests/test_torch_jpeg_enc.py`` holds to the JAX package.  This file
imports no JAX, so on a machine with a card
they run with
``python3 -m pytest tests/test_torch_jpeg_trellis_kernel.py -m chip --noconftest``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from codec_eval_tpu_torch.kernels import jpeg_enc as te
from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS, WRAPPERS, jpeg_trellis
from codec_eval_tpu_torch.utils import profiling
from portbench.harness import Run, load_reader
from portbench.trace import Trace

LUMA, CHROMA = te.DEFAULT_AC_LENGTHS_LUMA, te.DEFAULT_AC_LENGTHS_CHROMA
LADDER = [float(q) for q in range(10, 100, 2)]  # rd-calibrate's q10:2:98


def trellis_inputs():
    """``tests/test_torch_jpeg_enc.py``'s (that file imports JAX)."""
    rng = np.random.default_rng(23)
    dct = rng.normal(0, 22, (14, 11, 64)).astype(np.float32)
    dct[..., 0] = rng.normal(0, 140, (14, 11))
    q = np.clip(np.linspace(2, 55, 64), 1, 255)
    return dct, q


def ladder_steps(q, scales=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(n_q, 64) zigzag steps: ``q`` (natural order) scaled per quality.
    numpy's gather leaves them column-major (the wrapper copies such steps)."""
    return np.stack([np.clip(q * s, 1, 255) for s in scales]).astype(np.float32)[:, te.ZIGZAG]


def edge_blocks(seed: int = 5):
    """(n, 64) coefficients and (2, 64) steps that reach the DP's edges:
    all-zero blocks; magnitudes at and above 1,023 and DCs past the 2,047
    clamp, both signs; and blocks on a half-step grid, where under a flat
    rate table and lam a power of two many costs tie exactly (x = c + 1/2
    gives both candidates the same distortion, and equal sizes the same
    rate)."""
    rng = np.random.default_rng(seed)
    steps = np.ones((2, 64), np.float32)
    steps[1] = 2.0
    grid = (rng.integers(-6, 7, (240, 64)) / 2).astype(np.float32)
    zeros = np.zeros((16, 64), np.float32)
    halves = np.full((16, 64), 2.5, np.float32)
    big = rng.choice([-1.0, 1.0], (16, 64)).astype(np.float32) * rng.uniform(
        1022.5, 1600.0, (16, 64)).astype(np.float32)
    big[:, 0] = np.array([3000.0, -3000.0, 2046.5, -2047.5] * 4, np.float32)
    big[:4, 1:] = np.float32(1023.0)
    return np.concatenate([zeros, halves, big, grid]), steps


FLAT = np.full((16, 11), 4.0, np.float32)


# -- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("dct, q, want", [
    ((64, 64, 64), (45, 1, 1, 64), (45, 4096)),          # a 512 px ladder's luma
    ((32, 2, 32, 64), (45, 1, 1, 1, 64), (45, 2048)),    # its stacked chroma
    ((7, 64), (3, 1, 64), (3, 7)),
    ((0, 5, 64), (2, 1, 1, 64), (2, 0)),
    ((14, 11, 64), (64,), (1, 154)),                     # one quality's steps
    ((14, 11, 64), (1, 1, 64), (1, 154)),
    ((14, 11, 64), (1, 1, 1, 64), (1, 154)),             # a ladder of one
])
def test_ladder_form_maps_the_ports_broadcasts(dct, q, want):
    assert jpeg_trellis.ladder_form(dct, q) == want


@pytest.mark.parametrize("dct, q", [
    ((14, 11, 64), (2, 1, 64)),        # same rank, steps varying by row
    ((14, 11, 64), (1, 11, 64)),       # one quality, per-column steps
    ((14, 11, 64), (3, 11, 1, 64)),    # per-row steps
    ((14, 11, 64), (3, 1, 11, 64)),
    ((14, 11, 64), (3, 1, 1, 1, 64)),  # two axes too many
    ((14, 11, 32), (3, 1, 1, 32)),     # not 64 coefficients
    ((14, 11, 64), (3, 1, 1, 32)),
])
def test_ladder_form_refuses_other_broadcasts(dct, q):
    with pytest.raises(ValueError, match="ladder"):
        jpeg_trellis.ladder_form(dct, q)


def test_launchers_are_the_wrappers_and_k10():
    """One table of launch counters: K1-K9's wrappers and K10, whose
    source is built with theirs and which stands for the JAX DP's scan."""
    assert LAUNCHERS == {**WRAPPERS, "trellis_dp": jpeg_trellis.trellis_dp}
    k10 = LAUNCHERS["trellis_dp"]
    assert k10.source.endswith("csrc/jpeg_trellis.cu")
    assert k10.source.rsplit("/", 1)[1] in {p.name for p in jpeg_trellis._lib.sources()}
    path, line = k10.replaces.split(":")
    text = (Path(__file__).resolve().parents[1] / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def trellis_quantize_dev(")


def test_grid_covers_small_launches_and_strides_large_ones():
    assert jpeg_trellis.grid(1, 132) == 1
    assert jpeg_trellis.grid(9, 132) == 2
    assert jpeg_trellis.grid(45 * 4096, 132) == 132 * jpeg_trellis.CTAS_PER_SM


@pytest.mark.parametrize("lengths", ["LUMA", "CHROMA"])
def test_cpu_tensors_take_the_plain_path(lengths):
    dct, q = trellis_inputs()
    table = getattr(te, f"DEFAULT_AC_LENGTHS_{lengths}")
    steps = torch.from_numpy(ladder_steps(q)[:, None, None])
    before = jpeg_trellis.trellis_dp.launches
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = te.trellis_quantize_dev(torch.from_numpy(dct), steps, table, 0.10)
    want = te.trellis_quantize_plain(torch.from_numpy(dct), steps, table, 0.10)
    assert jpeg_trellis.trellis_dp.launches == before
    assert "jpeg.trellis_blocks" not in profiling.counters()
    assert got.shape == (3, 14, 11, 64) and torch.equal(got, want)


def test_another_device_raises():
    dct = torch.empty((4, 64), device="meta")
    q = torch.empty((2, 1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        te.trellis_quantize_dev(dct, q, LUMA, 0.1)
    with pytest.raises(ValueError, match="ladder"):
        te.trellis_quantize_dev(dct, q[:, 0], LUMA, 0.1)


@pytest.mark.parametrize("lmbda", [0.1, 0.35, 1.0])
def test_rate_table_is_the_plain_versions_products(lmbda):
    """K10's table at [s, r] is the f32 product lam * RT[r, s] that the
    plain version's ``lam * by_size`` forms."""
    for lengths in (LUMA, CHROMA):
        got = te._rate_table(lengths.tobytes(), lmbda)
        rt = torch.from_numpy(te._run_table(lengths.tobytes()).copy())
        want = (torch.tensor(np.float32(lmbda)) * rt).numpy().T
        assert got.shape == (11, 63) and got.dtype == np.float32 and got.flags.c_contiguous
        assert np.array_equal(got, want)


KERNEL_NAME = "void (anonymous namespace)::trellis_dp_kernel(float const*, float const*, float*, int)"


def _run(device, trace=True) -> Run:
    t = Trace(window=(0.0, 1000.0), device=device, host=[], calls=2, pairs=90)
    return Run(cell=None, seed=0, setup_s=0.0, window=(0.0, 1.0), calls=[], peak_bytes=0,
               trace=t if trace else None)


def test_trellis_dp_ns_per_block_reader(monkeypatch):
    read = load_reader("ladder.trellis_dp_ns_per_block")
    device = [(KERNEL_NAME, 100.0, 130.0), ("elementwise_kernel", 130.0, 200.0),
              (KERNEL_NAME, 300.0, 310.0)]
    monkeypatch.setattr(profiling, "counters", lambda: {"jpeg.trellis_blocks": 8000})
    assert read(_run(device)) == pytest.approx(40e-6 * 1e9 / 8000)  # 5 ns per block
    assert read(_run(device, trace=False)) is None
    assert read(_run(device[1:2])) is None  # no K10 in the trace: the parent's program
    monkeypatch.setattr(profiling, "counters", lambda: {"jpeg.trellis_blocks": 0})
    assert read(_run(device)) is None
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert read(_run(device)) is None
    monkeypatch.delattr(profiling, "counters")  # a program without counters
    assert read(_run(device)) is None


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(card, dct: np.ndarray, steps: np.ndarray, table, lmbda: float, q_shape=None):
    """K10 against the plain version bit for bit, on the card and on the
    CPU; the kernel launches once.  ``steps`` (n_q, 64) go in as a ladder,
    (n_q, 1, ..., 1, 64), unless ``q_shape`` gives another form."""
    q_shape = q_shape or (steps.shape[0], *([1] * (dct.ndim - 1)), 64)
    f, q = torch.from_numpy(dct), torch.from_numpy(steps).reshape(q_shape)
    before = jpeg_trellis.trellis_dp.launches
    got = te.trellis_quantize_dev(f.to(card), q.to(card), table, lmbda)
    assert jpeg_trellis.trellis_dp.launches == before + 1
    want = te.trellis_quantize_plain(f.to(card), q.to(card), table, lmbda)
    torch.cuda.synchronize()
    assert got.shape == want.shape == torch.broadcast_shapes(f.shape, q.shape)
    assert torch.equal(got, want), f"{int((got != want).sum())} values differ"
    host = te.trellis_quantize_plain(f, q, table, lmbda)
    assert torch.equal(got.cpu(), host), f"{int((got.cpu() != host).sum())} values differ"
    return got


@pytest.mark.chip
@pytest.mark.parametrize("lengths", ["LUMA", "CHROMA"])
def test_kernel_equals_plain_on_trellis_inputs(card, lengths):
    dct, q = trellis_inputs()
    table = getattr(te, f"DEFAULT_AC_LENGTHS_{lengths}")
    _held(card, dct, ladder_steps(q, (1.0,)), table, 0.10)
    _held(card, dct, ladder_steps(q), table, 0.10)


@pytest.mark.chip
@pytest.mark.parametrize("q_shape", [(64,), (1, 1, 64), (1, 1, 1, 64)])
def test_kernel_takes_one_qualitys_steps(card, q_shape):
    """One quality's steps, without a ladder axis or with one of length 1,
    run as a ladder of one and equal the plain version's broadcast."""
    dct, q = trellis_inputs()
    got = _held(card, dct, ladder_steps(q, (1.0,)), LUMA, 0.10, q_shape)
    assert got.shape == ((1,) if len(q_shape) == 4 else ()) + dct.shape


def _ladder_planes(card):
    """A 512 px image's transform and its 45-quality ladder's steps, as
    ``reconstruct_sweep`` makes them."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:512, 0:512]
    base = np.stack([x // 2, y // 2, (x + y) // 4], -1) % 256
    img = np.clip(base + rng.integers(-40, 41, base.shape), 0, 255).astype(np.uint8)
    planes = te.transform(torch.from_numpy(img).to(card), "420")
    zz = torch.from_numpy(te.ZIGZAG.astype(np.int64)).to(card)
    q_zz = torch.from_numpy(te.qtabs_for(LADDER)).to(card)[:, :, zz][:, :, None, None, :]
    return img, planes, q_zz


@pytest.mark.chip
def test_kernel_equals_plain_on_a_512_ladder(card):
    """The luma (45 x 4,096 blocks) and stacked chroma (45 x 2 x 1,024)
    exactly as ``reconstruct_sweep`` passes them: strided step views."""
    _, planes, q_zz = _ladder_planes(card)
    chroma = torch.stack([planes["dct_cb"], planes["dct_cr"]], dim=1)
    for dct, q, table, shape in ((planes["dct_y"], q_zz[:, 0], LUMA, (45, 64, 64, 64)),
                                 (chroma, q_zz[:, 1][:, :, None], CHROMA, (45, 32, 2, 32, 64))):
        before = jpeg_trellis.trellis_dp.launches
        got = te.trellis_quantize_dev(dct, q, table, 0.10)
        assert jpeg_trellis.trellis_dp.launches == before + 1
        want = te.trellis_quantize_plain(dct, q, table, 0.10)
        assert got.shape == shape and torch.equal(got, want)


@pytest.mark.chip
@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_kernel_equals_plain_at_ragged_block_counts(card, n):
    rng = np.random.default_rng(n)
    dct = rng.normal(0, 30, (n, 64)).astype(np.float32)
    dct[:, 0] = rng.normal(0, 300, n)
    _, q = trellis_inputs()
    _held(card, dct, ladder_steps(q), CHROMA, 0.2)


@pytest.mark.chip
@pytest.mark.parametrize("table", ["LUMA", "FLAT"])
@pytest.mark.parametrize("lmbda", [0.0, 0.1, 0.25, 0.5])
def test_kernel_equals_plain_at_the_edges(card, table, lmbda):
    dct, steps = edge_blocks()
    out = _held(card, dct, steps, LUMA if table == "LUMA" else FLAT, lmbda).cpu()
    assert not out[:, :16].any()  # the all-zero blocks
    assert out[0, 32:48, 1:].abs().max() == 1023 and out[0, 32:36, 0].abs().max() == 2047


@pytest.mark.chip
def test_counter_counts_the_blocks_of_each_launch(card):
    dct, q = trellis_inputs()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _held(card, dct, ladder_steps(q), LUMA, 0.1)
    assert profiling.counters()["jpeg.trellis_blocks"] == 3 * 14 * 11


@pytest.mark.chip
def test_reconstruct_sweep_equals_the_plain_dp(card, monkeypatch):
    """``reconstruct_sweep(trellis_lambda=0.10)`` gives the same candidates
    and int16 coefficients through K10 as through the plain DP."""
    img, _, _ = _ladder_planes(card)
    args = (torch.from_numpy(img).to(card), torch.from_numpy(te.qtabs_for(LADDER)).to(card), 0.0)
    before = jpeg_trellis.trellis_dp.launches
    cands, coefs = te.reconstruct_sweep(*args, trellis_lambda=0.10)
    assert jpeg_trellis.trellis_dp.launches == before + 2
    monkeypatch.setattr(te, "trellis_quantize_dev", te.trellis_quantize_plain)
    want_cands, want_coefs = te.reconstruct_sweep(*args, trellis_lambda=0.10)
    assert torch.equal(cands, want_cands)
    assert coefs.keys() == want_coefs.keys() and all(
        torch.equal(coefs[k], want_coefs[k]) for k in coefs)
