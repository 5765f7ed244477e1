"""rd-calibrate's device sweep (``cli.rd_calibrate.sweep_images_device``)
on the CPU, against the benchmark's plain reference
``portbench/reference/jpeg_ladder.py`` (and ``portbench/reference/score.py``
for the scores); the native Huffman half of device sizes against its Python
construction; the reference's exact bytes against the native coder; the
sweep's spans; the benchmark's device-ladder cell at a tiny size and its
metric readers.

Tolerances: the encoder's products are f32 in both, in other forms (the
reference's colour conversions are 3 x 3 products, the port's are
elementwise), so a sum that lands within an f32 ulp of a rounding step may
round the other way: at most 1e-4 of the coefficients may differ, and of
the candidates' samples, by one code value (at 512 px about 4e-7 and 2e-5
do).  Sizes are counted on the port's own coefficients and compared
exactly: the device estimate is the reference's estimate formula, and the
file's bytes differ from it by the stuffing estimate alone.  Scores, of
candidates that may differ in a sample, within 1e-4 relative.
"""

import ast
import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from codec_eval_tpu_torch.cli import rd_calibrate
from codec_eval_tpu_torch.corpus import Corpus
from codec_eval_tpu_torch.kernels import jpeg_rate as tr
from codec_eval_tpu_torch.kernels.jpeg_enc import reconstruct_sweep
from codec_eval_tpu_torch.parallel import make_mesh, sweep_corpus_ladders
from codec_eval_tpu_torch.utils import native
from portbench.harness import Run, load_cell, load_reader, run_cell
from portbench.reference import jpeg_ladder as ref
from portbench.reference.score import score_ladder as reference_scores
from portbench.trace import Trace

REPO = Path(__file__).resolve().parent.parent
QUALITIES = [10, 50, 90, 98]
SHAPES = [(48, 40), (64, 64)]


def _image(shape, seed=11):
    """A seeded random image: smooth waves under uniform noise."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(x / 9.0) + 30 * np.cos(y / 5.0)
    img = np.stack([base, 0.8 * base + 30, 0.6 * base + 50], -1) + rng.uniform(-40, 40, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _qtabs(qualities):
    return np.stack([np.stack(ref.qtables(q)) for q in qualities]).astype(np.float32)


# -- (a) the sweep against the plain reference ---------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sweep_images_device_equals_the_plain_reference(shape):
    img = _image(shape)
    want = ref.encode_ladder(img, QUALITIES, 0.10)
    cands, coefs = reconstruct_sweep(torch.from_numpy(img), torch.from_numpy(_qtabs(QUALITIES)),
                                     0.0, "420", trellis_lambda=0.10)
    coefs = {k: v.numpy() for k, v in coefs.items()}
    differ = sum(int((coefs[k] != want[k]).sum()) for k in ("y", "cb", "cr"))
    assert differ <= 1e-4 * sum(want[k].size for k in ("y", "cb", "cr"))
    gap = np.abs(np.moveaxis(cands.numpy(), 1, -1).astype(int) - want["candidates"])
    assert gap.max() <= 1 and np.count_nonzero(gap) <= 1e-4 * gap.size

    ((idx, got),) = rd_calibrate.sweep_images_device([img], QUALITIES, trellis=True,
                                                     size_mode="device", device="cpu")
    assert idx == [0]
    # Sizes of the port's own coefficients: the device estimate is the
    # reference's formula on the reference's symbol count, exactly, and
    # the file's bytes differ from it by the stuffing estimate alone.
    count = ref.count_ladder(coefs)
    np.testing.assert_array_equal(got.sizes[0], count["estimate"])
    scan_bytes = [(b + 7) // 8 for b in count["scan_bits"]]
    stuffing_error = [round(s / 368.0) - st for s, st in zip(scan_bytes, count["stuffed"])]
    np.testing.assert_array_equal(got.sizes[0] - np.array(count["exact"]), stuffing_error)
    scores = reference_scores(img, want["candidates"], ("ssimulacra2", "butteraugli"))
    for m in ("ssimulacra2", "butteraugli"):
        np.testing.assert_allclose(got.scores[m][0], scores[m], rtol=1e-4, atol=1e-4, err_msg=m)


def test_sweep_images_device_groups_by_shape_and_checks_its_input():
    imgs = [_image((48, 40), 1), _image((64, 64), 2), _image((48, 40), 3)]
    groups = rd_calibrate.sweep_images_device(imgs, [30, 80], trellis=True, size_mode="device",
                                              device="cpu")
    assert [idx for idx, _ in groups] == [[0, 2], [1]]
    alone = rd_calibrate.sweep_images_device([imgs[2]], [30, 80], trellis=True,
                                             size_mode="device", device="cpu")[0][1]
    np.testing.assert_array_equal(groups[0][1].sizes[1], alone.sizes[0])
    with pytest.raises(ValueError, match="size_mode"):
        rd_calibrate.sweep_images_device(imgs, [30], size_mode="fast", device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        rd_calibrate.sweep_images_device([imgs[0].astype(np.float32)], [30], device="cpu")


# -- (b) the native Huffman half ---------------------------------------------------


def _rows():
    """Packed (rows, 544) statistics: random counts, ties, one symbol per
    table, empty AC tables, and doubling counts whose optimal codes run past
    16 bits."""
    rng = np.random.default_rng(5)
    rows = []
    for _ in range(6):
        rows.append(rng.integers(0, 500, 544) * (rng.random(544) < 0.6))
    tie = np.zeros(544, dtype=np.int64)
    tie[:12] = tie[16:26] = tie[32:96] = tie[288:320] = 7
    rows.append(tie)
    single = np.zeros(544, dtype=np.int64)
    single[[3, 16 + 5, 32 + 0x11, 288 + 0x00]] = [40, 9, 1, 100]
    rows.append(single)
    empty_ac = np.zeros(544, dtype=np.int64)
    empty_ac[:16] = rng.integers(1, 30, 16)
    empty_ac[16:32] = rng.integers(0, 5, 16)
    rows.append(empty_ac)
    deep = np.zeros(544, dtype=np.int64)
    deep[32:32 + 24] = 2 ** np.arange(24)
    deep[288:288 + 20] = 2 ** np.arange(20)[::-1]
    deep[:11] = 3 ** np.arange(11)
    rows.append(deep)
    return np.stack(rows).astype(np.int64)


def _python_scan_bits(row):
    """(scan bits, DHT symbol count) of one packed row by ``t81_code_sizes``."""
    bits = nsyms = 0
    for t, (lo, width) in enumerate(((0, 16), (16, 16), (32, 256), (288, 256))):
        freq = np.zeros(256, dtype=np.int64)
        freq[:width] = row[lo:lo + width]
        sizes, n = tr.t81_code_sizes(freq)
        extra = np.arange(256) if t < 2 else np.arange(256) & 15
        bits += int((freq * (sizes + extra)).sum())
        nsyms += n
    return bits, nsyms


def test_native_scan_bits_equal_the_python_construction():
    from codec_eval_tpu.kernels import jpeg_rate as jr

    rows = _rows()
    bits, nsyms = native.jpeg_baseline_scan_bits(rows)
    for r, b, n in zip(rows, bits, nsyms):
        assert (b, n) == _python_scan_bits(r)
        parts = (r[:16], r[16:32], r[32:288], r[288:544])
        assert (b, n) == tr.scan_bits_from_hists(*parts) == jr.scan_bits_from_hists(*parts)
    # The doubling row's luma AC table needed the 16-bit limit.
    sizes, _ = tr.t81_code_sizes(rows[-1][32:288])
    assert sizes.max() == 16 and (rows[-1][32:288] > 0).sum() == 24
    assert tr.size_estimates_from_packed(rows) == [
        tr.baseline_size_estimate(r[:16], r[16:32], r[32:288], r[288:544]) for r in rows]


def test_size_estimates_from_packed_unchanged_on_a_trellis_ladder():
    """Rows of a real ladder's device statistics: the native path gives the
    JAX package's estimates (its Python construction, unchanged)."""
    from codec_eval_tpu.kernels import jpeg_rate as jr

    img = _image((64, 64), 7)
    qualities = list(range(10, 99, 8))
    _, coefs = reconstruct_sweep(torch.from_numpy(img), torch.from_numpy(_qtabs(qualities)), 0.0,
                                 "420", trellis_lambda=0.10)
    packed = tr.ladder_rate_stats(coefs["y"], coefs["cb"], coefs["cr"], "420").numpy()
    assert tr.size_estimates_from_packed(packed) == jr.size_estimates_from_packed(packed)


def test_native_scan_bits_refuse_what_they_cannot_count():
    row = np.zeros((1, 544), dtype=np.int64)
    row[0, 40] = -1
    with pytest.raises(ValueError, match="negative"):
        native.jpeg_baseline_scan_bits(row)
    row[0, 40] = 2**32
    with pytest.raises(ValueError):
        native.jpeg_baseline_scan_bits(row)
    with pytest.raises(ValueError, match="544"):
        native.jpeg_baseline_scan_bits(np.zeros((2, 288), dtype=np.int64))


# -- (c) the reference's count against the real coder -------------------------------


@pytest.mark.parametrize("shape", SHAPES + [(120, 136)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_bytes_equal_the_native_coder(shape):
    img = _image(shape, 4)
    enc = ref.encode_ladder(img, QUALITIES, 0.10)
    count = ref.count_ladder(enc)
    h, w = shape
    for i, q in enumerate(QUALITIES):
        ql, qc = (t[ref.zigzag()].astype(np.uint16) for t in ref.qtables(q))
        data = native.jpeg_encode_baseline(w, h, "420", enc["y"][i], enc["cb"][i], enc["cr"][i],
                                           ql, qc)
        assert count["exact"][i] == len(data), q
        stats = native.jpeg_scan_stats("420", enc["y"][i], enc["cb"][i], enc["cr"][i])
        assert count["stuffed"][i] == stats["stuffed"]


def test_reference_is_plain():
    src = REPO / "portbench" / "reference" / "jpeg_ladder.py"
    tops = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops == {"__future__", "contextlib", "heapq", "typing", "numpy", "torch"}


# -- (d) the corpus sweep, folded as before ------------------------------------------


def test_sweep_corpus_device_folds_as_before(tmp_path):
    shapes = [(48, 40), (64, 64), (48, 40)]
    imgs = [_image(s, 20 + i) for i, s in enumerate(shapes)]
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(tmp_path / f"im{i}.png")
    good = (tmp_path / "im0.png").read_bytes()
    (tmp_path / "truncated.png").write_bytes(good[:len(good) // 3])
    corpus = Corpus.discover(tmp_path)
    said = []
    got = rd_calibrate.sweep_corpus_device(corpus, [20, 60, 95], trellis=True,
                                           size_mode="device", progress=said.append,
                                           device="cpu")
    assert any("SKIP truncated.png" in s for s in said)
    assert said[-2:] == ["  [2/3] 48x40 group (2 images)", "  [3/3] 64x64 group (1 images)"]

    # The fold as it was before the sweep took decoded images: the readable
    # files grouped by shape in corpus order, each group one ladder sweep.
    order = [c.relative_path for c in corpus.images if c.relative_path != "truncated.png"]
    by_shape = {}
    for name in order:
        rgb = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        by_shape.setdefault(rgb.shape[:2], []).append(rgb)
    mesh = make_mesh(devices=[torch.device("cpu")])
    want = {q: [] for q in (20, 60, 95)}
    for rgbs in by_shape.values():
        res = sweep_corpus_ladders(rgbs, [20.0, 60.0, 95.0], mesh=mesh,
                                   metrics=("ssimulacra2", "butteraugli"), aq_strength=0.0,
                                   trellis_lambda=0.10, with_sizes="device")
        for ii in range(len(rgbs)):
            for qi, q in enumerate((20, 60, 95)):
                want[q].append((float(res.bits_per_pixel[ii, qi]),
                                float(res.scores["ssimulacra2"][ii, qi]),
                                float(res.scores["butteraugli"][ii, qi])))
    assert got == want


def test_host_sweep_scores_a_list_as_the_stack():
    img = _image((48, 40))
    cands = [ref.encode_ladder(img, [q], 0.10)["candidates"][0] for q in (30, 80)]
    from_list = rd_calibrate.score_ladder(img, cands, device="cpu")
    from_stack = rd_calibrate.score_ladder(img, np.stack(cands), device="cpu")
    for a, b in zip(from_list, from_stack):
        np.testing.assert_array_equal(a, b)


# -- (e) spans -------------------------------------------------------------------------


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name.startswith(("ce.ladder.", "ce.jpeg."))), key=lambda s: (s[1], -s[2]))
    return out, spans


def _children(spans, parent):
    """For each span ``parent``: the spans directly inside it."""
    out = []
    for name, lo, hi in spans:
        if name != parent:
            continue
        inside = [(n, s, e) for n, s, e in spans if (n, s, e) != (name, lo, hi)
                  and lo <= s and e <= hi]
        out.append([n for n, s, e in inside
                    if not any(lo2 <= s and e <= hi2 and (n2, lo2, hi2) != (n, s, e)
                               for n2, lo2, hi2 in inside)])
    return out


@pytest.mark.parametrize("size_mode", ["device", "exact"])
def test_ladder_spans_nest(size_mode):
    shape, qualities = (48, 40), [20, 60, 95]
    imgs = [_image(shape, 1), _image(shape, 2)]
    mesh = make_mesh(devices=[torch.device("cpu")])
    res, spans = _traced(lambda: sweep_corpus_ladders(
        imgs, qualities, mesh=mesh, metrics=("ssimulacra2",), aq_strength=0.0,
        trellis_lambda=0.10, with_sizes="device" if size_mode == "device" else True))
    assert res.sizes.shape == (2, 3)
    per_chunk = ["ce.ladder.fetch"] + (["ce.ladder.sizes"] if size_mode == "device" else [])
    waits = ["ce.ladder.entropy_wait"] * 2 if size_mode == "exact" else []
    assert _children(spans, "ce.ladder.sweep") == [["ce.ladder.image"] * 2 + per_chunk + waits]
    assert _children(spans, "ce.ladder.image") == [
        ["ce.jpeg.transform", "ce.jpeg.trellis", "ce.jpeg.reconstruct", "ce.ladder.rate",
         "ce.ladder.score"]] * 2


def test_aq_ladder_spans_quantize_and_runs_no_trellis():
    mesh = make_mesh(devices=[torch.device("cpu")])
    _, spans = _traced(lambda: sweep_corpus_ladders(
        [_image((48, 40))], [40], mesh=mesh, metrics=("psnr",), with_sizes=False))
    assert _children(spans, "ce.ladder.image") == [
        ["ce.jpeg.transform", "ce.jpeg.quantize", "ce.jpeg.reconstruct", "ce.ladder.score"]]


# -- the benchmark cell -------------------------------------------------------------

CELL = "cid22-512-tpujpeg-trellis.device-ladder"
TINY = dict(images=3, height=64, width=48, qualities=[30, 90, 20])
READERS = ("ladder.ops_per_pair", "ladder.trellis_ms_per_pair", "ladder.sizes_ms_per_pair",
           "ladder.wait_ms_per_pair")


def _tiny():
    cell = load_cell(CELL)
    return dataclasses.replace(cell, config={**cell.config, **TINY})


def test_tiny_traced_run_is_correct_and_reads_the_ladder():
    out = run_cell(_tiny(), 2**31 + 9, 0.3, True, time.perf_counter(), device="cpu")
    assert out["correct"], [(c.name, c.value, c.limit) for c in out["checks"]]
    assert out["attempted"] >= 2 and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert "ladder.ops_per_pair" not in got  # no device operations on the CPU
    for name in ("ladder.trellis_ms_per_pair", "ladder.sizes_ms_per_pair"):
        assert got[name] > 0, name
    assert got["ladder.wait_ms_per_pair"] >= 0  # no CUDA runtime calls on the CPU
    checks = {c.name: c.value for c in out["checks"]}
    assert checks["coef_differ_share"] == 0.0 and checks["size_estimate_gap"] == 0.0


def _run(host):
    t = Trace(window=(0.0, 1000.0), device=[("k", 1.0, 2.0)], host=host, calls=1, pairs=4)
    return Run(cell=None, seed=0, setup_s=0.0, window=(0.0, 1.0), calls=[], peak_bytes=0,
               trace=t)


def test_readers_without_the_ladder_spans_give_none():
    spans = [("ce.ladder.sweep", 0.0, 900.0), ("ce.jpeg.trellis", 10.0, 30.0),
             ("ce.ladder.sizes", 40.0, 44.0), ("cudaStreamSynchronize", 50.0, 58.0),
             ("cudaStreamSynchronize", 950.0, 990.0)]
    with_spans = {name: load_reader(name)(_run(spans)) for name in READERS}
    assert with_spans == pytest.approx({"ladder.ops_per_pair": 0.25,
                                        "ladder.trellis_ms_per_pair": 0.020 / 4,
                                        "ladder.sizes_ms_per_pair": 0.004 / 4,
                                        "ladder.wait_ms_per_pair": 0.008 / 4})
    bare = [ev for ev in spans if not ev[0].startswith("ce.")]
    for name in READERS[1:]:
        assert load_reader(name)(_run(bare)) is None, name
        assert load_reader(name)(Run(None, 0, 0.0, (0.0, 1.0), [], 0, None)) is None, name


def test_a_wrong_size_fails_the_check():
    cell = _tiny()
    out = run_cell(cell, 2**31 + 9, 0.2, False, time.perf_counter(), device="cpu")
    calls = out["answered"]
    k = next(iter(calls[0].answer))
    s2, ba, sizes = calls[0].answer[k]
    calls[0].answer[k] = (s2, ba, np.asarray(sizes) + 64)
    checks = {c.name: c for c in out["op"].check(calls)}
    assert not checks["size_estimate_gap"].ok
    assert checks["coef_differ_share"].ok and checks["ssimulacra2_gap"].ok
