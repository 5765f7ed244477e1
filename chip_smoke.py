#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codec_eval_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``codec_eval_tpu_torch/csrc`` with
``nvcc`` and then runs five phases, each failing loudly:

1. device: the card's name and power limit, and the kernels' build time;
2. every kernel (K1-K4) against its plain PyTorch version on the card, on
   the inputs the 512 px all-metric sweep gives it (25 candidates, K1 at all
   six SSIMULACRA2 scales), and at two ragged shapes;
3. the slice: an ``EvalSession(MetricConfig.all(), device="cuda")`` sweep of
   a 512x512 image through a host block-DCT codec at 25 quality levels,
   with the reports written, every kernel's launch counter read around it,
   three of its candidates rescored on the CPU (plain versions) and one
   ``score_batch`` of 25 timed;
4. the committed libjxl Butteraugli oracle scored on the card;
5. each kernel's time against its plain version's.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints neither.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SIZE = 512
SEED = 20240607
QUALITIES = [5] + list(range(10, 100, 4)) + [100]  # 25 levels, with 5, 50 and 100
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)  # f32 stencils: same arithmetic, same order
K1_TOL = dict(rtol=1e-4, atol=1e-6)  # partial sums taken in another order
SCORE_RTOL = {"ssimulacra2": 1e-4, "dssim": 1e-4, "psnr": 1e-4, "butteraugli": 5e-4}

# ---------------------------------------------------------------- the codec

# ITU-T T.81 Annex K tables, scaled as libjpeg's jpeg_quality_scaling does.
_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
]).reshape(8, 8)
_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32).reshape(8, 8)
_RGB_TO_YCC = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
])
_YCC_TO_RGB = np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]])


def _qtable(base: np.ndarray, quality: int) -> np.ndarray:
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.float64)


def _blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    bh, bw = blocks.shape[:2]
    return blocks.swapaxes(1, 2).reshape(bh * 8, bw * 8)


def dct_encode(image, request) -> bytes:
    """An 8x8 block-DCT quantizer on full-resolution YCbCr (baseline JPEG
    without the entropy coder): the bytes are the zlib-compressed int16
    quantized coefficients."""
    import scipy.fft

    rgb = image.to_rgb8().astype(np.float64)
    h, w = rgb.shape[:2]
    if h % 8 or w % 8:
        raise ValueError("the block-DCT codec takes sides that are multiples of 8")
    ycc = rgb @ _RGB_TO_YCC.T
    quality = int(request.quality)
    coefs = []
    for c in range(3):
        table = _qtable(_LUMA if c == 0 else _CHROMA, quality)
        level = ycc[..., c] - (128.0 if c == 0 else 0.0)
        d = scipy.fft.dctn(_blocks(level), axes=(-2, -1), norm="ortho")
        coefs.append(np.round(d / table).astype(np.int16))
    header = np.array([h, w, quality], np.int32).tobytes()
    return header + zlib.compress(np.stack(coefs).tobytes())


def dct_decode_array(data: bytes) -> np.ndarray:
    import scipy.fft

    h, w, quality = (int(v) for v in np.frombuffer(data[:12], np.int32))
    coefs = np.frombuffer(zlib.decompress(data[12:]), np.int16)
    coefs = coefs.reshape(3, h // 8, w // 8, 8, 8).astype(np.float64)
    planes = []
    for c in range(3):
        table = _qtable(_LUMA if c == 0 else _CHROMA, quality)
        level = scipy.fft.idctn(coefs[c] * table, axes=(-2, -1), norm="ortho")
        planes.append(_unblocks(level) + (128.0 if c == 0 else 0.0))
    rgb = np.stack(planes, -1) @ _YCC_TO_RGB.T
    return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)


def candidates(ref_u8: np.ndarray, qualities) -> np.ndarray:
    """(N, H, W, 3) u8: the codec's decodes of ``ref_u8`` at each quality."""
    import codec_eval_tpu_torch as ce

    img = ce.ImageData.rgb8(ref_u8)
    return np.stack([
        dct_decode_array(dct_encode(img, ce.EncodeRequest(quality=q))) for q in qualities
    ])


def make_image(size: int, seed: int) -> np.ndarray:
    """Smooth gradients, hard-edged shapes and a textured-noise quadrant."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack(
        [200 * x + 30, 180 * y + 40, 128 + 90 * np.sin(6.0 * x + 4.0 * y)], -1
    )
    img[(np.abs(x - 0.3) < 0.12) & (np.abs(y - 0.3) < 0.12)] = (230, 40, 40)
    img[(x - 0.7) ** 2 + (y - 0.35) ** 2 < 0.015] = (20, 30, 200)
    img[(y > 0.8) & (x < 0.5)] = (250, 250, 250)
    quad = (x > 0.5) & (y > 0.5)
    img[quad] += rng.normal(0.0, 24.0, (int(quad.sum()), 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ helpers


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def compare(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float):
    """max |got - want| and max relative difference; raise beyond the bound."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got.double() - want.double()).abs()
    ref = want.double().abs()
    max_abs = float(diff.max())
    max_rel = float((diff / ref.clamp(min=1e-30)).max())
    bad = int((diff > atol + rtol * ref).sum())
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} beyond bound={bad}")
    if bad:
        raise AssertionError(f"{name}: {bad} values beyond rtol={rtol}, atol={atol}")
    return max_abs


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call over ``iters`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------- phases


def phase_kernels(ref_u8: np.ndarray, cands_u8: np.ndarray, device: torch.device) -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns, per kernel, its max abs error and the (kernel, plain) calls to
    time in phase 5."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import ssimulacra2 as s2
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu_torch.kernels.cuda import freqsep, malta, scale_features

    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(cands_u8, -1, 1))).to(device)
    ref = torch.from_numpy(ref_u8).to(device)
    lin = srgb_u8_to_linear(planar)
    lin_ref = torch.movedim(srgb_u8_to_linear(ref), -1, 0).contiguous()
    it = float(np.float32(ba.ButteraugliParams().intensity_target))
    out = {}

    # K2: opsin dynamics.
    scaled = (lin * it).contiguous()
    got = freqsep.opsin_xyb_batch(scaled, ba._OPSIN_CONSTS)
    want = freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS)
    out["opsin_xyb"] = (
        compare("K2 opsin_xyb", got, want, **KERNEL_TOL),
        lambda: freqsep.opsin_xyb_batch(scaled, ba._OPSIN_CONSTS),
        lambda: freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS),
    )

    # K3: bands, on the plain XYB and its LF blur.
    xyb = want
    lf = ba._blur(xyb, ba.SIGMA_LF).contiguous()
    got = freqsep.bands_batch(xyb, lf, ba._BAND_CONSTS)
    want = freqsep.bands_plain(xyb, lf, ba._BAND_CONSTS)
    out["bands"] = (
        compare("K3 bands", got, want, **KERNEL_TOL),
        lambda: freqsep.bands_batch(xyb, lf, ba._BAND_CONSTS),
        lambda: freqsep.bands_plain(xyb, lf, ba._BAND_CONSTS),
    )

    # K4: Malta, on the diff planes of the candidates against the reference.
    pi0 = ba.precompute_butteraugli_reference(lin_ref).pi0_full
    diffs = ba._malta_diffs_stack(pi0, ba._psycho_batch(scaled), 0.8).contiguous()
    lines = (ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
    got = malta.malta_ac_batch(diffs, *lines)
    want = malta.malta_ac_plain(diffs, *lines)
    out["malta_ac"] = (
        compare("K4 malta_ac", got, want, **KERNEL_TOL),
        lambda: malta.malta_ac_batch(diffs, *lines),
        lambda: malta.malta_ac_plain(diffs, *lines),
    )

    # K1: SSIMULACRA2 features, at every scale of the pyramid.
    pre = s2.precompute_reference(ref, lin_planar=lin_ref)
    xyb2, level = [], lin
    for scale in range(s2.NUM_SCALES):
        if scale:
            level = s2.downscale_by_2(level)
        xyb2.append(s2._to_positive_xyb(level).contiguous())
    args = [(pre.xyb[s], pre.mu[s], pre.sqblur[s], xyb2[s]) for s in range(s2.NUM_SCALES)]
    worst = 0.0
    for s, a in enumerate(args):
        got = scale_features.scale_features_batch(*a)
        want = scale_features.scale_features_plain(*a)
        side = a[3].shape[-1]
        worst = max(worst, compare(f"K1 scale_features {side}px", got, want, **K1_TOL))
    out["scale_features"] = (
        worst,
        lambda: [scale_features.scale_features_batch(*a) for a in args],
        lambda: [scale_features.scale_features_plain(*a) for a in args],
    )
    torch.cuda.synchronize()
    return out


def check_odd_shapes(device: torch.device) -> None:
    """Each kernel against its plain version where tiles are ragged on both
    axes (widths 53 and 653, as the Pallas kernels' tests use)."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.blur import blur_separable
    from codec_eval_tpu_torch.kernels.cuda import freqsep, malta, scale_features

    rng = np.random.default_rng(SEED)
    for b, h, w in ((2, 37, 53), (1, 67, 653)):
        def planes(c, scale=1.0):
            return torch.from_numpy(rng.random((b, c, h, w), np.float32) * scale).to(device)

        scaled = planes(3, 80.0)
        compare(f"K2 {b}x{h}x{w}", freqsep.opsin_xyb_batch(scaled, ba._OPSIN_CONSTS),
                freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS), **KERNEL_TOL)
        xyb = freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS)
        lf = ba._blur(xyb, ba.SIGMA_LF).contiguous()
        compare(f"K3 {b}x{h}x{w}", freqsep.bands_batch(xyb, lf, ba._BAND_CONSTS),
                freqsep.bands_plain(xyb, lf, ba._BAND_CONSTS), **KERNEL_TOL)
        diffs = planes(6) - 0.5
        lines = (ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
        compare(f"K4 {b}x{h}x{w}", malta.malta_ac_batch(diffs, *lines),
                malta.malta_ac_plain(diffs, *lines), **KERNEL_TOL)
        xyb1 = planes(3)[0].contiguous()
        mu1 = blur_separable(xyb1, scale_features.SIGMA).contiguous()
        s11 = blur_separable(xyb1 * xyb1, scale_features.SIGMA).contiguous()
        xyb2 = (xyb1 + 0.05 * (planes(3) - 0.5)).contiguous()
        args = (xyb1, mu1, s11, xyb2)
        compare(f"K1 {b}x{h}x{w}", scale_features.scale_features_batch(*args),
                scale_features.scale_features_plain(*args), **K1_TOL)
    torch.cuda.synchronize()


def phase_slice(ref_u8: np.ndarray, report_dir: Path, device: torch.device) -> dict:
    """The 25-quality all-metric EvalSession sweep; returns each kernel's
    launch count during the sweep."""
    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS

    def decode(data):
        return ce.ImageData.rgb8(dct_decode_array(data))

    config = (
        ce.EvalConfig.builder().report_dir(report_dir).metrics(ce.MetricConfig.all())
        .quality_levels(QUALITIES).build()
    )
    session = ce.EvalSession(config, device=device)
    session.add_codec_with_decode("dct-q", "1", dct_encode, decode)

    for fn in WRAPPERS.values():
        fn.launches = 0
    report = session.evaluate_image("smoke", ce.ImageData.rgb8(ref_u8))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    session.write_image_report(report)
    print(f"  launches during the sweep: {launches}")

    written = json.loads((report_dir / "smoke.json").read_text())
    if len(written["results"]) != len(QUALITIES):
        raise AssertionError("the report does not hold one row per quality")
    rows = {r.quality: r.metrics for r in report.results}
    metrics = ("ssimulacra2", "dssim", "butteraugli", "psnr")
    values = np.array([[getattr(rows[q], m) for m in metrics] for q in QUALITIES], np.float64)
    if values.shape != (len(QUALITIES), 4) or not np.isfinite(values).all():
        raise AssertionError(f"non-finite or missing scores:\n{values}")
    lo, hi = rows[QUALITIES[0]], rows[QUALITIES[-1]]
    if not hi.ssimulacra2 > lo.ssimulacra2:
        raise AssertionError("SSIMULACRA2 does not rise from q5 to q100")
    if not hi.butteraugli < lo.butteraugli:
        raise AssertionError("Butteraugli does not fall from q5 to q100")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # Three candidates rescored on the host: the plain versions, which the
    # CPU tests hold to the JAX package.
    picks = [5, 50, 100]
    host = ce.BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(
        ref_u8, candidates(ref_u8, picks)
    )
    for q, h in zip(picks, host):
        d = rows[q]
        print(
            f"  q{q}: ssimulacra2={d.ssimulacra2:.6f} dssim={d.dssim:.8f} "
            f"butteraugli={d.butteraugli:.6f} psnr={d.psnr:.6f}"
        )
        for m in metrics:
            g, w = getattr(d, m), getattr(h, m)
            if abs(g - w) > SCORE_RTOL[m] * abs(w):
                raise AssertionError(f"q{q} {m}: card {g!r} vs host {w!r}")

    # One score_batch of 25, with the reference precompute cached.
    batch = candidates(ref_u8, QUALITIES)
    scorer = ce.BatchScorer(ce.MetricConfig.all(), device=device)
    scorer.score_batch(ref_u8, batch)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score_batch(ref_u8, batch)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(
        f"  score_batch of {len(batch)} at {SIZE}px: median {med * 1e3:.3f} ms of 5 "
        f"({[round(t * 1e3, 3) for t in times]}), {len(batch) / med:.2f} pairs/s"
    )
    return launches


def phase_oracle(device: torch.device) -> None:
    """The libjxl Butteraugli oracle (24 pairs, 128 px) on the card."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear

    fx = np.load(ROOT / "tests" / "goldens" / "butteraugli_oracle.npz")
    bases, ridx, dists, gold = fx["bases"], fx["ref_index"], fx["dists"], fx["gold"]

    def lin(u8):
        t = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
        return torch.movedim(srgb_u8_to_linear(t), -1, -3).contiguous()

    ours = np.zeros(len(gold))
    for r in np.unique(ridx):
        idx = np.flatnonzero(ridx == r)
        ref = ba.precompute_butteraugli_reference(lin(bases[r]))
        ours[idx] = ba.butteraugli_batch(ref, lin(dists[idx])).cpu().numpy()
    rel = np.abs(ours - gold) / np.maximum(gold, 1e-9)
    med, p90, worst = float(np.median(rel)), float(np.quantile(rel, 0.9)), float(rel.max())
    print(f"  relative error vs libjxl: median={med:.5f} p90={p90:.5f} max={worst:.5f}")
    if not (med <= 0.005 and p90 <= 0.02 and worst <= 0.08):
        raise AssertionError("the libjxl oracle gates (0.5% / 2% / 8%) failed")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS, _lib

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _lib.load()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    ref_u8 = make_image(SIZE, SEED)
    print(f"[2] kernels vs plain on the card ({len(QUALITIES)} x 3 x {SIZE} x {SIZE})")
    checks = phase_kernels(ref_u8, candidates(ref_u8, QUALITIES), device)
    check_odd_shapes(device)

    print(f"[3] EvalSession sweep on {device}: {len(QUALITIES)} qualities at {SIZE}px")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(ref_u8, Path(tmp), device)

    print("[4] libjxl Butteraugli oracle on the card")
    phase_oracle(device)

    print(f"[5] kernel vs plain device time, mean of 20 (plain, kernel, kernel, plain) | {card}")
    rows = []
    for name, fn in WRAPPERS.items():
        err, kernel, plain = checks[name]
        p1, k1, k2, p2 = (time_ms(f, 10) for f in (plain, kernel, kernel, plain))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rows.append({
            "name": name, "route": "cuda", "source": fn.source, "replaces": fn.replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
