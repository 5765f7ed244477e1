#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codec_eval_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # and profiles: one batch per size, K7/K8 per launch

Builds the hand-written kernels from ``codec_eval_tpu_torch/csrc`` with
``nvcc`` (one process per source, in parallel) and then runs eight phases,
each failing loudly:

1. device: the card's name and power limit, the kernels' build time, and
   the compiler's registers, shared memory and spills of the strip kernels
   (K1, K3) and the Malta kernels (K4, K5);
2. K1-K4 against their plain PyTorch versions on the card, on the inputs the
   512 px all-metric sweep gives them (25 candidates and the reference at
   512 and 256 px, K1 at all six SSIMULACRA2 scales), and all six kernels
   at three ragged shapes (K6 at sigma 2.7 and 7.16), and K1, K3 and K8
   where the last strip and the last segment of rows are both ragged and
   at the smallest pyramid scales (K3 bit for bit, K8 equal to K1's
   candidate in a batch);
3. the 512 px slice: an ``EvalSession(MetricConfig.all(), device="cuda")``
   sweep of a 512x512 image through a host block-DCT codec at 25 quality
   levels, with the reports written, every kernel's launch counter read
   around it (K1-K4 launch, K5 and K6 must not), three candidates rescored
   on the host (plain versions) and one ``score_batch`` of 25 timed;
4. the committed libjxl Butteraugli oracle scored on the card;
5. the 2048 px slice, the CLIC-class size: an ``EvalSession`` with no
   ``device`` (the card is the default) sweeps a 2048x2048 image at
   qualities 50..95 step 5, with every kernel launching (K4 on the 1024 px
   half-resolution pass), two candidates rescored on the host, one
   ``score_batch`` of 10 timed with its peak device memory; then every
   kernel against its plain version on that sweep's inputs (K1 at 2048 down
   to 64 px; K2, K3 and K6 at 2048 and 1024; K4 at 1024; K5 at 2048);
6. each kernel's time against its plain version's and its bound, on both
   paths for K1-K4, with the kernel-alone device time of K1, K3, K4 and K5
   (K8 in phase 7); for K6 the dense operator product it replaces; and the
   whole diffmap at 2048 and 1024 px both ways, through K5 and through the
   prologue, K4 and the eager epilogue;
7. the single-pair API and the codec-iter loop: the four ``calculate_*``
   and Butteraugli at 250 nits with no ``device`` on three 512 px
   candidates (K7 and K8 launch, K2-K4 once per pass at B = 1, K5 and K6
   never), rescored on the host, and identical pairs; the same calls on two
   2048 px candidates (K5 launches, and K4 on the 1024 px pass) held to
   phase 5's batch scores on the card; K7 and K8 against their plain
   versions on those pairs' inputs and K7 at two ragged shapes;
   ``run_eval`` over two 512 px images held to an ``EvalSession``'s
   SSIMULACRA2 column; each ``calculate_*`` timed per call; K7 and K8
   timed against their plain versions and their bounds;
8. the mixed-size corpus: 20 pairs of crops of the 2048 px image (4 x 512,
   2 x 800, 1 x 2048, 2048 x 1365 landscape and portrait, 333 x 517) at q50
   and q90 scored by ``parallel.score_pairs_sharded(masked=True)`` in six
   padded buckets with no ``device`` (K9 12 times and K4 twice per bucket,
   nothing else), held to the exact-shape path on the card and, for the
   333 x 517 bucket, to the host; where the card's time goes in one masked
   call (profiler); K9 against its plain version bit for bit at every
   scale of the 512, 2048 x 2048 and 2048 x 1408 buckets and at two ragged
   shapes; K9 timed against its plain version, a grouped
   ``conv2d`` and its bound; the corpus's wall time, pairs/s and peak
   device memory.

``--profile`` adds a ``torch.profiler`` breakdown of one ``score_batch``
per size; K7 and K8 launch by launch on one pair at each size (the grid,
the wrapper's time and the kernel's own device time); and the device's
busy and idle time during one call of each ``calculate_*`` at each size.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``, with the card's ``nvidia-smi`` line just
before them.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints none of them.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SIZE = 512
SEED = 20240607
QUALITIES = [5] + list(range(10, 100, 4)) + [100]  # 25 levels, with 5, 50 and 100
# The CLIC2025 calibration size and ladder of the JAX package's bench.py.
BIG = 2048
BIG_QUALITIES = list(range(50, 100, 5))
BIG_PICKS = [50, 95]  # rescored on the host
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)  # f32 stencils: same arithmetic, same order
K1_TOL = dict(rtol=1e-4, atol=1e-6)  # partial sums taken in another order
SCORE_RTOL = {"ssimulacra2": 1e-4, "dssim": 1e-4, "psnr": 1e-4, "butteraugli": 5e-4}
EXACT = dict(rtol=0.0, atol=0.0)  # K7: K6's tile code, K6's order, the same epilogue
PAIR_PICKS = [5, 50, 100]  # single pairs at 512 px, rescored on the host
# A single pair on the card against the batch scorer's score of the same
# candidate: the kernels run the same code at B = 1 as at B = 10; only
# PyTorch's reductions over a batch may add in another order.
PAIR_VS_BATCH_RTOL = 1e-6
# The kernels that only the single-pair path launches: K7 and K8.
PAIR_ONLY = frozenset({"mask_diff_ac", "scale_features_pair"})
# The kernel that only the masked (mixed-size) path launches: K9.
MASKED_ONLY = frozenset({"candidate_moments"})
# The mixed-size corpus: buckets of 128 px, and the masked scores held to
# the exact path at tests/test_parallel.py's tolerance.
GRANULARITY = 128
MASKED_BATCH = 8  # pairs per masked scoring step; every phase-8 bucket fits in one
MASKED_VS_EXACT = dict(rel=2e-3, abs=1e-4)
MIXED_QUALITIES = [50, 90]

# Peak rates of one H100 SXM at 700 W (NVIDIA's data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per output pixel that each kernel's function needs, whatever
# the kernel itself does (a multiply or an add counts one; selects,
# compares, abs and negation count nothing; the arithmetic of data-dependent
# branches is left out, so each count is a floor).
# K1, per channel: the products x2*x2 and x1*x2 (2); three 15-tap blurs both
# ways, 6 x (15 mul + 14 add); the SSIM map (16); the edge maps (two
# differences, two +1, a quotient, a -1: 6); the squares and fourth powers
# (6) and the six sums (6).
K1_OPS = 2 + 6 * (15 + 14) + 16 + 6 + 6 + 6
K2_OPS = 164  # three 5+5-tap blurs, two absorbance mixes, FastLog2f, sensitivity
K3_OPS = 270  # three 15+15-tap and two 7+7-tap blurs, suppression, range shaping
# K5, per channel: the diff, |l0|+|l1|, 0.5x, +n1, two quotients, a product,
# the two thresholds and the final add (the impact branch's two left out).
PROLOGUE_OPS = 10
# K5, per pixel: the asymmetric L2 twice (7 each) and its two adds, the MF
# X/Y terms (4 each), MF B (3), + dac, the three LF terms and their sum (12),
# the mask combine (6), the sqrt.
EPILOGUE_OPS = 2 * 7 + 2 + 2 * 4 + 3 + 1 + 12 + 6 + 1
# K7, per pixel beyond K6's blur: b0 - b1, the product with ac_mul, the square.
MASK_EPILOGUE_OPS = 3
# K9, per channel and pixel: the products x2*x2 and x1*x2, then three 15-tap
# blurs both ways.
K9_OPS = 2 + 6 * (15 + 14)
# The CUDA kernel behind each wrapper whose rows also carry the kernel's own
# device time (the profiler's, summed over the launches of one call), beside
# the CUDA-events time of the wrapper.
OWN_TIME = {
    "scale_features": "scale_features_kernel", "bands": "bands_kernel",
    "malta_ac": "malta_kernel", "malta_diffmap": "malta_diffmap_kernel",
    "scale_features_pair": "scale_features_kernel",
}
# The kernels whose compiler report (registers, shared memory, spills)
# phase 1 prints.
PTXAS_KERNELS = ("scale_features_kernel", "bands_kernel", "malta")

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


@dataclass
class Check:
    """One kernel held against its plain version at a path's shapes, and
    what phase 6 needs to time and bound it: the bytes its function must
    move, the operations it must do, and a PyTorch call that computes the
    same function, where there is one."""

    err: float
    kernel: Callable
    plain: Callable
    nbytes: float
    ops: float
    shapes: str
    library: Optional[Callable] = None


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float) -> tuple:
    """The least time (ms) the card could take, and what sets it: the bytes
    over the memory rate or the f32 operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def malta_ops(lines_full, lines_lf) -> int:
    """Operations per pixel of the six Malta sweeps, as the function needs
    them: each line's samples added and the sum squared, weighted where its
    weight is not 1, and added to the plane's other lines, on two
    full-pattern and four lf-pattern planes; then the six plane terms
    summed into the two accumulators."""
    def per_plane(lines):
        return sum(len(line) - 1 + 1 + (weight != 1) for weight, line in lines) + len(lines) - 1

    return 2 * per_plane(lines_full) + 4 * per_plane(lines_lf) + 6 - 2


def blur_ops(sigma: float) -> int:
    """Operations per pixel of K6: two FIR passes and the renormalization."""
    from codec_eval_tpu_torch.kernels.cuda.freqsep import _taps

    return 2 * (2 * len(_taps(sigma)) - 1) + 1


def device_us(e) -> float:
    """A profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def own_device_ms(fn, kernel: str, calls: int = 10) -> Optional[float]:
    """Device time of the CUDA kernels named ``kernel`` per call of ``fn``,
    from ``torch.profiler``: the kernel alone, without the host time between
    launches that CUDA events over a loop also count.  The wrappers' launch
    counters give the launches of one call (six for K1's six scales); the
    mean over the launches the profiler recorded in ``calls`` calls, which
    after a long profile of many operations may be fewer than it should,
    times that count.  None if it recorded none."""
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS
    from torch.profiler import ProfilerActivity

    before = sum(w.launches for w in WRAPPERS.values())
    fn()
    torch.cuda.synchronize()
    per_call = sum(w.launches for w in WRAPPERS.values()) - before
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    launches = sum(e.count for e in seen)
    if launches != calls * per_call:
        print(f"  (the profiler recorded {launches} of {calls} x {per_call} launches of {kernel})")
    if not launches:
        return None
    return sum(device_us(e) for e in seen) / 1e3 / launches * per_call


def reset_launches() -> None:
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS

    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS

    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ------------------------------------------------------------------- phases


def held(label: str, kernel: Callable, plain: Callable, cases: list, tol: dict):
    """Each (case, args) of ``cases`` through the kernel and its plain
    version; the worst max |err| and the first case's kernel output."""
    worst, first = 0.0, None
    for case, args in cases:
        got = kernel(*args)
        worst = max(worst, compare(f"{label} {case}", got, plain(*args), **tol))
        first = got if first is None else first
    return worst, first


def phase_kernels(ref_u8: np.ndarray, cands_u8: np.ndarray, device: torch.device) -> dict:
    """K1-K4 against their plain versions on every input that a sweep of
    ``ref_u8`` gives them: K2 and K3 on the candidates and on the reference
    at full and half resolution, K4 at each resolution whose diffmap does
    not take K5, K1 at all six SSIMULACRA2 scales.  Each check is timed and
    bounded on the candidates at the first resolution it runs at."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import ssimulacra2 as s2
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu_torch.kernels.cuda import freqsep, malta, scale_features

    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(cands_u8, -1, 1))).to(device)
    ref = torch.from_numpy(ref_u8).to(device)
    lin = srgb_u8_to_linear(planar)
    lin_ref = torch.movedim(srgb_u8_to_linear(ref), -1, 0).contiguous()
    params = ba.ButteraugliParams()
    it = float(np.float32(params.intensity_target))
    pre_ba = ba.precompute_butteraugli_reference(lin_ref)
    lines = (ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
    b, _, h, w = planar.shape
    out = {}

    # The inputs of K2, K3 and K4 at each resolution of the Butteraugli pass.
    k2, k3, k4 = [], [], []
    for cand, ref_lin, pi0 in (
        (lin, lin_ref, pre_ba.pi0_full),
        (ba._subsample2x(lin), ba._subsample2x(lin_ref), pre_ba.pi0_sub),
    ):
        rh, rw = cand.shape[-2:]
        for who, x in ((f"B={b}", cand), ("reference", ref_lin[None])):
            scaled = (x * it).contiguous()
            xyb = freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS)
            lf = ba._blur(xyb, ba.SIGMA_LF).contiguous()
            k2.append((f"{who} {rh}x{rw}", (scaled, ba._OPSIN_CONSTS)))
            k3.append((f"{who} {rh}x{rw}", (xyb, lf, ba._BAND_CONSTS)))
        if not ba._fused_diffmap_ok(rh, rw):
            pi1 = ba._psycho_batch(k2[-2][1][0])
            diffs = ba._malta_diffs_stack(pi0, pi1, params.hf_asymmetry).contiguous()
            k4.append((f"B={b} {rh}x{rw}", (diffs, *lines)))
            del pi1

    # K2: opsin dynamics.
    err, got = held("K2 opsin_xyb", freqsep.opsin_xyb_batch, freqsep.opsin_xyb_plain, k2,
                    KERNEL_TOL)
    scaled = k2[0][1][0]
    out["opsin_xyb"] = Check(
        err,
        lambda: freqsep.opsin_xyb_batch(scaled, ba._OPSIN_CONSTS),
        lambda: freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS),
        2 * nbytes(scaled) + h * w * 4, K2_OPS * b * h * w, f"{w} px, B={b}",
    )

    # K3: bands, on the plain XYB and its LF blur.
    err, got = held("K3 bands", freqsep.bands_batch, freqsep.bands_plain, k3, KERNEL_TOL)
    xyb, lf, _ = k3[0][1]
    out["bands"] = Check(
        err,
        lambda: freqsep.bands_batch(xyb, lf, ba._BAND_CONSTS),
        lambda: freqsep.bands_plain(xyb, lf, ba._BAND_CONSTS),
        nbytes(xyb, lf, got) + 2 * h * w * 4, K3_OPS * b * h * w, f"{w} px, B={b}",
    )

    # K4: Malta, on the diff planes of the candidates against the reference.
    err, got = held("K4 malta_ac", malta.malta_ac_batch, malta.malta_ac_plain, k4, KERNEL_TOL)
    diffs = k4[0][1][0]
    dh, dw = diffs.shape[-2:]
    out["malta_ac"] = Check(
        err,
        lambda: malta.malta_ac_batch(diffs, *lines),
        lambda: malta.malta_ac_plain(diffs, *lines),
        nbytes(diffs, got), malta_ops(*lines) * b * dh * dw, f"{dw} px, B={b}",
    )
    del got

    # K1: SSIMULACRA2 features, at every scale of the pyramid.
    pre = s2.precompute_reference(ref, lin_planar=lin_ref)
    xyb2, level = [], lin
    for scale in range(s2.NUM_SCALES):
        if scale:
            level = s2.downscale_by_2(level)
        xyb2.append(s2._to_positive_xyb(level).contiguous())
    args = [(pre.xyb[s], pre.mu[s], pre.sqblur[s], xyb2[s]) for s in range(s2.NUM_SCALES)]
    worst, moved, ops = 0.0, 0, 0
    for a in args:
        got = scale_features.scale_features_batch(*a)
        want = scale_features.scale_features_plain(*a)
        sw = a[3].shape[-1]
        worst = max(worst, compare(f"K1 scale_features {sw}px", got, want, **K1_TOL))
        moved += nbytes(*a, got)  # the inputs once and the (N, 3, 2, 3) features
        ops += K1_OPS * a[3].numel()
    out["scale_features"] = Check(
        worst,
        lambda: [scale_features.scale_features_batch(*a) for a in args],
        lambda: [scale_features.scale_features_plain(*a) for a in args],
        moved, ops, f"{w} px, B={b}, six scales",
    )
    torch.cuda.synchronize()
    return out


def check_odd_shapes(device: torch.device) -> None:
    """Each kernel against its plain version where tiles are ragged on both
    axes (widths 53 and 653, as the Pallas kernels' tests use, and 52, where
    K4 and K5 stage 16-byte chunks)."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.blur import blur_separable
    from codec_eval_tpu_torch.kernels.cuda import blur, freqsep, malta, scale_features

    rng = np.random.default_rng(SEED)
    lines = (ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
    consts = ba._fused_diffmap_consts(0.8, 1.0)
    for b, h, w in ((2, 37, 53), (1, 67, 653), (2, 36, 52)):
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
        compare(f"K4 {b}x{h}x{w}", malta.malta_ac_batch(diffs, *lines),
                malta.malta_ac_plain(diffs, *lines), **KERNEL_TOL)
        xyb1 = planes(3)[0].contiguous()
        mu1 = blur_separable(xyb1, scale_features.SIGMA).contiguous()
        s11 = blur_separable(xyb1 * xyb1, scale_features.SIGMA).contiguous()
        xyb2 = (xyb1 + 0.05 * (planes(3) - 0.5)).contiguous()
        args = (xyb1, mu1, s11, xyb2)
        compare(f"K1 {b}x{h}x{w}", scale_features.scale_features_batch(*args),
                scale_features.scale_features_plain(*args), **K1_TOL)
        ref6 = (planes(6)[0] - 0.5).contiguous()
        k5 = (planes(6) - 0.5, ref6, planes(4) - 0.5, (planes(4)[0] - 0.5).contiguous(),
              planes(1)[:, 0].contiguous(), planes(2)[0].contiguous(), *lines, *consts)
        compare(f"K5 {b}x{h}x{w}", malta.malta_diffmap_batch(*k5),
                malta.malta_diffmap_plain(*k5), **KERNEL_TOL)
        for sigma in (ba.SIGMA_MASK, ba.SIGMA_LF):
            d = planes(2, 10.0)
            compare(f"K6 {b}x{h}x{w} sigma {sigma:g}", blur.blur_batch(d, sigma),
                    blur.blur_batch_plain(d, sigma), **KERNEL_TOL)
    torch.cuda.synchronize()


def check_ragged_strips(device: torch.device) -> None:
    """K3, K1 and K8, the row-streamed strip kernels, where the last strip
    of columns and the last segment of rows are both ragged (heights of
    several segments and a remainder, widths not a multiple of the strip),
    and K1 and K8 at the smallest pyramid scales.  K3 bit for bit; K1 and
    K8 within K1_TOL, and each pair's K8 features equal to those of the same
    candidate in K1's batch."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.blur import blur_separable
    from codec_eval_tpu_torch.kernels.cuda import _lib, freqsep, scale_features as sf

    rng = np.random.default_rng(SEED + 1)
    for b, h, w in ((1, 101, 300), (2, 261, 131)):
        seg = freqsep.bands_segment_rows(b, h, w, _lib.sm_count(device))
        if h % seg == 0 or w % _lib.STRIP == 0:
            raise AssertionError(f"K3 {b}x{h}x{w}: segment {seg} leaves nothing ragged")
        scaled = torch.from_numpy(rng.random((b, 3, h, w), np.float32) * 80.0).to(device)
        xyb = freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS)
        lf = ba._blur(xyb, ba.SIGMA_LF).contiguous()
        compare(f"K3 {b}x{h}x{w} (segments of {seg} rows)",
                freqsep.bands_batch(xyb, lf, ba._BAND_CONSTS),
                freqsep.bands_plain(xyb, lf, ba._BAND_CONSTS), **EXACT)
    for n, h, w in ((3, 101, 300), (2, 261, 131), (10, 16, 16), (10, 8, 8)):
        seg = sf.segment_rows(h)
        xyb1 = torch.from_numpy(rng.random((3, h, w), np.float32)).to(device)
        mu1 = blur_separable(xyb1, sf.SIGMA).contiguous()
        s11 = blur_separable(xyb1 * xyb1, sf.SIGMA).contiguous()
        noise = torch.from_numpy(rng.random((n, 3, h, w), np.float32)).to(device)
        xyb2 = (xyb1 + 0.05 * (noise - 0.5)).contiguous()
        got = sf.scale_features_batch(xyb1, mu1, s11, xyb2)
        compare(f"K1 {n}x{h}x{w} (segments of {seg} rows)", got,
                sf.scale_features_plain(xyb1, mu1, s11, xyb2), **K1_TOL)
        pair = sf.scale_features(xyb1, mu1, s11, xyb2[0].contiguous())
        compare(f"K8 {h}x{w}", pair, sf.scale_features_plain(xyb1, mu1, s11, xyb2[0]),
                **K1_TOL)
        compare(f"K8 {h}x{w} against K1's candidate 0", pair, got[0], **EXACT)
    torch.cuda.synchronize()


def phase_slice(
    ref_u8: np.ndarray, qualities: list, picks: list, report_dir: Path, device, idle: set,
) -> dict:
    """An all-metric EvalSession sweep of ``ref_u8`` at ``qualities`` on
    ``device`` (``None``: the session's default).  Checks the report, the
    monotonicity of the scores, that every kernel but those in ``idle``
    launched and those did not, and the card's scores at ``picks`` against
    the host's; times one ``score_batch`` of the whole ladder.  Returns
    each kernel's launch count during the sweep and the report's scores by
    quality."""
    import codec_eval_tpu_torch as ce

    def decode(data):
        return ce.ImageData.rgb8(dct_decode_array(data))

    on = {} if device is None else {"device": device}
    config = (
        ce.EvalConfig.builder().report_dir(report_dir).metrics(ce.MetricConfig.all())
        .quality_levels(qualities).build()
    )
    session = ce.EvalSession(config, **on)
    session.add_codec_with_decode("dct-q", "1", dct_encode, decode)

    reset_launches()
    t0 = time.perf_counter()
    report = session.evaluate_image("smoke", ce.ImageData.rgb8(ref_u8))
    launches = read_launches()
    print(f"  sweep on {session._scorer.device}: {time.perf_counter() - t0:.2f} s "
          f"(host codec included); launches during the sweep: {launches}")
    session.write_image_report(report)

    written = json.loads((report_dir / "smoke.json").read_text())
    if len(written["results"]) != len(qualities):
        raise AssertionError("the report does not hold one row per quality")
    rows = {r.quality: r.metrics for r in report.results}
    metrics = ("ssimulacra2", "dssim", "butteraugli", "psnr")
    values = np.array([[getattr(rows[q], m) for m in metrics] for q in qualities], np.float64)
    if values.shape != (len(qualities), 4) or not np.isfinite(values).all():
        raise AssertionError(f"non-finite or missing scores:\n{values}")
    lo, hi = rows[qualities[0]], rows[qualities[-1]]
    if not hi.ssimulacra2 > lo.ssimulacra2:
        raise AssertionError(f"SSIMULACRA2 does not rise from q{qualities[0]} to q{qualities[-1]}")
    if not hi.butteraugli < lo.butteraugli:
        raise AssertionError(f"Butteraugli does not fall from q{qualities[0]} to q{qualities[-1]}")
    silent = sorted(name for name, n in launches.items() if n <= 0 and name not in idle)
    stray = sorted(name for name, n in launches.items() if n > 0 and name in idle)
    if silent or stray:
        raise AssertionError(f"kernels that never launched: {silent}; kernels off this "
                             f"path that launched: {stray}")

    # Candidates rescored on the host: the plain versions, which the CPU
    # tests hold to the JAX package.
    t0 = time.perf_counter()
    host = ce.BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(
        ref_u8, candidates(ref_u8, picks)
    )
    print(f"  host rescoring of q{picks}: {time.perf_counter() - t0:.2f} s")
    for q, h in zip(picks, host):
        d = rows[q]
        print(
            f"  q{q}: ssimulacra2={d.ssimulacra2:.6f} dssim={d.dssim:.8f} "
            f"butteraugli={d.butteraugli:.6f} psnr={d.psnr:.6f}"
        )
        for m in metrics:
            g, w = getattr(d, m), getattr(h, m)
            rel = abs(g - w) / max(abs(w), 1e-30)
            print(f"    {m}: card {g!r} host {w!r} rel {rel:.3e}")
            if abs(g - w) > SCORE_RTOL[m] * abs(w):
                raise AssertionError(f"q{q} {m}: card {g!r} vs host {w!r}")

    # One score_batch of the whole ladder, with the reference precompute cached.
    batch = candidates(ref_u8, qualities)
    scorer = ce.BatchScorer(ce.MetricConfig.all(), **on)
    torch.cuda.reset_peak_memory_stats()
    scorer.score_batch(ref_u8, batch)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score_batch(ref_u8, batch)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    side = ref_u8.shape[0]
    print(
        f"  score_batch of {len(batch)} at {side}px: median {med * 1e3:.3f} ms of 5 "
        f"({[round(t * 1e3, 3) for t in times]}), {len(batch) / med:.2f} pairs/s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    )
    return launches, rows


def phase_kernels_big(ref_u8: np.ndarray, cands_u8: np.ndarray, device: torch.device):
    """K5 and K6 against their plain versions on the inputs the 2048 px
    sweep gives them: K5 and K6 at full resolution, K6 at half (1024 px).
    Returns the checks for phase 6, K6's half-resolution check, and at both
    resolutions the whole diffmap both ways (K5 with its staging; the
    Malta prologue, K4 and the eager epilogue) for phase 6 to time."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu_torch.kernels.cuda import blur, malta

    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(cands_u8, -1, 1))).to(device)
    ref = torch.from_numpy(ref_u8).to(device)
    lin = srgb_u8_to_linear(planar)
    lin_ref = torch.movedim(srgb_u8_to_linear(ref), -1, 0).contiguous()
    params = ba.ButteraugliParams()
    it = float(np.float32(params.intensity_target))
    a, xmul = params.hf_asymmetry, params.xmul
    lines = (ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
    pre = ba.precompute_butteraugli_reference(lin_ref)
    b = planar.shape[0]
    out = {}

    def diffmaps(pi0, pi1, mask_pre):
        dac = ba._mask_diff_ac_batch(pi1, mask_pre[0])

        def fused():
            return malta.malta_diffmap_batch(
                *ba._fused_diffmap_args(pi0, pi1, a, xmul, mask_pre, dac))

        def unfused():
            stacks = ba._malta_diffs_stack(pi0, pi1, a).contiguous()
            return ba._diffmap_psycho(pi0, pi1, a, xmul, malta.malta_ac_batch(stacks, *lines),
                                      mask_pre, dac)

        return f"{dac.shape[-1]} px, B={b}", fused, unfused

    pi1 = ba._psycho_batch(lin * it)
    flows = [diffmaps(pre.pi0_full, pi1, pre.mask_full)]
    dac = ba._mask_diff_ac_batch(pi1, pre.mask_full[0])
    k5 = ba._fused_diffmap_args(pre.pi0_full, pi1, a, xmul, pre.mask_full, dac)
    h, w = dac.shape[-2:]
    got = malta.malta_diffmap_batch(*k5)
    want = malta.malta_diffmap_plain(*k5)
    tensors = [t for t in k5 if isinstance(t, torch.Tensor)]
    ops = (malta_ops(*k5[6:8]) + 6 * PROLOGUE_OPS + EPILOGUE_OPS) * b * h * w
    out["malta_diffmap"] = Check(
        compare(f"K5 malta_diffmap {b}x{h}x{w}", got, want, **KERNEL_TOL),
        lambda: malta.malta_diffmap_batch(*k5),
        lambda: malta.malta_diffmap_plain(*k5),
        nbytes(*tensors, got), ops, f"{h} px, B={b}",
    )
    del dac, got, want

    def k6_check(pi: "ba.PsychoImage", label: str) -> Check:
        d1 = ba._diff_precompute(ba._combine_channels_for_masking(pi))[:, None].contiguous()
        sigma = ba.SIGMA_MASK
        bh, bw = d1.shape[-2:]
        got = blur.blur_batch(d1, sigma)
        return Check(
            compare(f"K6 blur {label} {b}x{bh}x{bw}", got, blur.blur_batch_plain(d1, sigma),
                    **KERNEL_TOL),
            lambda: blur.blur_batch(d1, sigma),
            lambda: blur.blur_batch_plain(d1, sigma),
            2 * nbytes(d1) + bh * bw * 4, blur_ops(sigma) * d1.numel(), f"{bh} px, B={b}",
            library=lambda: ba._blur(d1, sigma),
        )

    out["blur"] = k6_check(pi1, "full")
    pi1_half = ba._psycho_batch(ba._subsample2x(lin) * it)
    half = k6_check(pi1_half, "half")
    flows.append(diffmaps(pre.pi0_sub, pi1_half, pre.mask_sub))
    torch.cuda.synchronize()
    return out, half, flows


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


def pair_calls() -> dict:
    """The single-pair entry points a user calls, with no ``device``."""
    from codec_eval_tpu_torch import metrics as m

    return {
        "ssimulacra2": m.calculate_ssimulacra2,
        "dssim": m.calculate_dssim,
        "butteraugli": m.calculate_butteraugli,
        "butteraugli_250": functools.partial(
            m.calculate_butteraugli_with_intensity, intensity_target=250.0),
        "psnr": m.calculate_psnr,
    }


def expected_pair_launches(side: int, pairs: int) -> dict:
    """Launches of ``pairs`` passes of ``pair_calls`` at ``side`` px: per
    Butteraugli call, K2 and K3 once per image and resolution, K7 once per
    resolution and K5 or K4 as the size route gives; per SSIMULACRA2 call,
    K8 once per scale; nothing else."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import ssimulacra2 as s2
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS

    fused = sum(ba._fused_diffmap_ok(n, n) for n in (side, (side + 1) // 2))
    n_ba = 2 * pairs  # calculate_butteraugli and the 250-nit call
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(opsin_xyb=4 * n_ba, bands=4 * n_ba, mask_diff_ac=2 * n_ba,
                malta_diffmap=fused * n_ba, malta_ac=(2 - fused) * n_ba,
                scale_features_pair=s2.NUM_SCALES * pairs)
    return want


def check_launches(label: str, got: dict, want: dict) -> None:
    print(f"  launches {label}: {got}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def score_pairs(ref_u8: np.ndarray, dists: np.ndarray, **on) -> dict:
    """{call: [score of each candidate]} through every ``pair_calls`` entry."""
    return {name: [fn(ref_u8, d, **on) for d in dists] for name, fn in pair_calls().items()}


def rel_diff(got: float, want: float) -> float:
    return 0.0 if got == want else abs(got - want) / max(abs(want), 1e-30)


def pair_kernel_inputs(ref_u8: np.ndarray, dist_u8: np.ndarray, device) -> tuple:
    """What K7 and K8 take on the single pair's path: K7's (d1, b0) at full
    and half resolution, and K8's four planes at every SSIMULACRA2 scale."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import ssimulacra2 as s2
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear

    ref = torch.from_numpy(ref_u8).to(device)
    dist = torch.from_numpy(dist_u8).to(device)
    lin0, lin1 = ba._planar_linear(ref), ba._planar_linear(dist)[None]
    pre = ba.precompute_butteraugli_reference(lin0)
    it = float(np.float32(pre.params.intensity_target))
    k7 = []
    for mask_pre, lin in ((pre.mask_full, lin1), (pre.mask_sub, ba._subsample2x(lin1))):
        pi1 = ba._psycho_batch(lin * it)
        d1 = ba._diff_precompute(ba._combine_channels_for_masking(pi1)).contiguous()
        k7.append((d1, mask_pre[0].contiguous()))
    ref_s2 = s2.precompute_reference(ref)
    k8, linear = [], torch.movedim(srgb_u8_to_linear(dist), -1, 0).contiguous()
    for scale in range(s2.NUM_SCALES):
        if scale:
            linear = s2.downscale_by_2(linear)
        xyb2 = s2._to_positive_xyb(linear).contiguous()
        k8.append((ref_s2.xyb[scale], ref_s2.mu[scale], ref_s2.sqblur[scale], xyb2))
    return k7, k8


def pair_checks(k7: list, k8: list, label: str) -> dict:
    """K7 (exactly) and K8 (within K1_TOL) against their plain versions on a
    single pair's inputs; the checks phase 7 times, at full resolution."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.cuda import maskac, scale_features

    mul, sigma = ba._MASK_DIFF_AC_MUL, ba.SIGMA_MASK
    k7_err = 0.0
    for d1, b0 in k7:
        b, h, w = d1.shape
        k7_err = max(k7_err, compare(
            f"K7 mask_diff_ac {label} {b}x{h}x{w}", maskac.mask_diff_ac_batch(d1, b0, mul, sigma),
            maskac.mask_diff_ac_plain(d1, b0, mul, sigma), **EXACT))
    d1, b0 = k7[0]
    k8_err, moved, ops = 0.0, 0, 0
    for a in k8:
        sw = a[3].shape[-1]
        got = scale_features.scale_features(*a)
        k8_err = max(k8_err, compare(
            f"K8 scale_features {label} {sw}px", got,
            scale_features.scale_features_plain(*a), **K1_TOL))
        moved += nbytes(*a, got)
        ops += K1_OPS * a[3].numel()
    torch.cuda.synchronize()
    return {
        "mask_diff_ac": Check(
            k7_err,
            lambda: maskac.mask_diff_ac_batch(d1, b0, mul, sigma),
            lambda: maskac.mask_diff_ac_plain(d1, b0, mul, sigma),
            2 * nbytes(d1) + 2 * nbytes(b0),  # d1 and out; b0 and the reciprocal plane
            (blur_ops(sigma) + MASK_EPILOGUE_OPS) * d1.numel(),
            f"{d1.shape[-1]} px, B=1",
        ),
        "scale_features_pair": Check(
            k8_err,
            lambda: [scale_features.scale_features(*a) for a in k8],
            lambda: [scale_features.scale_features_plain(*a) for a in k8],
            moved, ops, f"{k8[0][3].shape[-1]} px, one pair, six scales",
        ),
    }


def pair_grid_times(k7: list, k8: list, label: str) -> None:
    """Each K7 and K8 launch of a single pair: its grid, the wrapper's time
    (CUDA events over 10 calls, host overhead between launches included)
    and the kernel's own device time (profiler)."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.cuda import maskac, scale_features

    def show(name, shape, blocks, fn, kernel):
        own = own_device_ms(fn, kernel)
        own = "not measured" if own is None else f"{own:.4f} ms"
        print(f"    {name} {label} {shape}: grid {blocks} blocks, "
              f"wrapper {time_ms(fn, 10):.4f} ms, kernel alone {own}")

    for d1, b0 in k7:
        _, h, w = d1.shape
        show("K7", f"{w} px", -(-w // 64) * -(-h // 32),
             lambda: maskac.mask_diff_ac_batch(d1, b0, ba._MASK_DIFF_AC_MUL, ba.SIGMA_MASK),
             "mask_diff_ac_kernel")
    for a in k8:
        _, h, w = a[3].shape
        show("K8", f"{w} px", 3 * scale_features.grid_blocks(h, w),
             lambda: scale_features.scale_features(*a), "scale_features_kernel")


def check_k7_ragged(device) -> None:
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.cuda import maskac

    rng = np.random.default_rng(SEED)
    for b, h, w in ((2, 37, 53), (1, 67, 653)):
        d1 = torch.from_numpy(rng.random((b, h, w), np.float32) * 10.0).to(device)
        b0 = torch.from_numpy(rng.random((h, w), np.float32) * 10.0).to(device)
        args = (d1, b0, ba._MASK_DIFF_AC_MUL, ba.SIGMA_MASK)
        compare(f"K7 mask_diff_ac {b}x{h}x{w}", maskac.mask_diff_ac_batch(*args),
                maskac.mask_diff_ac_plain(*args), **EXACT)


def time_pair_calls(ref_u8: np.ndarray, dist_u8: np.ndarray) -> dict:
    """Each ``calculate_*`` per call on the card, host clock: median of 5
    after a warm-up (the reference precompute and the copies included)."""
    out = {}
    for name, fn in pair_calls().items():
        fn(ref_u8, dist_u8)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(ref_u8, dist_u8)
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e3
    side = ref_u8.shape[0]
    print(f"  calculate_* at {side}px, ms per call (median of 5): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def phase_single_pair(
    ref_u8: np.ndarray, big_u8: np.ndarray, big: np.ndarray, big_rows: dict, device
) -> tuple:
    """Part 1-3 of phase 7: single pairs at 512 and 2048 px with the launch
    counts read around them, the host (512) and the batch scorer (2048) as
    references, and K7 and K8 against their plain versions on the pairs'
    inputs.  ``big`` holds the decodes of ``big_u8`` at ``BIG_PICKS``.
    Returns the checks at 512 and 2048, the launch counts, and K7's and K8's
    inputs at both sizes."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear

    cands = candidates(ref_u8, PAIR_PICKS)
    reset_launches()
    card = score_pairs(ref_u8, cands)
    launches = read_launches()
    check_launches(f"of the single pairs at {SIZE}px", launches,
                   expected_pair_launches(SIZE, len(PAIR_PICKS)))
    t0 = time.perf_counter()
    host = score_pairs(ref_u8, cands, device="cpu")
    print(f"  host rescoring of q{PAIR_PICKS}: {time.perf_counter() - t0:.2f} s")
    for name, scores in card.items():
        metric = name.split("_")[0]
        for q, g, w in zip(PAIR_PICKS, scores, host[name]):
            rel = rel_diff(g, w)
            print(f"    q{q} {name}: card {g!r} host {w!r} rel {rel:.3e}")
            if not np.isfinite(g) or rel > SCORE_RTOL[metric]:
                raise AssertionError(f"q{q} {name}: card {g!r} vs host {w!r}")
    same = {name: fn(ref_u8, ref_u8.copy()) for name, fn in pair_calls().items()}
    print(f"  identical pair: {same}")
    if same != {"ssimulacra2": 100.0, "dssim": 0.0, "butteraugli": 0.0, "butteraugli_250": 0.0,
                "psnr": float("inf")}:
        raise AssertionError(f"identical pairs scored {same}")

    reset_launches()
    card_big = score_pairs(big_u8, big)
    launches_big = read_launches()
    check_launches(f"of the single pairs at {BIG}px", launches_big,
                   expected_pair_launches(BIG, len(BIG_PICKS)))
    # The batch scorer's scores of the same candidates: phase 5's report,
    # and Butteraugli at 250 nits through the batch path on the card.
    ref_t = torch.from_numpy(big_u8).to(device)
    lin_ref = torch.movedim(srgb_u8_to_linear(ref_t), -1, 0).contiguous()
    lin = srgb_u8_to_linear(torch.from_numpy(np.ascontiguousarray(np.moveaxis(big, -1, 1)))
                            .to(device))
    pre250 = ba.precompute_butteraugli_reference(lin_ref, ba.ButteraugliParams(
        intensity_target=250.0))
    batch250 = ba.butteraugli_batch(pre250, lin).cpu().tolist()
    worst = 0.0
    for name, scores in card_big.items():
        for i, (q, g) in enumerate(zip(BIG_PICKS, scores)):
            w = batch250[i] if name == "butteraugli_250" else getattr(big_rows[q], name)
            rel = rel_diff(g, w)
            worst = max(worst, rel)
            print(f"    q{q} {name}: pair {g!r} batch {w!r} rel {rel:.3e}")
            if rel > PAIR_VS_BATCH_RTOL:
                raise AssertionError(f"q{q} {name}: single pair {g!r} vs batch {w!r}")
    print(f"  largest relative difference, single pair vs batch at {BIG}px: {worst:.3e}")

    print("  K7 and K8 against their plain versions on the single pairs' inputs")
    small, large = (pair_kernel_inputs(ref_u8, cands[1], device),
                    pair_kernel_inputs(big_u8, big[0], device))
    checks = pair_checks(*small, f"{SIZE}")
    checks_big = pair_checks(*large, f"{BIG}")
    check_k7_ragged(device)
    return checks, checks_big, launches, launches_big, small, large


def phase_run_eval(report_dir: Path, rows: dict) -> None:
    """Part 4 of phase 7: ``run_eval`` over two 512 px images through the
    block-DCT codec, on the card by default, against an ``EvalSession``'s
    SSIMULACRA2 column for the same images and qualities: phase 3's report
    (``rows``) for the first, a session of its own for the second."""
    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch import iter as ci

    def encode(rgb, quality):
        return dct_encode(ce.ImageData.rgb8(rgb), ce.EncodeRequest(quality=quality))

    images = [ci.SourceImage(f"seed{s}", make_image(SIZE, s)) for s in (SEED, SEED + 1)]
    codec = ci.Codec(encode, dct_decode_array, "dct-q")
    reset_launches()
    t0 = time.perf_counter()
    result = ci.run_eval(images, codec, QUALITIES)
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want["scale_features"] = 6 * len(images)
    check_launches("of run_eval", launches, want)
    n = len(result.points)
    print(f"  run_eval of {len(images)} x {len(QUALITIES)} at {SIZE}px on the card: "
          f"{wall:.3f} s wall ({result.total_ms} ms by its clock), {n / wall:.2f} pairs/s "
          f"(host codec included)")

    config = (ce.EvalConfig.builder().report_dir(report_dir)
              .metrics(ce.MetricConfig(ssimulacra2=True)).quality_levels(QUALITIES).build())
    session = ce.EvalSession(config)
    session.add_codec_with_decode("dct-q", "1", dct_encode,
                                  lambda data: ce.ImageData.rgb8(dct_decode_array(data)))
    worst = 0.0
    for i, src in enumerate(images):
        if i:
            report = session.evaluate_image(src.name, ce.ImageData.rgb8(src.rgb))
            column = {r.quality: r.metrics.ssimulacra2 for r in report.results}
        else:
            column = {q: m.ssimulacra2 for q, m in rows.items()}
        for p in result.points:
            if p.image == src.name:
                rel = rel_diff(p.ssim2, column[p.quality])
                worst = max(worst, rel)
                if rel > PAIR_VS_BATCH_RTOL:
                    raise AssertionError(f"{p.image} q{p.quality}: run_eval {p.ssim2!r} vs "
                                         f"session {column[p.quality]!r}")
    print(f"  run_eval's ssim2 against the session's SSIMULACRA2 column: "
          f"largest relative difference {worst:.3e}")


# ------------------------------------------------- phase 8: mixed sizes


def mixed_corpus(big_u8: np.ndarray, big_batch: np.ndarray) -> tuple:
    """20 pairs of crops of the 2048 px image: 4 x 512, 2 x 800, the whole
    2048, 2048 x 1365 landscape and portrait, 333 x 517; candidates are the
    same crops of its q50 and q90 decodes (the codec codes 8x8 blocks
    independently, so an 8-aligned crop of a decode is the decode of the
    crop).  Returns the pairs and a label for each."""
    crops = [  # (row, col, h, w)
        (0, 0, 512, 512), (0, 1536, 512, 512), (1536, 0, 512, 512), (1536, 1536, 512, 512),
        (96, 608, 800, 800), (1024, 1024, 800, 800), (0, 0, BIG, BIG),
        (344, 0, 1365, BIG), (0, 344, BIG, 1365), (1200, 400, 333, 517),
    ]
    pairs, labels = [], []
    for y, x, h, w in crops:
        for q in MIXED_QUALITIES:
            dec = big_batch[BIG_QUALITIES.index(q)]
            pairs.append((np.ascontiguousarray(big_u8[y : y + h, x : x + w]),
                          np.ascontiguousarray(dec[y : y + h, x : x + w])))
            labels.append(f"{h}x{w} q{q}")
    return pairs, labels


def stage_bucket(pairs: list, shapes: list, bucket: tuple) -> tuple:
    """One bucket of the masked path on the card: the padded (N, H, W, 3)
    references and candidates and the (N, 2) valid dims."""
    from codec_eval_tpu_torch.kernels import masked as tm

    idx = [i for i, s in enumerate(shapes) if s == bucket]
    refs, dists = (
        torch.from_numpy(np.stack([tm.pad_to_bucket(pairs[i][k], *bucket) for i in idx])).cuda()
        for k in (0, 1)
    )
    return refs, dists, torch.tensor([pairs[i][0].shape[:2] for i in idx]).cuda()


def k9_inputs(pairs: list, shapes: list, bucket: tuple) -> list:
    """K9's inputs at every SSIMULACRA2 scale of one bucket of the masked
    path: (label, (xyb1, xyb2)), the planes zero beyond each pair's valid
    dims, as ``kernels/masked.py`` stages them."""
    from codec_eval_tpu_torch.kernels import masked as tm

    return [(f"{x1.shape[-2]}x{x1.shape[-1]}, N={x1.shape[0]}", (x1, x2))
            for x1, x2, _, _ in tm._xyb_pyramid(*stage_bucket(pairs, shapes, bucket))]


def k4_inputs(pairs: list, shapes: list, bucket: tuple) -> list:
    """K4's inputs on one bucket of the masked path: (label, diffs) at full
    and half resolution, the six Malta diff planes zeroed beyond each pair's
    valid rectangle, as ``kernels/masked.py`` stages them."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import masked as tm

    params = ba.ButteraugliParams(hf_asymmetry=0.8, intensity_target=80.0)
    out = []
    for level in tm._resolutions(*stage_bucket(pairs, shapes, bucket)):
        diffs = tm._malta_inputs(*level, params)[0]
        out.append((f"{diffs.shape[-2]}x{diffs.shape[-1]}, N={diffs.shape[0]}", diffs))
    return out


def k9_check(err: float, x1: torch.Tensor, x2: torch.Tensor, shapes: str) -> Check:
    """K9 on (x1, x2) for phase 6-style timing: its bound counts two planes
    read and three written per channel-pixel; the library call is one
    grouped ``conv2d`` with the 15x15 outer-product kernel on zero padding,
    over the stacked products made beforehand."""
    import torch.nn.functional as F
    from codec_eval_tpu_torch.kernels.blur import gaussian_taps
    from codec_eval_tpu_torch.kernels.cuda import moments

    taps = torch.from_numpy(gaussian_taps(moments.SIGMA)).to(x1.device)
    weight = torch.outer(taps, taps).expand(9, 1, len(taps), len(taps)).contiguous()
    stacked = torch.cat([x2, x2 * x2, x1 * x2], dim=1)
    conv = F.conv2d(stacked, weight, padding=len(taps) // 2, groups=9)
    plain = torch.cat(moments.candidate_moments_plain(x1, x2), dim=1)
    print(f"  grouped conv2d against K9's plain version ({shapes}): max |difference| "
          f"{float((conv - plain).abs().max()):.3e}")
    return Check(
        err,
        lambda: moments.candidate_moments(x1, x2),
        lambda: moments.candidate_moments_plain(x1, x2),
        5 * nbytes(x2), K9_OPS * x2.numel(), shapes,
        library=lambda: F.conv2d(stacked, weight, padding=len(taps) // 2, groups=9),
    )


def profile_masked(pairs: list, shapes: list) -> None:
    """Where one masked corpus call spends the card's time, from
    ``torch.profiler``: the dense operator products (cuBLAS GEMMs), K4, K9
    and everything else (eager elementwise ops, reductions, copies), the
    largest of the rest by name; then each masked metric alone over the six
    buckets (host clock, median of 3)."""
    from torch.profiler import ProfilerActivity

    from codec_eval_tpu_torch import parallel as par
    from codec_eval_tpu_torch.kernels import masked as tm

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        par.score_pairs_sharded(pairs, masked=True, granularity=GRANULARITY)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {"GEMM (dense masked blurs)": 0.0, "K4 malta_kernel": 0.0,
              "K9 candidate_moments_kernel": 0.0, "other": 0.0}
    count, rest = 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue
        count += e.count
        key = e.key.lower()
        group = ("GEMM (dense masked blurs)" if "gemm" in key else
                 "K4 malta_kernel" if "malta_kernel" in key else
                 "K9 candidate_moments_kernel" if "candidate_moments_kernel" in key else "other")
        groups[group] += device_us(e) / 1e3
        if group == "other":
            rest.append(e)
    busy = sum(groups.values())
    print(f"  profiled masked corpus call: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle {100 * (1 - busy / wall):.1f} %, {count} device operations")
    for name, ms in groups.items():
        print(f"    {ms:10.3f} ms  {name}")
    print("  the largest of the rest:")
    for e in sorted(rest, key=device_us, reverse=True)[:8]:
        print(f"    {device_us(e) / 1e3:10.3f} ms  {e.count:6d} calls  {e.key[:90]}")

    staged = [stage_bucket(pairs, shapes, b) for b in sorted(set(shapes), key=shapes.index)]
    for name in ("ssimulacra2", "dssim", "butteraugli", "psnr"):
        fn = getattr(tm, f"{name}_masked_batch")
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            for refs, dists, hw in staged:
                fn(refs, dists, hw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"  {name} alone, six buckets: median {statistics.median(times[1:]) * 1e3:.1f} ms "
              f"of 3 after a warm-up")


def phase_mixed(big_u8: np.ndarray, big_batch: np.ndarray) -> tuple:
    """Phase 8: the mixed-size corpus through the masked corpus runner with
    no ``device``; returns K9's row of the kernels line and what it adds to
    K4's row (launches, error and times on the masked path's inputs)."""
    from codec_eval_tpu_torch import parallel as par
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import masked as tm
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS, malta, moments

    metrics = ("ssimulacra2", "dssim", "butteraugli", "psnr")
    pairs, labels = mixed_corpus(big_u8, big_batch)
    shapes = tm.bucket_shapes([p[0].shape[:2] for p in pairs], GRANULARITY)
    buckets = sorted(set(shapes), key=shapes.index)
    print(f"  {len(pairs)} pairs in {len(buckets)} buckets of {GRANULARITY} px: "
          + ", ".join(f"{h}x{w} ({shapes.count((h, w))})" for h, w in buckets))
    if len(pairs) != 20 or len(buckets) != 6 or max(map(shapes.count, buckets)) > MASKED_BATCH:
        raise AssertionError(f"the corpus must be 20 pairs in six buckets of at most "
                             f"{MASKED_BATCH} pairs")

    # One masked call, the launch counts read around it: per bucket (one
    # scoring step each) K9 at six scales on both sides and K4 at full and
    # half resolution, nothing else.
    kw = dict(masked=True, granularity=GRANULARITY, batch=MASKED_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    masked = par.score_pairs_sharded(pairs, **kw)
    first = time.perf_counter() - t0
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(candidate_moments=12 * len(buckets), malta_ac=2 * len(buckets))
    launches = read_launches()
    check_launches("of the masked corpus", launches, want)
    print(f"  first masked call: {first:.2f} s")
    if len(masked.per_pair) != len(pairs) or any(
        set(p) != set(metrics) or not all(np.isfinite(p[k]) for k in metrics)
        for p in masked.per_pair
    ):
        raise AssertionError("the masked corpus did not give four finite scores per pair")

    # Every masked score against the exact-shape path on the card.
    t0 = time.perf_counter()
    exact = par.score_pairs_sharded(pairs)
    exact_s = time.perf_counter() - t0
    worst = dict.fromkeys(metrics, 0.0)
    for label, g, e in zip(labels, masked.per_pair, exact.per_pair):
        print(f"    {label}: masked " + " ".join(f"{k}={g[k]:.6f}" for k in metrics)
              + " | exact " + " ".join(f"{e[k]:.6f}" for k in metrics))
        for k in metrics:
            worst[k] = max(worst[k], rel_diff(g[k], e[k]))
            if abs(g[k] - e[k]) > MASKED_VS_EXACT["abs"] + MASKED_VS_EXACT["rel"] * abs(e[k]):
                raise AssertionError(f"{label} {k}: masked {g[k]!r} vs exact {e[k]!r}")
    print(f"  exact path, one pair at a time: {exact_s:.2f} s; largest relative difference "
          f"masked vs exact: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # The 333x517 bucket on the host.
    small = [i for i, s in enumerate(shapes) if s == (384, 640)]
    t0 = time.perf_counter()
    host = par.score_pairs_sharded(
        [pairs[i] for i in small], mesh=par.make_mesh(devices=[torch.device("cpu")]), **kw
    )
    print(f"  host rescoring of the 384x640 bucket: {time.perf_counter() - t0:.2f} s")
    for i, h in zip(small, host.per_pair):
        for k in metrics:
            g = masked.per_pair[i][k]
            print(f"    {labels[i]} {k}: card {g!r} host {h[k]!r} rel {rel_diff(g, h[k]):.3e}")
            if rel_diff(g, h[k]) > SCORE_RTOL[k]:
                raise AssertionError(f"{labels[i]} {k}: card {g!r} vs host {h[k]!r}")

    # The corpus as a whole: wall time of the masked call, staging included.
    par.score_pairs_sharded(pairs, **kw)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        par.score_pairs_sharded(pairs, **kw)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"  masked corpus of {len(pairs)} pairs: median {med * 1e3:.1f} ms of 3 "
          f"({[round(t * 1e3, 1) for t in times]}), {len(pairs) / med:.2f} pairs/s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_masked(pairs, shapes)

    # K9 against its plain version, bit for bit: every scale of the 512,
    # 2048 and 2048x1408 buckets, both sides, and two ragged shapes.  The
    # top scales of the first two are timed below.
    err, tops = 0.0, {}
    for bucket in ((512, 512), (BIG, BIG), (BIG, 1408)):
        scales = k9_inputs(pairs, shapes, bucket)
        tops[bucket] = scales[0]
        for label, (x1, x2) in scales:
            for side, a, b in (("candidate", x1, x2), ("reference", x1, x1)):
                err = max(err, compare(
                    f"K9 {side} {label}", torch.stack(moments.candidate_moments(a, b)),
                    torch.stack(moments.candidate_moments_plain(a, b)), **EXACT))
        del scales
    rng = np.random.default_rng(SEED)
    for shape in ((2, 3, 37, 53), (1, 3, 67, 653)):
        a, b = (torch.from_numpy(rng.random(shape, np.float32)).cuda() for _ in range(2))
        err = max(err, compare(
            f"K9 {'x'.join(map(str, shape))}", torch.stack(moments.candidate_moments(a, b)),
            torch.stack(moments.candidate_moments_plain(a, b)), **EXACT))

    # K4 against its plain version on the masked diff planes of the 512,
    # 2048x1408 and 384x640 buckets at full and half resolution; timed on
    # the 2048x1408 bucket's full resolution.
    lines = (ba._MALTA_LINES_FULL, ba._MALTA_LINES_LF)
    k4_err, k4_timed = 0.0, None
    for bucket in ((512, 512), (BIG, 1408), (384, 640)):
        for label, diffs in k4_inputs(pairs, shapes, bucket):
            got = malta.malta_ac_batch(diffs, *lines)
            k4_err = max(k4_err, compare(f"K4 malta_ac masked {label}", got,
                                         malta.malta_ac_plain(diffs, *lines), **KERNEL_TOL))
            if bucket == (BIG, 1408) and k4_timed is None:
                k4_timed = Check(
                    k4_err, functools.partial(malta.malta_ac_batch, diffs, *lines),
                    functools.partial(malta.malta_ac_plain, diffs, *lines),
                    nbytes(diffs, got), malta_ops(*lines) * diffs.shape[0] * diffs[0, 0].numel(),
                    f"masked 2048x1408 bucket, {label}")
            del got

    fn = WRAPPERS["candidate_moments"]
    top_small, top_big = tops[(512, 512)], tops[(BIG, BIG)]
    k9_row = {
        "name": "candidate_moments", "route": "cuda", "source": fn.source,
        "replaces": fn.replaces, "launches": launches["candidate_moments"], "max_abs_err": err,
        **time_check("candidate_moments", k9_check(err, *top_small[1], top_small[0])),
        "shapes": f"512x512 bucket top scale, {top_small[0]}",
        "launches_per_bucket": launches["candidate_moments"] // len(buckets),
        "at_2048": time_check("candidate_moments on the 2048x2048 bucket",
                              k9_check(err, *top_big[1], top_big[0])),
        "corpus_ms": med * 1e3, "corpus_pairs_per_s": len(pairs) / med,
    }
    k4_extra = {
        "launches_masked": launches["malta_ac"], "max_abs_err_masked": k4_err,
        "at_masked": {"shapes": k4_timed.shapes,
                      **time_check("malta_ac on the masked path", k4_timed,
                                   OWN_TIME["malta_ac"])},
    }
    return k9_row, k4_extra


def time_check(label: str, c: Check, own: Optional[str] = None) -> dict:
    """Kernel, plain and library device times of one check, in turns; with
    ``own``, also the device time of the CUDA kernels of that name alone."""
    p1, k1, k2, p2 = (time_ms(f, 10) for f in (c.plain, c.kernel, c.kernel, c.plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    library_ms = time_ms(c.library, 10) if c.library is not None else None
    bound_ms, bound_by = bound(c.nbytes, c.ops)
    lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
    times = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library_ms}
    if own:
        alone = times["own_device_ms"] = own_device_ms(c.kernel, own)
        lib += f", kernel alone {alone:.4f} ms" if alone else ", kernel alone not measured"
    print(f"  {label} ({c.shapes}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({c.nbytes / 1e6:.1f} MB, "
          f"{c.ops / 1e9:.2f} Gop)")
    return times


def profile(ref_u8: np.ndarray, batch: np.ndarray) -> None:
    """``torch.profiler`` over one all-metric ``score_batch``, the
    host staging on its own, and each metric's ``score_batch`` alone (median
    of 3 after a warm-up)."""
    import codec_eval_tpu_torch as ce
    from torch.profiler import ProfilerActivity

    scorer = ce.BatchScorer(ce.MetricConfig.all())
    scorer.score_batch(ref_u8, batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scorer.score_batch(ref_u8, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # Device-side events are the kernels and copies; the operators that
    # launched them carry the same time again.  The profiler's own buffer
    # requests are left out.
    events = sorted(
        (e for e in prof.key_averages() if not e.key.startswith("Activity Buffer")),
        key=device_us, reverse=True,
    )
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    busy = sum(device_us(e) for e in on_device) / 1e3
    print(f"  profiled score_batch of {len(batch)}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms, idle {100 * (1 - busy / (wall * 1e3)):.1f} %")
    for title, rows in (("operators", ops), ("kernels and copies", on_device)):
        print(f"  by {title}, self device time:")
        for e in rows[:15]:
            if device_us(e) <= 0:
                break
            print(f"    {device_us(e) / 1e3:10.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    # The scorer's host staging alone: the transpose to planar, then the copy.
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        planar = np.ascontiguousarray(np.moveaxis(batch, -1, 1))
        times.append(time.perf_counter() - t0)
    h2d = time_ms(lambda: torch.from_numpy(planar).to("cuda"), 3)
    print(f"  host transpose to planar: median {statistics.median(times) * 1e3:.3f} ms of 3; "
          f"pageable copy to the card: {h2d:.3f} ms")
    for metric in ("psnr", "ssimulacra2", "dssim", "butteraugli"):
        one = ce.BatchScorer(ce.MetricConfig(**{metric: True}))
        one.score_batch(ref_u8, batch)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            one.score_batch(ref_u8, batch)
            times.append(time.perf_counter() - t0)
        print(f"  {metric} alone: median {statistics.median(times) * 1e3:.3f} ms of 3")


def profile_pairs(ref_u8: np.ndarray, dist_u8: np.ndarray) -> None:
    """``torch.profiler`` over one call of each ``calculate_*`` after a
    warm-up: wall (under the profiler), device busy time, idle share and the
    number of device operations (kernels and copies)."""
    from torch.profiler import ProfilerActivity

    for name, fn in pair_calls().items():
        fn(ref_u8, dist_u8)
        torch.cuda.synchronize()
        with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            fn(ref_u8, dist_u8)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith("Activity Buffer")]
        busy = sum(device_us(e) for e in on_device) / 1e3
        print(f"  {name} at {ref_u8.shape[0]}px: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
              f"idle {100 * (1 - busy / wall):.1f} %, "
              f"{sum(e.count for e in on_device)} device operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS, _lib

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    start = time.perf_counter()
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _lib.load()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for kernel in PTXAS_KERNELS:
        for line in _lib.ptxas_report(kernel):
            entry = re.search(r"entry function '\w*?\d((?:malta_\w*?|bands_|scale_features_)"
                              r"kernel)(?:ILi(\d+)E)?", line)
            if entry:
                arg = f"<{entry.group(2)}>" if entry.group(2) else ""
                print(f"  ptxas -v, {entry.group(1)}{arg}:")
            elif "Compile time" not in line and "Function properties" not in line:
                print(f"    {line}")

    def done(phase, t0: float) -> None:
        print(f"  phase {phase}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    ref_u8 = make_image(SIZE, SEED)
    print(f"[2] kernels vs plain on the card ({len(QUALITIES)} x 3 x {SIZE} x {SIZE})")
    checks = phase_kernels(ref_u8, candidates(ref_u8, QUALITIES), device)
    check_odd_shapes(device)
    check_ragged_strips(device)
    done(2, t0)

    t0 = time.perf_counter()
    print(f"[3] EvalSession sweep on {device}: {len(QUALITIES)} qualities at {SIZE}px")
    with tempfile.TemporaryDirectory() as tmp:
        launches, rows_512 = phase_slice(ref_u8, QUALITIES, [5, 50, 100], Path(tmp), device,
                                         idle={"malta_diffmap", "blur", *PAIR_ONLY,
                                               *MASKED_ONLY})
    done(3, t0)

    t0 = time.perf_counter()
    print("[4] libjxl Butteraugli oracle on the card")
    phase_oracle(device)
    done(4, t0)

    t0 = time.perf_counter()
    big_u8 = make_image(BIG, SEED)
    print(f"[5] EvalSession sweep with the default device: {len(BIG_QUALITIES)} qualities "
          f"at {BIG}px")
    with tempfile.TemporaryDirectory() as tmp:
        launches_big, big_rows = phase_slice(big_u8, BIG_QUALITIES, BIG_PICKS, Path(tmp), None,
                                             idle=PAIR_ONLY | MASKED_ONLY)
    big_batch = candidates(big_u8, BIG_QUALITIES)
    print(f"  kernels vs plain on the {BIG} px sweep's inputs")
    checks_big = phase_kernels(big_u8, big_batch, device)
    k56, k6_half, flows = phase_kernels_big(big_u8, big_batch, device)
    checks_big.update(k56)
    done(5, t0)

    t0 = time.perf_counter()
    print(f"[6] device time, mean of 10 (plain, kernel, kernel, plain) | {card}")
    rows = []
    for name, fn in WRAPPERS.items():
        if name in PAIR_ONLY | MASKED_ONLY:
            continue  # K7 and K8 run on phase 7's path, K9 on phase 8's; timed there
        # Each kernel's row is timed on the path it was ported for (K1-K4 at
        # 512 px, K5 and K6 at 2048 px); its error is the worst of both paths.
        small, big = checks.get(name), checks_big[name]
        row = {
            "name": name, "route": "cuda", "source": fn.source, "replaces": fn.replaces,
            "launches": (launches if small else launches_big)[name],
            "max_abs_err": max(big.err, small.err if small else 0.0),
            **time_check(name, small or big, OWN_TIME.get(name)),
            "shapes": (small or big).shapes,
            "launches_512": launches[name], "launches_2048": launches_big[name],
            "max_abs_err_512": small.err if small else None, "max_abs_err_2048": big.err,
        }
        if small:
            row["at_2048"] = time_check(f"{name} on the {BIG} px path", big, OWN_TIME.get(name))
        rows.append(row)
    time_check("blur (half resolution)", k6_half)
    for shapes, fused, unfused in flows:
        f1, u1, u2, f2 = (time_ms(f, 5) for f in (fused, unfused, unfused, fused))
        diff = (fused() - unfused()).abs().max().item()
        print(f"  diffmap ({shapes}), mean of 5: K5 with its staging {(f1 + f2) / 2:.4f} ms, "
              f"prologue + K4 + eager epilogue {(u1 + u2) / 2:.4f} ms; "
              f"max |difference| {diff:.3e}")
    done(6, t0)

    t0 = time.perf_counter()
    print(f"[7] the single-pair API and the codec-iter loop, no device given | {card}")
    picks = big_batch[[BIG_QUALITIES.index(q) for q in BIG_PICKS]]
    pair, pair_big, launches_pair, launches_pair_big, k78, k78_big = phase_single_pair(
        ref_u8, big_u8, picks, big_rows, device)
    with tempfile.TemporaryDirectory() as tmp:
        phase_run_eval(Path(tmp), rows_512)
    pick = candidates(ref_u8, [50])[0]
    time_pair_calls(ref_u8, pick)
    time_pair_calls(big_u8, big_batch[0])
    for name in sorted(PAIR_ONLY, key=list(WRAPPERS).index):
        fn, small, big = WRAPPERS[name], pair[name], pair_big[name]
        rows.append({
            "name": name, "route": "cuda", "source": fn.source, "replaces": fn.replaces,
            "launches": launches_pair[name], "max_abs_err": max(small.err, big.err),
            **time_check(name, small, OWN_TIME.get(name)), "shapes": small.shapes,
            "launches_512": launches_pair[name], "launches_2048": launches_pair_big[name],
            "max_abs_err_512": small.err, "max_abs_err_2048": big.err,
            "at_2048": time_check(f"{name} on the {BIG} px single pair", big,
                                  OWN_TIME.get(name)),
        })
    done(7, t0)

    t0 = time.perf_counter()
    print(f"[8] the mixed-size corpus, masked, no device given | {card}")
    k9_row, k4_extra = phase_mixed(big_u8, big_batch)
    k4_row = next(r for r in rows if r["name"] == "malta_ac")
    k4_row["max_abs_err"] = max(k4_row["max_abs_err"], k4_extra["max_abs_err_masked"])
    k4_row.update(k4_extra)
    rows.append(k9_row)
    done(8, t0)

    if "--profile" in sys.argv[1:]:
        t0 = time.perf_counter()
        for image, batch in ((ref_u8, candidates(ref_u8, QUALITIES)), (big_u8, big_batch)):
            print(f"[profile] one score_batch of {len(batch)} at {image.shape[0]}px | {card}")
            profile(image, batch)
        print(f"[profile] K7 and K8 launch by launch, one pair (q{PAIR_PICKS[1]} at {SIZE}px, "
              f"q{BIG_PICKS[0]} at {BIG}px) | {card}")
        pair_grid_times(*k78, f"{SIZE}")
        pair_grid_times(*k78_big, f"{BIG}")
        print(f"[profile] one call of each calculate_* (q50) | {card}")
        profile_pairs(ref_u8, pick)
        profile_pairs(big_u8, big_batch[0])
        done("profile", t0)

    torch.cuda.synchronize()
    print(f"  total: {time.perf_counter() - start:.2f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
