#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``codec_eval_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # and profiles: one batch per size, K7/K8/K2 per launch

Builds the hand-written kernels from ``codec_eval_tpu_torch/csrc`` with
``nvcc`` (one process per source, in parallel) and then runs twelve phases,
each failing loudly:

1. device: the card's name and power limit, the kernels' build time, the
   compiler's registers, shared memory and spills of the strip kernels
   (K1, K2, K3, K9 and K9's tile walk; K6 and K7 at radii 1, 6 and 16) and
   the Malta kernels (K4, K5), and a summary of K2's SASS (its
   instructions and IEEE division sequence);
2. K1-K4 against their plain PyTorch versions on the card, on the inputs the
   512 px all-metric sweep gives them (25 candidates and the reference at
   512 and 256 px, K1 at all six SSIMULACRA2 scales), and all six kernels
   at three ragged shapes (K6 at sigma 2.7 and 7.16), and K1, K2, K3 and
   K8 where the last strip and the last segment of rows are both ragged and
   at the smallest pyramid scales (K2 and K3 bit for bit, K8 equal to K1's
   candidate in a batch); K6 and K7 bit for bit at radii 1, 6 and 16 where
   the last strip and segment are ragged, K6 at every segment length, and
   K7 equal to K6's blur followed by the eager mask term;
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
   to 64 px; K2, K3 and K6 at 2048 and 1024, K6 bit for bit; K4 at 1024;
   K5 at 2048);
6. each kernel's time against its plain version's and its bound, on both
   paths for K1-K4, with the kernel-alone device time of K1-K6 (K7 and K8
   in phase 7); for K6 the dense operator product it replaces and a
   ``conv2d`` with the 2-D outer-product kernel times the reciprocal
   plane; and the whole diffmap at 2048 and 1024 px both ways, through K5
   and through the prologue, K4 and the eager epilogue;
7. the single-pair API and the codec-iter loop: the four ``calculate_*``
   and Butteraugli at 250 nits with no ``device`` on three 512 px
   candidates (K7 and K8 launch, K2-K4 once per pass at B = 1, K5 and K6
   never), rescored on the host, and identical pairs; the same calls on two
   2048 px candidates (K5 launches, and K4 on the 1024 px pass) held to
   phase 5's batch scores on the card; K7 and K8 against their plain
   versions on those pairs' inputs (K2 too, bit for bit, at B = 1) and K7
   at two ragged shapes;
   ``run_eval`` over two 512 px images held to an ``EvalSession``'s
   SSIMULACRA2 column; each ``calculate_*`` timed per call; K7 and K8
   timed against their plain versions and their bounds;
8. the mixed-size corpus: 20 pairs of crops of the 2048 px image (4 x 512,
   2 x 800, 1 x 2048, 2048 x 1365 landscape and portrait, 333 x 517) at q50
   and q90 scored by ``parallel.score_pairs_sharded(masked=True)`` in six
   padded buckets with no ``device`` (per bucket K9 six times in each form,
   candidate and reference, and K4 twice, nothing else), held to the
   exact-shape path on the card and, for the 333 x 517 bucket, to the host;
   where the card's time goes in one masked call (profiler, K9's forms
   apart); both forms of K9 against their plain versions bit for bit,
   through the wrapper and through each walk (strip and tile), at every
   scale of the 512, 2048 x 2048 and 2048 x 1408 buckets and at two ragged
   shapes; K9 timed at every scale of the first two in both forms, through
   the wrapper and alone, beside its bound; K9 timed against its plain
   version and a grouped ``conv2d``; the corpus's wall time, pairs/s and
   peak device memory;
9. the crate-root surface with no ``device``: ``evaluate_single`` on phase
   3's q5, q50 and q100 and phase 5's q50 and q95, held to the batch
   scorer's scores (the same route at B = 1), with the launches of one
   call at each size read (those of one ``score_batch``: K1-K4 at 512 px,
   K1-K6 at 2048 px, never K7-K9) and each size timed per call; ``assert_quality`` raising below its threshold
   and passing above it, ``assert_perception_level`` on an identical pair;
   ``simulate_viewing`` at 2048 -> 1024, 512 -> 1024 and 512 -> 683 against
   the host's resize (at most one code value), the 2048 -> 1024 resize
   timed; ``evaluate_single`` with viewing simulation against ``score_pair``
   of the resized pair; K1-K6 against their plain versions at B = 1 at the
   2048 px call's shapes, and K1-K4 at the 512 px call's; and the stats
   layer on phase 3's ladder (a Pareto front, ``bd_rate`` against itself,
   ``find_knee``, an SVG chart).
10. the corpus session with no ``device``: ``EvalSession.evaluate_corpus``
   over four 512 px images x four callback codecs (phase 3's block-DCT
   codec, a 4:2:0 variant, a coarser table, and a variant that raises at
   q50 on the third image) x phase 3's 25 qualities, 100 candidates per
   image, with ``cache_dir`` set: 4 x 100 rows with exactly one unscored
   failed cell, the JSON back through ``CorpusReport.from_json``, the
   13-column CSV, 399 artifacts of their rows' sizes; launches four times
   phase 3's; every row equal to a second session's ``evaluate_image`` of
   the same image (1e-6 relative) and three rows to the host; K1-K4 against
   their plain versions at B = 100 (K2-K4 bit for bit); ``CodecRegistry``
   with a ``CodecImpl`` and ``codecs.ReportGenerator`` on the card's
   report; the pipeline's wall time against the serial sum of the four
   ``evaluate_image`` walls, and one ``score_batch`` of 100 timed with its
   peak device memory.
11. the command-line layer with no ``device``, on inputs that need no PIL:
   ``rd_calibrate``'s ladder scorer over four 512 px ``synthetic-photo-v1``
   images at its default range, 10:2:98 (45 qualities of phase 3's codec;
   launches four times phase 3's), and the knees, SVG and calibration code
   its ``main`` writes; the same scorer on phase 5's 2048 px ladder (phase
   5's launches, scores equal to phase 5's rows within 1e-6); K1-K4 against
   their plain versions at B = 45 and K5 and K6 on the 2048 px ladder;
   ``analysis.comparison``'s loop over two of the images x two block-DCT
   codecs x 14 qualities with a JSONL checkpoint, resumed by a second call
   that launches nothing, three rows rescored on the host, the CSV through
   ``codec_analyze`` (find-outliers, rd-compare, build-predictor) and
   ``codec_eval`` (pareto, stats); the heuristics of eight 512 px images and
   of the 2048 px image against the host; ``device_trace`` around one call;
   the ladder's ms per image at both sizes, its peak device memory, the
   loop's wall and the scorer's share of it, the heuristics' ms.
12. the device JPEG ladder with no ``device`` and no PIL (a ``RuntimeWarning``
   is an error): ``evaluate_tpujpeg_sweep`` of phase 3's image at its 25
   qualities, all four metrics, with exact sizes and bytes (launches those
   of phase 3's sweep: K1-K4, never K5-K9) and with device sizes (within
   0.4% of the exact ones, the same scores); the ladder's candidates equal
   ``decode_jpeg_device`` of its own bytes bit for bit, ``score_jpeg_files``
   on them equals its scores, three candidates rescored on the host, K1-K4
   against their plain versions on them; the XYB and progressive presets
   (device sizes; the q50 bytes are the codec's) and the trellis preset,
   whose DP on the card is held to ``trellis_quantize_native`` block by
   block (at most 1e-4 of the blocks differ, sizes within 0.1%); phase 5's
   image at q50..95 (phase 5's launches, K1-K6) with K5 and K6 against their
   plain versions on its candidates; ``sweep_corpus_ladders`` over four
   512 px ``synthetic-photo-v1`` images at 10:2:98 with exact and device
   sizes, each image equal to its own sweep, and ``mean_curve``;
   ``encode_to_target(min_ssimulacra2=70)`` rescored from its bytes; an
   ``EvalSession`` with a preset of the registry's zenjpeg slot and
   ``cache_dir`` (one device sweep, no fallback, its artifacts), the slot's
   eight presets through ``CodecRegistry``, and a JPEG adapter without a
   device sweep (one device decode); the ladder's ms at 512 and 2048 px with
   exact and device sizes, the host entropy pass's share, the trellis DP's
   ms, K10 (the trellis DP's kernel) bit for bit against its plain version
   and timed beside it and its bound at rd-calibrate's 45-quality luma and
   chroma shapes, the corpus ladder's ms per image and the peak device
   memory.
13. the multi-device layer.  (a) Two processes of this script
   (``--multihost-worker``) on the one card, in a gloo group on a free
   127.0.0.1 port, each on cuda:0 through ``global_batch_mesh()``: the
   dense global step over 16 pairs at 512 px (phase 3's image against its
   first 16 candidates; per worker K8, K2, K3, K7 and K4 for its 8 pairs),
   the masked global step on phase 8's 512 x 512 bucket (K9 in both forms,
   K4) and ``sweep_corpus_ladders(multihost=True, with_sizes="device")``
   over phase 12's four images (K1-K4, twice phase 3's launches per
   worker).  The workers' results are identical, the steps equal the
   single-process step (1e-6 relative) and the ladder phase 12's corpus
   ladder (sizes exactly, scores 1e-6); each part's ms and peak memory per
   worker.  A worker that fails or hangs fails the phase.  (b) The spatial
   step in this process, two row bands on [cuda:0, cuda:0]: phase 3's image
   at q5, q50 and q90 and phase 5's at q50 and q95, held to the unsharded
   step (1e-5 relative, Butteraugli 1e-4), with twice its launches (K5 at
   full resolution at 2048 px: the image's route, not the band's);
   windowed K8 against its windowed plain version on every band and scale
   (K1_TOL), the full window equal to no window; spatial against unsharded
   ms and peak memory at 2048 px, and windowed K8's time beside its bound.

``--profile`` adds a ``torch.profiler`` breakdown of one ``score_batch``
per size; K7, K8 and K2 launch by launch on one pair at each size (the
grid, the wrapper's time and the kernel's own device time); and the
device's busy and idle time during one call of each ``calculate_*`` at
each size.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``, with the card's ``nvidia-smi`` line just
before them.  Without a CUDA device, or outside a checkout of the
repository, it exits non-zero and prints none of them.
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass, field
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
EXACT = dict(rtol=0.0, atol=0.0)  # K2, K3, K6, K7, K9: the plain version's operations in order
PAIR_PICKS = [5, 50, 100]  # single pairs at 512 px, rescored on the host
# A single pair on the card against the batch scorer's score of the same
# candidate: the kernels run the same code at B = 1 as at B = 10; only
# PyTorch's reductions over a batch may add in another order.
PAIR_VS_BATCH_RTOL = 1e-6
# The kernels that only the single-pair path launches: K7 and K8.
PAIR_ONLY = frozenset({"mask_diff_ac", "scale_features_pair"})
# The kernel that only the masked (mixed-size) path launches: K9, in its
# candidate and reference forms.
MASKED_ONLY = frozenset({"candidate_moments", "reference_moments"})
# The kernel that only the trellis ladders (phase 12) launch: K10.
TRELLIS_ONLY = frozenset({"trellis_dp"})
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
# blurs both ways; its reference form: x1*x1, then two blurs both ways.
K9_OPS = 2 + 6 * (15 + 14)
K9_REF_OPS = 1 + 4 * (15 + 14)
# The CUDA kernels of K9 (the strip walk and the tile walk of small planes).
K9_KERNELS = ("candidate_moments_kernel", "moments_tile_kernel")
# The CUDA kernel behind each wrapper whose rows also carry the kernel's own
# device time (the profiler's, summed over the launches of one call), beside
# the CUDA-events time of the wrapper.
OWN_TIME = {
    "scale_features": "scale_features_kernel", "opsin_xyb": "opsin_kernel",
    "bands": "bands_kernel", "malta_ac": "malta_kernel",
    "malta_diffmap": "malta_diffmap_kernel", "blur": "blur_kernel",
    "mask_diff_ac": "mask_diff_ac_kernel", "scale_features_pair": "scale_features_kernel",
    "candidate_moments": K9_KERNELS, "reference_moments": K9_KERNELS,
}
# The kernels whose compiler report (registers, shared memory, spills)
# phase 1 prints, and those whose SASS it summarizes (K2's divisions).
PTXAS_KERNELS = ("scale_features_kernel", "opsin_kernel", "bands_kernel", "malta",
                 "candidate_moments_kernel", "moments_tile_kernel", "blur_kernel",
                 "mask_diff_ac_kernel", "trellis_dp_kernel")
# K6 and K7 are instantiated at every radius 1..16; phase 1 reports these:
# sigma 0.5, the path's 2.7 and 7.16.
BLUR_RADII = {1: 0.5, 6: 2.7, 16: 7.16}
SASS_KERNELS = ("opsin_kernel",)

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


def dct_codec(scale: float = 1.0, subsample: bool = False, chroma: np.ndarray = _CHROMA):
    """Encode and decode callbacks of an 8x8 block-DCT quantizer on YCbCr
    (baseline JPEG without the entropy coder): the bytes are a header and
    the zlib-compressed int16 quantized coefficients; the decode returns
    (H, W, 3) u8.  Variants: the tables times ``scale``, chroma at half
    resolution (4:2:0: 2x2 means, replicated back) when ``subsample``, and
    ``chroma`` as the chroma table."""
    import scipy.fft

    def tables(quality: int) -> list:
        return [np.clip(_qtable(b, quality) * scale, 1, 255) for b in (_LUMA, chroma, chroma)]

    def encode(image, request) -> bytes:
        rgb = image.to_rgb8().astype(np.float64)
        h, w = rgb.shape[:2]
        block = 16 if subsample else 8
        if h % block or w % block:
            raise ValueError(f"the block-DCT codec takes sides that are multiples of {block}")
        ycc = rgb @ _RGB_TO_YCC.T
        quality = int(request.quality)
        coefs = []
        for c, table in enumerate(tables(quality)):
            level = ycc[..., c] - (128.0 if c == 0 else 0.0)
            if c and subsample:
                level = level.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
            d = scipy.fft.dctn(_blocks(level), axes=(-2, -1), norm="ortho")
            coefs.append(np.round(d / table).astype(np.int16).tobytes())
        return np.array([h, w, quality], np.int32).tobytes() + zlib.compress(b"".join(coefs))

    def decode(data: bytes) -> np.ndarray:
        h, w, quality = (int(v) for v in np.frombuffer(data[:12], np.int32))
        raw = np.frombuffer(zlib.decompress(data[12:]), np.int16)
        planes, at = [], 0
        for c, table in enumerate(tables(quality)):
            ph, pw = (h // 2, w // 2) if c and subsample else (h, w)
            coefs = raw[at : at + ph * pw].reshape(ph // 8, pw // 8, 8, 8).astype(np.float64)
            at += ph * pw
            level = _unblocks(scipy.fft.idctn(coefs * table, axes=(-2, -1), norm="ortho"))
            if c and subsample:
                level = level.repeat(2, 0).repeat(2, 1)
            planes.append(level + (128.0 if c == 0 else 0.0))
        rgb = np.stack(planes, -1) @ _YCC_TO_RGB.T
        return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)

    return encode, decode


# Phases 3-10's codec, "dct-q".
dct_encode, dct_decode_array = dct_codec()


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
    # Other PyTorch calls of the same function, timed beside it: name -> call.
    others: dict = field(default_factory=dict)


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


def own_device_ms(fn, kernel, calls: int = 10) -> Optional[float]:
    """Device time of the CUDA kernels named ``kernel`` (a name, or a tuple
    of names) per call of ``fn``, from ``torch.profiler``: the kernel alone,
    without the host time between launches that CUDA events over a loop
    also count.  The launchers' counters give the launches of one call (six
    for K1's six scales); the mean over the launches the profiler recorded
    in ``calls`` calls, which after a long profile of many operations may be
    fewer than it should, times that count.  None if it recorded none."""
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS
    from torch.profiler import ProfilerActivity

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    before = sum(w.launches for w in LAUNCHERS.values())
    fn()
    torch.cuda.synchronize()
    per_call = sum(w.launches for w in LAUNCHERS.values()) - before
    for _ in range(2):  # once more if the profiler recorded under half of them
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(n in e.key for n in names)]
        launches = sum(e.count for e in seen)
        if 2 * launches >= calls * per_call:
            break
    if launches != calls * per_call:
        print(f"  (the profiler recorded {launches} of {calls} x {per_call} launches of "
              f"{' or '.join(names)})")
    if not launches:
        return None
    return sum(device_us(e) for e in seen) / 1e3 / launches * per_call


def reset_launches() -> None:
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS

    for fn in LAUNCHERS.values():
        fn.launches = 0


def read_launches() -> dict:
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS

    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def sass_summary(kernel: str) -> None:
    """The SASS of each compiled function whose name contains ``kernel``
    (``cuobjdump -sass`` on the built library): its instruction count, the
    most frequent opcodes, and the neighbourhood of its first IEEE division
    (a reciprocal estimate, a range check FCHK whose failure branches to the
    slow path, and the refinement steps)."""
    from collections import Counter

    from codec_eval_tpu_torch.kernels.cuda import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print(f"  SASS of {kernel}: cuobjdump not found beside nvcc")
        return
    text = subprocess.run([str(tool), "-sass", str(_lib.library_path())], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ops = [m.group(1).strip() for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([^;]+);", body)]
        count = Counter(o.split()[0] for o in ops)
        print(f"  SASS of {name}: {len(ops)} instructions; "
              + ", ".join(f"{k} {v}" for k, v in count.most_common(24)))
        check = next((i for i, o in enumerate(ops) if o.startswith("FCHK")), None)
        if check is not None:
            start = max(i for i in range(check) if ops[i].startswith("MUFU.RCP"))
            print("    the first division, from its reciprocal estimate to 8 instructions "
                  "past its range check (other work interleaved): "
                  + "; ".join(ops[start : check + 9]))


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
    s2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")
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

    # K2: opsin dynamics, bit for bit.
    err, got = held("K2 opsin_xyb", freqsep.opsin_xyb_batch, freqsep.opsin_xyb_plain, k2, EXACT)
    scaled = k2[0][1][0]
    out["opsin_xyb"] = Check(
        err,
        lambda: freqsep.opsin_xyb_batch(scaled, ba._OPSIN_CONSTS),
        lambda: freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS),
        2 * nbytes(scaled) + h * w * 4, K2_OPS * b * h * w, f"{w} px, B={b}",
    )
    del k2

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
                freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS), **EXACT)
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
                    blur.blur_batch_plain(d, sigma), **EXACT)
    torch.cuda.synchronize()


def check_ragged_strips(device: torch.device) -> None:
    """K2, K3, K1 and K8, row-streamed strip kernels, where the last strip
    of columns and the last segment of rows are both ragged (heights of
    several segments and a remainder, widths not a multiple of the strip),
    and K1 and K8 at the smallest pyramid scales.  K2 and K3 bit for bit;
    K1 and K8 within K1_TOL, and each pair's K8 features equal to those of
    the same candidate in K1's batch."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.blur import blur_separable
    from codec_eval_tpu_torch.kernels.cuda import _lib, freqsep, scale_features as sf

    rng = np.random.default_rng(SEED + 1)
    for b, h, w in ((1, 101, 300), (2, 261, 131)):
        seg = freqsep.bands_segment_rows(b, h, w, _lib.sm_count(device))
        if h % seg == 0 or w % _lib.STRIP == 0:
            raise AssertionError(f"K3 {b}x{h}x{w}: segment {seg} leaves nothing ragged")
        scaled = torch.from_numpy(rng.random((b, 3, h, w), np.float32) * 80.0).to(device)
        # K2 through the wrapper (one-row segments at these sizes) and at two
        # segment lengths that leave the last segment ragged.
        want = freqsep.opsin_xyb_plain(scaled, ba._OPSIN_CONSTS)
        seg2 = freqsep.opsin_segment_rows(b, h, w, _lib.sm_count(device))
        compare(f"K2 {b}x{h}x{w} (segments of {seg2} rows)",
                freqsep.opsin_xyb_batch(scaled, ba._OPSIN_CONSTS), want, **EXACT)
        for rows in (8, 64):
            if h % rows == 0:
                raise AssertionError(f"K2 {b}x{h}x{w}: segment {rows} leaves nothing ragged")
            compare(f"K2 {b}x{h}x{w} (segments of {rows} rows)",
                    freqsep._opsin_launch(scaled, ba._OPSIN_CONSTS, rows), want, **EXACT)
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


def check_blur_strips(device: torch.device) -> None:
    """K6 and K7 on their strip walk, bit for bit against their plain
    versions at radii 1, 6 and 16 (``BLUR_RADII``), where the last strip of
    columns and the last segment of rows are both ragged: through the
    wrappers, and K6 at every segment length of ``blur.SEGMENTS``; and K7
    against K6's blur on the card followed by the eager mask term, so that
    its b1, which it never stores, is K6's."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.cuda import _lib, blur, maskac

    rng = np.random.default_rng(SEED + 2)
    mul = ba._MASK_DIFF_AC_MUL
    for radius, sigma in BLUR_RADII.items():
        if len(blur._host_taps(sigma)) != 2 * radius + 1:
            raise AssertionError(f"sigma {sigma} does not give radius {radius}")
        for b, h, w in ((3, 261, 300), (2, 517, 333)):
            if w % _lib.STRIP == 0:
                raise AssertionError(f"{h}x{w}: the last strip is not ragged")
            d = torch.from_numpy(rng.random((b, 1, h, w), np.float32) * 10.0).to(device)
            want = blur.blur_batch_plain(d, sigma)
            seg = blur.segment_rows(b, h, w, _lib.sm_count(device))
            got = blur.blur_batch(d, sigma)
            compare(f"K6 R={radius} {b}x{h}x{w} (segments of {seg} rows)", got, want, **EXACT)
            for rows in blur.SEGMENTS:
                if h % rows == 0:
                    raise AssertionError(f"K6 {h}x{w}: segment {rows} leaves nothing ragged")
                compare(f"K6 R={radius} {b}x{h}x{w} (segments of {rows} rows)",
                        blur._launch(d, sigma, rows), want, **EXACT)
            d1, b0 = d[:, 0], torch.from_numpy(rng.random((h, w), np.float32) * 10.0).to(device)
            k7 = maskac.mask_diff_ac_batch(d1, b0, mul, sigma)
            compare(f"K7 R={radius} {b}x{h}x{w} (segments of {seg} rows)", k7,
                    maskac.mask_diff_ac_plain(d1, b0, mul, sigma), **EXACT)
            diff = b0 - got[:, 0]
            compare(f"K7 R={radius} {b}x{h}x{w} against K6 and the eager mask term", k7,
                    (mul * diff) * diff, **EXACT)
    torch.cuda.synchronize()


def phase_slice(
    ref_u8: np.ndarray, qualities: list, picks: list, report_dir: Path, device, idle: set,
) -> dict:
    """An all-metric EvalSession sweep of ``ref_u8`` at ``qualities`` on
    ``device`` (``None``: the session's default).  Checks the report, the
    monotonicity of the scores, that every kernel but those in ``idle``
    launched and those did not, and the card's scores at ``picks`` against
    the host's; times one ``score_batch`` of the whole ladder.  Returns
    each kernel's launch count during the sweep, the report's scores by
    quality and its bits per pixel by quality."""
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
    bpp = {r.quality: r.bits_per_pixel for r in report.results}
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
    return launches, rows, bpp


def phase_kernels_big(ref_u8: np.ndarray, cands_u8: np.ndarray, device: torch.device):
    """K5 and K6 against their plain versions on the inputs the 2048 px
    sweep gives them: K5 and K6 at full resolution, K6 at half (1024 px).
    Returns the checks for phase 6, K6's half-resolution check, and at both
    resolutions the whole diffmap both ways (K5 with its staging; the
    Malta prologue, K4 and the eager epilogue) for phase 6 to time."""
    import torch.nn.functional as F
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu_torch.kernels.cuda import blur, malta
    from codec_eval_tpu_torch.kernels.cuda.freqsep import _taps, recip_norm

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
        want = blur.blur_batch_plain(d1, sigma)
        # The same function as one zero-padded conv2d with the 2-D
        # outer-product kernel, times the reciprocal plane.
        taps = torch.from_numpy(_taps(sigma)).to(device)
        weight = torch.outer(taps, taps)[None, None].contiguous()
        recip = recip_norm(bh, bw, sigma, device)

        def conv2d():
            return F.conv2d(d1, weight, padding=len(taps) // 2) * recip

        print(f"  conv2d against K6's plain version ({label}): max |difference| "
              f"{float((conv2d() - want).abs().max()):.3e}")
        return Check(
            compare(f"K6 blur {label} {b}x{bh}x{bw}", got, want, **EXACT),
            lambda: blur.blur_batch(d1, sigma),
            lambda: blur.blur_batch_plain(d1, sigma),
            2 * nbytes(d1) + bh * bw * 4, blur_ops(sigma) * d1.numel(), f"{bh} px, B={b}",
            library=lambda: ba._blur(d1, sigma), others={"conv2d": conv2d},
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


def expected_pair_launches(side: int, pairs: int, butteraugli_calls: int = 2) -> dict:
    """Launches of ``pairs`` passes of ``pair_calls`` at ``side`` px: per
    Butteraugli call (two per pair there: 80 and 250 nits; one in the dense
    step), K2 and K3 once per image and resolution, K7 once per resolution
    and K5 or K4 as the size route gives; per SSIMULACRA2 call, K8 once per
    scale; nothing else."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    s2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS

    fused = sum(ba._fused_diffmap_ok(n, n) for n in (side, (side + 1) // 2))
    n_ba = butteraugli_calls * pairs
    want = dict.fromkeys(LAUNCHERS, 0)
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
    """What K7, K8 and K2 take on the single pair's path: K7's (d1, b0) at
    full and half resolution, K8's four planes at every SSIMULACRA2 scale,
    and K2's (label, args) for the candidate at B = 1 at both resolutions."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    s2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear

    ref = torch.from_numpy(ref_u8).to(device)
    dist = torch.from_numpy(dist_u8).to(device)
    lin0, lin1 = ba._planar_linear(ref), ba._planar_linear(dist)[None]
    pre = ba.precompute_butteraugli_reference(lin0)
    it = float(np.float32(pre.params.intensity_target))
    k7, k2 = [], []
    for mask_pre, lin in ((pre.mask_full, lin1), (pre.mask_sub, ba._subsample2x(lin1))):
        scaled = (lin * it).contiguous()
        k2.append((f"B=1 {lin.shape[-2]}x{lin.shape[-1]}", (scaled, ba._OPSIN_CONSTS)))
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
    return k7, k8, k2


def pair_checks(k7: list, k8: list, k2: list, label: str) -> dict:
    """K7 (exactly) and K8 (within K1_TOL) against their plain versions on a
    single pair's inputs; the checks phase 7 times, at full resolution.  K2
    bit for bit on the pair's candidate at B = 1."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.cuda import freqsep, maskac, scale_features

    held(f"K2 opsin_xyb {label}", freqsep.opsin_xyb_batch, freqsep.opsin_xyb_plain, k2, EXACT)

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


def pair_grid_times(k7: list, k8: list, k2: list, label: str) -> None:
    """Each K7, K8 and K2 launch of a single pair: its grid, the wrapper's
    time (CUDA events over 10 calls, host overhead between launches
    included) and the kernel's own device time (profiler)."""
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels.cuda import _lib, blur, freqsep, maskac, scale_features

    def show(name, shape, blocks, fn, kernel):
        own = own_device_ms(fn, kernel)
        own = "not measured" if own is None else f"{own:.4f} ms"
        print(f"    {name} {label} {shape}: grid {blocks} blocks, "
              f"wrapper {time_ms(fn, 10):.4f} ms, kernel alone {own}")

    for d1, b0 in k7:
        b, h, w = d1.shape
        seg = blur.segment_rows(b, h, w, _lib.sm_count(d1.device))
        show("K7", f"{w} px (segments of {seg} rows)", b * -(-w // _lib.STRIP) * -(-h // seg),
             lambda: maskac.mask_diff_ac_batch(d1, b0, ba._MASK_DIFF_AC_MUL, ba.SIGMA_MASK),
             "mask_diff_ac_kernel")
    for a in k8:
        _, h, w = a[3].shape
        show("K8", f"{w} px", 3 * scale_features.grid_blocks(h, w),
             lambda: scale_features.scale_features(*a), "scale_features_kernel")
    for _, args in k2:
        b, _, h, w = args[0].shape
        seg = freqsep.opsin_segment_rows(b, h, w, _lib.sm_count(args[0].device))
        show("K2", f"{w} px (segments of {seg} rows)", b * -(-w // _lib.STRIP) * -(-h // seg),
             lambda: freqsep.opsin_xyb_batch(*args), "opsin_kernel")


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


def k9_check(err: float, x1: torch.Tensor, x2: Optional[torch.Tensor], shapes: str) -> Check:
    """K9 on (x1, x2), or its reference form on x1 where ``x2`` is None,
    for phase 6-style timing: its bound counts two planes read and three
    written per channel-pixel (the reference form one and two); the library
    call is one grouped ``conv2d`` with the 15x15 outer-product kernel on
    zero padding, over the stacked products made beforehand."""
    import torch.nn.functional as F
    from codec_eval_tpu_torch.kernels.blur import gaussian_taps
    from codec_eval_tpu_torch.kernels.cuda import moments

    if x2 is None:
        stacked = torch.cat([x1, x1 * x1], dim=1)
        kernel, plain = (lambda: moments.reference_moments(x1),
                         lambda: moments.reference_moments_plain(x1))
        moved, ops = 3 * nbytes(x1), K9_REF_OPS * x1.numel()
    else:
        stacked = torch.cat([x2, x2 * x2, x1 * x2], dim=1)
        kernel, plain = (lambda: moments.candidate_moments(x1, x2),
                         lambda: moments.candidate_moments_plain(x1, x2))
        moved, ops = 5 * nbytes(x2), K9_OPS * x2.numel()
    taps = torch.from_numpy(gaussian_taps(moments.SIGMA)).to(x1.device)
    groups = stacked.shape[1]
    weight = torch.outer(taps, taps).expand(groups, 1, len(taps), len(taps)).contiguous()
    conv = F.conv2d(stacked, weight, padding=len(taps) // 2, groups=groups)
    print(f"  grouped conv2d against K9's plain version ({shapes}): max |difference| "
          f"{float((conv - torch.cat(plain(), dim=1)).abs().max()):.3e}")
    return Check(
        err, kernel, plain, moved, ops, shapes,
        library=lambda: F.conv2d(stacked, weight, padding=len(taps) // 2, groups=groups),
    )


def k9_form(key: str) -> Optional[str]:
    """Which form of K9 a profiler event is: its kernels are templates on
    the form, 1 (candidate) or 2 (reference)."""
    if not any(k in key for k in K9_KERNELS):
        return None
    return "reference" if "<2>" in key or "ILi2E" in key else "candidate"


def k9_walks(x1: torch.Tensor) -> list:
    """K9's two walks at x1's shape: (name, walk, seg) of the strip walk at
    the segment the wrapper would take and of the tile walk."""
    from codec_eval_tpu_torch.kernels.cuda import _lib, moments

    h, w = x1.shape[-2:]
    planes = x1.numel() // (h * w)
    seg = moments.segment_rows(planes, h, w, _lib.sm_count(x1.device))
    return [("strip", moments.STRIP_WALK, seg), ("tile", moments.TILE_WALK, 0)]


def check_k9(label: str, x1: torch.Tensor, x2: torch.Tensor) -> float:
    """Both forms of K9, through the wrapper and through each walk, against
    their plain versions bit for bit; the worst max |err|."""
    from codec_eval_tpu_torch.kernels.cuda import moments

    err = 0.0
    for form, inputs, wrapper, plain in (
        ("candidate", (x1, x2), moments.candidate_moments, moments.candidate_moments_plain),
        ("reference", (x1,), moments.reference_moments, moments.reference_moments_plain),
    ):
        want = torch.stack(plain(*inputs))
        err = max(err, compare(f"K9 {form} {label}", torch.stack(wrapper(*inputs)), want,
                               **EXACT))
        for route, walk, seg in k9_walks(x1):
            err = max(err, compare(f"K9 {form} {label}, {route} walk",
                                   moments._launch(form, inputs, walk, seg), want, **EXACT))
    return err


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
              "K9 candidate form": 0.0, "K9 reference form": 0.0, "other": 0.0}
    count, rest = 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Activity Buffer"):
            continue
        count += e.count
        key = e.key.lower()
        form = k9_form(e.key)
        group = ("GEMM (dense masked blurs)" if "gemm" in key else
                 "K4 malta_kernel" if "malta_kernel" in key else
                 f"K9 {form} form" if form else "other")
        groups[group] += device_us(e) / 1e3
        if group == "other":
            rest.append(e)
    busy = sum(groups.values())
    print(f"  profiled masked corpus call: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle {100 * (1 - busy / wall):.1f} %, {count} device operations")
    for name, ms in groups.items():
        print(f"    {ms:10.3f} ms  {name}")
    k9_ms = groups["K9 candidate form"] + groups["K9 reference form"]
    print(f"  K9's device time in the masked call: {k9_ms:.3f} ms")
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
    return k9_ms


def phase_mixed(big_u8: np.ndarray, big_batch: np.ndarray) -> tuple:
    """Phase 8: the mixed-size corpus through the masked corpus runner with
    no ``device``; returns K9's rows of the kernels line (its candidate and
    reference forms) and what it adds to K4's row (launches, error and
    times on the masked path's inputs)."""
    from codec_eval_tpu_torch import parallel as par
    from codec_eval_tpu_torch.kernels import butteraugli as ba
    from codec_eval_tpu_torch.kernels import masked as tm
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS, malta

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
    # scoring step each) K9 at six scales in each form (candidate and
    # reference) and K4 at full and half resolution, nothing else.
    kw = dict(masked=True, granularity=GRANULARITY, batch=MASKED_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    masked = par.score_pairs_sharded(pairs, **kw)
    first = time.perf_counter() - t0
    want = dict.fromkeys(LAUNCHERS, 0)
    want.update(candidate_moments=6 * len(buckets), reference_moments=6 * len(buckets),
                malta_ac=2 * len(buckets))
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
    k9_call_ms = profile_masked(pairs, shapes)

    # K9 against its plain versions, bit for bit: both forms, through the
    # wrapper and through each walk, at every scale of the 512, 2048 and
    # 2048x1408 buckets and at two ragged shapes.  Every scale of the first
    # two is timed below.
    err, timed = 0.0, {}
    for bucket in ((512, 512), (BIG, BIG), (BIG, 1408)):
        scales = k9_inputs(pairs, shapes, bucket)
        for label, (x1, x2) in scales:
            err = max(err, check_k9(label, x1, x2))
        if bucket != (BIG, 1408):
            timed[bucket] = scales
        del scales
    rng = np.random.default_rng(SEED)
    for shape in ((2, 3, 37, 53), (1, 3, 67, 653)):
        a, b = (torch.from_numpy(rng.random(shape, np.float32)).cuda() for _ in range(2))
        err = max(err, check_k9("x".join(map(str, shape)), a, b))
    per_scale = time_k9_scales(timed)

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

    top_small, top_big = timed[(512, 512)][0], timed[(BIG, BIG)][0]
    k9_rows = []
    for name in ("candidate_moments", "reference_moments"):
        fn, own = LAUNCHERS[name], OWN_TIME[name]
        pick = (lambda x1, x2: (x1, x2)) if name == "candidate_moments" else (
            lambda x1, x2: (x1, None))
        k9_rows.append({
            "name": name, "route": "cuda", "source": fn.source, "replaces": fn.replaces,
            "launches": launches[name], "max_abs_err": err,
            **time_check(name, k9_check(err, *pick(*top_small[1]), top_small[0]), own),
            "shapes": f"512x512 bucket top scale, {top_small[0]}",
            "launches_per_bucket": launches[name] // len(buckets),
            "at_2048": time_check(f"{name} on the 2048x2048 bucket",
                                  k9_check(err, *pick(*top_big[1]), top_big[0]), own),
            "per_scale": [r for r in per_scale if r["form"] == name],
            "k9_ms_per_masked_call": k9_call_ms,
            "corpus_ms": med * 1e3, "corpus_pairs_per_s": len(pairs) / med,
        })
    k4_extra = {
        "launches_masked": launches["malta_ac"], "max_abs_err_masked": k4_err,
        "at_masked": {"shapes": k4_timed.shapes,
                      **time_check("malta_ac on the masked path", k4_timed,
                                   OWN_TIME["malta_ac"])},
    }
    return k9_rows, k4_extra


def time_k9_scales(timed: dict) -> list:
    """K9 at every scale of the given buckets, in both forms: the wrapper's
    time (CUDA events, mean of 10 calls), the kernel alone (profiler) and
    the bound.  One row per (bucket, scale, form)."""
    from codec_eval_tpu_torch.kernels.cuda import _lib, moments

    rows = []
    print("  K9 per scale: wrapper ms, kernel alone ms, bound ms")
    for bucket, scales in timed.items():
        for label, (x1, x2) in scales:
            h, w = x1.shape[-2:]
            planes = x1.numel() // (h * w)
            if moments.launch_walk(planes, h, w) == moments.TILE_WALK:
                walk = "tile walk"
            else:
                walk = f"strip walk, {moments.segment_rows(planes, h, w, _lib.sm_count(x1.device))}"
                walk += "-row segments"
            for form, fn, moved, ops in (
                ("candidate_moments", functools.partial(moments.candidate_moments, x1, x2),
                 5 * nbytes(x1), K9_OPS * x1.numel()),
                ("reference_moments", functools.partial(moments.reference_moments, x1),
                 3 * nbytes(x1), K9_REF_OPS * x1.numel()),
            ):
                ms, alone = time_ms(fn, 10), own_device_ms(fn, K9_KERNELS)
                bound_ms, bound_by = bound(moved, ops)
                alone_text = "not measured" if alone is None else f"{alone:.4f}"
                print(f"    {form} {bucket[0]}x{bucket[1]} bucket {label} ({walk}): {ms:.4f}, "
                      f"alone {alone_text}, bound {bound_ms:.4f} by {bound_by}")
                rows.append({"form": form, "bucket": f"{bucket[0]}x{bucket[1]}", "scale": label,
                             "walk": walk, "ms": ms, "own_device_ms": alone,
                             "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


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
    for name, fn in c.others.items():
        times[f"{name}_ms"] = time_ms(fn, 10)
        lib += f", {name} {times[f'{name}_ms']:.4f} ms"
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


# ------------------------------------- phase 9: the crate-root surface


def viewing_cases() -> list:
    """(label, image side, SimulationParams) of the three viewing resizes:
    2048 -> 1024 (browser 2 dppx, image 1 dppx), 512 -> 1024 (the reverse)
    and 512 -> 683 (a 2x srcset on a 1.5x laptop, ratio 4/3)."""
    import codec_eval_tpu_torch as ce

    accurate = ce.SimulationMode.ACCURATE
    down = ce.ViewingCondition.desktop().with_browser_dppx(2.0).with_image_intrinsic_dppx(1.0)
    up = ce.ViewingCondition.desktop().with_browser_dppx(1.0).with_image_intrinsic_dppx(2.0)
    odd = ce.presets.srcset_2x_on_laptop_1_5x()
    return [
        (f"{BIG} -> {BIG // 2}", BIG, down.simulation_params(BIG, BIG, accurate)),
        (f"{SIZE} -> {2 * SIZE}", SIZE, up.simulation_params(SIZE, SIZE, accurate)),
        (f"{SIZE} -> {round(SIZE * 4 / 3)}", SIZE, odd.simulation_params(SIZE, SIZE, accurate)),
    ]


def phase_root(ref_u8: np.ndarray, rows_512: dict, bpp_512: dict, launches_512: dict,
               big_u8: np.ndarray, big_batch: np.ndarray, big_rows: dict, launches_big: dict,
               device) -> dict:
    """Phase 9: the crate-root helpers a user calls, with no ``device``.
    ``evaluate_single`` held to the batch scorer's scores of phases 3 and 5
    with the launches of one call at each size read; the CI gates; the viewing
    resize on the card against the host; ``evaluate_single`` with viewing
    simulation against ``score_pair`` of the resized pair; K1-K6 against
    their plain versions at B = 1 at the 2048 px call's shapes, and K1-K4 at
    the 512 px call's; the stats
    layer on phase 3's scores.  Returns the launches of the calls at each
    size, K1-K6's errors at B = 1 and the figures PERF.md records."""
    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch import stats
    from codec_eval_tpu_torch.kernels.resize import resize_u8

    config = ce.MetricConfig.all()
    metrics = ("ssimulacra2", "dssim", "butteraugli", "psnr")
    figures = {}

    def held_to(label, got, want):
        worst = 0.0
        for m in metrics:
            g, w = getattr(got, m), getattr(want, m)
            rel = rel_diff(g, w)
            worst = max(worst, rel)
            if not rel <= PAIR_VS_BATCH_RTOL:
                raise AssertionError(f"{label} {m}: evaluate_single {g!r} vs {w!r}")
        return worst

    # evaluate_single on the card by default, against the batch scores.
    small = dict(zip(PAIR_PICKS, candidates(ref_u8, PAIR_PICKS)))
    big = {q: big_batch[BIG_QUALITIES.index(q)] for q in BIG_PICKS}
    for image, cands, rows in ((ref_u8, small, rows_512), (big_u8, big, big_rows)):
        side = image.shape[0]
        worst = 0.0
        for q, cand in cands.items():
            got = ce.evaluate_single(image, cand, config)
            worst = max(worst, held_to(f"{side}px q{q}", got, rows[q]))
        print(f"  evaluate_single at {side}px, q{list(cands)}: largest relative difference "
              f"to score_batch {worst:.3e}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            ce.evaluate_single(image, cands[50], config)
            times.append(time.perf_counter() - t0)
        figures[f"evaluate_single_ms_{side}"] = statistics.median(times) * 1e3
        print(f"  evaluate_single at {side}px: median {statistics.median(times) * 1e3:.3f} ms "
              f"of 5 per call ({[round(t * 1e3, 3) for t in times]})")
    reset_launches()
    ce.evaluate_single(ref_u8, small[50], config)
    launches_small = read_launches()
    check_launches(f"of one evaluate_single at {SIZE}px (those of one score_batch)",
                   launches_small, launches_512)
    reset_launches()
    ce.evaluate_single(big_u8, big[50], config)
    launches = read_launches()
    check_launches(f"of one evaluate_single at {BIG}px (those of one score_batch)", launches,
                   launches_big)
    idle = PAIR_ONLY | MASKED_ONLY | TRELLIS_ONLY
    if any(launches[k] for k in idle) or not all(launches[k] for k in launches if k not in idle):
        raise AssertionError(f"evaluate_single at {BIG}px: K1-K6 must launch, K7-K10 not")

    # The CI gates on the card.
    q5, q100 = rows_512[5].ssimulacra2, rows_512[100].ssimulacra2
    gate = q5 + 1.0
    if not gate < q100:
        raise AssertionError(f"no gate between q5 ({q5}) and q100 ({q100})")
    try:
        ce.assert_quality(ref_u8, small[5], min_ssimulacra2=gate)
    except ce.QualityBelowThreshold as e:
        print(f"  assert_quality(q5, min_ssimulacra2={gate:.4f}) raised: {e}")
        if e.metric != "SSIMULACRA2" or rel_diff(e.value, q5) > PAIR_VS_BATCH_RTOL:
            raise AssertionError(f"the gate raised for another value: {e}") from None
    else:
        raise AssertionError("assert_quality did not raise below its threshold")
    ce.assert_quality(ref_u8, small[100], min_ssimulacra2=gate)
    ce.assert_perception_level(ref_u8, ref_u8.copy(), ce.PerceptionLevel.IMPERCEPTIBLE)
    print("  assert_quality(q100) and assert_perception_level(ref, ref, IMPERCEPTIBLE) passed")

    # The viewing resize on the card against the host's.
    cases = viewing_cases()
    for label, side, p in cases:
        image = ref_u8 if side == SIZE else big_u8
        card = ce.viewing.simulate_viewing(image, p)
        host = ce.viewing.simulate_viewing(image, p, device="cpu")
        diff = np.abs(card.astype(np.int16) - host.astype(np.int16))
        print(f"  simulate_viewing {label} ({card.shape[1]}x{card.shape[0]}): card against "
              f"host max {int(diff.max())} code value, {int((diff > 0).sum())} of {diff.size} "
              f"samples differ")
        if card.shape != (p.target_height, p.target_width, 3) or diff.max() > 1:
            raise AssertionError(f"simulate_viewing {label}: card and host differ")
    down = cases[0][2]
    on_card = torch.from_numpy(big_u8).to(device)
    ms = time_ms(lambda: resize_u8(on_card, down.target_height, down.target_width), 10)
    figures["resize_ms_2048_to_1024"] = ms
    print(f"  resize_u8 {BIG} -> {BIG // 2} on the card: {ms:.4f} ms (CUDA events, mean of 10, "
          f"u8 in and out, on the card)")

    # evaluate_single with viewing simulation adds nothing but the resize.
    got = ce.evaluate_single(big_u8, big[50], config, viewing_simulation=down)
    resized = [ce.viewing.simulate_viewing(i, down) for i in (big_u8, big[50])]
    want = ce.BatchScorer(config).score_pair(*resized)
    worst = held_to(f"{BIG}px q50 viewed at {BIG // 2}", got, want)
    print(f"  evaluate_single with viewing simulation ({BIG} -> {BIG // 2}), q50: {got}; "
          f"largest relative difference to score_pair of the resized pair {worst:.3e}")

    # K1-K6 against their plain versions at the shapes of the 2048 px call,
    # and K1-K4 at those of the 512 px call (no K5 or K6 there).
    print(f"  K1-K6 against their plain versions at B=1, {BIG} px (evaluate_single's shapes)")
    one = big_batch[BIG_QUALITIES.index(50)][None]
    checks = phase_kernels(big_u8, one, device)
    k56, k6_half, _ = phase_kernels_big(big_u8, one, device)
    errors = {name: c.err for name, c in {**checks, **k56}.items()}
    errors["blur"] = max(errors["blur"], k6_half.err)
    del checks, k56, k6_half
    print(f"  K1-K4 against their plain versions at B=1, {SIZE} px (evaluate_single's shapes)")
    for name, c in phase_kernels(ref_u8, small[50][None], device).items():
        errors[name] = max(errors[name], c.err)

    # The stats layer on the card's scores: phase 3's ladder.
    ladder = [stats.RDPoint("dct-q", q, bpp_512[q], rows_512[q].ssimulacra2) for q in QUALITIES]
    front = stats.ParetoFront.compute(ladder)
    curve = [(p.bpp, p.quality) for p in sorted(ladder, key=lambda p: p.bpp)]
    bd = stats.bd_rate(curve, curve)
    if bd is None or abs(bd) > 1e-9:
        raise AssertionError(f"bd_rate of the ladder against itself is {bd}")
    rd = sorted((bpp_512[q], rows_512[q].ssimulacra2, rows_512[q].butteraugli) for q in QUALITIES)
    bpps, s2s = [c[0] for c in rd], [c[1] for c in rd]
    norm = stats.NormalizationContext(stats.AxisRange(min(bpps), max(bpps)),
                                      stats.AxisRange(min(s2s), max(s2s)),
                                      stats.QualityDirection.HIGHER_IS_BETTER)
    knee = stats.find_knee(rd, norm, lambda c: c[1], stats.WEB_FRAME.s2_angle)
    if knee is None or not (min(bpps) <= knee.bpp <= max(bpps)):
        raise AssertionError(f"no knee on the ladder: {knee}")
    series = [stats.ChartSeries("dct-q", "#e74c3c", [
        stats.ChartPoint(bpp_512[q], rows_512[q].ssimulacra2, f"q{q}") for q in QUALITIES])]
    svg = stats.generate_svg(series, stats.ChartConfig.new("SSIMULACRA2 vs bpp, 512 px")
                             .with_x_label("bpp").with_y_label("SSIMULACRA2"))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ladder.svg"
        path.write_text(svg)
        written = path.read_text()
    if not (written.startswith("<svg") and "polyline" in written and "dct-q" in written):
        raise AssertionError("generate_svg wrote no chart")
    print(f"  stats: Pareto front of {len(front)} of {len(ladder)} points; bd_rate of the "
          f"ladder against itself {bd!r}; knee at {knee.bpp:.4f} bpp, SSIMULACRA2 "
          f"{knee.quality:.4f}, {knee.fixed_angle:.2f} deg in the web frame; SVG of "
          f"{len(written)} characters")
    figures.update(front_points=len(front), knee_bpp=knee.bpp, knee_ssimulacra2=knee.quality)
    return {"launches": launches, "launches_512": launches_small, "errors": errors,
            "figures": figures}


# ------------------------------------------ phase 10: the corpus session

CORPUS_SEEDS = (20240611, 20240612, 20240613, 20240614)  # four CID22-sized images
CORPUS_FAIL = (2, 50)  # the fourth codec raises at q50 on the third image
CORPUS_PICKS = ((0, "dct-q", 50), (1, "dct-420", 5), (3, "dct-coarse", 100))  # rescored on the host


def corpus_codecs(fail_crc: int) -> list:
    """(id, encode, decode) of phase 10's four codecs: phase 3's ``dct-q``,
    a 4:2:0 variant, a coarser table and a variant with the luma table for
    chroma, which raises at ``CORPUS_FAIL``'s quality on the image whose
    crc32 is ``fail_crc``."""
    import codec_eval_tpu_torch as ce

    fine_encode, fine_decode = dct_codec(chroma=_LUMA)

    def flaky_encode(image, request):
        if (request.quality == CORPUS_FAIL[1]
                and zlib.crc32(np.ascontiguousarray(image.to_rgb8()).data) == fail_crc):
            raise OSError("simulated encoder crash")
        return fine_encode(image, request)

    def image_data(decode):
        return lambda data: ce.ImageData.rgb8(decode(data))

    return [
        (codec_id, encode, image_data(decode)) for codec_id, (encode, decode) in (
            ("dct-q", (dct_encode, dct_decode_array)),
            ("dct-420", dct_codec(subsample=True)),
            ("dct-coarse", dct_codec(scale=2.0)),
            ("dct-lumachroma", (flaky_encode, fine_decode)),
        )
    ]


def phase_corpus(launches_512: dict, device: torch.device) -> dict:
    """Phase 10: ``EvalSession.evaluate_corpus`` with no ``device`` over four
    512 px images x four callback codecs x 25 qualities (100 candidates per
    image, one cell failing), ``cache_dir`` set and every metric on.  Checks
    the report, its JSON and CSV, the artifacts, the launches around the
    run (four times phase 3's), each row against a second session's
    ``evaluate_image`` of the same image and three rows against the host;
    holds K1-K4 to their plain versions at B = 100; drives ``CodecRegistry``
    with a ``CodecImpl`` and the report generator on the card's report; and
    times the pipeline against the serial sum and one ``score_batch`` of
    100.  Returns the launches, K1-K4's errors and the figures."""
    import csv

    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch import codecs
    from codec_eval_tpu_torch.engine.report import CSV_COLUMNS

    images = [make_image(SIZE, seed) for seed in CORPUS_SEEDS]
    names = [f"img{i}" for i in range(len(images))]
    fail_name = names[CORPUS_FAIL[0]]
    fail_crc = zlib.crc32(images[CORPUS_FAIL[0]].data)
    codec_list = corpus_codecs(fail_crc)
    metrics = ("ssimulacra2", "dssim", "butteraugli", "psnr")
    per_image = len(codec_list) * len(QUALITIES)
    figures = {}
    spans: dict = {}

    def timed(session, label: str):
        """Record the wall time of each call of the session's host phase
        (``_stage_image``, on the worker thread in ``evaluate_corpus``) and
        device phase (``_score_and_report``) under ``spans[label]``."""
        for key, method in (("stage", "_stage_image"), ("score", "_score_and_report")):
            calls = spans.setdefault(f"{key}_s_{label}", [])

            def wrapper(*args, orig=getattr(session, method), calls=calls, **kwargs):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    calls.append(time.perf_counter() - t0)

            setattr(session, method, wrapper)
        return session

    def session_for(report_dir: Path, cache_dir: Path, capture: Optional[list] = None):
        """A session over the four codecs; with ``capture``, its first
        ``per_image`` decodes (the first image's candidates, in batch order)
        are also kept there."""
        session = ce.EvalSession(
            ce.EvalConfig.builder().report_dir(report_dir).cache_dir(cache_dir)
            .metrics(ce.MetricConfig.all()).quality_levels(QUALITIES).build())
        for codec_id, encode, decode in codec_list:
            if capture is not None:
                def decode(data, dec=decode):
                    out = dec(data)
                    if len(capture) < per_image:
                        capture.append(out.to_rgb8())
                    return out
            session.add_codec_with_decode(codec_id, "1", encode, decode)
        return session

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        session = timed(session_for(tmp / "reports", tmp / "cache"), "corpus")
        if session._scorer.device.type != "cuda" or session.codec_count != len(codec_list):
            raise AssertionError("the corpus session must default to the card")
        items = [(n, ce.ImageData.rgb8(a)) for n, a in zip(names, images)]
        seen = []
        reset_launches()
        t0 = time.perf_counter()
        report = session.evaluate_corpus(items, name="corpus", progress=seen.append)
        corpus_s = time.perf_counter() - t0
        launches = read_launches()
        print(f"  evaluate_corpus: {len(images)} images x {per_image} candidates in "
              f"{corpus_s:.2f} s (host codecs included); progress {seen}")
        check_launches(f"around evaluate_corpus ({len(images)} x phase 3's)", launches,
                       {k: len(images) * v for k, v in launches_512.items()})
        if seen != [f"[{i + 1}/{len(images)}] {n} OK" for i, n in enumerate(names)]:
            raise AssertionError(f"progress messages: {seen}")

        # The report: 4 x 100 rows, one unscored failed cell, the rest finite.
        if [im.name for im in report.images] != names or report.total_results() != (
                len(images) * per_image):
            raise AssertionError("the corpus report does not hold 4 x 100 rows")
        rows = [(im.name, r) for im in report.images for r in im.results]
        failed = [(n, r) for n, r in rows if r.file_size == 0]
        if [(n, r.codec_id, r.quality) for n, r in failed] != [
                (fail_name, "dct-lumachroma", float(CORPUS_FAIL[1]))]:
            raise AssertionError(f"failed cells: {[(n, r.codec_id, r.quality) for n, r in failed]}")
        bad = failed[0][1]
        if (bad.metrics != ce.MetricResult() or bad.perception is not None
                or bad.cached_path is not None or bad.decode_time_ms is not None):
            raise AssertionError(f"the failed cell is not an unscored row: {bad}")
        with_bad = [c for c in session._codecs if c.id == "dct-lumachroma"][0]
        try:
            session._stage_cell(fail_name, items[CORPUS_FAIL[0]][1], with_bad,
                                float(CORPUS_FAIL[1]))
        except ce.CodecError as e:
            error = str(e)
        else:
            raise AssertionError("the failing cell did not raise a CodecError")
        if "encode failed at q50: OSError: simulated encoder crash" not in error:
            raise AssertionError(f"the failing cell's error: {error}")
        scored = [(n, r) for n, r in rows if r.file_size]
        values = np.array([[getattr(r.metrics, m) for m in metrics] for _, r in scored],
                          np.float64)
        if values.shape != (len(rows) - 1, 4) or not np.isfinite(values).all() or any(
                r.perception is None for _, r in scored):
            raise AssertionError("the scored rows are not all finite")
        print(f"  {len(scored)} rows scored and finite; the failed cell ({fail_name}, "
              f"dct-lumachroma, q{CORPUS_FAIL[1]}) unscored: {error}")

        # The written report: JSON back through from_json, the CSV, the artifacts.
        session.write_corpus_report(report)
        written = json.loads((tmp / "reports" / "corpus.json").read_text())
        if ce.CorpusReport.from_json(written) != report:
            raise AssertionError("CorpusReport.from_json of the written JSON differs")
        with open(tmp / "reports" / "corpus.csv", newline="") as f:
            table = list(csv.reader(f))
        if table[0] != CSV_COLUMNS or len(CSV_COLUMNS) != 13 or len(table) != len(rows) + 1 or {
                len(r) for r in table} != {13}:
            raise AssertionError("the CSV is not 13 columns with one row per result")
        if [(t[0], t[1], t[4]) for t in table[1:]] != [
                (n, r.codec_id, str(r.file_size)) for n, r in rows]:
            raise AssertionError("the CSV rows do not follow the report")
        cached = sorted((tmp / "cache").iterdir())
        sizes = {Path(r.cached_path).name: r.file_size for _, r in scored}
        if len(cached) != len(scored) or {p.name: p.stat().st_size for p in cached} != sizes:
            raise AssertionError(f"{len(cached)} artifacts in cache_dir, not one per scored row "
                                 "of its row's size")
        print(f"  JSON round trip equal; CSV of {len(table) - 1} rows x 13 columns; "
              f"{len(cached)} artifacts in cache_dir, each of its row's file_size")

        # Each row against a second session's evaluate_image, image by image:
        # the same route and configuration, serially; the serial sum times
        # the pipeline, and its artifacts equal the corpus run's.
        capture: list = []
        serial = timed(session_for(tmp / "serial", tmp / "serial-cache", capture), "serial")
        serial_s, worst = [], 0.0
        for i, (n, image) in enumerate(items):
            t0 = time.perf_counter()
            one = serial.evaluate_image(n, image, on_error="skip")
            serial_s.append(time.perf_counter() - t0)
            for r, w in zip(report.images[i].results, one.results):
                if (r.codec_id, r.quality, r.file_size) != (w.codec_id, w.quality, w.file_size):
                    raise AssertionError(f"{n}: rows differ: {r} vs {w}")
                for m in metrics:
                    g, want = getattr(r.metrics, m), getattr(w.metrics, m)
                    if g is None and want is None:
                        continue
                    rel = rel_diff(g, want)
                    worst = max(worst, rel)
                    if not rel <= PAIR_VS_BATCH_RTOL:
                        raise AssertionError(f"{n} {r.codec_id} q{r.quality} {m}: corpus {g!r} "
                                             f"vs evaluate_image {want!r}")
        batch_100 = np.stack(capture)
        del capture
        again = sorted((tmp / "serial-cache").iterdir())
        if [p.name for p in again] != [p.name for p in cached] or any(
                a.read_bytes() != b.read_bytes() for a, b in zip(again, cached)):
            raise AssertionError("the serial session's artifacts differ from the corpus run's")
        print(f"  every row equals evaluate_image's of the same image: largest relative "
              f"difference {worst:.3e}")

        # Three rows rescored on the host (the plain versions).
        by_key = {(n, r.codec_id, r.quality): r for n, r in rows}
        for idx, codec_id, q in CORPUS_PICKS:
            encode, decode = next((e, d) for c, e, d in codec_list if c == codec_id)
            image = items[idx][1]
            cand = decode(encode(image, ce.EncodeRequest(quality=float(q)))).to_rgb8()
            host = ce.BatchScorer(ce.MetricConfig.all(), device="cpu").score_pair(
                images[idx], cand)
            card = by_key[(names[idx], codec_id, float(q))].metrics
            for m in metrics:
                g, want = getattr(card, m), getattr(host, m)
                print(f"    {names[idx]} {codec_id} q{q} {m}: card {g!r} host {want!r} "
                      f"rel {rel_diff(g, want):.3e}")
                if abs(g - want) > SCORE_RTOL[m] * abs(want):
                    raise AssertionError(f"{names[idx]} {codec_id} q{q} {m}: card {g!r} vs "
                                         f"host {want!r}")

        # CodecRegistry with a CodecImpl, and the report generator.
        class DctCodec(codecs.CodecImpl):
            def id(self):
                return "dct-q"

            def version(self):
                return "1"

            def format(self):
                return "dctq"

            def encode(self, image, request):
                return dct_encode(image, request)

            def decode(self, data):
                return ce.ImageData.rgb8(dct_decode_array(data))

        registry = codecs.CodecRegistry(
            codecs.CompareConfig.new(tmp / "registry").with_quality_levels(QUALITIES)
            .with_metrics(ce.MetricConfig.all()))
        if not registry.register_codec(DctCodec()) or registry.session._codecs[0].impl is None:
            raise AssertionError("register_codec did not go through add_codec_impl")
        reg = registry.evaluate_image(names[0], items[0][1])
        mine = [r for r in report.images[0].results if r.codec_id == "dct-q"]
        reg_worst = 0.0
        for r, w in zip(reg.results, mine, strict=True):
            if (r.quality, r.file_size) != (w.quality, w.file_size):
                raise AssertionError(f"registry row {r} vs session row {w}")
            for m in metrics:
                rel = rel_diff(getattr(r.metrics, m), getattr(w.metrics, m))
                reg_worst = max(reg_worst, rel)
                if not rel <= PAIR_VS_BATCH_RTOL:
                    raise AssertionError(f"registry q{r.quality} {m}: {r.metrics} vs {w.metrics}")
        out = codecs.ReportGenerator(tmp / "generated").generate(report)
        files = sorted(p.name for p in (tmp / "generated").iterdir())
        if not {"pareto.svg", "stats.json", "pareto.json", "report.html"} <= set(files) or (
                len(out["stats"].codecs) != len(codec_list)):
            raise AssertionError(f"the report generator wrote {files}")
        print(f"  CodecRegistry (CodecImpl, add_codec_impl) on {names[0]}: 25 rows equal the "
              f"session's to {reg_worst:.3e}; ReportGenerator wrote {files} for "
              f"{len(out['stats'].codecs)} codecs, Pareto front of {len(out['pareto'].points)}")

    # K1-K4 against their plain versions at this path's shapes, B = 100.
    print(f"  K1-K4 against their plain versions at B={len(batch_100)}, {SIZE} px "
          "(one image's candidates)")
    checks = phase_kernels(images[0], batch_100, device)
    errors = {name: c.err for name, c in checks.items()}
    if any(errors[k] for k in ("opsin_xyb", "bands", "malta_ac")):
        raise AssertionError(f"K2-K4 not bit for bit at B={len(batch_100)}: {errors}")
    del checks

    # One score_batch of one image's 100 candidates, and the pipeline's figures.
    # The peak is read above what earlier phases still hold on the card.
    scorer = ce.BatchScorer(ce.MetricConfig.all())
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    scorer.score_batch(images[0], batch_100)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score_batch(images[0], batch_100)
        times.append(time.perf_counter() - t0)
    pairs = len(rows) - 1
    figures.update(
        evaluate_corpus_s=corpus_s, pairs=pairs, pairs_per_s=pairs / corpus_s,
        evaluate_image_s=serial_s, serial_sum_s=sum(serial_s),
        corpus_over_serial=corpus_s / sum(serial_s),
        score_batch_100_ms=statistics.median(times) * 1e3,
        score_batch_100_ms_each=[t * 1e3 for t in times],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        peak_above_held_gib=(torch.cuda.max_memory_allocated() - held_before) / 2**30,
        **spans,
    )
    return {"launches": launches, "errors": errors, "figures": figures}


# ----------------------------------------- phase 11: the command-line layer

CLI_SEED = 2026  # iter.source.photo_sources' default: the synthetic-photo-v1 corpus
CLI_RANGE = "10:2:98"  # rd_calibrate's default range: 45 qualities
CLI_SWEEP_QUALITIES = list(range(30, 96, 5))  # codec_analyze full-comparison's defaults: 14
CLI_PICKS = ((0, "dct-q", 30), (1, "dct-420", 60), (1, "dct-q", 95))  # rescored on the host
# Heuristics on the card against the host: continuous features within 1e-5
# relative or 1e-5 of their full range; thresholded shares within one pixel
# or block of the count.
HEURISTIC_RANGE = {
    **dict.fromkeys(["mean_luminance", "luminance_std", "edge_strength_mean",
                     "edge_strength_max", "local_contrast_mean", "local_contrast_std",
                     "horizontal_complexity", "vertical_complexity", "diagonal_complexity"],
                    255.0),
    **dict.fromkeys(["luminance_variance", "block_variance_mean", "block_variance_std",
                     "color_variance"], 255.0 ** 2),
    **dict.fromkeys(["saturation_mean", "saturation_std"], 1.0),
}


def iter_codec(codec_id: str, encode, decode):
    """Phase 10's block-DCT callbacks as a codec-iter ``Codec``: (H, W, 3) u8
    and an integer quality in, bytes out; bytes in, (H, W, 3) u8 out."""
    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch.iter import Codec

    return Codec(
        encode=lambda rgb, q: encode(ce.ImageData.rgb8(rgb), ce.EncodeRequest(quality=float(q))),
        decode=decode, summary=codec_id,
    )


def heuristics_agree(label: str, got: dict, want: dict, shape) -> None:
    """The card's heuristics against the host's at the CPU tests' tolerances."""
    h, w = shape[:2]
    one = {"edge_density": 1.0 / ((h - 2) * (w - 2)),
           "low_freq_energy": 1.0 / (h * (w - 1)), "high_freq_energy": 1.0 / (h * (w - 1))}
    worst = 0.0
    for k, v in want.items():
        g = got[k]
        if k in HEURISTIC_RANGE:
            ok = abs(g - v) <= max(1e-5 * abs(v), 1e-5 * HEURISTIC_RANGE[k])
            worst = max(worst, rel_diff(g, v))
        elif k == "freq_ratio":
            low, high = got["low_freq_energy"], got["high_freq_energy"]
            ok = g == float(np.float32(high) / np.float32(low) if low > 0 else high)
        else:
            ok = abs(g - v) <= 1.0001 * one.get(k, 100.0 / ((h // 8) * (w // 8)))
        if not ok:
            raise AssertionError(f"{label} {k}: card {g!r} vs host {v!r}")
    print(f"  {label}: card equals the host within the tolerances; largest relative "
          f"difference of a continuous feature {worst:.3e}")


def median_ms(fn, runs: int = 5) -> tuple:
    """Host-clock ms of ``fn`` (which ends in a device-to-host copy): the
    median of ``runs`` after one warm-up, and each run."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def phase_cli(launches_512: dict, launches_big: dict, big_u8: np.ndarray, big_batch: np.ndarray,
              big_rows: dict, card: str, device: torch.device) -> dict:
    """Phase 11: the command-line tools' device work with no ``device``
    given, on inputs that need no PIL: ``rd_calibrate``'s ladder scorer over
    four 512 px ``synthetic-photo-v1`` images at its default range (45
    qualities of phase 3's codec) and on phase 5's 2048 px ladder, and the
    calibration ``main`` writes from it; ``analysis.comparison``'s loop
    (``sweep_images``, the loop of ``sweep_codecs``) over two of those
    images x two block-DCT codecs x 14 qualities with a JSONL checkpoint,
    resumed; ``codec_analyze`` and ``codec_eval`` on its CSV; the
    heuristics; ``device_trace``.  Returns the launches, the kernels'
    errors and the figures."""
    import csv
    import importlib.util

    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch import analysis
    from codec_eval_tpu_torch.analysis import comparison, heuristics
    from codec_eval_tpu_torch.cli import codec_analyze, codec_eval, rd_calibrate
    from codec_eval_tpu_torch.iter.source import photo_sources
    from codec_eval_tpu_torch.kernels.cuda import WRAPPERS
    from codec_eval_tpu_torch.stats import WEB_FRAME, CorpusAggregate
    from codec_eval_tpu_torch.stats.rd_plot import plot_rd_svg
    from codec_eval_tpu_torch.utils.profiling import device_trace

    print(f"  PIL importable on this machine: {importlib.util.find_spec('PIL') is not None} "
          "(this phase does not use it)")
    figures: dict = {"card": card}
    errors: dict = {}
    qualities = rd_calibrate.parse_range(CLI_RANGE)
    sources = photo_sources(n=8, size=SIZE, seed=CLI_SEED)
    images = [s.rgb for s in sources[:4]]

    def ladder(rgb: np.ndarray, encode, decode, qs) -> tuple:
        img = ce.ImageData.rgb8(rgb)
        data = [encode(img, ce.EncodeRequest(quality=float(q))) for q in qs]
        return [len(d) for d in data], np.stack([decode(d) for d in data])

    # rd_calibrate at 512 px: sweep_corpus's loop body over the four images.
    ladders = [ladder(rgb, dct_encode, dct_decode_array, qualities) for rgb in images]
    by_quality = {q: [] for q in qualities}
    reset_launches()
    for (sizes, batch), rgb in zip(ladders, images):
        s2s, bas = rd_calibrate.score_ladder(rgb, batch)
        h, w = rgb.shape[:2]
        for q, size, s2, ba in zip(qualities, sizes, s2s, bas):
            if np.isfinite(s2) and np.isfinite(ba):
                by_quality[q].append((size * 8.0 / (w * h), float(s2), float(ba)))
    launches = read_launches()
    check_launches(f"rd_calibrate's ladder, {len(images)} x B={len(qualities)} at {SIZE}px "
                   "(4 x phase 3's)", launches, {k: 4 * v for k, v in launches_512.items()})
    if any(len(v) != len(images) for v in by_quality.values()):
        raise AssertionError("a 512 px ladder score is not finite")
    total = dict(launches)

    # What main does with the scores: the curve, the knees, the SVG, the code.
    curve = rd_calibrate.aggregate_curve(by_quality)
    agg = CorpusAggregate("synthetic-photo-v1", "dct-q", curve, len(images))
    cal = agg.calibrate(WEB_FRAME)
    if len(curve) != len(qualities) or cal is None:
        raise AssertionError(f"knee detection failed on a curve of {len(curve)} points")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        (out / "rd_curve.svg").write_text(plot_rd_svg(curve, WEB_FRAME, cal, title="R-D: dct-q"))
        code = rd_calibrate.emit_calibration_code(cal, "synthetic-photo-v1", "dct-q")
        (out / "calibration.py").write_text(code + "\n")
        svg = (out / "rd_curve.svg").read_text()
        if not svg.startswith("<svg") or "RDCalibration" not in (out / "calibration.py").read_text():
            raise AssertionError("the SVG or calibration.py was not written")
    print(f"  knees: s2 {cal.ssimulacra2.bpp:.4f} bpp @ {cal.ssimulacra2.quality:.2f} "
          f"({cal.ssimulacra2.fixed_angle:.1f} deg), ba {cal.butteraugli.bpp:.4f} bpp @ "
          f"{cal.butteraugli.quality:.3f} ({cal.butteraugli.fixed_angle:.1f} deg); "
          f"rd_curve.svg ({len(svg)} bytes) and calibration.py written")

    # K1-K4 against their plain versions at B = 45.
    print(f"  K1-K4 against their plain versions at B={len(qualities)}, {SIZE} px")
    checks = phase_kernels(images[0], ladders[0][1], device)
    errors.update({name: c.err for name, c in checks.items()})
    if any(errors[k] for k in ("opsin_xyb", "bands", "malta_ac")):
        raise AssertionError(f"K2-K4 not bit for bit at B={len(qualities)}: {errors}")
    del checks

    # One image's ladder timed, with its peak above what the process holds.
    ref, batch = images[0], ladders[0][1]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    figures["ladder_512_ms"], figures["ladder_512_ms_each"] = median_ms(
        lambda: rd_calibrate.score_ladder(ref, batch))
    figures["ladder_512_peak_above_held_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30

    # rd_calibrate at 2048 px on phase 5's ladder: K5 and K6 on phase 5's routes.
    reset_launches()
    s2s, bas = rd_calibrate.score_ladder(big_u8, big_batch)
    launches = read_launches()
    check_launches(f"rd_calibrate's ladder, B={len(big_batch)} at {BIG}px (phase 5's)", launches,
                   launches_big)
    total = {k: total[k] + v for k, v in launches.items()}
    worst = 0.0
    for q, s2, ba in zip(BIG_QUALITIES, s2s, bas):
        for m, g in (("ssimulacra2", s2), ("butteraugli", ba)):
            want = getattr(big_rows[q], m)
            worst = max(worst, rel_diff(float(g), want))
            if not rel_diff(float(g), want) <= PAIR_VS_BATCH_RTOL:
                raise AssertionError(f"2048 px ladder q{q} {m}: {g!r} vs score_batch {want!r}")
    print(f"  the 2048 px ladder equals phase 5's score_batch rows: largest relative "
          f"difference {worst:.3e}")
    k56, _, _ = phase_kernels_big(big_u8, big_batch, device)
    errors.update({name: c.err for name, c in k56.items()})
    del k56
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    figures["ladder_2048_ms"], figures["ladder_2048_ms_each"] = median_ms(
        lambda: rd_calibrate.score_ladder(big_u8, big_batch))
    figures["ladder_2048_peak_above_held_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30

    # The comparison loop with a JSONL checkpoint: two images x two codecs.
    codecs = [iter_codec("dct-q", dct_encode, dct_decode_array),
              iter_codec("dct-420", *dct_codec(subsample=True))]
    named = [(s.name, s.rgb) for s in sources[:2]]
    score_s = []
    score_sweep = comparison.score_sweep

    def timed_score(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return score_sweep(*args, **kwargs)
        finally:
            score_s.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "full_comparison.jsonl"
        seen: list = []
        comparison.score_sweep = timed_score
        try:
            reset_launches()
            t0 = time.perf_counter()
            rows = comparison.sweep_images(named, codecs, CLI_SWEEP_QUALITIES, len(named),
                                           progress=seen.append, checkpoint=ckpt)
            sweep_s = time.perf_counter() - t0
            launches = read_launches()
        finally:
            comparison.score_sweep = score_sweep
        units = len(named) * len(codecs)
        check_launches(f"sweep_images, {units} units x B={len(CLI_SWEEP_QUALITIES)} "
                       f"({units} x phase 3's)", launches,
                       {k: units * v for k, v in launches_512.items()})
        total = {k: total[k] + v for k, v in launches.items()}
        records = [json.loads(line) for line in ckpt.read_text().splitlines()]
        if len(rows) != units * len(CLI_SWEEP_QUALITIES) or len(records) != units:
            raise AssertionError(f"{len(rows)} rows and {len(records)} checkpoint records")
        if not all(np.isfinite([r.ssimulacra2, r.dssim, r.butteraugli]).all() for r in rows):
            raise AssertionError("a comparison score is not finite")
        reset_launches()
        resumed: list = []
        again = comparison.sweep_images(named, codecs, CLI_SWEEP_QUALITIES, len(named),
                                        progress=resumed.append, checkpoint=ckpt)
        if again != rows or any(read_launches().values()) or resumed[0] != (
                f"resumed {units} completed units from {ckpt}"):
            raise AssertionError(f"the checkpoint did not resume every unit: {resumed}")
        figures.update(sweep_s=sweep_s, sweep_score_s=sum(score_s),
                       sweep_score_share=sum(score_s) / sweep_s)
        print(f"  sweep_images: {len(rows)} rows in {sweep_s:.2f} s, the scorer "
              f"{sum(score_s):.2f} s of it; {seen}; the second call resumed all {units} units "
              "and launched nothing")

        # Three rows against the host's scorer.
        by_key = {(r.image, r.codec, r.quality): r for r in rows}
        for idx, codec_id, q in CLI_PICKS:
            codec = next(c for c in codecs if c.summary == codec_id)
            name, rgb = named[idx]
            cand = codec.decode(codec.encode(rgb, q))[None]
            host = comparison.score_sweep(rgb, cand, device="cpu")
            row = by_key[(name, codec_id, q)]
            for m, want in zip(("ssimulacra2", "dssim", "butteraugli"), host):
                g = getattr(row, m)
                print(f"    {name} {codec_id} q{q} {m}: card {g!r} host {float(want[0])!r} "
                      f"rel {rel_diff(g, float(want[0])):.3e}")
                if abs(g - want[0]) > SCORE_RTOL[m] * abs(want[0]):
                    raise AssertionError(f"{name} {codec_id} q{q} {m}: card {g!r} vs host")

        # The host tails of codec_analyze and codec_eval on the rows and the CSV.
        fc = tmp / "full_comparison.csv"
        analysis.write_comparison_csv(rows, fc)
        feats = heuristics.heuristics_batch(np.stack([rgb for _, rgb in named]))
        table = {name: f for (name, _), f in zip(named, feats)}
        outliers = analysis.find_outliers(rows, "dct-420", "dct-q")
        matched = analysis.rd_compare(rows, "dct-420", "dct-q", [1.0, 2.0, 3.0])
        samples = analysis.determine_winners(rows, table, "dct-420", "dct-q")
        scores = analysis.evaluate_rules(samples, analysis.default_rules("dct-420", "dct-q"))
        fitted = analysis.fit_logistic_rule(samples, "dct-420", "dct-q")
        print(f"  find_outliers: mean advantage {outliers.corpus_mean_advantage:+.4f} over "
              f"{len(outliers.images)} images; rd_compare at {sorted(matched.by_target)} bpp; "
              f"{len(samples)} winner samples, best rule {scores[0].name if scores else None}, "
              f"fitted rule {fitted.name if fitted else None}")
        heur = tmp / "heuristics.csv"
        with open(heur, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["image", "width", "height", "pixels"] + heuristics.FEATURE_NAMES)
            for name, rgb in named:
                writer.writerow([name, rgb.shape[1], rgb.shape[0], rgb.shape[0] * rgb.shape[1]]
                                + [f"{table[name][k]:.4f}" for k in heuristics.FEATURE_NAMES])
        for tool, argv in (
            (codec_analyze, ["find-outliers", str(fc)]),
            (codec_analyze, ["rd-compare", str(fc)]),
            (codec_analyze, ["build-predictor", str(fc), str(heur)]),
            (codec_eval, ["pareto", str(fc)]),
            (codec_eval, ["stats", str(fc), "--by-image"]),
        ):
            print(f"  $ {tool.__name__.rsplit('.', 1)[1]} {' '.join(argv[:1])}")
            if tool.main(argv) != 0:
                raise AssertionError(f"{tool.__name__} {argv[0]} did not return 0")

    # The heuristics on the card against the host.
    photos = np.stack([s.rgb for s in sources])
    card_feats = heuristics.heuristics_batch(photos)
    host_feats = heuristics.heuristics_batch(photos, device="cpu")
    for i, (g, w) in enumerate(zip(card_feats, host_feats)):
        heuristics_agree(f"heuristics_batch image {i}", g, w, photos.shape[1:])
    heuristics_agree(f"heuristics_one at {BIG}px", heuristics.heuristics_one(big_u8),
                     heuristics.heuristics_one(big_u8, device="cpu"), big_u8.shape)
    figures["heuristics_batch_8x512_ms"], _ = median_ms(lambda: heuristics.heuristics_batch(photos))
    figures["heuristics_one_2048_ms"], _ = median_ms(lambda: heuristics.heuristics_one(big_u8))

    # device_trace around one call of the scorer.
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            rd_calibrate.score_ladder(ref, batch)
        traces = list(Path(tmp).iterdir())
        if len(traces) != 1 or traces[0].stat().st_size == 0:
            raise AssertionError(f"device_trace wrote {traces}")
        events = json.loads(traces[0].read_text()).get("traceEvents", [])
        on_card = sum(1 for e in events if e.get("cat") == "kernel")
        print(f"  device_trace wrote {traces[0].name}: {len(events)} events, {on_card} of them "
              "kernels on the card")
        figures["trace_kernel_events"] = on_card
    for key in ("ladder_512_ms", "ladder_2048_ms", "ladder_512_peak_above_held_gib",
                "ladder_2048_peak_above_held_gib", "sweep_s", "sweep_score_share",
                "heuristics_batch_8x512_ms", "heuristics_one_2048_ms"):
        print(f"  {key}: {figures[key]!r} | {card}")
    return {"launches": total, "errors": errors, "figures": figures}


# ------------------------------------------ phase 12: the device JPEG ladder

LADDER_PICKS = (5, 50, 100)  # the 512 px ladder's candidates rescored on the host
DEVICE_SIZE_TOL = 0.004  # device size estimates against the exact sizes
TRELLIS_BLOCK_SHARE = 1e-4  # blocks where the card's DP may differ from the native DP
TRELLIS_SIZE_TOL = 0.001


def ladder_candidates(rgb: np.ndarray, qualities, device, **kw) -> tuple:
    """The candidates (n_q, 3, H, W) and int16 coefficients of
    ``evaluate_tpujpeg_sweep``'s ladder with the same settings."""
    from codec_eval_tpu_torch.kernels import jpeg_enc

    cs = kw.get("colorspace", "ycbcr")
    qt = torch.from_numpy(jpeg_enc.qtabs_for(qualities, cs)).to(device)
    return jpeg_enc.reconstruct_sweep(
        torch.from_numpy(rgb).to(device), qt, kw.get("aq_strength", 0.30),
        "444" if cs == "xyb" else kw.get("subsampling", "420"), cs,
        trellis_lambda=kw.get("trellis_lambda", 0.0))


def sizes_agree(label: str, exact: list, device_sizes: list, tol: float) -> float:
    """Device size estimates within ``tol`` of the exact sizes, or 6 bytes
    on a small file (the JAX package's bound)."""
    worst = max(abs(d - e) / e for d, e in zip(device_sizes, exact))
    print(f"  {label}: device size estimates within {worst:.4%} of the exact sizes")
    if any(abs(d - e) > max(6, tol * e) for d, e in zip(device_sizes, exact)):
        raise AssertionError(f"{label}: device sizes {worst:.4%} from the exact sizes")
    return worst


def scores_equal(label: str, got: list, want: list, rtol: float) -> float:
    """Two lists of {metric: score} equal within ``rtol`` relative."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if g.keys() != w.keys():
            raise AssertionError(f"{label}: metrics {sorted(g)} vs {sorted(w)}")
        for k in w:
            worst = max(worst, rel_diff(g[k], w[k]))
            if not rel_diff(g[k], w[k]) <= rtol:
                raise AssertionError(f"{label} {k}: {g[k]!r} vs {w[k]!r}")
    print(f"  {label}: largest relative difference {worst:.3e}")
    return worst


#: K10's f32 operations per block of 64, as the DP needs them: per state
#: (k, j), 2,016 of them (j < k over 63 steps), the zero-run term
#: best[j] + (P[k-1] - P[j]) once for both candidates (2), then per
#: candidate a rate add, a distortion add and a compare (3 each); per
#: coefficient |F| / q, the two candidates, their distortions and x^2 (12).
#: The bound divides them by the FMA-counted peak, which overstates what
#: add-only code can issue by up to two.
K10_OPS_PER_BLOCK = 8 * sum(range(1, 64)) + 12 * 64


def time_k10(ref_u8: np.ndarray, device, card: str) -> dict:
    """K10 (the trellis DP, ``trellis_quantize_dev`` on the card) beside its
    plain version at the shapes of rd-calibrate's 512 px ladder, 45
    qualities: the luma (184,320 blocks) and the stacked chroma (92,160),
    as ``reconstruct_sweep`` passes them.  Each must launch K10 once and
    equal the plain version bit for bit; then the bound, the kernel's time
    through its wrapper (CUDA events), alone (the profiler) and the plain
    version's."""
    from codec_eval_tpu_torch.cli import rd_calibrate
    from codec_eval_tpu_torch.kernels import jpeg_enc

    qualities = [float(q) for q in rd_calibrate.parse_range(CLI_RANGE)]
    planes = jpeg_enc.transform(torch.from_numpy(ref_u8).to(device), "420")
    zz = torch.from_numpy(jpeg_enc.ZIGZAG.astype(np.int64)).to(device)
    q_zz = torch.from_numpy(jpeg_enc.qtabs_for(qualities)).to(device)[:, :, zz][:, :, None, None, :]
    chroma = torch.stack([planes["dct_cb"], planes["dct_cr"]], dim=1)
    figures = {}
    for name, dct, q, table in (
            ("luma", planes["dct_y"], q_zz[:, 0], jpeg_enc.DEFAULT_AC_LENGTHS_LUMA),
            ("chroma", chroma, q_zz[:, 1][:, :, None], jpeg_enc.DEFAULT_AC_LENGTHS_CHROMA)):
        reset_launches()
        got = jpeg_enc.trellis_quantize_dev(dct, q, table, 0.1)
        launches = read_launches()
        check_launches(f"of K10 on the ladder's {name}", launches,
                       {**dict.fromkeys(launches, 0), "trellis_dp": 1})
        want = jpeg_enc.trellis_quantize_plain(dct, q, table, 0.1)
        if not torch.equal(got, want):
            raise AssertionError(f"K10 {name}: {int((got != want).sum())} values differ from "
                                 "the plain version")
        blocks = got.numel() // 64
        bound_ms, by = bound(nbytes(dct, got) + q.shape[0] * 64 * 4, blocks * K10_OPS_PER_BLOCK)
        row = {"blocks": blocks, "bound_ms": bound_ms, "bound_by": by,
               "kernel_ms": time_ms(lambda: jpeg_enc.trellis_quantize_dev(dct, q, table, 0.1), 20),
               "alone_ms": own_device_ms(lambda: jpeg_enc.trellis_quantize_dev(dct, q, table, 0.1),
                                         "trellis_dp_kernel"),
               "plain_ms": time_ms(lambda: jpeg_enc.trellis_quantize_plain(dct, q, table, 0.1), 3)}
        print(f"  K10 {name}, {blocks} blocks: one launch, bit-equal to the plain version; bound "
              f"{bound_ms:.4f} ms ({by}), kernel {row['kernel_ms']:.4f} ms, alone "
              f"{row['alone_ms']!r} ms, plain {row['plain_ms']:.2f} ms | {card}")
        figures[f"k10_{name}"] = row
        del got, want
    return figures


def phase_ladder(ref_u8: np.ndarray, big_u8: np.ndarray, launches_512: dict, launches_big: dict,
                 card: str, device: torch.device) -> dict:
    """Phase 12: the device JPEG ladder with no ``device`` given, and no
    PIL.  Returns the launches of the 512 and 2048 px ladders, the kernels'
    errors at the ladders' shapes, and the figures."""
    import warnings

    import codec_eval_tpu_torch as ce
    from codec_eval_tpu_torch import codecs
    from codec_eval_tpu_torch.cli import rd_calibrate
    from codec_eval_tpu_torch.codecs import TpuJpegCodec, decode_jpeg_device, score_jpeg_files
    from codec_eval_tpu_torch.codecs.jpeg_device import _decode_parsed, parse_jpeg
    from codec_eval_tpu_torch.engine import encode_to_target, evaluate_tpujpeg_sweep
    from codec_eval_tpu_torch.iter.source import photo_sources
    from codec_eval_tpu_torch.kernels import jpeg_enc
    from codec_eval_tpu_torch.parallel import sweep_corpus_ladders
    from codec_eval_tpu_torch.utils import native

    figures: dict = {"card": card}
    errors: dict = {}
    launches: dict = {}

    # The 512 px ladder, exact sizes and bytes.
    reset_launches()
    exact = evaluate_tpujpeg_sweep(ref_u8, QUALITIES, return_bytes=True)
    launches["512"] = read_launches()
    check_launches(f"the {SIZE} px ladder, B={len(QUALITIES)} (phase 3's)", launches["512"],
                   launches_512)
    dev_sized = evaluate_tpujpeg_sweep(ref_u8, QUALITIES, with_sizes="device")
    sizes_agree(f"{SIZE} px ladder", [p.file_size for p in exact],
                [p.file_size for p in dev_sized], DEVICE_SIZE_TOL)
    scores_equal(f"{SIZE} px ladder, device-sized run against the exact run",
                 [p.metrics for p in dev_sized], [p.metrics for p in exact], PAIR_VS_BATCH_RTOL)
    if not all(np.isfinite(v) for p in exact for v in p.metrics.values()):
        raise AssertionError("a 512 px ladder score is not finite")
    cands, _ = ladder_candidates(ref_u8, QUALITIES, device)
    blobs = [p.data for p in exact]
    batch = _decode_parsed([parse_jpeg(d) for d in blobs], device)
    single = [decode_jpeg_device(d) for d in blobs]
    if not torch.equal(batch, cands) or not all(
            np.array_equal(one, c) for one, c in zip(single, cands.permute(0, 2, 3, 1).cpu().numpy())):
        raise AssertionError("the ladder's candidates are not the device decode of its bytes")
    print(f"  the ladder's {len(QUALITIES)} candidates equal decode_jpeg_device of its own bytes "
          "bit for bit (one by one and as a batch)")
    scores_equal("score_jpeg_files on the ladder's bytes against the ladder",
                 score_jpeg_files(ref_u8, blobs), [p.metrics for p in exact], PAIR_VS_BATCH_RTOL)
    host = ce.BatchScorer(ce.MetricConfig.all(), device="cpu").score_batch(
        ref_u8, cands[[QUALITIES.index(q) for q in LADDER_PICKS]].permute(0, 2, 3, 1).cpu().numpy())
    for q, h in zip(LADDER_PICKS, host):
        card_row = exact[QUALITIES.index(q)].metrics
        for m, tol in SCORE_RTOL.items():
            want = getattr(h, m)
            print(f"    q{q} {m}: card {card_row[m]!r} host {want!r} "
                  f"rel {rel_diff(card_row[m], want):.3e}")
            if m != "psnr" or np.isfinite(want):
                if abs(card_row[m] - want) > tol * abs(want):
                    raise AssertionError(f"ladder q{q} {m}: card {card_row[m]!r} vs host {want!r}")
    print(f"  K1-K4 against their plain versions on the {SIZE} px ladder's candidates")
    nhwc = cands.permute(0, 2, 3, 1).cpu().numpy()
    checks = phase_kernels(ref_u8, nhwc, device)
    errors.update({name: c.err for name, c in checks.items()})
    del checks

    # The other presets: XYB, progressive with device sizes, trellis.
    for label, kw in (("tpujpeg-xyb-aq", dict(colorspace="xyb")),
                      ("tpujpeg-420-aq-prog", dict(progressive=True))):
        pts = evaluate_tpujpeg_sweep(ref_u8, QUALITIES, return_bytes=True, **kw)
        est = evaluate_tpujpeg_sweep(ref_u8, QUALITIES, with_sizes="device", **kw)
        sizes_agree(label, [p.file_size for p in pts], [p.file_size for p in est],
                    DEVICE_SIZE_TOL)
        codec = TpuJpegCodec(**kw)
        picked = pts[QUALITIES.index(50)]
        if codec.encode(ce.ImageData.rgb8(ref_u8), ce.EncodeRequest(50.0)) != picked.data:
            raise AssertionError(f"{label}: the ladder's q50 bytes are not the codec's")
    # Each trellis ladder runs K10 once on its luma and once on its chroma.
    trellis = TpuJpegCodec(trellis=True)
    reset_launches()
    t_pts = trellis.device_sweep(ce.ImageData.rgb8(ref_u8), QUALITIES, ("ssimulacra2",),
                                 with_bytes=True)
    launches["trellis_sweep"] = read_launches()
    reset_launches()
    _, t_coefs = ladder_candidates(ref_u8, QUALITIES, device, aq_strength=0.0, trellis_lambda=0.1)
    launches["trellis_ladder"] = read_launches()
    for key in ("trellis_sweep", "trellis_ladder"):
        if launches[key]["trellis_dp"] != 2:
            raise AssertionError(f"{key}: K10 launched {launches[key]['trellis_dp']} times, not 2")
    print(f"  K10 launches: {launches['trellis_sweep']['trellis_dp']} in the trellis preset's "
          f"device sweep, {launches['trellis_ladder']['trellis_dp']} in its ladder")
    planes = jpeg_enc.jpeg_transform(ref_u8, "420")
    qt = jpeg_enc.qtabs_for(QUALITIES)[:, :, jpeg_enc.ZIGZAG]
    differ = total = 0
    worst_size = 0.0
    for qi, q in enumerate(QUALITIES):
        for key, table, ci in (("y", jpeg_enc.DEFAULT_AC_LENGTHS_LUMA, 0),
                               ("cb", jpeg_enc.DEFAULT_AC_LENGTHS_CHROMA, 1),
                               ("cr", jpeg_enc.DEFAULT_AC_LENGTHS_CHROMA, 1)):
            host_blocks = native.trellis_quantize_native(planes[f"dct_{key}"], qt[qi, ci], table, 0.1)
            card_blocks = t_coefs[key][qi].cpu().numpy()
            differ += int((host_blocks != card_blocks).any(axis=-1).sum())
            total += host_blocks.shape[0] * host_blocks.shape[1]
        host_size = len(trellis.encode(ce.ImageData.rgb8(ref_u8), ce.EncodeRequest(q)))
        worst_size = max(worst_size, abs(t_pts[qi].file_size - host_size) / host_size)
    figures["trellis_blocks_differing"] = differ
    figures["trellis_blocks"] = total
    print(f"  tpujpeg-420-trellis: the card's DP differs from trellis_quantize_native in "
          f"{differ} of {total} blocks ({differ / total:.3e}); file sizes within {worst_size:.4%}")
    if differ > TRELLIS_BLOCK_SHARE * total or worst_size > TRELLIS_SIZE_TOL:
        raise AssertionError("the card's trellis DP strays from the native DP")

    # The 2048 px ladder: K5 and K6 on phase 5's routes, held at these shapes.
    reset_launches()
    big = evaluate_tpujpeg_sweep(big_u8, BIG_QUALITIES)
    launches["2048"] = read_launches()
    check_launches(f"the {BIG} px ladder, B={len(BIG_QUALITIES)} (phase 5's)", launches["2048"],
                   launches_big)
    if not all(np.isfinite(v) for p in big for v in p.metrics.values()):
        raise AssertionError("a 2048 px ladder score is not finite")
    big_cands, _ = ladder_candidates(big_u8, BIG_QUALITIES, device)
    print(f"  K5 and K6 against their plain versions on the {BIG} px ladder's candidates")
    k56, _, _ = phase_kernels_big(big_u8, big_cands.permute(0, 2, 3, 1).cpu().numpy(), device)
    errors.update({f"{name}_2048": c.err for name, c in k56.items()})
    del k56, big_cands

    # The corpus ladder: four photo-statistics images at rd_calibrate's range.
    qualities = [float(q) for q in rd_calibrate.parse_range(CLI_RANGE)]
    images = [src.rgb for src in photo_sources(n=4, size=SIZE, seed=CLI_SEED)]
    corpus = {mode: sweep_corpus_ladders(images, qualities, with_sizes=mode)
              for mode in (True, "device")}
    worst = 0.0
    for i, rgb in enumerate(images):
        for mode, res in corpus.items():
            pts = evaluate_tpujpeg_sweep(rgb, qualities, with_sizes=mode)
            if [p.file_size for p in pts] != res.sizes[i].tolist():
                raise AssertionError(f"corpus image {i} ({mode}): sizes differ from its sweep")
            for qi, p in enumerate(pts):
                for k, v in p.metrics.items():
                    worst = max(worst, rel_diff(float(res.scores[k][i, qi]), v))
    sizes_agree("the corpus ladder", corpus[True].sizes.reshape(-1).tolist(),
                corpus["device"].sizes.reshape(-1).tolist(), DEVICE_SIZE_TOL)
    print(f"  the corpus ladder ({len(images)} x {len(qualities)}) equals each image's own sweep: "
          f"largest relative difference {worst:.3e}")
    if worst > PAIR_VS_BATCH_RTOL:
        raise AssertionError("the corpus ladder strays from the per-image sweeps")
    curve = corpus[True].mean_curve("ssimulacra2")
    print(f"  mean_curve: {len(curve)} points, {curve[0][0]:.3f} bpp / {curve[0][1]:.2f} at "
          f"q{qualities[0]:g} to {curve[-1][0]:.3f} bpp / {curve[-1][1]:.2f} at q{qualities[-1]:g}")

    # Encode to a target, decoded and rescored.
    target = encode_to_target(ref_u8, min_ssimulacra2=70.0)
    rescored = score_jpeg_files(ref_u8, [target.data], metrics=("ssimulacra2",))[0]
    print(f"  encode_to_target(min_ssimulacra2=70): q{target.quality:g}, {target.file_size} bytes, "
          f"ssimulacra2 {target.metrics['ssimulacra2']!r}, rescored {rescored['ssimulacra2']!r}")
    if (target.file_size != len(target.data) or target.metrics["ssimulacra2"] < 70.0
            or rel_diff(rescored["ssimulacra2"], target.metrics["ssimulacra2"]) > PAIR_VS_BATCH_RTOL):
        raise AssertionError("encode_to_target's bytes do not score as it says")

    # The sessions: a preset of the zenjpeg slot with cache_dir, the whole
    # slot through the registry, and a JPEG adapter without a device sweep.
    # A fast path's fallback warns: here that is an error.
    with warnings.catch_warnings(), tempfile.TemporaryDirectory() as tmp:
        warnings.simplefilter("error", RuntimeWarning)
        tmp = Path(tmp)
        registry = codecs.CodecRegistry(
            codecs.CompareConfig.new(tmp / "registry").with_formats(
                codecs.FormatSelection(zenjpeg=True)).with_quality_levels(QUALITIES))
        if registry.register_all() != 8:
            raise AssertionError(f"the zenjpeg slot registered {registry.codec_ids()}")
        config = (ce.EvalConfig.builder().report_dir(tmp / "reports").cache_dir(tmp / "cache")
                  .metrics(ce.MetricConfig.all()).quality_levels(QUALITIES).build())
        session = ce.EvalSession(config)
        session.add_codec_impl(registry.codecs[0])
        report = session.evaluate_image("ref", ce.ImageData.rgb8(ref_u8))
        if (session.device_sweeps_run, session.device_sweep_fallbacks,
                session.jpeg_device_decode_fallbacks) != (1, 0, 0):
            raise AssertionError("the session did not take the device sweep")
        for r, p in zip(report.results, exact, strict=True):
            if (r.file_size != p.file_size or Path(r.cached_path).stat().st_size != r.file_size
                    or rel_diff(r.metrics.ssimulacra2, p.metrics["ssimulacra2"])
                    > PAIR_VS_BATCH_RTOL):
                raise AssertionError(f"session row q{r.quality} differs from the ladder")
        reg = registry.evaluate_image("ref", ce.ImageData.rgb8(ref_u8))
        rs = registry.session
        if (rs.device_sweeps_run, rs.device_sweep_fallbacks) != (8, 0) or len(reg.results) != 8 * len(
                QUALITIES):
            raise AssertionError("the registry's zenjpeg slot did not run 8 device sweeps")

        class JpegOnly(codecs.CodecImpl):
            """tpujpeg's streams through an adapter without a device sweep."""

            def __init__(self):
                self.inner = TpuJpegCodec()

            def id(self):
                return "jpeg-bytes"

            def version(self):
                return "1"

            def format(self):
                return "jpg"

            def encode(self, image, request):
                return self.inner.encode(image, request)

            def decode(self, data):
                return self.inner.decode(data)

        second = ce.EvalSession(ce.EvalConfig.builder().report_dir(tmp / "r2")
                                .metrics(ce.MetricConfig.all()).quality_levels(QUALITIES).build())
        second.add_codec_impl(JpegOnly())
        rows = second.evaluate_image("ref", ce.ImageData.rgb8(ref_u8))
        if (second.jpeg_device_decodes_run, second.jpeg_device_decode_fallbacks,
                second.device_sweeps_run, second.device_sweep_fallbacks) != (1, 0, 0, 0):
            raise AssertionError("the JPEG adapter did not take the device decode")
        scores_equal("the device-decode session against the ladder",
                     [{k: getattr(r.metrics, k) for k in p.metrics} for r in rows.results],
                     [p.metrics for p in exact], PAIR_VS_BATCH_RTOL)
        print(f"  sessions: device_sweeps_run 1 (cache_dir: {len(list((tmp / 'cache').iterdir()))}"
              f" artifacts), the registry's zenjpeg slot 8, jpeg_device_decodes_run 1; "
              "every fallback counter 0")

    # Timings, each the median of 5 after a warm-up.
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    figures["ladder_512_exact_ms"], figures["ladder_512_exact_ms_each"] = median_ms(
        lambda: evaluate_tpujpeg_sweep(ref_u8, QUALITIES))
    figures["ladder_512_peak_above_held_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    figures["ladder_512_device_ms"], _ = median_ms(
        lambda: evaluate_tpujpeg_sweep(ref_u8, QUALITIES, with_sizes="device"))
    figures["ladder_512_scores_only_ms"], _ = median_ms(
        lambda: evaluate_tpujpeg_sweep(ref_u8, QUALITIES, with_sizes=False))
    _, coefs = ladder_candidates(ref_u8, QUALITIES, device)
    host = [coefs[k].cpu().numpy() for k in ("y", "cb", "cr")]
    qt = jpeg_enc.qtabs_for(QUALITIES).astype(np.uint16)[:, :, jpeg_enc.ZIGZAG]

    def entropy_pass():
        return [native.jpeg_encode_baseline(SIZE, SIZE, "420", host[0][i], host[1][i], host[2][i],
                                            qt[i, 0], qt[i, 1]) for i in range(len(QUALITIES))]

    figures["entropy_pass_512_ms"], _ = median_ms(entropy_pass)
    figures["entropy_share_of_exact_ladder"] = (figures["entropy_pass_512_ms"]
                                                / figures["ladder_512_exact_ms"])

    def reconstruct(lam):
        def run():
            c, _ = ladder_candidates(ref_u8, QUALITIES, device, aq_strength=0.0,
                                     trellis_lambda=lam)
            return c.sum().item()
        return run

    figures["reconstruct_512_ms"], _ = median_ms(reconstruct(0.0))
    figures["reconstruct_512_trellis_ms"], _ = median_ms(reconstruct(0.1))
    figures.update(time_k10(ref_u8, device, card))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    figures["ladder_2048_exact_ms"], _ = median_ms(lambda: evaluate_tpujpeg_sweep(big_u8,
                                                                                 BIG_QUALITIES))
    figures["ladder_2048_peak_above_held_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    figures["ladder_2048_device_ms"], _ = median_ms(
        lambda: evaluate_tpujpeg_sweep(big_u8, BIG_QUALITIES, with_sizes="device"))
    for mode, key in ((True, "exact"), ("device", "device")):
        ms, _ = median_ms(lambda m=mode: sweep_corpus_ladders(images, qualities, with_sizes=m))
        figures[f"corpus_ladder_ms_per_image_{key}"] = ms / len(images)
    for key in ("ladder_512_exact_ms", "ladder_512_device_ms", "ladder_512_scores_only_ms",
                "entropy_pass_512_ms", "entropy_share_of_exact_ladder", "reconstruct_512_ms",
                "reconstruct_512_trellis_ms", "ladder_2048_exact_ms", "ladder_2048_device_ms",
                "corpus_ladder_ms_per_image_exact", "corpus_ladder_ms_per_image_device",
                "ladder_512_peak_above_held_gib", "ladder_2048_peak_above_held_gib"):
        print(f"  {key}: {figures[key]!r} | {card}")
    return {"launches": launches, "errors": errors, "figures": figures,
            "corpus_device": corpus["device"]}


# --------------------------------------------- phase 13: the multi-device layer

MH_PROCESSES = 2
MH_PAIRS = 16  # phase 3's image against its first 16 candidates, 8 per process
MH_TIMEOUT_S = 300  # a worker that fails, hangs or cannot join fails the phase
MH_RTOL = 1e-6  # the global steps and ladder against the single-process results
SPATIAL_RTOL = {"ssimulacra2": 1e-5, "dssim": 1e-5, "psnr": 1e-5, "butteraugli": 1e-4}
SPATIAL_PICKS = {SIZE: [5, 50, 90], BIG: [50, 95]}
SPATIAL_BANDS = 2


def mh_inputs(ref_u8: np.ndarray, big_u8: np.ndarray, big_batch: np.ndarray) -> dict:
    """The arrays the workers take: the dense step's pairs, phase 8's
    512 x 512 bucket (its four 512 px crops at q50 and q90) and phase 12's
    four corpus-ladder images."""
    from codec_eval_tpu_torch.iter.source import photo_sources

    pairs, _ = mixed_corpus(big_u8, big_batch)
    bucket = [(r, d) for r, d in pairs if r.shape[:2] == (SIZE, SIZE)]
    return {
        "refs": np.repeat(ref_u8[None], MH_PAIRS, axis=0),
        "dists": candidates(ref_u8, QUALITIES[:MH_PAIRS]),
        "masked_refs": np.stack([r for r, _ in bucket]),
        "masked_dists": np.stack([d for _, d in bucket]),
        "masked_hw": np.array([r.shape[:2] for r, _ in bucket], np.int32),
        "photos": np.stack([src.rgb for src in photo_sources(n=4, size=SIZE, seed=CLI_SEED)]),
    }


def mh_dense(mesh, data: dict) -> dict:
    """The dense step over the whole batch (each process scores its share)."""
    from codec_eval_tpu_torch import parallel as par

    per_pair, means = par.sharded_score_fn(mesh)(par.shard_batch(mesh, data["refs"]),
                                                 par.shard_batch(mesh, data["dists"]))
    return {f"dense_{k}": v.cpu().numpy() for k, v in {**per_pair, **means}.items()}


def mh_masked(mesh, data: dict) -> dict:
    """The masked step over phase 8's 512 x 512 bucket."""
    from codec_eval_tpu_torch import parallel as par

    per_pair, means = par.sharded_masked_score_fn(mesh)(
        par.shard_batch(mesh, data["masked_refs"]), par.shard_batch(mesh, data["masked_dists"]),
        par.shard_batch(mesh, data["masked_hw"]))
    return {f"masked_{k}": v.cpu().numpy() for k, v in {**per_pair, **means}.items()}


def mh_ladder(mesh, data: dict) -> dict:
    """``sweep_corpus_ladders(multihost=True)`` with device sizes over phase
    12's corpus at rd_calibrate's range."""
    from codec_eval_tpu_torch import parallel as par
    from codec_eval_tpu_torch.cli import rd_calibrate

    qualities = [float(q) for q in rd_calibrate.parse_range(CLI_RANGE)]
    lad = par.sweep_corpus_ladders(list(data["photos"]), qualities, mesh=mesh,
                                   with_sizes="device", multihost=True)
    return {**{f"ladder_{k}": v for k, v in lad.scores.items()}, "ladder_sizes": lad.sizes}


MH_PARTS = {"dense": mh_dense, "masked": mh_masked, "ladder": mh_ladder}


def mh_worker(pid: int, procs: int, port: int, tmp: Path) -> int:
    """One process of phase 13(a): joins the gloo group, takes
    ``global_batch_mesh()``'s default device (cuda:0 for both), runs each
    part once to warm up and once with the launch counters set to 0 just
    before it and read just after, and writes its results, launches, ms and
    peak device memory."""
    import torch.distributed as dist
    from codec_eval_tpu_torch.kernels.cuda import _lib
    from codec_eval_tpu_torch.parallel import multihost as mh

    data = dict(np.load(tmp / "inputs.npz"))
    mh.initialize_distributed(f"127.0.0.1:{port}", procs, pid)
    mesh = mh.global_batch_mesh()
    _lib.load()
    print(f"  worker {pid}: process {mesh.process_index} of {mesh.process_count} on "
          f"{mesh.devices.tolist()}")
    out, figures, launches = {}, {}, {}
    for name, part in MH_PARTS.items():
        part(mesh, data)  # warm-up
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out.update(part(mesh, data))
        torch.cuda.synchronize()
        figures[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        launches[name] = read_launches()
        figures[f"{name}_peak_above_held_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
    np.savez(tmp / f"out{pid}.npz", **out)
    digest = hashlib.sha256(b"".join(
        k.encode() + np.ascontiguousarray(out[k]).tobytes() for k in sorted(out))).hexdigest()
    (tmp / f"out{pid}.json").write_text(json.dumps(
        {"launches": launches, "figures": figures, "digest": digest}))
    print(f"  worker {pid}: digest {digest}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_workers(tmp: Path) -> list:
    """Phase 13(a)'s processes: this script in worker mode, twice, on a free
    127.0.0.1 port, each waited for at most MH_TIMEOUT_S; any that fails or
    hangs fails the phase, and none outlives it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    if Path("/sys/class/net/lo").exists():
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the group lives on this host
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--multihost-worker", str(pid),
         str(MH_PROCESSES), str(port), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(MH_PROCESSES)]
    deadline = time.monotonic() + MH_TIMEOUT_S
    outs = []
    try:
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"worker {pid} did not finish in {MH_TIMEOUT_S} s")
            print(out, end="")
            if p.returncode:
                raise AssertionError(f"worker {pid} exited {p.returncode}:\n{err[-4000:]}")
            outs.append(json.loads((tmp / f"out{pid}.json").read_text()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def spatial_k8(ref_u8: np.ndarray, dist_u8: np.ndarray, device) -> tuple:
    """Windowed K8 against its windowed plain version on each band of one
    pair, at every scale (K1_TOL), and the full window against no window
    (bit for bit); returns the worst error and the first band's check."""
    from codec_eval_tpu_torch.kernels.color import srgb_u8_to_linear
    from codec_eval_tpu_torch.kernels.cuda import scale_features as sf
    from codec_eval_tpu_torch.parallel import spatial
    s2 = importlib.import_module("codec_eval_tpu_torch.kernels.ssimulacra2")

    worst, first = 0.0, None
    side = ref_u8.shape[0]
    for j, band in enumerate(spatial.row_bands(side, SPATIAL_BANDS)):
        ref = torch.from_numpy(np.ascontiguousarray(ref_u8[band.start:band.stop])).to(device)
        dist = torch.from_numpy(np.ascontiguousarray(dist_u8[band.start:band.stop])).to(device)
        pre = s2.precompute_reference(ref)
        linear = torch.movedim(srgb_u8_to_linear(dist), -1, 0).contiguous()
        calls = []
        for scale in range(s2.NUM_SCALES):
            if scale:
                linear = s2.downscale_by_2(linear)
            xyb2 = s2._to_positive_xyb(linear).contiguous()
            args = (pre.xyb[scale], pre.mu[scale], pre.sqblur[scale], xyb2)
            rows = band.window(scale)
            h, w = xyb2.shape[-2:]
            worst = max(worst, compare(
                f"K8 windowed, band {j} ({band.stop - band.start} x {w} rows {band.lo}..{band.hi}) "
                f"scale {scale} rows {rows[0]}..{rows[1]} of {h}",
                sf.scale_features(*args, rows=rows), sf.scale_features_plain(*args, rows=rows),
                **K1_TOL))
            compare(f"K8 full window = no window, {h}x{w}", sf.scale_features(*args, rows=(0, h)),
                    sf.scale_features(*args), **EXACT)
            calls.append((args, rows))
        if first is None:
            moved = sum(nbytes(*a) + 4 * 18 for a, _ in calls)
            ops = sum(K1_OPS * 3 * (r[1] - r[0]) * a[3].shape[-1] for a, r in calls)
            first = Check(
                0.0,
                lambda c=calls: [sf.scale_features(*a, rows=r) for a, r in c],
                lambda c=calls: [sf.scale_features_plain(*a, rows=r) for a, r in c],
                moved, ops,
                f"{band.stop - band.start} x {side} band owning rows {band.lo}..{band.hi}, "
                "six scales")
    torch.cuda.synchronize()
    first.err = worst
    return worst, first


def phase_multi(ref_u8: np.ndarray, big_u8: np.ndarray, big_batch: np.ndarray,
                launches_512: dict, ladder_device, card: str, device: torch.device) -> dict:
    """Phase 13: (a) two processes on the one card in a gloo group, each on
    cuda:0 through ``global_batch_mesh()``: the dense global step, the
    masked global step and the multi-process corpus ladder, held to the
    single-process results; (b) the spatial step in this process, two row
    bands on [cuda:0, cuda:0], held to the unsharded step at 512 and
    2048 px, with windowed K8 held to its plain version on the bands."""
    from codec_eval_tpu_torch import parallel as par
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS

    figures: dict = {"card": card}
    launches: dict = {}
    errors: dict = {}

    # (a) two processes on cuda:0.
    t0 = time.perf_counter()
    data = mh_inputs(ref_u8, big_u8, big_batch)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        np.savez(tmp / "inputs.npz", **data)
        outs = run_workers(tmp)
        results = [dict(np.load(tmp / f"out{pid}.npz")) for pid in range(MH_PROCESSES)]
    figures["multihost_wall_s"] = time.perf_counter() - t0
    digests = [o["digest"] for o in outs]
    if len(set(digests)) != 1 or any(
            not np.array_equal(results[0][k], r[k]) for r in results[1:] for k in results[0]):
        raise AssertionError(f"the workers' results differ: {digests}")
    print(f"  both workers' digests: {digests[0]}")
    per_process = MH_PAIRS // MH_PROCESSES
    masked_per_process = len(data["masked_refs"]) // MH_PROCESSES
    images_per_process = len(data["photos"]) // MH_PROCESSES
    want = {
        "dense": expected_pair_launches(SIZE, per_process, butteraugli_calls=1),
        "masked": {**dict.fromkeys(LAUNCHERS, 0), "candidate_moments": 6,
                   "reference_moments": 6, "malta_ac": 2},
        "ladder": {k: images_per_process * v for k, v in launches_512.items()},
    }
    for pid, o in enumerate(outs):
        for part in MH_PARTS:
            check_launches(f"of worker {pid}'s {part} part", o["launches"][part], want[part])
        print(f"  worker {pid} figures: {json.dumps(o['figures'])} | {card}")
        figures[f"worker{pid}"] = o["figures"]
    launches.update({f"multihost_{part}": outs[0]["launches"][part] for part in MH_PARTS})
    print(f"  launches: dense {per_process} pairs, masked {masked_per_process} pairs, "
          f"ladder {images_per_process} images per worker")

    mesh = par.make_mesh()
    for part, step in (("dense", mh_dense), ("masked", mh_masked)):
        worst = 0.0
        for k, v in step(mesh, data).items():
            got = results[0][k]
            if got.shape != v.shape:
                raise AssertionError(f"{k}: shape {got.shape} != {v.shape}")
            worst = max(worst, max(rel_diff(float(a), float(b))
                                   for a, b in zip(got.reshape(-1), v.reshape(-1))))
        print(f"  the global {part} step vs the single-process step: largest relative "
              f"difference {worst:.3e}")
        if worst > MH_RTOL:
            raise AssertionError(f"the global {part} step strays from the single-process step")
        errors[f"multihost_{part}_rel"] = worst
    if not np.array_equal(results[0]["ladder_sizes"], ladder_device.sizes):
        raise AssertionError("the multi-process ladder's device sizes differ from phase 12's")
    lad_worst = max(
        rel_diff(float(a), float(b))
        for k, v in ladder_device.scores.items()
        for a, b in zip(results[0][f"ladder_{k}"].reshape(-1), v.reshape(-1)))
    print(f"  multi-process ladder: sizes equal phase 12's corpus ladder; scores within "
          f"{lad_worst:.3e} relative")
    if lad_worst > MH_RTOL:
        raise AssertionError("the multi-process ladder's scores stray from phase 12's")
    errors["multihost_ladder_rel"] = lad_worst

    # (b) spatial in one process: two row bands on one card.
    t0 = time.perf_counter()
    mesh_s = par.make_mesh(n_batch=1, n_space=SPATIAL_BANDS, devices=[device] * SPATIAL_BANDS)
    mesh_1 = par.make_mesh(devices=[device])
    step_s = par.sharded_score_fn(mesh_s, spatial=True)
    step_1 = par.sharded_score_fn(mesh_1)
    k8_checks = {}
    for side, image, picks in ((SIZE, ref_u8, SPATIAL_PICKS[SIZE]),
                               (BIG, big_u8, SPATIAL_PICKS[BIG])):
        dists = (candidates(image, picks) if side == SIZE
                 else big_batch[[BIG_QUALITIES.index(q) for q in picks]])
        refs = np.repeat(image[None], len(picks), axis=0)

        def spatial_run(r=refs, d=dists):
            return step_s(par.shard_batch(mesh_s, r, spatial=True),
                          par.shard_batch(mesh_s, d, spatial=True))

        def whole_run(r=refs, d=dists):
            return step_1(par.shard_batch(mesh_1, r), par.shard_batch(mesh_1, d))

        reset_launches()
        got, _ = spatial_run()
        ls = read_launches()
        reset_launches()
        ref_scores, _ = whole_run()
        l1 = read_launches()
        launches[f"spatial_{side}"] = ls
        check_launches(f"of the spatial step at {side} px ({SPATIAL_BANDS} bands of "
                       f"{len(picks)} pairs)", ls, {k: SPATIAL_BANDS * v for k, v in l1.items()})
        if side == BIG:  # K5 at full resolution (the image's route, not the band's), K4 at half
            check_launches(f"of K5 and K4 in the unsharded {BIG} px step",
                           {k: l1[k] for k in ("malta_diffmap", "malta_ac")},
                           {"malta_diffmap": len(picks), "malta_ac": len(picks)})
        for k, v in ref_scores.items():
            for q, a, b in zip(picks, got[k].tolist(), v.tolist()):
                err = rel_diff(a, b)
                errors[f"spatial_{side}_{k}"] = max(errors.get(f"spatial_{side}_{k}", 0.0), err)
                if err > SPATIAL_RTOL[k]:
                    raise AssertionError(f"spatial {side} px q{q} {k}: {a!r} vs unsharded {b!r}")
        print(f"  spatial {side} px vs unsharded, largest relative difference: " + ", ".join(
            f"{k} {errors[f'spatial_{side}_{k}']:.3e}" for k in ref_scores))
        err, check = spatial_k8(image, dists[0], device)
        errors[f"k8_windowed_{side}"] = err
        k8_checks[side] = check
        if side == BIG:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            for name, fn in (("spatial", spatial_run), ("unsharded", whole_run),
                             ("unsharded", whole_run), ("spatial", spatial_run)):
                torch.cuda.reset_peak_memory_stats()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                figures.setdefault(f"{name}_{BIG}_ms_each", []).append(
                    (time.perf_counter() - t1) * 1e3)
                figures[f"{name}_{BIG}_peak_above_held_gib"] = max(
                    figures.get(f"{name}_{BIG}_peak_above_held_gib", 0.0),
                    (torch.cuda.max_memory_allocated() - held) / 2**30)
            for name in ("spatial", "unsharded"):
                figures[f"{name}_{BIG}_ms"] = statistics.mean(figures[f"{name}_{BIG}_ms_each"])
            figures["spatial_peak_ratio"] = (figures[f"spatial_{BIG}_peak_above_held_gib"]
                                            / figures[f"unsharded_{BIG}_peak_above_held_gib"])
    k8_times = {side: time_check(f"K8 windowed at the {side} px band", c, OWN_TIME.get(
        "scale_features_pair")) for side, c in k8_checks.items()}
    figures["spatial_wall_s"] = time.perf_counter() - t0
    for key in (f"spatial_{BIG}_ms", f"unsharded_{BIG}_ms", f"spatial_{BIG}_peak_above_held_gib",
                f"unsharded_{BIG}_peak_above_held_gib", "spatial_peak_ratio",
                "multihost_wall_s", "spatial_wall_s"):
        print(f"  {key}: {figures[key]!r} | {card}")
    return {"launches": launches, "errors": errors, "figures": figures, "k8": k8_times}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from codec_eval_tpu_torch.kernels.cuda import LAUNCHERS, WRAPPERS, _lib

    args = sys.argv[1:]
    if args[:1] == ["--multihost-worker"]:  # one process of phase 13(a)
        return mh_worker(int(args[1]), int(args[2]), int(args[3]), Path(args[4]))
    profiling = "--profile" in args
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
        shown = True
        for line in _lib.ptxas_report(kernel):
            entry = re.search(r"entry function '\w*?\d((?:malta_\w*?|bands_|scale_features_|"
                              r"opsin_|candidate_moments_|moments_tile_|blur_|mask_diff_ac_|trellis_dp_)"
                              r"kernel)(?:ILi(\d+)E)?", line)
            if entry:
                arg = f"<{entry.group(2)}>" if entry.group(2) else ""
                shown = kernel not in ("blur_kernel", "mask_diff_ac_kernel") or (
                    int(entry.group(2)) in BLUR_RADII)
                if shown:
                    print(f"  ptxas -v, {entry.group(1)}{arg}:")
            elif shown and "Compile time" not in line and "Function properties" not in line:
                print(f"    {line}")
    for kernel in SASS_KERNELS:
        sass_summary(kernel)

    def done(phase, t0: float) -> None:
        print(f"  phase {phase}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    ref_u8 = make_image(SIZE, SEED)
    print(f"[2] kernels vs plain on the card ({len(QUALITIES)} x 3 x {SIZE} x {SIZE})")
    checks = phase_kernels(ref_u8, candidates(ref_u8, QUALITIES), device)
    check_odd_shapes(device)
    check_ragged_strips(device)
    check_blur_strips(device)
    done(2, t0)

    t0 = time.perf_counter()
    print(f"[3] EvalSession sweep on {device}: {len(QUALITIES)} qualities at {SIZE}px")
    with tempfile.TemporaryDirectory() as tmp:
        launches, rows_512, bpp_512 = phase_slice(
            ref_u8, QUALITIES, [5, 50, 100], Path(tmp), device,
            idle={"malta_diffmap", "blur", *PAIR_ONLY, *MASKED_ONLY, *TRELLIS_ONLY})
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
        launches_big, big_rows, _ = phase_slice(big_u8, BIG_QUALITIES, BIG_PICKS, Path(tmp),
                                                None, idle=PAIR_ONLY | MASKED_ONLY | TRELLIS_ONLY)
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
    time_check("blur (half resolution)", k6_half, OWN_TIME["blur"])
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

    # What only --profile uses is let go before phase 8's peak-memory reading.
    if not profiling:
        k78, k78_big = k78[:2] + ([],), k78_big[:2] + ([],)

    t0 = time.perf_counter()
    print(f"[8] the mixed-size corpus, masked, no device given | {card}")
    k9_rows, k4_extra = phase_mixed(big_u8, big_batch)
    k4_row = next(r for r in rows if r["name"] == "malta_ac")
    k4_row["max_abs_err"] = max(k4_row["max_abs_err"], k4_extra["max_abs_err_masked"])
    k4_row.update(k4_extra)
    rows.extend(k9_rows)
    done(8, t0)

    t0 = time.perf_counter()
    print(f"[9] the crate-root surface, no device given | {card}")
    root = phase_root(ref_u8, rows_512, bpp_512, launches, big_u8, big_batch, big_rows,
                      launches_big, device)
    for row in rows:
        name = row["name"]
        row["launches_evaluate_single_512"] = root["launches_512"][name]
        row["launches_evaluate_single_2048"] = root["launches"][name]
        if name in root["errors"]:
            row["max_abs_err_evaluate_single"] = root["errors"][name]
            row["max_abs_err"] = max(row["max_abs_err"], root["errors"][name])
    root["figures"]["wall_s"] = time.perf_counter() - t0
    print(f"  phase 9 figures: {json.dumps(root['figures'])}")
    done(9, t0)

    t0 = time.perf_counter()
    print(f"[10] the corpus session, no device given: {len(CORPUS_SEEDS)} images x 4 codecs x "
          f"{len(QUALITIES)} qualities at {SIZE}px | {card}")
    corpus = phase_corpus(launches, device)
    for row in rows:
        name = row["name"]
        row["launches_corpus"] = corpus["launches"][name]
        row["max_abs_err_corpus"] = corpus["errors"].get(name)
        if name in corpus["errors"]:
            row["max_abs_err"] = max(row["max_abs_err"], corpus["errors"][name])
    corpus["figures"]["wall_s"] = time.perf_counter() - t0
    print(f"  corpus figures: {json.dumps(corpus['figures'])}")
    done(10, t0)

    t0 = time.perf_counter()
    print(f"[11] the command-line layer, no device given | {card}")
    cli = phase_cli(launches, launches_big, big_u8, big_batch, big_rows, card, device)
    for row in rows:
        name = row["name"]
        row["launches_cli"] = cli["launches"][name]
        row["max_abs_err_cli"] = cli["errors"].get(name)
        if name in cli["errors"]:
            row["max_abs_err"] = max(row["max_abs_err"], cli["errors"][name])
    cli["figures"]["wall_s"] = time.perf_counter() - t0
    print(f"  cli figures: {json.dumps(cli['figures'])}")
    print(f"  phase 11 wall: {cli['figures']['wall_s']:.2f} s | {card}")
    done(11, t0)

    t0 = time.perf_counter()
    print(f"[12] the device JPEG ladder, no device given | {card}")
    ladder = phase_ladder(ref_u8, big_u8, launches, launches_big, card, device)
    # K10 runs on the trellis ladders alone: its row holds their launches,
    # its bit-equality with the plain DP and its timings at rd-calibrate's
    # luma shape (chroma under "at_chroma"), and 0 launches on every other
    # path.
    k10 = LAUNCHERS["trellis_dp"]
    luma, chroma = ladder["figures"]["k10_luma"], ladder["figures"]["k10_chroma"]

    def k10_times(t: dict) -> dict:
        return {"ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "own_device_ms": t["alone_ms"]}

    rows.append({
        "name": "trellis_dp", "route": "cuda", "source": k10.source, "replaces": k10.replaces,
        "launches": ladder["launches"]["trellis_ladder"]["trellis_dp"], "max_abs_err": 0.0,
        **k10_times(luma), "shapes": f"{luma['blocks']} blocks (45-quality 512 px luma)",
        "at_chroma": {**k10_times(chroma), "shapes": f"{chroma['blocks']} blocks"},
        "launches_trellis_sweep": ladder["launches"]["trellis_sweep"]["trellis_dp"],
        "launches_512": launches["trellis_dp"], "launches_2048": launches_big["trellis_dp"],
        "launches_evaluate_single_512": root["launches_512"]["trellis_dp"],
        "launches_evaluate_single_2048": root["launches"]["trellis_dp"],
        "launches_corpus": corpus["launches"]["trellis_dp"],
        "launches_cli": cli["launches"]["trellis_dp"],
    })
    for row in rows:
        name = row["name"]
        row["launches_ladder_512"] = ladder["launches"]["512"][name]
        row["launches_ladder_2048"] = ladder["launches"]["2048"][name]
        errs = [v for k, v in ladder["errors"].items() if k in (name, f"{name}_2048")]
        row["max_abs_err_ladder"] = max(errs) if errs else None
        if errs:
            row["max_abs_err"] = max(row["max_abs_err"], *errs)
    ladder["figures"]["wall_s"] = time.perf_counter() - t0
    print(f"  ladder figures: {json.dumps(ladder['figures'])}")
    done(12, t0)

    t0 = time.perf_counter()
    print(f"[13] the multi-device layer: {MH_PROCESSES} processes on one card in a gloo group, "
          f"and {SPATIAL_BANDS} row bands of each pair | {card}")
    multi = phase_multi(ref_u8, big_u8, big_batch, launches, ladder.pop("corpus_device"), card,
                        device)
    for row in rows:
        for key, counts in multi["launches"].items():
            row[f"launches_{key}"] = counts[row["name"]]
    k8 = next(r for r in rows if r["name"] == "scale_features_pair")
    k8["max_abs_err_windowed"] = max(multi["errors"][f"k8_windowed_{s}"] for s in (SIZE, BIG))
    k8["max_abs_err"] = max(k8["max_abs_err"], k8["max_abs_err_windowed"])
    k8["windowed_band_512"], k8["windowed_band_2048"] = multi["k8"][SIZE], multi["k8"][BIG]
    multi["figures"]["wall_s"] = time.perf_counter() - t0
    print(f"  multi-device figures: {json.dumps(multi['figures'])}")
    done(13, t0)

    if profiling:
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
