"""The benchmark's inputs, made from the seed: photo-like source images and
their JPEG candidates.

``photo_image`` is a frozen copy of ``synthetic-photo-v1``, the port's
photo-statistics generator (``codec_eval_tpu_torch/iter/source.py``
``photo_sources``, commit 80b80d3), widened to rectangles: at a square
size it gives the port's image bit for bit.  The candidates are PIL's
libjpeg at 4:2:0, encoded and decoded here, the stand-in for mozjpeg."""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np


def photo_image(seed: int, index: int, height: int, width: int) -> np.ndarray:
    """Image ``index`` of the corpus of ``seed``: an (H, W, 3) u8 photo-like
    image (1/f^alpha luma with soft occlusion edges, smoother chroma fields,
    luma-dependent film grain)."""
    rng = np.random.default_rng(seed * 1000 + index)
    alpha = rng.uniform(1.7, 2.3)
    h, w = height, width

    def field(a):
        fy = np.fft.fftfreq(h)[:, None]
        fx = np.fft.rfftfreq(w)[None, :]
        f = np.hypot(fy, fx)
        amp = np.where(f > 0, 1.0 / np.power(np.maximum(f, 1e-6), a / 2.0), 0.0)
        phase = rng.uniform(0, 2 * np.pi, amp.shape)
        x = np.fft.irfft2(amp * np.exp(1j * phase), s=(h, w))
        sd = x.std()
        return x / (sd if sd > 0 else 1.0)

    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    luma = field(alpha) * rng.uniform(35.0, 70.0) + rng.uniform(90.0, 165.0)
    for _ in range(int(rng.integers(2, 5))):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        ang = rng.uniform(0, np.pi)
        d = (x - cx) * np.cos(ang) + (y - cy) * np.sin(ang)
        z = np.clip(d / rng.uniform(0.6, 2.5), -60.0, 60.0)
        luma = luma + rng.uniform(-45.0, 45.0) / (1.0 + np.exp(-z))

    sat = rng.uniform(0.06, 0.35)
    cb = field(alpha + 0.6) * 28.0 * sat * rng.uniform(0.5, 1.5)
    cr = field(alpha + 0.6) * 28.0 * sat * rng.uniform(0.5, 1.5)

    g0, g1 = rng.uniform(0.4, 1.4), rng.uniform(0.04, 0.18)
    sigma = g0 + g1 * np.sqrt(np.clip(luma, 0.0, 255.0))
    lum_n = luma + rng.normal(0.0, 1.0, (h, w)) * sigma

    r = lum_n + 1.402 * cr + rng.normal(0, 0.3, (h, w)) * sigma
    g = lum_n - 0.344136 * cb - 0.714136 * cr
    b = lum_n + 1.772 * cb + rng.normal(0, 0.3, (h, w)) * sigma
    return np.clip(np.stack([r, g, b], -1), 0.0, 255.0).astype(np.uint8)


def ladder(spec: Sequence[int]) -> List[int]:
    """[start, stop, step] inclusive of stop: [10, 98, 2] -> 10, 12, ..., 98."""
    start, stop, step = spec
    return list(range(start, stop + 1, step))


def jpeg_candidate(image: np.ndarray, quality: int, subsampling: str) -> Tuple[bytes, np.ndarray]:
    """PIL's libjpeg at ``quality`` and chroma ``subsampling`` ("4:2:0"):
    the stream and its decoded (H, W, 3) u8 pixels."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=int(quality), subsampling=subsampling)
    data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        decoded = np.ascontiguousarray(np.asarray(im.convert("RGB")))
    return data, decoded


def workers() -> int:
    """Threads for making inputs: the host's cores, at most 8."""
    return max(1, min(8, os.cpu_count() or 1))


def make_images(seed: int, shapes: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """Image i of ``seed`` at ``shapes[i]``, made in parallel."""
    with ThreadPoolExecutor(workers()) as pool:
        return list(pool.map(lambda a: photo_image(seed, a[0], *a[1]), enumerate(shapes)))


def make_candidates(
    images: Sequence[np.ndarray], jobs: Sequence[Tuple[int, int]], subsampling: str
) -> dict:
    """{(image index, quality): (stream, decoded)} for each job, in parallel
    (libjpeg releases the interpreter lock)."""
    with ThreadPoolExecutor(workers()) as pool:
        done = pool.map(lambda j: jpeg_candidate(images[j[0]], j[1], subsampling), jobs)
        return dict(zip(jobs, done))
