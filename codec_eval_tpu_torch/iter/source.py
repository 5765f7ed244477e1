"""Source image loading with representative tiers and a PPM fast cache.

Port of ``codec_eval_tpu/iter/source.py`` (reference:
crates/codec-iter/src/source.rs:19-201), the same code: cluster-representative
CID22-512 filename tiers selected by ``--limit``, PNG decode through PIL, a
``.codec-iter-cache/`` PPM cache so repeat runs skip PNG decoding (PPM IO
through ``utils/native.py``'s Python reader and writer), and the two
procedural corpora ``synthetic-v1`` and ``synthetic-photo-v1``, which need
neither files nor PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from ..errors import ImageLoadError
from ..utils import native
from .eval import SourceImage

#: Representative tiers (glassa-clustered CID22-512 picks).
#: reference: crates/codec-iter/src/source.rs:19-45
TINY = ["pexels-photo-951408.png", "53435.png", "1963557.png"]

SMALL = TINY + ["160577.png", "2866385.png"]

MEDIUM = [
    "pexels-photo-951408.png",
    "pexels-photo-3193731.png",
    "pexels-photo-7438498.png",
    "53435.png",
    "pexels-photo-1130297.png",
    "1963557.png",
    "Temperament-pie-chart-according-to-Eysenck.png",
    "160577.png",
    "1277396.png",
    "2866385.png",
    "1583339.png",
    "144200.png",
    "pexels-photo-2908983.png",
    "1183021.png",
    "162511.png",
]

CACHE_DIR_NAME = ".codec-iter-cache"


def _cache_path(corpus: Path, name: str) -> Path:
    return corpus / CACHE_DIR_NAME / (Path(name).stem + ".ppm")


def load_image(corpus: Path, name: str) -> SourceImage:
    """Load via PPM cache, else decode and cache.
    reference: crates/codec-iter/src/source.rs:62-92."""
    cache = _cache_path(corpus, name)
    if cache.exists():
        try:
            return SourceImage(name=name, rgb=native.read_ppm(cache))
        except IOError:
            pass
    path = corpus / name
    if not path.exists():
        raise ImageLoadError(f"source image not found: {path}")
    from PIL import Image

    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    cache.parent.mkdir(parents=True, exist_ok=True)
    try:
        native.write_ppm(cache, rgb)
    except IOError:
        pass
    return SourceImage(name=name, rgb=np.ascontiguousarray(rgb))


#: Version tag of the procedural corpus below.  Committed baselines under
#: ``baselines/`` record this tag in ``corpus_path``; bump it whenever the
#: generator changes so stale baselines fail loudly instead of drifting.
SYNTHETIC_CORPUS_VERSION = "synthetic-v1"


def synthetic_sources(n: int = 3, size: int = 256) -> List[SourceImage]:
    """Deterministic photo-like test images, generated in memory.

    The reference ships committed quality/size baselines computed on a real
    corpus (baselines/*.json, crates/codec-iter/src/baseline.rs:11-43); this
    environment cannot commit corpus images, so the committed baselines here
    are computed on this procedural corpus instead.  Determinism contract:
    ``default_rng`` streams are stable across numpy versions (NEP 19), so
    the same (n, size, version) always regenerates bit-identical pixels.
    """
    out: List[SourceImage] = []
    for i in range(n):
        rng = np.random.default_rng(9000 + i)
        y, x = np.mgrid[0:size, 0:size]
        base = (
            115.0
            + 70.0 * np.sin(x / (11.0 + 3.0 * i))
            + 55.0 * np.cos(y / (8.0 + 2.0 * i))
            + 25.0 * np.sin((x + y) / (29.0 + 5.0 * i))
        )
        img = np.stack(
            [base, base * 0.87 + 14.0, base * 0.72 + 28.0], axis=-1
        )
        img += rng.normal(0.0, 6.5, img.shape)
        rgb = np.clip(img, 0.0, 255.0).astype(np.uint8)
        out.append(
            SourceImage(name=f"{SYNTHETIC_CORPUS_VERSION}-{i:03d}", rgb=rgb)
        )
    return out


#: Version tag of the photo-statistics corpus below (bump on generator
#: change, as with SYNTHETIC_CORPUS_VERSION).
PHOTO_CORPUS_VERSION = "synthetic-photo-v1"


def photo_sources(
    n: int = 8, size: int = 512, seed: int = 2026
) -> List[SourceImage]:
    """Photo-statistics synthetic corpus: the closest in-environment stand-in
    for CID22/CLIC photographs (no real corpus ships here; the reference's
    comparable BD-rate numbers are CID22-photograph numbers,
    crates/codec-iter/src/avif_config.rs:3-7).

    Each image follows measured natural-image statistics rather than the
    trig-pattern recipe of ``synthetic_sources``:

    - luma is a 1/f^alpha random-phase field (alpha ~ U[1.7, 2.3], the
      natural-image power-law band) plus 2-4 soft occlusion edges;
    - chroma rides two independent, smoother (alpha + 0.6) low-bandwidth
      fields with per-image saturation drawn from U[0.06, 0.35] — mixed
      muted/vivid palettes;
    - film grain: luma-dependent Gaussian noise (sigma = g0 + g1*sqrt(Y)),
      mostly common-mode across channels like real sensor noise.

    Deterministic: FFTs and ``default_rng`` streams are stable across numpy
    versions, so (n, size, seed, version) regenerates identical pixels.
    """
    out: List[SourceImage] = []
    for i in range(n):
        rng = np.random.default_rng(seed * 1000 + i)
        alpha = rng.uniform(1.7, 2.3)

        def field(a, r=rng, s=size):
            fy = np.fft.fftfreq(s)[:, None]
            fx = np.fft.rfftfreq(s)[None, :]
            f = np.hypot(fy, fx)
            amp = np.where(f > 0, 1.0 / np.power(np.maximum(f, 1e-6), a / 2.0), 0.0)
            phase = r.uniform(0, 2 * np.pi, amp.shape)
            spec = amp * np.exp(1j * phase)
            x = np.fft.irfft2(spec, s=(s, s))
            sd = x.std()
            return x / (sd if sd > 0 else 1.0)

        y, x = np.mgrid[0:size, 0:size].astype(np.float64)
        luma = field(alpha) * rng.uniform(35.0, 70.0) + rng.uniform(90.0, 165.0)
        # Soft occlusion edges (objects against background produce step
        # edges that pure 1/f fields lack).
        for _ in range(int(rng.integers(2, 5))):
            cx, cy = rng.uniform(0, size), rng.uniform(0, size)
            ang = rng.uniform(0, np.pi)
            d = (x - cx) * np.cos(ang) + (y - cy) * np.sin(ang)
            z = np.clip(d / rng.uniform(0.6, 2.5), -60.0, 60.0)
            luma = luma + rng.uniform(-45.0, 45.0) / (1.0 + np.exp(-z))

        sat = rng.uniform(0.06, 0.35)
        cb = field(alpha + 0.6) * 28.0 * sat * rng.uniform(0.5, 1.5)
        cr = field(alpha + 0.6) * 28.0 * sat * rng.uniform(0.5, 1.5)

        # Film grain: luma-dependent, mostly common-mode.
        g0, g1 = rng.uniform(0.4, 1.4), rng.uniform(0.04, 0.18)
        sigma = g0 + g1 * np.sqrt(np.clip(luma, 0.0, 255.0))
        common = rng.normal(0.0, 1.0, (size, size)) * sigma
        lum_n = luma + common

        r = lum_n + 1.402 * cr + rng.normal(0, 0.3, (size, size)) * sigma
        g = lum_n - 0.344136 * cb - 0.714136 * cr
        b = lum_n + 1.772 * cb + rng.normal(0, 0.3, (size, size)) * sigma
        rgb = np.clip(np.stack([r, g, b], -1), 0.0, 255.0).astype(np.uint8)
        out.append(
            SourceImage(name=f"{PHOTO_CORPUS_VERSION}-{i:03d}", rgb=rgb)
        )
    return out


def load_sources(corpus: Path, limit: int) -> List[SourceImage]:
    """Tier selection by limit (<=3 TINY, <=5 SMALL, <=15 MEDIUM, else all).
    reference: crates/codec-iter/src/source.rs:47-60.

    The virtual corpus names ``synthetic-v1`` and ``synthetic-photo-v1``
    resolve to the in-memory procedural generators (no files needed) —
    handy where no image corpus ships (this environment).
    """
    name = str(corpus)
    if name == SYNTHETIC_CORPUS_VERSION:
        return synthetic_sources(n=limit or 3)
    if name == PHOTO_CORPUS_VERSION:
        return photo_sources(n=limit or 8)
    corpus = Path(corpus)
    if not corpus.is_dir():
        raise ImageLoadError(f"corpus directory not found: {corpus}")
    if limit <= 3:
        names = TINY[: max(limit, 0)]
    elif limit <= 5:
        names = SMALL[:limit]
    elif limit <= 15:
        names = MEDIUM[:limit]
    else:
        names = []

    if names:
        available = [n for n in names if (corpus / n).exists()]
        if available:
            return [load_image(corpus, n) for n in available]
        # Tier files absent from this corpus: fall back to directory order.

    out: List[SourceImage] = []
    for path in sorted(corpus.iterdir()):
        if path.suffix.lower() in (".png", ".jpg", ".jpeg", ".webp", ".ppm"):
            if path.parent.name == CACHE_DIR_NAME:
                continue
            out.append(load_image(corpus, path.name))
            if limit and len(out) >= limit:
                break
    if not out:
        raise ImageLoadError(f"no usable images in {corpus}")
    return out
