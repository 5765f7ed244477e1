"""Fast encoder-iteration eval loop (the codec-iter core).

Port of ``codec_eval_tpu/iter/eval.py`` (reference:
crates/codec-iter/src/eval.rs:12-192): a minimal ``Codec`` (encode/decode
callbacks and a summary), an ``EvalPoint`` row per (image, quality), and a
run that scores every quality of an image in one ``ssimulacra2_batch`` call
on the device (K1 at every scale on the card), sharing the image's
reference precompute across its ladder.  Host encode/decode of the next
image overlaps the device's scoring of the current one (a one-slot pipeline).
``run_eval_device`` runs tpujpeg's whole ladder on the device instead
(``engine.tpu_sweep``).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ssimulacra2 import ssimulacra2_batch


@dataclass
class Codec:
    """Encode/decode callbacks and a human-readable config summary.
    reference: crates/codec-iter/src/eval.rs:12-19."""

    encode: Callable[[np.ndarray, int], bytes]
    decode: Callable[[bytes], np.ndarray]
    summary: str


@dataclass
class EvalPoint:
    """One (image, quality) measurement, in the baseline JSON schema.
    reference: crates/codec-iter/src/eval.rs:21-29."""

    image: str
    quality: int
    bpp: float
    ssim2: float
    size_bytes: int
    encode_ms: int

    def to_json(self) -> dict:
        return {
            "image": self.image,
            "quality": self.quality,
            "bpp": self.bpp,
            "ssim2": self.ssim2,
            "size_bytes": self.size_bytes,
            "encode_ms": self.encode_ms,
        }

    @classmethod
    def from_json(cls, d: dict) -> "EvalPoint":
        return cls(
            image=d["image"],
            quality=int(d["quality"]),
            bpp=d["bpp"],
            ssim2=d["ssim2"],
            size_bytes=d["size_bytes"],
            encode_ms=int(d["encode_ms"]),
        )


@dataclass
class EvalResult:
    config_summary: str
    points: List[EvalPoint]
    total_ms: int


@dataclass
class SourceImage:
    name: str
    rgb: np.ndarray  # (H, W, 3) u8


def _encode_image(codec: Codec, src: SourceImage, qualities: Sequence[int]) -> List[dict]:
    """Host phase: encode and decode every quality of one image (timed)."""
    entries = []
    for q in qualities:
        t0 = time.perf_counter()
        data = codec.encode(src.rgb, int(q))
        encode_ms = int((time.perf_counter() - t0) * 1000)
        entries.append(
            {"quality": int(q), "size": len(data), "encode_ms": encode_ms,
             "decoded": codec.decode(data)}
        )
    return entries


def run_eval(
    images: Sequence[SourceImage],
    codec: Codec,
    qualities: Sequence[int],
    progress: Optional[Callable[[str], None]] = None,
    *,
    device="cuda",
) -> EvalResult:
    """Sweep codec x qualities over images, each image's ladder scored in
    one batch on ``device`` (the card by default; ``"cpu"`` runs the plain
    versions).  reference: crates/codec-iter/src/eval.rs:94-192."""
    dev = resolve_device(device)
    if not images:
        return EvalResult(config_summary=codec.summary, points=[], total_ms=0)

    t_start = time.perf_counter()
    points: List[EvalPoint] = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(_encode_image, codec, images[0], qualities)
        for i, src in enumerate(images):
            entries = future.result()
            if i + 1 < len(images):
                future = pool.submit(_encode_image, codec, images[i + 1], qualities)

            h, w = src.rgb.shape[:2]
            batch = torch.from_numpy(np.stack([e["decoded"] for e in entries])).to(dev)
            ref = torch.from_numpy(np.require(src.rgb, requirements="CW")).to(dev)
            scores = ssimulacra2_batch(ref, batch).cpu().numpy()
            for e, s in zip(entries, scores):
                points.append(
                    EvalPoint(
                        image=src.name,
                        quality=e["quality"],
                        bpp=e["size"] * 8.0 / (w * h),
                        ssim2=float(s),
                        size_bytes=e["size"],
                        encode_ms=e["encode_ms"],
                    )
                )
            if progress:
                progress(f"[{i + 1}/{len(images)}] {src.name}")

    total_ms = int((time.perf_counter() - t_start) * 1000)
    return EvalResult(config_summary=codec.summary, points=points, total_ms=total_ms)


def run_eval_device(
    images: Sequence[SourceImage],
    qualities: Sequence[int],
    subsampling: str = "420",
    adaptive: bool = True,
    progress: Optional[Callable[[str], None]] = None,
    trellis: bool = False,
    size_mode: str = "exact",
    *,
    device="cuda",
) -> EvalResult:
    """tpujpeg's ladder on ``device`` per image (``engine.tpu_sweep``): the
    encode transform, the decode reconstruction and SSIMULACRA2 there.
    size_mode="exact" entropy-codes the fetched coefficients on the host;
    "device" takes the sizes from device rate statistics
    (``kernels.jpeg_rate``), fetching only packed symbol counts.  The
    reference's loop round-trips every candidate through host RAM
    (crates/codec-iter/src/eval.rs:151); this has no analog there."""
    from ..engine.tpu_sweep import evaluate_tpujpeg_sweep

    if size_mode not in ("exact", "device"):
        raise ValueError(f"size_mode must be 'exact' or 'device', got {size_mode!r}")
    aq = 0.0 if trellis else (0.30 if adaptive else 0.0)
    mode = "trellis" if trellis else ("aq" if adaptive else "plain")
    summary = f"tpujpeg-{subsampling}-{mode}-device"
    t_start = time.perf_counter()
    points: List[EvalPoint] = []
    for i, src in enumerate(images):
        t0 = time.perf_counter()
        pts = evaluate_tpujpeg_sweep(
            src.rgb,
            [float(q) for q in qualities],
            subsampling=subsampling,
            aq_strength=aq,
            metrics=("ssimulacra2",),
            trellis_lambda=0.10 if trellis else 0.0,
            with_sizes="device" if size_mode == "device" else True,
            device=device,
        )
        ladder_ms = int((time.perf_counter() - t0) * 1000)
        for p in pts:
            points.append(
                EvalPoint(
                    image=src.name,
                    quality=int(p.quality),
                    bpp=p.bits_per_pixel,
                    ssim2=p.metrics["ssimulacra2"],
                    size_bytes=p.file_size,
                    encode_ms=ladder_ms // max(len(pts), 1),
                )
            )
        if progress:
            progress(f"[{i + 1}/{len(images)}] {src.name}")
    total_ms = int((time.perf_counter() - t_start) * 1000)
    return EvalResult(config_summary=summary, points=points, total_ms=total_ms)
