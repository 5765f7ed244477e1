"""rd-calibrate: R-D knee calibration pipeline.

Port of ``codec_eval_tpu/cli/rd_calibrate.py`` (reference:
crates/codec-compare/src/rd_calibrate.rs:53-379): sweep one codec over a
fine quality grid across a corpus, aggregate the per-quality corpus-mean
curve, detect the SSIMULACRA2/Butteraugli knees, plot the dark-theme R-D
SVG, and print ready-to-paste calibration code.

Each image's whole quality sweep is scored in one batch
(``score_ladder``: SSIMULACRA2 and Butteraugli against a reference
precomputed once) on the card unless ``--device cpu`` asks for the host,
and per-quality corpus means reduce on the host from the per-image score
vectors.  ``--device-sweep`` runs tpujpeg's whole calibration sweep
(encode, decode and score) on the device through
``parallel.sweep_corpus_ladders`` (``sweep_images_device``, which takes
decoded images).

    python -m codec_eval_tpu_torch.cli.rd_calibrate CORPUS --range 10:2:98
    python -m codec_eval_tpu_torch.cli.rd_calibrate CORPUS --format tpujpeg --device-sweep
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Sequence, Tuple

import numpy as np

from ..corpus import Corpus
from ..engine.scoring import score_ladder as _score_ladder
from ..errors import CodecEvalError
from ..iter.codecs import build_codec
from ..metrics import MetricConfig
from ..stats import CorpusAggregate, WEB_FRAME
from ..stats.rd_plot import plot_rd_svg
from . import add_device_argument

if TYPE_CHECKING:
    from ..parallel import CorpusLadders


def parse_range(spec: str) -> List[int]:
    """"10:2:98" -> [10, 12, ..., 98].  reference: rd_calibrate.rs:53-64."""
    parts = spec.split(":")
    if len(parts) != 3:
        raise CodecEvalError(f"range spec must be start:step:end, got '{spec}'")
    start, step, end = (int(p) for p in parts)
    if step <= 0 or end < start:
        raise CodecEvalError(f"invalid range '{spec}'")
    return list(range(start, end + 1, step))


def score_ladder(
    ref_u8: np.ndarray, batch_u8: "np.ndarray | Sequence[np.ndarray]", device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """SSIMULACRA2 and Butteraugli of (N, H, W, 3) u8 candidates, or a list
    of N (H, W, 3) u8 arrays, against one (H, W, 3) u8 reference, each
    reference precompute shared across the ladder: the JAX module's
    ``score_sweep``."""
    scores = _score_ladder(
        ref_u8, batch_u8, MetricConfig(ssimulacra2=True, butteraugli=True), device=device
    )
    return scores["ssimulacra2"], scores["butteraugli"]


def sweep_corpus(
    corpus: Corpus,
    codec,
    qualities: List[int],
    limit: int = 0,
    progress=print,
    *,
    device="cuda",
) -> Dict[int, List[Tuple[float, float, float]]]:
    """Per-quality lists of (bpp, s2, ba) across images."""
    images = corpus.images[:limit] if limit else corpus.images
    by_quality: Dict[int, List[Tuple[float, float, float]]] = {
        q: [] for q in qualities
    }
    for i, corpus_image in enumerate(images):
        path = corpus_image.full_path(corpus.root_path)
        try:
            from PIL import Image

            rgb = np.asarray(Image.open(path).convert("RGB"))
        except Exception as e:  # noqa: BLE001 - skip-and-continue policy
            progress(f"  SKIP {corpus_image.relative_path}: {e}")
            continue
        h, w = rgb.shape[:2]

        encoded = []
        for q in qualities:
            data = codec.encode(rgb, q)
            decoded = codec.decode(data)
            encoded.append((len(data), decoded))

        s2s, bas = score_ladder(rgb, [d for _, d in encoded], device=device)
        for q, (size, _), s2, ba in zip(qualities, encoded, s2s, bas):
            if np.isfinite(s2) and np.isfinite(ba):
                # Drop non-finite scores (reference: rd_calibrate.rs:144-148).
                by_quality[q].append((size * 8.0 / (w * h), float(s2), float(ba)))
        progress(f"  [{i + 1}/{len(images)}] {corpus_image.relative_path}")
    return by_quality


def aggregate_curve(
    by_quality: Dict[int, List[Tuple[float, float, float]]]
) -> List[Tuple[float, float, float]]:
    """Per-quality corpus means sorted by bpp.
    reference: rd_calibrate.rs:240-260."""
    curve = []
    for q in sorted(by_quality):
        samples = by_quality[q]
        if not samples:
            continue
        n = len(samples)
        curve.append(
            (
                sum(s[0] for s in samples) / n,
                sum(s[1] for s in samples) / n,
                sum(s[2] for s in samples) / n,
            )
        )
    curve.sort(key=lambda p: p[0])
    return curve


def emit_calibration_code(cal, corpus_name: str, codec_id: str) -> str:
    """Ready-to-paste defaults code.  reference: rd_calibrate.rs:322-379."""
    s2, ba = cal.ssimulacra2, cal.butteraugli
    return f'''\
# Generated calibration for {codec_id} on {corpus_name}
RDCalibration(
    frame=WEB_FRAME,
    ssimulacra2=RDKnee(
        bpp={s2.bpp:.4f}, quality={s2.quality:.2f},
        fixed_angle=WEB_FRAME.s2_angle({s2.bpp:.4f}, {s2.quality:.2f}),
        norm=NormalizationContext(
            bpp_range=AxisRange({s2.norm.bpp_range.min:.4f}, {s2.norm.bpp_range.max:.4f}),
            quality_range=AxisRange({s2.norm.quality_range.min:.2f}, {s2.norm.quality_range.max:.2f}),
            direction=QualityDirection.HIGHER_IS_BETTER,
        ),
    ),
    butteraugli=RDKnee(
        bpp={ba.bpp:.4f}, quality={ba.quality:.3f},
        fixed_angle=WEB_FRAME.ba_angle({ba.bpp:.4f}, {ba.quality:.3f}),
        norm=NormalizationContext(
            bpp_range=AxisRange({ba.norm.bpp_range.min:.4f}, {ba.norm.bpp_range.max:.4f}),
            quality_range=AxisRange({ba.norm.quality_range.min:.3f}, {ba.norm.quality_range.max:.3f}),
            direction=QualityDirection.LOWER_IS_BETTER,
        ),
    ),
    corpus="{corpus_name}",
    codec="{codec_id}",
    image_count={cal.image_count},
)'''


def sweep_images_device(
    images: Sequence[np.ndarray],
    qualities: Sequence[int],
    subsampling: str = "420",
    trellis: bool = False,
    size_mode: str = "exact",
    *,
    device="cuda",
) -> List[Tuple[List[int], CorpusLadders]]:
    """The calibration sweep's whole encode / decode / score loop
    (reference: rd_calibrate.rs:184-216) over decoded (H, W, 3) u8 images,
    on ``device`` through tpujpeg's ladder runner
    (``parallel.sweep_corpus_ladders``): SSIMULACRA2 and Butteraugli of
    every quality, and byte sizes, entropy-coded on the host ("exact") or
    counted from the device's rate statistics ("device").  ``trellis``
    quantizes by the trellis DP (lambda 0.10, no AQ), otherwise by AQ
    rounding (strength 0.30).

    Returns one (input indices, ``CorpusLadders``) per image shape, in the
    order each shape first appears."""
    import torch

    from ..parallel import make_mesh, sweep_corpus_ladders

    if size_mode not in ("exact", "device"):
        raise ValueError(f"size_mode must be 'exact' or 'device', got {size_mode!r}")
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, rgb in enumerate(images):
        if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
            raise ValueError(f"image {i}: need (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
        groups.setdefault(rgb.shape[:2], []).append(i)
    mesh = make_mesh(devices=[torch.device(device)])
    return [
        (idx, sweep_corpus_ladders(
            [images[i] for i in idx],
            [float(q) for q in qualities],
            mesh=mesh,
            subsampling=subsampling,
            metrics=("ssimulacra2", "butteraugli"),
            aq_strength=0.0 if trellis else 0.30,
            trellis_lambda=0.10 if trellis else 0.0,
            with_sizes="device" if size_mode == "device" else True,
        ))
        for idx in groups.values()
    ]


def sweep_corpus_device(
    corpus: Corpus,
    qualities: List[int],
    subsampling: str = "420",
    limit: int = 0,
    progress=print,
    trellis: bool = False,
    size_mode: str = "exact",
    *,
    device="cuda",
) -> Dict[int, List[Tuple[float, float, float]]]:
    """``sweep_images_device`` over a corpus's files (an unreadable file is
    skipped), folded into per-quality lists of (bpp, s2, ba)."""
    images = corpus.images[:limit] if limit else corpus.images
    rgbs = []
    for corpus_image in images:
        path = corpus_image.full_path(corpus.root_path)
        try:
            from PIL import Image

            rgbs.append(np.asarray(Image.open(path).convert("RGB")))
        except Exception as e:  # noqa: BLE001 - skip-and-continue policy
            progress(f"  SKIP {corpus_image.relative_path}: {e}")

    by_quality: Dict[int, List[Tuple[float, float, float]]] = {q: [] for q in qualities}
    done = 0
    groups = sweep_images_device(rgbs, qualities, subsampling, trellis, size_mode, device=device)
    for idx, res in groups:
        s2 = res.scores["ssimulacra2"]
        ba = res.scores["butteraugli"]
        for ii in range(len(idx)):
            for qi, q in enumerate(qualities):
                if np.isfinite(s2[ii, qi]) and np.isfinite(ba[ii, qi]):
                    by_quality[q].append(
                        (float(res.bits_per_pixel[ii, qi]), float(s2[ii, qi]), float(ba[ii, qi]))
                    )
        done += len(idx)
        h, w = rgbs[idx[0]].shape[:2]
        progress(f"  [{done}/{len(rgbs)}] {h}x{w} group ({len(idx)} images)")
    return by_quality


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rd-calibrate")
    parser.add_argument("corpus", type=Path)
    parser.add_argument("--range", default="10:2:98", help="start:step:end")
    parser.add_argument("--format", default="jpeg")
    parser.add_argument("--subsampling", default="420")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--output", type=Path, default=Path("./rd_calibration"))
    parser.add_argument(
        "--device-sweep",
        action="store_true",
        help="tpujpeg only: run the whole calibration sweep (encode, "
        "decode, score) on the device mesh",
    )
    parser.add_argument(
        "--trellis",
        action="store_true",
        help="tpujpeg only: trellis quantization (device DP under "
        "--device-sweep)",
    )
    parser.add_argument(
        "--size-mode",
        choices=("exact", "device"),
        default="exact",
        help="--device-sweep byte sizes: 'exact' entropy-codes on host; "
        "'device' computes them from on-device rate statistics "
        "(entropy-exact, stuffing estimated ~0.15%%)",
    )
    add_device_argument(parser)
    args = parser.parse_args(argv)

    try:
        qualities = parse_range(args.range)
        if args.device_sweep and args.format != "tpujpeg":
            print("error: --device-sweep requires --format tpujpeg",
                  file=sys.stderr)
            return 2
        codec = (
            None
            if args.device_sweep
            else build_codec(
                args.format, subsampling=args.subsampling, trellis=args.trellis,
                device=args.device,
            )
        )
        corpus = Corpus.discover(args.corpus)
    except CodecEvalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    summary = (
        f"tpujpeg-{args.subsampling}-{'trellis' if args.trellis else 'aq'}-device"
        if args.device_sweep
        else codec.summary
    )
    print(f"rd-calibrate: {summary} x {len(qualities)} qualities "
          f"on {len(corpus)} images")
    t0 = time.perf_counter()
    if args.device_sweep:
        by_quality = sweep_corpus_device(
            corpus, qualities, subsampling=args.subsampling, limit=args.limit,
            trellis=args.trellis, size_mode=args.size_mode, device=args.device,
        )
    else:
        by_quality = sweep_corpus(
            corpus, codec, qualities, limit=args.limit, device=args.device
        )
    curve = aggregate_curve(by_quality)
    if len(curve) < 3:
        print("error: not enough data for knee detection", file=sys.stderr)
        return 1

    image_count = max(len(v) for v in by_quality.values())
    agg = CorpusAggregate(corpus.name, summary, curve, image_count)
    cal = agg.calibrate(WEB_FRAME)
    if cal is None:
        print("error: knee detection failed", file=sys.stderr)
        return 1

    dt = time.perf_counter() - t0
    print(f"\nsweep complete in {dt:.1f}s")
    print(f"s2 knee: {cal.ssimulacra2.bpp:.4f} bpp @ {cal.ssimulacra2.quality:.2f} "
          f"({cal.ssimulacra2.fixed_angle:.1f} deg)")
    print(f"ba knee: {cal.butteraugli.bpp:.4f} bpp @ {cal.butteraugli.quality:.3f} "
          f"({cal.butteraugli.fixed_angle:.1f} deg)")

    args.output.mkdir(parents=True, exist_ok=True)
    svg = plot_rd_svg(curve, WEB_FRAME, cal,
                      title=f"R-D: {summary} on {corpus.name}")
    (args.output / "rd_curve.svg").write_text(svg)
    code = emit_calibration_code(cal, corpus.name, summary)
    (args.output / "calibration.py").write_text(code + "\n")
    # Machine-readable calibration for tooling (tools/clic_calibration_check
    # .py and CI): knees + provenance.
    import json

    (args.output / "calibration.json").write_text(
        json.dumps(
            {
                "corpus": corpus.name,
                "codec": summary,
                "image_count": image_count,
                "ssimulacra2": {
                    "bpp": cal.ssimulacra2.bpp,
                    "score": cal.ssimulacra2.quality,
                    "angle": cal.ssimulacra2.fixed_angle,
                },
                "butteraugli": {
                    "bpp": cal.butteraugli.bpp,
                    "score": cal.butteraugli.quality,
                    "angle": cal.butteraugli.fixed_angle,
                },
            },
            indent=2,
        )
        + "\n"
    )
    print(f"\nwrote {args.output}/rd_curve.svg, calibration.py, calibration.json")
    print("\n" + code)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
