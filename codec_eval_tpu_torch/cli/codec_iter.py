"""codec-iter: sub-second encoder iteration CLI.

Port of ``codec_eval_tpu/cli/codec_iter.py`` (reference:
crates/codec-iter/src/main.rs:31-449): ``eval`` / ``sweep`` / ``baseline
{save,show}`` subcommands, quality presets (quick=[75,85,95], standard=8
points, dense=50..98 step 2), result tables with delta-vs-baseline columns
and the scalar pareto score, and automatic baseline save on first run.
Scoring, and tpujpeg's device work (``--format tpujpeg``, ``eval
--device-sweep``, ``target``), run on ``--device``, the card by default.

    python -m codec_eval_tpu_torch.cli.codec_iter eval --corpus synthetic-photo-v1 --limit 2
    python -m codec_eval_tpu_torch.cli.codec_iter eval --corpus synthetic-photo-v1 \
        --format tpujpeg --device-sweep --size-mode device
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..errors import CodecEvalError
from ..iter.baseline import (
    compare_with_baseline,
    load_baseline,
    make_baseline,
    save_baseline,
)
from ..iter.codecs import AVIF_PRESETS, AvifIterConfig, JpegIterConfig, build_codec
from ..iter.eval import run_eval, run_eval_device
from ..iter.source import load_sources
from ..iter.sweep import print_sweep, run_sweep
from . import add_device_argument

QUALITY_PRESETS = {
    "quick": [75, 85, 95],
    "standard": [50, 60, 70, 75, 80, 85, 90, 95],
    "dense": list(range(50, 99, 2)),
}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--corpus", type=Path, required=True,
        help="image directory, or a virtual corpus name "
        "(synthetic-v1, synthetic-photo-v1)",
    )
    p.add_argument("--limit", type=int, default=3, help="image count (tier select)")
    p.add_argument(
        "--preset", choices=sorted(QUALITY_PRESETS), default="quick",
        help="quality ladder",
    )
    p.add_argument("--format", default="jpeg", help="jpeg|avif|webp|tpujpeg")
    p.add_argument("--subsampling", default="420")
    p.add_argument("--baseline-dir", type=Path, default=Path("baselines"))
    p.add_argument(
        "--avif-preset", default="baseline", choices=sorted(AVIF_PRESETS)
    )
    p.add_argument("--no-progressive", action="store_true")
    p.add_argument(
        "--xyb", action="store_true",
        help="tpujpeg only: encode in the XYB opsin colorspace",
    )
    p.add_argument(
        "--trellis", action="store_true",
        help="tpujpeg only: RD-optimal trellis quantization "
        "(baseline scans; overrides --no-progressive)",
    )
    p.add_argument(
        "--device-sweep",
        action="store_true",
        help="tpujpeg only: run the whole ladder (encode+decode+SSIM2) on "
        "device; host only entropy-codes for exact sizes",
    )
    p.add_argument(
        "--size-mode",
        choices=("exact", "device"),
        default="exact",
        help="--device-sweep byte sizes: 'exact' entropy-codes on host; "
        "'device' computes them from on-device rate statistics "
        "(entropy-exact, 0xFF stuffing estimated ~0.15%%, no coefficient "
        "fetch)",
    )


def _print_eval(points, baseline) -> None:
    """Result table with deltas.  reference: main.rs:297-380."""
    if baseline is None:
        print(f"\n{'q':>4} {'bpp':>8} {'ssim2':>8} {'bytes':>8} {'enc ms':>7}")
        by_q = {}
        for p in points:
            by_q.setdefault(p.quality, []).append(p)
        for q in sorted(by_q):
            pts = by_q[q]
            n = len(pts)
            print(
                f"{q:>4} {sum(p.bpp for p in pts) / n:>8.3f} "
                f"{sum(p.ssim2 for p in pts) / n:>8.2f} "
                f"{sum(p.size_bytes for p in pts) // n:>8} "
                f"{sum(p.encode_ms for p in pts) // n:>7}"
            )
        return
    rows = compare_with_baseline(points, baseline)
    print(
        f"\n{'q':>4} {'bpp':>8} {'ssim2':>8} {'Δbpp':>8} {'Δssim2':>8} {'pareto':>8}"
    )
    for r in rows:
        print(
            f"{r.quality:>4} {r.bpp:>8.3f} {r.ssim2:>8.2f} "
            f"{r.delta_bpp:>+8.3f} {r.delta_ssim2:>+8.2f} {r.pareto:>+8.2f}"
        )


def cmd_eval(args) -> int:
    qualities = QUALITY_PRESETS[args.preset]
    images = load_sources(args.corpus, args.limit)
    if args.device_sweep:
        if args.format != "tpujpeg":
            print("--device-sweep requires --format tpujpeg")
            return 2
        print(
            f"eval: tpujpeg-{args.subsampling} DEVICE sweep on "
            f"{len(images)} images x {len(qualities)} qualities"
        )
        result = run_eval_device(
            images, qualities, subsampling=args.subsampling,
            progress=lambda s: print(f"  {s}"), trellis=args.trellis,
            size_mode=args.size_mode, device=args.device,
        )
    else:
        codec = build_codec(
            args.format,
            subsampling=args.subsampling,
            progressive=not args.no_progressive,
            preset=args.avif_preset,
            xyb=args.xyb,
            trellis=args.trellis,
            device=args.device,
        )
        print(
            f"eval: {codec.summary} on {len(images)} images x "
            f"{len(qualities)} qualities"
        )
        result = run_eval(
            images, codec, qualities, progress=lambda s: print(f"  {s}"),
            device=args.device,
        )
    print(f"total: {result.total_ms} ms")

    baseline = load_baseline(args.baseline_dir, result.config_summary)
    if baseline is None:
        # Auto-save on first run.  reference: main.rs:424-439.
        saved = save_baseline(
            args.baseline_dir,
            make_baseline(
                result.config_summary,
                result.config_summary,
                str(args.corpus),
                result.points,
            ),
        )
        print(f"baseline saved: {saved}")
    _print_eval(result.points, baseline)
    return 0


def cmd_sweep(args) -> int:
    qualities = QUALITY_PRESETS[args.preset]
    images = load_sources(args.corpus, args.limit)
    if args.format == "jpeg":
        codecs = [
            JpegIterConfig(subsampling=s, progressive=p).build()
            for s in ("420", "444")
            for p in (True, False)
        ]
    elif args.format == "avif":
        codecs = [AvifIterConfig(preset=p).build() for p in sorted(AVIF_PRESETS)]
    elif args.format == "tpujpeg":
        # The zenjpeg-style config grid: subsampling x colorspace x scan
        # structure (reference: crates/codec-iter/src/config.rs:5-67).
        from ..iter.codecs import TpuJpegIterConfig

        dev = args.device
        codecs = [
            TpuJpegIterConfig(subsampling=s, device=dev).build()
            for s in ("420", "444", "422", "440")
        ] + [
            TpuJpegIterConfig(subsampling="420", progressive=True, device=dev).build(),
            TpuJpegIterConfig(xyb=True, device=dev).build(),
            TpuJpegIterConfig(subsampling="420", adaptive=False, device=dev).build(),
            TpuJpegIterConfig(subsampling="420", trellis=True, device=dev).build(),
        ]
    else:
        codecs = [build_codec(args.format, device=args.device)]
    result = run_sweep(images, codecs, qualities, device=args.device)
    print_sweep(result)
    return 0


def cmd_baseline(args) -> int:
    if args.baseline_cmd == "show":
        baseline = load_baseline(args.baseline_dir, args.key)
        if baseline is None:
            print(f"no baseline '{args.key}' in {args.baseline_dir}")
            return 1
        print(f"baseline {args.key}: {len(baseline.points)} points, "
              f"created {baseline.created_at}, corpus {baseline.corpus_path}")
        _print_eval(baseline.points, None)
        return 0
    if args.baseline_cmd == "save":
        qualities = QUALITY_PRESETS[args.preset]
        images = load_sources(args.corpus, args.limit)
        codec = build_codec(
            args.format,
            subsampling=args.subsampling,
            progressive=not args.no_progressive,
            preset=args.avif_preset,
            xyb=args.xyb,
            trellis=args.trellis,
            device=args.device,
        )
        result = run_eval(images, codec, qualities, device=args.device)
        saved = save_baseline(
            args.baseline_dir,
            make_baseline(
                result.config_summary,
                result.config_summary,
                str(args.corpus),
                result.points,
            ),
        )
        print(f"baseline saved: {saved}")
        return 0
    raise ValueError(args.baseline_cmd)


def cmd_target(args) -> int:
    """Distance-targeted encode: one device ladder finds the smallest file
    meeting the given floors/ceiling, then that quality is entropy-coded.
    No reference analog — its loop would search by re-encoding on host."""
    from ..engine.tpu_sweep import encode_to_target

    if all(
        v is None
        for v in (args.min_ssim2, args.max_butteraugli, args.max_dssim,
                  args.max_bpp)
    ):
        print("error: give at least one of --min-ssim2/--max-butteraugli/"
              "--max-dssim/--max-bpp", file=sys.stderr)
        return 2
    images = load_sources(args.corpus, args.limit)
    # The quick default is too coarse for targeting; use the dense grid
    # unless the user picked a preset deliberately.
    qualities = QUALITY_PRESETS[args.preset if args.preset != "quick" else "dense"]
    print(
        f"target: tpujpeg-{args.subsampling} on {len(images)} images "
        f"(grid of {len(qualities)})"
    )
    print(f"\n{'image':<28} {'q':>4} {'bpp':>7} {'bytes':>9} {'ssim2':>7} {'ba':>6}")
    out_dir = args.out
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    for src in images:
        res = encode_to_target(
            src.rgb,
            min_ssimulacra2=args.min_ssim2,
            max_butteraugli=args.max_butteraugli,
            max_dssim=args.max_dssim,
            max_bits_per_pixel=args.max_bpp,
            qualities=qualities,
            subsampling=args.subsampling,
            colorspace="xyb" if args.xyb else "ycbcr",
            progressive=not args.no_progressive and not args.xyb,
            trellis_lambda=0.10 if args.trellis else 0.0,
            device=args.device,
        )

        def fmt(key, width):
            v = res.metrics.get(key)
            return f"{v:>{width}.2f}" if v is not None else " " * (width - 1) + "-"

        print(
            f"{src.name:<28} {res.quality:>4g} {res.bits_per_pixel:>7.3f} "
            f"{res.file_size:>9} {fmt('ssimulacra2', 7)} {fmt('butteraugli', 6)}"
        )
        if out_dir is not None:
            stem = Path(src.name).stem
            (out_dir / f"{stem}.jpg").write_bytes(res.data)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="codec-iter", description="fast encoder iteration (TPU-scored)"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_eval = sub.add_parser("eval", help="evaluate one codec config")
    _add_common(p_eval)
    add_device_argument(p_eval)
    p_eval.set_defaults(fn=cmd_eval)

    p_target = sub.add_parser(
        "target",
        help="tpujpeg: encode each image to a perceptual/rate target "
        "(one device ladder per image)",
    )
    _add_common(p_target)
    p_target.add_argument("--min-ssim2", type=float, default=None)
    p_target.add_argument("--max-butteraugli", type=float, default=None)
    p_target.add_argument("--max-dssim", type=float, default=None)
    p_target.add_argument("--max-bpp", type=float, default=None)
    p_target.add_argument(
        "--out", type=Path, default=None, help="write the .jpg files here"
    )
    add_device_argument(p_target)
    p_target.set_defaults(fn=cmd_target)

    p_sweep = sub.add_parser("sweep", help="sweep codec configs")
    _add_common(p_sweep)
    add_device_argument(p_sweep)
    p_sweep.set_defaults(fn=cmd_sweep)

    p_base = sub.add_parser("baseline", help="manage baselines")
    base_sub = p_base.add_subparsers(dest="baseline_cmd", required=True)
    p_save = base_sub.add_parser("save")
    _add_common(p_save)
    add_device_argument(p_save)
    p_show = base_sub.add_parser("show")
    p_show.add_argument("key")
    p_show.add_argument("--baseline-dir", type=Path, default=Path("baselines"))
    p_base.set_defaults(fn=cmd_baseline)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CodecEvalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
