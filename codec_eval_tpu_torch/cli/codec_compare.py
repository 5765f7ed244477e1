"""codec-compare: full multi-codec corpus comparison CLI.

Port of ``codec_eval_tpu/cli/codec_compare.py`` (reference:
crates/codec-compare/src/main.rs:33-386): ``run`` (corpus loop printing
``[i/n] name... OK``), ``single`` (one image), ``list`` (registered
codecs), ``report`` (regenerate charts/stats from a saved corpus report
JSON).  ``run`` and ``single`` score on ``--device``, the card by
default; the zenjpeg slot, which ``--formats all`` and ``--formats jpeg``
select, is tpujpeg's presets, whose ladders run there too.

    python -m codec_eval_tpu_torch.cli.codec_compare run CORPUS --formats jpeg
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..codecs import (
    CodecRegistry,
    CompareConfig,
    FormatSelection,
    Metric,
    ReportGenerator,
)
from ..corpus import Corpus
from ..engine import CorpusReport, ImageData
from ..errors import CodecEvalError
from ..metrics import MetricConfig
from . import add_device_argument


def _format_selection(args) -> FormatSelection:
    if args.formats == "all":
        return FormatSelection.all()
    if args.formats == "jpeg":
        return FormatSelection.jpeg_only()
    if args.formats == "next-gen":
        return FormatSelection.next_gen()
    sel = FormatSelection()
    for f in args.formats.split(","):
        f = f.strip().lower()
        if not hasattr(sel, f):
            raise CodecEvalError(f"unknown format '{f}'")
        setattr(sel, f, True)
    return sel


def _build_registry(args, device) -> CodecRegistry:
    config = (
        CompareConfig.new(args.output)
        .with_formats(_format_selection(args))
        .with_avif_speed(args.avif_speed)
    )
    if args.qualities:
        config.with_quality_levels([float(q) for q in args.qualities.split(",")])
    if args.fast_metrics:
        config.with_metrics(MetricConfig.ssimulacra2_only())
    registry = CodecRegistry(config, device=device)
    n = registry.register_all()
    if n == 0:
        raise CodecEvalError("no codecs available for the selected formats")
    return registry


def cmd_run(args) -> int:
    registry = _build_registry(args, args.device)
    corpus = Corpus.discover(args.corpus)
    images = corpus.images[: args.limit] if args.limit else corpus.images
    print(f"comparing {len(registry.codecs)} codecs on {len(images)} images")
    if registry.skipped:
        print("skipped (unavailable): "
              + ", ".join(c.id() for c in registry.skipped))

    def load_items():
        for corpus_image in images:
            try:
                yield (
                    corpus_image.name(),
                    ImageData.open(corpus_image.full_path(corpus.root_path)),
                )
            except CodecEvalError as e:
                # Skip-and-continue (reference: main.rs:335-376).
                print(f"SKIP {corpus_image.name()} ({e})")

    # Pipelined corpus evaluation: host codecs encode image i+1 while the
    # device scores image i.
    corpus_report = registry.session.evaluate_corpus(
        load_items(), name=args.name, on_error="skip", progress=print
    )
    for report in corpus_report.images:
        registry.write_image_report(report)

    registry.write_corpus_report(corpus_report)
    gen = ReportGenerator(args.output, Metric(args.metric))
    out = gen.generate(corpus_report)
    ReportGenerator.print_statistics(out["stats"])
    print(f"\nreports in {args.output}")
    return 0


def cmd_single(args) -> int:
    registry = _build_registry(args, args.device)
    image = ImageData.open(args.image)
    report = registry.evaluate_image(Path(args.image).stem, image)
    registry.write_image_report(report)
    print(f"{'codec':<24} {'q':>4} {'bpp':>8} {'ssim2':>8} {'dssim':>10} "
          f"{'ba':>7} {'lvl':>4}")
    for r in report.results:
        m = r.metrics
        print(
            f"{r.codec_id:<24} {r.quality:>4g} {r.bits_per_pixel:>8.3f} "
            f"{m.ssimulacra2 if m.ssimulacra2 is not None else float('nan'):>8.2f} "
            f"{m.dssim if m.dssim is not None else float('nan'):>10.6f} "
            f"{m.butteraugli if m.butteraugli is not None else float('nan'):>7.2f} "
            f"{r.perception.code() if r.perception else '---':>4}"
        )
    return 0


def cmd_list(args) -> int:
    # Lists the adapters and scores nothing: its session stays on the host.
    registry = _build_registry(args, "cpu")
    for codec in registry.codecs:
        print(f"{codec.id():<28} {codec.format():<6} v{codec.version()}")
    for codec in registry.skipped:
        print(f"{codec.id():<28} {codec.format():<6} UNAVAILABLE")
    return 0


def cmd_report(args) -> int:
    with open(args.input) as f:
        corpus_report = CorpusReport.from_json(json.load(f))
    gen = ReportGenerator(args.output, Metric(args.metric))
    out = gen.generate(corpus_report)
    ReportGenerator.print_statistics(out["stats"])
    print(f"reports regenerated in {args.output}")
    return 0


def _add_registry_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--output", type=Path, default=Path("./reports"))
    p.add_argument("--formats", default="all",
                   help="all|jpeg|next-gen|comma list (jpeg,webp,avif,jpegxl)")
    p.add_argument("--qualities", help="comma-separated quality levels")
    p.add_argument("--avif-speed", type=int, default=6)
    p.add_argument("--metric", default="ssimulacra2",
                   choices=[m.value for m in Metric])
    p.add_argument("--fast-metrics", action="store_true",
                   help="SSIMULACRA2 only (skip dssim/butteraugli)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="codec-compare")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="compare codecs over a corpus")
    p_run.add_argument("corpus", type=Path)
    p_run.add_argument("--limit", type=int)
    p_run.add_argument("--name", default="corpus")
    _add_registry_args(p_run)
    add_device_argument(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_single = sub.add_parser("single", help="compare codecs on one image")
    p_single.add_argument("image", type=Path)
    _add_registry_args(p_single)
    add_device_argument(p_single)
    p_single.set_defaults(fn=cmd_single)

    p_list = sub.add_parser("list", help="list registered codecs")
    _add_registry_args(p_list)
    p_list.set_defaults(fn=cmd_list)

    p_report = sub.add_parser("report", help="regenerate reports from JSON")
    p_report.add_argument("input", type=Path)
    p_report.add_argument("--output", type=Path, default=Path("./reports"))
    p_report.add_argument("--metric", default="ssimulacra2",
                          choices=[m.value for m in Metric])
    p_report.set_defaults(fn=cmd_report)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CodecEvalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
