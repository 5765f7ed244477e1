"""codec-analyze: corpus analysis studies CLI.

Port of ``codec_eval_tpu/cli/codec_analyze.py``, which consolidates the
reference's nine analysis binaries (crates/codec-compare/Cargo.toml:22-52)
into one subcommand CLI:

- ``full-comparison``  <- full_comparison.rs (two codecs, all metrics, CSV)
- ``brute-force-sweep``<- brute_force_sweep.rs (fine grid, ETA display)
- ``find-outliers``    <- find_outliers.rs (divergent images, text/json/csv)
- ``rd-compare``       <- rd_compare.rs (matched-bpp targets)
- ``heuristics``       <- image_heuristics.rs (26 features -> CSV)
- ``analyze-image``    <- analyze_image.rs (explain encoder preference)
- ``build-predictor``  <- build_predictor.rs (winner rules + fitted rule)

The sweeps and the heuristics run on ``--device``, the card by default.

    python -m codec_eval_tpu_torch.cli.codec_analyze full-comparison CORPUS
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np

from ..analysis.comparison import (
    DEFAULT_BPP_TARGETS,
    find_outliers,
    outlier_report_json,
    rd_compare,
    read_comparison_csv,
    sweep_codecs,
    write_comparison_csv,
)
from ..analysis.heuristics import FEATURE_NAMES, heuristics_one
from ..analysis.predictor import (
    default_rules,
    determine_winners,
    evaluate_rules,
    fit_logistic_rule,
)
from ..analysis import quality_predictor as qp
from ..corpus import Corpus
from ..errors import CodecEvalError
from ..iter.codecs import build_codec
from . import add_device_argument


def _codec(spec: str, device="cuda"):
    """Spec: format[:subsampling[:prog|base]], avif:preset,
    tpujpeg:xyb, or tpujpeg:trellis[:subsampling].  tpujpeg's analysis and
    decode run on ``device``."""
    parts = spec.split(":")
    fmt = parts[0]
    if fmt == "avif" and len(parts) > 1:
        return build_codec("avif", preset=parts[1])
    if fmt == "tpujpeg" and len(parts) > 1 and parts[1] == "xyb":
        return build_codec("tpujpeg", xyb=True, device=device)
    if fmt == "tpujpeg" and len(parts) > 1 and parts[1] == "trellis":
        return build_codec(
            "tpujpeg", trellis=True, progressive=False,
            subsampling=parts[2] if len(parts) > 2 else "420", device=device,
        )
    sub = parts[1] if len(parts) > 1 else "420"
    prog = (parts[2] != "base") if len(parts) > 2 else True
    return build_codec(fmt, subsampling=sub, progressive=prog, device=device)


def cmd_full_comparison(args) -> int:
    corpus = Corpus.discover(args.corpus)
    codecs = [_codec(args.codec_a, args.device), _codec(args.codec_b, args.device)]
    qualities = list(range(args.q_min, args.q_max + 1, args.q_step))
    rows = sweep_codecs(
        corpus, codecs, qualities, limit=args.limit,
        progress=lambda s: print(f"  {s}"), checkpoint=args.checkpoint,
        device=args.device,
    )
    write_comparison_csv(rows, args.output)
    print(f"wrote {len(rows)} rows to {args.output}")
    return 0


def cmd_brute_force(args) -> int:
    corpus = Corpus.discover(args.corpus)
    codecs = [_codec(s, args.device) for s in args.codecs.split(",")]
    qualities = list(range(2, 101, 2))
    rows = sweep_codecs(
        corpus, codecs, qualities, limit=args.limit,
        progress=lambda s: print(f"  {s}"), eta=True, checkpoint=args.checkpoint,
        device=args.device,
    )
    write_comparison_csv(rows, args.output)
    print(f"wrote {len(rows)} rows to {args.output}")
    return 0


def cmd_find_outliers(args) -> int:
    rows = read_comparison_csv(args.input)
    codecs = sorted({r.codec for r in rows})
    a = args.codec_a or codecs[0]
    b = args.codec_b or (codecs[1] if len(codecs) > 1 else codecs[0])
    report = find_outliers(rows, a, b, top_n=args.top)
    if args.format == "json":
        print(outlier_report_json(report))
    elif args.format == "csv":
        w = csv.writer(sys.stdout)
        w.writerow(["image", "advantage", "divergence"])
        for image, adv, div in report.images:
            w.writerow([image, f"{adv:.4f}", f"{div:.4f}"])
    else:
        print(f"advantage of {b} over {a} (butteraugli delta at matched q)")
        print(f"corpus mean advantage: {report.corpus_mean_advantage:+.4f}")
        for image, adv, div in report.images:
            print(f"  {image:<32} {adv:+8.4f}  (divergence {div:.4f})")
    return 0


def cmd_rd_compare(args) -> int:
    rows = read_comparison_csv(args.input)
    codecs = sorted({r.codec for r in rows})
    a = args.codec_a or codecs[0]
    b = args.codec_b or (codecs[1] if len(codecs) > 1 else codecs[0])
    targets = (
        [float(t) for t in args.targets.split(",")]
        if args.targets
        else DEFAULT_BPP_TARGETS
    )
    result = rd_compare(rows, a, b, targets)
    print(f"{'bpp':>6} {'s2 ' + a:>16} {'s2 ' + b:>16} {'delta':>8} {'n':>4}")
    for target in sorted(result.by_target):
        va, vb, n = result.by_target[target]
        print(f"{target:>6.2f} {va:>16.2f} {vb:>16.2f} {vb - va:>+8.2f} {n:>4}")
    if not result.by_target:
        print("no overlapping bpp coverage at the requested targets")
    return 0


def cmd_heuristics(args) -> int:
    corpus = Corpus.discover(args.corpus)
    from PIL import Image

    images = corpus.images[: args.limit] if args.limit else corpus.images
    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "width", "height", "pixels"] + FEATURE_NAMES)
        for i, corpus_image in enumerate(images):
            try:
                rgb = np.asarray(
                    Image.open(corpus_image.full_path(corpus.root_path)).convert("RGB")
                )
            except Exception as e:  # noqa: BLE001
                print(f"  SKIP {corpus_image.relative_path} ({e})")
                continue
            feats = heuristics_one(rgb, device=args.device)
            w.writerow(
                [corpus_image.name(), rgb.shape[1], rgb.shape[0],
                 rgb.shape[0] * rgb.shape[1]]
                + [f"{feats[k]:.4f}" for k in FEATURE_NAMES]
            )
            print(f"  [{i + 1}/{len(images)}] {corpus_image.name()}")
    print(f"wrote {args.output}")
    return 0


def cmd_analyze_image(args) -> int:
    from PIL import Image

    rgb = np.asarray(Image.open(args.image).convert("RGB"))
    feats = heuristics_one(rgb, device=args.device)
    print(f"{args.image}: {rgb.shape[1]}x{rgb.shape[0]}")
    for k in FEATURE_NAMES:
        print(f"  {k:<24} {feats[k]:.4f}")
    encoder, bpp = qp.predict_encoder_for_quality(
        args.target_butteraugli,
        feats["flat_block_pct"],
        feats["edge_strength_mean"],
        feats["local_contrast_mean"],
    )
    print(f"\npredicted winner at BA<={args.target_butteraugli}: "
          f"{encoder} (~{bpp:.2f} bpp)")
    return 0


def cmd_build_predictor(args) -> int:
    rows = read_comparison_csv(args.comparison)
    heuristics = {}
    with open(args.heuristics, newline="") as f:
        for d in csv.DictReader(f):
            heuristics[d["image"]] = {
                k: float(v)
                for k, v in d.items()
                if k not in ("image",) and v not in ("", None)
            }
    codecs = sorted({r.codec for r in rows})
    a = args.codec_a or codecs[0]
    b = args.codec_b or (codecs[1] if len(codecs) > 1 else codecs[0])
    samples = determine_winners(rows, heuristics, a, b)
    if not samples:
        print("no (image, bucket) samples with both codecs covered",
              file=sys.stderr)
        return 1
    wins_a = sum(1 for s in samples if s.winner == a)
    print(f"{len(samples)} samples; {a} wins {wins_a}, {b} wins "
          f"{len(samples) - wins_a}")

    rules = default_rules(a, b)
    fitted = fit_logistic_rule(samples, a, b)
    if fitted:
        rules.append(fitted)
    scores = evaluate_rules(samples, rules)
    print(f"\n{'rule':<26} {'accuracy':>9} {'weighted':>9}")
    for s in scores:
        print(f"{s.name:<26} {s.accuracy:>9.3f} {s.weighted_accuracy:>9.3f}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="codec-analyze")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("full-comparison")
    p.add_argument("corpus", type=Path)
    p.add_argument("--codec-a", default="jpeg:420:prog")
    p.add_argument("--codec-b", default="jpeg:444:prog")
    p.add_argument("--q-min", type=int, default=30)
    p.add_argument("--q-max", type=int, default=95)
    p.add_argument("--q-step", type=int, default=5)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--output", type=Path, default=Path("full_comparison.csv"))
    p.add_argument("--checkpoint", type=Path,
                   help="JSONL checkpoint for shard-level resume")
    add_device_argument(p)
    p.set_defaults(fn=cmd_full_comparison)

    p = sub.add_parser("brute-force-sweep")
    p.add_argument("corpus", type=Path)
    p.add_argument("--codecs", default="jpeg:420,webp")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--output", type=Path, default=Path("brute_force.csv"))
    p.add_argument("--checkpoint", type=Path,
                   help="JSONL checkpoint for shard-level resume")
    add_device_argument(p)
    p.set_defaults(fn=cmd_brute_force)

    p = sub.add_parser("find-outliers")
    p.add_argument("input", type=Path, help="comparison CSV")
    p.add_argument("--codec-a")
    p.add_argument("--codec-b")
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--format", choices=["text", "json", "csv"], default="text")
    p.set_defaults(fn=cmd_find_outliers)

    p = sub.add_parser("rd-compare")
    p.add_argument("input", type=Path, help="comparison CSV")
    p.add_argument("--codec-a")
    p.add_argument("--codec-b")
    p.add_argument("--targets", help="comma-separated bpp targets")
    p.set_defaults(fn=cmd_rd_compare)

    p = sub.add_parser("heuristics")
    p.add_argument("corpus", type=Path)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--output", type=Path, default=Path("image_heuristics.csv"))
    add_device_argument(p)
    p.set_defaults(fn=cmd_heuristics)

    p = sub.add_parser("analyze-image")
    p.add_argument("image", type=Path)
    p.add_argument("--target-butteraugli", type=float, default=3.0)
    add_device_argument(p)
    p.set_defaults(fn=cmd_analyze_image)

    p = sub.add_parser("build-predictor")
    p.add_argument("comparison", type=Path)
    p.add_argument("heuristics", type=Path)
    p.add_argument("--codec-a")
    p.add_argument("--codec-b")
    p.set_defaults(fn=cmd_build_predictor)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CodecEvalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
