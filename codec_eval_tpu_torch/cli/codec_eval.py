"""codec-eval: corpus management + analysis CLI.

Port of ``codec_eval_tpu/cli/codec_eval.py`` (reference:
crates/codec-eval-cli/src/main.rs:23-246): subcommand groups ``corpus
{discover,info,list}``, ``sparse {clone,init,add,set,status,list,preview,
disable,fetch}``, ``import``, ``pareto``, ``stats``.  Pareto converts
imported results to RD points with lower-is-better metric negation
(commands/pareto.rs:22-47); stats prints overall / by-codec / by-image
Summary tables (commands/stats.rs:36-164).  Result files load as JSON
first, then CSV (commands/pareto.rs:123-137).  All host code, the JAX
tool's own, so it takes no ``--device``.

    python -m codec_eval_tpu_torch.cli.codec_eval stats results.csv
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from ..corpus import Corpus, SparseCheckout, SparseFilter
from ..errors import CodecEvalError
from ..importers import CsvImporter, ExternalResult
from ..stats import ParetoFront, RDPoint, Summary


def _load_results(path: Path) -> List[ExternalResult]:
    """JSON-then-CSV auto-loading.  reference: commands/pareto.rs:123-137."""
    if path.suffix.lower() == ".json" or _looks_like_json(path):
        with open(path) as f:
            data = json.load(f)
        rows = data if isinstance(data, list) else data.get("results", [])
        return [ExternalResult.from_json(r) for r in rows]
    return CsvImporter.auto_detect().import_file(path)


def _looks_like_json(path: Path) -> bool:
    try:
        with open(path) as f:
            head = f.read(64).lstrip()
        return head.startswith("[") or head.startswith("{")
    except OSError:
        return False


def _to_rd_points(
    results: List[ExternalResult], metric: str
) -> List[RDPoint]:
    """Metric negation for lower-is-better (dssim/butteraugli).
    reference: commands/pareto.rs:22-47."""
    lower_is_better = metric in ("dssim", "butteraugli")
    points = []
    for r in results:
        value = getattr(r, metric)
        bpp = r.bits_per_pixel
        if value is None or bpp is None:
            continue
        points.append(
            RDPoint(
                codec=r.codec,
                quality_setting=r.quality_setting or 0.0,
                bpp=bpp,
                quality=-value if lower_is_better else value,
                encode_time_ms=r.encode_time_ms,
                image=r.image_name,
            )
        )
    return points


# -- corpus ---------------------------------------------------------------


def cmd_corpus(args) -> int:
    if args.corpus_cmd == "discover":
        corpus = Corpus.discover(args.path)
        if args.manifest:
            corpus.save_manifest(args.manifest)
            print(f"manifest written: {args.manifest}")
        s = corpus.stats()
        print(f"corpus '{corpus.name}': {s.image_count} images, "
              f"{s.total_bytes / 1e6:.1f} MB, "
              f"{s.min_width}x{s.min_height}..{s.max_width}x{s.max_height}")
        for cat, count in sorted(corpus.metadata.category_counts.items()):
            print(f"  {cat}: {count}")
        return 0
    if args.corpus_cmd == "info":
        corpus = Corpus.discover(args.path)
        s = corpus.stats()
        print(json.dumps({
            "name": corpus.name,
            "image_count": s.image_count,
            "total_pixels": s.total_pixels,
            "total_bytes": s.total_bytes,
            "width_range": [s.min_width, s.max_width],
            "height_range": [s.min_height, s.max_height],
            "categories": corpus.metadata.category_counts,
        }, indent=2))
        return 0
    if args.corpus_cmd == "list":
        corpus = Corpus.discover(args.path)
        for img in corpus.images:
            cat = f" [{img.category}]" if img.category else ""
            print(f"{img.relative_path} {img.width}x{img.height} "
                  f"{img.file_size}B{cat}")
        return 0
    raise ValueError(args.corpus_cmd)


# -- sparse ---------------------------------------------------------------


def cmd_sparse(args) -> int:
    cmd = args.sparse_cmd
    if cmd == "clone":
        sc = (
            SparseCheckout.clone_shallow(args.url, args.target, args.depth)
            if args.depth
            else SparseCheckout.clone(args.url, args.target)
        )
        print(f"cloned {args.url} -> {sc.repo_path}")
        return 0
    if cmd == "init":
        SparseCheckout.init(args.repo)
        print("sparse checkout initialized")
        return 0

    sc = SparseCheckout.open(args.repo)
    if cmd == "add":
        sc.add_paths(args.patterns)
    elif cmd == "set":
        sc.set_paths(args.patterns)
    elif cmd == "status":
        st = sc.status()
        total = f"/{st.total_files}" if st.total_files else ""
        print(f"enabled: {st.enabled}; files: {st.checked_out_files}{total}")
        for p in st.patterns:
            print(f"  {p}")
    elif cmd == "list":
        for p in sc.list_patterns():
            print(p)
    elif cmd == "preview":
        for f in sc.preview_patterns(args.patterns):
            print(f)
    elif cmd == "disable":
        sc.disable()
    elif cmd == "fetch":
        sc.fetch()
    elif cmd == "pull":
        sc.pull()
    else:
        raise ValueError(cmd)
    return 0


# -- import / pareto / stats ---------------------------------------------


def cmd_import(args) -> int:
    results = CsvImporter.auto_detect().import_file(args.input)
    print(f"imported {len(results)} results from {args.input}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=2)
        print(f"written: {args.output}")
    else:
        codecs = sorted({r.codec for r in results})
        print(f"codecs: {', '.join(codecs)}")
    return 0


def cmd_pareto(args) -> int:
    results = _load_results(args.input)
    points = _to_rd_points(results, args.metric)
    if not points:
        print(f"no usable points for metric '{args.metric}'", file=sys.stderr)
        return 1
    front = ParetoFront.compute(points)
    print(f"Pareto front ({args.metric}): {len(front)} of {len(points)} points")
    for p in front.points:
        print(f"  {p.codec:<24} q={p.quality_setting:<6g} "
              f"bpp={p.bpp:<8.4f} {args.metric}={abs(p.quality):.4f}")
    if args.per_codec:
        for codec, cf in sorted(ParetoFront.per_codec(points).items()):
            print(f"\n{codec}: {len(cf)} points on own front")
            for p in cf.points:
                print(f"  q={p.quality_setting:<6g} bpp={p.bpp:<8.4f} "
                      f"{args.metric}={abs(p.quality):.4f}")
    return 0


def _print_summary(label: str, summary: Optional[Summary]) -> None:
    if summary is None:
        return
    print(f"  {label:<28} n={summary.count:<5} mean={summary.mean:<10.4f} "
          f"median={summary.median:<10.4f} p5={summary.p5:<10.4f} "
          f"p95={summary.p95:<10.4f}")


def cmd_stats(args) -> int:
    results = _load_results(args.input)
    values = [
        getattr(r, args.metric) for r in results if getattr(r, args.metric) is not None
    ]
    if not values:
        print(f"no values for metric '{args.metric}'", file=sys.stderr)
        return 1
    print(f"stats for {args.metric} over {len(values)} results:")
    _print_summary("overall", Summary.compute(values))

    print("\nby codec:")
    by_codec = {}
    for r in results:
        v = getattr(r, args.metric)
        if v is not None:
            by_codec.setdefault(r.codec, []).append(v)
    for codec in sorted(by_codec):
        _print_summary(codec, Summary.compute(by_codec[codec]))

    if args.by_image:
        print("\nby image:")
        by_image = {}
        for r in results:
            v = getattr(r, args.metric)
            if v is not None:
                by_image.setdefault(r.image_name, []).append(v)
        for image in sorted(by_image):
            _print_summary(image, Summary.compute(by_image[image]))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="codec-eval")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_corpus = sub.add_parser("corpus")
    corpus_sub = p_corpus.add_subparsers(dest="corpus_cmd", required=True)
    for name in ("discover", "info", "list"):
        p = corpus_sub.add_parser(name)
        p.add_argument("path", type=Path)
        if name == "discover":
            p.add_argument("--manifest", type=Path)
    p_corpus.set_defaults(fn=cmd_corpus)

    p_sparse = sub.add_parser("sparse")
    sparse_sub = p_sparse.add_subparsers(dest="sparse_cmd", required=True)
    p = sparse_sub.add_parser("clone")
    p.add_argument("url")
    p.add_argument("target", type=Path)
    p.add_argument("--depth", type=int)
    p = sparse_sub.add_parser("init")
    p.add_argument("repo", type=Path)
    for name in ("add", "set", "preview"):
        p = sparse_sub.add_parser(name)
        p.add_argument("repo", type=Path)
        p.add_argument("patterns", nargs="+")
    for name in ("status", "list", "disable", "fetch", "pull"):
        p = sparse_sub.add_parser(name)
        p.add_argument("repo", type=Path)
    p_sparse.set_defaults(fn=cmd_sparse)

    p_import = sub.add_parser("import")
    p_import.add_argument("input", type=Path)
    p_import.add_argument("--output", type=Path)
    p_import.set_defaults(fn=cmd_import)

    p_pareto = sub.add_parser("pareto")
    p_pareto.add_argument("input", type=Path)
    p_pareto.add_argument("--metric", default="ssimulacra2",
                          choices=["ssimulacra2", "dssim", "butteraugli", "psnr"])
    p_pareto.add_argument("--per-codec", action="store_true")
    p_pareto.set_defaults(fn=cmd_pareto)

    p_stats = sub.add_parser("stats")
    p_stats.add_argument("input", type=Path)
    p_stats.add_argument("--metric", default="ssimulacra2",
                         choices=["ssimulacra2", "dssim", "butteraugli", "psnr"])
    p_stats.add_argument("--by-image", action="store_true")
    p_stats.set_defaults(fn=cmd_stats)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CodecEvalError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
