"""The command-line tools, ported from ``codec_eval_tpu/cli``.

Each runs as ``python -m codec_eval_tpu_torch.cli.<name>`` (``codec_iter``,
``codec_eval``, ``codec_compare``, ``rd_calibrate``, ``codec_analyze``)
and takes the JAX tool's arguments.  The commands that score or compute
heuristics also take ``--device``: they run on the card (``cuda``, the
default) unless ``--device cpu`` asks for the host.
"""

from __future__ import annotations

import argparse


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    """Give a scoring command ``parser`` its ``--device`` option."""
    parser.add_argument(
        "--device", default="cuda",
        help="where to score: the card (cuda, the default) or the host (cpu)",
    )
