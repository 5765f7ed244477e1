"""The check that a run loaded neither JAX nor the JAX package: every module
in ``sys.modules`` is judged by its top-level name (before the first dot),
compared whole, so ``codec_eval_tpu_torch`` is not ``codec_eval_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "codec_eval_tpu"})


def forbidden_modules(names: Iterable[str] | None = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
