"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root.  Tests marked ``chip`` need a CUDA device and skip
without one; ``python -m pytest portbench/tests -m chip`` runs them on the card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")
