"""Cells cut to a size a CPU test run holds: 64 px (96 px long side for the
mixed sizes), two images, seven qualities."""

import dataclasses
import time

from portbench.harness import load_cell, run_cell

TINY = dict(images=2, height=64, width=64, long_side=96, qualities=[30, 90, 10])
CELLS = ("cid22-512.session", "clic2025-2048.session", "cid22-512.ci-gate",
         "clic2025-2048.masked-corpus")


def tiny_cell(name: str):
    cell = load_cell(name)
    return dataclasses.replace(cell, config={**cell.config, **TINY})


def tiny_run(name: str, seed: int = 2**31 + 5, seconds: float = 0.3, trace: bool = False):
    return run_cell(tiny_cell(name), seed, seconds, trace, time.perf_counter(), device="cpu")
