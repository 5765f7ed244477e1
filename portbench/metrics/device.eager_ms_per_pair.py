"""device.eager_ms_per_pair: device time per pair outside the hand-written
kernels (ATen elementwise ops, GEMMs, sorts, copies) in the traced window, ms."""

import re

from portbench.spans import load_work_table


def read(run):
    t = run.trace
    if t is None or not t.device or not t.pairs:
        return None
    rx = [re.compile(p) for spec in load_work_table().values() for p in spec["kernels"]]
    eager = sum(e - s for name, s, e in t.device if not any(r.search(name) for r in rx))
    return eager * 1e-3 / t.pairs
