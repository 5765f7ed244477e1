"""pair_p95_ms: the 95th percentile, over every gate call of the window,
of the call's time (a threshold miss is a completed gate)."""

import numpy as np


def read(run):
    times = [(c.t1 - c.t0) * 1e3 for c in run.ok_calls]
    return float(np.percentile(times, 95)) if times else None
