"""image_p95_ms: the 95th percentile, over every call of the window, of an
image's time from the call to its returned report."""

import numpy as np


def read(run):
    times = [(c.t1 - c.t0) * 1e3 for c in run.ok_calls]
    return float(np.percentile(times, 95)) if times else None
