"""kernels.roofline_pct: the hand-written kernels' share of their roofline
in the traced window, 100 x (sum of the bounds of their work) / (sum of
their device time).  The work of each wrapper call is counted from its
shapes by the frozen counts (yardstick/counts.py); the kernels are found
in the device trace by the work table (yardstick/kernel_work.json).  Only
work whose kernels ran and whose calls were recorded counts, on both sides."""

from portbench.spans import load_work_table


def read(run):
    t = run.trace
    if t is None:
        return None
    bound_ms, time_s = 0.0, 0.0
    for work, spec in load_work_table().items():
        spent = t.time_matching(spec["kernels"])
        if spent > 0 and work in t.bounds:
            bound_ms += t.bounds[work][0]
            time_s += spent
    return 100.0 * bound_ms * 1e-3 / time_s if time_s > 0 else None
