"""device.idle_pct: share of a timed call's wall time in which no kernel or
copy ran on the card, %: 1 - (device busy seconds per traced call, from the
profiler's CUDA activity) / (the window's wall seconds per call, untraced).
The traced calls' own wall is not the denominator: the profiler records
every operator on the host, which stretches a host-bound call (the gate's
~1,700 launches per call about twofold)."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.calls or not run.calls:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.calls) / (run.window_s / len(run.calls)))
