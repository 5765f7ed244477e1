"""ladder.trellis_ms_per_pair: the program's ``ce.jpeg.trellis`` spans in
the traced window, host ms per pair: what the ladder's host thread spends
issuing the trellis DP's launches (63 dependent steps per plane) under the
profiler, which adds its own cost per recorded launch.  It is not the DP's
device time; a change that cuts the DP's launches moves it."""

from portbench.program import span_ms


def read(run):
    t = run.trace
    ms = span_ms(t, "ce.jpeg.trellis")
    return ms / t.pairs if ms is not None and t.pairs else None
