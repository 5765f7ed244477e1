"""scorer.stage_ms_per_pair: the program's ``ce.scorer.stage`` spans (the
candidates' planar host copy and its copy to the device) in the traced
window, host ms per pair scored."""

from portbench.program import span_ms


def read(run):
    t = run.trace
    ms = span_ms(t, "ce.scorer.stage")
    return ms / t.pairs if ms is not None and t.pairs else None
