"""session.batch_ms_per_image: the program's ``ce.session.batch`` spans
(the session's stack of the decoded candidates into one host batch, and
the reference's pixels) in the traced window, host ms per traced call."""

from portbench.program import span_ms


def read(run):
    t = run.trace
    ms = span_ms(t, "ce.session.batch")
    return ms / t.calls if ms is not None and t.calls else None
