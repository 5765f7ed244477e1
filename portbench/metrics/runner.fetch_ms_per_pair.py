"""runner.fetch_ms_per_pair: host ms per pair scored in the traced window
that the corpus runner waits for the device: its ``ce.runner.fetch`` spans
(the reads of each chunk's scores) and, inside its ``ce.runner.bucket``
spans, the CUDA runtime's synchronising calls, where the step's pageable
copies to the device hold the host until the device's queue drains."""

from portbench.program import span_ms, wait_ms


def read(run):
    t = run.trace
    fetch = span_ms(t, "ce.runner.fetch")
    if fetch is None or not t.pairs:
        return None
    return (fetch + (wait_ms(t, "ce.runner.bucket") or 0.0)) / t.pairs
