"""ladder.sizes_ms_per_pair: the program's ``ce.ladder.sizes`` spans (the
host's Huffman tables and size estimates from each chunk's fetched rate
statistics) in the traced window, host ms per pair."""

from portbench.program import span_ms


def read(run):
    t = run.trace
    ms = span_ms(t, "ce.ladder.sizes")
    return ms / t.pairs if ms is not None and t.pairs else None
