"""ladder.wait_ms_per_pair: host ms per pair in the traced window that the
ladder runner waits for the device: the CUDA runtime's synchronising calls
inside its ``ce.ladder.sweep`` spans (each image's and table's synchronous
copy to the device, each chunk's fetch of scores and statistics)."""

from portbench.program import wait_ms


def read(run):
    t = run.trace
    ms = wait_ms(t, "ce.ladder.sweep")
    return ms / t.pairs if ms is not None and t.pairs else None
