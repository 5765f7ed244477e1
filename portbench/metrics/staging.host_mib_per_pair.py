"""staging.host_mib_per_pair: fresh host memory the session and the scorer
allocate to stage candidates (the program's ``staging.host_bytes``
counter) in the traced window, MiB per pair scored."""

from portbench.program import counter


def read(run):
    t = run.trace
    n = counter(run, "staging.host_bytes")
    return n / t.pairs / 2**20 if n is not None and t.pairs else None
