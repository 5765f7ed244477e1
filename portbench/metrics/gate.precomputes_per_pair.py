"""gate.precomputes_per_pair: reference precomputes built (the program's
``scorer.precompute_miss`` counter) per gate call in the traced window;
0 where every call found its reference's precompute cached."""

from portbench.program import counter


def read(run):
    t = run.trace
    miss = counter(run, "scorer.precompute_miss")
    hit = counter(run, "scorer.precompute_hit")
    if (miss is None and hit is None) or not t.calls:
        return None
    return (miss or 0) / t.calls
