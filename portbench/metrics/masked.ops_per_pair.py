"""masked.ops_per_pair: device operations (kernels, copies, fills) in the
traced window per pair it scored."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.pairs:
        return None
    return len(t.device) / t.pairs
