"""ladder.ops_per_pair: device operations (kernels, copies, fills) in the
traced window per pair it swept: the encoder, the trellis DP, the rate
statistics and the ladder's scoring."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.pairs:
        return None
    return len(t.device) / t.pairs
