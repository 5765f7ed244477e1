"""pairs_per_s: every candidate pair scored by the window's completed
calls, over the window's elapsed time (the window ends with its last call)."""


def read(run):
    pairs = sum(c.pairs for c in run.ok_calls)
    return pairs / run.window_s if pairs else None
