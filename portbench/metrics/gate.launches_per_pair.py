"""gate.launches_per_pair: CUDA kernels launched per gate call in the
traced window (copies and fills not counted)."""


def read(run):
    t = run.trace
    if t is None or not t.device or not t.calls:
        return None
    return len(t.kernels()) / t.calls
