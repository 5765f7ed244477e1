"""setup_s: process start to the first timed call (imports, CUDA context,
the kernel library, the inputs from the seed, the warm-up calls)."""


def read(run):
    return run.setup_s
