"""ladder.trellis_dp_ns_per_block: device time of the trellis DP's kernel
(K10, ``trellis_dp_kernel``) in the traced window, ns per block it
quantized there: the program's ``jpeg.trellis_blocks`` counter, blocks of
64 coefficients times qualities per launch.  None on a program without the
kernel or the counter."""

from portbench.program import counter

KERNEL = r"\btrellis_dp_kernel\b"


def read(run):
    blocks = counter(run, "jpeg.trellis_blocks")
    if not blocks:
        return None
    s = run.trace.time_matching([KERNEL])
    return s * 1e9 / blocks if s > 0 else None
