"""The grouped GEMM's calls in the profiled steps (forward, and the
backward's dx and dw) against their least time (``counts/grouped_matmul.py``),
as a share of the device time the calls took."""

from acsbench.harness import counts, op_share


def read(run):
    c = counts("grouped_matmul")
    return op_share(run, (c.FWD, c.BWD), c.bound_s)
