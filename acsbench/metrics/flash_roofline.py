"""Flash attention's calls in the profiled steps (the forward with its
log-sum-exp, and every pass of the backward) against their least time
(``counts/flash_attention.py``), as a share of the device time the calls
took."""

from acsbench.harness import counts, op_share


def read(run):
    c = counts("flash_attention")
    return op_share(run, (c.FWD, c.BWD), c.bound_s)
