"""Host milliseconds inside the train step's call up to its return, before
the host read of its loss: the mean over the traced window's steps."""

import statistics


def read(run):
    ms = getattr(run, "host_step_ms", None)
    return statistics.fmean(ms) if ms else None
