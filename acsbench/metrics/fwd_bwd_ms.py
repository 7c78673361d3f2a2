"""Device milliseconds from the start to the end of ``loss_and_grads`` (the
forward, the loss and the backward), CUDA events, the mean over the traced
window's steps."""

import statistics


def read(run):
    ms = getattr(run, "span_ms", {}).get("loss_and_grads")
    return statistics.fmean(ms) if ms else None
