"""Device milliseconds from the start of the gradient clip to the end of
the AdamW update, CUDA events, the mean over the traced window's steps."""

import statistics


def read(run):
    ms = getattr(run, "span_ms", {}).get("optim")
    return statistics.fmean(ms) if ms else None
