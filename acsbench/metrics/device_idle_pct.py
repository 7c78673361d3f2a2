"""The share of the traced window's time in which no operation runs on the
device: one minus the window's device-busy seconds (the union of the
intervals of every device operation the window launched, recorded by
``devtrace.WindowTrace`` over the whole window) over the window's
seconds."""


def read(run):
    if getattr(run, "busy_s", None) is None or not run.window_s > 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
