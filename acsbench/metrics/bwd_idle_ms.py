"""Device-idle milliseconds a profiled step in the gaps that began while
the host was inside the program's span ``train.backward`` (on any thread:
the backward's own range, and the recompute's blocks on autograd's thread).
The steps are those the traced run profiles after its window
(``devtrace.profile_steps``), in which the program's spans open their
ranges; ``acsbench/spans.py``: ``idle_split``. None on a program
without the spans."""

from acsbench.spans import idle_ms


def read(run):
    return idle_ms(getattr(run, "profile", None), "train.backward")
