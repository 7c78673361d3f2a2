"""Device-idle milliseconds a profiled step in the gaps that began while
the host was inside the program's span ``train.forward`` (on any thread:
the forward's own range).
The steps are those the traced run profiles after its window
(``devtrace.profile_steps``), in which the program's spans open their
ranges; ``acsbench/spans.py``: ``idle_split``. None on a program
without the spans."""

from acsbench.spans import idle_ms


def read(run):
    return idle_ms(getattr(run, "profile", None), "train.forward")
