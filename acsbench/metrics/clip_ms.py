"""Device milliseconds a step of the program's own span ``optim.clip``
(``optim/adamw.py:clip_by_global_norm``): CUDA events the program records
with its tracing on (``acsbench/spans.py``: ``inside_steps``)."""

from acsbench.spans import span_ms


def read(run):
    return span_ms(getattr(run, "inside", None), "optim.clip")
