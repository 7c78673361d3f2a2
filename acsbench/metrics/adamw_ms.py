"""Device milliseconds a step of the program's own span ``optim.adamw``
(``optim/adamw.py:adamw_update``): CUDA events the program records with
its tracing on (``acsbench/spans.py``: ``inside_steps``)."""

from acsbench.spans import span_ms


def read(run):
    return span_ms(getattr(run, "inside", None), "optim.adamw")
