"""Device milliseconds a step of the program's own span ``train.forward``
(``models/transformer.py:loss_and_grads``, around ``loss_fn``): CUDA events
the program records with its tracing on, in steps run with it on
(``acsbench/spans.py``: ``inside_steps``)."""

from acsbench.spans import span_ms


def read(run):
    return span_ms(getattr(run, "inside", None), "train.forward")
