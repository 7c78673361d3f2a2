"""Device milliseconds a step of the program's own span ``train.backward``
(``models/transformer.py:loss_and_grads``: ``loss.backward()``, each
stage's recompute included, and the gradients' tree): CUDA events the
program records with its tracing on (``acsbench/spans.py``:
``inside_steps``)."""

from acsbench.spans import span_ms


def read(run):
    return span_ms(getattr(run, "inside", None), "train.backward")
