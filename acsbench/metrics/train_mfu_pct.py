"""Model FLOPs a step (``counts/model.py``: no recompute) over the traced
window's mean step time, as a share of the card's bf16 dense peak."""

from acsbench.harness import counts


def read(run):
    if not getattr(run, "steps", 0) or not hasattr(run, "spec"):
        return None
    step_s = run.window_s / run.steps
    flops = counts("model").train_flops(run.spec, run.batch, run.seq)
    return 100.0 * flops / step_s / counts("peaks").BF16_FLOP_S
