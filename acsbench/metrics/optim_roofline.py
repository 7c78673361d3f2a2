"""The clip and the AdamW update against their least bytes at the card's
memory peak (``counts/adamw.py``), as a share of ``optim_ms``."""

from acsbench.harness import counts, per_layer


def read(run):
    ms = per_layer("optim_ms", run)
    if not ms or not getattr(run, "leaves", None):
        return None
    return 100.0 * counts("adamw").bound_s(run.leaves) / (ms / 1e3)
