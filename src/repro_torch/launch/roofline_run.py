"""Useful-FLOPs accounting (PyTorch port of
``repro/launch/roofline_run.model_flops_per_device``): 6 N D for a train
step (N_active for MoE), 2 N D for a forward, per device, from which a
step's model FLOP utilization (MFU) is read against
``roofline.PEAK_FLOPS``. The reference's script around it (XLA lowerings
of every arch and shape, ``results/roofline.json``) is a tool of XLA and
is not ported (ROADMAP)."""

from __future__ import annotations

from typing import Dict, Tuple

from ..configs import SHAPES

__all__ = ["model_flops_per_device"]


def model_flops_per_device(cfg, shape_name: str, n_devices: int,
                           shapes: Dict[str, Tuple[int, int, str]] = SHAPES) -> float:
    """6*N*D useful-FLOPs accounting (N_active for MoE), per device, for a
    cell of ``shapes`` ((seq, batch, kind) by name; the assigned grid by
    default)."""
    seq, batch, kind = shapes[shape_name]
    n = cfg.n_active_params if cfg.moe is not None else cfg.n_params
    if kind == "train":
        tokens = seq * batch          # fwd+bwd: 6 N D
        factor = 6.0
    elif kind == "prefill":
        tokens = seq * batch          # fwd only: 2 N D
        factor = 2.0
    else:  # decode: one token per sequence
        tokens = batch
        factor = 2.0
    return factor * n * tokens / n_devices
