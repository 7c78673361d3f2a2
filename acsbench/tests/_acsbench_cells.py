"""Tiny versions of the benchmark's train cells for the CPU tests: the
configuration and traffic files as committed, with the sizes cut."""

from __future__ import annotations

import torch

from acsbench import harness
from acsbench.kinds import train

TINY = {
    "granite-moe.train": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                              vocab=250, n_experts=4, top_k=2, d_expert=32),
    "minicpm.train": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                          vocab=250, d_ff=128),
}


def tiny_cell(name: str, *, seed: int = 7, dtype: str = "float32", seconds: float = 0.2,
              batch: int = 2, seq: int = 16, optimizer=None) -> train.Cell:
    """The cell ``name`` cut to the tiny sizes; ``optimizer`` overrides
    keys of the traffic's optimizer."""
    found = harness.find_cell(harness.load_benchmark(), name)
    traffic = dict(found["traffic"], batches=8)
    traffic["optimizer"] = dict(traffic["optimizer"], **(optimizer or {}))
    return train.Cell(config=found["config"], traffic=traffic,
                      seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
                      sizes=dict(TINY[name], dtype=dtype, batch=batch, seq=seq))
