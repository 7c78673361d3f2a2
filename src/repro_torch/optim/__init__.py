"""Optimizer substrate (PyTorch port of ``repro/optim``): AdamW with fp32
master weights, LR schedules (cosine and MiniCPM's WSD), global-norm
clipping (both on plain tensors through ``kernels/adamw.py``),
error-feedback gradient compression, and ``opt_specs``: ZeRO-1 sharding of
the optimizer state over the data axes of a mesh. Each function takes
trees of tensors (``repro_torch.tree``)."""

from .adamw import ScaledGrads, adamw_init, adamw_update, clip_by_global_norm, opt_specs
from .compression import ef_int8_compress, ef_int8_decompress, topk_compress
from .schedules import cosine_schedule, wsd_schedule

__all__ = [
    "ScaledGrads", "adamw_init", "adamw_update", "clip_by_global_norm", "opt_specs",
    "cosine_schedule", "wsd_schedule",
    "ef_int8_compress", "ef_int8_decompress", "topk_compress",
]
