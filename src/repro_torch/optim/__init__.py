"""Optimizer substrate (PyTorch port of ``repro/optim``): AdamW with fp32
master weights, LR schedules (cosine and MiniCPM's WSD), global-norm
clipping, and error-feedback gradient compression. Each function takes
trees of tensors (``repro_torch.tree``). The reference's ``opt_specs``
(ZeRO-1 sharding of the optimizer state over a TPU mesh) waits for a
multi-GPU slice (ROADMAP)."""

from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .compression import ef_int8_compress, ef_int8_decompress, topk_compress
from .schedules import cosine_schedule, wsd_schedule

__all__ = [
    "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "wsd_schedule",
    "ef_int8_compress", "ef_int8_decompress", "topk_compress",
]
