"""Assigned architecture registry: ``get_config(name)`` / ``--arch <id>``
(a copy of ``repro/configs/``: pure data, no JAX).

The port builds all ten: GQA global and local attention, MLA, RG-LRU,
Mamba, dense and MoE FFN, and the two frontends' projections
(``models.init_params`` takes every config; the servers refuse the
frontend archs, whose inputs are embeddings, not tokens).

Each module defines ``CONFIG`` with the exact published configuration
(sources inline). ``SHAPES`` defines the assigned input-shape grid and
``cells(cfg)`` the applicable (shape -> step kind) set, with long_500k
restricted to sub-quadratic archs (DESIGN.md §5).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..models.config import ArchConfig

from . import (
    deepseek_v2_236b,
    falcon_mamba_7b,
    gemma2_27b,
    granite_moe_3b_a800m,
    h2o_danube_3_4b,
    minicpm_2b,
    mistral_large_123b,
    musicgen_large,
    paligemma_3b,
    recurrentgemma_2b,
)

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        musicgen_large, recurrentgemma_2b, falcon_mamba_7b, deepseek_v2_236b,
        granite_moe_3b_a800m, minicpm_2b, mistral_large_123b, h2o_danube_3_4b,
        gemma2_27b, paligemma_3b,
    )
}

# (shape name, seq_len, global_batch, step kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(cfg: ArchConfig) -> List[str]:
    """Applicable shapes for this arch (skips noted in DESIGN.md §5)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


__all__ = ["ARCHS", "SHAPES", "get_config", "cells"]
