"""LM model stack (PyTorch port of ``repro/models``): GQA (global and
sliding-window) and RG-LRU layers with dense gated or MoE FFNs, as
``nn.Module``s behind the reference's functional entry names. MLA, Mamba,
the frontends and ``loss_fn`` are still to port (ROADMAP queue 1 item 9)."""

from .config import ArchConfig, MLAConfig, MoEConfig
from .convert import cache_from_numpy, params_from_numpy
from .transformer import (
    Block,
    LanguageModel,
    decode_step,
    forward,
    init_cache,
    init_params,
    pad_vocab,
    prefill,
    split_pattern,
)

__all__ = [
    "ArchConfig", "MLAConfig", "MoEConfig",
    "Block", "LanguageModel",
    "cache_from_numpy", "params_from_numpy",
    "decode_step", "forward", "init_cache", "init_params",
    "pad_vocab", "prefill", "split_pattern",
]
