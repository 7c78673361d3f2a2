"""LM model stack (PyTorch port of ``repro/models``): GQA (global and
sliding-window), MLA, RG-LRU and Mamba layers with dense gated or MoE FFNs,
and the audio and vision frontend stubs, as ``nn.Module``s behind the
reference's functional entry names, ``loss_fn`` (the training loss) among
them. ``convert`` carries weights, caches and AdamW state across from the
JAX package's numpy trees and back."""

from .config import ArchConfig, MLAConfig, MoEConfig
from .convert import (cache_from_numpy, opt_state_from_numpy, opt_state_to_numpy,
                      params_from_numpy, params_to_numpy)
from .transformer import (
    FRONTEND_DIMS,
    LAYER_KINDS,
    Block,
    LanguageModel,
    LayerKind,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_and_grads,
    loss_fn,
    pad_vocab,
    layer_kind,
    prefill,
    split_pattern,
)

__all__ = [
    "ArchConfig", "MLAConfig", "MoEConfig",
    "FRONTEND_DIMS", "LAYER_KINDS", "Block", "LanguageModel", "LayerKind", "layer_kind",
    "cache_from_numpy", "params_from_numpy", "params_to_numpy", "opt_state_from_numpy",
    "opt_state_to_numpy",
    "decode_step", "forward", "init_cache", "init_params", "loss_and_grads", "loss_fn",
    "pad_vocab", "prefill", "split_pattern",
]
