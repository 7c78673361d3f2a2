"""Carry the JAX package's parameters and caches into the port, given as
numpy arrays (``jax.tree.map(np.asarray, params)``). It imports no JAX.

The reference stacks each stage's leaves on a leading axis; the port holds
one tuple of layer dicts (or cache entries) per stage, so that axis is
split here (an MoE layer's stacked expert leaves ``[n_stages, E_pad, ...]``
included; the port reads E_pad from the weights, so trees made with any
``tp_size`` carry across). bfloat16 leaves (numpy's ``ml_dtypes`` type) go through
float32, which is exact; every other leaf keeps its dtype (so Mamba's
``A_log``, ``D`` and ``dt_bias`` stay float32 in a bfloat16 model). The
walk is generic over the tree: MLA and Mamba leaves, a Mamba layer's
missing FFN and a frontend arch's ``frontend_proj`` carry across as they
are, and so do MLA's ``(c_kv, k_rope)`` and Mamba's ``(h, conv tail)``
cache entries.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.buffers import DeviceLike, resolve_device
from .config import ArchConfig
from .transformer import Cache, LanguageModel, split_pattern

__all__ = ["tensor_from_numpy", "params_from_numpy", "cache_from_numpy"]


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if str(arr.dtype) == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)  # a copy: jax's arrays are read-only


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _unstack(stages: Any, n_stages: int) -> list:
    """The reference's stacked stage tree -> one entry per stage."""
    if n_stages == 0 or stages is None:
        return []
    return [_map(stages, lambda a, i=i: np.asarray(a)[i]) for i in range(n_stages)]


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, *,
                      device: DeviceLike = "cuda") -> LanguageModel:
    """A :class:`LanguageModel` holding the reference's parameters."""
    dev = resolve_device(device)
    _, n_stages = split_pattern(cfg)
    to_t = lambda a: tensor_from_numpy(a, dev)  # noqa: E731
    port = {k: _map(v, to_t) for k, v in tree.items() if k not in ("prefix", "stages")}
    port["prefix"] = _map(list(tree["prefix"]), to_t)
    port["stages"] = [_map(tuple(s), to_t) for s in _unstack(tree["stages"], n_stages)]
    return LanguageModel(cfg, port)


def cache_from_numpy(cache: Dict[str, Any], cfg: ArchConfig, *,
                     device: DeviceLike = "cuda") -> Cache:
    """The port's cache layout (``init_cache``) holding the reference's
    cache values."""
    dev = resolve_device(device)
    _, n_stages = split_pattern(cfg)
    to_t = lambda a: tensor_from_numpy(a, dev)  # noqa: E731
    return {
        "prefix": [_map(tuple(e), to_t) for e in cache["prefix"]],
        "stages": [tuple(_map(tuple(e), to_t) for e in s)
                   for s in _unstack(cache["stages"], n_stages)],
    }
