"""Carry the JAX package's parameters, caches and AdamW state into the
port, given as numpy arrays (``jax.tree.map(np.asarray, params)``), and the
port's parameters and AdamW state back out in the reference's layout. It
imports no JAX.

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

The way back (``params_to_numpy``, ``opt_state_to_numpy``,
``tree_to_numpy``) stacks each stage's leaves on a leading axis again, as
the reference holds them (``stages`` is ``None`` for a config with no
stage), and writes bfloat16 leaves as float32 numpy arrays (exact; numpy
has no bfloat16 of its own). AdamW's ``master``, ``m`` and ``v`` share
the params' tree, so one conversion serves all four. The checkpoints use
this layout, which is how a checkpoint either package writes restores in
the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.buffers import DeviceLike, resolve_device
from ..tree import tree_map
from .config import ArchConfig
from .transformer import Cache, LanguageModel, split_pattern

__all__ = ["tensor_from_numpy", "params_from_numpy", "cache_from_numpy", "tree_from_numpy",
           "tree_to_numpy", "params_to_numpy", "load_params_", "opt_state_from_numpy",
           "opt_state_to_numpy"]


def tensor_from_numpy(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if str(arr.dtype) == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)  # a copy: jax's arrays are read-only


def _unstack(stages: Any, n_stages: int) -> list:
    """The reference's stacked stage tree -> one entry per stage."""
    if n_stages == 0 or stages is None:
        return []
    return [tree_map(lambda a, i=i: np.asarray(a)[i], stages) for i in range(n_stages)]


def _port_layout(tree: Dict[str, Any], n_stages: int) -> Dict[str, Any]:
    """The reference's params-shaped tree with its stages split: ``prefix``
    a list, ``stages`` a list of one tuple of layer dicts per stage."""
    port = {k: v for k, v in tree.items() if k not in ("prefix", "stages")}
    port["prefix"] = list(tree["prefix"])
    port["stages"] = [tuple(s) for s in _unstack(tree["stages"], n_stages)]
    return port


def tree_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, *,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A params-shaped numpy tree of the reference as tensors in the
    port's layout (``LanguageModel.param_tree``'s)."""
    dev = resolve_device(device)
    _, n_stages = split_pattern(cfg)
    return tree_map(lambda a: tensor_from_numpy(a, dev), _port_layout(tree, n_stages))


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig, *,
                      device: DeviceLike = "cuda") -> LanguageModel:
    """A :class:`LanguageModel` holding the reference's parameters."""
    return LanguageModel(cfg, tree_from_numpy(tree, cfg, device=device))


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_stack([t[i] for t in trees]) for i in range(len(trees[0])))
    return np.stack(trees)


def tree_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A params-shaped tree in the port's layout (``param_tree``'s) as the
    reference's numpy tree: stages stacked, bfloat16 as float32."""
    out = {k: tree_map(_leaf_to_numpy, v) for k, v in tree.items()
           if k not in ("prefix", "stages")}
    out["prefix"] = [tree_map(_leaf_to_numpy, layer) for layer in tree["prefix"]]
    stages = [tree_map(_leaf_to_numpy, stage) for stage in tree["stages"]]
    out["stages"] = _stack(stages) if stages else None
    return out


def params_to_numpy(model: LanguageModel) -> Dict[str, Any]:
    """The model's parameters as the reference's numpy tree: the inverse
    of :func:`params_from_numpy` (bfloat16 weights come back as float32)."""
    return tree_to_numpy(model.param_tree())


def _zip(port: Any, ref: Any, fn) -> None:
    if isinstance(port, dict):
        if set(port) != set(ref):
            raise ValueError(f"tree keys differ: {sorted(port)} and {sorted(ref)}")
        for k in port:
            _zip(port[k], ref[k], fn)
    elif isinstance(port, (list, tuple)):
        if len(port) != len(ref):
            raise ValueError(f"tree lengths differ: {len(port)} and {len(ref)}")
        for a, b in zip(port, ref):
            _zip(a, b, fn)
    else:
        fn(port, ref)


@torch.no_grad()
def load_params_(model: LanguageModel, tree: Dict[str, Any]) -> LanguageModel:
    """Write the reference's numpy weights into ``model``'s parameters in
    place, each cast to its parameter's dtype. Returns ``model``."""
    _, n_stages = split_pattern(model.cfg)

    def load(param: torch.Tensor, arr: Any) -> None:
        if tuple(param.shape) != tuple(np.shape(arr)):
            raise ValueError(f"weight shape {tuple(np.shape(arr))} != {tuple(param.shape)}")
        param.copy_(tensor_from_numpy(arr, param.device))

    _zip(model.param_tree(), _port_layout(tree, n_stages), load)
    return model


def opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """AdamW's state (``optim.adamw_init``'s, over a model's
    ``param_tree``) as the reference's: step an int32 scalar, master, m
    and v params-shaped numpy trees."""
    return {"step": np.asarray(int(state["step"]), dtype=np.int32),
            **{k: tree_to_numpy(state[k]) for k in ("master", "m", "v")}}


def opt_state_from_numpy(state: Dict[str, Any], cfg: ArchConfig, *,
                         device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The reference's AdamW state as the port's, on ``device``."""
    dev = resolve_device(device)
    out = {k: tree_from_numpy(state[k], cfg, device=dev) for k in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)
    return out


def cache_from_numpy(cache: Dict[str, Any], cfg: ArchConfig, *,
                     device: DeviceLike = "cuda") -> Cache:
    """The port's cache layout (``init_cache``) holding the reference's
    cache values."""
    dev = resolve_device(device)
    _, n_stages = split_pattern(cfg)
    to_t = lambda a: tensor_from_numpy(a, dev)  # noqa: E731
    return {
        "prefix": [tree_map(to_t, tuple(e)) for e in cache["prefix"]],
        "stages": [tuple(tree_map(to_t, tuple(e)) for e in s)
                   for s in _unstack(cache["stages"], n_stages)],
    }
