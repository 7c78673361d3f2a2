"""Sharding context (PyTorch port of ``repro/parallel/axes.py``): model
code names *semantic* constraints (``shard(x, "act_btd")``) and the active
:class:`ShardingPolicy` says how each kind lies over the mesh's axes.
Without a policy, or with one that names no mesh (one card), every
constraint is a no-op and ``shard`` returns its tensor. Under a policy
over a ``DeviceMesh`` a ``DTensor`` is redistributed to the kind's
placements (the counterpart of ``with_sharding_constraint``), its
gradient to the same in the backward, and a plain tensor raises: on a
mesh the model's activations are DTensors.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names (the dim sharded over several mesh axes, in mesh order), or
``None``; :func:`placements` turns it into a ``DTensor``'s placements.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["ShardingPolicy", "use_policy", "current_policy", "shard", "placements",
           "mesh_axes"]

_TLS = threading.local()


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Resolved per-(arch, mesh) sharding decisions, as the reference's."""

    dp: Tuple[str, ...]          # data-parallel mesh axes, e.g. ("pod", "data")
    tp: str = "model"            # tensor-parallel axis
    shard_heads: bool = True     # H % tp_size == 0
    shard_kv_heads: bool = True  # Hkv % tp_size == 0
    shard_experts: bool = True   # (padded) E % tp_size == 0
    seq_shard_attn: bool = False # fallback: shard attention over sequence
    tp_size: int = 1
    dp_size: int = 1
    batch_shardable: bool = True
    mesh: Optional[Any] = None   # a DeviceMesh (or any named mesh); None on one card

    def spec(self, kind: str) -> Tuple[Any, ...]:
        """The mesh axes of each dimension of a tensor of ``kind`` (a
        ``PartitionSpec``'s entries in the reference)."""
        tp = self.tp
        dp = self.dp if self.batch_shardable else ()
        tpw = tp if self.batch_shardable else self.dp + (tp,)
        heads = lambda shard_it: ((dp, tp, None, None) if shard_it  # noqa: E731
                                  else (dp, None, tp, None) if self.seq_shard_attn
                                  else (dp, None, None, None))
        table = {
            "act_btd": (dp, None, None),
            "ffn_hidden": (dp, None, tpw),
            "logits": (dp, None, tpw),
            "heads": heads(self.shard_heads),
            "kv_heads": heads(self.shard_kv_heads),
            "kv_cache": (dp, tp, None, None) if self.shard_kv_heads else (dp, None, tpw, None),
            "experts_gecd": (dp, tp, None, None) if self.shard_experts else (dp, None, None, None),
            "experts_gec": (dp, tp, None) if self.shard_experts else (dp, None, None),
            "channels": (dp, None, tpw),
            "state_bw": (dp, tpw),
            "tokens": (dp, None),
        }
        return table[kind]


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    prev = getattr(_TLS, "policy", None)
    _TLS.policy = policy
    try:
        yield
    finally:
        _TLS.policy = prev


def current_policy() -> Optional[ShardingPolicy]:
    return getattr(_TLS, "policy", None)


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``) or of any mesh with ``axis_names`` and ``devices.shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Tuple[Any, ...], mesh) -> Tuple[Any, ...]:
    """A spec's ``DTensor`` placements on ``mesh``: ``Shard(d)`` on each
    mesh dim the spec names at tensor dim ``d``, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, entry in enumerate(spec):
        for name in _names(entry):
            where[name] = d
    return tuple(Shard(where[name]) if name in where else Replicate()
                 for name in mesh_axes(mesh))


def shard(x, kind: str):
    """Apply the active policy's constraint for ``kind``: ``x`` itself
    without a policy or a mesh (one card), else ``x`` (a ``DTensor``)
    redistributed to the kind's placements."""
    policy = current_policy()
    if policy is None or policy.mesh is None:
        return x
    spec = policy.spec(kind)  # an unknown kind raises, as in the reference
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"shard({kind!r}): under a mesh policy the model's tensors are "
                        f"DTensors, got a plain {type(x).__name__}")
    want = placements(spec, policy.mesh)
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Constrain.apply(x, want)


class _Constrain(torch.autograd.Function):
    """A sharding constraint on a DTensor and on its gradient, as
    ``with_sharding_constraint`` constrains the cotangent too: without it a
    gradient may stay partial across ``model`` and DTensor then gathers
    weights to multiply it, repeating the product on every rank."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.want), None
