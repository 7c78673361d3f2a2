"""Sharding context (PyTorch port of ``repro/parallel/axes.py``): model
code names *semantic* constraints (``shard(x, "act_btd")``) and the active
:class:`ShardingPolicy` says how each kind lies over the mesh's axes. The
port runs on one card and has no mesh yet, so every constraint is a no-op
and ``shard`` returns its tensor; a policy that names a mesh raises, until
a multi-GPU slice places tensors over one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Tuple

__all__ = ["ShardingPolicy", "use_policy", "current_policy", "shard"]

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
    mesh: Optional[Any] = None   # a device mesh; None on one card

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


def shard(x, kind: str):
    """Apply the active policy's constraint for ``kind``: ``x`` itself
    without a policy or a mesh (one card)."""
    policy = current_policy()
    if policy is None or policy.mesh is None:
        return x
    policy.spec(kind)  # an unknown kind raises, as in the reference
    raise NotImplementedError("shard: sharding over a mesh of cards is still to port "
                              "(ROADMAP: parallel/sharding.py)")
