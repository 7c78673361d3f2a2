"""Distribution layer (PyTorch port of ``repro/parallel``): the sharding
context model code calls (``shard(x, "act_btd")``), a no-op on one card.
The reference's ``parallel/sharding.py`` (per-arch ``PartitionSpec`` trees
for TPU meshes) waits for a multi-GPU slice (ROADMAP)."""

from .axes import ShardingPolicy, current_policy, shard, use_policy

__all__ = ["ShardingPolicy", "current_policy", "shard", "use_policy"]
