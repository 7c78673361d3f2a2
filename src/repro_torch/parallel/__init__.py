"""Distribution layer (PyTorch port of ``repro/parallel``): mesh axes,
per-arch sharding policies and spec trees, and the constraint model code
calls (``shard(x, "act_btd")``): a no-op without a mesh, a ``DTensor``
redistribution over one (``launch.mesh``)."""

from .axes import ShardingPolicy, current_policy, mesh_axes, placements, shard, use_policy
from .sharding import batch_specs, cache_specs, param_specs, policy_for

__all__ = [
    "ShardingPolicy", "current_policy", "shard", "use_policy", "placements", "mesh_axes",
    "param_specs", "batch_specs", "cache_specs", "policy_for",
]
