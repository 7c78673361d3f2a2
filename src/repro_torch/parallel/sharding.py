"""Per-arch sharding rules (PyTorch port of ``repro/parallel/sharding.py``).

``policy_for(cfg, mesh)`` resolves the per-(arch, mesh) decisions:
heads, kv heads and experts shard over ``model`` when they divide;
otherwise attention falls back to sequence sharding and the (small)
attention weights are replicated. ``param_specs`` / ``batch_specs`` /
``cache_specs`` give spec trees (``parallel.axes``: one mesh-axis entry per
tensor dim) over the port's parameter and cache layouts, and
``axes.placements`` turns each into a ``DTensor``'s placements.

The port holds one tensor per layer in each stage (``stages`` a list of
one tuple of layer dicts per stage), not leaves stacked on a stage axis,
so a stage's leaf takes the reference's stacked spec without its leading
``None``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..models.config import ArchConfig
from .axes import ShardingPolicy, mesh_axes

__all__ = ["policy_for", "param_specs", "batch_specs", "cache_specs"]

Spec = Tuple[Any, ...]


def policy_for(cfg: ArchConfig, mesh, batch: Optional[int] = None) -> ShardingPolicy:
    """The policy of ``cfg`` on ``mesh`` (a ``DeviceMesh``, or any mesh
    with axis names and a shape); ``batch`` the cell's global batch, which
    the data axes may not divide (``long_500k``)."""
    axes = mesh_axes(mesh)
    tp = axes.get("model", 1)
    dp = tuple(a for a in axes if a != "model")
    dp_size = 1
    for a in dp:
        dp_size *= axes[a]
    return ShardingPolicy(
        dp=dp,
        tp="model",
        tp_size=tp,
        dp_size=dp_size,
        batch_shardable=batch is None or batch % dp_size == 0,
        shard_heads=cfg.eff_heads % tp == 0,
        shard_kv_heads=cfg.eff_kv_heads % tp == 0,
        shard_experts=cfg.moe is not None,  # experts are padded to E % tp == 0
        seq_shard_attn=cfg.eff_heads % tp != 0,
        mesh=mesh,
    )


# -- parameter tree ----------------------------------------------------------

def _leaf_spec(name: str, ndim: int, pol: ShardingPolicy) -> Spec:
    """Sharding rule for one (unstacked) parameter leaf by name and rank."""
    tp = pol.tp
    h = tp if pol.shard_heads else None
    kv = tp if pol.shard_kv_heads else None
    rules: Dict[Tuple[str, int], Spec] = {
        ("embed", 2): (tp, None),        # vocab-sharded embedding
        ("head", 2): (None, tp),
        ("frontend_proj", 2): (None, tp),
        ("norm", 1): (None,),
        ("ffn_norm", 1): (None,),
        ("final_norm", 1): (None,),
        # attention
        ("wq", 3): (None, h, None),
        ("wk", 3): (None, kv, None),
        ("wv", 3): (None, kv, None),
        ("wo", 2): (h, None),
        # MLA
        ("wq_a", 2): (None, None),
        ("wq_b", 3): (None, h, None),
        ("wkv_a", 2): (None, None),
        ("wkv_b", 3): (None, h, None),
        # dense FFN
        ("w_gate", 2): (None, tp),
        ("w_up", 2): (None, tp),
        ("w_down", 2): (tp, None),
        # MoE experts (E axis)
        ("router", 2): (None, None),
        ("w_gate", 3): (tp, None, None),
        ("w_up", 3): (tp, None, None),
        ("w_down", 3): (tp, None, None),
        # RG-LRU
        ("w_in", 2): (None, tp),
        ("w_gate_in", 2): (None, tp),
        ("conv_w", 2): (None, tp),
        ("wr", 2): (None, tp),
        ("wi", 2): (None, tp),
        ("a_log", 1): (tp,),
        ("w_out", 2): (tp, None),
        # Mamba
        ("x_proj", 2): (tp, None),
        ("dt_proj", 2): (None, tp),
        ("dt_bias", 1): (tp,),
        ("A_log", 2): (tp, None),
        ("D", 1): (tp,),
    }
    return rules.get((name, ndim), (None,) * ndim)


def _map_named(fn, tree: Any, name: str = "") -> Any:
    """``fn(name, leaf)`` over a tree of tensors, ``name`` the innermost
    string key above the leaf (list and tuple nodes keep the name)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    if tree is None:
        return None
    return fn(name, tree)


def param_specs(params: Any, pol: ShardingPolicy) -> Any:
    """A spec for each leaf of ``params`` (a ``LanguageModel`` or its
    ``param_tree()``, real, meta or fake tensors), in the same tree."""
    tree = params.param_tree() if hasattr(params, "param_tree") else params
    return _map_named(lambda name, leaf: _leaf_spec(name, leaf.dim(), pol), tree)


# -- step inputs ---------------------------------------------------------------

def batch_specs(cfg: ArchConfig, pol: ShardingPolicy, kind: str) -> Any:
    """Specs for (inputs, labels), or for the serving inputs."""
    dp = pol.dp if pol.batch_shardable else ()
    inputs = (dp, None, None) if cfg.frontend else (dp, None)  # embeddings or tokens
    if kind == "train":
        return inputs, (dp, None)
    return inputs


def cache_specs(cfg: ArchConfig, pol: ShardingPolicy) -> Dict[str, Any]:
    """Specs in ``transformer.init_cache``'s layout: ``{"prefix": [entry per
    layer], "stages": [one tuple of entries per stage]}``.

    A sharded dim must divide exactly, so ``wide`` takes the largest option
    that does: the folded (dp + tp) axes when the batch is unshardable,
    else tp, else none.
    """
    from ..models.transformer import split_pattern

    tp = pol.tp
    dp = pol.dp if pol.batch_shardable else ()
    tp_total = pol.tp_size * (1 if pol.batch_shardable else pol.dp_size)

    def wide(dim: int):
        if not pol.batch_shardable and dim % tp_total == 0:
            return pol.dp + (tp,)
        if dim % max(pol.tp_size, 1) == 0:
            return tp
        return None

    def entry(kind: str):
        if kind in ("attn_global", "attn_local"):
            # as the reference: the row count is the window where the arch
            # has one (the callers size local caches at min(window, seq) ==
            # window), else unbounded
            rows = cfg.window or 1 << 30
            if pol.shard_kv_heads:
                kv = (dp, tp, None, None)
            else:
                kv = (dp, None, wide(rows), None)
            return (kv, kv)
        if kind == "mla":
            c = (dp, None, None)
            return (c, c)
        if kind == "rglru":
            w = cfg.rglru_width or cfg.d_model
            return ((dp, wide(w)), (dp, None, wide(w)))
        if kind == "mamba":
            di = cfg.expand * cfg.d_model
            return ((dp, wide(di), None), (dp, None, wide(di)))
        raise ValueError(kind)

    prefix, n_stages = split_pattern(cfg)
    return {
        "prefix": [entry(k) for k in prefix],
        "stages": [tuple(entry(k) for k in cfg.pattern_unit) for _ in range(n_stages)],
    }
