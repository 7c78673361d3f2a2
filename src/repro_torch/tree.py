"""Nested containers of tensors ("trees"), as ``jax.tree_util`` walks them:
a dict is a node whose children come in sorted key order, a list or tuple
a node in index order, ``None`` a node with no leaves, and anything else a
leaf. The optimizer, the gradient compression and the checkpoints use this
order, so a checkpoint's leaves come in the reference's order under the
reference's names."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_names"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), called in the leaves' order;
    the result has that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves_with_names(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in the reference's order, each name the path's
    keys and indices joined by ``/`` (``"root"`` for a bare leaf), as the
    reference's checkpoint manager names them."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_leaves_with_names(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree)
                for pair in tree_leaves_with_names(t, f"{prefix}/{i}" if prefix else str(i))]
    if tree is None:
        return []
    return [(prefix or "root", tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_names(tree)]
