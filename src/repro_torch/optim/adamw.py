"""AdamW with fp32 master weights over bf16 (or fp32) compute params
(PyTorch port of ``repro/optim/adamw.py``).

The state is the reference's: ``{"step", "master", "m", "v"}``, with
master, m and v trees of the params' structure. The update is the
reference's formula, weight decay inside the step
(``master - lr * (mh / (sqrt(vh) + eps) + wd * master)``), not
``torch.optim.AdamW``'s decoupled decay, which rounds differently. It runs
in place: the params, master, m, v and step are updated where they lie, so
a 2.7 B-parameter model's state (32.7 GB of float32 master, m and v) is
never held twice, as a functional update would hold it.

The clip returns :class:`ScaledGrads` (the gradients as given and the
clip's scale) in place of a float32 copy of every gradient, and the update
applies the scale as it reads each gradient. Both steps run in
``kernels/adamw.py``: on plain CUDA tensors its multi-tensor kernels (two
launches for the norm, one for the update, whatever the number of leaves),
on CPU tensors and DTensors its plain per-leaf version; over a mesh the
norm takes one all-reduce a mesh axis.

``opt_specs`` is ZeRO-1 over a mesh: master, m and v take their
parameter's spec and are also sharded over the data axes along the first
unsharded dim that those axes divide, since the state is only needed
shard by shard at the update."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import trace
from ..kernels import adamw as fused
from ..tree import tree_leaves, tree_map

__all__ = ["ScaledGrads", "adamw_init", "adamw_update", "clip_by_global_norm", "opt_specs"]


def adamw_init(params: Any) -> Dict[str, Any]:
    """Fresh state for a tree of params: the float32 master a copy (also
    where the params are float32 already), m and v zeros."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


class ScaledGrads:
    """The clip's result: the gradient tree as given and ``scale`` (a 0-d
    float32 tensor, or DTensor, on its device), which :func:`adamw_update`
    applies as it reads each gradient."""

    __slots__ = ("grads", "scale")

    def __init__(self, grads: Any, scale: torch.Tensor) -> None:
        self.grads = grads
        self.scale = scale

    def materialize(self) -> Any:
        """The scaled gradients as a float32 tree (a copy of every leaf)."""
        return tree_map(lambda g: g.float() * self.scale, self.grads)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(ScaledGrads(grads, min(1, max_norm / (norm + 1e-9))), norm)``, the
    norm over every leaf in float32; nothing is copied. Over DTensors
    sharded or replicated on one mesh (no partial sums left) the sum of
    squares is each rank's over its own shards, each leaf's divided by the
    ranks that hold copies of its shard, then summed across the mesh once."""
    with trace.span("optim.clip"):
        leaves = tree_leaves(grads)
        sq = _sharded_sum_of_squares(leaves)
        if sq is None:  # the kernels on plain CUDA tensors, else the plain version
            gnorm, scale = fused.global_norm(leaves, max_norm)
        else:
            gnorm = torch.sqrt(sq)
            scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
        return ScaledGrads(grads, scale), gnorm


def _sharded_sum_of_squares(leaves) -> Any:
    """The global sum of squares of DTensor ``leaves`` laid out by ``Shard``
    and ``Replicate`` on one mesh, as a replicated DTensor, with one
    all-reduce a mesh axis; None where the leaves are not such DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not leaves or not all(isinstance(g, DTensor) for g in leaves):
        return None
    mesh = leaves[0].device_mesh
    if any(g.device_mesh != mesh or not all(isinstance(p, (Shard, Replicate))
                                            for p in g.placements) for g in leaves):
        return None
    local = torch.zeros((), dtype=torch.float32, device=leaves[0].to_local().device)
    for g in leaves:
        copies = 1
        for size, p in zip(mesh.shape, g.placements):
            if isinstance(p, Replicate):
                copies *= size
        local = local + torch.sum(torch.square(g.to_local().float())) / copies
    partial = DTensor.from_local(local, mesh, [Partial("sum")] * mesh.ndim, run_check=False)
    return partial.redistribute(mesh, [Replicate()] * mesh.ndim)


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    state: Dict[str, Any],
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step, in place on ``params`` (each the rounding of its new
    master to its dtype) and ``state``; ``grads`` a tree or the clip's
    :class:`ScaledGrads`; ``lr`` a float or 0-d tensor. Returns ``(params,
    state)``, the same objects."""
    with trace.span("optim.adamw"):
        scale = None
        if isinstance(grads, ScaledGrads):
            grads, scale = grads.grads, grads.scale
        state["step"] += 1
        step = state["step"].float()
        c1 = 1.0 - torch.pow(b1, step)
        c2 = 1.0 - torch.pow(b2, step)
        fused.adamw_step(tree_leaves(params), tree_leaves(grads), tree_leaves(state["master"]),
                         tree_leaves(state["m"]), tree_leaves(state["v"]), scale=scale, c1=c1,
                         c2=c2, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return params, state


def opt_specs(param_spec_tree: Any, dp: Tuple[str, ...], dp_size: int,
              shapes: Any) -> Dict[str, Any]:
    """ZeRO-1 specs for ``adamw_init``'s state: on top of each parameter's
    own spec (``param_spec_tree``, in the params' tree), master, m and v
    are sharded over the data axes ``dp`` (``dp_size`` ranks in all) along
    the first unsharded dim of ``shapes`` (the params' tree of tensors,
    real, meta or fake) that ``dp_size`` divides."""

    def zero1(shape: torch.Tensor, spec: Tuple[Any, ...]) -> Tuple[Any, ...]:
        dims = tuple(shape.shape)
        if not dims:
            return ()
        entries = list(spec) + [None] * (len(dims) - len(spec))
        for i, d in enumerate(dims):
            if entries[i] is None and dp_size > 0 and d % dp_size == 0:
                entries[i] = dp
                break
        return tuple(entries)

    per_leaf = tree_map(zero1, shapes, param_spec_tree)
    return {"step": (), "master": per_leaf, "m": per_leaf, "v": per_leaf}
