"""An arch's steps, shared by the trainer CLI, the dry run and
``chip_smoke.py`` (PyTorch port of ``repro/launch/steps.py``): given an
arch config (and a mesh), the train, prefill and decode steps, the
shapes of every input of a cell (``input_specs``, nothing allocated), the
spec trees of the parameters and the AdamW state over the mesh, and
``StepBundle.trace``, the counterpart of the reference's
``lower(...).compile()``: the bundle's own step run over fake ``DTensor``s
on a mesh of ranks (``launch.mesh.fake_world``), which records what one
rank computes, moves and holds without a card or an allocation."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from .. import trace
from ..models import decode_step as model_decode
from ..models import init_cache, loss_and_grads
from ..models import prefill as model_prefill
from ..models.config import ArchConfig
from ..models.layers import DTYPES
from ..models.transformer import FRONTEND_DIMS, LanguageModel, param_shapes
from ..optim import adamw_update, clip_by_global_norm, opt_specs
from ..parallel import batch_specs, cache_specs, param_specs, placements, policy_for
from ..tree import tree_leaves, tree_map

__all__ = ["StepBundle", "input_specs"]

Shapes = Dict[str, Tuple[int, int, str]]


def input_specs(cfg: ArchConfig, shape_name: str, shapes: Shapes, *,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """Meta tensors standing in for every model input of one cell (shapes
    and dtypes, nothing allocated): ``inputs`` and ``labels`` for a train
    cell, ``inputs`` and ``cache`` for prefill, and decode's one-token
    ``inputs``, ``cache`` and ``pos``."""
    seq, batch, kind = shapes[shape_name]
    if batch_override:
        batch = batch_override
    dtype = DTYPES[cfg.dtype]
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")  # noqa: E731
    if cfg.frontend:
        inp = meta((batch, seq, FRONTEND_DIMS[cfg.frontend]), dtype)
    else:
        inp = meta((batch, seq), torch.int32)
    if kind == "train":
        return {"inputs": inp, "labels": meta((batch, seq), torch.int32)}
    cache = init_cache(cfg, batch, seq, device="meta")
    if kind == "prefill":
        return {"inputs": inp, "cache": cache}
    if kind == "decode":
        one = (meta((batch, 1, FRONTEND_DIMS[cfg.frontend]), dtype) if cfg.frontend
               else meta((batch, 1), torch.int32))
        return {"inputs": one, "cache": cache, "pos": meta((), torch.int32)}
    raise ValueError(kind)


def _locals(tree: Any) -> list:
    """The rank's own shards of a tree's tensors."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _redistributed(t: torch.Tensor, spec) -> torch.Tensor:
    """A DTensor laid out by ``spec`` on its own mesh (a sum over the ranks
    that hold parts of it reduce-scattered onto the shards), or ``t`` where
    it is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, placements(spec, t.device_mesh))


def _nbytes(tree: Any) -> int:
    """The bytes of the rank's own shards of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


class StepBundle:
    """The steps of one arch: a train step (loss, gradients through the
    kernels' backward, global-norm clip, AdamW at a constant ``lr``, in
    place) and the serving steps. Given a ``mesh`` (a ``DeviceMesh``) it
    also holds the arch's policy on it (``policy``), the parameters' shapes
    (meta tensors), their specs (``pspecs``) and the AdamW state's ZeRO-1
    specs (``ospecs``), and can :meth:`trace` a cell."""

    def __init__(self, cfg: ArchConfig, mesh=None, lr: float = 3e-4, clip: float = 1.0):
        self.cfg = cfg
        self.mesh = mesh
        self.lr = lr
        self.clip = clip
        if mesh is not None:
            self.policy = policy_for(cfg, mesh)
            self.param_shapes = param_shapes(cfg, tp_size=self.policy.tp_size)
            self.pspecs = param_specs(self.param_shapes, self.policy)
            self.ospecs = opt_specs(self.pspecs, self.policy.dp, self.policy.dp_size,
                                    self.param_shapes)

    def train_step(self, params: LanguageModel, opt_state: Dict[str, Any],
                   inputs: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[LanguageModel, Dict[str, Any], Dict[str, torch.Tensor]]:
        """One step on trainable weights (``params.requires_grad_(True)``)
        and ``optim.adamw_init(params.param_tree())``'s state, both updated
        in place and returned. The metrics are device scalars. Over a mesh
        each gradient goes onto its AdamW state's ZeRO-1 shards before the
        clip (a reduce-scatter where it is a sum over the data ranks), so
        that the norm and the update run on the shards."""
        with trace.span(trace.STEP):
            loss, grads = loss_and_grads(params, self.cfg, inputs, labels)
            if self.mesh is not None:  # ZeRO-1: each gradient onto its optimizer state's shards
                grads = tree_map(_redistributed, grads, self.ospecs["m"])
            grads, gnorm = clip_by_global_norm(grads, self.clip)
            adamw_update(params.param_tree(), grads, opt_state, self.lr)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    def prefill_step(self, params, inputs, cache):
        return model_prefill(params, self.cfg, inputs, cache)

    def decode_step(self, params, inputs, cache, pos):
        return model_decode(params, self.cfg, inputs, cache, pos)

    # -- tracing over a mesh -------------------------------------------------
    def trace(self, shape_name: str, shapes: Shapes) -> Dict[str, Any]:
        """Run the cell's step once over fake DTensors laid out on the
        bundle's mesh, as rank 0 of its world, and return what that rank
        computes, moves and holds: ``flops`` (the FLOP formulas of PyTorch's
        flop counter, the kernels' ops included), ``bytes`` (each compute
        op's operands read and results written once), the collective
        ``records`` (``roofline.StepCounter``), ``argument_bytes``
        (parameters, AdamW state, inputs and caches), ``output_bytes``,
        ``peak_bytes`` (the most bytes the rank's live storages held at
        once during the step, arguments included) and ``trace_s``.

        Every tensor is a fake tensor (``FakeTensorMode``), so nothing is
        allocated and no kernel builds or launches; a ``Shard(a) ->
        Shard(b)`` is the card's all-to-all on a CPU mesh too
        (``roofline.card_collectives``)."""
        if self.mesh is None:
            raise ValueError("StepBundle.trace needs a mesh")
        from torch._subclasses.fake_tensor import FakeTensorMode

        from ..models.meshed import mesh_context
        from .roofline import StepCounter, card_collectives

        cfg = self.cfg
        specs = input_specs(cfg, shape_name, shapes)
        kind = shapes[shape_name][2]
        pol = policy_for(cfg, self.mesh, batch=specs["inputs"].shape[0])
        t0 = time.time()
        counter = StepCounter(self.mesh)  # reads the mesh's ranks: before the fakes
        with FakeTensorMode(), card_collectives():
            params, args = self._fake_arguments(kind, specs, pol)
            step = {"train": self.train_step, "prefill": self.prefill_step,
                    "decode": self.decode_step}[kind]
            with mesh_context(pol):
                counter.hold(_locals((params.param_tree(), args)))
                with counter:
                    out = step(params, *args)
        argument_bytes = _nbytes(params.param_tree()) + _nbytes(args)
        outputs = (out[0].param_tree(), out[1:]) if kind == "train" else out
        return {
            "kind": kind,
            "policy": pol,
            "flops": float(counter.flops),
            "bytes": float(counter.bytes),
            "records": counter.records,
            "argument_bytes": argument_bytes,
            "output_bytes": _nbytes(outputs),
            "peak_bytes": counter.peak_bytes,
            "trace_s": time.time() - t0,
        }

    def _fake_arguments(self, kind: str, specs: Dict[str, Any], pol) -> Tuple[Any, tuple]:
        """The step's arguments as DTensors of empty fake tensors on their
        placements (call under ``FakeTensorMode``): the model, and the AdamW
        state and labels, the cache, or the cache and position."""
        import torch.distributed.tensor as dtensor

        mesh = self.mesh

        def empty(shape_like, spec, dtype=None):
            return dtensor.empty(tuple(shape_like.shape), dtype=dtype or shape_like.dtype,
                                 device_mesh=mesh, placements=placements(spec, mesh))

        model = LanguageModel(self.cfg, tree_map(empty, self.param_shapes, self.pspecs))
        in_spec = batch_specs(self.cfg, pol, kind)
        if kind == "train":
            model.requires_grad_(True)
            f32 = lambda p, s: empty(p, s, torch.float32)  # noqa: E731
            opt = {"step": empty(torch.empty((), dtype=torch.int32, device="meta"), ()),
                   **{k: tree_map(f32, self.param_shapes, self.ospecs[k])
                      for k in ("master", "m", "v")}}
            return model, (opt, empty(specs["inputs"], in_spec[0]),
                           empty(specs["labels"], in_spec[1]))
        cache = tree_map(empty, specs["cache"], cache_specs(self.cfg, pol))
        if kind == "prefill":
            return model, (empty(specs["inputs"], in_spec), cache)
        return model, (empty(specs["inputs"], in_spec), cache, empty(specs["pos"], ()))
