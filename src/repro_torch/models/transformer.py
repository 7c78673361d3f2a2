"""Model assembly: embedding or frontend projection -> (prefix layers +
stages) -> final norm -> LM head (PyTorch port of
``repro/models/transformer.py``). One code path builds all ten configs.

Layer layout: ``cfg.pattern`` (length n_layers) is split into an unscanned
*prefix* (the pattern remainder) and ``n_stages`` repetitions of
``pattern_unit``. The reference stacks each stage's params and caches on a
leading axis and runs them with ``lax.scan``; the port keeps a list of
stage modules and caches, and loops.

Modes (the reference's functional entry names, over a
:class:`LanguageModel`):

* ``forward``      — training/eval forward (no cache) -> logits [B, S, V_pad]
* ``loss_fn``      — mean next-token cross-entropy over ``forward``
* ``prefill``      — forward + cache population -> (last logits, cache)
* ``decode_step``  — one token against the cache -> (logits, cache)

Training: ``model.requires_grad_(True)`` makes every weight trainable
(``init_params`` and ``params_from_numpy`` build them frozen, as serving
wants them); ``loss_fn(...).backward()`` then leaves each weight's
gradient in ``.grad``. ``remat=True`` (the reference's default) recomputes
each stage in the backward (``torch.utils.checkpoint``), equal in value to
no remat. ``prefill`` and ``decode_step`` run under ``no_grad`` whatever
the weights say.

Mixers: GQA (global and local), MLA, RG-LRU and Mamba. Every layer but a
Mamba one has a dense or MoE FFN (prefix layers, which absorb
``moe.first_dense``, stay dense). A frontend arch (``audio_stub``,
``vision_stub``) takes precomputed frame or patch embeddings ``[B, S, F]``
in place of tokens and projects them with ``frontend_proj``, in all three
modes.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from .. import trace
from ..core.buffers import DeviceLike, resolve_device
from ..parallel import current_policy, shard
from ..tree import tree_map
from .attention import GqaAttention, MlaAttention, init_attn, init_mla
from .config import ATTN_GLOBAL, ATTN_LOCAL, MAMBA, MLA, RGLRU, ArchConfig
from .ffn import GatedMlp, MoeFfn, init_ffn, init_moe
from .layers import DTYPES, dense_init, rms_norm
from .recurrent import Mamba, RgLru, init_mamba, init_rglru

__all__ = [
    "FRONTEND_DIMS", "LAYER_KINDS", "LayerKind", "layer_kind", "Block", "LanguageModel", "pad_vocab", "split_pattern",
    "init_params", "param_shapes", "init_cache", "forward", "loss_fn", "loss_and_grads",
    "prefill", "decode_step", "remat_policy",
]

# The width of a frontend's precomputed embeddings (EnCodec frames, SigLIP
# patches), projected to d_model by ``frontend_proj``.
FRONTEND_DIMS = {"audio_stub": 512, "vision_stub": 1152}

Cache = Dict[str, List[Any]]
Pos = Union[int, torch.Tensor]


# Remat policy for the per-stage checkpoint: "nothing" (recompute the
# whole stage in the backward, the least memory) or "dots" (save matmul and
# kernel outputs, skipping the recompute of the big GEMMs and of the
# collectives around them, at more activation memory).
_REMAT_POLICY = "nothing"
_REMAT_POLICIES = ("nothing", "dots")


@contextlib.contextmanager
def remat_policy(name: str):
    """Run the per-stage recompute (``remat=True``) under policy ``name``:
    ``"nothing"`` (the default) or ``"dots"``, which saves the outputs of
    matrix products and of the flash and grouped-GEMM ops through
    ``torch.utils.checkpoint``'s selective checkpointing."""
    global _REMAT_POLICY
    if name not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy: {name!r} is not one of {_REMAT_POLICIES}")
    prev = _REMAT_POLICY
    _REMAT_POLICY = name
    try:
        yield
    finally:
        _REMAT_POLICY = prev


def _saves_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    saved = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.addmm.default, torch.ops.repro_torch.flash_attention_lse.default,
             torch.ops.repro_torch.grouped_matmul_fwd.default)
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint_kwargs() -> Dict[str, Any]:
    if _REMAT_POLICY == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                _saves_dots)}
    return {}


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def split_pattern(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int]:
    """Returns (prefix_kinds, n_stages). Body = n_stages x pattern_unit."""
    unit = cfg.pattern_unit
    n_prefix = cfg.n_layers % len(unit)
    if cfg.moe is not None and cfg.moe.first_dense:
        fd = cfg.moe.first_dense
        # prefix must absorb the dense-FFN layers and keep body divisible
        while (cfg.n_layers - max(n_prefix, fd)) % len(unit):
            fd += 1
        n_prefix = max(n_prefix, fd)
    prefix = cfg.pattern[:n_prefix]
    n_stages = (cfg.n_layers - n_prefix) // len(unit)
    return prefix, n_stages


# ---------------------------------------------------------------------------
# layer kinds
# ---------------------------------------------------------------------------

def _attn_cache(local: bool) -> Callable:
    def build(cfg: ArchConfig, batch: int, max_len: int, zeros: Callable):
        rows = max_len
        if local and cfg.window is not None:
            rows = min(cfg.window, max_len)
        shape = (batch, cfg.eff_kv_heads, rows, cfg.head_dim)
        return (zeros(shape), zeros(shape))
    return build


def _mla_cache(cfg: ArchConfig, batch: int, max_len: int, zeros: Callable):
    m = cfg.mla
    return (zeros((batch, max_len, m.kv_lora)), zeros((batch, max_len, m.rope_dim)))


def _rglru_cache(cfg: ArchConfig, batch: int, max_len: int, zeros: Callable):
    w = cfg.rglru_width or cfg.d_model
    return (zeros((batch, w), torch.float32), zeros((batch, cfg.d_conv - 1, w)))


def _mamba_cache(cfg: ArchConfig, batch: int, max_len: int, zeros: Callable):
    di = cfg.expand * cfg.d_model
    return (zeros((batch, di, cfg.ssm_state), torch.float32),
            zeros((batch, cfg.d_conv - 1, di)))


class LayerKind(NamedTuple):
    """What one layer kind builds: its mixer's params (``init(gen, cfg,
    dtype)``), its mixer module (``module(cfg, params)``) and its cache
    entry (``cache(cfg, batch, max_len, zeros)``); whether the mixer is a
    recurrence, called with ``state=`` rather than positions and a cache;
    and whether the layer has an FFN."""

    init: Callable
    module: Callable
    cache: Callable
    recurrent: bool
    ffn: bool


LAYER_KINDS: Dict[str, LayerKind] = {
    ATTN_GLOBAL: LayerKind(init_attn, lambda cfg, p: GqaAttention(cfg, p, local=False),
                           _attn_cache(False), False, True),
    ATTN_LOCAL: LayerKind(init_attn, lambda cfg, p: GqaAttention(cfg, p, local=True),
                          _attn_cache(True), False, True),
    MLA: LayerKind(init_mla, MlaAttention, _mla_cache, False, True),
    RGLRU: LayerKind(init_rglru, RgLru, _rglru_cache, True, True),
    MAMBA: LayerKind(init_mamba, Mamba, _mamba_cache, True, False),  # a Mamba block has no FFN
}


def layer_kind(kind: str) -> LayerKind:
    if kind not in LAYER_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    return LAYER_KINDS[kind]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: pre-norm mixer and, where the layer's params hold an
    ``ffn`` (every kind but Mamba: ``LayerKind.ffn``), a pre-norm FFN (a
    gated MLP, or the MoE FFN where those params hold a ``router``), both
    residual."""

    def __init__(self, cfg: ArchConfig, kind: str, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        spec = layer_kind(kind)
        self.recurrent = spec.recurrent
        self.norm = nn.Parameter(params["norm"], requires_grad=False)
        self.mixer = spec.module(cfg, params["mixer"])
        self.ffn = None
        if "ffn" in params:
            self.ffn_norm = nn.Parameter(params["ffn_norm"], requires_grad=False)
            ffn = params["ffn"]
            self.ffn = MoeFfn(cfg, ffn) if "router" in ffn else GatedMlp(ffn)

    def forward(self, x, positions, cache_entry, pos, prefill_mode):
        cfg = self.cfg
        with trace.span("block.mixer"):
            h = rms_norm(x, self.norm, cfg.norm_eps)
            if self.recurrent:
                y, new_c = self.mixer(h, state=cache_entry)
            else:
                y, new_c = self.mixer(h, positions=positions, cache=cache_entry, pos=pos,
                                      prefill=prefill_mode)
            x = x + y
        if self.ffn is not None:
            with trace.span("block.ffn"):
                h = rms_norm(x, self.ffn_norm, cfg.norm_eps)
                x = x + self.ffn(h)
        return x, new_c


class LanguageModel(nn.Module):
    """Embedding, prefix blocks, stages of ``pattern_unit`` blocks, final
    norm and (tied or separate) head, and a frontend arch's
    ``frontend_proj``. ``tree`` holds tensors in the reference's parameter
    layout, with ``stages`` as one tuple of layer dicts per stage instead
    of stacked leaves."""

    def __init__(self, cfg: ArchConfig, tree: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        prefix, n_stages = split_pattern(cfg)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
        self.frontend_proj = (nn.Parameter(tree["frontend_proj"], requires_grad=False)
                              if cfg.frontend else None)
        self.final_norm = nn.Parameter(tree["final_norm"], requires_grad=False)
        self.head = (None if cfg.tied_embeddings
                     else nn.Parameter(tree["head"], requires_grad=False))
        self.prefix = nn.ModuleList(
            Block(cfg, kind, lp) for kind, lp in zip(prefix, tree["prefix"]))
        self.stages = nn.ModuleList(
            nn.ModuleList(Block(cfg, kind, lp) for kind, lp in zip(cfg.pattern_unit, stage))
            for stage in tree["stages"])
        if len(self.prefix) != len(prefix) or len(self.stages) != n_stages:
            raise ValueError(f"{cfg.name}: the tree holds {len(self.prefix)} prefix layers "
                             f"and {len(self.stages)} stages, the config {len(prefix)} "
                             f"and {n_stages}")

    def param_tree(self) -> Dict[str, Any]:
        """The model's parameters (the tensors themselves) in the layout
        ``__init__`` takes: the reference's keys, ``prefix`` a list of layer
        dicts, ``stages`` a list of one tuple of layer dicts per stage."""
        tree: Dict[str, Any] = {"prefix": [{} for _ in self.prefix],
                                "stages": [tuple({} for _ in st) for st in self.stages]}
        for name, param in self.named_parameters():
            parts = name.split(".")
            node: Any = tree
            for part in parts[:-1]:
                node = node[int(part)] if part.isdigit() else node.setdefault(part, {})
            node[parts[-1]] = param
        return tree


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, kind: str, cfg: ArchConfig, dtype,
                layer_has_moe: bool, tp_size: int) -> Dict[str, Any]:
    d = cfg.d_model
    norm = lambda: torch.zeros((d,), dtype=torch.float32, device=gen.device)  # noqa: E731
    spec = layer_kind(kind)
    layer = {"norm": norm(), "mixer": spec.init(gen, cfg, dtype)}
    if spec.ffn:
        layer["ffn_norm"] = norm()
        layer["ffn"] = (init_moe(gen, cfg, dtype, tp_size) if layer_has_moe
                        else init_ffn(gen, d, cfg.d_ff, dtype))
    return layer


class _MetaGenerator:
    """What the initializers read of a generator on the meta device: its
    device (``layers.dense_init`` then draws nothing)."""

    device = torch.device("meta")


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, device: DeviceLike = "cuda",
                tp_size: int = 16) -> LanguageModel:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (the numbers differ from ``jax.random``'s; the tests carry
    the reference's weights across with ``models.convert`` instead). MoE
    layers pad their experts to a multiple of ``tp_size``, as the
    reference does. ``device="meta"`` gives the shapes and dtypes alone,
    allocating and drawing nothing: the counterpart of the reference's
    ``jax.eval_shape(init_params)`` (see :func:`param_shapes`)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = _MetaGenerator()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = DTYPES[cfg.dtype]
    d = cfg.d_model
    v_pad = pad_vocab(cfg.vocab)
    prefix, n_stages = split_pattern(cfg)
    tree: Dict[str, Any] = {
        "embed": dense_init(gen, (v_pad, d), dtype),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=dev),
    }
    if cfg.frontend:
        tree["frontend_proj"] = dense_init(gen, (FRONTEND_DIMS[cfg.frontend], d), dtype)
    if not cfg.tied_embeddings:
        tree["head"] = dense_init(gen, (d, v_pad), dtype)
    moe = cfg.moe is not None
    tree["prefix"] = [_init_layer(gen, kind, cfg, dtype, False, tp_size) for kind in prefix]
    tree["stages"] = [tuple(_init_layer(gen, kind, cfg, dtype, moe, tp_size)
                            for kind in cfg.pattern_unit)
                      for _ in range(n_stages)]
    return LanguageModel(cfg, tree)


def param_shapes(cfg: ArchConfig, tp_size: int = 16) -> Dict[str, Any]:
    """The parameter tree (``LanguageModel.param_tree``'s layout) as meta
    tensors: every leaf's shape and dtype, nothing allocated."""
    return init_params(cfg, device="meta", tp_size=tp_size).param_tree()


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: DeviceLike = "cuda") -> Cache:
    """Zero caches: ``{"prefix": [entry per layer], "stages": [tuple of
    entries per stage]}``; an attention entry is ``(k, v)``, an MLA entry
    ``(c_kv, k_rope)``, an RG-LRU or Mamba entry ``(h float32, conv
    tail)``."""
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    entry = lambda kind: layer_kind(kind).cache(cfg, batch, max_len, zeros)  # noqa: E731
    prefix, n_stages = split_pattern(cfg)
    return {
        "prefix": [entry(k) for k in prefix],
        "stages": [tuple(entry(k) for k in cfg.pattern_unit) for _ in range(n_stages)],
    }


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def _embed(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Tokens [B, S] through the embedding table, or a frontend arch's
    embeddings [B, S, F] through ``frontend_proj`` (in the promoted dtype
    of the two, as ``jnp.einsum`` computes it)."""
    if cfg.frontend:
        dt = torch.promote_types(inputs.dtype, params.frontend_proj.dtype)
        x = torch.einsum("bsf,fd->bsd", inputs.to(dt), params.frontend_proj.to(dt))
    else:
        pol = current_policy()
        if pol is not None and pol.mesh is not None:  # the vocab-sharded table
            from .meshed import embed

            x = embed(inputs, params.embed, pol)
        else:
            x = params.embed[inputs.long()]
    if cfg.embed_scale:
        # sqrt(d) as float32, applied in float32 before the cast to the
        # model dtype (the reference's order, which matters for bf16)
        x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    return shard(x.to(DTYPES[cfg.dtype]), "act_btd")


def _head(params: LanguageModel, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.t() if cfg.tied_embeddings else params.head
    logits = torch.einsum("bsd,dv->bsv", x, w).float()  # the product in the model dtype
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return shard(logits, "logits")


def _run_stage(stage: nn.ModuleList, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One stage's blocks without a cache (the unit ``remat`` recomputes)."""
    for block in stage:
        x, _ = block(x, positions, None, None, False)
    return x


def _run_stage_on_mesh(pol, stage: nn.ModuleList, x: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """``_run_stage`` under the mesh policy ``pol``, which the recompute
    in the backward may need on another thread."""
    from .meshed import mesh_context

    with mesh_context(pol):
        return _run_stage(stage, x, positions)


def _run_layers(params: LanguageModel, x, positions, cache, pos, prefill_mode, remat=False):
    new_prefix = []
    for i, block in enumerate(params.prefix):
        entry = cache["prefix"][i] if cache is not None else None
        x, nc = block(x, positions, entry, pos, prefill_mode)
        new_prefix.append(nc)
    if remat and cache is None and torch.is_grad_enabled():
        # As the reference's jax.checkpoint per stage: keep each stage's
        # input (and, under remat_policy("dots"), its products' outputs) and
        # recompute the rest in the backward.
        pol = current_policy()
        run = (_run_stage if pol is None or pol.mesh is None
               else functools.partial(_run_stage_on_mesh, pol))
        for stage in params.stages:
            x = torch.utils.checkpoint.checkpoint(run, stage, x, positions,
                                                  use_reentrant=False, **_checkpoint_kwargs())
        return x, None
    new_stages = []
    for si, stage in enumerate(params.stages):
        entries = []
        for ui, block in enumerate(stage):
            entry = cache["stages"][si][ui] if cache is not None else None
            x, nc = block(x, positions, entry, pos, prefill_mode)
            entries.append(nc)
        new_stages.append(tuple(entries))
    new_cache = None if cache is None else {"prefix": new_prefix, "stages": new_stages}
    return x, new_cache


def forward(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """Training/eval forward. inputs: tokens [B, S] int (or embeddings
    [B, S, F] for frontend archs). Returns logits [B, S, V_pad] (f32).
    ``remat`` recomputes each stage in the backward where autograd records
    the forward; it changes no value."""
    s = inputs.shape[1]
    x = _embed(params, cfg, inputs)
    positions = torch.arange(s, device=x.device)
    x, _ = _run_layers(params, x, positions, None, None, False, remat)
    return _head(params, cfg, x)


def loss_fn(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor,
            labels: torch.Tensor, *, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy; the padded vocab columns are masked
    out (logit -1e30), as in the reference."""
    logits = forward(params, cfg, inputs, remat=remat)
    pol = current_policy()
    if pol is not None and pol.mesh is not None:  # vocab-sharded logits
        from .meshed import cross_entropy

        return cross_entropy(logits, labels, cfg.vocab, pol)
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(col < cfg.vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def loss_and_grads(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor,
                   labels: torch.Tensor, *, remat: bool = True):
    """``loss_fn`` and its gradient with respect to every weight (the
    reference's ``jax.value_and_grad(loss_fn)``); the weights must be
    trainable (``params.requires_grad_(True)``). Returns the detached loss
    and the gradients in ``param_tree``'s layout, each in its weight's dtype
    (zeros for a weight the loss does not reach); the weights' ``.grad`` is
    left cleared."""
    params.zero_grad(set_to_none=True)
    with trace.span("train.forward"):
        loss = loss_fn(params, cfg, inputs, labels, remat=remat)
    with trace.span("train.backward"):
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         params.param_tree())
        params.zero_grad(set_to_none=True)
    return loss.detach(), grads


@torch.no_grad()
def prefill(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor, cache: Cache):
    """Populate the cache from a prompt; returns (last-token logits, cache)."""
    s = inputs.shape[1]
    x = _embed(params, cfg, inputs)
    positions = torch.arange(s, device=x.device)
    pos = torch.zeros((), dtype=torch.int32, device=x.device)
    x, cache = _run_layers(params, x, positions, cache, pos, True)
    return _head(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor, cache: Cache,
                pos: Pos):
    """One decode step at position ``pos`` (an int, or an int32 device
    scalar: then no host read). inputs [B, 1] (or [B, 1, F] embeddings)."""
    x = _embed(params, cfg, inputs)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos + torch.arange(inputs.shape[1], device=x.device)
    x, cache = _run_layers(params, x, positions, cache, pos, False)
    return _head(params, cfg, x), cache
