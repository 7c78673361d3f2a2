"""Model assembly: embedding -> (prefix layers + stages) -> final norm ->
LM head (PyTorch port of ``repro/models/transformer.py``).

Layer layout: ``cfg.pattern`` (length n_layers) is split into an unscanned
*prefix* (the pattern remainder) and ``n_stages`` repetitions of
``pattern_unit``. The reference stacks each stage's params and caches on a
leading axis and runs them with ``lax.scan``; the port keeps a list of
stage modules and caches, and loops.

Modes (the reference's functional entry names, over a
:class:`LanguageModel`):

* ``forward``      — training/eval forward (no cache) -> logits [B, S, V_pad]
* ``prefill``      — forward + cache population -> (last logits, cache)
* ``decode_step``  — one token against the cache -> (logits, cache)

The port builds GQA (global and local) and RG-LRU layers with dense or
MoE FFNs (prefix layers, which absorb ``moe.first_dense``, stay dense);
MLA, Mamba, the frontends and ``loss_fn`` are still to port (ROADMAP queue
1 item 9), and ``init_params`` raises ``NotImplementedError`` for a
configuration that needs them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.buffers import DeviceLike, resolve_device
from .attention import GqaAttention, init_attn
from .config import ATTN_LOCAL, MAMBA, MLA, RGLRU, ArchConfig
from .ffn import GatedMlp, MoeFfn, init_ffn, init_moe
from .layers import DTYPES, dense_init, rms_norm
from .recurrent import RgLru, init_rglru

__all__ = [
    "Block", "LanguageModel", "pad_vocab", "split_pattern", "check_supported",
    "init_params", "init_cache", "forward", "prefill", "decode_step",
]

Cache = Dict[str, List[Any]]
Pos = Union[int, torch.Tensor]


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


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not build yet."""
    missing = [what for what, needed in (
        ("the frontend archs", cfg.frontend is not None),
        ("MLA attention", MLA in cfg.pattern_unit),
        ("Mamba blocks", MAMBA in cfg.pattern_unit),
    ) if needed]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported to repro_torch yet "
            "(ROADMAP queue 1 item 9)")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: pre-norm mixer and pre-norm FFN (a gated MLP, or the MoE
    FFN where the layer's FFN params hold a ``router``), both residual."""

    def __init__(self, cfg: ArchConfig, kind: str, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm = nn.Parameter(params["norm"], requires_grad=False)
        # check_supported admits only attention and RG-LRU layers
        self.mixer = (RgLru(cfg, params["mixer"]) if kind == RGLRU
                      else GqaAttention(cfg, params["mixer"], local=(kind == ATTN_LOCAL)))
        self.ffn_norm = nn.Parameter(params["ffn_norm"], requires_grad=False)
        ffn = params["ffn"]
        self.ffn = MoeFfn(cfg, ffn) if "router" in ffn else GatedMlp(ffn)

    def forward(self, x, positions, cache_entry, pos, prefill_mode):
        cfg = self.cfg
        h = rms_norm(x, self.norm, cfg.norm_eps)
        if self.kind == RGLRU:
            y, new_c = self.mixer(h, state=cache_entry)
        else:
            y, new_c = self.mixer(h, positions=positions, cache=cache_entry, pos=pos,
                                  prefill=prefill_mode)
        x = x + y
        h = rms_norm(x, self.ffn_norm, cfg.norm_eps)
        return x + self.ffn(h), new_c


class LanguageModel(nn.Module):
    """Embedding, prefix blocks, stages of ``pattern_unit`` blocks, final
    norm and (tied or separate) head. ``tree`` holds tensors in the
    reference's parameter layout, with ``stages`` as one tuple of layer
    dicts per stage instead of stacked leaves."""

    def __init__(self, cfg: ArchConfig, tree: Dict[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        prefix, n_stages = split_pattern(cfg)
        self.embed = nn.Parameter(tree["embed"], requires_grad=False)
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, kind: str, cfg: ArchConfig, dtype,
                layer_has_moe: bool, tp_size: int) -> Dict[str, Any]:
    d = cfg.d_model
    norm = lambda: torch.zeros((d,), dtype=torch.float32, device=gen.device)  # noqa: E731
    mixer = init_rglru(gen, cfg, dtype) if kind == RGLRU else init_attn(gen, cfg, dtype)
    ffn = (init_moe(gen, cfg, dtype, tp_size) if layer_has_moe
           else init_ffn(gen, d, cfg.d_ff, dtype))
    return {"norm": norm(), "mixer": mixer, "ffn_norm": norm(), "ffn": ffn}


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, device: DeviceLike = "cuda",
                tp_size: int = 16) -> LanguageModel:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (the numbers differ from ``jax.random``'s; the tests carry
    the reference's weights across with ``models.convert`` instead). MoE
    layers pad their experts to a multiple of ``tp_size``, as the
    reference does."""
    dev = resolve_device(device)
    check_supported(cfg)
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
    if not cfg.tied_embeddings:
        tree["head"] = dense_init(gen, (d, v_pad), dtype)
    moe = cfg.moe is not None
    tree["prefix"] = [_init_layer(gen, kind, cfg, dtype, False, tp_size) for kind in prefix]
    tree["stages"] = [tuple(_init_layer(gen, kind, cfg, dtype, moe, tp_size)
                            for kind in cfg.pattern_unit)
                      for _ in range(n_stages)]
    return LanguageModel(cfg, tree)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _layer_cache(kind: str, cfg: ArchConfig, batch: int, max_len: int, dtype, dev):
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    if kind == RGLRU:
        w = cfg.rglru_width or cfg.d_model
        return (zeros((batch, w), torch.float32), zeros((batch, cfg.d_conv - 1, w)))
    rows = max_len  # attention (check_supported admits no other kind)
    if kind == ATTN_LOCAL and cfg.window is not None:
        rows = min(cfg.window, max_len)
    shape = (batch, cfg.eff_kv_heads, rows, cfg.head_dim)
    return (zeros(shape), zeros(shape))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device: DeviceLike = "cuda") -> Cache:
    """Zero caches: ``{"prefix": [entry per layer], "stages": [tuple of
    entries per stage]}``; an attention entry is ``(k, v)``, an RG-LRU entry
    ``(h float32, conv tail)``."""
    dev = resolve_device(device)
    check_supported(cfg)
    dtype = DTYPES[cfg.dtype]
    prefix, n_stages = split_pattern(cfg)
    return {
        "prefix": [_layer_cache(k, cfg, batch, max_len, dtype, dev) for k in prefix],
        "stages": [tuple(_layer_cache(k, cfg, batch, max_len, dtype, dev)
                         for k in cfg.pattern_unit) for _ in range(n_stages)],
    }


# ---------------------------------------------------------------------------
# forward paths
# ---------------------------------------------------------------------------

def _embed(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    x = params.embed[inputs.long()]
    if cfg.embed_scale:
        # sqrt(d) as float32, applied in float32 before the cast to the
        # model dtype (the reference's order, which matters for bf16)
        x = x.float() * float(np.float32(np.sqrt(cfg.d_model)))
    return x.to(DTYPES[cfg.dtype])


def _head(params: LanguageModel, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.t() if cfg.tied_embeddings else params.head
    logits = torch.einsum("bsd,dv->bsv", x, w).float()  # the product in the model dtype
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _run_layers(params: LanguageModel, x, positions, cache, pos, prefill_mode):
    new_prefix = []
    for i, block in enumerate(params.prefix):
        entry = cache["prefix"][i] if cache is not None else None
        x, nc = block(x, positions, entry, pos, prefill_mode)
        new_prefix.append(nc)
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


def forward(params: LanguageModel, cfg: ArchConfig, inputs: torch.Tensor) -> torch.Tensor:
    """Training/eval forward. inputs: tokens [B, S] int. Returns logits
    [B, S, V_pad] (f32)."""
    s = inputs.shape[1]
    x = _embed(params, cfg, inputs)
    positions = torch.arange(s, device=x.device)
    x, _ = _run_layers(params, x, positions, None, None, False)
    return _head(params, cfg, x)


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
    scalar: then no host read). inputs [B, 1]."""
    x = _embed(params, cfg, inputs)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    positions = pos + torch.arange(inputs.shape[1], device=x.device)
    x, cache = _run_layers(params, x, positions, cache, pos, False)
    return _head(params, cfg, x), cache
