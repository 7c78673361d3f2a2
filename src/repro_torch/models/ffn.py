"""FFN sublayers: gated dense MLP and Mixture-of-Experts (PyTorch port of
``repro/models/ffn.py``).

MoE uses capacity-based expert-choice dispatch over the token-choice top-k
assignment, as the reference does: the router picks each token's top-k
experts; each expert then takes its top-C assigned rows
(C = tokens*k/E * capacity_factor). Every shape is static and the FLOPs are
the active compute times capacity_factor; overflowed assignments are
dropped, and the expert axis is padded (padded experts have no router
column, so they get no real token).

The three expert products run on the ``[E_pad * C, D]`` capacity layout
through ``kernels.ops.grouped_matmul`` (one tile of ``C`` rows per expert):
the hand-written CUDA kernel on the card, the plain version on the CPU.

Two choices keep the port's output the reference's function and the same
bits run after run on the card:

* Top-k is a stable descending sort, so equal scores keep the lower index
  first, as ``jax.lax.top_k`` does. Expert-choice over ``assign.T`` has
  many equal (zero) scores.
* The combine gathers each token's <= k kept expert rows through an
  inverse map and sums them, instead of a scatter-add: PyTorch's
  scatter-adds use atomics on CUDA and are not deterministic.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import trace
from ..kernels import ops
from ..parallel import shard
from . import meshed
from .config import ArchConfig
from .layers import dense_init

__all__ = ["GatedMlp", "MoeFfn", "MoeRouting", "init_ffn", "apply_ffn", "init_moe",
           "apply_moe", "route_moe", "padded_experts"]


def init_ffn(gen: torch.Generator, d: int, ff: int, dtype) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(gen, (d, ff), dtype),
        "w_up": dense_init(gen, (d, ff), dtype),
        "w_down": dense_init(gen, (ff, d), dtype),
    }


class GatedMlp(nn.Module):
    """``silu(x @ w_gate) * (x @ w_up) @ w_down``."""

    NAMES = ("w_gate", "w_up", "w_down")

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(params[name], requires_grad=False))

    def forward(self, x):
        return apply_ffn(self, x)


def apply_ffn(p: GatedMlp, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("bsd,df->bsf", x, p.w_gate))
    h = h * torch.einsum("bsd,df->bsf", x, p.w_up)
    h = shard(h, "ffn_hidden")
    return shard(torch.einsum("bsf,fd->bsd", h, p.w_down), "act_btd")


def padded_experts(cfg: ArchConfig, tp_size: int = 16) -> int:
    e = cfg.moe.n_experts
    return -(-e // tp_size) * tp_size


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype,
             tp_size: int = 16) -> Dict[str, object]:
    m = cfg.moe
    d, de = cfg.d_model, m.d_expert
    e_pad = padded_experts(cfg, tp_size)
    params: Dict[str, object] = {
        "router": dense_init(gen, (d, m.n_experts), torch.float32),
        "w_gate": dense_init(gen, (e_pad, d, de), dtype),
        "w_up": dense_init(gen, (e_pad, d, de), dtype),
        "w_down": dense_init(gen, (e_pad, de, d), dtype),
    }
    if m.n_shared:
        params["shared"] = init_ffn(gen, d, m.n_shared * de, dtype)
    return params


class MoeFfn(nn.Module):
    """The routed experts (``router [D, E]`` float32, ``w_gate``/``w_up``
    ``[E_pad, D, De]``, ``w_down [E_pad, De, D]``) and, with
    ``moe.n_shared``, the always-on ``shared`` dense MLP."""

    NAMES = ("router", "w_gate", "w_up", "w_down")

    def __init__(self, cfg: ArchConfig, params: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(params[name], requires_grad=False))
        self.shared = GatedMlp(params["shared"]) if "shared" in params else None

    def forward(self, x):
        return apply_moe(self, x, self.cfg)


class MoeRouting(NamedTuple):
    """One forward's dispatch, per token group ``g``: each token's top-k
    experts and renormalised weights (``top_e``, ``top_p`` ``[G, Tg, k]``),
    and each expert's C chosen tokens (``token_idx``), their scores and
    whether each is a real assignment (``valid``, ``[G, E_pad, C]``)."""

    top_p: torch.Tensor
    top_e: torch.Tensor
    token_idx: torch.Tensor
    top_scores: torch.Tensor
    valid: torch.Tensor


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _groups(x: torch.Tensor, cfg: ArchConfig, g: Optional[int] = None) -> Tuple[int, int, int]:
    """(token groups, tokens per group, capacity C per expert); ``g`` the
    groups of ``x`` where it is one rank's share of a batch."""
    m = cfg.moe
    b, s, _ = x.shape
    g = g or max(1, min(m.dispatch_groups, b))
    tg = b * s // g
    cap = max(int(tg * m.top_k / m.n_experts * m.capacity_factor), 1)
    return g, tg, min(cap, tg)


def route_moe(p: MoeFfn, x: torch.Tensor, cfg: ArchConfig) -> MoeRouting:
    """The router (float32 softmax, token-choice top-k, renormalised) and
    the expert-choice capacity dispatch over it."""
    return _route(x, p.router, p.w_gate.shape[0], cfg)


def _route(x: torch.Tensor, router: torch.Tensor, e_pad: int, cfg: ArchConfig,
           e0: int = 0, e_loc: Optional[int] = None, groups: Optional[int] = None
           ) -> MoeRouting:
    """``route_moe`` over experts ``[e0, e0 + e_loc)`` of the ``e_pad``
    (all of them by default) in ``groups`` token groups (``_groups``): each
    expert's top-C rows are its own, so a rank of an expert-parallel mesh
    routes its experts alone."""
    k = cfg.moe.top_k
    g, tg, cap = _groups(x, cfg, groups)
    xg = x.reshape(g, tg, x.shape[-1])
    logits = torch.einsum("gtd,de->gte", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)        # [G, Tg, E]
    top_p, top_e = _top_k(probs, k)             # [G, Tg, k]
    top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    assign = torch.zeros((g, tg, e_pad), dtype=torch.float32, device=x.device)
    assign.scatter_(2, top_e, top_p)            # a token's k experts are distinct
    scores = assign.transpose(1, 2)
    if e_loc is not None:
        scores = scores[:, e0:e0 + e_loc]
    top_scores, token_idx = _top_k(scores, cap)  # [G, E, C]
    return MoeRouting(top_p, top_e, token_idx, top_scores, top_scores > 0.0)


# (device, E_pad, G) -> the capacity layout's tile ids, arange(E_pad) per
# group, and the kernel's error flag. The ids index w's own first axis, so
# the flag is never set and apply_moe does not read it.
_TILES: Dict[Tuple[torch.device, int, int], Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}


def _expert_tiles(device: torch.device, e_pad: int, g: int):
    key = (device, e_pad, g)
    if key not in _TILES:
        tiles = torch.arange(e_pad, dtype=torch.int32, device=device).repeat(g)
        err = (torch.zeros(1, dtype=torch.int32, device=device)
               if device.type == "cuda" else None)
        _TILES[key] = (tiles, err)
    return _TILES[key]


def apply_moe(p: MoeFfn, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D], the reference's function with its cast
    points: the router in float32, the expert products in the weights'
    dtype (float32 inside), ``ye * score`` in ``ye``'s dtype, the combine
    in ``moe.combine_dtype``, the result in ``x``'s dtype.

    Dispatch happens within ``g = moe.dispatch_groups`` batch-aligned token
    groups (g=1 -> one global group); the g groups' expert tiles share one
    grouped-GEMM launch per product. Over a mesh the experts are sharded
    over ``model`` (``meshed.moe``) and the combine is summed across it in
    ``moe.combine_dtype``.
    """
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moe.combine_dtype]
    pol = meshed.mesh_policy()
    if pol is None:
        e_pad = p.w_gate.shape[0]
        out = _moe_block(x, p.router, p.w_gate, p.w_up, p.w_down, 0, e_pad, None, cfg,
                         cdt).to(x.dtype)
    else:
        core = lambda *a: _moe_block(*a, cfg, cdt, cached=False)  # noqa: E731
        out = meshed.moe(x, p.router, p.w_gate, p.w_up, p.w_down, pol, core=core,
                         groups=cfg.moe.dispatch_groups, cdt=cdt)
        out = shard(out, "act_btd").to(x.dtype)
    if p.shared is not None:
        out = out + apply_ffn(p.shared, x)
    return out


def _moe_block(x, router, w_gate, w_up, w_down, e0: int, e_pad: int, groups: Optional[int],
               cfg: ArchConfig, cdt, cached: bool = True) -> torch.Tensor:
    """The routed experts on experts ``[e0, e0 + E_loc)`` (``w_*``'s first
    axis) of the ``e_pad``, in ``groups`` token groups (``None``: as
    ``_groups`` counts them): their share of the combine, in ``cdt``.
    ``cached`` reuses the tile ids and error flag of ``_expert_tiles``
    (off over a mesh, where the tensors may be a trace's fakes)."""
    b, s, d = x.shape
    e_loc = w_gate.shape[0]
    g, tg, cap = _groups(x, cfg, groups)
    with trace.span("moe.route"):
        r = _route(x, router, e_pad, cfg, e0, e_loc if e_loc != e_pad else None, g)
        if trace.enabled() and e_loc == e_pad:  # one chip's routing (a rank's is not counted)
            trace.count("moe.kept_rows", r.valid.sum())
            trace.count("moe.expert_rows", r.valid.sum(dim=(0, 2)))
            trace.count("moe.capacity_rows", g * e_loc * cap)
            trace.count("moe.assignments", b * s * cfg.moe.top_k)

    with trace.span("moe.experts"):
        xg = x.reshape(g, tg, d)
        gi = torch.arange(g, device=x.device)[:, None, None]
        xe = xg[gi, r.token_idx].reshape(g * e_loc * cap, d)      # [G*E_loc*C, D]
        if cached:
            tiles, err = _expert_tiles(x.device, e_loc, g)
        else:
            tiles = torch.arange(e_loc, dtype=torch.int32, device=x.device).repeat(g)
            err = torch.zeros(1, dtype=torch.int32, device=x.device)
        gmm = lambda a, w: ops.grouped_matmul(a, w, tiles, block_m=cap, err=err)  # noqa: E731
        h = F.silu(gmm(xe, w_gate)) * gmm(xe, w_up)
        ye = gmm(h, w_down).reshape(g, e_loc, cap, d)
        ye = (ye * (r.top_scores * r.valid)[..., None].to(ye.dtype)).to(cdt)

    # Combine: row (g, e, c) of ye belongs to token token_idx[g, e, c]. For
    # each token, look up where each of its k experts kept it (a missing
    # or dropped assignment, or an expert of another rank, points at a zero
    # row) and sum those rows.
    with trace.span("moe.combine"):
        n_rows = g * e_loc * cap
        flat = torch.arange(n_rows, device=x.device).reshape(g, e_loc, cap)
        flat = torch.where(r.valid, flat, torch.full_like(flat, n_rows))
        where = torch.full((g, e_loc, tg), n_rows, dtype=flat.dtype, device=x.device)
        where.scatter_(2, r.token_idx, flat)       # an expert's C tokens are distinct
        slot = r.top_e
        if e_loc != e_pad:  # a rank's experts: another rank's expert reads the zero row
            where = torch.cat([where, where.new_full((g, 1, tg), n_rows)], dim=1)
            slot = torch.where((slot >= e0) & (slot < e0 + e_loc), slot - e0, e_loc)
        inv = torch.gather(where.transpose(1, 2), 2, slot)     # [G, Tg, k]
        rows = torch.cat([ye.reshape(n_rows, d), ye.new_zeros((1, d))])
        return rows[inv].sum(dim=2).reshape(b, s, d)
