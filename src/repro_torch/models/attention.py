"""Attention mixers (PyTorch port of ``repro/models/attention.py``): GQA
(global, sliding-window, softcap and prefix-LM) and deepseek-v2's
multi-head latent attention (MLA).

Activations are [B, S, D]; attention runs in [B, H, S, hd]. Caches are
functional pairs: GQA's ``(k, v)`` [B, Hkv, Sc, hd], MLA's compressed
``(c_kv [B, Sc, kv_lora], k_rope [B, Sc, rope_dim])``. Every step returns
new tensors and never writes into the ones it was given. Prefill and
training attend through ``ops.attention`` (the flash kernel on the card;
MLA's q and k are 192 wide and its v 128); decode attends through the
plain ``_cached_attention``, as the reference does. ``parallel.shard``
sits where the reference constrains GQA's tensors: a no-op without a
mesh; over one, ``models.meshed`` runs flash, the cached attention and the
cache writes (the ring-buffer window cache's shift too) on each rank's
shards.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels import ops
from ..parallel import shard
from . import meshed
from .config import ArchConfig
from .layers import apply_rope, dense_init, rope

__all__ = ["GqaAttention", "MlaAttention", "init_attn", "apply_attn", "init_mla", "apply_mla"]

Pos = Union[int, torch.Tensor]


def init_attn(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    h_real, kv_real = cfg.n_heads, cfg.n_kv_heads
    h, hkv = cfg.eff_heads, cfg.eff_kv_heads
    wq_r = dense_init(gen, (d, h_real, hd), dtype)
    wk_r = dense_init(gen, (d, kv_real, hd), dtype)
    wv_r = dense_init(gen, (d, kv_real, hd), dtype)
    wo_r = dense_init(gen, (h_real * hd, d), dtype)
    if h == h_real:
        return {"wq": wq_r, "wk": wk_r, "wv": wv_r, "wo": wo_r}

    # Head padding (pad_heads_to): real q head (g, r) keeps its kv group —
    # it moves to slot g*group_pad + r; padded slots hold zero queries AND
    # zero wo rows, so numerics are exactly unchanged.
    group = h_real // kv_real
    group_pad = h // hkv
    idx = torch.tensor([(i // group) * group_pad + (i % group) for i in range(h_real)],
                       device=gen.device)
    wq = torch.zeros((d, h, hd), dtype=dtype, device=gen.device)
    wq[:, idx] = wq_r
    wo = torch.zeros((h, hd, d), dtype=dtype, device=gen.device)
    wo[idx] = wo_r.reshape(h_real, hd, d)
    wo = wo.reshape(h * hd, d)
    if hkv != kv_real:  # MHA: kv heads pad alongside (group_pad == 1)
        wk = torch.zeros((d, hkv, hd), dtype=dtype, device=gen.device)
        wv = torch.zeros((d, hkv, hd), dtype=dtype, device=gen.device)
        wk[:, idx] = wk_r
        wv[:, idx] = wv_r
    else:
        wk, wv = wk_r, wv_r
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


class GqaAttention(nn.Module):
    """Grouped-query attention over ``wq [D, H, hd]``, ``wk``/``wv
    [D, Hkv, hd]`` and ``wo [H*hd, D]`` (the reference's layout)."""

    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor], *, local: bool):
        super().__init__()
        self.cfg = cfg
        self.local = local
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(params[name], requires_grad=False))

    def forward(self, x, *, positions, cache=None, pos=None, prefill=False):
        return apply_attn(self, x, self.cfg, local=self.local, positions=positions,
                          cache=cache, pos=pos, prefill=prefill)


def _update_rows(c: torch.Tensor, new: torch.Tensor, pos: Pos, dim: int = 2) -> torch.Tensor:
    """``c`` with rows ``[pos, pos + s)`` of axis ``dim`` replaced by
    ``new``; the start clamps into range like ``lax.dynamic_update_slice``.
    ``pos`` may be a device scalar: no host read."""
    rows, s = c.shape[dim], new.shape[dim]
    start = torch.clamp(torch.as_tensor(pos, device=c.device).long(), 0, rows - s)
    return c.index_copy(dim, start + torch.arange(s, device=c.device), new)


def apply_attn(
    p: GqaAttention,
    x: torch.Tensor,                    # [B, S, D]
    cfg: ArchConfig,
    *,
    local: bool,
    positions: torch.Tensor,            # [S] global positions of x
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # k, v [B, Hkv, Sc, hd]
    pos: Optional[Pos] = None,          # scalar write offset into the cache
    prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    b, s, d = x.shape
    h, hd = cfg.eff_heads, cfg.head_dim
    pol = meshed.mesh_policy()

    if pol is None:
        q = torch.einsum("bsd,dhk->bhsk", x, p.wq)
        k = torch.einsum("bsd,dhk->bhsk", x, p.wk)
        v = torch.einsum("bsd,dhk->bhsk", x, p.wv)
    else:
        q, k, v = (_heads(x, w) for w in (p.wq, p.wk, p.wv))

    cos, sin = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = shard(q, "heads")
    k = shard(k, "kv_heads")
    v = shard(v, "kv_heads")

    window = cfg.window if local else None
    new_cache = None
    if cache is not None:
        ck, cv = cache
        ring = window is not None and ck.shape[2] <= window
        if ring and pol is not None:
            spec = pol.spec("kv_cache")
            ck = meshed.ring_update(ck, k, pol, spec)
            cv = meshed.ring_update(cv, v, pol, spec)
        elif ring:
            # ring-buffer window cache: keep only the trailing buffer rows
            rows = ck.shape[2]
            ck = torch.cat([ck, k], dim=2)[:, :, -rows:]
            cv = torch.cat([cv, v], dim=2)[:, :, -rows:]
        elif pol is not None:
            spec = pol.spec("kv_cache")
            ck = meshed.update_rows(ck, k, pos, pol, spec, write=_update_rows)
            cv = meshed.update_rows(cv, v, pos, pol, spec, write=_update_rows)
        else:
            ck = _update_rows(ck, k, pos)
            cv = _update_rows(cv, v, pos)
        ck = shard(ck, "kv_cache")
        cv = shard(cv, "kv_cache")
        new_cache = (ck, cv)

    flags = dict(window=window, softcap=cfg.attn_softcap, prefix_len=cfg.prefix_len)
    if cache is None or prefill:
        # attention within the current segment (training, or prefill where
        # the cache starts empty and all context is in this call)
        if pol is not None:
            out = meshed.attention(q, k, v, pol, attend=_flash, causal=True, **flags)
        else:
            out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                **flags)
    else:
        ck, cv = new_cache
        if window is not None and ck.shape[2] <= window:
            q_offset = ck.shape[2] - s       # query at the buffer tail
            min_col = ck.shape[2] - s - pos  # mask unwritten warmup rows
        else:
            q_offset = pos
            min_col = None
        if pol is not None:
            out = meshed.cached_attention(q, ck, cv, pol, pol.spec("kv_cache"),
                                          local=_cached_attention, q_offset=q_offset,
                                          min_col=min_col, **flags)
        else:
            out = _cached_attention(q, ck, cv, q_offset=q_offset, min_col=min_col, **flags)

    out = shard(out, "heads")
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    y = torch.einsum("bsk,kd->bsd", out, p.wo) if pol is None else meshed.project(out, p.wo)
    return shard(y, "act_btd"), new_cache


def _heads(x, w):
    """``einsum("bsd,dhk->bhsk")`` over DTensors, through
    ``meshed.project``'s batched product (rows sharded over both the batch
    and the sequence in the backward)."""
    b, s, _ = x.shape
    d, h, hd = w.shape
    return meshed.project(x, w.reshape(d, h * hd)).reshape(b, s, h, hd).transpose(1, 2)


def _flash(q, k, v, **flags):
    return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(), **flags)


def _cached_attention(q, k, v, *, q_offset: Pos, window, softcap, prefix_len,
                      min_col: Optional[Pos] = None, row0: int = 0,
                      part: Optional[str] = None, m=None):
    """Attention against a cache where ``q_offset`` and ``min_col`` may be
    device scalars (the decode position), masked with them on the device:
    ``cols <= q_offset + row``. Masked logits are ``-1e30``, as in the
    reference.

    Over a mesh whose ranks hold the cache's rows from ``row0`` on
    (``meshed.cached_attention``): ``part="max"`` gives the row maxima of
    this rank's scores ``[B, H, Sq]``; ``part="sums"`` with the global
    maxima ``m``, this rank's exp-sums ``[B, H, Sq]`` and weighted values
    ``[B, H, Sq, Dv]``, both float32."""
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
    group = h // hkv
    scale = 1.0 / (hd ** 0.5)

    qg = q.reshape(b, hkv, group, sq, hd).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    if row0:
        cols = cols + row0
    mask = cols <= rows
    if window is not None:
        mask &= cols > rows - window
    if prefix_len:
        mask |= cols < prefix_len
    if min_col is not None:
        mask &= cols >= min_col
    s = s.masked_fill(~mask, -1e30)
    if part == "max":  # one rank's part of a softmax over sharded rows
        return s.amax(dim=-1).reshape(b, h, sq)
    if part == "sums":
        e = torch.exp(s - m.reshape(b, hkv, group, sq, 1))
        o = torch.einsum("bkgql,bkld->bkgqd", e, v.float())
        return e.sum(dim=-1).reshape(b, h, sq), o.reshape(b, h, sq, dv)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", prob, v.float())
    return out.reshape(b, h, sq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank compressed KV; the cache is (c_kv, k_rope)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora), dtype),
        "wq_b": dense_init(gen, (m.q_lora, h, qd), dtype),
        "wkv_a": dense_init(gen, (d, m.kv_lora + m.rope_dim), dtype),
        "wkv_b": dense_init(gen, (m.kv_lora, h, m.nope_head_dim + m.v_head_dim), dtype),
        "wo": dense_init(gen, (h * m.v_head_dim, d), dtype),
    }


class MlaAttention(nn.Module):
    """Multi-head latent attention over ``wq_a [D, q_lora]``, ``wq_b
    [q_lora, H, nope + rope]``, ``wkv_a [D, kv_lora + rope]``, ``wkv_b
    [kv_lora, H, nope + v]`` and ``wo [H * v, D]`` (the reference's
    layout)."""

    NAMES = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")

    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(params[name], requires_grad=False))

    def forward(self, x, *, positions, cache=None, pos=None, prefill=False):
        return apply_mla(self, x, self.cfg, positions=positions, cache=cache, pos=pos,
                         prefill=prefill)


def apply_mla(
    p: MlaAttention,
    x: torch.Tensor,                    # [B, S, D]
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,            # [S] global positions of x
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # c_kv, k_rope [B, Sc, *]
    pos: Optional[Pos] = None,          # scalar write offset into the cache
    prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads

    q = torch.einsum("bsd,dr->bsr", x, p.wq_a)
    q = torch.einsum("bsr,rhk->bhsk", q, p.wq_b)  # [B, H, S, nope + rope]
    q_nope, q_rope = q[..., : m.nope_head_dim], q[..., m.nope_head_dim:]

    kv_a = torch.einsum("bsd,dr->bsr", x, p.wkv_a)
    c_kv, k_rope_new = kv_a[..., : m.kv_lora], kv_a[..., m.kv_lora:]

    cos, sin = rope(positions, m.rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new[:, None], cos, sin)[:, 0]  # [B, S, rope]

    new_cache = None
    if cache is not None:
        cc, cr = cache
        new_cache = (_update_rows(cc, c_kv, pos, dim=1), _update_rows(cr, k_rope_new, pos, dim=1))

    if cache is None or prefill:
        c_all, r_all = c_kv, k_rope_new  # the local segment
    else:
        c_all, r_all = new_cache

    # per-head keys and values reconstructed from the latent
    kv = torch.einsum("bsr,rhk->bhsk", c_all, p.wkv_b)
    k_nope, v = kv[..., : m.nope_head_dim], kv[..., m.nope_head_dim:]
    k_rope_b = r_all[:, None].expand((b, h) + tuple(r_all.shape[1:]))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_b], dim=-1)
    q_full = shard(q_full, "heads")
    k_full = shard(k_full, "heads")
    v = shard(v, "heads")

    pol = meshed.mesh_policy()
    if cache is None or prefill:
        out = ops.attention(q_full.contiguous(), k_full.contiguous(), v.contiguous(),
                            causal=True)
    elif pol is not None:  # the heads' layout: each rank's heads against the whole cache
        out = meshed.cached_attention(q_full, k_full, v, pol, pol.spec("heads"),
                                      local=_cached_attention, q_offset=pos, window=None,
                                      softcap=None, prefix_len=0)
    else:
        out = _cached_attention(q_full, k_full, v, q_offset=pos, window=None, softcap=None,
                                prefix_len=0)
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head_dim)
    y = torch.einsum("bsk,kd->bsd", out, p.wo) if pol is None else meshed.project(out, p.wo)
    return shard(y, "act_btd"), new_cache
