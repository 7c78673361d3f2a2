"""GQA attention mixer: global, sliding-window, softcap and prefix-LM
(PyTorch port of the GQA part of ``repro/models/attention.py``; MLA is
still to port, ROADMAP queue 1 item 9).

Activations are [B, S, D]; attention runs in [B, H, S, hd]. Caches are
functional ``(k, v)`` pairs [B, Hkv, Sc, hd]: every step returns new
tensors and never writes into the ones it was given. The reference's
``parallel.shard`` calls are no-ops without a mesh and are dropped here.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels import ops
from .config import ArchConfig
from .layers import apply_rope, dense_init, rope

__all__ = ["GqaAttention", "init_attn", "apply_attn"]

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


def _update_rows(c: torch.Tensor, new: torch.Tensor, pos: Pos) -> torch.Tensor:
    """``c`` with rows ``[pos, pos + s)`` of axis 2 replaced by ``new``; the
    start clamps into range like ``lax.dynamic_update_slice``. ``pos`` may
    be a device scalar: no host read."""
    rows, s = c.shape[2], new.shape[2]
    start = torch.clamp(torch.as_tensor(pos, device=c.device).long(), 0, rows - s)
    return c.index_copy(2, start + torch.arange(s, device=c.device), new)


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

    q = torch.einsum("bsd,dhk->bhsk", x, p.wq)
    k = torch.einsum("bsd,dhk->bhsk", x, p.wk)
    v = torch.einsum("bsd,dhk->bhsk", x, p.wv)

    cos, sin = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    window = cfg.window if local else None
    new_cache = None
    if cache is not None:
        ck, cv = cache
        ring = window is not None and ck.shape[2] <= window
        if ring:
            # ring-buffer window cache: keep only the trailing buffer rows
            rows = ck.shape[2]
            ck = torch.cat([ck, k], dim=2)[:, :, -rows:]
            cv = torch.cat([cv, v], dim=2)[:, :, -rows:]
        else:
            ck = _update_rows(ck, k, pos)
            cv = _update_rows(cv, v, pos)
        new_cache = (ck, cv)

    if cache is None or prefill:
        # attention within the current segment (training, or prefill where
        # the cache starts empty and all context is in this call)
        out = ops.attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=window,
            softcap=cfg.attn_softcap, prefix_len=cfg.prefix_len,
        )
    else:
        ck, cv = new_cache
        if window is not None and ck.shape[2] <= window:
            q_offset = ck.shape[2] - s       # query at the buffer tail
            min_col = ck.shape[2] - s - pos  # mask unwritten warmup rows
        else:
            q_offset = pos
            min_col = None
        out = _cached_attention(
            q, ck, cv, q_offset=q_offset, window=window,
            softcap=cfg.attn_softcap, prefix_len=cfg.prefix_len,
            min_col=min_col,
        )

    out = out.transpose(1, 2).reshape(b, s, h * hd)
    y = torch.einsum("bsk,kd->bsd", out, p.wo)
    return y, new_cache


def _cached_attention(q, k, v, *, q_offset: Pos, window, softcap, prefix_len,
                      min_col: Optional[Pos] = None):
    """Attention against a cache where ``q_offset`` and ``min_col`` may be
    device scalars (the decode position), masked with them on the device:
    ``cols <= q_offset + row``. Masked logits are ``-1e30``, as in the
    reference."""
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
    mask = cols <= rows
    if window is not None:
        mask &= cols > rows - window
    if prefix_len:
        mask |= cols < prefix_len
    if min_col is not None:
        mask &= cols >= min_col
    s = s.masked_fill(~mask, -1e30)
    prob = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgql,bkld->bkgqd", prob, v.float())
    return out.reshape(b, h, sq, dv).to(q.dtype)
