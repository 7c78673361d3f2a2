"""Recurrent mixers (PyTorch port of ``repro/models/recurrent.py``):
recurrentgemma's RG-LRU and falcon-mamba's Mamba-1 block.

Both open with a causal depthwise conv1d and run a recurrence in float32,
in prefill (S = prompt length) and in every decode step (S = 1):

* RG-LRU: the gated diagonal recurrence ``h_t = a_t * h_{t-1} + b_t``,
  served by ``kernels.ops.lru_scan``; its output is cast to the model
  dtype after it. The state is ``(h [B, W] f32, conv tail [B, K-1, W])``.
* Mamba: the selective scan over ``N`` states a channel (the reference
  runs it as ``lax.scan``) with its neighbours, ``softplus(dt + dt_bias)``,
  ``-exp(A_log)``, the ``D`` skip term and the ``silu(z)`` gate, in one
  launch of ``kernels.ops.mamba_scan``; the projections and the conv stay
  PyTorch ops. The state is ``(h [B, di, N] f32, conv tail [B, K-1, di])``.

``parallel.shard`` sits where the reference constrains them: a no-op
without a mesh; over one, the recurrences run channel-sharded (the scans'
ops' sharding rules) and each block's output is ``act_btd``'s layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..parallel import shard
from . import meshed
from .config import ArchConfig
from .layers import dense_init

__all__ = ["RgLru", "Mamba", "init_rglru", "apply_rglru", "init_mamba", "apply_mamba"]


def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    w = cfg.rglru_width or d
    return {
        "w_in": dense_init(gen, (d, w), dtype),       # x branch
        "w_gate_in": dense_init(gen, (d, w), dtype),  # multiplicative branch
        "conv_w": dense_init(gen, (cfg.d_conv, w), dtype, scale=0.5),
        "wr": dense_init(gen, (w, w), dtype),         # recurrence gate
        "wi": dense_init(gen, (w, w), dtype),         # input gate
        "a_log": torch.full((w,), -0.5, dtype=torch.float32, device=gen.device),
        "w_out": dense_init(gen, (w, d), dtype),
    }


class RgLru(nn.Module):
    """The RG-LRU block's weights (the reference's names and layout)."""

    NAMES = ("w_in", "w_gate_in", "conv_w", "wr", "wi", "a_log", "w_out")

    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(params[name], requires_grad=False))

    def forward(self, x, *, state=None):
        return apply_rglru(self, x, self.cfg, state=state)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [B, S, K] @ w [K, N]``: ``einsum`` on one card; over a mesh
    ``meshed.project``'s batched product, as attention's projections
    (``einsum`` flattens B and S, which DTensor cannot shard over the data
    axes and ``model`` at once)."""
    if meshed.mesh_policy() is None:
        return torch.einsum("bsk,kn->bsn", x, w)
    return meshed.project(x, w)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor]):
    """x [B, S, W]; w [K, W] depthwise causal conv. Returns (y, new_state)
    where state is the trailing K-1 inputs (for decode)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, W]
    y = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return y.to(x.dtype), new_state


def apply_rglru(
    p: RgLru,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    *,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (h [B,W] f32, conv [B,K-1,W])
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    b = x.shape[0]
    u = _project(x, p.w_in)
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact.
    g = F.gelu(_project(x, p.w_gate_in), approximate="tanh")
    u = shard(u, "channels")

    conv_state = state[1] if state is not None else None
    u, new_conv = _causal_conv1d(u, p.conv_w, conv_state)

    r = torch.sigmoid(_project(u, p.wr))
    i = torch.sigmoid(_project(u, p.wi))
    log_a = -8.0 * r * F.softplus(p.a_log)[None, None, :]
    a = torch.exp(log_a.float())
    gated = (i * u).float()
    bterm = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-6)) * gated

    h0 = (state[0].float() if state is not None
          else torch.zeros((b, u.shape[-1]), dtype=torch.float32, device=x.device))
    hs = ops.lru_scan(a.contiguous(), bterm.contiguous(), h0.contiguous())  # [B, S, W]
    hs = shard(hs.to(x.dtype), "channels")

    y = _project(hs * g, p.w_out)
    new_state = (hs[:, -1].float(), new_conv) if state is not None else None
    return shard(y, "act_btd"), new_state


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba)
# ---------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.ssm_state
    dt_rank = max(d // 16, 1)
    dev = gen.device
    return {
        "w_in": dense_init(gen, (d, 2 * di), dtype),
        "conv_w": dense_init(gen, (cfg.d_conv, di), dtype, scale=0.5),
        "x_proj": dense_init(gen, (di, dt_rank + 2 * n), dtype),
        "dt_proj": dense_init(gen, (dt_rank, di), dtype),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                           .expand(di, n).contiguous()),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (di, d), dtype),
    }


class Mamba(nn.Module):
    """The Mamba-1 block's weights (the reference's names and layout;
    ``dt_bias``, ``A_log`` and ``D`` are float32 in every model dtype)."""

    NAMES = ("w_in", "conv_w", "x_proj", "dt_proj", "dt_bias", "A_log", "D", "w_out")

    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(params[name], requires_grad=False))

    def forward(self, x, *, state=None):
        return apply_mamba(self, x, self.cfg, state=state)


def apply_mamba(
    p: Mamba,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    *,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (h [B,di,N] f32, conv [B,K-1,di])
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    b = x.shape[0]
    di = cfg.expand * cfg.d_model
    n = cfg.ssm_state
    dt_rank = p.dt_proj.shape[0]

    xz = torch.einsum("bsd,de->bse", x, p.w_in)
    xi, z = xz[..., :di], xz[..., di:]
    xi = shard(xi, "channels")

    conv_state = state[1] if state is not None else None
    xi, new_conv = _causal_conv1d(xi, p.conv_w, conv_state)
    xi = F.silu(xi)

    proj = torch.einsum("bse,ef->bsf", xi, p.x_proj)
    dt_raw = torch.einsum("bsr,re->bse", proj[..., :dt_rank], p.dt_proj)  # [B, S, di]

    h0 = (state[0].float() if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    # softplus(dt_raw + dt_bias), the scan over -exp(A_log), the D skip and
    # the silu(z) gate, in x's dtype: one launch on the card.
    y, h_t = ops.mamba_scan(dt_raw, p.dt_bias, xi, z, proj[..., dt_rank: dt_rank + n],
                            proj[..., dt_rank + n:], p.A_log, p.D, h0.contiguous())
    y = shard(y, "channels")
    out = torch.einsum("bse,ed->bsd", y, p.w_out)
    new_state = (h_t, new_conv) if state is not None else None
    return shard(out, "act_btd"), new_state
