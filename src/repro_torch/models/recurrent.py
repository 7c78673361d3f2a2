"""RG-LRU recurrent mixer of recurrentgemma (PyTorch port of the RG-LRU
part of ``repro/models/recurrent.py``; Mamba is still to port, ROADMAP
queue 1 item 9).

A causal depthwise conv1d and a gated diagonal linear recurrence
``h_t = a_t * h_{t-1} + b_t`` served by ``kernels.ops.lru_scan``, in
prefill (S = prompt length) and in every decode step (S = 1). The scan
runs in float32; its output is cast to the model dtype after it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ArchConfig
from .layers import dense_init

__all__ = ["RgLru", "init_rglru", "apply_rglru"]


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
    u = torch.einsum("bsd,dw->bsw", x, p.w_in)
    # jax.nn.gelu defaults to the tanh approximation; torch's default is exact.
    g = F.gelu(torch.einsum("bsd,dw->bsw", x, p.w_gate_in), approximate="tanh")

    conv_state = state[1] if state is not None else None
    u, new_conv = _causal_conv1d(u, p.conv_w, conv_state)

    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", u, p.wr))
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", u, p.wi))
    log_a = -8.0 * r * F.softplus(p.a_log)[None, None, :]
    a = torch.exp(log_a.float())
    gated = (i * u).float()
    bterm = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-6)) * gated

    h0 = (state[0].float() if state is not None
          else torch.zeros((b, u.shape[-1]), dtype=torch.float32, device=x.device))
    hs = ops.lru_scan(a.contiguous(), bterm.contiguous(), h0.contiguous())  # [B, S, W]
    hs = hs.to(x.dtype)

    y = torch.einsum("bsw,wd->bsd", hs * g, p.w_out)
    new_state = (hs[:, -1].float(), new_conv) if state is not None else None
    return y, new_state
