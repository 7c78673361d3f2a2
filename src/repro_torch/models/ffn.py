"""Gated dense MLP (PyTorch port of the dense part of
``repro/models/ffn.py``; the MoE FFN is still to port, ROADMAP queue 1
item 9)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init

__all__ = ["GatedMlp", "init_ffn", "apply_ffn"]


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
    return torch.einsum("bsf,fd->bsd", h, p.w_down)
