"""Shared layer primitives: RMSNorm, rotary embeddings, initializers
(PyTorch port of ``repro/models/layers.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["rms_norm", "rope", "apply_rope", "dense_init", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32 and scale by ``1 + w``; the result is in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope(positions: torch.Tensor, dim: int,
         theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding. positions [S] -> [S, dim/2]."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, D] rotated pairwise (split-halves convention)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)  # broadcast over leading axes
    c, s = cos.reshape(shape), sin.reshape(shape)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """Normal(0, 1) from ``gen`` (on the generator's device), times
    ``scale / sqrt(fan_in)``, in ``dtype``; fan_in is ``shape[0]``. On the
    meta device an empty tensor of that shape and dtype."""
    if gen.device.type == "meta":  # shapes only (``init_params(device="meta")``)
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return (scale * x / float(np.sqrt(fan_in))).to(dtype)
