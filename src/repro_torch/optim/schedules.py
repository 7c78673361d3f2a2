"""LR schedules: cosine-with-warmup and MiniCPM's Warmup-Stable-Decay
(WSD, arXiv:2404.06395 — the schedule minicpm-2b was trained with)
(PyTorch port of ``repro/optim/schedules.py``). Each returns a function of
the step (an int, a float or a 0-d tensor) giving a float32 0-d tensor."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "wsd_schedule"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """Warmup -> flat plateau -> exponential-ish decay tail (WSD)."""
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        tail = peak_lr * torch.pow(torch.tensor(floor, dtype=torch.float32), t)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, torch.tensor(peak_lr), tail))

    return lr
