"""Seeded weights and token batches, made on the device in a few large
calls; the same seed gives the same tensors on the same device, so the
harness can make them again for the reference instead of keeping a copy.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Sequence, Tuple

import torch

from .reference.model import Leaf

__all__ = ["derive_seed", "make_weights", "iter_weights", "make_batches"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def derive_seed(seed: int, what: str) -> int:
    """A 63-bit seed for one use (``"weights"``, ``"tokens"``) of the run's
    ``--seed``, which may be any whole number."""
    digest = hashlib.sha256(f"{int(seed)}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def iter_weights(leaves: Sequence[Leaf], seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each leaf's initial value, in order: one ``randn`` a dtype over all
    of that dtype's normal leaves (drawn in the dtype), each leaf a slice of
    it times ``1 / sqrt(fan_in)``; zeros where the leaf starts at zero."""
    device = torch.device(device)
    flats: Dict[str, torch.Tensor] = {}
    offsets: Dict[str, int] = {}
    for i, dt in enumerate(sorted({leaf.dtype for leaf in leaves if leaf.init == "normal"})):
        total = sum(leaf.numel for leaf in leaves if leaf.init == "normal" and leaf.dtype == dt)
        gen = torch.Generator(device=device)
        gen.manual_seed(derive_seed(seed, f"weights/{dt}"))
        flats[dt] = torch.randn(total, generator=gen, dtype=DTYPES[dt], device=device)
        offsets[dt] = 0
    for leaf in leaves:
        if leaf.init == "zeros":
            yield leaf.name, torch.zeros(leaf.shape, dtype=DTYPES[leaf.dtype], device=device)
            continue
        if leaf.init != "normal":
            raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")
        off = offsets[leaf.dtype]
        offsets[leaf.dtype] = off + leaf.numel
        flat = flats[leaf.dtype][off:off + leaf.numel].view(leaf.shape)
        yield leaf.name, flat * (1.0 / leaf.fan_in ** 0.5)


def make_weights(leaves: Sequence[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf's initial value, each a tensor of its own."""
    return dict(iter_weights(leaves, seed, device))


def make_batches(tokens: dict, vocab: int, n: int, batch: int, seq: int, seed: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` batches of ``(inputs, labels)``, each ``[n, batch, seq]`` int32:
    token ids drawn from a Zipf unigram over the whole vocabulary (rank
    ``r`` with weight ``r ** -exponent``), and with probability
    ``shift_share`` a token replaced by a shift of its predecessor,
    ``(prev * shift_mul + shift_add) % vocab``; the labels are the inputs
    moved by one. The distribution of the synthetic pipeline the program's
    trainer reads, drawn on the device."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "tokens"))
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -float(tokens["exponent"]), 0)
    cdf = cdf / cdf[-1]
    u = torch.rand((n, batch, seq + 1), generator=gen, dtype=torch.float64, device=device)
    toks = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    mix = torch.rand((n, batch, seq), generator=gen, device=device) < tokens["shift_share"]
    shifted = (toks[..., :-1] * tokens["shift_mul"] + tokens["shift_add"]) % vocab
    toks[..., 1:] = torch.where(mix, shifted, toks[..., 1:])
    toks = toks.to(torch.int32)
    return toks[..., :-1].contiguous(), toks[..., 1:].contiguous()
