"""``chip_smoke.py``'s serving (phase 6) and training (phase 9) rows on the
CPU: the launch counts it demands on the card, and the memory each cut
leaves the card.

For each config of ``SERVE_ARCHS`` and ``TRAIN_ARCHS`` a twin at the
reduced widths keeps the row's pattern, depth (its cut) and frontend. Its
kernels' plain versions, counted per call at ``ops`` (forward calls there,
backward calls through a counting autograd node on each output), must
give ``expected_launches`` over a greedy serving loop and
``expected_train_launches`` over one ``loss_and_grads`` step with remat:
the counts the card's kernels must hit exactly. ``gmm_dx_wgmma`` names the
card's ``dx`` path of a 16-bit model; the twins are float32, so it is 0.
Each row's bf16 weights (2 bytes a parameter) and its weights, gradients
and AdamW state (16 bytes a parameter) stay under 70 GB of the H100's 80,
so that a later edit cannot raise a cut past the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as C
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import (FRONTEND_DIMS, decode_step, init_cache, init_params,
                                loss_and_grads, prefill)

# Flash's launches in a server run (8 requests) and a train step (forward
# with remat's recompute / backward) of the configs this slice adds.
NEW_SERVE_FLASH = {"gemma2-27b": 128, "h2o-danube-3-4b": 192, "mistral-large-123b": 128}
NEW_TRAIN_FLASH = {"h2o-danube-3-4b": (48, 24), "paligemma-3b": (36, 18),
                   "musicgen-large": (96, 48), "gemma2-27b": (4, 2),
                   "mistral-large-123b": (2, 1)}


def _cut(arch, cuts):
    return dataclasses.replace(ARCHS[arch], **cuts.get(arch, {}))


def _twin(arch, cuts):
    return dataclasses.replace(ARCHS[arch].reduced(), n_layers=_cut(arch, cuts).n_layers)


class _Count(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, counts, keys):
        ctx.counts, ctx.keys = counts, keys
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        for key in ctx.keys:
            ctx.counts[key] += 1
        return grad, None, None


@pytest.fixture
def counts(monkeypatch):
    """Each kernel's plain version at ``ops``, counted per call (the keys of
    ``chip_smoke.train_counters``)."""
    got = dict.fromkeys(("flash", "flash_bwd", "gmm", "gmm_dx", "gmm_dx_wgmma", "gmm_dw", "lru",
                         "lru_bwd", "mamba", "mamba_bwd"), 0)

    def counted(fn, fwd, bwd):
        def wrapper(*args, **kwargs):
            got[fwd] += 1
            out = fn(*args, **kwargs)
            first = out[0] if isinstance(out, tuple) else out
            if first.requires_grad:
                first = _Count.apply(first, got, bwd)
            return (first, *out[1:]) if isinstance(out, tuple) else first
        return wrapper
    for name, fwd, bwd in (("attention", "flash", ("flash_bwd",)),
                           ("grouped_matmul", "gmm", ("gmm_dx", "gmm_dw")),
                           ("lru_scan", "lru", ("lru_bwd",)),
                           ("mamba_scan", "mamba", ("mamba_bwd",))):
        monkeypatch.setattr(ops, name, counted(getattr(ops, name), fwd, bwd))
    return got


@pytest.mark.parametrize("arch", C.SERVE_ARCHS)
def test_serving_launches_are_the_plain_calls(arch, counts):
    cfg = _twin(arch, C.SERVE_CUTS)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, n).astype(np.int32) for n in (5, 9)]
    with torch.no_grad():
        for prompt in prompts:
            cache = init_cache(cfg, 1, 32, device="cpu")
            logits, cache = prefill(params, cfg, torch.from_numpy(prompt[None]), cache)
            tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
            for i in range(C.SERVE_MAX_NEW):
                logits, cache = decode_step(params, cfg, tok[:, None], cache, len(prompt) + i)
                tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
    want = C.expected_launches(cfg, len(prompts))
    assert {"flash_attention": counts["flash"], "lru_scan": counts["lru"],
            "grouped_matmul": counts["gmm"], "selective_scan": counts["mamba"]} == want


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_train_step_launches_are_the_plain_calls(arch, counts):
    cfg = _twin(arch, C.TRAIN_CUTS)
    model = init_params(cfg, 0, device="cpu", tp_size=1).requires_grad_(True)
    inputs, labels = (torch.from_numpy(a) for a in C.train_batches(cfg)[0])
    if cfg.frontend:
        assert inputs.shape == (C.TRAIN_BATCH, C.TRAIN_SEQ, FRONTEND_DIMS[cfg.frontend])
    else:
        assert inputs.shape == (C.TRAIN_BATCH, C.TRAIN_SEQ)
    loss, _ = loss_and_grads(model, cfg, inputs, labels)
    assert torch.isfinite(loss)
    assert counts == C.expected_train_launches(cfg)


@pytest.mark.parametrize("arch", sorted(NEW_SERVE_FLASH))
def test_new_serving_rows_launch_flash_once_a_prefill_and_attention_layer(arch):
    assert arch in C.SERVE_ARCHS
    got = C.expected_launches(_cut(arch, C.SERVE_CUTS), C.SERVE_REQUESTS)
    assert got == {"flash_attention": NEW_SERVE_FLASH[arch], "lru_scan": 0, "grouped_matmul": 0,
                   "selective_scan": 0}


@pytest.mark.parametrize("arch", sorted(NEW_TRAIN_FLASH))
def test_new_train_rows_launch_flash_with_remat(arch):
    assert arch in C.TRAIN_ARCHS
    got = C.expected_train_launches(_cut(arch, C.TRAIN_CUTS))
    assert (got.pop("flash"), got.pop("flash_bwd")) == NEW_TRAIN_FLASH[arch]
    assert not any(got.values())


@pytest.mark.parametrize("arch", C.SERVE_ARCHS)
def test_serving_cut_fits_the_card(arch):
    assert 2 * _cut(arch, C.SERVE_CUTS).n_params <= C.CARD_MAX_BYTES


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_train_cut_fits_the_card(arch):
    assert 16 * _cut(arch, C.TRAIN_CUTS).n_params <= C.CARD_MAX_BYTES
