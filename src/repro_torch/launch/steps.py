"""An arch's steps, shared by the trainer CLI and ``chip_smoke.py`` (PyTorch
port of ``repro/launch/steps.py``): given an arch config, the train,
prefill and decode steps. The reference also lowers each step with
``jax.jit`` over a TPU mesh's sharding trees (``lower``, ``input_specs``)
for its dry runs; that is a tool of the TPU pods and is not ported
(ROADMAP)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import decode_step as model_decode
from ..models import loss_and_grads
from ..models import prefill as model_prefill
from ..models.config import ArchConfig
from ..models.transformer import LanguageModel
from ..optim import adamw_update, clip_by_global_norm

__all__ = ["StepBundle"]


class StepBundle:
    """The steps of one arch: a train step (loss, gradients through the
    kernels' backward, global-norm clip, AdamW at a constant ``lr``, in
    place) and the serving steps."""

    def __init__(self, cfg: ArchConfig, lr: float = 3e-4, clip: float = 1.0):
        self.cfg = cfg
        self.lr = lr
        self.clip = clip

    def train_step(self, params: LanguageModel, opt_state: Dict[str, Any],
                   inputs: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[LanguageModel, Dict[str, Any], Dict[str, torch.Tensor]]:
        """One step on trainable weights (``params.requires_grad_(True)``)
        and ``optim.adamw_init(params.param_tree())``'s state, both updated
        in place and returned. The metrics are device scalars."""
        loss, grads = loss_and_grads(params, self.cfg, inputs, labels)
        grads, gnorm = clip_by_global_norm(grads, self.clip)
        adamw_update(params.param_tree(), grads, opt_state, self.lr)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    def prefill_step(self, params, inputs, cache):
        return model_prefill(params, self.cfg, inputs, cache)

    def decode_step(self, params, inputs, cache, pos):
        return model_decode(params, self.cfg, inputs, cache, pos)
