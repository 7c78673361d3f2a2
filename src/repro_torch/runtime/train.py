"""Fault-tolerant training loop (PyTorch port of ``repro/runtime/train.py``).

The reference's behaviours, on one card (or the CPU with ``device="cpu"``):

* **Checkpoint/restart** — params, optimizer state, gradient-compression
  error and data cursor checkpointed every ``checkpoint_every`` steps and
  at the end (atomic manifests, the reference's layout); a fresh
  ``Trainer`` on the same directory resumes exactly, from a checkpoint
  either package wrote.
* **Straggler mitigation** — per-step wall time watchdog over the WHOLE
  step, batch fetch included: a step slower than ``straggler_factor`` x
  the running median is recorded and the ``on_straggler`` hook fires.
* **Failure injection** — ``fail_at_step`` raises before that step runs.
* **Gradient compression** — optional error-feedback int8 round trip on
  the gradients (``optim/compression.py``).

The step is ``loss_and_grads`` (autograd through ``loss_fn``, flash
attention's hand-written backward on the card), ``clip_by_global_norm``
and the in-place ``adamw_update`` at the cosine schedule's lr. The weights
come from a ``torch.Generator`` seeded with ``tcfg.seed`` (other numbers
than ``jax.random``'s); MoE experts are padded with ``tp_size`` 1, as the
reference's trainer pads them, so checkpoints carry across.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import trace
from ..checkpoint import CheckpointManager
from ..core.buffers import DeviceLike, resolve_device
from ..data import DataCursor, TokenPipeline
from ..models import init_params, loss_and_grads
from ..models.config import ArchConfig
from ..models.convert import (load_params_, opt_state_from_numpy, opt_state_to_numpy,
                              params_to_numpy, tree_from_numpy, tree_to_numpy)
from ..optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    ef_int8_compress,
    ef_int8_decompress,
)
from ..tree import tree_map

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 32
    batch: int = 4
    lr: float = 3e-3
    warmup: int = 20
    total_steps: int = 400
    clip: float = 1.0
    checkpoint_every: int = 20
    keep: int = 3
    straggler_factor: float = 3.0
    grad_compression: bool = False
    seed: int = 0


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        tcfg: TrainerConfig,
        ckpt_dir: Path,
        *,
        fail_at_step: Optional[int] = None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        device: DeviceLike = "cuda",
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep=tcfg.keep)
        self.fail_at_step = fail_at_step
        self.on_straggler = on_straggler
        self.schedule = cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps)
        self.pipeline = TokenPipeline(cfg.vocab, tcfg.seq_len, tcfg.batch, seed=tcfg.seed)
        self.metrics: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []

        self.model = init_params(cfg, tcfg.seed, device=self.device, tp_size=1)
        self.model.requires_grad_(True)
        self.params = self.model.param_tree()
        self.opt = adamw_init(self.params)
        self.err = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), self.params)
                    if tcfg.grad_compression else None)

        restored = self.ckpt.restore_latest(self.state_numpy())
        if restored is not None:
            state, extras = restored
            load_params_(self.model, state["params"])
            self.opt = opt_state_from_numpy(state["opt"], cfg, device=self.device)
            if self.err is not None:
                self.err = tree_from_numpy(state["err"], cfg, device=self.device)
            self.pipeline.seek(DataCursor.from_dict(extras["cursor"]))
            self.start_step = int(extras["step"]) + 1
        else:
            self.start_step = 0

    def state_numpy(self) -> Dict[str, Any]:
        """The trainer's state as the reference's trainer holds it, in numpy:
        ``{"params", "opt": {"step", "master", "m", "v"}, "err"}``."""
        return {"params": params_to_numpy(self.model), "opt": opt_state_to_numpy(self.opt),
                "err": None if self.err is None else tree_to_numpy(self.err)}

    def _step(self, inputs: torch.Tensor, labels: torch.Tensor, lr: torch.Tensor):
        with trace.span(trace.STEP):
            loss, grads = loss_and_grads(self.model, self.cfg, inputs, labels)
            grads, gnorm = clip_by_global_norm(grads, self.tcfg.clip)
            if self.err is not None:
                # error-feedback int8 round-trip (the data-parallel wire format),
                # on the scaled gradients in float32
                q, scales, self.err = ef_int8_compress(grads.materialize(), self.err)
                grads = ef_int8_decompress(q, scales)
            adamw_update(self.params, grads, self.opt, lr)
        return {"loss": loss, "gnorm": gnorm}

    def run(self, n_steps: Optional[int] = None) -> List[Dict[str, float]]:
        end = self.tcfg.total_steps if n_steps is None else self.start_step + n_steps
        times: List[float] = []
        for step in range(self.start_step, end):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            # The watchdog times the WHOLE step, batch fetch included: an
            # input-pipeline stall delays the step exactly like a slow
            # device and must register as straggler signal.
            t0 = time.perf_counter()
            inputs, labels = self.pipeline.next_batch()
            m = self._step(torch.from_numpy(inputs).to(self.device),
                           torch.from_numpy(labels).to(self.device),
                           self.schedule(step).to(self.device))
            m = {k: float(v) for k, v in m.items()}
            dt = time.perf_counter() - t0
            times.append(dt)
            med = statistics.median(times[-25:])
            if len(times) > 5 and dt > self.tcfg.straggler_factor * med:
                self.straggler_steps.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt / med)
            m.update(step=step, dt=dt)
            self.metrics.append(m)
            if (step + 1) % self.tcfg.checkpoint_every == 0 or step + 1 == end:
                self.ckpt.save(step, self.state_numpy(),
                               extras={"cursor": self.pipeline.cursor.as_dict()})
        self.start_step = end
        return self.metrics
