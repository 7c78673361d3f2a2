"""Wave executors — how a set of READY kernels runs (PyTorch port of
``repro/core/executors.py``).

* :class:`SerialExecutor` — one call per task, in program order: the
  paper's single-stream baseline.
* :class:`FusedWaveExecutor` — the ACS-SW wave. The READY set is
  partitioned by ``Task.signature``, oldest group first, and each group of
  two or more tasks runs as ONE ``torch.func.vmap`` call over its stacked
  inputs (N small kernels -> one batched kernel per op), where the
  reference emits one ``jax.jit(vmap)`` program per wave. Eager PyTorch
  has no whole-wave program, so a wave costs one call per group. The
  batched ops are elementwise or reduce a short trailing axis, and are
  held bit-equal to serial on the CPU and on the card
  (``tests/test_torch_schedulers.py``, ``chip_smoke.py``).

The reference's end-of-run barrier (``jax.block_until_ready``) becomes a
synchronize of the executor's device.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .buffers import DeviceLike, resolve_device
from .task import Task

__all__ = ["ExecStats", "SerialExecutor", "FusedWaveExecutor",
           "group_by_signature", "synchronize"]


def synchronize(device: torch.device) -> None:
    """Block until every queued kernel on ``device`` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ExecStats:
    def __init__(self) -> None:
        self.dispatches = 0  # calls issued by the host: per task, or per vmapped group
        # Compiled programs built. Eager PyTorch builds none: kept so the
        # report keys match the reference's.
        self.compiles = 0
        self.tasks_run = 0
        self.wave_widths: List[int] = []
        self.exec_seconds = 0.0
        # Host-blocking device syncs the scheduler issued per task (the
        # threaded scheduler's StreamSync).
        self.blocking_syncs = 0

    def as_dict(self) -> Dict[str, Any]:
        w = np.asarray(self.wave_widths or [0])
        return {
            "dispatches": self.dispatches,
            "compiles": self.compiles,
            "tasks_run": self.tasks_run,
            "waves": len(self.wave_widths),
            "mean_wave_width": float(w.mean()),
            "max_wave_width": int(w.max()),
            "exec_seconds": self.exec_seconds,
            "blocking_syncs": self.blocking_syncs,
        }


def group_by_signature(tasks: Sequence[Task]) -> List[List[Task]]:
    """Partition tasks into homogeneous (batchable) groups, oldest-first."""
    groups: Dict[Tuple, List[Task]] = {}
    order: List[Tuple] = []
    for t in tasks:
        key = t.signature
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(t)
    return [groups[k] for k in order]


class SerialExecutor:
    """Single-stream baseline: every kernel is its own call."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.stats = ExecStats()

    def execute_wave(self, tasks: Sequence[Task]) -> None:
        t0 = time.perf_counter()
        for task in tasks:
            task.write_outputs(task.fn(*task.input_values()))
            self.stats.dispatches += 1
            self.stats.tasks_run += 1
            self.stats.wave_widths.append(1)
        self.stats.exec_seconds += time.perf_counter() - t0

    def finalize(self) -> None:
        synchronize(self.device)


def _run_group(group: Sequence[Task]) -> None:
    """One call for a homogeneous group: the task's own fn for a group of
    one, else ``vmap(fn)`` over the inputs stacked along a new axis 0."""
    if len(group) == 1:
        group[0].write_outputs(group[0].fn(*group[0].input_values()))
        return
    vals = [t.input_values() for t in group]
    stacked = [torch.stack([v[i] for v in vals]) for i in range(len(vals[0]))]
    outs = torch.func.vmap(group[0].fn)(*stacked)
    for i, task in enumerate(group):
        if isinstance(outs, (tuple, list)):
            task.write_outputs(tuple(o[i] for o in outs))
        else:
            task.write_outputs(outs[i])


class FusedWaveExecutor:
    """ACS-SW wave: one (vmapped) call per signature group of the READY
    set."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.stats = ExecStats()

    def execute_wave(self, tasks: Sequence[Task]) -> None:
        if not tasks:
            return
        t0 = time.perf_counter()
        groups = group_by_signature(tasks)
        for group in groups:
            _run_group(group)
        self.stats.dispatches += len(groups)
        self.stats.tasks_run += len(tasks)
        self.stats.wave_widths.append(len(tasks))
        self.stats.exec_seconds += time.perf_counter() - t0

    def finalize(self) -> None:
        synchronize(self.device)
