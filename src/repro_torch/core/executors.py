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

  On a CUDA device a group whose fn runs a contraction (a matrix product,
  a convolution, attention) or a long reduction runs task by task, one
  dispatch each: the library's batched kernel sums in another order than
  its single one (the H100's batched ``a @ b`` differs from the single
  GEMMs by ~1e-5), and every scheduler must leave ``run_serial``'s bits.
  :func:`contraction_op` finds such an op once per signature by running
  the fn on ``meta`` tensors, with no device work and no host sync, as the
  reference compiles one program per signature. On the CPU the batched
  ops round as the single ones do, so every group stays one call there.

The reference's end-of-run barrier (``jax.block_until_ready``) becomes a
synchronize of the executor's device.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .buffers import DeviceLike, resolve_device
from .task import Task

__all__ = ["ExecStats", "SerialExecutor", "FusedWaveExecutor",
           "group_by_signature", "synchronize", "contraction_op", "contraction_in"]

_LOG = logging.getLogger(__name__)


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


# ATen ops (by packet name) whose batched call may sum in another order
# than its single one: matrix products, convolutions, attention.
_CONTRACTIONS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot", "matmul",
    "linear", "einsum", "tensordot", "_int_mm", "_scaled_mm", "_weight_int8pack_mm",
})
_CONTRACTION_PREFIXES = ("conv", "_conv", "cudnn_conv", "_scaled_dot_product",
                         "_flash_attention", "_efficient_attention")
# Reductions, which keep their order only over a short axis (at most
# SHORT_REDUCTION terms an output: the physics stream's 3-vectors).
_REDUCTIONS = frozenset({"sum", "nansum", "mean", "prod", "norm", "linalg_vector_norm",
                         "var", "std", "var_mean", "std_mean", "logsumexp"})
_ALONG_DIM = frozenset({"_softmax", "_log_softmax", "_safe_softmax", "cumsum", "cumprod"})
SHORT_REDUCTION = 32


def _reduced_terms(name: str, args: Sequence[Any], out: Any) -> int:
    x = args[0]
    if name in _ALONG_DIM:
        return int(x.shape[args[1]]) if x.dim() else 1
    out = out[0] if isinstance(out, (tuple, list)) else out
    return x.numel() // max(out.numel(), 1)


class _FindContraction(TorchDispatchMode):
    """Records the first op that :func:`contraction_op` looks for."""

    def __init__(self) -> None:
        super().__init__()
        self.found: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.found is None:
            name = func.overloadpacket.__name__
            if (name in _CONTRACTIONS or name.startswith(_CONTRACTION_PREFIXES)
                    or ((name in _REDUCTIONS or name in _ALONG_DIM)
                        and _reduced_terms(name, args, out) > SHORT_REDUCTION)):
                self.found = name
        return out


# Signature -> contraction_op's answer: one meta run per signature and
# process (schedulers, and with them executors, are often built per step).
_CONTRACTION_OF: Dict[Tuple, Optional[str]] = {}


def contraction_op(task: Task) -> Optional[str]:
    """The first op of ``task.fn`` whose batched (``vmap``) call may round
    otherwise than one call per task: a contraction (``mm``, ``bmm``,
    ``addmm``, a convolution, attention, ...) or a reduction over more than
    :data:`SHORT_REDUCTION` terms an output. None for elementwise fns and
    short reductions. See :func:`contraction_in`."""
    return contraction_in(task.fn, task.signature, task.input_values())


def contraction_in(fn: Any, signature: Tuple, values: Sequence[Any]) -> Optional[str]:
    """:func:`contraction_op` for a task group given by its fn, its
    ``Task.signature`` and one task's inputs. Found by running the fn once
    on ``meta`` tensors of those inputs' shapes (no device work, no host
    sync) and cached by the signature, which names the kernel through its
    ``AcsKernel``'s uid (its second field; each launch wraps the fn anew);
    a task built by hand (uid -1) may share its opcode with another fn, so
    its fn joins the key. A fn that cannot run on ``meta`` tensors counts
    as a contraction, and the first such signature is logged."""
    key = signature if signature[1] >= 0 else (signature, fn)
    if key in _CONTRACTION_OF:
        return _CONTRACTION_OF[key]
    metas = [torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
             if isinstance(v, torch.Tensor) else v for v in values]
    finder = _FindContraction()
    try:
        with torch.no_grad(), finder:
            fn(*metas)
        found = finder.found
    except Exception as exc:  # noqa: BLE001 - any failure: run the group task by task
        found = f"unknown ({type(exc).__name__})"
        if not any(str(v).startswith("unknown") for v in _CONTRACTION_OF.values()):
            _LOG.warning("task fn %r of signature %r does not run on meta tensors (%s); "
                         "its groups run task by task on the card", fn, signature, exc)
    _CONTRACTION_OF[key] = found
    return found


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
    set; on a CUDA device, one call per task for a group whose fn runs a
    contraction or a long reduction (:func:`contraction_op`)."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.stats = ExecStats()

    def execute_wave(self, tasks: Sequence[Task]) -> None:
        if not tasks:
            return
        t0 = time.perf_counter()
        per_task = self.device.type == "cuda"
        for group in group_by_signature(tasks):
            if per_task and len(group) > 1 and contraction_op(group[0]) is not None:
                for task in group:
                    task.write_outputs(task.fn(*task.input_values()))
                self.stats.dispatches += len(group)
            else:
                _run_group(group)
                self.stats.dispatches += 1
        self.stats.tasks_run += len(tasks)
        self.stats.wave_widths.append(len(tasks))
        self.stats.exec_seconds += time.perf_counter() - t0

    def finalize(self) -> None:
        synchronize(self.device)
