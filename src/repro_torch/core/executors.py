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
  reference compiles one program per signature. On the CPU a group whose
  fn runs a convolution runs task by task too (:func:`per_task_group`):
  a vmapped stride-1 or stride-2 3x3 conv over six ``[1,12,16,16]`` maps
  is ~1e-5 off the per-task calls there (``tests/test_torch_dyn.py``),
  while pooling, the elementwise ops, ``gap`` and ``mix_weights`` are
  bit-equal (torch 2.13, CPU). Other CPU groups stay one call: the expert
  stream's GEMM groups are bit-equal there, and its dispatches equal the
  reference's.
* :class:`GroupExecutor` — the frontier half-executor: one homogeneous
  group per launch, split into non-blocking ``launch()`` / ``poll()``
  halves. ``launch`` runs the group on the current CUDA stream (by the
  route above) and records a ``torch.cuda.Event`` after it; ``poll`` is
  that event's ``query()``; ``sync`` is its ``synchronize()``, the
  blocking fallback, counted in ``ExecStats.blocking_syncs``. Downstream
  groups read the written tensors in stream order, so no host sync stands
  between dependent groups.

The reference's end-of-run barrier (``jax.block_until_ready``) becomes a
synchronize of the executor's device.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .buffers import DeviceLike, resolve_device
from .task import Task

__all__ = ["ExecStats", "SerialExecutor", "FusedWaveExecutor", "GroupExecutor", "GroupHandle",
           "group_by_signature", "synchronize", "contraction_op", "contraction_in",
           "per_task_group"]

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
        # Host-blocking device syncs: the threaded scheduler's StreamSync
        # per task, the frontier's fallback sync of its oldest group.
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
_CONVOLUTIONS = ("conv", "_conv", "cudnn_conv", "mkldnn_conv")
_CONTRACTION_PREFIXES = _CONVOLUTIONS + ("_scaled_dot_product", "_flash_attention",
                                         "_efficient_attention")
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


def per_task_group(fn: Any, signature: Tuple, values: Sequence[Any],
                   device: torch.device) -> bool:
    """The route every executor and the device window's step path share:
    True when a homogeneous group of two or more tasks (given as for
    :func:`contraction_in`) runs one call per task, as ``run_serial``
    would, instead of one vmapped call. On a CUDA device: any op
    :func:`contraction_in` finds. On the CPU: a convolution (the module
    docstring has the measurements)."""
    found = contraction_in(fn, signature, values)
    return found is not None and (device.type == "cuda" or found.startswith(_CONVOLUTIONS))


def _run_per_task(group: Sequence[Task]) -> None:
    for task in group:
        task.write_outputs(task.fn(*task.input_values()))


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
    set, or one call per task where :func:`per_task_group` says so."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.stats = ExecStats()

    def execute_wave(self, tasks: Sequence[Task]) -> None:
        if not tasks:
            return
        t0 = time.perf_counter()
        for group in group_by_signature(tasks):
            t = group[0]
            if len(group) > 1 and per_task_group(t.fn, t.signature, t.input_values(),
                                                 self.device):
                _run_per_task(group)
                self.stats.dispatches += len(group)
            else:
                _run_group(group)
                self.stats.dispatches += 1
        self.stats.tasks_run += len(tasks)
        self.stats.wave_widths.append(len(tasks))
        self.stats.exec_seconds += time.perf_counter() - t0

    def finalize(self) -> None:
        synchronize(self.device)


class GroupHandle:
    """An in-flight homogeneous group: its tasks (whose window slots it
    still occupies), the event recorded after its launch (None on the CPU,
    where a launch has landed when it returns) and the host launch stamp."""

    __slots__ = ("tasks", "event", "t_launch")

    def __init__(self, tasks: Sequence[Task], event: Optional[torch.cuda.Event],
                 t_launch: float):
        self.tasks = list(tasks)
        self.event = event
        self.t_launch = t_launch


class GroupExecutor:
    """Non-blocking group launches for the frontier scheduler.

    ``launch`` runs one homogeneous group on the current CUDA stream — one
    ``vmap`` call, or one call per task where :func:`per_task_group` says
    so, exactly as :class:`FusedWaveExecutor` runs it — writes the results
    into the output buffers and records an event. The host does not wait:
    a downstream group reads those tensors later in the same stream.
    ``poll`` is the non-blocking completion probe (``event.query()``);
    ``sync`` is the blocking fallback (``event.synchronize()``), counted in
    ``stats.blocking_syncs``.

    ``warm`` is the reference's compile-ahead half. Eager PyTorch compiles
    nothing, and running the fn on zeros would be real device work (and
    would launch the hand-written kernels a serving fn reaches), so it only
    classifies the group's route (:func:`per_task_group`: one ``meta`` run
    per signature and process).

    The executor owns the **in-flight ledger**: ``launch`` appends to
    ``inflight`` (oldest first) and ``poll_landed``/``sync_oldest`` consume
    it, so groups stay in flight across session submissions. One live
    session per executor.
    """

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.stats = ExecStats()
        self.inflight: Deque[GroupHandle] = collections.deque()

    def warm(self, group: Sequence[Task]) -> bool:
        """The group's route: True when it runs one call per task. No
        device work."""
        t = group[0]
        return len(group) > 1 and per_task_group(t.fn, t.signature, t.input_values(),
                                                 self.device)

    def launch(self, group: Sequence[Task]) -> GroupHandle:
        if self.warm(group):
            _run_per_task(group)
            self.stats.dispatches += len(group)
        else:
            _run_group(group)
            self.stats.dispatches += 1
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.stats.tasks_run += len(group)
        self.stats.wave_widths.append(len(group))
        handle = GroupHandle(group, event, time.perf_counter())
        self.inflight.append(handle)
        return handle

    def poll(self, handle: GroupHandle) -> bool:
        """True iff the group's work has finished on the device."""
        return handle.event is None or handle.event.query()

    def poll_landed(self) -> List[GroupHandle]:
        """Remove and return every in-flight group that has landed
        (non-blocking) — the session's rolling-retire probe."""
        landed: List[GroupHandle] = []
        still: Deque[GroupHandle] = collections.deque()
        for handle in self.inflight:
            (landed if self.poll(handle) else still).append(handle)
        self.inflight = still
        return landed

    def sync(self, handle: GroupHandle) -> None:
        """Blocking fallback: wait for the group (the §II-D overhead)."""
        if handle.event is not None:
            handle.event.synchronize()
        self.stats.blocking_syncs += 1
        try:
            self.inflight.remove(handle)
        except ValueError:
            pass  # already consumed via poll_landed/sync_oldest

    def sync_oldest(self) -> Optional[GroupHandle]:
        """Blocking-sync the oldest in-flight group (its downstreams have
        waited longest); None when nothing is in flight."""
        if not self.inflight:
            return None
        handle = self.inflight.popleft()
        self.sync(handle)
        return handle

    def finalize(self) -> None:
        synchronize(self.device)
