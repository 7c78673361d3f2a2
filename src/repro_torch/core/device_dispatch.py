"""ACS-HW: the scheduling window on the device (PyTorch port of
``repro/core/device_dispatch.py``).

The paper's ACS-HW moves the window into GPU hardware so that kernel
completion -> upstream update -> ready dispatch never round-trips to the
CPU. Here the host runs the windowed dependency analysis once per stream
(or epoch) and lowers it over a shape-class slab arena (`core/arena.py`)
into integer tables, in one of three plan modes:

* ``"wave"`` / ``"frontier"``: the window is planned into steps (wave
  fronts, or one homogeneous frontier group per step: `plan_waves`,
  `plan_frontier`) and `lower_plan` turns each step into arena-addressed
  :class:`DeviceStep` groups with dense row tables. The epoch runs as a
  host loop over the steps, one ``torch.func.vmap`` call per group (the
  reference's ``lax.scan`` program; `_build_program` keeps its run-length
  segmentation; a group whose fn runs a contraction on a CUDA device, or
  a convolution on the CPU, makes one call per task, so the result keeps
  ``run_serial``'s bits: ``executors.per_task_group``).
  When every task of the epoch fits the **wave megakernel**
  (``kernels/wave_elementwise.py``, CUDA: one shape class of
  padding-free float32 1-D rows, no views, two inputs, one output, every
  fn its opcode's registered switch branch), each plan step lowers a
  second time, to one ``[S, 4]`` descriptor table, and the whole plan runs
  as ONE persistent ``wave_epoch`` launch, in place on the slab, with a
  grid barrier between steps where the host loop had a round per step.
* ``"loop"``: the epoch lowers to a ready-queue program
  (`lower_epoch_program`): per-task operand rows, in-degrees, forward
  edges from :func:`~.scoreboard.dependency_arrays` and an initial ready
  ring, run by the **ready-queue kernel** (``kernels/ready_queue.py``,
  CUDA, one launch for the epoch) when eligible, else by a host
  interpreter over the same ring.

Both kernels take only padding-free 1-D rows of one shape class, so the
dynamic-DNN streams (``dyn/``: NCHW maps of many classes, convs and pools)
never reach them, as in the reference: their wave and frontier epochs run
the step path and their loop epochs the interpreter.

:class:`DeviceWindowRunner` is the closed-batch form: each ``run`` plans,
lowers, packs a fresh arena and syncs once. :class:`DeviceSession` is the
persistent form: a live :class:`~.session.SchedulerSession` that drains
its window in epochs over a session-lifetime arena whose slabs stay on the
device, with a structure-keyed plan cache, a host path for opaque operands
inside an epoch, and an audit of every host<->device sync.

The seed's uniform-shape interpreter survives as the legacy path
(`compile_wave_plan` + `DeviceWindowRunner.execute_uniform`): one padded
``(D,)`` shape, arity <= 3, refused loudly beyond.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .arena import SlabArena, pad_to
from .buffers import Buffer, BufferView, DeviceLike, resolve_device
from .executors import (ExecStats, SerialExecutor, group_by_signature, per_task_group,
                        synchronize)
from .scheduler import PLAN_MODES, SchedulerReport
from .scoreboard import dependency_arrays
from .session import SchedulerSession
from .task import Task, operand_base, operand_shape
from .window import SchedulingWindow

__all__ = [
    "DeviceOpRegistry",
    "compile_wave_plan",
    "plan_waves",
    "plan_frontier",
    "plan_active_fraction",
    "lower_plan",
    "lower_epoch_program",
    "EpochProgram",
    "DeviceStep",
    "DeviceWindowRunner",
    "DeviceSession",
    "ExportedRow",
]

MAX_ARITY = 3  # legacy uniform-slab path only; the arena path has no limit


class DeviceOpRegistry:
    """The device executor's fixed opcode table (the paper's HW window
    supports a finite kernel set burned in next to the command processor).

    ``register`` assigns each kernel name a stable opcode. ``strict``
    registries refuse to lower tasks whose opcode was never registered;
    non-strict registries auto-register on first sight. During lowering the
    registry records which shape classes each opcode ran over
    (``classes_seen``).
    """

    def __init__(self, strict: bool = True) -> None:
        self._ops: List[Tuple[str, Optional[Callable]]] = []
        self._index: Dict[str, int] = {}
        self.strict = strict
        # opcode name -> set of (input class labels, output class labels)
        self.classes_seen: Dict[str, set] = {}
        # The device kernels' fixed branch table: opcode name -> elementwise
        # shape-preserving fn. Kernel eligibility requires a task's fn to BE
        # the registered branch (object identity), so a kernel can never
        # silently diverge from what the host path would execute.
        self._branch_fns: Dict[str, Callable] = {}

    def register(self, name: str, fn: Optional[Callable] = None) -> int:
        """Register ``name`` (idempotent). ``fn`` is the legacy uniform-path
        branch ``fn(x, y, z) -> out``; the arena path runs each task's own
        fn. Re-registering a known name upgrades an fn-less entry; a
        *different* fn for a name that already has one raises."""
        idx = self._index.get(name)
        if idx is not None:
            stored = self._ops[idx][1]
            if fn is not None:
                if stored is None:
                    self._ops[idx] = (name, fn)
                elif stored is not fn:
                    raise ValueError(
                        f"opcode {name!r} already registered with a different "
                        "branch fn; device opcodes are fixed per registry"
                    )
            return idx
        idx = len(self._ops)
        self._ops.append((name, fn))
        self._index[name] = idx
        return idx

    def opcode(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            if not self.strict:
                return self.register(name)
            raise KeyError(
                f"opcode {name!r} is not in the device registry "
                f"(registered: {sorted(self._index) or 'none'}); register it "
                "or build the runner with an auto-registering registry"
            )
        return idx

    def note_classes(self, name: str, in_labels: Tuple[str, ...],
                     out_labels: Tuple[str, ...]) -> None:
        self.classes_seen.setdefault(name, set()).add((in_labels, out_labels))

    def register_switch_branch(self, name: str, fn: Callable) -> int:
        """Admit ``fn`` to the device kernels' branch table (and register
        the opcode name). Re-registering the same fn is idempotent; a
        different fn for a known name is a conflict."""
        stored = self._branch_fns.get(name)
        if stored is not None and stored is not fn:
            raise ValueError(
                f"switch branch {name!r} already registered with a different "
                "fn; the device switch table is fixed per registry")
        self._branch_fns[name] = fn
        return self.register(name)

    def switch_branch(self, name: str) -> Optional[Callable]:
        """The registered kernel branch fn for ``name`` (None if the opcode
        is interpreter-only)."""
        return self._branch_fns.get(name)

    @property
    def branches(self) -> List[Callable]:
        """Legacy uniform-path branch table (registration order): every
        registered name must carry an ``fn(x, y, z)`` branch."""
        missing = [n for n, fn in self._ops if fn is None]
        if missing:
            raise ValueError(
                "legacy uniform path needs an fn(x, y, z) branch for every "
                f"registered opcode; missing: {missing} (real kernels are "
                "registered fn-less — run them through the arena path)"
            )
        return [fn for _, fn in self._ops]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self._ops)


# ---------------------------------------------------------------------------
# Planning: run the windowed scheduler symbolically (no execution)
# ---------------------------------------------------------------------------

def plan_waves(tasks: Sequence[Task], window_size: int = 32,
               return_window: bool = False):
    """Run the windowed scheduler symbolically to obtain the wave plan.
    With ``return_window=True`` also returns the planning
    :class:`SchedulingWindow`, whose stats are the real numbers behind the
    plan."""
    window = SchedulingWindow(window_size)
    window.submit_all(tasks)
    waves: List[List[Task]] = []
    while not window.drained():
        ready = window.ready_tasks()
        if not ready:
            raise RuntimeError("stall while planning waves")
        for t in ready:
            window.mark_executing(t)
        waves.append(ready)
        window.retire_many(ready)
    return (waves, window) if return_window else waves


def plan_frontier(
    tasks: Sequence[Task], window_size: int = 32, max_group: Optional[int] = None,
    return_window: bool = False,
):
    """Frontier-plan mode: one homogeneous group per device step. The READY
    set is re-collected after every group, so newly unblocked kernels join
    the very next step instead of waiting out a whole wave front: steps are
    narrower but denser (a higher active-slot fraction)."""
    window = SchedulingWindow(window_size)
    window.submit_all(tasks)
    groups: List[List[Task]] = []
    while not window.drained():
        ready = window.ready_tasks()
        if not ready:
            raise RuntimeError("stall while planning frontier groups")
        group = group_by_signature(ready)[0]
        if max_group is not None:
            group = group[:max_group]
        for t in group:
            window.mark_executing(t)
        window.retire_many(group)
        groups.append(group)
    return (groups, window) if return_window else groups


def plan_active_fraction(plan: Sequence[Sequence[Task]]) -> float:
    """Fraction of (step, slot) table cells holding a real kernel when each
    step is padded to the widest: the padding-waste metric the frontier
    plan improves."""
    if not plan:
        return 1.0
    max_w = max(len(step) for step in plan)
    return sum(len(step) for step in plan) / (len(plan) * max_w)


# ---------------------------------------------------------------------------
# Legacy lowering: one uniform (D,) shape class, arity <= 3
# ---------------------------------------------------------------------------

def compile_wave_plan(
    waves: Sequence[Sequence[Task]],
    registry: DeviceOpRegistry,
    buffer_index: Dict[str, int],
    n_rows: int,
) -> Dict[str, np.ndarray]:
    """Lower a wave schedule to dense dispatch tables over one uniform slab
    (row ``n_rows`` is a scratch row for inactive slots). Over-arity and
    multi-output tasks are refused: the arena path (`lower_plan`) has
    neither limit."""
    n_waves = len(waves)
    max_w = max((len(w) for w in waves), default=1)
    dummy = n_rows
    opc = np.zeros((n_waves, max_w), dtype=np.int32)
    ins = np.full((n_waves, max_w, MAX_ARITY), dummy, dtype=np.int32)
    outs = np.full((n_waves, max_w), dummy, dtype=np.int32)
    active = np.zeros((n_waves, max_w), dtype=bool)
    for wi, wave in enumerate(waves):
        for si, task in enumerate(wave):
            if len(task.inputs) > MAX_ARITY:
                raise ValueError(
                    f"task {task.opcode}#{task.tid} has {len(task.inputs)} "
                    f"operands but the legacy uniform-slab path supports at "
                    f"most {MAX_ARITY}; use the arena path "
                    "(DeviceWindowRunner.execute) for variable arity"
                )
            if len(task.outputs) != 1:
                raise ValueError(
                    f"task {task.opcode}#{task.tid} has {len(task.outputs)} "
                    "outputs but the legacy uniform-slab path supports "
                    "exactly one; use the arena path "
                    "(DeviceWindowRunner.execute) for multi-output tasks"
                )
            opc[wi, si] = registry.opcode(task.opcode)
            for ai, op in enumerate(task.inputs):
                ins[wi, si, ai] = buffer_index[operand_base(op).name]
            outs[wi, si] = buffer_index[operand_base(task.outputs[0]).name]
            active[wi, si] = True
    return {"opcode": opc, "ins": ins, "outs": outs, "active": active}


# ---------------------------------------------------------------------------
# Arena lowering: per-class tables, variable arity, multi-output, views
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _OperandSpec:
    """Static half of one operand column (shared by the whole group)."""

    class_id: int
    true_shape: Tuple[int, ...]
    is_view: bool
    view_rows: int  # leading-axis rows covered when is_view


@dataclasses.dataclass(frozen=True)
class _StepSpec:
    """Static half of one device step (one homogeneous task group)."""

    opcode: int
    width: int
    inputs: Tuple[_OperandSpec, ...]
    outputs: Tuple[_OperandSpec, ...]
    signature: Tuple  # group Task.signature


@dataclasses.dataclass
class DeviceStep:
    """One lowered step: one homogeneous task group, dense row tables.

    ``in_rows``/``out_rows`` are ``[n_operands, width]`` int32 slab row
    ids; ``*_starts`` carry the leading-axis offset for view operands
    (zero otherwise)."""

    spec: _StepSpec
    fn: Callable
    in_rows: np.ndarray
    in_starts: np.ndarray
    out_rows: np.ndarray
    out_starts: np.ndarray
    tids: Tuple[int, ...]

    def tables(self) -> Dict[str, np.ndarray]:
        return {
            "in_rows": self.in_rows, "in_starts": self.in_starts,
            "out_rows": self.out_rows, "out_starts": self.out_starts,
        }


def _operand_spec(arena: SlabArena, op) -> Tuple[_OperandSpec, int, int]:
    """Returns (static spec, row, start) for one operand occurrence."""
    addr = arena.address(op)
    return (
        _OperandSpec(
            class_id=addr.class_id,
            true_shape=tuple(operand_shape(op)),
            is_view=addr.is_view,
            view_rows=addr.row_count if addr.is_view else 0,
        ),
        addr.row,
        addr.row_start,
    )


def _lowering_groups(wave: Sequence[Task], arena: SlabArena) -> List[List[Task]]:
    """Partition tasks into arena-homogeneous groups, oldest-first.

    ``Task.signature`` alone is not enough: a full ``(2, 4)`` buffer and a
    2-row view of an ``(8, 4)`` buffer are signature-equal yet need
    different gather/scatter code, so the key also carries each operand's
    static arena addressing (class id, view-ness, view extent)."""

    def opkey(op):
        addr = arena.address(op)
        return (addr.class_id, addr.is_view, addr.row_count)

    groups: Dict[Tuple, List[Task]] = {}
    order: List[Tuple] = []
    for t in wave:
        key = (
            t.signature,
            tuple(opkey(o) for o in t.inputs),
            tuple(opkey(o) for o in t.outputs),
        )
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(t)
    return [groups[k] for k in order]


def _group_tables(group: Sequence[Task], arena: SlabArena
                  ) -> Tuple[List[_OperandSpec], List[_OperandSpec], Dict[str, np.ndarray]]:
    """One homogeneous group's operand specs (from its head) and dense
    ``[n_operands, count]`` row/start tables."""
    head = group[0]
    n_in, n_out, count = len(head.inputs), len(head.outputs), len(group)
    in_specs: List[_OperandSpec] = []
    out_specs: List[_OperandSpec] = []
    tbl = {
        "in_rows": np.zeros((n_in, count), np.int32),
        "in_starts": np.zeros((n_in, count), np.int32),
        "out_rows": np.zeros((n_out, count), np.int32),
        "out_starts": np.zeros((n_out, count), np.int32),
    }
    for gi, task in enumerate(group):
        for i, op in enumerate(task.inputs):
            spec, row, start = _operand_spec(arena, op)
            tbl["in_rows"][i, gi], tbl["in_starts"][i, gi] = row, start
            if gi == 0:
                in_specs.append(spec)
        for o, op in enumerate(task.outputs):
            spec, row, start = _operand_spec(arena, op)
            tbl["out_rows"][o, gi], tbl["out_starts"][o, gi] = row, start
            if gi == 0:
                out_specs.append(spec)
    return in_specs, out_specs, tbl


def _note_group_classes(registry: DeviceOpRegistry, arena: SlabArena, name: str,
                        in_specs: Sequence[_OperandSpec],
                        out_specs: Sequence[_OperandSpec]) -> None:
    registry.note_classes(
        name,
        tuple(arena.classes[sp.class_id].label for sp in in_specs),
        tuple(arena.classes[sp.class_id].label for sp in out_specs))


def lower_plan(
    plan: Sequence[Sequence[Task]],
    registry: DeviceOpRegistry,
    arena: SlabArena,
) -> List[DeviceStep]:
    """Lower a wave/frontier plan to arena-addressed device steps: each plan
    step (a wave, or an already homogeneous frontier group) is partitioned
    into arena-homogeneous groups (tasks within a plan step are
    independent, so sub-step order is free), each one :class:`DeviceStep`
    with a static spec and dense per-operand row tables."""
    steps: List[DeviceStep] = []
    for wave in plan:
        for group in _lowering_groups(wave, arena):
            head = group[0]
            opcode = registry.opcode(head.opcode)
            in_specs, out_specs, tbl = _group_tables(group, arena)
            _note_group_classes(registry, arena, head.opcode, in_specs, out_specs)
            steps.append(
                DeviceStep(
                    spec=_StepSpec(opcode, len(group), tuple(in_specs),
                                   tuple(out_specs), head.signature),
                    fn=head.fn,
                    tids=tuple(t.tid for t in group),
                    **tbl,
                )
            )
    return steps


def _gather_operand(slabs: Sequence[torch.Tensor], spec: _OperandSpec,
                    rows: np.ndarray, starts: np.ndarray, width: int,
                    dev_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather one operand column: ``[width, *true_shape]`` (unbatched when
    width == 1), padding trimmed, contiguous like every value a serial run
    passes, and always a copy, so a scatter later in the step cannot
    change it."""
    slab = slabs[spec.class_id]
    trim = tuple(slice(0, s) for s in spec.true_shape)
    if width == 1:
        val = slab[int(rows[0])]
        if spec.is_view:
            start = int(starts[0])
            val = val[start:start + spec.view_rows]
        return val[trim].clone(memory_format=torch.contiguous_format)
    if spec.is_view:
        vals = torch.stack([slab[int(r), int(s):int(s) + spec.view_rows]
                            for r, s in zip(rows, starts)])
    else:
        if dev_rows is None:
            dev_rows = torch.as_tensor(rows, dtype=torch.long, device=slab.device)
        vals = slab.index_select(0, dev_rows)
    return vals[(slice(None),) + trim].contiguous()


def _scatter_operand(slabs: Sequence[torch.Tensor], spec: _OperandSpec,
                     rows: np.ndarray, starts: np.ndarray, width: int,
                     val: torch.Tensor, dev_rows: Optional[torch.Tensor] = None) -> None:
    """Write one output column into its class slab, in place (the slabs are
    the executor's own), zero-filling the padding."""
    slab = slabs[spec.class_id]
    padded_row = tuple(slab.shape[1:])
    if spec.is_view:
        # Two view writes of one step may target the SAME parent row at
        # disjoint intervals, so they go one at a time: a vectorized
        # scatter would keep only one of the duplicated rows.
        target = (spec.view_rows,) + padded_row[1:]
        for g in range(width):
            v = val[g] if width > 1 else val
            start = int(starts[g])
            slab[int(rows[g]), start:start + spec.view_rows] = pad_to(v, target).to(slab.dtype)
    elif width == 1:
        slab[int(rows[0])] = pad_to(val, padded_row).to(slab.dtype)
    else:
        if dev_rows is None:
            dev_rows = torch.as_tensor(rows, dtype=torch.long, device=slab.device)
        slab.index_copy_(0, dev_rows, pad_to(val, (width,) + padded_row).to(slab.dtype))


def _per_task(fn: Callable, signature: Tuple, ins: Sequence[torch.Tensor]) -> bool:
    """A step group that must run one call per task
    (``executors.per_task_group``: on a CUDA device a fn with a contraction
    or a long reduction, on the CPU a convolution)."""
    return per_task_group(fn, signature, [x[0] for x in ins], ins[0].device)


def _apply_step(slabs: Sequence[torch.Tensor], spec: _StepSpec, fn: Callable,
                tables: Dict[str, np.ndarray],
                dev_rows: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Run one homogeneous group over the slabs: gather every input column,
    then one call (``fn`` for a group of one, else ``torch.func.vmap(fn)``),
    then scatter. Everything is gathered before anything is scattered: a
    task may read the row it writes. A group that ``_per_task`` picks (on
    a CUDA device a contraction, on the CPU a convolution) calls ``fn`` once
    per task instead, each on its own copy of its inputs, as ``run_serial``
    would: the batched call sums in another order."""
    din = dev_rows.get("in_rows") if dev_rows else None
    dout = dev_rows.get("out_rows") if dev_rows else None
    ins = [
        _gather_operand(slabs, s, tables["in_rows"][i], tables["in_starts"][i],
                        spec.width, None if din is None else din[i])
        for i, s in enumerate(spec.inputs)
    ]
    if spec.width > 1 and _per_task(fn, spec.signature, ins):
        per = [fn(*(x[g].clone() for x in ins)) for g in range(spec.width)]
        out = (tuple(torch.stack(o) for o in zip(*per)) if isinstance(per[0], (tuple, list))
               else torch.stack(per))
    else:
        out = torch.func.vmap(fn)(*ins) if spec.width > 1 else fn(*ins)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if len(outs) != len(spec.outputs):
        raise ValueError(
            f"device step opcode {spec.opcode}: kernel returned {len(outs)} "
            f"values for {len(spec.outputs)} outputs"
        )
    for o, s in enumerate(spec.outputs):
        _scatter_operand(slabs, s, tables["out_rows"][o], tables["out_starts"][o],
                         spec.width, outs[o], None if dout is None else dout[o])


def _build_program(
    steps: Sequence[DeviceStep],
) -> Tuple[Callable, List[Tuple[_StepSpec, Callable, int]]]:
    """Returns ``(run_program, runs)``. ``runs`` is the reference's
    run-length segmentation (runs of consecutive steps with an identical
    static spec, which it compiles into one ``lax.scan`` each);
    ``run_program(slabs, run_tables)`` walks them in eager PyTorch, one
    :func:`_apply_step` per step, updating ``slabs`` in place."""
    runs: List[Tuple[_StepSpec, Callable, int]] = []  # (spec, fn, run length)
    for st in steps:
        if runs and runs[-1][0] == st.spec:
            spec, fn, n = runs[-1]
            runs[-1] = (spec, fn, n + 1)
        else:
            runs.append((st.spec, st.fn, 1))

    def run_program(slabs: List[torch.Tensor], run_tables: Sequence[Dict]) -> List[torch.Tensor]:
        for (spec, fn, length), tables in zip(runs, run_tables):
            host, dev = tables["host"], tables["dev"]
            if length == 1:
                _apply_step(slabs, spec, fn, host, dev)
                continue
            for i in range(length):
                _apply_step(slabs, spec, fn, {k: v[i] for k, v in host.items()},
                            {k: v[i] for k, v in dev.items()})
        return slabs

    return run_program, runs


def _run_tables(steps: Sequence[DeviceStep],
                runs: Sequence[Tuple[_StepSpec, Callable, int]]) -> List[Dict[str, np.ndarray]]:
    """Stack each run's per-step tables: ``[T, n_operands, width]`` for a
    run of T > 1 steps, plain ``[n_operands, width]`` for a singleton."""
    tables: List[Dict[str, np.ndarray]] = []
    idx = 0
    for _, _, length in runs:
        chunk = steps[idx: idx + length]
        idx += length
        if length == 1:
            tables.append(dict(chunk[0].tables()))
        else:
            tables.append({k: np.stack([s.tables()[k] for s in chunk])
                           for k in chunk[0].tables()})
    return tables


def _device_tables(tables: Sequence[Dict[str, np.ndarray]], runs,
                   device: torch.device) -> List[Dict]:
    """Each run's tables for the executor: the host arrays (view starts and
    width-1 rows are read as ints) and, for runs of groups wider than one,
    their row tables uploaded once as index tensors."""
    out = []
    for (spec, _, _), tbl in zip(runs, tables):
        dev = {}
        if spec.width > 1:
            dev = {k: torch.as_tensor(tbl[k], dtype=torch.long, device=device)
                   for k in ("in_rows", "out_rows")}
        out.append({"host": tbl, "dev": dev})
    return out


# ---------------------------------------------------------------------------
# Wave-kernel lowering: a whole plan step as one descriptor table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WaveKernelProgram:
    """A plan lowered for the wave megakernel: one ``[S_i, 4]`` descriptor
    block ``(branch, in0_row, in1_row, out_row)`` per plan step, stacked
    into ``desc`` with ``offsets[i]:offsets[i + 1]`` the rows of step i;
    ``direct[i]`` says step i may write its rows in place at once (no slot
    reads a row another slot of the step writes), marked once per
    program."""

    class_id: int
    branches: Tuple[Callable, ...]
    desc: np.ndarray      # [sum S_i, 4] int32
    offsets: Tuple[int, ...]
    direct: Tuple[bool, ...]

    @property
    def n_steps(self) -> int:
        return len(self.offsets) - 1

    def payload(self, device: torch.device) -> Dict[str, Any]:
        return {"desc": torch.from_numpy(self.desc).to(device), "offsets": self.offsets}


def _wave_kernel_parts(plan: Sequence[Sequence[Task]], registry: DeviceOpRegistry,
                       arena: SlabArena) -> Tuple[Optional[WaveKernelProgram], str]:
    """Wave-kernel eligibility and lowering: ``(program, "")`` when every
    task fits the kernel, else ``(None, why)``. The rules are the ready
    queue's (`_loop_kernel_parts`) with exactly two inputs: one shape class
    of padding-free 1-D float32 rows, no views, one output, and every fn IS
    its opcode's registered switch branch."""
    tasks = [t for step in plan for t in step]
    if not tasks:
        return None, "empty plan"
    branches: Dict[Callable, int] = {}
    cids = set()
    for t in tasks:
        if len(t.inputs) != 2 or len(t.outputs) != 1:
            return None, (f"task {t.opcode}#{t.tid} has {len(t.inputs)} inputs and "
                          f"{len(t.outputs)} outputs (the kernel takes 2 and 1)")
        if registry.switch_branch(t.opcode) is not t.fn:
            return None, f"task {t.opcode}#{t.tid}'s fn is not its registered switch branch"
        for op in tuple(t.inputs) + tuple(t.outputs):
            addr = arena.address(op)
            cids.add(addr.class_id)
            cls = arena.classes[addr.class_id]
            if addr.is_view or len(cls.padded_shape) != 1 \
                    or tuple(operand_shape(op)) != cls.padded_shape:
                return None, (f"operand {op.name!r} is not a padding-free 1-D row "
                              f"(class {cls.label})")
            if cls.dtype != "float32":
                return None, f"class {cls.label} is not float32"
        branches.setdefault(t.fn, len(branches))
    if len(cids) != 1:
        return None, f"{len(cids)} shape classes (the kernel takes one slab)"
    desc = np.zeros((len(tasks), 4), np.int32)
    offsets = [0]
    i = 0
    for step in plan:
        for t in step:
            desc[i] = (branches[t.fn], arena.address(t.inputs[0]).row,
                       arena.address(t.inputs[1]).row, arena.address(t.outputs[0]).row)
            i += 1
        offsets.append(i)
    from ..kernels.wave_elementwise import direct_steps

    return WaveKernelProgram(cids.pop(), tuple(branches), desc, tuple(offsets),
                             direct_steps(desc, offsets)), ""


def _run_wave_kernel(slabs: List[torch.Tensor], program: WaveKernelProgram,
                     payload: Dict[str, Any], err: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The whole plan as ONE ``wave_epoch`` launch, in place on the
    program's slab (the runner's and the session's own: no copy); the
    caller checks ``err`` where it syncs."""
    from ..kernels.wave_elementwise import wave_epoch

    wave_epoch(slabs[program.class_id], payload["desc"], payload["offsets"],
               branches=program.branches, err=err, direct=program.direct)
    return slabs


def _wave_err(device: torch.device) -> Optional[torch.Tensor]:
    """The wave kernel's deferred error flag (None on the CPU, where the
    plain version raises at once)."""
    return torch.zeros(1, dtype=torch.int32, device=device) if device.type == "cuda" else None


# ---------------------------------------------------------------------------
# Ready-queue lowering: the whole dependency frontier in one dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EpochProgram:
    """One epoch lowered as a ready-queue program: per-spec static halves
    (``specs``/``fns``/``opnames``), per-spec dense address tables, the
    per-task ``(spec_id, spec_pos)`` dispatch map, the dependency arrays and
    the initial ring. Order is decided by the queue as it runs; the tables
    only say where each task's operands live and whom it wakes."""

    specs: Tuple[_StepSpec, ...]
    fns: Tuple[Callable, ...]
    opnames: Tuple[str, ...]
    spec_tables: List[Dict[str, np.ndarray]]  # per spec: [n_operands, count]
    spec_id: np.ndarray    # [n] int32: task position -> spec index
    spec_pos: np.ndarray   # [n] int32: task position -> column in its tables
    indeg: np.ndarray      # [n] int32 initial upstream counters
    dep_tbl: np.ndarray    # [n, m] int32 forward edges, sentinel n
    ring0: np.ndarray      # [n+1] int32 initially-ready positions, pad n
    tail0: int             # count of initially-ready tasks
    tids: Tuple[int, ...]

    @property
    def n_tasks(self) -> int:
        return len(self.tids)

    def payload(self, device: Any) -> Dict[str, torch.Tensor]:
        """The ready-queue kernel's operands as int32 tensors on
        ``device``: task table, forward edges, counters, ring, tail."""
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        return {
            "task_tbl": as_dev(_loop_task_table(self)),
            "dep_tbl": as_dev(self.dep_tbl),
            "rem0": as_dev(np.concatenate([self.indeg, np.zeros(1, np.int32)])),
            "ring0": as_dev(self.ring0),
            "tail0": as_dev(np.asarray([self.tail0])),
        }


def lower_epoch_program(tasks: Sequence[Task], registry: DeviceOpRegistry,
                        arena: SlabArena) -> EpochProgram:
    """Lower one epoch (tasks in program order) to a ready-queue program.

    Tasks group purely by structure (`_lowering_groups` over the whole
    epoch), each group contributing one spec and dense per-task address
    columns, and the exact dependency arrays ride along so the device can
    discover the execution order itself. Program order is topological, so
    every edge points forward and the queue never starves.
    """
    tasks = list(tasks)
    n = len(tasks)
    groups = _lowering_groups(tasks, arena)

    # Canonical group order (sorted by structure), so two epochs over the
    # same spec set but different arrival interleavings lower alike.
    def _group_key(g):
        head = g[0]
        return (head.opcode, repr(head.signature),
                repr([(arena.address(o).class_id, arena.address(o).is_view,
                       arena.address(o).row_count)
                      for o in tuple(head.inputs) + tuple(head.outputs)]))

    groups.sort(key=_group_key)
    specs: List[_StepSpec] = []
    fns: List[Callable] = []
    opnames: List[str] = []
    spec_tables: List[Dict[str, np.ndarray]] = []
    spec_id = np.zeros(n, np.int32)
    spec_pos = np.zeros(n, np.int32)
    pos = {t.tid: i for i, t in enumerate(tasks)}
    for s, group in enumerate(groups):
        head = group[0]
        opcode = registry.opcode(head.opcode)
        for gi, task in enumerate(group):
            spec_id[pos[task.tid]] = s
            spec_pos[pos[task.tid]] = gi
        in_specs, out_specs, tbl = _group_tables(group, arena)
        _note_group_classes(registry, arena, head.opcode, in_specs, out_specs)
        # width 1: the queue runs tasks one at a time, each slicing its column
        specs.append(_StepSpec(opcode, 1, tuple(in_specs), tuple(out_specs),
                               head.signature))
        fns.append(head.fn)
        opnames.append(head.opcode)
        spec_tables.append(tbl)

    indeg, dep_tbl = dependency_arrays(tasks)
    ready = np.flatnonzero(indeg == 0)
    ring0 = np.full(n + 1, n, np.int32)
    ring0[: len(ready)] = ready
    return EpochProgram(
        specs=tuple(specs), fns=tuple(fns), opnames=tuple(opnames),
        spec_tables=spec_tables, spec_id=spec_id, spec_pos=spec_pos,
        indeg=indeg, dep_tbl=dep_tbl, ring0=ring0, tail0=int(len(ready)),
        tids=tuple(t.tid for t in tasks),
    )


def _run_loop_interpreter(slabs: List[torch.Tensor], program: EpochProgram
                          ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The general ready-queue executor (the reference's ``lax.while_loop``
    interpreter): a host loop over the ring, each pop running its task's fn
    on its column of the spec tables. Updates ``slabs`` in place; returns
    them with the ``[n] int32`` completion flags."""
    n = program.n_tasks
    dep_tbl = program.dep_tbl.tolist()
    remaining = program.indeg.tolist() + [0]  # + trash slot
    ring = program.ring0.tolist()
    done = [0] * n
    head, tail = 0, program.tail0
    while head < tail:
        t = ring[head]
        s = int(program.spec_id[t])
        col = int(program.spec_pos[t])
        _apply_step(slabs, program.specs[s], program.fns[s],
                    {k: v[:, col:col + 1] for k, v in program.spec_tables[s].items()})
        done[t] = 1
        for d in dep_tbl[t]:  # sentinel n lands in the trash slot
            remaining[d] -= 1
            if d < n and remaining[d] == 0:
                ring[tail] = d
                tail += 1
        head += 1
    return slabs, torch.tensor(done, dtype=torch.int32)


def _loop_kernel_parts(program: EpochProgram, registry: DeviceOpRegistry,
                       arena: SlabArena) -> Optional[Tuple[int, Tuple[Callable, ...]]]:
    """Kernel eligibility: ``(class_id, branches)`` when every spec fits the
    ready-queue kernel, else None. Requirements: one shape class with
    padding-free 1-D rows, no views, arity <= 3, exactly one output, and
    every fn IS its opcode's registered switch branch. ``branches[s]`` is
    spec ``s``'s fn (the task table's branch column holds spec ids)."""
    if not program.specs:
        return None
    cids = {sp.class_id for st in program.specs
            for sp in st.inputs + st.outputs}
    if len(cids) != 1:
        return None
    cid = cids.pop()
    padded = arena.classes[cid].padded_shape
    if len(padded) != 1:
        return None
    for spec, fn, name in zip(program.specs, program.fns, program.opnames):
        if len(spec.outputs) != 1 or len(spec.inputs) > 3:
            return None
        for sp in spec.inputs + spec.outputs:
            if sp.is_view or tuple(sp.true_shape) != tuple(padded):
                return None
        if registry.switch_branch(name) is not fn:
            return None
    return cid, tuple(program.fns)


def _loop_task_table(program: EpochProgram) -> np.ndarray:
    """Flatten the per-spec tables into the kernel's ``[n, 5]`` dispatch
    rows ``(branch, in0, in1, in2, out_row)``; unused input slots alias the
    task's own output row (always a valid slab index)."""
    n = program.n_tasks
    task_tbl = np.zeros((n, 5), np.int32)
    for i in range(n):
        s = int(program.spec_id[i])
        col = int(program.spec_pos[i])
        tbl = program.spec_tables[s]
        out_row = int(tbl["out_rows"][0, col])
        rows = [int(r) for r in tbl["in_rows"][:, col]]
        rows += [out_row] * (3 - len(rows))
        task_tbl[i] = [s] + rows + [out_row]
    return task_tbl


def _run_loop_kernel(slabs: List[torch.Tensor], class_id: int,
                     branches: Tuple[Callable, ...], p: Dict[str, torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run the epoch through the ready-queue kernel (the reference's
    ``_build_loop_pallas`` binding) on the payload ``p``
    (:meth:`EpochProgram.payload`), in the interpreter's calling
    convention."""
    from ..kernels.ready_queue import ready_queue

    slab, done, _ring = ready_queue(
        slabs[class_id], p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"],
        p["tail0"], branches=branches)
    out = list(slabs)
    out[class_id] = slab
    return out, done


def _kernel_wanted(flag: Optional[bool], device: torch.device) -> bool:
    """Executor selection shared by both kernels: None = the CUDA kernel on
    a GPU, True = the kernel path wherever eligible (its wrapper runs the
    plain version on the CPU), False = never."""
    return device.type == "cuda" if flag is None else bool(flag)


def _kernel_executor(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "ref"


def _wave_counts() -> Tuple[int, int]:
    """The wave kernel's (launches, epoch steps) counters."""
    we = importlib.import_module("..kernels.wave_elementwise", __package__)
    return we.launches, we.steps


class DeviceWindowRunner:
    """Execute a whole task stream as ONE device epoch.

    ``run`` takes a task iterable and returns a :class:`SchedulerReport`
    (the ``make_scheduler`` contract) whose window stats come from the
    planning pass, with ``exec_stats.dispatches == 1`` per stream, the plan
    (wave widths, ``report.waves``, ``report.plan_active_fraction``) and
    arena occupancy in ``report.arena_stats``.

    Host-clock spans of one run, in order: ``report.plan_seconds`` (window,
    arena rows, lowering, eligibility), ``report.payload_seconds`` (the
    tables' upload), ``report.pack_seconds`` (``arena.pack``),
    ``exec_stats["exec_seconds"]`` (the steps or kernels and the epoch's
    one host sync) and ``report.unpack_seconds`` (write-back);
    ``wall_seconds`` is their sum.

    ``plan_mode`` is ``"wave"`` (the default, as in the reference),
    ``"frontier"`` (``max_group`` caps a group) or ``"loop"``. Executor
    selection, per plan mode: ``wave_kernel`` (wave/frontier) and
    ``loop_kernel`` (loop; the reference's ``loop_pallas``) are None = the
    CUDA kernel when the device is a GPU and the stream is eligible, True =
    the kernel path whenever eligible (on the CPU its wrapper runs the
    plain version), False = never. ``report.wave_executor`` is ``"cuda"``,
    ``"ref"`` or ``"steps"`` (with ``report.wave_kernel_refusal`` saying
    why the kernel did not take the stream, and
    ``report.wave_kernel_launches`` its launches, one per run on the card,
    and ``report.wave_kernel_steps`` the plan steps they ran, equal to
    ``len(report.waves)``); ``report.loop_executor``
    is ``"cuda"``, ``"ref"`` or ``"interpreter"``.
    """

    def __init__(
        self,
        registry: Optional[DeviceOpRegistry] = None,
        window_size: int = 32,
        plan_mode: str = "wave",
        max_group: Optional[int] = None,
        pad_multiple: int = 8,
        loop_kernel: Optional[bool] = None,
        wave_kernel: Optional[bool] = None,
        device: DeviceLike = "cuda",
    ):
        if plan_mode not in PLAN_MODES:
            raise ValueError(f"plan_mode must be one of {PLAN_MODES}, got {plan_mode!r}")
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else DeviceOpRegistry(strict=False)
        self.window_size = window_size
        self.plan_mode = plan_mode
        self.max_group = max_group
        self.pad_multiple = pad_multiple
        self.loop_kernel = loop_kernel
        self.wave_kernel = wave_kernel

    def session(self) -> "DeviceSession":
        """Open a persistent :class:`DeviceSession` sharing this runner's
        opcode registry (each session owns its own arena)."""
        return DeviceSession(window_size=self.window_size, registry=self.registry,
                             plan_mode=self.plan_mode, max_group=self.max_group,
                             pad_multiple=self.pad_multiple, loop_kernel=self.loop_kernel,
                             wave_kernel=self.wave_kernel, device=self.device)

    def _plan(self, tasks: Sequence[Task]):
        if self.plan_mode == "frontier":
            return plan_frontier(tasks, self.window_size, self.max_group,
                                 return_window=True)
        return plan_waves(tasks, self.window_size, return_window=True)

    def run(self, stream: Iterable[Task]) -> SchedulerReport:
        """`make_scheduler` contract: task iterable in, report out."""
        return self.execute(list(stream))

    def _arena(self, tasks: Sequence[Task], buffers: Optional[Sequence]) -> SlabArena:
        arena = SlabArena(pad_multiple=self.pad_multiple)
        if buffers is not None:
            for b in buffers:
                arena.add(b)
        arena.add_tasks(tasks)
        return arena

    @staticmethod
    def _report(window, stats: ExecStats, spans: Sequence[float], plan, plan_mode: str,
                active: float, arena: SlabArena, device_steps: int) -> SchedulerReport:
        t0, t1, t2, t3, t4, t5 = spans
        report = SchedulerReport(window, stats, t5 - t0, [[t.tid for t in w] for w in plan])
        report.plan_seconds = t1 - t0  # type: ignore[attr-defined]
        report.payload_seconds = t2 - t1  # type: ignore[attr-defined]
        report.pack_seconds = t3 - t2  # type: ignore[attr-defined]
        report.unpack_seconds = t5 - t4  # type: ignore[attr-defined]
        report.plan_mode = plan_mode  # type: ignore[attr-defined]
        report.plan_active_fraction = active  # type: ignore[attr-defined]
        report.arena_stats = {  # type: ignore[attr-defined]
            "n_classes": arena.n_classes(),
            "total_waste_frac": round(arena.total_waste_frac(), 4),
            "per_class": arena.padding_waste(),
            "device_steps": device_steps,
        }
        return report

    def execute(self, tasks: Sequence[Task],
                buffers: Optional[Sequence] = None) -> SchedulerReport:
        """Plan (wave fronts or frontier groups), lower over a fresh arena,
        run the epoch, sync once, write back."""
        if self.plan_mode == "loop":
            return self._execute_loop(list(tasks), buffers)
        tasks = list(tasks)
        t0 = time.perf_counter()
        plan, window = self._plan(tasks)
        arena = self._arena(tasks, buffers)
        steps = lower_plan(plan, self.registry, arena)
        wave, refusal = (_wave_kernel_parts(plan, self.registry, arena)
                         if _kernel_wanted(self.wave_kernel, self.device)
                         else (None, "wave_kernel=False"))
        t1 = time.perf_counter()

        if wave is not None:
            payload, err = wave.payload(self.device), _wave_err(self.device)
        else:
            run_fn, runs = _build_program(steps)
            tables = _device_tables(_run_tables(steps, runs), runs, self.device)
        t2 = time.perf_counter()
        slabs = arena.pack(self.device)
        t3 = time.perf_counter()
        launches0, steps0 = _wave_counts()
        if wave is not None:
            out_slabs = _run_wave_kernel(slabs, wave, payload, err)
        else:
            out_slabs = run_fn(slabs, tables)
        synchronize(self.device)  # the epoch's one host sync
        if wave is not None and err is not None:
            from ..kernels.wave_elementwise import raise_on_error

            raise_on_error(err)
        launches, kernel_steps = _wave_counts()
        launches, kernel_steps = launches - launches0, kernel_steps - steps0
        t4 = time.perf_counter()
        written = [operand_base(op) for t in tasks for op in t.outputs]
        arena.unpack(out_slabs, only=None if buffers is not None else written)
        t5 = time.perf_counter()

        stats = ExecStats()
        stats.dispatches = 1  # the whole stream was one epoch
        stats.tasks_run = len(tasks)
        stats.wave_widths = [len(w) for w in plan]
        stats.exec_seconds = t4 - t3
        report = self._report(window, stats, (t0, t1, t2, t3, t4, t5), plan,
                              self.plan_mode, plan_active_fraction(plan), arena, len(steps))
        report.wave_executor = (  # type: ignore[attr-defined]
            "steps" if wave is None else _kernel_executor(self.device))
        report.wave_kernel_refusal = refusal  # type: ignore[attr-defined]
        report.wave_kernel_launches = launches  # type: ignore[attr-defined]
        report.wave_kernel_steps = kernel_steps  # type: ignore[attr-defined]
        return report

    def _execute_loop(self, tasks: List[Task],
                      buffers: Optional[Sequence] = None) -> SchedulerReport:
        """``plan_mode="loop"``: lower the whole stream as ONE ready-queue
        program — no host-side schedule at all; the queue discovers
        execution order from the dependency arrays. The planning window
        still runs symbolically for its stats, and the one host sync at the
        end asserts every completion flag."""
        t0 = time.perf_counter()
        _, window = plan_waves(tasks, self.window_size, return_window=True)
        arena = self._arena(tasks, buffers)
        program = lower_epoch_program(tasks, self.registry, arena)
        parts = (_loop_kernel_parts(program, self.registry, arena)
                 if _kernel_wanted(self.loop_kernel, self.device) else None)
        t1 = time.perf_counter()
        payload = program.payload(self.device) if parts is not None else None
        t2 = time.perf_counter()
        slabs = arena.pack(self.device)
        t3 = time.perf_counter()
        if parts is not None:
            out_slabs, done = _run_loop_kernel(slabs, parts[0], parts[1], payload)
        else:
            out_slabs, done = _run_loop_interpreter(slabs, program)
        done_host = done.cpu().numpy()  # the epoch's one host sync
        synchronize(self.device)
        t4 = time.perf_counter()
        if not bool(done_host.all()):
            missing = [program.tids[i] for i in np.flatnonzero(done_host == 0)]
            raise RuntimeError(
                f"ready-queue epoch stalled: tasks {missing} never became "
                "ready (dependency arrays disagree with program order)")
        written = [operand_base(op) for t in tasks for op in t.outputs]
        arena.unpack(out_slabs, only=None if buffers is not None else written)
        t5 = time.perf_counter()

        stats = ExecStats()
        stats.dispatches = 1
        stats.tasks_run = len(tasks)
        stats.wave_widths = [len(tasks)]
        stats.exec_seconds = t4 - t3
        # Dense by construction: every table column holds a real task.
        report = self._report(window, stats, (t0, t1, t2, t3, t4, t5), [tasks],
                              self.plan_mode, 1.0, arena, len(program.specs))
        report.loop_executor = (  # type: ignore[attr-defined]
            "interpreter" if parts is None else _kernel_executor(self.device))
        return report

    # -- legacy uniform path (the seed's interpreter) -----------------------
    def _uniform_interpreter(self) -> Callable:
        branches = self.registry.branches

        def run(slab: torch.Tensor, plan: Dict[str, np.ndarray]) -> torch.Tensor:
            # slab: [rows + 1, D]; per wave: opcode [S], ins [S, 3],
            # outs [S], active [S]. Every slot reads the wave's input slab.
            for opc, ins, outs, active in zip(plan["opcode"], plan["ins"],
                                              plan["outs"], plan["active"]):
                results = [branches[int(op)](slab[int(i[0])], slab[int(i[1])],
                                             slab[int(i[2])])
                           for op, i, act in zip(opc, ins, active) if act]
                slab = slab.clone()
                for out_row, res in zip(outs[active], results):
                    slab[int(out_row)] = res
            return slab

        return run

    def execute_uniform(self, tasks: Sequence[Task],
                        buffers: Sequence) -> SchedulerReport:
        """The seed's single-shape-class interpreter (a switch over registry
        branches ``fn(x, y, z)``, arity <= 3, one output, every buffer of
        one ``(D,)`` shape). Kept as the legacy path; `execute` is the
        general one."""
        t0 = time.perf_counter()
        plan, window = self._plan(tasks)
        plan_time = time.perf_counter() - t0

        buffer_index = {b.name: i for i, b in enumerate(buffers)}
        tables = compile_wave_plan(plan, self.registry, buffer_index, len(buffers))
        run = self._uniform_interpreter()
        d = int(buffers[0].shape[-1])
        first = torch.as_tensor(buffers[0].value)
        slab = torch.stack([torch.as_tensor(b.value).to(self.device) for b in buffers]
                           + [torch.zeros((d,), dtype=first.dtype, device=self.device)])
        t1 = time.perf_counter()
        slab = run(slab, tables)
        synchronize(self.device)
        exec_time = time.perf_counter() - t1
        for i, b in enumerate(buffers):
            b.value = slab[i].clone()

        stats = ExecStats()
        stats.dispatches = 1
        stats.tasks_run = len(tasks)
        stats.wave_widths = [len(w) for w in plan]
        stats.exec_seconds = exec_time
        report = SchedulerReport(window, stats, plan_time + exec_time,
                                 [[t.tid for t in w] for w in plan])
        report.plan_seconds = plan_time  # type: ignore[attr-defined]
        report.plan_mode = self.plan_mode  # type: ignore[attr-defined]
        report.plan_active_fraction = plan_active_fraction(plan)  # type: ignore[attr-defined]
        return report


# ---------------------------------------------------------------------------
# Persistent device window: the live-session form of ACS-HW
# ---------------------------------------------------------------------------

def _device_lowerable(task: Task) -> bool:
    """True iff every operand can live in the slab arena: array-valued (or
    not-yet-produced) buffers whose values match their declared shapes.
    Opaque values (a server's ``(cache, token, pos)`` slot) and raw byte
    views take the host path inside the epoch."""
    for op in tuple(task.inputs) + tuple(task.outputs):
        if isinstance(op, BufferView) and op.row_start is None:
            return False
        base = operand_base(op)
        val = base.value
        if val is None:
            continue
        shape = getattr(val, "shape", None)
        if shape is None or getattr(val, "dtype", None) is None:
            return False
        if tuple(shape) != tuple(base.shape):
            return False
    return True


def _tensors(value: Any) -> Iterable[torch.Tensor]:
    """Every CUDA tensor inside a host value: a tensor, or tuples, lists
    and dicts of them (a server slot's ``(cache, token, pos)``)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


@dataclasses.dataclass
class ExportedRow:
    """A slab row in flight between two shards (``DeviceSession.export_row``):
    a copy of the row, and the CUDA event recorded after the copy on the
    owner's stream (None on the CPU, where the copy is done on return)."""

    value: torch.Tensor
    event: Optional[torch.cuda.Event]


def _event_ready(event: Optional[torch.cuda.Event]) -> bool:
    """Non-blocking completion probe of a dispatch (the reference's
    ``jax.Array.is_ready``): the CUDA event recorded after it has been
    reached. No event (the CPU, where work finishes before the call
    returns) counts as ready."""
    return event is None or event.query()


class DeviceSession(SchedulerSession):
    """Persistent device-resident window: the rolling, live-fed ACS-HW.

    Producers ``submit()`` tasks (or feed a ``TaskStream(sink=session)``)
    at any time; each ``poll``/``drive`` drains everything admitted so far
    as one **epoch**:

    1. the live window is planned (wave fronts or frontier groups, as the
       runner plans them; ``"loop"`` drains it in program order);
    2. the epoch's slice is lowered against the **session-lifetime arena**:
       slabs stay on the device across epochs (only rows for newly seen
       buffers are appended), and a **structure-keyed plan cache** (LRU,
       ``plan_cache_limit``) maps a recurring slice straight to its
       uploaded tables, skipping the lowering; a **spec-keyed program
       cache** shares run programs between entries;
    3. the slice runs in ONE dispatch (the wave kernel, the ready-queue
       kernel or the step loop, chosen per dispatch as in the runner);
       host values re-sync only at retire boundaries (a watched task: a
       listener, a callback or a ticket; ``sync``/``flush``/``close``).
       ``host_syncs`` counts every transition, d2h and h2d, per tag.

    Tasks whose operands cannot live in the arena execute host-side within
    the epoch, in plan order, with slab re-sync at each device/host
    transition. ``release_buffer`` (a ``BufferPool`` free hook) recycles a
    buffer's row; classes whose dead rows cross ``compact_waste`` are
    compacted between dispatches, dropping exactly the plan-cache entries
    that addressed them.

    Device residency is a contract with the producer: while the session is
    open, buffers it has packed are written only through submitted tasks,
    and a direct read of ``buf.value`` after a bare ``poll()`` may see a
    pre-epoch value until the next sync (call ``sync()`` first).

    ``launch()`` dispatches everything admitted WITHOUT retiring: each
    device segment parks with a CUDA event recorded after its dispatch,
    and ``poll_inflight()`` retires landed segments oldest-first (FIFO,
    program order), probing the events with ``query()``.

    ``device`` is where the slabs live (default ``"cuda"``). ``stream``
    (a ``torch.cuda.Stream`` on that device; the mesh gives each shard its
    own) carries every dispatch, event and sync of the session: a sync
    waits on that stream alone, not on the whole card, and each dispatch
    first waits for the work its producer queued on the stream that was
    current when the session was made. ``None`` (the default) runs on the
    current stream and syncs the device.

    The mesh's halves (:class:`~.mesh_session.ShardLink`): ``sync_buffers``
    and ``mark_host_dirty`` stage a row through the host; ``export_row``
    copies a device-authoritative row on this session's stream and records
    an event, ``import_row`` makes this session's stream wait for that
    event before writing the row; ``invalidate_row`` drops a superseded
    copy's claim. ``pad_payloads=True`` is refused: the reference pads
    payloads to keep XLA from retracing, and eager PyTorch does not trace.
    """

    def __init__(
        self,
        window_size: int = 32,
        registry: Optional[DeviceOpRegistry] = None,
        plan_mode: str = "wave",
        max_group: Optional[int] = None,
        pad_multiple: int = 8,
        compact_waste: float = 0.5,
        compact_min_rows: int = 8,
        plan_cache_limit: Optional[int] = 512,
        history_limit: Optional[int] = None,
        loop_kernel: Optional[bool] = None,
        wave_kernel: Optional[bool] = None,
        device: DeviceLike = "cuda",
        pad_payloads: bool = False,
        stream: Optional["torch.cuda.Stream"] = None,
    ):
        if plan_mode not in PLAN_MODES:
            raise ValueError(
                f"plan_mode must be one of {PLAN_MODES}, got {plan_mode!r}")
        if pad_payloads:
            raise NotImplementedError(
                "DeviceSession(pad_payloads=True) is refused: the reference pads payloads "
                "to keep XLA from retracing, and eager PyTorch does not trace")
        self.device = resolve_device(device)
        if stream is not None and self.device.type != "cuda":
            raise ValueError(f"a CUDA stream cannot carry a session on {self.device}")
        self.stream = stream
        # The stream the producer's values are queued on (initial state,
        # uploads): every dispatch on ``stream`` waits for it first.
        self._producer = (torch.cuda.current_stream(self.device) if stream is not None
                          else None)
        super().__init__(window_size, history_limit=history_limit)
        self.registry = registry if registry is not None else DeviceOpRegistry(strict=False)
        self.plan_mode = plan_mode
        self.max_group = max_group
        self.loop_kernel = loop_kernel
        self.wave_kernel = wave_kernel
        self.arena = SlabArena(pad_multiple=pad_multiple, compact_waste=compact_waste,
                               compact_min_rows=compact_min_rows)
        self._slabs: Optional[List[torch.Tensor]] = None
        # id(Buffer) -> Buffer whose freshest value lives device-side
        # (slab newer than host) / host-side (host newer than slab).
        self._device_dirty: Dict[int, Buffer] = {}
        self._host_dirty: Dict[int, Buffer] = {}
        # id(Buffer) -> the stream tag that made it host-dirty from outside
        # (the mesh's "mesh-transfer"), added to its h2d refresh's tags.
        self._host_dirty_tags: Dict[int, str] = {}
        # structure key -> (run, payload, n_steps, class generations,
        # executor): the session-scope plan cache, insertion order = LRU.
        self._plan_cache: Dict[Tuple, Tuple] = {}
        self.plan_cache_limit = plan_cache_limit
        self.plan_cache_evictions = 0
        self.plan_cache_invalidations = 0
        # static step-spec structure -> run program
        self._programs: Dict[Tuple, Any] = {}
        self.stats = ExecStats()
        # In-epoch host path: a serial executor sharing this session's stats.
        self._host_exec = SerialExecutor(self.device)
        self._host_exec.stats = self.stats
        self.epochs = 0
        self.device_dispatches = 0
        self.loop_dispatches = 0  # ready-queue dispatches (subset of device)
        self.wave_kernel_dispatches = 0  # wave-kernel dispatches (subset of device)
        self.host_task_dispatches = 0
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        # host_syncs = d2h slab read-backs + h2d row refreshes forced by
        # host-path writes, also per stream tag.
        self.host_syncs = 0
        self.host_syncs_d2h = 0
        self.host_syncs_h2d = 0
        self.host_syncs_by_tag: Dict[str, int] = {}
        # The mesh's d2d row moves and write-owner invalidations.
        self.d2d_row_exports = 0
        self.d2d_row_imports = 0
        self.row_invalidations = 0
        # The wave kernel's error flag, shared by every launch and read
        # where the session syncs anyway (None on the CPU).
        self._wave_err = _wave_err(self.device)
        self._wave_unchecked = False
        # The last dispatch's completion event (None on the CPU), and the
        # deferred segments of launch(): (plan, event), oldest first.
        self._last_event: Optional[torch.cuda.Event] = None
        self._inflight: deque = deque()
        self._defer_retire = False
        self.epoch_log: Any = ([] if history_limit is None
                               else deque(maxlen=history_limit))

    # -- epoch planning ----------------------------------------------------
    def _plan_epoch(self) -> List[List[Task]]:
        """Drain the live window symbolically into this epoch's plan: wave
        fronts, or one homogeneous frontier group per step (led by the most
        urgent READY kernels: ``ready_tasks()`` is priority-bucketed)."""
        plan: List[List[Task]] = []
        while not self.window.idle():
            ready = self.window.ready_tasks()
            if not ready:
                raise RuntimeError(
                    "device session stall: no READY kernels but window non-empty")
            if self.plan_mode == "frontier":
                group = group_by_signature(ready)[0]
                if self.max_group is not None:
                    group = group[: self.max_group]
            else:
                group = ready
            for t in group:
                self.window.mark_executing(t)
            self.window.retire_many(group)
            plan.append(group)
        return plan

    # -- sync bookkeeping --------------------------------------------------
    @staticmethod
    def _tags_of(tasks: Iterable[Task]) -> Tuple[str, ...]:
        return tuple({getattr(t, "stream_tag", None) or "untagged" for t in tasks})

    def _count_sync(self, direction: str, tags: Iterable[str]) -> None:
        self.host_syncs += 1
        if direction == "d2h":
            self.host_syncs_d2h += 1
        else:
            self.host_syncs_h2d += 1
        for tag in tags or ("untagged",):
            self.host_syncs_by_tag[tag] = self.host_syncs_by_tag.get(tag, 0) + 1

    def _check_wave_errors(self) -> None:
        """Raise if any wave-kernel launch since the last check met a bad
        descriptor (a flag read: call only where the device is synced)."""
        if self._wave_unchecked and self._wave_err is not None:
            from ..kernels.wave_elementwise import raise_on_error

            self._wave_unchecked = False
            raise_on_error(self._wave_err)

    def _on_stream(self):
        """The context every device call of the session runs in: its own
        stream, after that stream waits for the producer's (a no-op
        context without a stream)."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(self._producer)
        return torch.cuda.stream(self.stream)

    def _wait(self) -> None:
        """Block the host until the session's work has finished: its
        stream's, or the whole device's without one."""
        if self.stream is not None:
            self.stream.synchronize()
        else:
            synchronize(self.device)

    def _sync_to_host(self, buffers: Iterable[Buffer], tags: Iterable[str] = ()) -> None:
        """Write the given buffers' slab rows back to host values (ONE
        blocking sync, counted; ``tags`` attributes it to the stream tags
        that forced it). The copies are queued on the session's stream
        before the wait, so the values are complete when it returns."""
        bufs = [b for b in buffers if id(b) in self._device_dirty]
        if not bufs or self._slabs is None:
            return
        with self._on_stream():
            self.arena.unpack(self._slabs, only=bufs)
        self._wait()
        self._check_wave_errors()
        for b in bufs:
            del self._device_dirty[id(b)]
        self._count_sync("d2h", tuple(tags))

    def sync(self) -> None:
        """Force every device-resident value back to host buffers."""
        with self._lock:
            self._sync_to_host(list(self._device_dirty.values()), tags=("sync",))

    def sync_buffers(self, buffers: Iterable[Buffer],
                     tags: Iterable[str] = ("transfer",)) -> None:
        """Sync just the given buffers' device values back to host (one
        counted d2h when any is device-dirty). The mesh stages a
        cross-shard edge as: owner ``sync_buffers``, destination
        ``mark_host_dirty``, destination's next dispatch re-uploads."""
        with self._lock:
            self._sync_to_host(list(buffers), tags=tuple(tags))

    def mark_host_dirty(self, buf: Buffer, tag: Optional[str] = None) -> None:
        """The buffer's HOST value is now authoritative (another shard
        produced it): drop any device-dirty claim and refresh its row at
        the next dispatch. A no-op for buffers this arena never packed
        (their next pack reads the host value anyway). ``tag`` attributes
        the eventual h2d refresh to the stream that forced it (the mesh's
        staged path passes ``"mesh-transfer"``)."""
        with self._lock:
            self._device_dirty.pop(id(buf), None)
            if buf in self.arena:
                self._host_dirty[id(buf)] = buf
                if tag is not None:
                    self._host_dirty_tags[id(buf)] = tag

    # -- d2d row transfer (the mesh ShardLink's halves) --------------------
    def export_row(self, buf: Buffer) -> Optional["ExportedRow"]:
        """A copy of the slab row holding ``buf``'s device-authoritative
        padded value, for a peer shard to import without a host hop, or
        ``None`` when this session holds no such value (host value
        current, row never packed, pending a host refresh, or moved by a
        compaction): the caller then stages through the host. The copy is
        queued on this session's stream, after the epoch that wrote the
        row and before any later one, with an event recorded after it; the
        host does not wait."""
        with self._lock:
            if self._slabs is None or id(buf) not in self._device_dirty:
                return None
            addr = self.arena.addr_of(buf)
            if addr is None:
                return None
            try:
                with self._on_stream():
                    value = self.arena.export_row(
                        self._slabs, buf,
                        expected_generation=self.arena.class_generation(addr[0]))
                    event = None
                    if self.device.type == "cuda":
                        event = torch.cuda.Event()
                        event.record()
            except RuntimeError:
                return None
            self.d2d_row_exports += 1
            return ExportedRow(value, event)

    def import_row(self, buf: Buffer, row: "ExportedRow") -> bool:
        """Write a peer shard's exported row into this session's slab (a
        d2d edge): the row becomes device-authoritative here, the state a
        local dispatch leaves, so every later sync and observer path is
        unchanged. This session's stream waits for the export's event
        first, and the copy is marked as used on it, so the allocator
        does not hand its memory out before the write ends."""
        with self._lock:
            self.arena.add(buf)
            cid, _row = self.arena.addr_of(buf)
            with self._on_stream():
                # A first-touch import needs its row inside the packed
                # watermark (an admission upload, not a counted sync).
                self._slabs = self.arena.pack_incremental(self._slabs, device=self.device)
                stream = (torch.cuda.current_stream(self.device)
                          if self.device.type == "cuda" else None)
                if row.event is not None:
                    stream.wait_event(row.event)
                if stream is not None and row.value.device == self.device:
                    row.value.record_stream(stream)
                self._slabs = self.arena.import_row(
                    self._slabs, buf, row.value,
                    expected_generation=self.arena.class_generation(cid))
                if stream is not None and row.value.device != self.device:
                    # A copy from another card (not run on one card): the
                    # source copy must outlive it, so wait for it here.
                    stream.synchronize()
            self._host_dirty.pop(id(buf), None)
            self._host_dirty_tags.pop(id(buf), None)
            self._device_dirty[id(buf)] = buf
            self.d2d_row_imports += 1
            return True

    def invalidate_row(self, buf: Buffer) -> bool:
        """Drop any authoritative claim this session holds on ``buf``:
        the write-owner invalidation half of the mesh protocol (another
        shard took write ownership, so a later sync here must not clobber
        the fresh value). The slab row keeps its bits; a future read on
        this shard re-stages through the link first."""
        with self._lock:
            had = self._device_dirty.pop(id(buf), None) is not None
            self._host_dirty.pop(id(buf), None)
            self._host_dirty_tags.pop(id(buf), None)
            if had:
                self.row_invalidations += 1
            return had

    # -- row lifecycle -------------------------------------------------------
    def release_buffer(self, buf: Buffer) -> bool:
        """Release a buffer the producer is done with: its arena row joins
        the class free-list and its dirty-tracking entries drop (no value
        is synced back: a released buffer owes none). The caller guarantees
        no pending or future task references it (serving wires this to
        ``BufferPool.free`` through a free hook)."""
        with self._lock:
            self._device_dirty.pop(id(buf), None)
            self._host_dirty.pop(id(buf), None)
            self._host_dirty_tags.pop(id(buf), None)
            return self.arena.free(buf)

    def _maybe_compact(self) -> None:
        """Compact classes whose dead-row waste crossed the threshold
        (between dispatches) and drop exactly the plan-cache entries that
        address a compacted class."""
        cids = self.arena.needs_compaction()
        if not cids:
            return
        self._slabs, moved = self.arena.compact(self._slabs, cids)
        stale = [k for k, entry in self._plan_cache.items()
                 if any(cid in moved for cid, _ in entry[3])]
        for k in stale:
            del self._plan_cache[k]
        self.plan_cache_invalidations += len(stale)

    def _pre_observe_retired(self, task: Task) -> None:
        # An observer attaching after an unwatched epoch retired the task
        # reads host values: sync first.
        self._sync_to_host(list(self._device_dirty.values()), tags=self._tags_of([task]))

    # -- device / host halves ----------------------------------------------
    def _structure_key(self, dev_plan: Sequence[Sequence[Task]]) -> Tuple:
        def opkey(op):
            a = self.arena.address(op)
            return (a.class_id, a.row, a.row_start, a.row_count)

        return tuple(
            tuple((t.signature, tuple(opkey(o) for o in t.inputs),
                   tuple(opkey(o) for o in t.outputs))
                  for t in step)
            for step in dev_plan
        )

    def _cached_plan(self, key: Tuple, build: Callable[[], Tuple]) -> Tuple:
        """The plan cache: a hit (LRU touch) unless the entry is missing or
        a compaction moved its classes since it was built; else ``build()``
        it, evicting the oldest entry past ``plan_cache_limit``."""
        cached = self._plan_cache.get(key)
        if cached is not None and any(self.arena.class_generation(cid) != gen
                                      for cid, gen in cached[3]):
            del self._plan_cache[key]
            self.plan_cache_invalidations += 1
            cached = None
        if cached is not None:
            self._plan_cache[key] = self._plan_cache.pop(key)
            self.plan_cache_hits += 1
            return cached
        cached = self._plan_cache[key] = build()
        self.plan_cache_misses += 1
        if self.plan_cache_limit is not None and len(self._plan_cache) > self.plan_cache_limit:
            self._plan_cache.pop(next(iter(self._plan_cache)))
            self.plan_cache_evictions += 1
        return cached

    def _generations(self, specs: Iterable[_StepSpec]) -> Tuple[Tuple[int, int], ...]:
        cids = sorted({sp.class_id for st in specs for sp in st.inputs + st.outputs})
        return tuple((cid, self.arena.class_generation(cid)) for cid in cids)

    def _program(self, key: Tuple, build: Callable[[], Any]) -> Any:
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = build()
            self.stats.compiles += 1
        return prog

    def _lower_steps(self, dev_plan: List[List[Task]]) -> Tuple:
        """Plan-cache entry for a wave/frontier device segment:
        ``(run(slabs, payload) -> slabs, payload, n_steps, generations,
        executor)``."""
        steps = lower_plan(dev_plan, self.registry, self.arena)
        gens = self._generations(st.spec for st in steps)
        wave = None
        if _kernel_wanted(self.wave_kernel, self.device):
            wave, _ = _wave_kernel_parts(dev_plan, self.registry, self.arena)
        if wave is not None:
            run = lambda slabs, p, w=wave: _run_wave_kernel(slabs, w, p, self._wave_err)  # noqa: E731
            return run, wave.payload(self.device), len(steps), gens, "wave_kernel"
        run_fn, runs = self._program(tuple(st.spec for st in steps),
                                     lambda: _build_program(steps))
        tables = _device_tables(_run_tables(steps, runs), runs, self.device)
        return run_fn, tables, len(steps), gens, "steps"

    def _execute_device(self, dev_plan: List[List[Task]]) -> None:
        self._maybe_compact()
        tasks = [t for step in dev_plan for t in step]
        self.arena.add_tasks(tasks)
        run, payload, _, _, executor = self._cached_plan(
            (self.plan_mode, self._structure_key(dev_plan)),
            lambda: self._lower_steps(dev_plan))
        self._refresh_slabs(tasks)
        if executor == "wave_kernel":
            self.wave_kernel_dispatches += 1
            self._wave_unchecked = self._wave_err is not None
        self._slabs = run(self._slabs, payload)
        self._dispatched(tasks, [len(step) for step in dev_plan])

    def _dispatched(self, tasks: List[Task], widths: List[int]) -> None:
        """Bookkeeping after one device dispatch: counters, the completion
        event, and the outputs' device-dirty marks."""
        if self.device.type == "cuda":
            self._last_event = torch.cuda.Event()
            self._last_event.record()
        self.device_dispatches += 1
        self.stats.dispatches += 1
        self.stats.tasks_run += len(tasks)
        self.stats.wave_widths.extend(widths)
        for t in tasks:
            for op in t.outputs:
                b = operand_base(op)
                self._device_dirty[id(b)] = b
                self._host_dirty.pop(id(b), None)
                self._host_dirty_tags.pop(id(b), None)

    def _refresh_slabs(self, tasks: List[Task]) -> None:
        """Bring the slabs up to date before a dispatch: append rows for
        newly seen buffers (admission upload, not a counted sync) and
        refresh rows whose host values changed since packing (an h2d
        transition, counted)."""
        self._slabs = self.arena.pack_incremental(self._slabs, device=self.device)
        stale = [b for b in self._host_dirty.values() if b in self.arena]
        if stale:
            self._slabs = self.arena.update_rows(self._slabs, stale)
            tags = set(self._tags_of(tasks))
            for b in stale:
                del self._host_dirty[id(b)]
                forced = self._host_dirty_tags.pop(id(b), None)
                if forced is not None:
                    tags.add(forced)
            self._count_sync("h2d", tuple(tags))

    def _execute_host_step(self, tasks: List[Task]) -> None:
        """In-epoch host path (opaque operands): one call per task, reading
        fresh values back from the slabs first when a device step produced
        them. Retirement fires per task, so chained callbacks (serving
        decode harvests) observe each value as under the host sessions."""
        need: Dict[int, Buffer] = {}
        for t in tasks:
            for op in tuple(t.inputs) + tuple(t.outputs):
                base = operand_base(op)
                if id(base) in self._device_dirty:
                    need[id(base)] = base
        if need:
            self._sync_to_host(need.values(), tags=self._tags_of(tasks))
        for task in tasks:
            if self.stream is not None:
                # Values made on another stream (a server's prompt, a fresh
                # cache) are read on this one: the allocator must not hand
                # their memory out before this use ends.
                for op in task.inputs:
                    for t in _tensors(operand_base(op).value):
                        t.record_stream(self.stream)
            self._host_exec.execute_wave([task])
            self.host_task_dispatches += 1
            for op in task.outputs:
                b = operand_base(op)
                self._host_dirty[id(b)] = b
                self._host_dirty_tags.pop(id(b), None)
                self._device_dirty.pop(id(b), None)
            self.waves.append([task.tid])
            self._note_retired(task)

    def _lower_loop(self, tasks: List[Task]) -> Tuple:
        """Plan-cache entry for a loop segment: ``(run(slabs, payload) ->
        slabs, payload, n_specs, generations, executor)``."""
        program = lower_epoch_program(tasks, self.registry, self.arena)
        parts = (_loop_kernel_parts(program, self.registry, self.arena)
                 if _kernel_wanted(self.loop_kernel, self.device) else None)
        gens = self._generations(program.specs)
        key = ("loop", program.specs, program.dep_tbl.shape[1], parts is not None)
        if parts is not None:
            cid, branches = parts

            def kernel(slabs, p):
                return _run_loop_kernel(slabs, cid, branches, p)[0]

            return (self._program(key, lambda: kernel), program.payload(self.device),
                    len(program.specs), gens, "loop_kernel")

        def interpreter(slabs, prog):
            return _run_loop_interpreter(slabs, prog)[0]

        return (self._program(key, lambda: interpreter), program, len(program.specs), gens,
                "interpreter")

    def _execute_device_loop(self, tasks: List[Task]) -> None:
        """Dispatch one program-order run of device-lowerable tasks as a
        single ready-queue program (the device pops tasks as their counters
        hit zero), through the same plan and program caches."""
        self._maybe_compact()
        self.arena.add_tasks(tasks)
        run, payload, _, _, _ = self._cached_plan(
            ("loop", self._structure_key([tasks])), lambda: self._lower_loop(tasks))
        self._refresh_slabs(tasks)
        self._slabs = run(self._slabs, payload)
        self.loop_dispatches += 1
        self._dispatched(tasks, [len(tasks)])

    def _run_epoch_loop(self) -> None:
        """The ``plan_mode="loop"`` epoch: the program-order drain splits
        into maximal contiguous device-lowerable runs, each ONE ready-queue
        dispatch; opaque-operand runs take the host path in between."""
        order = self.window.drain_program_order()
        syncs_before = self.host_syncs
        hits_before = self.plan_cache_hits
        n_device_dispatches = 0
        n_host_tasks = 0
        for lowerable, grp in itertools.groupby(order, key=_device_lowerable):
            run = list(grp)
            if lowerable:
                self._execute_device_loop(run)
                n_device_dispatches += 1
                self._retire_device_segment([run])
            else:
                n_host_tasks += len(run)
                self._execute_host_step(run)
        self._log_epoch(len(order), n_device_dispatches + n_host_tasks,
                        n_device_dispatches, n_host_tasks, hits_before, syncs_before)

    def _log_epoch(self, n_tasks: int, plan_steps: int, n_device: int, n_host: int,
                   hits_before: int, syncs_before: int) -> None:
        self.epochs += 1
        self.epoch_log.append({
            "epoch": self.epochs,
            "tasks": n_tasks,
            "plan_steps": plan_steps,
            "device_dispatches": n_device,
            "host_tasks": n_host,
            "plan_cache_hits": self.plan_cache_hits - hits_before,
            "host_syncs": self.host_syncs - syncs_before,
        })

    # -- the epoch ----------------------------------------------------------
    def _run_any_epoch(self) -> None:
        with self._on_stream():
            if self.plan_mode == "loop":
                self._run_epoch_loop()
            else:
                self._run_epoch()

    def _pump(self) -> bool:
        # Segments a prior launch() left in flight retire first (blocking:
        # _pump must make progress).
        progressed = False
        if self._inflight:
            progressed = self._drain_inflight(block=True) > 0
        if self.window.idle():
            return progressed
        self._run_any_epoch()
        return True

    def launch(self) -> bool:
        """Dispatch everything admitted so far WITHOUT retiring device
        segments: each parks on the in-flight queue with its completion
        event until :meth:`poll_inflight` retires it. Host-path tasks still
        execute and retire inline. Returns True when anything is in flight
        or was dispatched."""
        with self._lock:
            if self.window.idle():
                return bool(self._inflight)
            self._defer_retire = True
            try:
                self._run_any_epoch()
            finally:
                self._defer_retire = False
            return True

    @property
    def inflight_segments(self) -> int:
        with self._lock:
            return len(self._inflight)

    def poll_inflight(self, block: bool = False) -> int:
        """Retire in-flight device segments whose dispatches have landed,
        oldest-first (program-order retirement). Non-blocking by default:
        stops at the first segment whose event has not been reached.
        ``block=True`` waits for the oldest segment first. Returns the
        number of tasks retired."""
        with self._lock:
            return self._drain_inflight(block=block)

    def _drain_inflight(self, block: bool) -> int:
        retired = 0
        while self._inflight:
            dev_plan, event = self._inflight[0]
            if not block and not _event_ready(event):
                break
            if block and event is not None:
                event.synchronize()
            self._inflight.popleft()
            self._retire_device_segment(dev_plan)
            retired += sum(len(step) for step in dev_plan)
            block = False  # only force the oldest; the rest must be ready
        return retired

    def _retire_device_segment(self, dev_plan: List[List[Task]]) -> None:
        """Retire a just-dispatched device segment. A watched segment
        (listeners, callbacks, tickets) syncs the slabs back first (one
        blocking sync: the retire boundary). Under a deferred launch the
        segment parks on the in-flight queue with its event instead."""
        if self._defer_retire:
            self._inflight.append((dev_plan, self._last_event))
            return
        watched = bool(self._listeners) or any(
            t.tid in self._watchers or t.tid in self._tickets
            for step in dev_plan for t in step)
        if watched:
            self._sync_to_host(list(self._device_dirty.values()),
                               tags=self._tags_of(t for step in dev_plan for t in step))
        for step in dev_plan:
            self.waves.append([t.tid for t in step])
            for t in step:
                self._note_retired(t)

    def _run_epoch(self) -> None:
        plan = self._plan_epoch()
        syncs_before = self.host_syncs
        hits_before = self.plan_cache_hits
        n_device_dispatches = 0
        n_host_tasks = 0
        # Walk the plan in order, batching maximal runs of device-lowerable
        # steps into single dispatches; tasks within one plan step are
        # independent, so splitting a step between the device and host
        # halves preserves every cross-step dependency.
        pending: List[List[Task]] = []
        for step in plan:
            dev = [t for t in step if _device_lowerable(t)]
            host = [t for t in step if not _device_lowerable(t)]
            if dev:
                pending.append(dev)
            if host:
                if pending:
                    self._execute_device(pending)
                    n_device_dispatches += 1
                    self._retire_device_segment(pending)
                    pending = []
                n_host_tasks += len(host)
                self._execute_host_step(host)
        if pending:
            self._execute_device(pending)
            n_device_dispatches += 1
            self._retire_device_segment(pending)
        self._log_epoch(sum(len(step) for step in plan), len(plan), n_device_dispatches,
                        n_host_tasks, hits_before, syncs_before)

    # -- lifecycle ----------------------------------------------------------
    def flush(self) -> None:
        """Drain everything submitted so far, then sync device-resident
        values back to host buffers (the observable retire boundary)."""
        super().flush()
        self.sync()

    def session_stats(self) -> Dict[str, Any]:
        """Aggregate session counters (the per-epoch detail is in
        ``epoch_log``)."""
        with self._lock:
            return {
                "plan_mode": self.plan_mode,
                "epochs": self.epochs,
                "device_dispatches": self.device_dispatches,
                "loop_dispatches": self.loop_dispatches,
                "wave_kernel_dispatches": self.wave_kernel_dispatches,
                "host_task_dispatches": self.host_task_dispatches,
                "plan_cache_hits": self.plan_cache_hits,
                "plan_cache_misses": self.plan_cache_misses,
                "plan_cache_entries": len(self._plan_cache),
                "plan_cache_evictions": self.plan_cache_evictions,
                "plan_cache_invalidations": self.plan_cache_invalidations,
                "compiled_programs": len(self._programs),
                "host_syncs": self.host_syncs,
                "host_syncs_d2h": self.host_syncs_d2h,
                "host_syncs_h2d": self.host_syncs_h2d,
                "host_syncs_by_tag": dict(self.host_syncs_by_tag),
                "d2d_row_exports": self.d2d_row_exports,
                "d2d_row_imports": self.d2d_row_imports,
                "row_invalidations": self.row_invalidations,
                "n_classes": self.arena.n_classes(),
                "padding_waste_frac": round(self.arena.total_waste_frac(), 4),
                "slab_bytes": self.arena.slab_bytes(),
                "arena_generation": self.arena.generation,
                "arena_live_rows": self.arena.live_rows(),
                "arena_free_rows": self.arena.free_rows(),
                "arena_recycled_rows": self.arena.recycled_rows,
                "arena_compactions": self.arena.compactions,
                "dep_checks": self.window.stats.dep_checks,
                "scoreboard_probes": self.window.stats.scoreboard_probes,
            }

    def _finalize(self) -> SchedulerReport:
        self._wait()
        self._check_wave_errors()
        wall = time.perf_counter() - self._t0
        self.stats.exec_seconds = wall
        report = SchedulerReport(self.window, self.stats, wall, self.waves)
        report.plan_mode = self.plan_mode  # type: ignore[attr-defined]
        report.session_stats = self.session_stats()  # type: ignore[attr-defined]
        report.arena_stats = {  # type: ignore[attr-defined]
            "n_classes": self.arena.n_classes(),
            "total_waste_frac": round(self.arena.total_waste_frac(), 4),
            "per_class": self.arena.padding_waste(),
            "device_steps": sum(e["plan_steps"] for e in self.epoch_log),
        }
        return report
