"""ACS-HW: the scheduling window's ready queue on the device (PyTorch port
of the ``plan_mode="loop"`` half of ``repro/core/device_dispatch.py``).

The paper's ACS-HW moves the window into GPU hardware so that kernel
completion -> upstream update -> ready dispatch never round-trips to the
CPU. Here an epoch (a stream of tasks in program order) is lowered over a
shape-class slab arena (`core/arena.py`) into integer tables — per-task
operand rows, in-degrees, forward edges from
:func:`~.scoreboard.dependency_arrays`, and an initial ready ring — and
executed by one of two executors:

* the **ready-queue kernel** (``kernels/ready_queue.py``, CUDA): one launch
  for the whole epoch, taken when the epoch is eligible (one shape class
  of padding-free 1-D rows, arity <= 3, one output, every fn a registered
  switch branch);
* the **interpreter**: a plain host loop over the same ring that calls
  each task's own fn on slab slices. It is the general executor for
  streams the kernel does not take, such as the physics stream
  (``sim/engine.py`` explains why none of its kernels qualifies).

Both advance the ring in the same order and leave the same slab; the
runner syncs with the host once, after the epoch, to check every
completion flag.

Still to port (ROADMAP): the wave/frontier lowering (``lower_plan``,
``_build_program``), ``DeviceSession`` and ``execute_uniform``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .arena import SlabArena, pad_to
from .buffers import DeviceLike, resolve_device
from .executors import ExecStats, synchronize
from .scheduler import PLAN_MODES, SchedulerReport
from .scoreboard import dependency_arrays
from .task import Task, operand_base, operand_shape
from .window import SchedulingWindow

__all__ = [
    "DeviceOpRegistry",
    "plan_waves",
    "lower_epoch_program",
    "EpochProgram",
    "DeviceWindowRunner",
]


class DeviceOpRegistry:
    """The device executor's fixed opcode table (the paper's HW window
    supports a finite kernel set burned in next to the command processor).

    ``register`` assigns each kernel name a stable opcode. ``strict``
    registries refuse to lower tasks whose opcode was never registered;
    non-strict registries auto-register on first sight.
    """

    def __init__(self, strict: bool = True) -> None:
        self._ops: List[Tuple[str, Optional[Callable]]] = []
        self._index: Dict[str, int] = {}
        self.strict = strict
        # The ready-queue kernel's fixed branch table: opcode name ->
        # elementwise shape-preserving fn. Eligibility requires a task's fn
        # to BE the registered branch (object identity), so the kernel can
        # never silently diverge from what the host path would execute.
        self._branch_fns: Dict[str, Callable] = {}

    def register(self, name: str, fn: Optional[Callable] = None) -> int:
        """Register ``name`` (idempotent). Re-registering a known name
        upgrades an fn-less entry; a *different* fn for a name that already
        has one is a conflict and raises."""
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

    def register_switch_branch(self, name: str, fn: Callable) -> int:
        """Admit ``fn`` to the ready-queue kernel's branch table (and
        register the opcode name). Re-registering the same fn is
        idempotent; a different fn for a known name is a conflict."""
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


# ---------------------------------------------------------------------------
# Arena lowering: static operand specs + dense address tables
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
    """Static half of one group of structurally identical tasks."""

    opcode: int
    width: int
    inputs: Tuple[_OperandSpec, ...]
    outputs: Tuple[_OperandSpec, ...]
    signature: Tuple  # group Task.signature


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


def _gather_operand(slabs: Sequence[torch.Tensor], spec: _OperandSpec,
                    row: int, start: int) -> torch.Tensor:
    """One task's operand value, sliced out of its class slab (padding
    trimmed; contiguous, like every value a serial run passes)."""
    val = slabs[spec.class_id][row]
    if spec.is_view:
        val = val[start:start + spec.view_rows]
    val = val[tuple(slice(0, s) for s in spec.true_shape)]
    return val.contiguous()


def _scatter_operand(slabs: Sequence[torch.Tensor], spec: _OperandSpec,
                     row: int, start: int, val: torch.Tensor) -> None:
    """Write one task's output into its class slab (in place: the slabs
    are the runner's own working copies), zero-filling the padding."""
    slab = slabs[spec.class_id]
    if spec.is_view:
        target = (spec.view_rows,) + tuple(slab.shape[2:])
        slab[row, start:start + spec.view_rows] = pad_to(val, target).to(slab.dtype)
    else:
        slab[row] = pad_to(val, tuple(slab.shape[1:])).to(slab.dtype)


def _apply_step(slabs: Sequence[torch.Tensor], spec: _StepSpec, fn: Callable,
                tables: Dict[str, np.ndarray], col: int) -> None:
    """Run the task in column ``col`` of its spec's tables over the slabs."""
    ins = [
        _gather_operand(slabs, s, int(tables["in_rows"][i, col]),
                        int(tables["in_starts"][i, col]))
        for i, s in enumerate(spec.inputs)
    ]
    out = fn(*ins)
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if len(outs) != len(spec.outputs):
        raise ValueError(
            f"device step opcode {spec.opcode}: kernel returned {len(outs)} "
            f"values for {len(spec.outputs)} outputs"
        )
    for o, s in enumerate(spec.outputs):
        _scatter_operand(slabs, s, int(tables["out_rows"][o, col]),
                         int(tables["out_starts"][o, col]), outs[o])


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
        n_in, n_out = len(head.inputs), len(head.outputs)
        count = len(group)
        in_specs: List[_OperandSpec] = []
        out_specs: List[_OperandSpec] = []
        tbl = {
            "in_rows": np.zeros((n_in, count), np.int32),
            "in_starts": np.zeros((n_in, count), np.int32),
            "out_rows": np.zeros((n_out, count), np.int32),
            "out_starts": np.zeros((n_out, count), np.int32),
        }
        for gi, task in enumerate(group):
            spec_id[pos[task.tid]] = s
            spec_pos[pos[task.tid]] = gi
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
    on slab slices. Updates ``slabs`` in place; returns them with the
    ``[n] int32`` completion flags."""
    n = program.n_tasks
    dep_tbl = program.dep_tbl.tolist()
    remaining = program.indeg.tolist() + [0]  # + trash slot
    ring = program.ring0.tolist()
    done = [0] * n
    head, tail = 0, program.tail0
    while head < tail:
        t = ring[head]
        s = int(program.spec_id[t])
        _apply_step(slabs, program.specs[s], program.fns[s],
                    program.spec_tables[s], int(program.spec_pos[t]))
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


class DeviceWindowRunner:
    """Execute a whole task stream as ONE device epoch (``plan_mode="loop"``).

    ``run`` takes a task iterable and returns a :class:`SchedulerReport`
    (the ``make_scheduler`` contract) whose window stats come from the
    planning pass, with ``exec_stats.dispatches == 1`` per stream,
    ``report.loop_executor`` naming the executor that ran, and arena
    occupancy in ``report.arena_stats``.

    Host-clock spans of one run, in order: ``report.plan_seconds`` (window,
    arena rows, lowering, eligibility), ``report.payload_seconds`` (the
    kernel's task table and the upload of its int32 tables; 0 for the
    interpreter), ``report.pack_seconds`` (``arena.pack``),
    ``exec_stats["exec_seconds"]`` (the kernel or the interpreter and the
    epoch's one host sync) and ``report.unpack_seconds`` (write-back);
    ``wall_seconds`` is their sum. Device work queued by the pack finishes
    inside the exec span.

    ``loop_kernel`` selects the executor (the reference calls it
    ``loop_pallas``): None = the CUDA kernel when the device is a GPU and
    the stream is eligible, else the interpreter; True = the kernel path
    whenever eligible (on the CPU its wrapper runs the plain version);
    False = the interpreter always. ``report.loop_executor`` is ``"cuda"``
    for the kernel (the reference's ``"pallas"``), ``"ref"`` for the kernel
    path on the CPU, and ``"interpreter"``.
    """

    def __init__(
        self,
        registry: Optional[DeviceOpRegistry] = None,
        window_size: int = 32,
        plan_mode: str = "loop",
        pad_multiple: int = 8,
        loop_kernel: Optional[bool] = None,
        device: DeviceLike = "cuda",
    ):
        if plan_mode not in PLAN_MODES:
            raise ValueError(f"plan_mode must be one of {PLAN_MODES}, got {plan_mode!r}")
        if plan_mode != "loop":
            raise NotImplementedError(
                f"plan_mode={plan_mode!r} (the wave/frontier step-table lowering) "
                "is not ported yet; see ROADMAP.md queue 1, item 6b. Use 'loop'.")
        self.device = resolve_device(device)
        self.registry = registry if registry is not None else DeviceOpRegistry(strict=False)
        self.window_size = window_size
        self.plan_mode = plan_mode
        self.pad_multiple = pad_multiple
        self.loop_kernel = loop_kernel

    def run(self, stream: Iterable[Task]) -> SchedulerReport:
        """`make_scheduler` contract: task iterable in, report out."""
        return self.execute(list(stream))

    def execute(self, tasks: Sequence[Task],
                buffers: Optional[Sequence] = None) -> SchedulerReport:
        """Lower the whole stream as ONE ready-queue program — no host-side
        schedule at all; the queue discovers execution order from the
        dependency arrays. The planning window still runs symbolically for
        its stats, and the one host sync at the end asserts every
        completion flag."""
        tasks = list(tasks)
        t0 = time.perf_counter()
        _, window = plan_waves(tasks, self.window_size, return_window=True)

        arena = SlabArena(pad_multiple=self.pad_multiple)
        if buffers is not None:
            for b in buffers:
                arena.add(b)
        arena.add_tasks(tasks)
        program = lower_epoch_program(tasks, self.registry, arena)
        use_kernel = (self.device.type == "cuda" if self.loop_kernel is None
                      else self.loop_kernel)
        parts = _loop_kernel_parts(program, self.registry, arena) if use_kernel else None
        t1 = time.perf_counter()
        plan_time = t1 - t0

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
        report = SchedulerReport(window, stats, t5 - t0, [[t.tid for t in tasks]])
        report.plan_seconds = plan_time  # type: ignore[attr-defined]
        report.payload_seconds = t2 - t1  # type: ignore[attr-defined]
        report.pack_seconds = t3 - t2  # type: ignore[attr-defined]
        report.unpack_seconds = t5 - t4  # type: ignore[attr-defined]
        report.plan_mode = self.plan_mode  # type: ignore[attr-defined]
        report.plan_active_fraction = 1.0  # type: ignore[attr-defined]
        if parts is None:
            executor = "interpreter"
        else:
            executor = "cuda" if self.device.type == "cuda" else "ref"
        report.loop_executor = executor  # type: ignore[attr-defined]
        report.arena_stats = {  # type: ignore[attr-defined]
            "n_classes": arena.n_classes(),
            "total_waste_frac": round(arena.total_waste_frac(), 4),
            "per_class": arena.padding_waste(),
            "device_steps": len(program.specs),
        }
        return report
