"""The ACS scheduling window (paper §III-C/D, Fig 14/15).

Faithful mechanics:

* kernels arrive through an **input FIFO** in program order;
* a fixed-size **window** (default N=32, the paper's chosen size) holds the
  kernels currently being tracked;
* on insertion, the incoming kernel is dependency-checked against the
  residents (RAW/WAR/WAW over read/write segments, Algorithm 1's hazard
  semantics) and the conflicting residents form its **upstream list**;
* a kernel whose upstream list is empty is **READY**; launched kernels are
  EXECUTING; on completion the kernel is retired, removed from every
  upstream list, and vacancies are refilled from the FIFO.

The input side has explicit **open/drain semantics** for live-fed sessions
(§III-D: the FIFO is refilled *while* kernels execute). A window is born
with its input closed (closed-batch compatibility: submit everything, then
drain). ``open_input()`` marks it live: ``drained()`` then reports False
even when the window is momentarily empty — the producer may still submit
— until ``close_input()`` declares the stream complete. ``idle()`` is the
weaker "empty right now" predicate either way.

Note on Algorithm 1 as printed: it tests the incoming kernel's *writes*
against residents' reads+writes (WAR + WAW) only. Correctness also needs
RAW (incoming *reads* vs residents' writes) — §III-C's prose ("overlaps
between read segments and write segments") implies it; we implement the
full RAW/WAR/WAW check.

**Dependency authority** (DESIGN.md §9): the sole source of upstream sets
is the incremental :class:`~.scoreboard.IntervalScoreboard` — per
address-interval writer/reader tid sets in a sorted boundary structure,
probed only at the incoming kernel's own (coalesced) segments. An
insertion costs O(segments x log intervals) instead of the seed's
O(window x segments^2) pairwise scan (``segments.window_upstreams``, now
demoted to the property-test oracle), which is what makes windows of
128-512 affordable. ``WindowStats`` counts both the scoreboard cells
actually probed and the pairwise-equivalent check count the seed path
would have performed, so Table II comparisons stay honest.

Because insertion order == program order, dependencies only ever point
from newer to older kernels; the window can never deadlock, and a window
of size 1 degenerates to the serial baseline (tested property).

Ready-set maintenance is **incremental** (DESIGN.md §9): each slot keeps
its upstream tid set AND the window keeps the reverse adjacency
(tid -> dependent tids), so a retire touches only the retiree's true
downstreams — O(out-degree) — instead of rescanning every resident slot.
The READY index is a sorted list of (priority bucket, insertion seq,
tid) — DESIGN §13. Within a bucket the ordering is exactly the old
(seq, tid) program order, so schedulers that consume ``ready_tasks()``
in order launch urgent work first WITHOUT perturbing relative order
inside a class: with a single priority class (the default) the index is
bit-identical to the pre-QoS one. Fresh inserts bisect in (a
high-priority insert may jump ahead of lower buckets; within its own
bucket its seq is the global max so it lands last), and a woken
dependent — whose seq may be older than a task inserted READY after it
— bisects into its bucket. ``ready_tasks()`` stays a plain O(R) read
with no per-poll sort. Priority only reorders *provably independent*
kernels (everything in READY is dependency-free by construction), so it
can never violate a hazard; consumers that need strict program order
(the §2-A3 loop lowering, mesh placement) use ``drain_program_order()``
which re-sorts by seq and is priority-oblivious.
"""

from __future__ import annotations

import bisect
import collections
import enum
from typing import Deque, Dict, Iterable, List, Sequence, Set, Tuple

from .scoreboard import IntervalScoreboard
from .task import Task

__all__ = ["TaskState", "SchedulingWindow", "WindowStats"]


class TaskState(enum.Enum):
    PENDING = "pending"
    READY = "ready"
    EXECUTING = "executing"


class _Slot:
    __slots__ = ("task", "upstream", "state", "seq", "priority")

    def __init__(self, task: Task, upstream: set, state: TaskState, seq: int):
        self.task = task
        self.upstream = upstream  # set of tids this task waits on
        self.state = state
        self.seq = seq  # monotone insertion index (== program order)
        # READY-index bucket, captured at insertion so the key used to
        # bisect into _ready is identical to the one used to delete from
        # it even if task.priority is mutated while resident.
        self.priority = task.priority


class WindowStats:
    """Counters for the benchmarks (dep checks mirror Table II).

    ``dep_checks`` is the *pairwise-equivalent* count: how many
    incoming-vs-resident checks Algorithm 1's scan would have performed
    (residents at each insertion) — kept so Table II comparisons against
    the paper stay honest. ``scoreboard_probes`` is what the incremental
    path actually did: interval cells inspected across all insertions.
    The ratio probes/checks is the concurrency-discovery saving."""

    def __init__(self) -> None:
        self.dep_checks = 0
        self.scoreboard_probes = 0
        self.inserted = 0
        self.retired = 0
        self.max_resident = 0

    def as_dict(self) -> Dict[str, int]:
        return {
            "dep_checks": self.dep_checks,
            "scoreboard_probes": self.scoreboard_probes,
            "inserted": self.inserted,
            "retired": self.retired,
            "max_resident": self.max_resident,
        }


class SchedulingWindow:
    def __init__(self, size: int = 32):
        if size < 1:
            raise ValueError("window size must be >= 1")
        self.size = size
        self.fifo: Deque[Task] = collections.deque()
        self.slots: "collections.OrderedDict[int, _Slot]" = collections.OrderedDict()
        self.stats = WindowStats()
        # The dependency authority: interval claims of every resident.
        # Residency here and on the scoreboard are updated in lockstep
        # (insert at _fill, remove at retire).
        self.scoreboard = IntervalScoreboard()
        self._seq = 0
        # Live-session input state: False = closed batch (default; the
        # producer has submitted everything it ever will), True = a
        # session may still submit, so an empty window is idle, not done.
        self._input_open = False
        # Reverse dependency edges: producer tid -> tids of resident
        # dependents. Maintained at insertion; consumed at retire so the
        # upstream update is O(out-degree), not O(window).
        self._downstream: Dict[int, Set[int]] = {}
        # READY slots as a sorted list of (priority, seq, tid): kept
        # ordered incrementally (inserts and wakes bisect into place), so
        # ready_tasks() is a plain O(R) read — urgent buckets first,
        # program order within a bucket — with no per-poll sort.
        self._ready: List[Tuple[int, int, int]] = []

    # -- producer side ----------------------------------------------------
    def submit(self, task: Task) -> None:
        self.fifo.append(task)
        self._fill()

    def submit_all(self, tasks: Iterable[Task]) -> None:
        self.fifo.extend(tasks)
        self._fill()

    def open_input(self) -> None:
        """Mark the input FIFO live: more submissions may arrive, so an
        empty window is ``idle()`` but not ``drained()``."""
        self._input_open = True

    def close_input(self) -> None:
        """Declare the input stream complete: once the window empties it is
        ``drained()`` for good. Idempotent."""
        self._input_open = False

    @property
    def input_open(self) -> bool:
        return self._input_open

    def fifo_depth(self) -> int:
        """Kernels waiting in the input FIFO (not yet window-resident) —
        the session backpressure signal."""
        return len(self.fifo)

    def backlog(self) -> int:
        """Kernels submitted but not yet retired (FIFO + resident): the
        depth a session reports to producers as its backpressure signal."""
        return len(self.fifo) + len(self.slots)

    # -- scheduler side ---------------------------------------------------
    def ready_tasks(self) -> List[Task]:
        """All READY kernels (they may launch concurrently): most urgent
        priority bucket first, oldest-first within a bucket."""
        return [self.slots[tid].task for _, _, tid in self._ready]

    def mark_executing(self, task: Task) -> None:
        slot = self.slots[task.tid]
        if slot.state is not TaskState.READY:
            raise RuntimeError(f"task {task.tid} launched while {slot.state}")
        slot.state = TaskState.EXECUTING
        idx = bisect.bisect_left(self._ready, (slot.priority, slot.seq, task.tid))
        del self._ready[idx]

    def retire(self, task: Task) -> None:
        """Kernel completed: drop it, update upstream lists, refill window."""
        self._retire_no_fill(task)
        self._fill()

    def retire_many(self, tasks: Sequence[Task]) -> None:
        """Batch retire (one refill pass): the frontier scheduler retires a
        whole homogeneous group at once when its results land."""
        for task in tasks:
            self._retire_no_fill(task)
        self._fill()

    def drained(self) -> bool:
        """Closed AND complete: input stream ended and nothing is resident.
        A live (``input_open``) window is never drained — see ``idle()``."""
        return not self._input_open and not self.fifo and not self.slots

    def idle(self) -> bool:
        """Empty *right now* — but if the input is open, more may arrive."""
        return not self.fifo and not self.slots

    def resident(self) -> int:
        return len(self.slots)

    def seq_of(self, tid: int) -> int:
        """Insertion sequence number (== program order) of a resident task.
        Consumers that retire-and-refill in waves but must reconstruct
        program order afterwards (the device ready-queue lowering) capture
        this BEFORE retiring — the slot is destroyed at retire."""
        return self.slots[tid].seq

    def drain_program_order(self) -> List[Task]:
        """Drain everything admitted so far (retire-and-refill waves) and
        return the tasks in PROGRAM order. The ready-queue epoch lowering
        and the mesh placement plane both need a topological order, and
        program order guarantees every dependency edge points forward;
        each task's insertion seq is captured before its slot is destroyed
        at retire. Raises on a stalled window (READY empty but residents
        remain) — impossible under program-order admission."""
        drained: List[Tuple[int, Task]] = []
        while not self.idle():
            ready = self.ready_tasks()
            if not ready:
                raise RuntimeError(
                    "window stall: no READY kernels but window non-empty")
            for t in ready:
                self.mark_executing(t)
                drained.append((self.seq_of(t.tid), t))
            self.retire_many(ready)
        drained.sort(key=lambda p: p[0])
        return [t for _, t in drained]

    # -- internals ----------------------------------------------------------
    def _retire_no_fill(self, task: Task) -> None:
        slot = self.slots.get(task.tid)
        if slot is None:
            raise RuntimeError(f"task {task.tid} retired but not resident")
        if slot.state is not TaskState.EXECUTING:
            raise RuntimeError(f"task {task.tid} retired while {slot.state}")
        del self.slots[task.tid]
        self.scoreboard.retire(task.tid)
        for dep_tid in self._downstream.pop(task.tid, ()):
            dep = self.slots[dep_tid]
            dep.upstream.discard(task.tid)
            if not dep.upstream and dep.state is TaskState.PENDING:
                dep.state = TaskState.READY
                bisect.insort(self._ready, (dep.priority, dep.seq, dep_tid))
        self.stats.retired += 1

    def _fill(self) -> None:
        while self.fifo and len(self.slots) < self.size:
            task = self.fifo.popleft()
            # Pairwise-equivalent accounting: Algorithm 1 would have
            # checked the incoming kernel against every resident.
            self.stats.dep_checks += len(self.slots)
            # The actual check: probe only the intervals this kernel's
            # own segments touch (exact RAW/WAR/WAW upstream set).
            upstream = self.scoreboard.insert(
                task.tid, task.read_segments, task.write_segments
            )
            self.stats.scoreboard_probes = self.scoreboard.probe_cells
            for up_tid in upstream:
                self._downstream.setdefault(up_tid, set()).add(task.tid)
            state = TaskState.PENDING if upstream else TaskState.READY
            slot = _Slot(task, upstream, state, self._seq)
            self._seq += 1
            self.slots[task.tid] = slot
            if state is TaskState.READY:
                # Fresh insert: within its own bucket seq is the global
                # max, but a more-urgent bucket must jump ahead of every
                # lower one — append when it sorts last (the common
                # single-class case), bisect otherwise.
                entry = (slot.priority, slot.seq, task.tid)
                if not self._ready or entry > self._ready[-1]:
                    self._ready.append(entry)
                else:
                    bisect.insort(self._ready, entry)
            self.stats.inserted += 1
            self.stats.max_resident = max(self.stats.max_resident, len(self.slots))
