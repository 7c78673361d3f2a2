"""Full-DAG baseline — the CUDA Graph / ATMI comparison point (§II-D, Fig 9);
PyTorch port of ``repro/core/dag_baseline.py``.

CUDA Graph requires the *entire* dependency DAG to be constructed before
execution, for every input. That is an all-pairs dependency check over the
whole stream (O(n^2) in stream length against ACS's O(n·W) windowed
checks), plus a whole-graph schedule: :func:`build_full_dag` and
:func:`level_schedule`. :class:`DagRunner` runs the level schedule through
:class:`~.executors.FusedWaveExecutor`, one level a wave, as the reference
does (it captures no ``torch.cuda.CUDAGraph``).

For *static* graphs the constructed schedule can be cached and replayed
(``DagRunner.execute(..., construct=False)``), the paper's Fig 27
observation that CUDA Graph matches ACS-HW when the graph never changes.
The cache holds each level as stream positions, so a replay runs the
tasks it is given (a new input's, for a static graph) in the cached
levels; the reference's replays the cached tasks themselves.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

from .buffers import DeviceLike, resolve_device
from .executors import FusedWaveExecutor
from .scheduler import SchedulerReport
from .segments import depends_on
from .task import Task
from .window import SchedulingWindow

__all__ = ["build_full_dag", "level_schedule", "DagRunner"]


def build_full_dag(tasks: Sequence[Task]) -> Tuple[Dict[int, List[int]], int]:
    """All-pairs dependency construction. Returns (edges: tid -> upstream
    tids, number of dependency checks performed)."""
    edges: Dict[int, List[int]] = {t.tid: [] for t in tasks}
    checks = 0
    for j, newer in enumerate(tasks):
        for older in tasks[:j]:
            checks += 1
            if depends_on(
                newer.read_segments,
                newer.write_segments,
                older.read_segments,
                older.write_segments,
            ):
                edges[newer.tid].append(older.tid)
    return edges, checks


def level_schedule(tasks: Sequence[Task], edges: Dict[int, List[int]]) -> List[List[Task]]:
    """Topological level order: level(t) = 1 + max(level(upstream))."""
    by_tid = {t.tid: t for t in tasks}
    level: Dict[int, int] = {}
    for t in tasks:  # program order is a valid topological order
        ups = edges[t.tid]
        level[t.tid] = 1 + max((level[u] for u in ups), default=-1)
    n_levels = 1 + max(level.values(), default=0)
    out: List[List[Task]] = [[] for _ in range(n_levels)]
    for tid, lv in level.items():
        out[lv].append(by_tid[tid])
    return out


class DagRunner:
    """Construct-then-execute runner with optional schedule caching."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self._cached: Optional[List[List[int]]] = None  # levels of stream positions
        self.construct_seconds = 0.0
        self.dep_checks = 0

    def construct(self, tasks: Sequence[Task]) -> None:
        t0 = time.perf_counter()
        edges, checks = build_full_dag(tasks)
        pos = {t.tid: i for i, t in enumerate(tasks)}
        self._cached = [[pos[t.tid] for t in level] for level in level_schedule(tasks, edges)]
        self.construct_seconds += time.perf_counter() - t0
        self.dep_checks += checks

    def execute(self, tasks: Sequence[Task], construct: bool = True) -> SchedulerReport:
        """If ``construct`` (the dynamic-graph case), the DAG is rebuilt for
        this input; otherwise the cached schedule is replayed (static case)
        over ``tasks``, which must be as many as it was built from.
        """
        tasks = list(tasks)
        if construct or self._cached is None:
            self.construct(tasks)
        n_cached = sum(len(level) for level in self._cached)
        if len(tasks) != n_cached:
            raise ValueError(f"cannot replay a schedule of {n_cached} tasks over {len(tasks)}")
        schedule = [[tasks[i] for i in level] for level in self._cached]
        executor = FusedWaveExecutor(self.device)
        window = SchedulingWindow(size=max(1, len(tasks)))  # for stats shape only
        t0 = time.perf_counter()
        waves: List[List[int]] = []
        for wave in schedule:
            executor.execute_wave(wave)
            waves.append([t.tid for t in wave])
        executor.finalize()
        wall = time.perf_counter() - t0
        report = SchedulerReport(window, executor.stats, wall, waves)
        report.construct_seconds = self.construct_seconds  # type: ignore[attr-defined]
        report.dep_checks = self.dep_checks  # type: ignore[attr-defined]
        return report
