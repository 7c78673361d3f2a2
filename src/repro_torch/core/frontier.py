"""Async frontier scheduling — retiring dependencies, not waves (PyTorch
port of ``repro/core/frontier.py``).

:class:`~.scheduler.WaveScheduler` retires an entire wave before refilling
the window, so the slowest kernel in a wave gates every successor.
:class:`~.scheduler.ThreadedStreamScheduler` retires at kernel granularity
but pays a lock and a stream sync per kernel, the per-kernel sync overhead
§II-D budgets against. :class:`AsyncFrontierScheduler` sits between them:

* the READY set is partitioned into homogeneous groups (equal
  ``Task.signature``) and each *group* is launched asynchronously by
  :class:`~.executors.GroupExecutor` on the current CUDA stream: the
  results are written straight into the output buffers, downstream groups
  read them in stream order, and the host never blocks per kernel;
* groups retire individually as their recorded events complete
  (non-blocking ``poll``), waking only their true downstreams — no wave
  barrier;
* dependency checking and route classification (``GroupExecutor.warm``)
  are overlapped with in-flight device work by a double-buffered dispatch
  queue: while launched groups execute, the next groups are staged; the
  buffers flip and the staged groups launch while their successors stage.

A blocking sync happens only when the pipeline truly stalls (window full
of in-flight work and nothing polls complete); ``ExecStats.blocking_syncs``
counts these.

The frontier is a live :class:`FrontierSession`: producers ``submit()``
while groups are in flight — the executor's in-flight ledger survives
across submissions. :class:`AsyncFrontierScheduler.run` is the
closed-batch wrapper (open, submit everything, close).
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Iterable, List, Optional, Sequence, Set

from .buffers import DeviceLike
from .executors import GroupExecutor, GroupHandle
from .scheduler import GroupTrace, SchedulerReport
from .session import SchedulerSession
from .task import Task

__all__ = ["AsyncFrontierScheduler", "DispatchQueue", "FrontierSession"]


class DispatchQueue:
    """Double-buffered, coalescing group staging.

    ``stage()`` sorts freshly-READY kernels into per-signature buckets in
    the *back* buffer while previously-launched groups are still executing.
    Buckets coalesce: a kernel that wakes two retires after its batchable
    sibling still joins the same bucket, so group width recovers even
    though the frontier never waits for a full wave (the pipeline delay
    before the next ``flip`` IS the batching window). ``flip()`` promotes
    the back buffer to launchable — classifying each group's route on the
    way (``GroupExecutor.warm``), one iteration ahead of launch — once the
    front has drained. The point is pipelining: dependency analysis and
    batching happen behind device time, and the launch loop only ever
    touches ready-made groups.
    """

    def __init__(self, max_group: Optional[int] = None):
        self.max_group = max_group
        # back buffer: signature -> coalescing bucket (insertion-ordered)
        self._staged: "collections.OrderedDict[tuple, List[Task]]" = (
            collections.OrderedDict()
        )
        self._launchable: Deque[List[Task]] = collections.deque()  # front
        self._queued_tids: Set[int] = set()

    def stage(self, ready: Sequence[Task]) -> int:
        """Bucket not-yet-queued READY tasks by signature; returns the
        number of new buckets opened."""
        opened = 0
        for t in ready:
            if t.tid in self._queued_tids:
                continue
            bucket = self._staged.get(t.signature)
            if bucket is None:
                bucket = self._staged[t.signature] = []
                opened += 1
            bucket.append(t)
            self._queued_tids.add(t.tid)
        return opened

    def flip(self, executor: GroupExecutor) -> bool:
        """Promote the back buffer once the front is drained; warm every
        promoted group (ahead of its launch next iteration)."""
        if self._launchable or not self._staged:
            return False
        for bucket in self._staged.values():
            while bucket:
                cut = bucket[: self.max_group] if self.max_group else bucket
                bucket = bucket[len(cut):]
                executor.warm(cut)
                self._launchable.append(cut)
        self._staged = collections.OrderedDict()
        return True

    def pop(self) -> Optional[List[Task]]:
        if not self._launchable:
            return None
        group = self._launchable.popleft()
        for t in group:
            self._queued_tids.discard(t.tid)
        return group

    @property
    def has_launchable(self) -> bool:
        return bool(self._launchable)

    def empty(self) -> bool:
        return not self._staged and not self._launchable


class FrontierSession(SchedulerSession):
    """Live-fed rolling frontier: the session form of the async frontier.

    Every ``poll`` runs one scheduling step — retire groups whose results
    landed (waking only true downstreams), launch staged groups up to the
    in-flight cap, stage the fresh READY set, flip the double buffer.
    In-flight groups live on the *executor's* ledger, so they survive
    across ``submit`` calls: the producer can keep feeding the FIFO while
    earlier groups execute, which is the paper's §III-D picture. ``drive``
    adds the blocking fallback (sync the oldest in-flight group) used when
    the pipeline genuinely stalls.
    """

    def __init__(
        self,
        window_size: int = 32,
        executor: Optional[GroupExecutor] = None,
        max_inflight: int = 8,
        max_group: Optional[int] = None,
        history_limit: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        ex = executor if executor is not None else GroupExecutor(device)
        super().__init__(window_size, history_limit=history_limit)
        if ex.inflight:
            # One live session per executor: poll_landed would hand this
            # session groups whose tasks live in ANOTHER session's window
            # (retire-not-resident corruption). Fail loudly at open instead.
            raise RuntimeError(
                f"executor has {len(ex.inflight)} in-flight group(s) from "
                "another session; close it before opening a new one"
            )
        self.executor = ex
        self.queue = DispatchQueue(max_group)
        self.max_inflight = max_inflight

    def _retire_group(self, handle: GroupHandle, blocking: bool) -> None:
        self.window.retire_many(handle.tasks)
        self.groups.append(
            GroupTrace(
                [t.tid for t in handle.tasks],
                handle.t_launch - self._t0,
                time.perf_counter() - self._t0,
                blocking=blocking,
            )
        )
        for t in handle.tasks:
            self._note_retired(t)

    def _pump(self) -> bool:
        # Per-pump window costs are all incremental: retire_many updates
        # scoreboard claims + downstream sets in O(own segments +
        # out-degree), refill dep-checks via scoreboard probes, and
        # ready_tasks() is a plain ordered read — no per-poll sort, no
        # pairwise rescan — so polling stays cheap at window 256+.
        ex = self.executor
        progressed = False

        # 1. Retire every group whose results have landed (non-blocking).
        for handle in ex.poll_landed():
            self._retire_group(handle, blocking=False)
            progressed = True

        # 2. Launch previously staged groups up to the in-flight cap.
        while len(ex.inflight) < self.max_inflight and self.queue.has_launchable:
            group = self.queue.pop()
            assert group is not None
            for t in group:
                self.window.mark_executing(t)
            ex.launch(group)
            self.waves.append([t.tid for t in group])
            progressed = True

        # 3. Stage the next groups from the current READY set (coalescing
        #    batchable siblings), 4. flip the double buffer when drained.
        #    ready_tasks() yields urgent priority buckets first, so staging order — hence group open order and launch
        #    order — serves high-priority kernels ahead of independent
        #    lower-priority peers with no frontier-side logic.
        self.queue.stage(self.window.ready_tasks())
        if self.queue.flip(ex):
            progressed = True
        return progressed

    def poll(self) -> List[Task]:
        # Pump to quiescence, not one step: a retire that wakes a staged
        # downstream should launch it within the same poll — otherwise
        # every dependency edge costs an extra host round-trip.
        with self._lock:
            while self._pump():
                pass
        return self._drain_fresh()

    def drive(self) -> List[Task]:
        with self._lock:
            progressed = False
            while self._pump():
                progressed = True
            if not progressed:
                self._sync_one()
        return self._drain_fresh()

    def _on_stall(self) -> None:
        with self._lock:
            self._sync_one()

    def _sync_one(self) -> None:
        """Blocking fallback (lock held): sync the oldest in-flight group —
        the one whose downstreams have waited longest."""
        handle = self.executor.sync_oldest()
        if handle is not None:
            self._retire_group(handle, blocking=True)
        elif not self.window.idle():
            # No in-flight work, no READY kernels, window non-empty:
            # impossible by the window's no-deadlock invariant.
            raise RuntimeError("frontier stall: no READY kernels but window non-empty")

    def _finalize(self) -> SchedulerReport:
        ex = self.executor
        ex.finalize()
        wall = time.perf_counter() - self._t0
        # Accumulate like every other executor: the executor (and its
        # ExecStats) persists across sessions, so overwriting would pair
        # last-run seconds with all-runs dispatch counters in deltas.
        ex.stats.exec_seconds += wall
        return SchedulerReport(self.window, ex.stats, wall, self.waves,
                               groups=self.groups)


class AsyncFrontierScheduler:
    """Windowed out-of-order scheduler with rolling, barrier-free retire.

    Parameters
    ----------
    window_size:
        ACS scheduling window size (paper default 32).
    max_inflight:
        Cap on simultaneously in-flight groups — the analogue of the
        paper's stream count. More in-flight groups = more overlap, but
        retire latency for any one group grows.
    max_group:
        Cap on tasks fused per group launch (None = unbounded), mirroring
        ``WaveScheduler.max_wave``.
    """

    def __init__(
        self,
        window_size: int = 32,
        executor: Optional[GroupExecutor] = None,
        max_inflight: int = 8,
        max_group: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.window_size = window_size
        self.executor = executor if executor is not None else GroupExecutor(device)
        self.max_inflight = max_inflight
        self.max_group = max_group

    def session(self) -> FrontierSession:
        """Open a live session sharing this scheduler's executor (route
        cache and stats persist, as a long-running runtime's would)."""
        return FrontierSession(
            window_size=self.window_size,
            executor=self.executor,
            max_inflight=self.max_inflight,
            max_group=self.max_group,
        )

    def run(self, stream: Iterable[Task]) -> SchedulerReport:
        """Closed-batch wrapper: open a session, submit everything, close."""
        session = self.session()
        session.submit(list(stream))
        return session.close()
