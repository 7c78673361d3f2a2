"""Persistent scheduler sessions — the live-fed ACS window (PyTorch port
of ``repro/core/session.py``).

The paper's runtime is *open-loop*: applications launch kernels into the
input FIFO **while** the window dependency-checks, dispatches, and retires
concurrently (§III-C/D). :class:`SchedulerSession` is that runtime:

* ``submit(tasks)`` — producers push tasks at any time; returns the backlog
  depth (FIFO + resident), the backpressure signal. A ``TaskStream``
  constructed with ``sink=session`` feeds every ``AcsKernel.launch``
  straight into the window.
* ``poll()`` — non-blocking progress; returns tasks retired since the last
  drain.
* ``drive()`` — like ``poll`` but may block for one retirement.
* ``flush()`` — block until everything submitted so far has retired.
* ``close()`` — end the input stream, flush, finalize, and return the
  :class:`~.scheduler.SchedulerReport`.

Retirement is observable per task (``submit(..., on_retire=...)``,
``on_task_retired``, ``ticket()``). ``history_limit=N`` bounds the schedule
traces and the retired-tid set for long-lived sessions.

:class:`ThreadedSession` runs K worker threads, each with its own
``torch.cuda.Stream``: a worker launches its task under that stream,
records an event and waits on it (the paper's StreamSync) before the task
retires, so a consumer on another stream never reads an unfinished output.

Thread-safety: all bookkeeping runs under one re-entrant lock, so
retirement callbacks may submit follow-on work into the same session.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Union

import torch

from .buffers import DeviceLike, resolve_device
from .executors import ExecStats, FusedWaveExecutor
from .scheduler import SchedulerReport
from .task import Task
from .window import SchedulingWindow

__all__ = ["SchedulerSession", "TaskTicket", "WaveSession", "ThreadedSession"]

RetireCallback = Callable[[Task], None]


class TaskTicket:
    """Future-like handle to one task's retirement (thread-safe)."""

    __slots__ = ("task", "_event")

    def __init__(self, task: Task):
        self.task = task
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until retirement. Only meaningful while something else
        drives the session (a worker thread, or another caller polling)."""
        return self._event.wait(timeout)


class SchedulerSession:
    """Base class: open window + retirement bookkeeping. Subclasses supply
    the dispatch policy via ``_pump`` (one non-blocking scheduling step)
    and may override ``drive``/``flush``."""

    def __init__(self, window_size: int = 32,
                 history_limit: Optional[int] = None):
        if history_limit is not None and history_limit < 1:
            raise ValueError(f"history_limit must be >= 1, got {history_limit}")
        self.window = SchedulingWindow(window_size)
        self.window.open_input()
        self._lock = threading.RLock()
        self._t0 = time.perf_counter()
        self.history_limit = history_limit
        if history_limit is None:
            self.waves: Any = []
            self.groups: Any = []  # GroupTrace entries (frontier)
        else:
            self.waves = deque(maxlen=history_limit)
            self.groups = deque(maxlen=history_limit)
        self._submitted = 0
        self._retired = 0
        self._retired_tids: Set[int] = set()
        # Bounded mode: retirement order of _retired_tids members, and the
        # evicted tids merged into sorted disjoint [lo, hi] intervals so
        # _is_retired stays exact after rotation.
        self._retired_order: Optional[deque] = (
            deque() if history_limit is not None else None)
        self._retired_evicted: List[List[int]] = []
        self._fresh: List[Task] = []  # retired since last drain
        self._watchers: Dict[int, List[RetireCallback]] = {}
        self._tickets: Dict[int, TaskTicket] = {}
        self._listeners: List[RetireCallback] = []
        self.retired_by_tag: Dict[str, int] = {}
        self._closed = False

    # -- producer side -----------------------------------------------------
    def submit(
        self,
        tasks: Union[Task, Iterable[Task]],
        on_retire: Optional[RetireCallback] = None,
    ) -> int:
        """Enqueue task(s) into the live window; callable at any time while
        the session is open, including from retirement callbacks. Returns
        the post-submit backlog depth (input FIFO + window residents) —
        the producer's backpressure signal."""
        batch = [tasks] if isinstance(tasks, Task) else list(tasks)
        with self._lock:
            if self._closed or not self.window.input_open:
                raise RuntimeError("cannot submit to a closed session")
            for t in batch:
                if on_retire is not None:
                    self._watchers.setdefault(t.tid, []).append(on_retire)
                self._submitted += 1
                self.window.submit(t)
            depth = self.window.backlog()
            self._wake()
        return depth

    def backlog(self) -> int:
        """Tasks submitted but not yet retired (FIFO + resident)."""
        with self._lock:
            return self.window.backlog()

    def window_stats(self) -> Dict[str, int]:
        """Live snapshot of the window's counters (dep_checks =
        pairwise-equivalent Algorithm 1 cost, scoreboard_probes = interval
        cells actually inspected, inserted/retired/max_resident) — the
        monitoring surface servers poll without draining the session."""
        with self._lock:
            return self.window.stats.as_dict()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._submitted - self._retired

    # -- retirement observation --------------------------------------------
    def add_retire_listener(self, cb: RetireCallback) -> None:
        """Session-wide retirement subscriber (fires for every task)."""
        with self._lock:
            self._listeners.append(cb)

    def _is_retired(self, tid: int) -> bool:
        """Exact has-this-tid-ever-retired test (lock held): the live set,
        plus the merged intervals of tids evicted under ``history_limit``."""
        if tid in self._retired_tids:
            return True
        iv = self._retired_evicted
        if not iv:
            return False
        # last interval whose lo <= tid ([tid, inf] sorts after any of them)
        i = bisect.bisect_right(iv, [tid, float("inf")]) - 1
        return i >= 0 and iv[i][0] <= tid <= iv[i][1]

    def _evict_retired_tid(self, tid: int) -> None:
        """Move one tid from the live retired set into the interval list
        (lock held), merging with adjacent intervals."""
        iv = self._retired_evicted
        i = bisect.bisect_left(iv, [tid, tid])
        left = i > 0 and iv[i - 1][1] + 1 >= tid
        right = i < len(iv) and iv[i][0] <= tid + 1
        if left and tid <= iv[i - 1][1]:
            return  # already covered
        if left and right and iv[i][0] == tid + 1:
            iv[i - 1][1] = iv[i][1]
            del iv[i]
        elif left:
            iv[i - 1][1] = tid
        elif right and iv[i][0] == tid + 1:
            iv[i][0] = tid
        elif right and iv[i][0] <= tid:
            pass  # already covered
        else:
            iv.insert(i, [tid, tid])

    def on_task_retired(self, task: Task, cb: RetireCallback) -> None:
        """Per-task completion callback; fires immediately if the task has
        already retired."""
        with self._lock:
            fire_now = self._is_retired(task.tid)
            if not fire_now:
                self._watchers.setdefault(task.tid, []).append(cb)
        if fire_now:
            cb(task)

    def ticket(self, task: Task) -> TaskTicket:
        """Future-like handle for one task's retirement."""
        with self._lock:
            tk = self._tickets.get(task.tid)
            if tk is None:
                tk = TaskTicket(task)
                if self._is_retired(task.tid):
                    tk._event.set()
                else:
                    self._tickets[task.tid] = tk
            return tk

    # -- scheduler side ----------------------------------------------------
    def poll(self) -> List[Task]:
        """Non-blocking progress; returns tasks retired since last drain."""
        with self._lock:
            self._pump()
        return self._drain_fresh()

    def drive(self) -> List[Task]:
        """Progress, blocking for at most one retirement if stalled."""
        return self.poll()

    def flush(self) -> None:
        """Block until every task submitted so far has retired."""
        while True:
            with self._lock:
                if self._retired >= self._submitted:
                    return
                progressed = self._pump()
            if not progressed:
                self._on_stall()

    def close(self) -> SchedulerReport:
        """End the input stream, drain everything in flight, and report."""
        with self._lock:
            if self._closed:
                raise RuntimeError("session already closed")
            self.window.close_input()
        self.flush()
        report = self._finalize()
        self._closed = True
        return report

    # -- internals ---------------------------------------------------------
    def _pump(self) -> bool:
        """One non-blocking scheduling step; True if progress was made.
        Called with the lock held."""
        raise NotImplementedError

    def _on_stall(self) -> None:
        """Nothing progressed during flush but work remains outstanding."""
        raise RuntimeError("scheduler stall: no READY kernels but window non-empty")

    def _finalize(self) -> SchedulerReport:
        raise NotImplementedError

    def _wake(self) -> None:
        """Submission hook (threaded sessions notify their workers)."""

    def _drain_fresh(self) -> List[Task]:
        with self._lock:
            out, self._fresh = self._fresh, []
        return out

    def _note_retired(self, task: Task) -> None:
        """Central retirement bookkeeping (lock held): counters, per-tag
        accounting, tickets, then callbacks. Callbacks run under the
        re-entrant lock so they may submit into this session."""
        self._retired += 1
        self._retired_tids.add(task.tid)
        if self._retired_order is not None:
            self._retired_order.append(task.tid)
            while len(self._retired_tids) > self.history_limit:
                old = self._retired_order.popleft()
                if old in self._retired_tids:
                    self._retired_tids.discard(old)
                    self._evict_retired_tid(old)
        self._fresh.append(task)
        tag = task.stream_tag
        if tag is not None:
            self.retired_by_tag[tag] = self.retired_by_tag.get(tag, 0) + 1
            if self.history_limit is not None and \
                    len(self.retired_by_tag) > self.history_limit:
                self.retired_by_tag.pop(next(iter(self.retired_by_tag)))
        ticket = self._tickets.pop(task.tid, None)
        if ticket is not None:
            ticket._event.set()
        for cb in self._watchers.pop(task.tid, ()):  # noqa: B020
            cb(task)
        for cb in self._listeners:
            cb(task)


class WaveSession(SchedulerSession):
    """Wave-synchronous session: each ``poll`` launches the current READY
    set as one fused wave and retires it. With ``window_size=1`` this
    degenerates to the serial baseline even under live feeding (tested
    property); ``WaveScheduler.run`` is the closed-batch wrapper."""

    def __init__(self, window_size: int = 32, executor: Optional[Any] = None,
                 max_wave: Optional[int] = None,
                 history_limit: Optional[int] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(window_size, history_limit=history_limit)
        self.executor = executor if executor is not None else FusedWaveExecutor(device)
        self.max_wave = max_wave

    def _pump(self) -> bool:
        ready = self.window.ready_tasks()
        if not ready:
            return False
        if self.max_wave is not None:
            # ready_tasks() is priority-bucketed (DESIGN §13): a capped
            # wave takes the most urgent READY kernels first.
            ready = ready[: self.max_wave]
        for t in ready:
            self.window.mark_executing(t)
        self.executor.execute_wave(ready)
        self.waves.append([t.tid for t in ready])
        for t in ready:
            self.window.retire(t)
            self._note_retired(t)
        return True

    def _finalize(self) -> SchedulerReport:
        self.executor.finalize()
        wall = time.perf_counter() - self._t0
        return SchedulerReport(self.window, self.executor.stats, wall, self.waves)


class ThreadedSession(SchedulerSession):
    """Paper-faithful ACS-SW as a live session: K worker threads, each
    driving its own CUDA stream, executing concurrently with producer
    submissions (plain threads when ``device`` is the CPU).

    Idle workers park on a :class:`threading.Condition` and are signalled
    on submit, retire, and close."""

    def __init__(self, window_size: int = 32, num_streams: int = 4,
                 device: DeviceLike = "cuda",
                 history_limit: Optional[int] = None):
        super().__init__(window_size, history_limit=history_limit)
        self.num_streams = num_streams
        self.device = resolve_device(device)
        self.stats = ExecStats()
        self._cv = threading.Condition(self._lock)
        self._worker_error: Optional[BaseException] = None
        if self.device.type == "cuda":
            # Values the producer made (initial state, uploaded actions)
            # are queued on its stream; every launch waits for them.
            self._producer = torch.cuda.current_stream(self.device)
            streams = [torch.cuda.Stream(self.device) for _ in range(num_streams)]
        else:
            self._producer = None
            streams = [None] * num_streams
        self._threads = [
            threading.Thread(target=self._worker, args=(s,), daemon=True,
                             name=f"acs-stream-{i}")
            for i, s in enumerate(streams)
        ]
        for th in self._threads:
            th.start()

    def _wake(self) -> None:
        self._cv.notify_all()

    def _launch(self, stream, task: Task, vals):
        """Run ``task`` on this worker's stream and wait for it there
        (StreamSync): the output is complete before the task retires."""
        if stream is None:
            return task.fn(*vals)
        with torch.cuda.stream(stream):
            stream.wait_stream(self._producer)
            out = task.fn(*vals)
        for v in vals:
            if isinstance(v, torch.Tensor):
                # Made on another stream, read on this one: the allocator
                # must not hand its memory out before this use ends.
                v.record_stream(stream)
        stream.synchronize()
        return out

    def _write_back(self, stream, task: Task, out) -> None:
        """Write outputs (lock held). A row-view write clones its buffer,
        which is device work: run it on this worker's stream and wait, so
        the new value is complete before any other stream can read it."""
        if stream is None:
            task.write_outputs(out)
            return
        with torch.cuda.stream(stream):
            task.write_outputs(out)
        stream.synchronize()

    def _worker(self, stream) -> None:
        # Algorithm 2, session form: wait (not spin) for a READY kernel,
        # launch, StreamSync, retire, signal.
        try:
            while True:
                with self._cv:
                    task = None
                    while task is None:
                        if self.window.drained():
                            return  # input closed AND complete
                        ready = self.window.ready_tasks()
                        if ready:
                            task = ready[0]
                            self.window.mark_executing(task)
                            vals = task.input_values()
                        else:
                            self._cv.wait()  # woken on submit/retire/close
                out = self._launch(stream, task, vals)
                with self._cv:
                    self._write_back(stream, task, out)
                    self.window.retire(task)
                    if stream is not None:
                        self.stats.blocking_syncs += 2  # launch + write-back
                    self.stats.dispatches += 1
                    self.stats.tasks_run += 1
                    self.stats.wave_widths.append(1)
                    self.waves.append([task.tid])
                    self._note_retired(task)
                    self._cv.notify_all()
        except BaseException as exc:  # surface worker crashes to flush/close
            with self._cv:
                self._worker_error = exc
                self._cv.notify_all()

    def _check_error(self) -> None:
        if self._worker_error is not None:
            raise RuntimeError("threaded session worker failed") from self._worker_error

    def poll(self) -> List[Task]:
        with self._cv:
            self._check_error()
        return self._drain_fresh()

    def drive(self) -> List[Task]:
        with self._cv:
            self._check_error()
            if self._retired < self._submitted:
                self._cv.wait(timeout=0.1)
                self._check_error()
        return self._drain_fresh()

    def flush(self) -> None:
        with self._cv:
            while self._retired < self._submitted:
                self._check_error()
                self._cv.wait(timeout=0.1)
            self._check_error()

    def _finalize(self) -> SchedulerReport:
        with self._cv:
            self._cv.notify_all()  # input is closed: let idle workers exit
        for th in self._threads:
            th.join()
        self._check_error()
        if not self.window.drained():
            raise RuntimeError("threaded scheduler exited before draining the window")
        wall = time.perf_counter() - self._t0
        self.stats.exec_seconds = wall
        return SchedulerReport(self.window, self.stats, wall, self.waves)
