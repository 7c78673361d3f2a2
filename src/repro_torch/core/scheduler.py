"""ACS-SW schedulers: window -> waves -> executor (PyTorch port of
``repro/core/scheduler.py``).

:class:`WaveScheduler` is wave-synchronous: all READY kernels launch as one
wave, retire together, refill. It is deterministic, which the equivalence
tests rely on.

:class:`ThreadedStreamScheduler` is the ACS-SW of paper §IV-B: a window
module plus K scheduler threads, each driving its own CUDA stream
(Algorithm 2's poll/launch/StreamSync/retire loop) — on the card, the
paper's own design on the hardware it was built for.

Every scheduler is a closed-batch facade over a live
:class:`~.session.SchedulerSession`: ``run(tasks)`` opens a session,
submits the whole list, and closes. All leave the same final buffer
contents as the serial baseline: ACS only reorders provably independent
kernels.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from .buffers import DeviceLike, resolve_device
from .executors import ExecStats, FusedWaveExecutor, SerialExecutor
from .task import Task
from .window import SchedulingWindow

__all__ = [
    "GroupTrace",
    "SchedulerReport",
    "WaveScheduler",
    "ThreadedStreamScheduler",
    "run_serial",
    "SCHEDULER_NAMES",
    "PLAN_MODES",
    "make_scheduler",
]


class GroupTrace:
    """Lifetime of one dispatched group: launch/retire stamps."""

    __slots__ = ("tids", "t_launch", "t_retire", "blocking")

    def __init__(self, tids: List[int], t_launch: float, t_retire: float, blocking: bool = False):
        self.tids = tids
        self.t_launch = t_launch
        self.t_retire = t_retire
        self.blocking = blocking  # retired via blocking sync, not poll

    def as_dict(self) -> Dict[str, Any]:
        return {
            "tids": list(self.tids),
            "t_launch": self.t_launch,
            "t_retire": self.t_retire,
            "blocking": self.blocking,
        }


class SchedulerReport:
    def __init__(
        self,
        window: SchedulingWindow,
        exec_stats: ExecStats,
        wall_seconds: float,
        waves: List[List[int]],
        groups: Optional[List[GroupTrace]] = None,
    ):
        self.window_stats = window.stats.as_dict()
        self.exec_stats = exec_stats.as_dict()
        self.wall_seconds = wall_seconds
        self.waves = waves  # list of lists of tids (schedule trace)
        # Overlapping-lifetime trace: one entry per dispatched group.
        self.groups = groups if groups is not None else []

    @property
    def mean_wave_width(self) -> float:
        return self.exec_stats["mean_wave_width"]

    def occupancy_proxy(self, max_parallel: Optional[int] = None) -> float:
        """Mean fraction of the achievable parallel width filled per wave."""
        widths = [len(w) for w in self.waves] or [1]
        cap = max_parallel or max(widths)
        return sum(min(w, cap) for w in widths) / (len(widths) * cap)

    def max_inflight_groups(self) -> int:
        """Peak number of groups simultaneously in flight (trace-derived)."""
        events = []
        for g in self.groups:
            events.append((g.t_launch, 1))
            events.append((g.t_retire, -1))
        depth = peak = 0
        for _, delta in sorted(events):
            depth += delta
            peak = max(peak, depth)
        return peak

    def retire_order(self) -> List[int]:
        """Tids in retirement order (groups sorted by retire stamp)."""
        order: List[int] = []
        for g in sorted(self.groups, key=lambda g: g.t_retire):
            order.extend(g.tids)
        return order

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "wall_seconds": self.wall_seconds,
            "waves": len(self.waves),
            **{f"window_{k}": v for k, v in self.window_stats.items()},
            **{f"exec_{k}": v for k, v in self.exec_stats.items()},
        }
        if self.groups:
            out["groups"] = len(self.groups)
            out["max_inflight_groups"] = self.max_inflight_groups()
        return out


class WaveScheduler:
    """Windowed out-of-order scheduler, wave-synchronous execution."""

    def __init__(self, window_size: int = 32, executor: Optional[Any] = None,
                 max_wave: Optional[int] = None, device: DeviceLike = "cuda"):
        self.window_size = window_size
        self.executor = executor if executor is not None else FusedWaveExecutor(device)
        self.max_wave = max_wave  # cap = number of "streams"; None = unbounded

    def session(self):
        """Open a live :class:`~.session.WaveSession` sharing this
        scheduler's executor."""
        from .session import WaveSession

        return WaveSession(window_size=self.window_size, executor=self.executor,
                           max_wave=self.max_wave)

    def run(self, stream: Iterable[Task]) -> SchedulerReport:
        """Closed-batch wrapper: open a session, submit everything, close."""
        session = self.session()
        session.submit(list(stream))
        return session.close()


class ThreadedStreamScheduler:
    """Paper-faithful ACS-SW: K scheduler threads, each with its own CUDA
    stream on ``device`` (plain threads on the CPU)."""

    def __init__(self, window_size: int = 32, num_streams: int = 4,
                 device: DeviceLike = "cuda"):
        self.window_size = window_size
        self.num_streams = num_streams
        self.device = resolve_device(device)

    def session(self):
        """Open a live :class:`~.session.ThreadedSession`: K worker threads
        park on a condition variable until the FIFO feeds them."""
        from .session import ThreadedSession

        return ThreadedSession(window_size=self.window_size,
                               num_streams=self.num_streams,
                               device=self.device)

    def run(self, stream: Iterable[Task]) -> SchedulerReport:
        """Closed-batch wrapper: open a session, submit everything, close."""
        session = self.session()
        session.submit(list(stream))
        return session.close()


def run_serial(stream: Iterable[Task], device: DeviceLike = "cuda") -> SchedulerReport:
    """The single-stream baseline: program order, one call per kernel."""
    sched = WaveScheduler(window_size=1, executor=SerialExecutor(device))
    return sched.run(stream)


# Only the ported policies. "frontier" comes with the async-frontier slice
# (ROADMAP queue 1, item 5).
SCHEDULER_NAMES = ("serial", "wave", "threaded", "device")
# Device plan lowerings of the reference. The port has "loop" (the
# device-resident ready queue); "wave"/"frontier" are still to port.
PLAN_MODES = ("wave", "frontier", "loop")


def make_scheduler(name: str, window_size: int = 32, num_streams: int = 4,
                   plan_mode: str = "loop", device: DeviceLike = "cuda"):
    """Factory over the ported execution policies. Returns a persistent
    scheduler's bound ``run`` (``tasks -> SchedulerReport``).

    ``plan_mode`` only affects ``name="device"``; the port implements
    ``"loop"`` (the reference's default is ``"wave"``, not yet ported).
    """
    if plan_mode not in PLAN_MODES:
        raise ValueError(f"plan_mode must be one of {PLAN_MODES}, got {plan_mode!r}")
    if name == "serial":
        return WaveScheduler(window_size=1, executor=SerialExecutor(device)).run
    if name == "wave":
        return WaveScheduler(window_size=window_size, device=device).run
    if name == "threaded":
        return ThreadedStreamScheduler(window_size=window_size,
                                       num_streams=num_streams, device=device).run
    if name == "device":
        from .device_dispatch import DeviceWindowRunner

        return DeviceWindowRunner(window_size=window_size, plan_mode=plan_mode,
                                  device=device).run
    raise ValueError(f"unknown scheduler {name!r}; choose from {SCHEDULER_NAMES}")
