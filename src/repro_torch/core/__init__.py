"""repro_torch.core — ACS: windowed out-of-order kernel scheduling on
PyTorch (port of ``repro.core``): the segment algebra, buffers and tasks,
the scheduling window, the ACS-SW schedulers and sessions, and the ACS-HW
device ready queue over a slab arena."""

from .arena import ArenaAddress, ShapeClass, SlabArena, pad_shape, row_capacity
from .buffers import Buffer, BufferPool, BufferView, resolve_device
from .device_dispatch import DeviceOpRegistry, DeviceWindowRunner, lower_epoch_program, plan_waves
from .executors import FusedWaveExecutor, SerialExecutor
from .scheduler import (
    GroupTrace,
    PLAN_MODES,
    SCHEDULER_NAMES,
    SchedulerReport,
    ThreadedStreamScheduler,
    WaveScheduler,
    make_scheduler,
    run_serial,
)
from .scoreboard import IntervalScoreboard
from .segments import Segment, SegmentSet, any_overlap, depends_on, segments_overlap
from .session import SchedulerSession, TaskTicket, ThreadedSession, WaveSession
from .task import Task, operand_base, operand_dtype, operand_shape
from .window import SchedulingWindow, TaskState
from .wrapper import KERNEL_REGISTRY, AcsKernel, TaskStream, acs_kernel

__all__ = [
    "ArenaAddress", "ShapeClass", "SlabArena", "pad_shape", "row_capacity",
    "Buffer", "BufferPool", "BufferView", "resolve_device",
    "DeviceOpRegistry", "DeviceWindowRunner", "lower_epoch_program", "plan_waves",
    "FusedWaveExecutor", "SerialExecutor",
    "GroupTrace", "PLAN_MODES", "SCHEDULER_NAMES", "SchedulerReport",
    "ThreadedStreamScheduler", "WaveScheduler", "make_scheduler", "run_serial",
    "IntervalScoreboard",
    "Segment", "SegmentSet", "any_overlap", "depends_on", "segments_overlap",
    "SchedulerSession", "TaskTicket", "ThreadedSession", "WaveSession",
    "Task", "operand_base", "operand_dtype", "operand_shape",
    "SchedulingWindow", "TaskState",
    "KERNEL_REGISTRY", "AcsKernel", "TaskStream", "acs_kernel",
]
