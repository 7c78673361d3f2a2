"""repro_torch.core — ACS: windowed out-of-order kernel scheduling on
PyTorch (port of ``repro.core``): the segment algebra, buffers and tasks,
the scheduling window, the ACS-SW schedulers and sessions, and the ACS-HW
device window (wave, frontier and ready-queue lowerings, closed-batch and
persistent) over a slab arena, its mesh-sharded form (one shard, arena
and CUDA stream a device slot), the full-DAG baseline, and the analytic
device model of the policies (``perfmodel``)."""

from .arena import (ArenaAddress, ShapeClass, ShardTransferTable, SlabArena, pad_shape,
                    row_capacity)
from .buffers import Buffer, BufferPool, BufferView, resolve_device
from .dag_baseline import DagRunner, build_full_dag, level_schedule
from .device_dispatch import (
    DeviceOpRegistry,
    DeviceSession,
    DeviceStep,
    DeviceWindowRunner,
    EpochProgram,
    compile_wave_plan,
    lower_epoch_program,
    lower_plan,
    plan_active_fraction,
    plan_frontier,
    plan_waves,
)
from .executors import (FusedWaveExecutor, GroupExecutor, GroupHandle, SerialExecutor,
                        group_by_signature)
from .frontier import AsyncFrontierScheduler, DispatchQueue, FrontierSession
from .mesh_session import MeshDeviceSession, ShardLink
from .perfmodel import (H100_LIKE, RTX3060_LIKE, RTX3070_LIKE, TPU_V5E_CORE, DeviceModel,
                        simulate)
from .scheduler import (
    GroupTrace,
    PLAN_MODES,
    SCHEDULER_NAMES,
    SESSION_NAMES,
    SchedulerReport,
    ThreadedStreamScheduler,
    WaveScheduler,
    make_scheduler,
    make_session,
    run_serial,
)
from .scoreboard import IntervalScoreboard
from .segments import Segment, SegmentSet, any_overlap, depends_on, segments_overlap
from .session import SchedulerSession, TaskTicket, ThreadedSession, WaveSession
from .task import Task, operand_base, operand_dtype, operand_shape
from .window import SchedulingWindow, TaskState
from .wrapper import KERNEL_REGISTRY, AcsKernel, TaskStream, acs_kernel

__all__ = [
    "ArenaAddress", "ShapeClass", "ShardTransferTable", "SlabArena", "pad_shape", "row_capacity",
    "Buffer", "BufferPool", "BufferView", "resolve_device",
    "DagRunner", "build_full_dag", "level_schedule",
    "DeviceOpRegistry", "DeviceSession", "DeviceStep", "DeviceWindowRunner", "EpochProgram",
    "compile_wave_plan", "lower_epoch_program", "lower_plan", "plan_active_fraction",
    "plan_frontier", "plan_waves",
    "FusedWaveExecutor", "GroupExecutor", "GroupHandle", "SerialExecutor", "group_by_signature",
    "AsyncFrontierScheduler", "DispatchQueue", "FrontierSession",
    "MeshDeviceSession", "ShardLink",
    "DeviceModel", "H100_LIKE", "RTX3060_LIKE", "RTX3070_LIKE", "TPU_V5E_CORE", "simulate",
    "GroupTrace", "PLAN_MODES", "SCHEDULER_NAMES", "SESSION_NAMES", "SchedulerReport",
    "ThreadedStreamScheduler", "WaveScheduler", "make_scheduler", "make_session", "run_serial",
    "IntervalScoreboard",
    "Segment", "SegmentSet", "any_overlap", "depends_on", "segments_overlap",
    "SchedulerSession", "TaskTicket", "ThreadedSession", "WaveSession",
    "Task", "operand_base", "operand_dtype", "operand_shape",
    "SchedulingWindow", "TaskState",
    "KERNEL_REGISTRY", "AcsKernel", "TaskStream", "acs_kernel",
]
