"""Analytic device model for scheduling-policy evaluation (PyTorch port of
``repro/core/perfmodel.py``; plain float arithmetic, equal to the
reference's on the same stream).

Model
-----
A device has ``units`` parallel execution slots (SM analogue). Kernel k
needs ``u_k = min(ctas_k, units)`` slots for ``t_k`` microseconds where::

    t_k = max(flops_k / flops_rate, bytes_k / bytes_rate, min_kernel_us)

Policies (paper §VI configurations):

* ``serial``    — single stream: kernels run alone, back-to-back; each
                  pays ``launch_us``.
* ``acs_sw``    — windowed waves; kernels in a wave run concurrently
                  (shelf-packed onto ``units``); each kernel pays
                  ``launch_us + sync_us`` spread over ``num_streams``
                  scheduler threads (Algorithm 2's launch + StreamSync).
* ``acs_hw``    — same wave plan; per-kernel overhead is the hardware
                  window's dispatch latency (``hw_dispatch_us``) and no
                  CPU sync.
* ``cudagraph`` — full-DAG level schedule, zero per-kernel overhead, plus
                  the host-side DAG construction time (``construct_us``).

The model ignores second-order effects (L2 contention, wave
quantization): it compares policies; it does not predict a card.
``H100_LIKE`` holds the port's own device, each constant beside its
source; the other three are the reference's data, kept as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from .task import Task, operand_shape

__all__ = ["DeviceModel", "H100_LIKE", "RTX3060_LIKE", "RTX3070_LIKE", "TPU_V5E_CORE",
           "kernel_time_us", "kernel_ctas", "shelf_makespan", "simulate"]


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    units: int              # parallel kernel slots (SMs / cores)
    launch_us: float        # host kernel-launch overhead
    sync_us: float          # CPU<->device completion sync overhead
    hw_dispatch_us: float   # ACS-HW window dispatch latency
    flops_per_us: float
    bytes_per_us: float
    min_kernel_us: float = 1.0
    threads_per_cta: int = 256
    # achieved fraction of peak for small kernels (no deep pipelining,
    # cold caches, short grids) — calibrates absolute kernel times
    small_kernel_efficiency: float = 0.12
    num_streams: int = 4    # ACS-SW scheduler threads (paper §IV-B)


# The reference's devices (its data, unchanged): the paper's RTX3060 and
# RTX3070 (§V), and one TPU v5e core.
RTX3060_LIKE = DeviceModel("rtx3060", units=28, launch_us=5.0, sync_us=8.0,
                           hw_dispatch_us=0.08, flops_per_us=12.7e6,
                           bytes_per_us=360e3, min_kernel_us=3.0)
RTX3070_LIKE = DeviceModel("rtx3070", units=46, launch_us=5.0, sync_us=8.0,
                           hw_dispatch_us=0.08, flops_per_us=20.3e6,
                           bytes_per_us=448e3, min_kernel_us=3.0)
TPU_V5E_CORE = DeviceModel("tpu-v5e", units=8, launch_us=10.0, sync_us=15.0,
                           hw_dispatch_us=0.1, flops_per_us=197e6,
                           bytes_per_us=819e3)
# One NVIDIA H100 SXM (80 GB HBM3, 700 W power limit), the port's card:
H100_LIKE = DeviceModel(
    "h100",
    units=132,              # SMs (NVIDIA's H100 data sheet)
    # Median host time of one small launch (`x.add_(1)` on 4 floats,
    # enqueue only) and of a `torch.cuda.synchronize()` right after one:
    # chip_smoke.py's phase_perfmodel on an H100 80GB HBM3 at 700 W (7.42
    # and 8.62 us; 13.49 and 14.53 on another host).
    launch_us=7.4,
    sync_us=8.6,
    # The ready queue's hop from one retired task to its dependent's start:
    # one 32-deep chain's device time / 32 (chip_smoke.py's phase_numbers,
    # ``hop_us``, 2.747 us on an H100 80GB HBM3 at 700 W).
    hw_dispatch_us=2.7,
    flops_per_us=67e6,      # 67 TFLOP/s float32 outside the tensor cores (data sheet)
    bytes_per_us=3.35e6,    # 3.35 TB/s HBM3 (data sheet)
    # min_kernel_us, threads_per_cta, small_kernel_efficiency and
    # num_streams keep the class defaults (the reference's, not measured).
)


def kernel_time_us(task: Task, m: DeviceModel) -> float:
    eff = m.small_kernel_efficiency
    return max(task.cost_flops / (eff * m.flops_per_us),
               task.cost_bytes / (eff * m.bytes_per_us),
               m.min_kernel_us)


def kernel_ctas(task: Task, m: DeviceModel) -> int:
    elems = sum(int(np.prod(operand_shape(o))) for o in task.outputs)
    return max(1, -(-elems // m.threads_per_cta))


def shelf_makespan(items: Sequence[Tuple[int, float]], units: int) -> Tuple[float, float]:
    """Greedy shelf packing of (width, time) items onto ``units`` slots.
    Returns (makespan_us, busy_slot_us)."""
    makespan = 0.0
    busy = 0.0
    cap = 0
    shelf_t = 0.0
    for u, t in sorted(items, key=lambda x: -x[1]):
        busy += u * t
        if cap + u > units and cap > 0:
            makespan += shelf_t
            cap, shelf_t = 0, 0.0
        cap += u
        shelf_t = max(shelf_t, t)
    makespan += shelf_t
    return makespan, busy


def simulate(waves: Sequence[Sequence[Task]], model: DeviceModel, policy: str,
             construct_us: float = 0.0) -> Dict[str, float]:
    """Model total device time and achieved occupancy for a wave plan.

    ``waves`` is the schedule trace: for ``serial`` pass one task per wave
    (program order); for acs/cudagraph pass the window/level plan.
    """
    total = construct_us
    busy_total = 0.0
    for wave in waves:
        if policy == "serial":
            for task in wave:
                t = kernel_time_us(task, model)
                u = min(kernel_ctas(task, model), model.units)
                total += t + model.launch_us
                busy_total += u * t
        else:
            if policy == "acs_sw":
                # per-kernel launch+sync runs on the K scheduler threads,
                # overlapping with device execution of other kernels: the
                # wave is bounded by max(device makespan, CPU issue rate).
                ovh = (model.launch_us + model.sync_us) / model.num_streams
            elif policy == "acs_hw":
                ovh = model.hw_dispatch_us
            elif policy == "cudagraph":
                ovh = 0.0
            else:
                raise ValueError(policy)
            items = []
            for task in wave:
                t = kernel_time_us(task, model)
                u = min(kernel_ctas(task, model), model.units)
                items.append((u, t))
                busy_total += u * t
            span, _ = shelf_makespan(items, model.units)
            total += max(span, ovh * len(wave))
    occupancy = busy_total / (model.units * total) if total > 0 else 0.0
    return {
        "time_us": total,
        "occupancy": min(occupancy, 1.0),
        "kernels": float(sum(len(w) for w in waves)),
        "policy_overhead_us": construct_us,
    }
