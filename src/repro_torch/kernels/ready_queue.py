"""Device-resident ready-queue executor — the ACS-HW path on the H100
(port of ``repro/kernels/ready_queue.py``).

The paper's ACS-HW dispatches a kernel the moment its upstream count hits
zero, entirely on the accelerator. :func:`ready_queue` runs one epoch of
that loop as ONE launch of the hand-written CUDA kernel in
``csrc/ready_queue.cu`` (its header says what bounds it and how it is
laid out):

* the task table ``[n, 5] int32`` holds each task's branch id and slab rows
  ``(branch, in0, in1, in2, out_row)``;
* ``dep_tbl [n, m] int32`` holds forward edges, sentinel-padded with ``n``;
* the per-task counters, the ready ring and the completion flags live on
  the device; retiring a task decrements its dependents' counters and
  pushes zero-crossings onto the ring, with no host involvement.

Program order is topological, so every edge points forward and the ring
never starves: pop ``i`` always has a task.

The reference's ``lax.switch`` over Python callables becomes a fixed opcode
set compiled into the kernel (``kernels/ops.py`` ``LOOP_OPCODES``); each
branch fn is mapped to its opcode by identity, and anything else raises.

The kernel is built at first use with ``nvcc`` into ``_build/`` beside this
file (listed in ``.gitignore``) and bound through ``ctypes``. A CPU tensor
goes to the plain version :func:`~.ref.ready_queue_ref`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Sequence, Tuple

import torch

from ._nvcc import CudaLibrary
from .ops import LOOP_OPCODES
from .ref import ready_queue_ref

__all__ = ["ready_queue", "build", "launches", "reset_launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ready_queue.cu"

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel, never by the plain version.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_ready_queue.argtypes = [
        ptr, i32, i32,          # slab, rows, d
        ptr, ptr, i32, i32,     # task_tbl, dep_tbl, n, m
        ptr, i32,               # branch_ops, n_branches
        ptr, ptr, ptr, ptr,     # ring, rem, done, tail0
        ptr,                    # stream
    ]
    lib.acs_ready_queue.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)


def build() -> Tuple[Path, float]:
    """Compile ``csrc/ready_queue.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the shared library's path and the seconds the
    compile took (0.0 when it was already built)."""
    return _LIB.build()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"ready_queue: {name} is on {t.device}, slab on {device}")
    if t.dtype != dtype:
        raise TypeError(f"ready_queue: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ready_queue: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"ready_queue: {name} must be contiguous")


def ready_queue(
    slab: torch.Tensor,       # [rows, d] float32, the single shape class's slab
    task_tbl: torch.Tensor,   # [n, 5] int32 (branch, in0, in1, in2, out_row)
    dep_tbl: torch.Tensor,    # [n, m] int32 forward edges, sentinel n
    ring0: torch.Tensor,      # [n+1] int32 initially-ready positions, pad n
    rem0: torch.Tensor,       # [n+1] int32 in-degrees + one trash slot
    tail0: torch.Tensor,      # [1] int32 count of initially-ready tasks
    *,
    branches: Sequence[Callable],  # per branch id: a LOOP_BRANCHES fn
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one epoch's ready queue; returns ``(slab', done, ring)``.

    ``slab'`` is a fresh tensor (the input is not modified), ``done`` the
    ``[n] int32`` completion flags (all ones iff the queue drained) and
    ``ring`` the final ``[n+1]`` ring (the pop order, then the trash slot).
    Launches on the current CUDA stream without synchronizing.
    """
    if slab.device.type == "cpu":
        return ready_queue_ref(slab, task_tbl, dep_tbl, ring0, rem0, tail0,
                               branches=branches)
    if slab.device.type != "cuda":
        raise ValueError(f"ready_queue: unsupported device {slab.device}")
    if slab.dim() != 2:
        raise ValueError(f"ready_queue: slab must be 2-D, got {tuple(slab.shape)}")
    n, m = dep_tbl.shape
    dev = slab.device
    _check("slab", slab, torch.float32, slab.shape, dev)
    _check("task_tbl", task_tbl, torch.int32, (n, 5), dev)
    _check("dep_tbl", dep_tbl, torch.int32, (n, m), dev)
    _check("ring0", ring0, torch.int32, (n + 1,), dev)
    _check("rem0", rem0, torch.int32, (n + 1,), dev)
    _check("tail0", tail0, torch.int32, (1,), dev)
    unknown = [fn for fn in branches if fn not in LOOP_OPCODES]
    if unknown:
        raise ValueError(f"ready_queue: branches {unknown} have no kernel opcode; "
                         "only kernels/ops.py LOOP_BRANCHES run on the card")
    ops = torch.tensor([LOOP_OPCODES[fn] for fn in branches], dtype=torch.int32,
                       device=dev)
    out = slab.clone()
    ring = ring0.clone()
    rem = rem0.clone()
    done = torch.empty(n, dtype=torch.int32, device=dev)
    err = _LIB.get().acs_ready_queue(
        out.data_ptr(), out.shape[0], out.shape[1],
        task_tbl.data_ptr(), dep_tbl.data_ptr(), n, m,
        ops.data_ptr(), len(branches),
        ring.data_ptr(), rem.data_ptr(), done.data_ptr(), tail0.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ready_queue kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out, done, ring
