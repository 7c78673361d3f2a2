"""Device-resident ready-queue executor — the ACS-HW path on the H100
(port of ``repro/kernels/ready_queue.py``).

The paper's ACS-HW dispatches a kernel the moment its upstream count hits
zero, entirely on the accelerator. :func:`ready_queue` runs one epoch of
that loop as ONE cooperative launch of the hand-written CUDA kernel in
``csrc/ready_queue.cu`` (its header says what bounds it and how it is
laid out):

* the task table ``[n, 5] int32`` holds each task's branch id and slab rows
  ``(branch, in0, in1, in2, out_row)``;
* ``dep_tbl [n, m] int32`` holds forward edges, sentinel-padded with ``n``;
* a persistent grid (one block an SM) first checks the tables on the
  device, then every block claims ready tasks from one device-wide
  ring, runs each whole and retires it with warp-parallel atomics that
  push its dependents as their counts reach zero, with no host
  involvement.

The contract, kept by the plain version :func:`~.ref.ready_queue_ref` too:
tables that fail a check (:func:`~.ref.ready_queue_tables_error`) run no
task, so the slab comes back unchanged, ``done`` all 0 and ``ring`` equal
to ``ring0``, for the caller to report as a stall. Tables that pass drain.
``slab'`` and ``done`` are then the same bits on every device and every
run, and ``ring[:n]`` is the order in which tasks started: a topological
order of ``dep_tbl`` that a concurrent queue does not fix from run to run
(the plain version's is its FIFO pop order). ``ring[n]`` keeps ``ring0[n]``.

The reference's ``lax.switch`` over Python callables becomes a fixed opcode
set compiled into the kernel (``kernels/ops.py`` ``LOOP_OPCODES``); each
branch fn is mapped to its opcode by identity, and anything else raises.

The kernel is built at first use with ``nvcc`` into ``_build/`` beside this
file (listed in ``.gitignore``) and bound through ``ctypes``. A CPU tensor
goes to the plain version; a CUDA tensor launches the kernel or raises,
also when the cooperative launch is refused.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ._nvcc import CudaLibrary, raw_stream
from .ops import LOOP_OPCODES, branch_table
from .ref import ready_queue_ref

__all__ = ["ready_queue", "build", "launches", "reset_launches", "launch_stats", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ready_queue.cu"

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel, never by the plain version.
launches = 0
# The last launch's scratch, which launch_stats() reads.
_last_scratch: Optional[torch.Tensor] = None

# csrc/ready_queue.cu's scratch layout: kHeader counter words, and where
# the kernel leaves its grid and the blocks that ran a task.
_HEADER, _GRID_SIZE, _BLOCKS_RAN = 10, 8, 6


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_ready_queue.argtypes = [
        ptr, i32, i32,          # slab, rows, d
        ptr, ptr, i32, i32,     # task_tbl, dep_tbl, n, m
        ptr, i32,               # branch_ops, n_branches
        ptr, ptr, ptr,          # ring0, rem0, tail0
        ptr, ptr, ptr,          # ring, done, scratch
        ptr,                    # stream
    ]
    lib.acs_ready_queue.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)


def build() -> Tuple[Path, float]:
    """Compile ``csrc/ready_queue.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the shared library's path and the seconds the
    compile took (0.0 when it was already built)."""
    return _LIB.build()


def launch_stats() -> Dict[str, int]:
    """The last launch's grid (``blocks``) and how many of its blocks ran a
    task (``blocks_ran``): reads its scratch, a host sync."""
    if _last_scratch is None:
        raise RuntimeError("ready_queue: no kernel launched yet")
    words = _last_scratch[:_HEADER].tolist()
    return {"blocks": words[_GRID_SIZE], "blocks_ran": words[_BLOCKS_RAN]}


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
    rem0: torch.Tensor,       # [n+1] int32 in-degrees + one unused slot
    tail0: torch.Tensor,      # [1] int32 count of initially-ready tasks
    *,
    branches: Sequence[Callable],  # per branch id: a LOOP_BRANCHES fn
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one epoch's ready queue; returns ``(slab', done, ring)``.

    ``slab'`` is a fresh tensor (the input is not modified), ``done`` the
    ``[n] int32`` completion flags (all ones iff the tables passed the
    checks, all zeros otherwise) and ``ring`` the ``[n+1]`` start order
    (``ring0`` itself when nothing ran; see the module docstring).
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
    out = slab.clone()
    if n == 0:
        return out, torch.zeros(0, dtype=torch.int32, device=dev), ring0.clone()
    ring = torch.empty(n + 1, dtype=torch.int32, device=dev)
    done = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros(_HEADER + 3 * n, dtype=torch.int32, device=dev)
    err = _LIB.get().acs_ready_queue(
        out.data_ptr(), out.shape[0], out.shape[1],
        task_tbl.data_ptr(), dep_tbl.data_ptr(), n, m,
        branch_table(branches, dev).data_ptr(), len(branches),
        ring0.data_ptr(), rem0.data_ptr(), tail0.data_ptr(),
        ring.data_ptr(), done.data_ptr(), scratch.data_ptr(), raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"ready_queue kernel launch failed: CUDA error {err}")
    global launches, _last_scratch
    launches += 1
    _last_scratch = scratch
    return out, done, ring
