"""ACS-HW wave megakernel: one launch runs a whole wave of small
heterogeneous elementwise tasks from a descriptor table, or every wave of
a device-window epoch (port of ``repro/kernels/wave_elementwise.py``).

The paper's hardware window dispatches ready kernels without host
round-trips (Fig 20). Both entries launch the hand-written CUDA in
``csrc/wave_elementwise.cu`` (its header says what bounds it and how it is
laid out):

* ``desc [S, 4] int32`` holds each slot's ``(branch, in0_row, in1_row,
  out_row)``;
* :func:`wave_elementwise` runs ONE wave: slot ``si`` writes
  ``branches[branch](slab[in0], slab[in1])`` as row ``si`` of the
  ``[S, D]`` result, every slot reading the unmodified slab, and
  :func:`apply_wave` scatters the rows to ``desc[:, 3]`` out of place
  (out rows are unique within a wave: a WAW hazard would have put the two
  tasks in different waves);
* :func:`wave_epoch` runs EVERY step of a lowered plan in one persistent
  (cooperative) launch, in place on a slab the caller owns: step ``i`` is
  ``desc[offsets[i]:offsets[i + 1]]`` and computes exactly what
  ``wave_elementwise`` + the scatter compute for it, in step order, with a
  grid barrier between steps instead of a host round. A step marked
  ``direct`` (:func:`direct_steps`: no slot reads a row another slot of
  the step writes) writes its out rows at once; every other step stages
  its rows in scratch first. On an H100 the chain universe's 720-step
  plan takes 1.98 ms of device time in one launch, where the host loop of
  720 launches, clones and scatters took 58-85 ms of kernels and syncs.

The reference's ``lax.switch`` over Python callables becomes the fixed
opcode set compiled into the kernel (``kernels/ops.py`` ``LOOP_OPCODES``,
shared with the ready queue); each branch fn maps to its opcode by
identity, and anything else raises, on the CPU as on the card. The
kernel takes float32 slabs.

A descriptor naming a row outside the slab or a branch outside the table
never makes the kernel read out of bounds: its slot writes nothing and
sets an error flag (an epoch runs its later steps all the same). With
``err=None`` the wrapper reads the flag after the launch (one host sync)
and raises ``ValueError``; a caller that runs many waves or epochs passes
its own ``err`` tensor and calls :func:`raise_on_error` where it
synchronizes anyway.

``launches`` counts kernel launches (one per wave, or one per epoch);
``steps`` counts the plan steps the epoch kernel ran.

The kernel is built at first use with ``nvcc`` into ``_build/`` beside
this file and bound through ``ctypes``. A CPU tensor goes to the plain
version (:func:`~.ref.wave_rows_ref`; for an epoch, one
:func:`wave_elementwise` call and scatter per step); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from ._nvcc import CudaLibrary, raw_stream
from .ops import LOOP_OPCODES
from .ref import wave_rows_ref

__all__ = ["wave_elementwise", "wave_epoch", "direct_steps", "apply_wave", "raise_on_error",
           "build", "launches", "steps", "reset_launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wave_elementwise.cu"

# Kernel launches since the last reset_launches(): incremented once per
# launch of either CUDA kernel, never by the plain version.
launches = 0
# Plan steps the epoch kernel ran since the last reset_launches().
steps = 0

# (device, opcodes) -> the kernel's branch table on that device, uploaded once.
_OPS: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}


def reset_launches() -> None:
    global launches, steps
    launches = 0
    steps = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_wave_elementwise.argtypes = [
        ptr, i32, i32,      # slab, rows, d
        ptr, i32,           # desc, s
        ptr, i32,           # branch_ops, n_branches
        ptr, ptr,           # out, err
        ptr,                # stream
    ]
    lib.acs_wave_elementwise.restype = i32
    lib.acs_wave_epoch.argtypes = [
        ptr, i32, i32,      # slab, rows, d
        ptr, ptr, i32, i32,  # desc, steps, n_steps, s_max
        ptr, i32,           # branch_ops, n_branches
        ptr, ptr, ptr,      # scratch, err, arrivals
        ptr,                # stream
    ]
    lib.acs_wave_epoch.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)
_HANDLE = None  # the loaded, bound library, looked up at the first launch


def _lib() -> ctypes.CDLL:
    global _HANDLE
    if _HANDLE is None:
        _HANDLE = _LIB.get()
    return _HANDLE


def build() -> Tuple[Path, float]:
    """Compile ``csrc/wave_elementwise.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the shared library's path and the seconds the
    compile took (0.0 when it was already built)."""
    return _LIB.build()


def raise_on_error(err: torch.Tensor) -> None:
    """Read the kernel's error flag (a host sync) and raise ``ValueError``
    if any launch that shared it met a bad descriptor."""
    if int(err.reshape(-1)[0]) != 0:
        raise ValueError("wave_elementwise: a descriptor names a row outside the slab "
                         "or a branch outside the branch table")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"wave_elementwise: {name} is on {t.device}, slab on {device}")
    if t.dtype != dtype:
        raise TypeError(f"wave_elementwise: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"wave_elementwise: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"wave_elementwise: {name} must be contiguous")


def _check_branches(branches: Sequence[Callable]) -> None:
    unknown = [fn for fn in branches if fn not in LOOP_OPCODES]
    if unknown:
        raise ValueError(f"wave_elementwise: branches {unknown} have no kernel opcode; "
                         "only kernels/ops.py LOOP_BRANCHES run in the wave kernel")


def _branch_ops(branches: Sequence[Callable], device: torch.device) -> torch.Tensor:
    key = (device, tuple(LOOP_OPCODES[fn] for fn in branches))
    ops = _OPS.get(key)
    if ops is None:
        ops = _OPS[key] = torch.tensor(key[1], dtype=torch.int32, device=device)
    return ops


def wave_elementwise(
    slab: torch.Tensor,   # [R, D] float32 buffer rows
    desc: torch.Tensor,   # [S, 4] int32 (branch, in0_row, in1_row, out_row)
    *,
    branches: Sequence[Callable],  # per branch id: a LOOP_BRANCHES fn
    err: Optional[torch.Tensor] = None,  # [1] int32 error flag the caller checks
) -> torch.Tensor:
    """Returns ``[S, D]``: the result row of each wave slot. Launches on the
    current CUDA stream; without ``err`` it then syncs once to check the
    descriptors. A branch outside ``LOOP_BRANCHES`` is refused on every
    device: the opcode set is the kernel's."""
    _check_branches(branches)
    if slab.device.type == "cpu":
        return wave_rows_ref(slab, desc, branches)
    if slab.device.type != "cuda":
        raise ValueError(f"wave_elementwise: unsupported device {slab.device}")
    if slab.dim() != 2:
        raise ValueError(f"wave_elementwise: slab must be 2-D, got {tuple(slab.shape)}")
    dev = slab.device
    s = desc.shape[0]
    _check("slab", slab, torch.float32, slab.shape, dev)
    _check("desc", desc, torch.int32, (s, 4), dev)
    ops = _branch_ops(branches, dev)
    own = err is None
    if own:
        err = torch.zeros(1, dtype=torch.int32, device=dev)
    _check("err", err, torch.int32, (1,), dev)
    out = torch.empty((s, slab.shape[1]), dtype=torch.float32, device=dev)
    rc = _lib().acs_wave_elementwise(
        slab.data_ptr(), slab.shape[0], slab.shape[1], desc.data_ptr(), s,
        ops.data_ptr(), len(branches), out.data_ptr(), err.data_ptr(), raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"wave_elementwise kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    if own:
        raise_on_error(err)
    return out


def direct_steps(desc: np.ndarray, offsets: Sequence[int]) -> Tuple[bool, ...]:
    """Per plan step of ``desc [sum S_i, 4]`` (host int array, step ``i``
    at ``offsets[i]:offsets[i + 1]``): True when no slot reads a row that
    another slot of the step writes and the out rows are unique, so the
    epoch kernel may write the step's rows in place at once. A slot reading
    its own out row does not stop it."""
    offs = np.asarray(offsets, dtype=np.int64)
    n = len(offs) - 1
    if n < 1:
        return ()
    desc = np.asarray(desc, dtype=np.int64).reshape(-1, 4)
    step = np.repeat(np.arange(n), np.diff(offs))
    span = int(desc[:, 1:].max(initial=0)) + 1
    out_key = step * span + desc[:, 3]
    uniq, counts = np.unique(out_key, return_counts=True)
    clash = np.zeros(len(desc), dtype=bool)
    for col in (1, 2):
        reads_other = (desc[:, col] != desc[:, 3]) & np.isin(step * span + desc[:, col], uniq)
        clash |= reads_other
    clash |= np.isin(out_key, uniq[counts > 1])
    staged = np.bincount(step[clash], minlength=n) > 0
    return tuple(bool(x) for x in ~staged)


def _check_offsets(offsets: Sequence[int], n_slots: int) -> np.ndarray:
    offs = np.asarray(offsets)
    if offs.ndim != 1 or len(offs) < 1 or not np.issubdtype(offs.dtype, np.integer):
        raise ValueError(f"wave_epoch: offsets must be a 1-D sequence of ints, got {offsets!r}")
    if offs[0] != 0 or offs[-1] != n_slots:
        raise ValueError(f"wave_epoch: offsets must run from 0 to the {n_slots} descriptor "
                         f"rows, got {int(offs[0])} .. {int(offs[-1])}")
    if (np.diff(offs) < 0).any():
        raise ValueError("wave_epoch: offsets must not decrease")
    return offs.astype(np.int32)


def wave_epoch(
    slab: torch.Tensor,   # [R, D] float32 buffer rows, updated in place
    desc: torch.Tensor,   # [sum S_i, 4] int32 (branch, in0_row, in1_row, out_row)
    offsets: Sequence[int],  # host ints: step i is desc[offsets[i]:offsets[i + 1]]
    *,
    branches: Sequence[Callable],  # per branch id: a LOOP_BRANCHES fn
    err: Optional[torch.Tensor] = None,  # [1] int32 error flag the caller checks
    direct: Optional[Sequence[bool]] = None,  # per step: write in place (direct_steps)
) -> torch.Tensor:
    """Run every plan step in order, in place on ``slab``, and return it.
    Each step computes what :func:`wave_elementwise` and the scatter of
    :func:`apply_wave` compute for it. On the card this is ONE cooperative
    launch on the current CUDA stream; without ``err`` it then syncs once
    to check the descriptors. ``direct`` marks steps that may skip the
    staging (:func:`direct_steps` computes it); a step wrongly marked
    direct is refused on the CPU and computes other rows on the card."""
    _check_branches(branches)
    offs = _check_offsets(offsets, desc.shape[0])
    n_steps = len(offs) - 1
    flags = np.zeros(n_steps, dtype=np.int32)
    if direct is not None:
        if len(direct) != n_steps:
            raise ValueError(f"wave_epoch: {len(direct)} direct flags for {n_steps} steps")
        flags[:] = np.asarray(direct, dtype=bool)
    if slab.device.type == "cpu":
        if flags.any():
            safe = np.asarray(direct_steps(desc.numpy(), offs), dtype=bool)
            if (flags.astype(bool) & ~safe).any():
                raise ValueError("wave_epoch: a step marked direct has a slot that reads "
                                 "another slot's out row")
        for lo, hi in zip(offs[:-1].tolist(), offs[1:].tolist()):
            if hi > lo:
                step = desc[lo:hi]
                slab[step[:, 3].long()] = wave_elementwise(slab, step, branches=branches)
        return slab
    if slab.device.type != "cuda":
        raise ValueError(f"wave_epoch: unsupported device {slab.device}")
    if slab.dim() != 2:
        raise ValueError(f"wave_epoch: slab must be 2-D, got {tuple(slab.shape)}")
    dev = slab.device
    _check("slab", slab, torch.float32, slab.shape, dev)
    _check("desc", desc, torch.int32, (desc.shape[0], 4), dev)
    ops = _branch_ops(branches, dev)
    own = err is None
    if own:
        err = torch.zeros(1, dtype=torch.int32, device=dev)
    _check("err", err, torch.int32, (1,), dev)
    s_max = int(np.diff(offs).max(initial=0))
    if s_max == 0 or slab.shape[1] == 0:
        return slab  # no slot to run: nothing is launched
    # offsets then flags, one pinned upload that does not wait for the stream
    table = torch.from_numpy(np.concatenate([offs, flags])).pin_memory().to(
        dev, non_blocking=True)
    scratch = torch.empty((s_max, slab.shape[1]), dtype=torch.float32, device=dev)
    arrivals = torch.zeros(1, dtype=torch.int32, device=dev)  # the grid barrier's count
    rc = _lib().acs_wave_epoch(
        slab.data_ptr(), slab.shape[0], slab.shape[1], desc.data_ptr(), table.data_ptr(),
        n_steps, s_max, ops.data_ptr(), len(branches), scratch.data_ptr(), err.data_ptr(),
        arrivals.data_ptr(), raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"wave_epoch kernel launch failed: CUDA error {rc}")
    global launches, steps
    launches += 1
    steps += n_steps
    if own:
        raise_on_error(err)
    return slab


def apply_wave(slab: torch.Tensor, desc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter wave results back into a copy of the slab (out rows are
    unique within a wave: WAW hazards would have serialized the tasks into
    different waves)."""
    out = slab.clone()
    out[desc[:, 3].long()] = rows.to(slab.dtype)
    return out
