"""ACS-HW wave megakernel: one launch runs a whole wave of small
heterogeneous elementwise tasks from a descriptor table (port of
``repro/kernels/wave_elementwise.py``).

The paper's hardware window dispatches ready kernels without host
round-trips (Fig 20). :func:`wave_elementwise` runs one wave of them as
ONE launch of the hand-written CUDA kernel in ``csrc/wave_elementwise.cu``
(its header says what bounds it and how it is laid out):

* ``desc [S, 4] int32`` holds each slot's ``(branch, in0_row, in1_row,
  out_row)``;
* slot ``si`` writes ``branches[branch](slab[in0], slab[in1])`` as row
  ``si`` of the ``[S, D]`` result, every slot reading the unmodified slab;
* :func:`apply_wave` scatters the rows to ``desc[:, 3]`` out of place
  (out rows are unique within a wave: a WAW hazard would have put the two
  tasks in different waves).

The reference's ``lax.switch`` over Python callables becomes the fixed
opcode set compiled into the kernel (``kernels/ops.py`` ``LOOP_OPCODES``,
shared with the ready queue); each branch fn maps to its opcode by
identity, and anything else raises, on the CPU as on the card. The
kernel takes float32 slabs.

A descriptor naming a row outside the slab or a branch outside the table
never makes the kernel read out of bounds: its slot writes nothing and
sets an error flag. With ``err=None`` the wrapper reads the flag after the
launch (one host sync) and raises ``ValueError``; a caller that runs many
waves passes its own ``err`` tensor and calls :func:`raise_on_error` once,
where it synchronizes anyway.

The kernel is built at first use with ``nvcc`` into ``_build/`` beside
this file and bound through ``ctypes``. A CPU tensor goes to the plain
version :func:`~.ref.wave_rows_ref`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ._nvcc import CudaLibrary
from .ops import LOOP_OPCODES
from .ref import wave_rows_ref

__all__ = ["wave_elementwise", "apply_wave", "raise_on_error", "build", "launches",
           "reset_launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "wave_elementwise.cu"

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel, never by the plain version.
launches = 0

# (device, opcodes) -> the kernel's branch table on that device, uploaded once.
_OPS: Dict[Tuple[torch.device, Tuple[int, ...]], torch.Tensor] = {}


def reset_launches() -> None:
    global launches
    launches = 0


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


_LIB = CudaLibrary(SOURCE, _bind)


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
    rc = _LIB.get().acs_wave_elementwise(
        slab.data_ptr(), slab.shape[0], slab.shape[1], desc.data_ptr(), s,
        ops.data_ptr(), len(branches), out.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wave_elementwise kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    if own:
        raise_on_error(err)
    return out


def apply_wave(slab: torch.Tensor, desc: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter wave results back into a copy of the slab (out rows are
    unique within a wave: WAW hazards would have serialized the tasks into
    different waves)."""
    out = slab.clone()
    out[desc[:, 3].long()] = rows.to(slab.dtype)
    return out
