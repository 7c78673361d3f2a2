"""Diagonal linear-recurrence scan ``h_t = a_t * h_{t-1} + b_t`` on the
H100 (port of ``repro/kernels/lru_scan.py``).

Serves the RG-LRU layers of recurrentgemma (``models/recurrent.py``), in
prefill (S = prompt length) and in every decode step (S = 1), 18 times a
decode step at recurrentgemma-2b. The kernel is the hand-written CUDA in
``csrc/lru_scan.cu`` (its header says what bounds it and how it is laid
out): a time-tiled scan over tiles of 16 or 32 channels, ``a`` and ``b``
streamed through a ``cp.async`` ring in shared memory, a float32 carry, any
S with no padding copy, bit-equal to the plain version
:func:`~.ref.lru_scan_ref` on the card. On an H100 its device time at
recurrentgemma's prefill ``[1, 512, 2560]`` f32 is 0.0105 ms (the first,
one-thread-per-channel design: 0.0296 ms); a decode launch is bound by
this wrapper's host path.

The wrapper's host path is short because it runs once per layer and
decode step: the C entry point is looked up once, the shape, dtype, device
and contiguity checks run once per distinct key of those (cached), and
the stream handle comes from PyTorch's raw accessor.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernel builds at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ._nvcc import CudaLibrary, raw_stream, refuse_grad
from .ref import lru_scan_ref

__all__ = ["lru_scan", "build", "launches", "reset_launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel, never by the plain version.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_lru_scan.argtypes = [ptr, ptr, ptr, ptr,  # a, b, h0, out
                                 i32, i32, i32,       # B, S, D
                                 i32, i32,            # dtype, h0 dtype
                                 ptr]                 # stream
    lib.acs_lru_scan.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)
_ENTRY = None  # the bound C entry point, looked up at the first launch
# (shapes, dtypes, devices, contiguity) of inputs that passed _check.
_CHECKED = set()


def build() -> Tuple[Path, float]:
    """Compile ``csrc/lru_scan.cu`` for ``sm_90a`` (once per source and
    flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"lru_scan: a and b must be equal [B, S, D] shapes, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    n_batch, seq, dim = a.shape
    if seq < 1:
        raise ValueError("lru_scan: the sequence must hold at least one step")
    if tuple(h0.shape) != (n_batch, dim):
        raise ValueError(f"lru_scan: h0 must be [{n_batch}, {dim}], got {tuple(h0.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"lru_scan: a and b must share one of {sorted(map(str, _DTYPES))}, "
                        f"got {a.dtype} and {b.dtype}")
    if h0.dtype not in _DTYPES:
        raise TypeError(f"lru_scan: h0 must be float32 or bfloat16, got {h0.dtype}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.device != a.device:
            raise ValueError(f"lru_scan: {name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"lru_scan: {name} must be contiguous")


def lru_scan(
    a: torch.Tensor,   # [B, S, D] decay
    b: torch.Tensor,   # [B, S, D] input
    h0: torch.Tensor,  # [B, D] initial state
) -> torch.Tensor:
    """``h [B, S, D]`` in ``b``'s dtype, the carry in float32. Launches on
    the current CUDA stream without synchronizing."""
    if not a.is_cuda:
        if a.device.type == "cpu":
            return lru_scan_ref(a, b, h0)
        raise ValueError(f"lru_scan: unsupported device {a.device}")
    refuse_grad("lru_scan", a, b, h0)
    key = (a.shape, b.shape, h0.shape, a.dtype, b.dtype, h0.dtype, a.get_device(),
           b.get_device(), h0.get_device(), a.is_contiguous(), b.is_contiguous(),
           h0.is_contiguous())
    if key not in _CHECKED:
        _check(a, b, h0)
        _CHECKED.add(key)
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_lru_scan
    n_batch, seq, dim = a.shape
    out = torch.empty_like(b)
    err = _ENTRY(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), n_batch, seq, dim,
                 _DTYPES[a.dtype], _DTYPES[h0.dtype], raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return out
