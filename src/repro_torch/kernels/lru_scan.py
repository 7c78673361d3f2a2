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

Training: where an input needs a gradient the call is a
``torch.autograd.Function`` that saves ``a``, its output ``h`` and ``h0``,
and whose backward is the reverse scan ``acs_lru_scan_bwd`` of the same
``csrc/lru_scan.cu`` (``db``, ``da``, and ``dh0`` only where ``h0`` needs
one; bit-equal to :func:`~.ref.lru_scan_bwd_ref` on the card, counted on
``backward_launches``). On the CPU the same Function runs the plain
forward and the plain backward.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernel builds at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ._nvcc import CudaLibrary, raw_stream
from .ref import lru_scan_bwd_ref, lru_scan_ref

__all__ = ["lru_scan", "lru_scan_bwd", "build", "launches", "backward_launches",
           "reset_launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel (the forward) and of the reverse scan, never by
# the plain versions.
launches = 0
backward_launches = 0


def reset_launches() -> None:
    global launches, backward_launches
    launches = backward_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_lru_scan.argtypes = [ptr, ptr, ptr, ptr,  # a, b, h0, out
                                 i32, i32, i32,       # B, S, D
                                 i32, i32,            # dtype, h0 dtype
                                 ptr]                 # stream
    lib.acs_lru_scan.restype = i32
    lib.acs_lru_scan_bwd.argtypes = [ptr, ptr, ptr, ptr,  # a, h, h0, dh
                                     ptr, ptr, ptr,       # da, db, dh0 or null
                                     i32, i32, i32,       # B, S, D
                                     i32, i32,            # dtype, h0 dtype
                                     ptr]                 # stream
    lib.acs_lru_scan_bwd.restype = i32


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


def _forward(a, b, h0):
    """The scan on a's device: the plain version on the CPU, the kernel on
    a CUDA tensor."""
    if not a.is_cuda:
        if a.device.type == "cpu":
            return lru_scan_ref(a, b, h0)
        raise ValueError(f"lru_scan: unsupported device {a.device}")
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


def lru_scan_bwd(a, h, h0, dh, *, need_dh0=True):
    """The reverse scan: ``(da, db, dh0)`` in the dtypes of ``a``, ``h``
    and ``h0`` from the forward's ``a``, output ``h`` and ``h0`` and the
    output's gradient ``dh`` (``dh0`` None unless ``need_dh0``). The plain
    version on the CPU; on CUDA tensors the kernel, on the current stream,
    no sync."""
    if a.device.type == "cpu":
        da, db, dh0 = lru_scan_bwd_ref(a, h, h0, dh)
        return da, db, dh0 if need_dh0 else None
    if a.device.type != "cuda":
        raise ValueError(f"lru_scan_bwd: unsupported device {a.device}")
    _check(a, h, h0)
    dh = dh.to(h.dtype).contiguous()
    if dh.shape != h.shape or dh.device != a.device:
        raise ValueError(f"lru_scan_bwd: dh {tuple(dh.shape)} on {dh.device} does not match "
                         f"h {tuple(h.shape)} on {a.device}")
    n_batch, seq, dim = a.shape
    da, db = torch.empty_like(a), torch.empty_like(h)
    dh0 = torch.empty_like(h0) if need_dh0 else None
    global backward_launches
    err = _LIB.get().acs_lru_scan_bwd(
        a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
        None if dh0 is None else dh0.data_ptr(), n_batch, seq, dim, _DTYPES[a.dtype],
        _DTYPES[h0.dtype], raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"lru_scan backward launch failed: CUDA error {err}")
    backward_launches += 1
    return da, db, dh0


class _LruScanFunction(torch.autograd.Function):
    """The scan with ``a``, its output and ``h0`` saved; the reverse scan
    (or its plain version on the CPU) for the gradient."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        return lru_scan_bwd(a, h, h0, dh, need_dh0=ctx.needs_input_grad[2])


def lru_scan(
    a: torch.Tensor,   # [B, S, D] decay
    b: torch.Tensor,   # [B, S, D] input
    h0: torch.Tensor,  # [B, D] initial state
) -> torch.Tensor:
    """``h [B, S, D]`` in ``b``'s dtype, the carry in float32. Launches on
    the current CUDA stream without synchronizing. Differentiable on both
    devices."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or h0.requires_grad):
        return _LruScanFunction.apply(a, b, h0)
    return _forward(a, b, h0)
