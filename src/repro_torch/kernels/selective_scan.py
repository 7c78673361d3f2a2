"""Mamba's selective scan on the H100: the recurrence of the falcon-mamba
layers (``models/recurrent.py`` ``apply_mamba``), in prefill (S = prompt
length) and in every decode step (S = 1), once per layer and forward.

For each step ``t`` and channel ``e``, over ``N`` states::

    h    = exp(dt_t[e] * a[e, :]) * h + (dt_t[e] * x_t[e]) * b_t[:]
    y_t  = sum_n h[n] * c_t[n]

The reference has no kernel for it: it runs ``jax.lax.scan`` over that
step (``repro/models/recurrent.py`` ``apply_mamba``). The kernel is the
hand-written CUDA in ``csrc/selective_scan.cu`` (its header says what
bounds it and how it is laid out): four lanes a channel, the states in
registers, ``dt``/``x`` and ``b``/``c`` time tiles streamed through a
``cp.async`` ring, any B, S, E and N from 1 to 16, everything float32.
It is held to its plain version :func:`~.ref.selective_scan_ref` within a
tolerance (float32, 1e-5 relative), because it sums the N terms of ``y``
in another order than the plain version's einsum. On an H100 80GB HBM3
(700 W) falcon-mamba's prefill ``[1, 512, 8192]``, N 16, takes 0.166 ms
back to back against its bound of 0.0161 (the exponentials on the SFUs),
where the plain loop takes 72-96 ms; a decode launch is bound by this
wrapper's host path.

The wrapper is on the falcon-mamba decode step's path 64 times a step, so
its host work is short: the C entry point is looked up once and the
checks run once per distinct key of shapes, dtypes, devices and
contiguity (cached).

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernel builds at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ._nvcc import CudaLibrary, raw_stream
from .ref import selective_scan_ref

__all__ = ["selective_scan", "build", "launches", "reset_launches", "SOURCE", "MAX_STATE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "selective_scan.cu"
MAX_STATE = 16

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel, never by the plain version.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acs_selective_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,  # dt, x, b, c, a, h0
                                       ptr, ptr,                      # ys, hT
                                       i32, i32, i32, i32,            # B, S, E, N
                                       ptr]                           # stream
    lib.acs_selective_scan.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)
_ENTRY = None  # the bound C entry point, looked up at the first launch
# (shapes, dtypes, devices, contiguity) of inputs that passed _check.
_CHECKED = set()


def build() -> Tuple[Path, float]:
    """Compile ``csrc/selective_scan.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def _check(dt, x, bmat, cmat, a, h0) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan: dt and x must be equal [B, S, E] shapes, "
                         f"got {tuple(dt.shape)} and {tuple(x.shape)}")
    n_batch, seq, ch = dt.shape
    if seq < 1 or ch < 1:
        raise ValueError(f"selective_scan: empty scan {tuple(dt.shape)}")
    if a.dim() != 2 or a.shape[0] != ch:
        raise ValueError(f"selective_scan: a must be [{ch}, N], got {tuple(a.shape)}")
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {n} outside 1..{MAX_STATE}")
    for name, t in (("b", bmat), ("c", cmat)):
        if tuple(t.shape) != (n_batch, seq, n):
            raise ValueError(f"selective_scan: {name} must be [{n_batch}, {seq}, {n}], "
                             f"got {tuple(t.shape)}")
    if tuple(h0.shape) != (n_batch, ch, n):
        raise ValueError(f"selective_scan: h0 must be [{n_batch}, {ch}, {n}], "
                         f"got {tuple(h0.shape)}")
    for name, t in (("dt", dt), ("x", x), ("b", bmat), ("c", cmat), ("a", a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {name} must be float32, got {t.dtype}")
        if t.device != dt.device:
            raise ValueError(f"selective_scan: {name} is on {t.device}, dt on {dt.device}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")


def selective_scan(
    dt: torch.Tensor,    # [B, S, E] step sizes
    x: torch.Tensor,     # [B, S, E] inputs
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    a: torch.Tensor,     # [E, N]
    h0: torch.Tensor,    # [B, E, N] initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ys [B, S, E], hT [B, E, N])``, all float32. The checks of shape,
    dtype, device and contiguity hold on every device; a CUDA launch is on
    the current stream, without synchronizing."""
    args = (dt, x, bmat, cmat, a, h0)
    key = tuple((t.shape, t.dtype, t.device, t.is_contiguous()) for t in args)
    if key not in _CHECKED:
        _check(*args)
        _CHECKED.add(key)
    if not dt.is_cuda:
        if dt.device.type == "cpu":
            return selective_scan_ref(*args)
        raise ValueError(f"selective_scan: unsupported device {dt.device}")
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_selective_scan
    n_batch, seq, ch = dt.shape
    ys = torch.empty_like(dt)
    ht = torch.empty_like(h0)
    err = _ENTRY(dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
                 h0.data_ptr(), ys.data_ptr(), ht.data_ptr(), n_batch, seq, ch, a.shape[1],
                 raw_stream(dt.device))
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return ys, ht
