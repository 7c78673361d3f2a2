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

Training and the mesh: the scan and its reverse scan are ``torch.library``
ops, ``repro_torch::lru_scan`` and ``::lru_scan_bwd``, the first
differentiable through the second (``register_autograd``, which saves
``a``, the output ``h`` and ``h0``). The reverse scan is the entry
``acs_lru_scan_bwd`` of the same ``csrc/lru_scan.cu`` (``da``, ``db``,
``dh0``; bit-equal to :func:`~.ref.lru_scan_bwd_ref` on the card, counted
on ``backward_launches``). Each op has the plain version on the CPU, the
kernel on CUDA (no fallback), a fake implementation (shapes and dtypes: no
build, no launch) for FakeTensorMode, a FLOP formula for the flop counter
and a DTensor sharding rule: each rank scans its own batch rows or its own
channels (over one mesh axis or several).

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
    """The kernel on CUDA tensors, on the current stream, no sync."""
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


def _backward(a, h, h0, dh):
    """The reverse scan on CUDA tensors: ``(da, db, dh0)``, on the current
    stream, no sync."""
    _check(a, h, h0)
    dh = dh.to(h.dtype).contiguous()
    if dh.shape != h.shape or dh.device != a.device:
        raise ValueError(f"lru_scan_bwd: dh {tuple(dh.shape)} on {dh.device} does not match "
                         f"h {tuple(h.shape)} on {a.device}")
    n_batch, seq, dim = a.shape
    da, db, dh0 = torch.empty_like(a), torch.empty_like(h), torch.empty_like(h0)
    global backward_launches
    err = _LIB.get().acs_lru_scan_bwd(
        a.data_ptr(), h.data_ptr(), h0.data_ptr(), dh.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), n_batch, seq, dim, _DTYPES[a.dtype], _DTYPES[h0.dtype],
        raw_stream(a.device))
    if err != 0:
        raise RuntimeError(f"lru_scan backward launch failed: CUDA error {err}")
    backward_launches += 1
    return da, db, dh0


# ---------------------------------------------------------------------------
# The torch.library ops: repro_torch::lru_scan (serving and training alike;
# its autograd runs ::lru_scan_bwd) and ::lru_scan_bwd.
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::lru_scan", mutates_args=(), device_types="cpu")
def _scan_op(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    return lru_scan_ref(a, b, h0)


@_scan_op.register_kernel("cuda")
def _scan_cuda(a, b, h0):
    return _forward(a, b, h0)


@_scan_op.register_fake
def _scan_fake(a, b, h0):
    return b.new_empty(b.shape)


@torch.library.custom_op("repro_torch::lru_scan_bwd", mutates_args=(), device_types="cpu")
def _scan_bwd_op(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor, dh: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return lru_scan_bwd_ref(a, h, h0, dh)


@_scan_bwd_op.register_kernel("cuda")
def _scan_bwd_cuda(a, h, h0, dh):
    return _backward(a, h, h0, dh)


@_scan_bwd_op.register_fake
def _scan_bwd_fake(a, h, h0, dh):
    return a.new_empty(a.shape), h.new_empty(h.shape), h0.new_empty(h0.shape)


def _scan_setup(ctx, inputs, output):
    a, _, h0 = inputs
    ctx.save_for_backward(a, output, h0)


def _scan_backward(ctx, dh):
    a, h, h0 = ctx.saved_tensors
    da, db, dh0 = torch.ops.repro_torch.lru_scan_bwd.default(a, h, h0, dh)
    return da, db, (dh0 if ctx.needs_input_grad[2] else None)


_scan_op.register_autograd(_scan_backward, setup_context=_scan_setup)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    def forward(a_shape, *_, out_shape=None, **__):
        # h_t = a_t * h_{t-1} + b_t: a multiply and an add an element
        n_batch, seq, dim = a_shape
        return 2 * n_batch * seq * dim

    def backward(a_shape, *_, out_shape=None, **__):
        # the carry g_t = dh_t + a_{t+1} g_{t+1}, a multiply and an add at
        # every step but the last; da_t = g_t h_{t-1}, a multiply at every
        # step; dh0 = a_0 g_0, a multiply: 3 B S D - B D
        n_batch, seq, dim = a_shape
        return (3 * seq - 1) * n_batch * dim

    register_flop_formula(torch.ops.repro_torch.lru_scan)(forward)
    register_flop_formula(torch.ops.repro_torch.lru_scan_bwd)(backward)


_register_flop_formulas()


def _register_sharding() -> None:
    """DTensor rules, one mesh axis at a time: every tensor replicated; the
    batch sharded (dim 0 of each); or the channels sharded (dim 2 of the
    ``[B, S, D]`` tensors, dim 1 of ``h0`` and ``dh0``). Channels sharded
    on several axes (the batch unshardable: ``long_500k``) are this rule
    on each."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    rep, batch = Replicate(), Shard(0)
    chan, chan_h = Shard(2), Shard(1)

    @register_sharding(torch.ops.repro_torch.lru_scan.default)
    def _forward_rule(a, b, h0):
        return [([rep], [rep] * 3), ([batch], [batch] * 3), ([chan], [chan, chan, chan_h])]

    @register_sharding(torch.ops.repro_torch.lru_scan_bwd.default)
    def _backward_rule(a, h, h0, dh):
        return [([rep] * 3, [rep] * 4), ([batch] * 3, [batch] * 4),
                ([chan, chan, chan_h], [chan, chan, chan_h, chan])]


_register_sharding()


def lru_scan_bwd(a, h, h0, dh, *, need_dh0=True):
    """The reverse scan: ``(da, db, dh0)`` in the dtypes of ``a``, ``h``
    and ``h0`` from the forward's ``a``, output ``h`` and ``h0`` and the
    output's gradient ``dh`` (``dh0`` None unless ``need_dh0``). The plain
    version on the CPU; on CUDA tensors the kernel, on the current stream,
    no sync."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lru_scan_bwd: unsupported device {a.device}")
    da, db, dh0 = torch.ops.repro_torch.lru_scan_bwd.default(a, h, h0, dh)
    return da, db, dh0 if need_dh0 else None


def lru_scan(
    a: torch.Tensor,   # [B, S, D] decay
    b: torch.Tensor,   # [B, S, D] input
    h0: torch.Tensor,  # [B, D] initial state
) -> torch.Tensor:
    """``h [B, S, D]`` in ``b``'s dtype, the carry in float32. Launches on
    the current CUDA stream without synchronizing. Differentiable on both
    devices (the op's autograd)."""
    return torch.ops.repro_torch.lru_scan.default(a, b, h0)
