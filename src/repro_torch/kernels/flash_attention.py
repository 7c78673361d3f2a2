"""Blocked online-softmax attention (flash attention) on the H100 (port of
``repro/kernels/flash_attention.py``).

Serves every attention prefill of the models (``models/attention.py``
through ``ops.attention``): GQA, a causal mask at a global ``q_offset``
(decode: Sq = 1 against a cache), a sliding ``window``, ``prefix_len``
keys visible to every query, a gemma2-style ``softcap``, a ragged Sk, and
values of another width than the keys (MLA: q and k at D = 192, v at
Dv = 128). The kernel takes Dv == D up to 256, or D up to 192 with Dv up to
128; the wrapper refuses any other pair on every device.
The kernel is the hand-written CUDA in ``csrc/flash_attention.cu`` (its
header says what bounds it and how it is laid out): for bfloat16 and
float16 both products on the tensor cores (``mma.sync``) with keys and
values streamed through a 2-stage ``cp.async`` ring, P rounded to the
input dtype before the PV product as FlashAttention-2 does; float32 (the
tolerance tests) on scalar FMAs. It computes what the
plain version :func:`~.ref.attention_ref` computes, fully masked rows
included (they give 0, where the Pallas kernel gives the row's mean of
``v``).

Training: on CUDA tensors that need a gradient the call is a
``torch.autograd.Function`` whose forward is the same kernel, also writing
each row's log-sum-exp, and whose backward is the hand-written
``csrc/flash_attention_bwd.cu`` (dQ, dK, dV in two deterministic passes;
Dv == D up to ``MAX_BACKWARD_HEAD_DIM`` = 256, at D 256 each pass split
into two column slices; Dv != D, MLA's widths, raises under grad).
Without a gradient the call is the serving call, bit for bit. On the CPU
autograd differentiates the plain version.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernels build at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ._nvcc import NVCC_FLAGS, CudaLibrary, raw_stream
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_bwd", "build",
           "build_backward", "launches", "backward_launches", "reset_launches", "SOURCE",
           "BACKWARD_SOURCE", "MAX_HEAD_DIM", "MAX_BACKWARD_HEAD_DIM", "kernel_takes",
           "backward_takes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BACKWARD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
# The head widths the kernel is instantiated for, written only here: the
# build passes them to csrc/flash_attention.cu as -D defines (kMaxD, kMlaD,
# kMlaDv there). Dv == D up to MAX_HEAD_DIM; for Dv != D, D up to
# MAX_QK_DIM_SPLIT with Dv up to MAX_V_DIM_SPLIT (MLA's 192 and 128).
MAX_HEAD_DIM = 256
MAX_QK_DIM_SPLIT, MAX_V_DIM_SPLIT = 192, 128
# The backward (csrc/flash_attention_bwd.cu, kMaxD there): Dv == D up to this.
MAX_BACKWARD_HEAD_DIM = 256

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The attention kernel is held to its plain version within a tolerance, not
# bit for bit, so it may contract multiply-adds.
_FLAGS = (*(f for f in NVCC_FLAGS if f != "-fmad=false"),
          f"-DACS_FLASH_MAX_D={MAX_HEAD_DIM}", f"-DACS_FLASH_SPLIT_D={MAX_QK_DIM_SPLIT}",
          f"-DACS_FLASH_SPLIT_DV={MAX_V_DIM_SPLIT}")
_BACKWARD_FLAGS = (*(f for f in NVCC_FLAGS if f != "-fmad=false"),
                   f"-DACS_FLASH_BWD_MAX_D={MAX_BACKWARD_HEAD_DIM}")

# Kernel launches since the last reset_launches(): incremented once per
# launch of the forward kernel, and once per call of the backward's entry
# (its prologue and two passes), never by the plain version.
launches = 0
backward_launches = 0


def reset_launches() -> None:
    global launches, backward_launches
    launches = backward_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acs_flash_attention.argtypes = [
        ptr, ptr, ptr, ptr,            # q, k, v, o
        ptr,                           # lse or null
        i32, i32, i32, i32, i32, i32,  # B, H, Hkv, Sq, Sk, D
        i32,                           # Dv
        i32, f32, i32,                 # dtype, scale, causal
        i32, i32, i32, f32,            # has_window, window, has_softcap, softcap
        i32, i32,                      # q_offset, prefix_len
        ptr,                           # stream
    ]
    lib.acs_flash_attention.restype = i32


def _bind_backward(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acs_flash_attention_bwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,       # q, k, v, o, dout
        ptr, ptr,                      # lse, di scratch
        ptr, ptr, ptr,                 # dq, dk, dv
        i32, i32, i32, i32, i32, i32,  # B, H, Hkv, Sq, Sk, D
        i32, f32, i32,                 # dtype, scale, causal
        i32, i32, i32, f32,            # has_window, window, has_softcap, softcap
        i32, i32,                      # q_offset, prefix_len
        ptr,                           # stream
    ]
    lib.acs_flash_attention_bwd.restype = i32


_LIB = CudaLibrary(SOURCE, _bind, _FLAGS)
_BACKWARD_LIB = CudaLibrary(BACKWARD_SOURCE, _bind_backward, _BACKWARD_FLAGS)
_ENTRY = None  # the bound C entry points, looked up at the first launch
_BACKWARD_ENTRY = None


def build() -> Tuple[Path, float]:
    """Compile ``csrc/flash_attention.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def build_backward() -> Tuple[Path, float]:
    """Compile ``csrc/flash_attention_bwd.cu``, as :func:`build`."""
    return _BACKWARD_LIB.build()


def kernel_takes(dim: int, dv: int) -> bool:
    """Whether the kernel has an instantiation for q and k of width
    ``dim`` and v of width ``dv``."""
    if dv == dim:
        return 1 <= dim <= MAX_HEAD_DIM
    return 1 <= dim <= MAX_QK_DIM_SPLIT and 1 <= dv <= MAX_V_DIM_SPLIT


def backward_takes(dim: int, dv: int) -> bool:
    """Whether the backward has an instantiation for these widths."""
    return dv == dim and 1 <= dim <= MAX_BACKWARD_HEAD_DIM


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The CUDA path's checks of shape, dtype, device and contiguity."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q [B, H, Sq, D], k [B, Hkv, Sk, D] and "
                         f"v [B, Hkv, Sk, Dv] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    n_batch, n_heads, sq, dim = q.shape
    n_kv = k.shape[1]
    if k.shape[0] != n_batch or k.shape[3] != dim:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if n_kv < 1 or n_heads % n_kv:
        raise ValueError(f"flash_attention: {n_heads} query heads over {n_kv} kv heads")
    if n_batch * n_heads * sq == 0:
        raise ValueError(f"flash_attention: empty query {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{sorted(map(str, _DTYPES))}, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _check_cuda(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {q.device}")


def _masks(causal, window, softcap, q_offset, prefix_len) -> tuple:
    """The mask arguments of both C entries, after the dtype and scale."""
    return (int(causal), int(window is not None), int(window or 0), int(softcap is not None),
            float(softcap or 0.0), int(q_offset), int(prefix_len))


def _scale(scale: Optional[float], dim: int) -> float:
    return float(scale if scale is not None else 1.0 / dim ** 0.5)


def _forward(q, k, v, masks, scale, want_lse: bool):
    """Launch the forward kernel: ``(out, lse or None)``."""
    n_batch, n_heads, sq, dim = q.shape
    _, n_kv, sk, _ = k.shape
    dv = v.shape[3]
    out = torch.empty((n_batch, n_heads, sq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((n_batch, n_heads, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_flash_attention
    err = _ENTRY(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        n_batch, n_heads, n_kv, sq, sk, dim, dv, _DTYPES[q.dtype], scale, *masks,
        raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out, lse


def _backward(q, k, v, out, lse, dout, masks, scale):
    """Launch the backward's prologue and two passes: ``(dq, dk, dv)``."""
    n_batch, n_heads, sq, dim = q.shape
    _, n_kv, sk, _ = k.shape
    dout = dout.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((n_batch, n_heads, sq), dtype=torch.float32, device=q.device)
    global _BACKWARD_ENTRY, backward_launches
    if _BACKWARD_ENTRY is None:
        _BACKWARD_ENTRY = _BACKWARD_LIB.get().acs_flash_attention_bwd
    err = _BACKWARD_ENTRY(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        n_batch, n_heads, n_kv, sq, sk, dim, _DTYPES[q.dtype], scale, *masks,
        raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {err}")
    backward_launches += 1
    return dq, dk, dv


class _FlashFunction(torch.autograd.Function):
    """The forward kernel with its row log-sum-exp saved; the backward
    kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, masks, scale):
        out, lse = _forward(q, k, v, masks, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks, ctx.scale = masks, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, ctx.masks, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    prefix_len: int = 0,
) -> torch.Tensor:
    """Attention ``[B, H, Sq, Dv]`` in ``q``'s dtype, float32 inside, with
    the scale ``1 / sqrt(D)`` unless given. Launches on the current CUDA
    stream without synchronizing."""
    if q.dim() == 4 and v.dim() == 4 and not kernel_takes(q.shape[3], v.shape[3]):
        # on every device, so that a model the CPU runs is one the card runs
        raise ValueError(f"flash_attention: no kernel for head dims D {q.shape[3]}, "
                         f"Dv {v.shape[3]}: it takes Dv == D in 1..{MAX_HEAD_DIM}, or D in "
                         f"1..{MAX_QK_DIM_SPLIT} with Dv in 1..{MAX_V_DIM_SPLIT}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale, q_offset=q_offset, prefix_len=prefix_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    masks = _masks(causal, window, softcap, q_offset, prefix_len)
    scale = _scale(scale, q.shape[3])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if not backward_takes(q.shape[3], v.shape[3]):
            raise ValueError(f"flash_attention: no backward kernel for head dims D "
                             f"{q.shape[3]}, Dv {v.shape[3]}: it takes Dv == D in "
                             f"1..{MAX_BACKWARD_HEAD_DIM} (still to port: ROADMAP)")
        return _FlashFunction.apply(q, k, v, masks, scale)
    return _forward(q, k, v, masks, scale, False)[0]


def flash_attention_lse(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
                        q_offset=0, prefix_len=0):
    """The forward kernel with its row log-sum-exp: ``(out, lse [B, H, Sq]
    float32)``, -inf for a row that sees no key. CUDA tensors only; no
    autograd."""
    _check_cuda("flash_attention_lse", q)
    _check(q, k, v)
    return _forward(q, k, v, _masks(causal, window, softcap, q_offset, prefix_len),
                    _scale(scale, q.shape[3]), True)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=None, softcap=None,
                        scale=None, q_offset=0, prefix_len=0):
    """The backward kernel alone: ``(dq, dk, dv)`` in q's dtype from the
    forward's ``out`` and ``lse`` and the output's gradient ``dout``. CUDA
    tensors only (the plain version is ``ref.attention_bwd_ref``)."""
    _check_cuda("flash_attention_bwd", q)
    _check(q, k, v)
    if not backward_takes(q.shape[3], v.shape[3]):
        raise ValueError(f"flash_attention_bwd: no instantiation for D {q.shape[3]}, "
                         f"Dv {v.shape[3]}")
    return _backward(q, k, v, out.contiguous(), lse.contiguous(), dout,
                     _masks(causal, window, softcap, q_offset, prefix_len),
                     _scale(scale, q.shape[3]))
