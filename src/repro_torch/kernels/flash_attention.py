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

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. The kernel builds at first use (``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from ._nvcc import NVCC_FLAGS, CudaLibrary, raw_stream
from .ref import attention_ref

__all__ = ["flash_attention", "build", "launches", "reset_launches", "SOURCE", "MAX_HEAD_DIM",
           "kernel_takes"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# The head widths the kernel is instantiated for, written only here: the
# build passes them to csrc/flash_attention.cu as -D defines (kMaxD, kMlaD,
# kMlaDv there). Dv == D up to MAX_HEAD_DIM; for Dv != D, D up to
# MAX_QK_DIM_SPLIT with Dv up to MAX_V_DIM_SPLIT (MLA's 192 and 128).
MAX_HEAD_DIM = 256
MAX_QK_DIM_SPLIT, MAX_V_DIM_SPLIT = 192, 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The attention kernel is held to its plain version within a tolerance, not
# bit for bit, so it may contract multiply-adds.
_FLAGS = (*(f for f in NVCC_FLAGS if f != "-fmad=false"),
          f"-DACS_FLASH_MAX_D={MAX_HEAD_DIM}", f"-DACS_FLASH_SPLIT_D={MAX_QK_DIM_SPLIT}",
          f"-DACS_FLASH_SPLIT_DV={MAX_V_DIM_SPLIT}")

# Kernel launches since the last reset_launches(): incremented once per
# launch of the CUDA kernel, never by the plain version.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.acs_flash_attention.argtypes = [
        ptr, ptr, ptr, ptr,            # q, k, v, o
        i32, i32, i32, i32, i32, i32,  # B, H, Hkv, Sq, Sk, D
        i32,                           # Dv
        i32, f32, i32,                 # dtype, scale, causal
        i32, i32, i32, f32,            # has_window, window, has_softcap, softcap
        i32, i32,                      # q_offset, prefix_len
        ptr,                           # stream
    ]
    lib.acs_flash_attention.restype = i32


_LIB = CudaLibrary(SOURCE, _bind, _FLAGS)
_ENTRY = None  # the bound C entry point, looked up at the first launch


def build() -> Tuple[Path, float]:
    """Compile ``csrc/flash_attention.cu`` for ``sm_90a`` (once per source
    and flag set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


def kernel_takes(dim: int, dv: int) -> bool:
    """Whether the kernel has an instantiation for q and k of width
    ``dim`` and v of width ``dv``."""
    if dv == dim:
        return 1 <= dim <= MAX_HEAD_DIM
    return 1 <= dim <= MAX_QK_DIM_SPLIT and 1 <= dv <= MAX_V_DIM_SPLIT


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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q [B, H, Sq, D], k [B, Hkv, Sk, D] and "
                         f"v [B, Hkv, Sk, Dv] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    n_batch, n_heads, sq, dim = q.shape
    _, n_kv, sk, _ = k.shape
    dv = v.shape[3]
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
    scale = float(scale if scale is not None else 1.0 / dim ** 0.5)
    out = torch.empty((n_batch, n_heads, sq, dv), dtype=q.dtype, device=q.device)
    global _ENTRY, launches
    if _ENTRY is None:
        _ENTRY = _LIB.get().acs_flash_attention
    err = _ENTRY(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        n_batch, n_heads, n_kv, sq, sk, dim, dv, _DTYPES[q.dtype], scale, int(causal),
        int(window is not None), int(window or 0),
        int(softcap is not None), float(softcap or 0.0),
        int(q_offset), int(prefix_len),
        raw_stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
