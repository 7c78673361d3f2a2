"""The optimizer's global-norm clip and AdamW update as multi-tensor CUDA
passes over every leaf of a model (``csrc/adamw.cu``), beside their plain
per-leaf versions.

The reference has no kernel here: its optimizer (``repro/optim/adamw.py``)
is plain ``jnp``, which XLA fuses. Run as eager PyTorch leaf by leaf, the
clip made a float32 copy of every gradient and the update ran ~15 kernels a
leaf, each streaming the leaf through device memory again; the kernels read
and write each element once a pass, in a fixed number of launches whatever
the number of leaves:

* :func:`global_norm` — two launches: each block of a persistent grid sums
  its chunks' float32 squares in double into its own slot, then one block
  adds the slots in order and writes ``gnorm`` and the clip's ``scale``.
  No atomics, so the same bits every run; no host read.
* :func:`adamw_step` — one launch: reads the gradient in its dtype, the
  scale and the float32 master, m and v, and writes master, m, v and the
  parameter in its dtype, in place, rounding as the plain version does
  (bit-equal to it on the card at the same scale).

A launch reads a table of its leaves (pointers, sizes, dtypes, the first
16-byte-aligned element and each leaf's first chunk) that the wrapper
copies to the card from pinned memory each call, without a sync. The
update's rows for the parameters and the state are checked and built once
and kept while the same tensors hold the same storage; each call checks
and fills in only the gradients' columns.

Plain CUDA tensors (``torch.Tensor`` or ``nn.Parameter``, no other
subclass; contiguous, float32, bfloat16 or float16, on one device) take
the kernels; CPU tensors and DTensors take the plain versions
(:func:`global_norm_ref`, :func:`adamw_step_ref`: the per-leaf formulas,
which the CPU tests hold to the reference); anything else raises.
``launches`` and ``norm_launches`` count the kernels' launches; ``paths``
counts the leaves each update on a card took by path (``fused``: the
kernel; ``per_leaf``: DTensors, eager kernels leaf by leaf); the plain
version on the CPU counts nothing. The library builds at first use
(``_nvcc.py``).
"""

from __future__ import annotations

import ctypes
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._nvcc import CudaLibrary, raw_stream

__all__ = ["global_norm", "global_norm_ref", "adamw_step", "adamw_step_ref", "build",
           "launches", "norm_launches", "paths", "reset_launches", "SOURCE", "CHUNK"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PLAIN = (torch.Tensor, torch.nn.Parameter)  # the tensor types the kernels take
CHUNK = 32768          # elements a chunk (csrc/adamw.cu kChunk)
_FIELDS = 8            # int64 fields of a table row (csrc/adamw.cu struct Leaf)

# Kernel launches since the last reset_launches(): the update's, and the
# norm's (two a call); ``paths``: leaves updated on a card, by path.
launches = 0
norm_launches = 0
paths = {"fused": 0, "per_leaf": 0}


def reset_launches() -> None:
    global launches, norm_launches
    launches = norm_launches = 0
    for key in paths:
        paths[key] = 0


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.acs_adamw_norm_blocks.argtypes = []
    lib.acs_adamw_norm_blocks.restype = i32
    lib.acs_adamw_norm.argtypes = [ptr, i32, i64,  # leaves, n_leaves, n_chunks
                                   ptr, f32, ptr,  # partial, max_norm, out
                                   ptr]            # stream
    lib.acs_adamw_norm.restype = i32
    lib.acs_adamw_update.argtypes = [ptr, i32, i64,            # leaves, n_leaves, n_chunks
                                     ptr, ptr, ptr, ptr, f32,  # scale, c1, c2, lr_ptr, lr
                                     f32, f32, f32, f32,       # b1, 1 - b1, b2, 1 - b2
                                     f32, f32,                 # eps, wd
                                     ptr]                      # stream
    lib.acs_adamw_update.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)
_NORM_BLOCKS: Dict[int, int] = {}  # device index -> the norm's blocks (partial slots)


def build() -> Tuple[Path, float]:
    """Compile ``csrc/adamw.cu`` for ``sm_90a`` (once per source and flag
    set). Returns the library's path and the compile's seconds."""
    return _LIB.build()


# ---------------------------------------------------------------------------
# The plain versions: the port's per-leaf formulas, on any device
# ---------------------------------------------------------------------------

def global_norm_ref(grads: Sequence[torch.Tensor], max_norm: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gnorm, scale)``: the float32 norm over every leaf, summed leaf by
    leaf, and ``min(1, max_norm / (gnorm + 1e-9))``."""
    sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        sq = sq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(sq)
    return gnorm, torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def adamw_step_ref(params, grads, master, m, v, *, scale: Optional[torch.Tensor],
                   c1: torch.Tensor, c2: torch.Tensor, lr: torch.Tensor, b1: float,
                   b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step leaf by leaf, in place on ``params``, ``master``, ``m``
    and ``v`` (lists of leaves): each gradient in float32 times ``scale``
    (None: as it is), ``c1``, ``c2`` and ``lr`` 0-d float32 tensors."""
    for p, w, g, mm, vv in zip(params, master, grads, m, v):
        g = g.float() if scale is None else g.float() * scale
        mm.mul_(b1).add_((1 - b1) * g)
        vv.mul_(b2).add_((1 - b2) * g * g)
        update = (mm / c1).div_(torch.sqrt(vv / c2).add_(eps)).add_(weight_decay * w)
        w.sub_(lr * update)
        p.copy_(w)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _route(first: torch.Tensor, what: str) -> Optional[torch.device]:
    """The CUDA device of the kernels' path where the first leaf is a plain
    CUDA tensor (each leaf is checked as the table is built), or None where
    the plain version takes the leaves (a CPU tensor or a DTensor first);
    raises on anything else."""
    from torch.distributed.tensor import DTensor

    if type(first) in _PLAIN and first.device.type == "cuda":
        return first.device
    if first.device.type == "cpu" or isinstance(first, DTensor):
        return None
    raise ValueError(f"{what}: the kernels take plain tensors on one CUDA device and the plain "
                     f"version CPU tensors or DTensors, got a {type(first).__name__} on "
                     f"{first.device}")


def _head(ptrs: Sequence[int], sizes: Sequence[int], width: int) -> int:
    """The first element index at which every pointer (elements of its size
    in bytes) is aligned to ``width`` elements, or -1 where they never are
    at once: the elements a kernel runs one by one before its vectors."""
    heads = {((-ptr) % (width * size)) // size for ptr, size in zip(ptrs, sizes)}
    return heads.pop() if len(heads) == 1 else -1


def _fault(what: str, name: str, t: torch.Tensor, index: int, dtypes: Sequence[torch.dtype],
           shape: Optional[torch.Size] = None) -> Optional[Exception]:
    """The error for one of a leaf's tensors that the kernels do not take,
    or None: ``t`` (``name``: a gradient, a parameter, ``master``, ``m`` or
    ``v``) must be a plain tensor on device ``index``, of one of
    ``dtypes``, contiguous, and of ``shape`` where it is given."""
    if type(t) not in _PLAIN or t.get_device() != index:
        return ValueError(f"{what}: every leaf must be a plain tensor on one CUDA device "
                          f"(cuda:{index}), got a {type(t).__name__} on {t.device}")
    if t.dtype not in dtypes:
        return TypeError(f"{what}: {name} must be one of {sorted(map(str, dtypes))}, "
                         f"got {t.dtype}")
    if not t.is_contiguous():
        return ValueError(f"{what}: {name} must be contiguous")
    if shape is not None and t.shape != shape:
        return ValueError(f"{what}: a leaf of shape {tuple(shape)} with {name} of shape "
                          f"{tuple(t.shape)}")
    return None


_ANY = tuple(_DTYPES)
_F32 = (torch.float32,)
# Device index -> the last parameters and state the update met there: weak
# references to their tensors, their pointers, and what _state_rows returns.
_STATE_ROWS: Dict[int, Tuple[List[weakref.ref], Tuple[int, ...], Any]] = {}


def _state_rows(params, master, m, v, index: int):
    """The update's table without the gradients' columns, for the parameters
    and their state: ``(shapes, rows, heads, chunks)``, each leaf's shape,
    the rows of the leaves with elements (int64, ``_FIELDS`` a row), the
    first element at which the row's four pointers align to 4 elements (-1:
    never at once), and the chunks in all. Checked and built when first met
    on device ``index``, then kept while the same tensors hold the same
    storage: the parameters and the state are the job's, the gradients
    change every step."""
    tensors = [*params, *master, *m, *v]
    hit = _STATE_ROWS.get(index)
    if (hit is not None and len(hit[0]) == len(tensors)
            and all(ref() is t for ref, t in zip(hit[0], tensors))
            and tuple(map(torch.Tensor.data_ptr, tensors)) == hit[1]):
        return hit[2]
    shapes, rows, heads, chunks = [], [], [], 0
    for p, w, mm, vv in zip(params, master, m, v):
        shape = p.shape
        for name, t, dtypes in (("parameter", p, _ANY), ("master", w, _F32), ("m", mm, _F32),
                                ("v", vv, _F32)):
            err = _fault("adamw_step", name, t, index, dtypes, shape)
            if err is not None:
                raise err
        shapes.append(shape)
        n = p.numel()
        if n == 0:
            continue
        ptrs = (p.data_ptr(), w.data_ptr(), mm.data_ptr(), vv.data_ptr())
        rows.append((ptrs[0], 0, *ptrs[1:], n, _DTYPES[p.dtype], chunks))
        heads.append(_head(ptrs, (p.element_size(), 4, 4, 4), 4))  # 4-element vectors
        chunks += -(-n // CHUNK)
    entry = (shapes, np.array(rows, dtype=np.int64).reshape(-1, _FIELDS),
             np.array(heads, dtype=np.int64), chunks)
    _STATE_ROWS[index] = ([weakref.ref(t) for t in tensors],
                          tuple(map(torch.Tensor.data_ptr, tensors)), entry)
    return entry


def _with_grads(base: np.ndarray, heads: np.ndarray, ptrs: Sequence[int], sizes: Sequence[int],
                codes: Sequence[int]) -> np.ndarray:
    """The update's table: ``_state_rows``' rows and heads with each row's
    gradient pointer and dtype code filled in, and the first element at
    which all five pointers align to 4 elements (``_head``'s)."""
    table = base.copy()
    g_ptr, g_size = np.array(ptrs, dtype=np.int64), np.array(sizes, dtype=np.int64)
    head = np.where((-g_ptr) % (4 * g_size) // g_size == heads, heads, -1)
    table[:, 1] = g_ptr
    table[:, 6] |= (np.array(codes, dtype=np.int64) << 8) | ((head + 1) << 16)
    return table


def _upload(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """The table on the card: pinned on the host, copied without a sync."""
    return torch.from_numpy(table).pin_memory().to(device, non_blocking=True)


def _norm_blocks(lib, device: torch.device) -> int:
    blocks = _NORM_BLOCKS.get(device.index)
    if blocks is None:
        with torch.cuda.device(device):
            blocks = lib.acs_adamw_norm_blocks()
        if blocks <= 0:
            raise RuntimeError(f"global_norm: could not size the grid: CUDA error {-blocks}")
        _NORM_BLOCKS[device.index] = blocks
    return blocks


def global_norm(grads: Sequence[torch.Tensor], max_norm: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gnorm, scale)`` over the leaves ``grads``, 0-d float32 tensors on
    their device: the kernels on plain CUDA tensors (two launches, no host
    read), :func:`global_norm_ref` on CPU tensors and DTensors."""
    device = _route(grads[0], "global_norm")
    if device is None:
        return global_norm_ref(grads, max_norm)
    index = device.index
    rows, chunks = [], 0
    for g in grads:
        err = _fault("global_norm", "gradient", g, index, _ANY)
        if err is not None:
            raise err
        n = g.numel()
        if n == 0:
            continue
        ptr, size = g.data_ptr(), g.element_size()
        head = _head((ptr,), (size,), 16 // size)  # 16-byte loads
        rows.append((0, ptr, 0, 0, 0, n, (_DTYPES[g.dtype] << 8) | ((head + 1) << 16), chunks))
        chunks += -(-n // CHUNK)
    lib = _LIB.get()
    partial = torch.empty(_norm_blocks(lib, device), dtype=torch.float64, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    table = _upload(np.array(rows, dtype=np.int64).reshape(-1, _FIELDS), device)
    err = lib.acs_adamw_norm(table.data_ptr(), len(rows), chunks, partial.data_ptr(),
                             float(max_norm), out.data_ptr(), raw_stream(device))
    if err != 0:
        raise RuntimeError(f"global_norm kernel launch failed: CUDA error {err}")
    global norm_launches
    norm_launches += 2
    return out[0], out[1]


def adamw_step(params, grads, master, m, v, *, scale: Optional[torch.Tensor],
               c1: torch.Tensor, c2: torch.Tensor, lr: Any, b1: float, b2: float, eps: float,
               weight_decay: float) -> None:
    """One AdamW step in place over lists of leaves (see
    :func:`adamw_step_ref`); ``lr`` a float or a 0-d tensor. Plain CUDA
    tensors take one launch of the kernel, which reads ``scale``, ``c1``,
    ``c2`` and a tensor ``lr`` from device memory; CPU tensors and DTensors
    the plain version."""
    n_leaves = len(params)
    if not (len(grads) == len(master) == len(m) == len(v) == n_leaves):
        raise ValueError(f"adamw_step: {n_leaves} params, {len(grads)} gradients and "
                         f"{len(master)} / {len(m)} / {len(v)} state leaves")
    if n_leaves == 0:
        return
    device = _route(params[0], "adamw_step")
    if device is None:
        lr = torch.as_tensor(lr, dtype=torch.float32, device=c1.device)
        adamw_step_ref(params, grads, master, m, v, scale=scale, c1=c1, c2=c2, lr=lr, b1=b1,
                       b2=b2, eps=eps, weight_decay=weight_decay)
        if params[0].device.type == "cuda":  # DTensors on cards: eager kernels leaf by leaf
            paths["per_leaf"] += n_leaves
        return
    index = device.index
    shapes, base, heads, chunks = _state_rows(params, master, m, v, index)
    ptrs, sizes, codes = [], [], []
    for g, shape in zip(grads, shapes):
        err = _fault("adamw_step", "gradient", g, index, _ANY, shape)
        if err is not None:
            raise err
        if shape.numel():
            ptrs.append(g.data_ptr())
            sizes.append(g.element_size())
            codes.append(_DTYPES[g.dtype])
    for name, t in (("scale", scale), ("c1", c1), ("c2", c2)):
        if t is not None and (t.device != device or t.dtype != torch.float32 or t.numel() != 1):
            raise ValueError(f"adamw_step: {name} must be a float32 scalar on {device}")
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor) and lr.device == device:
        lr = lr.to(torch.float32)
        if lr.numel() != 1:
            raise ValueError(f"adamw_step: lr must be a scalar, got shape {tuple(lr.shape)}")
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)  # a Python number, or a CPU tensor: no device read
    table = _upload(_with_grads(base, heads, ptrs, sizes, codes), device)
    err = _LIB.get().acs_adamw_update(
        table.data_ptr(), len(base), chunks, None if scale is None else scale.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), lr_ptr, lr_value, b1, 1 - b1, b2, 1 - b2, eps,
        weight_decay, raw_stream(device))
    if err != 0:
        raise RuntimeError(f"adamw_step kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    paths["fused"] += n_leaves
