"""Virtual device address space + buffer pool (PyTorch port of
``repro/core/buffers.py``).

The paper's dependency checks operate on *virtual addresses* resolved just
before kernel launch (§IV-A). Tensors from PyTorch's caching allocator do
not keep stable addresses across the functional updates the executors
make, so the runtime keeps its own virtual address space: every logical
buffer is assigned a contiguous address range at allocation time, and
kernel wrappers resolve (buffer, offset, size) references into absolute
``Segment``s — the role of ``get_addresses`` in Fig 17.

Sub-buffer views (one body's state slice, one force row) map to
sub-intervals of the parent buffer's range, so partial-overlap dependencies
behave like real address-range checks, including aliasing.

Values are ``torch.Tensor``s on the pool's device. Writes through a row
view are functional (clone, then assign the slice): a tensor a reader
already holds never changes under it, the guarantee the reference gets from
immutable jax arrays.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .segments import Segment

__all__ = ["Buffer", "BufferView", "BufferPool", "resolve_device", "to_numpy_dtype"]

_ALIGN = 256  # bytes; mirrors typical device allocator alignment.

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device on a host without
    one is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch defaults to device='cuda' but torch.cuda.is_available() "
            "is False on this host; pass device='cpu' to run on the CPU")
    return dev


def to_numpy_dtype(dtype: Any) -> np.dtype:
    """Normalise a torch or numpy dtype to ``np.dtype`` (``torch.float32``
    -> ``np.dtype('float32')``), so task signatures compare equal to the
    reference's."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def _as_tensor(value: Any, device: torch.device) -> Any:
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to(device)
    # A copy: the caller's array must not alias the buffer's value.
    return torch.tensor(np.asarray(value), device=device)


@dataclasses.dataclass
class Buffer:
    """A logical device allocation with a virtual address range."""

    name: str
    base: int
    nbytes: int
    shape: Tuple[int, ...]
    dtype: Any
    # The buffer's current value (a torch tensor). The ACS executors
    # functionally update this as tasks retire.
    value: Any = None

    @property
    def segment(self) -> Segment:
        return Segment(self.base, self.nbytes)

    def view(self, offset_bytes: int, nbytes: int) -> "BufferView":
        if offset_bytes < 0 or offset_bytes + nbytes > self.nbytes:
            raise ValueError(
                f"view [{offset_bytes}, {offset_bytes + nbytes}) out of bounds "
                f"for buffer {self.name!r} of {self.nbytes} bytes"
            )
        return BufferView(self, offset_bytes, nbytes)

    def row_view(self, row_start: int, row_count: int) -> "BufferView":
        """View of contiguous leading-axis rows — the common case
        (a request's KV rows, a token group's slice, a body's state)."""
        if not self.shape:
            raise ValueError("row_view requires a shaped buffer")
        row_bytes = self.nbytes // self.shape[0]
        v = self.view(row_start * row_bytes, row_count * row_bytes)
        return BufferView(self, v.offset, v.nbytes, row_start, row_count)

    def get_value(self):
        return self.value

    def set_value(self, new) -> None:
        self.value = new


@dataclasses.dataclass(frozen=True)
class BufferView:
    """A (buffer, offset, size) reference — resolvable to a Segment.

    ``row_start``/``row_count`` are set when the view is a contiguous
    leading-axis row slice; executors use them to slice / scatter values.
    """

    buffer: Buffer
    offset: int
    nbytes: int
    row_start: Optional[int] = None
    row_count: Optional[int] = None

    @property
    def segment(self) -> Segment:
        return Segment(self.buffer.base + self.offset, self.nbytes)

    @property
    def name(self) -> str:
        return f"{self.buffer.name}[{self.offset}:{self.offset + self.nbytes}]"

    def get_value(self):
        if self.row_start is not None:
            return self.buffer.value[self.row_start : self.row_start + self.row_count]
        raise ValueError("only row views carry values; use the parent buffer")

    def set_value(self, new) -> None:
        if self.row_start is None:
            raise ValueError("only row views support value writeback")
        # Functional: a reader may hold the old tensor (or a view of it)
        # while this write lands, so never assign into it.
        out = self.buffer.value.clone()
        out[self.row_start : self.row_start + self.row_count] = new
        self.buffer.value = out


class BufferPool:
    """Bump allocator over the virtual address space (thread-safe).

    Addresses are never recycled during a stream's lifetime: the paper's
    window only ever holds a handful of live kernels, and monotonically
    increasing addresses make WAR/WAW detection exact without a free-list.

    ``device`` is where values passed to ``alloc`` are placed.
    """

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self._next = _ALIGN  # keep 0 unused; eases debugging.
        self._buffers: Dict[str, Buffer] = {}
        self._lock = threading.Lock()
        self._anon = 0
        self._free_hooks: List[Callable[[Buffer], None]] = []

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray],
                   device: DeviceLike = "cuda") -> "BufferPool":
        """A pool holding one buffer per ``arrays`` entry, with the same
        names, shapes and dtypes, allocated in the dict's order — the way
        to start the port from a reference pool's state
        (``{b.name: np.asarray(b.value) for b in pool.buffers()}``)."""
        pool = cls(device)
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            pool.alloc(arr.shape, arr.dtype, name=name, value=arr)
        return pool

    def add_free_hook(self, cb: Callable[[Buffer], None]) -> None:
        """Subscribe to buffer release: ``cb(buf)`` fires after ``free``
        drops the pool's reference, so downstream residency tracking (the
        device arena's row free-list) learns a buffer's lifetime ended."""
        with self._lock:
            self._free_hooks.append(cb)

    def alloc(
        self,
        shape: Tuple[int, ...],
        dtype: Any = np.float32,
        name: Optional[str] = None,
        value: Any = None,
    ) -> Buffer:
        dtype = to_numpy_dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize if shape else dtype.itemsize
        nbytes = max(nbytes, 1)
        value = _as_tensor(value, self.device)
        with self._lock:
            if name is None:
                name = f"buf{self._anon}"
                self._anon += 1
            if name in self._buffers:
                raise KeyError(f"buffer {name!r} already allocated")
            base = self._next
            padded = (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
            self._next = base + padded
            buf = Buffer(name=name, base=base, nbytes=nbytes, shape=tuple(shape),
                         dtype=dtype, value=value)
            self._buffers[name] = buf
            return buf

    def free(self, name: str) -> None:
        """Release a named buffer: the pool drops its reference and the
        name becomes reusable. Virtual addresses are NOT recycled, so past
        segment checks stay exact. Free hooks fire after the reference
        drops (outside the pool lock — hooks may take their own locks)."""
        with self._lock:
            if name not in self._buffers:
                raise KeyError(f"buffer {name!r} not allocated")
            buf = self._buffers.pop(name)
            hooks = tuple(self._free_hooks)
        for cb in hooks:
            cb(buf)

    def from_array(self, arr: Any, name: Optional[str] = None) -> Buffer:
        return self.alloc(tuple(arr.shape), to_numpy_dtype(arr.dtype), name=name, value=arr)

    def buffers(self) -> Tuple[Buffer, ...]:
        """All live allocations, in allocation order."""
        with self._lock:
            return tuple(self._buffers.values())

    def __getitem__(self, name: str) -> Buffer:
        return self._buffers[name]

    def __contains__(self, name: str) -> bool:
        return name in self._buffers

    def __len__(self) -> int:
        return len(self._buffers)
