"""Shape-class slab arena — the device-resident buffer image (PyTorch port
of ``repro/core/arena.py``).

The device window (`core/device_dispatch.py`) needs every operand a lowered
epoch touches in a device-resident slab that dispatch tables index with
plain integers:

* Operands are grouped into **shape classes** ``(padded_shape, dtype)``;
  the padded shape rounds the trailing dimension up to ``pad_multiple``.
  Two buffers whose shapes pad to the same tuple share a class; the
  per-operand true shape is static in the lowered program, so gathers slice
  the padding back off before compute.
* Each class owns one **slab** ``[rows, *padded_shape]``; every ``Buffer``
  is assigned one row, and a row-``BufferView`` resolves to a leading-axis
  sub-interval of its parent's row, so view aliasing behaves exactly like
  the virtual-address-range checks in `core/buffers.py`.
* Padding is accounted: ``padding_waste()`` reports, per class, the row
  count and the fraction of slab cells occupied by padding.
* ``free(buf)`` releases a row into its class's free-list and ``add``
  recycles free rows before growing the slab.

Slabs are torch tensors on the caller's device. The persistent-session
half of the reference (``pack_incremental``, ``update_rows``, compaction)
and ``ShardTransferTable`` come with the ``DeviceSession`` and mesh slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .buffers import Buffer, BufferView, DeviceLike, resolve_device
from .task import Operand, Task, operand_base

__all__ = ["ShapeClass", "ArenaAddress", "SlabArena", "pad_shape", "row_capacity",
           "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """``"float32"`` -> ``torch.float32`` (class dtypes are numpy names)."""
    return getattr(torch, np.dtype(name).name)


def row_capacity(n_rows: int) -> int:
    """Physical slab rows for ``n_rows`` logical rows: the next power of
    two (floored at 8), as in the reference, so slab shapes (and hence the
    lowered tables' addressing) agree between the two packages. Rows past
    the logical count hold zeros and are never addressed."""
    cap = 8
    while cap < n_rows:
        cap *= 2
    return cap


def pad_shape(shape: Tuple[int, ...], pad_multiple: int) -> Tuple[int, ...]:
    """Round the trailing dimension up to ``pad_multiple`` (scalars pass
    through)."""
    if not shape or pad_multiple <= 1:
        return tuple(shape)
    last = -(-shape[-1] // pad_multiple) * pad_multiple
    return tuple(shape[:-1]) + (last,)


def pad_to(val: torch.Tensor, target_shape: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad ``val`` at the end of each axis up to ``target_shape``."""
    if tuple(val.shape) == tuple(target_shape):
        return val
    pads: List[int] = []
    for s, p in zip(reversed(val.shape), reversed(target_shape)):
        pads += [0, p - s]
    return F.pad(val, pads)


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """One slab's identity: the padded shape every resident row shares."""

    padded_shape: Tuple[int, ...]
    dtype: str

    @property
    def row_elems(self) -> int:
        return int(np.prod(self.padded_shape, dtype=np.int64)) if self.padded_shape else 1

    @property
    def label(self) -> str:
        return f"{self.dtype}{list(self.padded_shape)}"


@dataclasses.dataclass(frozen=True)
class ArenaAddress:
    """Where one operand lives: ``slabs[class_id][row]``, optionally a
    leading-axis sub-interval ``[row_start : row_start + row_count]`` when
    the operand is a row view of its parent buffer."""

    class_id: int
    row: int
    row_start: int = 0
    row_count: int = 0  # 0 => the whole row (a full Buffer operand)

    @property
    def is_view(self) -> bool:
        return self.row_count > 0


class SlabArena:
    """Assigns buffers to (class, row) slab coordinates and moves values
    into and out of the slabs around a lowered epoch's single dispatch."""

    def __init__(self, pad_multiple: int = 8):
        self.pad_multiple = pad_multiple
        self._class_ids: Dict[ShapeClass, int] = {}
        self._classes: List[ShapeClass] = []
        # per class, row -> Buffer (None = freed row awaiting reuse)
        self._rows: List[List[Optional[Buffer]]] = []
        # id(Buffer) -> (class, row); _rows holds the references.
        self._addr: Dict[int, Tuple[int, int]] = {}
        # Per-class LIFO free-lists of recyclable row indices.
        self._free: List[List[int]] = []
        self.freed_rows = 0
        self.recycled_rows = 0
        self.unpack_rows_written = 0

    # -- classification ----------------------------------------------------
    def class_of(self, buf: Buffer) -> ShapeClass:
        return ShapeClass(
            padded_shape=pad_shape(tuple(buf.shape), self.pad_multiple),
            dtype=str(np.dtype(buf.dtype)),
        )

    def add(self, buf: Buffer) -> Tuple[int, int]:
        """Assign ``buf`` a (class_id, row); idempotent per buffer object."""
        key = id(buf)
        if key in self._addr:
            return self._addr[key]
        cls = self.class_of(buf)
        cid = self._class_ids.get(cls)
        if cid is None:
            cid = len(self._classes)
            self._class_ids[cls] = cid
            self._classes.append(cls)
            self._rows.append([])
            self._free.append([])
        if self._free[cid]:
            row = self._free[cid].pop()
            self._rows[cid][row] = buf
            self.recycled_rows += 1
        else:
            row = len(self._rows[cid])
            self._rows[cid].append(buf)
        self._addr[key] = (cid, row)
        return cid, row

    def free(self, buf: Buffer) -> bool:
        """Release ``buf``'s row into its class free-list for recycling.
        Returns False (no-op) when the buffer is not arena-resident."""
        addr = self._addr.pop(id(buf), None)
        if addr is None:
            return False
        cid, row = addr
        self._rows[cid][row] = None
        self._free[cid].append(row)
        self.freed_rows += 1
        return True

    def add_tasks(self, tasks: Iterable[Task]) -> None:
        for t in tasks:
            for op in tuple(t.inputs) + tuple(t.outputs):
                self.add(operand_base(op))

    def address(self, op: Operand) -> ArenaAddress:
        """Resolve an operand to its arena coordinates (adding the parent
        buffer if unseen)."""
        if isinstance(op, BufferView):
            if op.row_start is None:
                raise ValueError(
                    f"arena operands must be Buffers or row views; {op.name!r} "
                    "is a raw byte view (no row_start)"
                )
            cid, row = self.add(op.buffer)
            return ArenaAddress(cid, row, op.row_start, op.row_count)
        cid, row = self.add(op)
        return ArenaAddress(cid, row)

    # -- introspection -----------------------------------------------------
    def __contains__(self, buf: Buffer) -> bool:
        return id(buf) in self._addr

    def addr_of(self, buf: Buffer) -> Optional[Tuple[int, int]]:
        """``(class_id, row)`` for a resident buffer, ``None`` otherwise."""
        return self._addr.get(id(buf))

    @property
    def classes(self) -> List[ShapeClass]:
        return list(self._classes)

    def n_classes(self) -> int:
        return len(self._classes)

    def rows(self, class_id: int) -> List[Optional[Buffer]]:
        return list(self._rows[class_id])

    def device_address_table(self, operands: Sequence[Operand]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve operands to dense per-slot address arrays ``(rows,
        starts)``, both ``[len(operands)] int32``: each operand's slab row,
        and the leading-axis offset for row views (0 for full buffers)."""
        rows = np.zeros(len(operands), np.int32)
        starts = np.zeros(len(operands), np.int32)
        for i, op in enumerate(operands):
            addr = self.address(op)
            rows[i] = addr.row
            starts[i] = addr.row_start
        return rows, starts

    def live_rows(self, class_id: Optional[int] = None) -> int:
        if class_id is not None:
            return len(self._rows[class_id]) - len(self._free[class_id])
        return sum(len(r) for r in self._rows) - sum(len(f) for f in self._free)

    def slab_bytes(self) -> int:
        """Device footprint of the slabs a pack materializes."""
        total = 0
        for cid, cls in enumerate(self._classes):
            total += len(self._rows[cid]) * cls.row_elems * np.dtype(cls.dtype).itemsize
        return total

    def padding_waste(self) -> Dict[str, Dict[str, Any]]:
        """Per-class occupancy: how many slab cells hold real values vs
        trailing-dimension padding and dead (freed) rows."""
        out: Dict[str, Dict[str, Any]] = {}
        for cid, cls in enumerate(self._classes):
            bufs = self._rows[cid]
            padded = cls.row_elems
            used = sum(
                int(np.prod(b.shape, dtype=np.int64)) if b.shape else 1
                for b in bufs if b is not None
            )
            total = padded * len(bufs)
            out[cls.label] = {
                "rows": len(bufs),
                "dead_rows": len(self._free[cid]),
                "padded_elems_per_row": padded,
                "used_elems": used,
                "waste_frac": round(1.0 - used / total, 4) if total else 0.0,
            }
        return out

    def total_waste_frac(self) -> float:
        padded = used = 0
        for cid, cls in enumerate(self._classes):
            padded += cls.row_elems * len(self._rows[cid])
            used += sum(
                int(np.prod(b.shape, dtype=np.int64)) if b.shape else 1
                for b in self._rows[cid] if b is not None
            )
        return 1.0 - used / padded if padded else 0.0

    # -- host <-> device movement ------------------------------------------
    def _row_value(self, buf: Optional[Buffer], cls: ShapeClass,
                   device: torch.device) -> torch.Tensor:
        dtype = torch_dtype(cls.dtype)
        if buf is None or buf.value is None:
            # Dead row, or a not-yet-produced output: program order
            # guarantees the producing task writes before any consumer reads.
            return torch.zeros(cls.padded_shape, dtype=dtype, device=device)
        val = torch.as_tensor(buf.value).to(device=device, dtype=dtype)
        if tuple(val.shape) != tuple(buf.shape):
            raise ValueError(
                f"buffer {buf.name!r} declares shape {tuple(buf.shape)} but "
                f"holds a value of shape {tuple(val.shape)}"
            )
        return pad_to(val, cls.padded_shape)

    def pack(self, device: DeviceLike = "cuda") -> List[torch.Tensor]:
        """One tensor per class on ``device``: ``[capacity, *padded_shape]``
        with the live rows first and zero rows up to ``row_capacity``."""
        device = resolve_device(device)
        slabs = []
        for cid, cls in enumerate(self._classes):
            rows = [self._row_value(b, cls, device) for b in self._rows[cid]]
            cap = row_capacity(len(rows))
            slab = torch.zeros((cap,) + cls.padded_shape,
                               dtype=torch_dtype(cls.dtype), device=device)
            slab[: len(rows)] = torch.stack(rows)
            slabs.append(slab)
        return slabs

    def unpack(self, slabs: Sequence[torch.Tensor],
               only: Optional[Iterable[Buffer]] = None) -> None:
        """Write slab rows back into buffer values, slicing padding off.

        ``only`` restricts writeback to the given buffers (e.g. the ones
        some task actually wrote); default writes every live resident row.
        Buffers already released are skipped.
        """
        if only is not None:
            for buf in only:
                addr = self._addr.get(id(buf))
                if addr is None:
                    continue
                cid, row = addr
                self._write_back(buf, slabs[cid], row, self._classes[cid])
            return
        for cid, cls in enumerate(self._classes):
            for row, buf in enumerate(self._rows[cid]):
                if buf is not None:
                    self._write_back(buf, slabs[cid], row, cls)

    def _write_back(self, buf: Buffer, slab: torch.Tensor, row: int,
                    cls: ShapeClass) -> None:
        val = slab[row]
        if tuple(buf.shape) != cls.padded_shape:
            # Contiguous, like every value a task writes, so later kernels
            # see the same memory layout whichever executor produced it.
            val = val[tuple(slice(0, s) for s in buf.shape)].contiguous()
        buf.value = val
        self.unpack_rows_written += 1
