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
* The arena may be **persistent** (the ``DeviceSession`` rolling window):
  ``pack_incremental`` keeps the materialized slabs and appends only rows
  added since the last pack, refreshing recycled rows inside the packed
  watermark from host values; ``update_rows`` refreshes rows whose host
  values changed. When a class's dead-row fraction crosses
  ``compact_waste`` (``needs_compaction``), ``compact`` renumbers its live
  rows densely (a device-side gather of the slab) and bumps the class's
  **generation**, the signal a plan cache holding static row addresses
  invalidates on.

Slabs are torch tensors on the caller's device; a persistent session
updates its slabs in place, so ``unpack`` hands each buffer a copy of its
row, never a view, and ``export_row`` (the mesh's d2d edge) a copy too.
``ShardTransferTable`` is the mesh's ledger of rows moved between shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .buffers import Buffer, BufferView, DeviceLike, resolve_device
from .task import Operand, Task, operand_base

__all__ = ["ShapeClass", "ArenaAddress", "ShardTransferTable", "SlabArena", "pad_shape",
           "row_capacity", "torch_dtype"]


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


class ShardTransferTable:
    """Cross-shard row-transfer ledger for a mesh-sharded window.

    Each shard owns its own :class:`SlabArena`, a shard-local address
    space: ``(class_id, row)`` means something only against the owning
    shard's slabs, so a buffer consumed on another shard than the one that
    produced it has its row MOVED across at a sub-epoch boundary, either
    as a device-to-device copy of the slab row (``mode="d2d"``) or through
    the host (the owner syncs the row back, the destination refreshes it
    at its next dispatch; ``mode="staged"``). The table records every
    such move: source and destination shard, shape-class label, row bytes
    and mode.
    """

    def __init__(self) -> None:
        self.transfers = 0
        self.bytes = 0
        # (src_shard, dst_shard) -> count; class label -> count;
        # mode -> {transfers, bytes} (the d2d-vs-staged audit split).
        self.by_route: Dict[Tuple[int, int], int] = {}
        self.by_class: Dict[str, int] = {}
        self.by_mode: Dict[str, Dict[str, int]] = {}

    def record(self, src_shard: int, dst_shard: int, class_label: str,
               nbytes: int, mode: str = "staged") -> None:
        self.transfers += 1
        self.bytes += int(nbytes)
        route = (src_shard, dst_shard)
        self.by_route[route] = self.by_route.get(route, 0) + 1
        self.by_class[class_label] = self.by_class.get(class_label, 0) + 1
        slot = self.by_mode.setdefault(mode, {"transfers": 0, "bytes": 0})
        slot["transfers"] += 1
        slot["bytes"] += int(nbytes)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "transfers": self.transfers,
            "bytes": self.bytes,
            "by_route": {f"{s}->{d}": n for (s, d), n in sorted(self.by_route.items())},
            "by_class": dict(sorted(self.by_class.items())),
            "by_mode": {m: dict(v) for m, v in sorted(self.by_mode.items())},
        }


class SlabArena:
    """Assigns buffers to (class, row) slab coordinates and moves values
    into and out of the slabs around a lowered epoch's single dispatch."""

    def __init__(self, pad_multiple: int = 8, *, compact_waste: float = 0.5,
                 compact_min_rows: int = 8):
        self.pad_multiple = pad_multiple
        # Compaction policy: rebuild a class once it holds at least
        # compact_min_rows rows and its dead fraction reaches compact_waste.
        self.compact_waste = compact_waste
        self.compact_min_rows = compact_min_rows
        self._class_ids: Dict[ShapeClass, int] = {}
        self._classes: List[ShapeClass] = []
        # per class, row -> Buffer (None = freed row awaiting reuse)
        self._rows: List[List[Optional[Buffer]]] = []
        # id(Buffer) -> (class, row); _rows holds the references.
        self._addr: Dict[int, Tuple[int, int]] = {}
        # Per-class count of rows already materialized into device slabs
        # (the pack_incremental watermark).
        self._packed_rows: List[int] = []
        # Per-class LIFO free-lists of recyclable row indices.
        self._free: List[List[int]] = []
        # Per-class rows below the watermark re-assigned to a new buffer
        # since the last pack: the slab still holds the dead occupant's bits.
        self._reused: List[set] = []
        # Per-class compaction counters; `generation` is their sum.
        self._generation: List[int] = []
        self.generation = 0
        self.freed_rows = 0
        self.recycled_rows = 0
        self.compactions = 0
        self.unpack_rows_written = 0

    # -- classification ----------------------------------------------------
    def class_of(self, buf: Buffer) -> ShapeClass:
        return ShapeClass(
            padded_shape=pad_shape(tuple(buf.shape), self.pad_multiple),
            dtype=str(np.dtype(buf.dtype)),
        )

    def row_nbytes(self, buf: Buffer) -> int:
        """Padded slab-row bytes of this buffer's class."""
        cls = self.class_of(buf)
        return cls.row_elems * np.dtype(cls.dtype).itemsize

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
            self._packed_rows.append(0)
            self._free.append([])
            self._reused.append(set())
            self._generation.append(0)
        if self._free[cid]:
            row = self._free[cid].pop()
            self._rows[cid][row] = buf
            self.recycled_rows += 1
            if row < self._packed_rows[cid]:
                # The materialized row holds the previous occupant's value:
                # refresh it from host at the next incremental pack.
                self._reused[cid].add(row)
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
        self._reused[cid].discard(row)
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

    # -- row-granular transfer (the mesh's d2d edges) -------------------------
    def _row_addr(self, what: str, buf: Buffer,
                  expected_generation: Optional[int]) -> Tuple[int, int]:
        addr = self._addr.get(id(buf))
        if addr is None:
            raise KeyError(f"{what}: {buf.name!r} is not arena-resident")
        cid, row = addr
        if expected_generation is not None and self._generation[cid] != expected_generation:
            raise RuntimeError(
                f"{what}: class {cid} generation moved {expected_generation} -> "
                f"{self._generation[cid]} (compaction invalidated the captured row address)")
        return cid, row

    def export_row(self, slabs: Sequence[torch.Tensor], buf: Buffer, *,
                   expected_generation: Optional[int] = None) -> torch.Tensor:
        """A copy of the device row holding ``buf``'s padded value, the
        unit a ``ShardLink`` moves to another shard without a host hop. A
        copy, not a view: the owner's next epoch writes its slab in place.
        Raises if the buffer is not resident, its row was never packed or
        awaits a host refresh, or a compaction moved the class's rows
        since the caller captured ``expected_generation``."""
        cid, row = self._row_addr("export_row", buf, expected_generation)
        if row >= self._packed_rows[cid] or row in self._reused[cid]:
            raise RuntimeError(
                f"export_row: {buf.name!r} row {row} is not materialized "
                "device-side (unpacked or pending host refresh)")
        return slabs[cid][row].clone()

    def import_row(self, slabs: Sequence[torch.Tensor], buf: Buffer, value: torch.Tensor, *,
                   expected_generation: Optional[int] = None) -> List[torch.Tensor]:
        """Write ``value`` (a padded row exported from a peer shard) into
        ``buf``'s slab row, in place, on the slab's device: the receiving
        half of a d2d edge. The row must already be materialized (inside
        the packed watermark); the generation check is ``export_row``'s."""
        cid, row = self._row_addr("import_row", buf, expected_generation)
        if row >= self._packed_rows[cid]:
            raise RuntimeError(
                f"import_row: {buf.name!r} row {row} is not materialized "
                "device-side yet (pack before importing)")
        cls = self._classes[cid]
        if tuple(value.shape) != cls.padded_shape:
            raise ValueError(
                f"import_row: {buf.name!r} expects a padded row of shape "
                f"{cls.padded_shape}, got {tuple(value.shape)}")
        out = list(slabs)
        out[cid][row].copy_(value.to(dtype=out[cid].dtype), non_blocking=True)
        # The row now holds the peer's bits; a pending host-refresh mark
        # would clobber them at the next pack.
        self._reused[cid].discard(row)
        return out

    @property
    def classes(self) -> List[ShapeClass]:
        return list(self._classes)

    def n_classes(self) -> int:
        return len(self._classes)

    def rows(self, class_id: int) -> List[Optional[Buffer]]:
        return list(self._rows[class_id])

    def class_generation(self, class_id: int) -> int:
        return self._generation[class_id]

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

    def free_rows(self, class_id: Optional[int] = None) -> int:
        if class_id is not None:
            return len(self._free[class_id])
        return sum(len(f) for f in self._free)

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

    # -- compaction ---------------------------------------------------------
    def needs_compaction(self) -> List[int]:
        """Class ids whose dead-row fraction crossed the policy threshold."""
        out = []
        for cid in range(len(self._classes)):
            total = len(self._rows[cid])
            if total >= self.compact_min_rows and \
                    len(self._free[cid]) / total >= self.compact_waste:
                out.append(cid)
        return out

    def compact(self, slabs: Optional[Sequence[torch.Tensor]] = None,
                class_ids: Optional[Iterable[int]] = None,
                ) -> Tuple[Optional[List[torch.Tensor]], Dict[int, Dict[int, int]]]:
        """Rebuild the given classes with dead rows squeezed out.

        Live rows keep their relative order, so the packed live rows form a
        dense prefix and the new slab is a device-side gather of the old
        one: freed rows' values are dropped, never read back through the
        host. Rows beyond the old watermark were never materialized; the
        next :meth:`pack_incremental` appends them.

        Returns ``(new_slabs, moved)`` with ``moved[cid]`` mapping old row
        -> new row for every surviving row of a compacted class. Each
        compacted class's generation (and the global ``generation``)
        bumps. ``slabs=None`` skips the gather (an unmaterialized arena).
        """
        if class_ids is None:
            class_ids = self.needs_compaction()
        out = None if slabs is None else list(slabs)
        moved: Dict[int, Dict[int, int]] = {}
        for cid in class_ids:
            if not self._free[cid]:
                continue
            rows = self._rows[cid]
            packed = self._packed_rows[cid]
            live_old = [r for r, b in enumerate(rows) if b is not None]
            remap = {old: new for new, old in enumerate(live_old)}
            n_packed_live = sum(1 for r in live_old if r < packed)
            for old in live_old:
                self._addr[id(rows[old])] = (cid, remap[old])
            self._rows[cid] = [rows[r] for r in live_old]
            self._free[cid] = []
            self._reused[cid] = {remap[r] for r in self._reused[cid]}
            self._packed_rows[cid] = n_packed_live
            if out is not None and cid < len(out):
                keep = torch.tensor(live_old[:n_packed_live], dtype=torch.long,
                                    device=out[cid].device)
                slab = out[cid].index_select(0, keep)
                # Re-pad to the quantized capacity of the squeezed rows, so
                # the next pack_incremental appends within capacity.
                cap = row_capacity(len(self._rows[cid]))
                if cap > slab.shape[0]:
                    slab = torch.cat([slab, slab.new_zeros((cap - slab.shape[0],)
                                                           + tuple(slab.shape[1:]))])
                out[cid] = slab
            moved[cid] = remap
            self._generation[cid] += 1
            self.generation += 1
            self.compactions += 1
        return out, moved

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
            self._packed_rows[cid] = len(rows)
            self._reused[cid].clear()  # every row just re-read from host
        return slabs

    def pack_incremental(self, slabs: Optional[Sequence[torch.Tensor]],
                         device: DeviceLike = "cuda") -> List[torch.Tensor]:
        """Persistent-arena pack: keep the materialized slab rows (they hold
        the latest device-side values), append the rows added since the
        last pack, and refresh recycled rows inside the watermark from host
        values. ``slabs=None`` is a full :meth:`pack`. A slab grows to the
        next :func:`row_capacity` (a new tensor); rows are written in place.
        Host changes to already-packed buffers go through
        :meth:`update_rows`."""
        if slabs is None:
            return self.pack(device)
        device = resolve_device(device)
        out: List[torch.Tensor] = list(slabs)
        for cid, cls in enumerate(self._classes):
            total = len(self._rows[cid])
            packed = self._packed_rows[cid] if cid < len(slabs) else 0
            if packed < total:
                fresh = torch.stack([self._row_value(b, cls, device)
                                     for b in self._rows[cid][packed:]])
                if cid < len(out):
                    cap = out[cid].shape[0]
                    if total > cap:
                        out[cid] = torch.cat([out[cid], out[cid].new_zeros(
                            (row_capacity(total) - cap,) + cls.padded_shape)])
                else:
                    out.append(torch.zeros((row_capacity(total),) + cls.padded_shape,
                                           dtype=torch_dtype(cls.dtype), device=device))
                out[cid][packed:total] = fresh
                self._packed_rows[cid] = total
            if self._reused[cid]:
                rows = sorted(self._reused[cid])
                out[cid][rows] = torch.stack(
                    [self._row_value(self._rows[cid][r], cls, device) for r in rows])
                self._reused[cid].clear()
        return out

    def update_rows(self, slabs: Sequence[torch.Tensor],
                    buffers: Iterable[Buffer]) -> List[torch.Tensor]:
        """Refresh the given buffers' slab rows from their current host
        values, in place: the re-sync path for buffers written host-side
        between device epochs."""
        out = list(slabs)
        for buf in buffers:
            cid, row = self._addr[id(buf)]
            out[cid][row] = self._row_value(buf, self._classes[cid], out[cid].device)
        return out

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
            val = val[tuple(slice(0, s) for s in buf.shape)]
        # A contiguous copy, like every value a task writes (later kernels
        # see the same layout whichever executor produced it), and never a
        # view of a slab a persistent session goes on updating in place.
        buf.value = val.clone(memory_format=torch.contiguous_format)
        self.unpack_rows_written += 1
