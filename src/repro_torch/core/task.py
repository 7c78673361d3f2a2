"""Task IR — the unit the ACS window schedules (PyTorch port of
``repro/core/task.py``).

A ``Task`` is a kernel launch packet (§II-A): an opcode, operand buffer
references, the resolved read/write ``Segment``s (the paper's launch-time
``get_addresses`` output), and a static cost estimate.

Tasks with equal ``signature`` are *batchable*: same kernel, same operand
shapes and dtypes. Dtypes enter the signature as numpy dtype names, so a
port task's signature equals the reference's for the same launch (apart
from ``kernel_uid``, a per-process counter).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np

from .buffers import Buffer, BufferView, to_numpy_dtype
from .segments import Segment, SegmentSet

__all__ = ["Task", "Operand", "operand_shape", "operand_dtype", "operand_base"]

Operand = Union[Buffer, BufferView]

_tid_counter = itertools.count()


def operand_shape(op: Operand) -> Tuple[int, ...]:
    if isinstance(op, BufferView):
        if op.row_count is None:
            raise ValueError("non-row views have no array shape")
        return (op.row_count,) + tuple(op.buffer.shape[1:])
    return tuple(op.shape)


def operand_dtype(op: Operand) -> np.dtype:
    buf = op.buffer if isinstance(op, BufferView) else op
    return to_numpy_dtype(buf.dtype)


def operand_base(op: Operand) -> Buffer:
    """The backing allocation: a view's parent buffer, or the buffer itself.
    This is the unit the slab arena assigns rows to."""
    return op.buffer if isinstance(op, BufferView) else op


@dataclasses.dataclass
class Task:
    """One schedulable kernel invocation."""

    opcode: str
    fn: Callable[..., Any]  # pure: (*input tensors) -> output tensor | tuple
    inputs: Tuple[Operand, ...]
    outputs: Tuple[Operand, ...]
    read_segments: SegmentSet
    write_segments: SegmentSet
    cost_flops: float = 0.0
    cost_bytes: float = 0.0
    tid: int = dataclasses.field(default_factory=lambda: next(_tid_counter))
    # Extra python-scalar params baked into fn via the wrapper (kept for
    # signature identity so compiled wave programs can be reused).
    static_args: Tuple[Any, ...] = ()
    # Unique id of the defining AcsKernel — disambiguates distinct kernels
    # that share a display name (e.g. two lambdas): signature safety.
    kernel_uid: int = -1
    # Tag of the TaskStream that pushed this task (live sessions: per-tenant
    # / per-request accounting). Not part of the signature.
    stream_tag: Optional[str] = None
    # QoS class: lower = more urgent (0 = highest). Only a *scheduling
    # hint* — it buckets the window's READY index so urgent work launches
    # first among provably independent kernels; it never reorders
    # dependent work and is not part of the signature (a compiled wave
    # program serves every priority class).
    priority: int = 1

    @property
    def signature(self) -> Tuple:
        """Batching/caching key: same signature => same compiled program."""
        return (
            self.opcode,
            self.kernel_uid,
            tuple((operand_shape(x), str(operand_dtype(x))) for x in self.inputs),
            tuple((operand_shape(x), str(operand_dtype(x))) for x in self.outputs),
            self.static_args,
        )

    def input_values(self) -> Tuple[Any, ...]:
        return tuple(x.get_value() for x in self.inputs)

    def write_outputs(self, results: Any) -> None:
        if not isinstance(results, (tuple, list)):
            results = (results,)
        if len(results) != len(self.outputs):
            raise ValueError(
                f"task {self.opcode}#{self.tid}: fn returned {len(results)} "
                f"values for {len(self.outputs)} outputs"
            )
        for out, val in zip(self.outputs, results):
            out.set_value(val)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Task({self.opcode}#{self.tid}, in={len(self.inputs)}, out={len(self.outputs)})"


def default_segments(
    inputs: Sequence[Operand], outputs: Sequence[Operand]
) -> Tuple[SegmentSet, SegmentSet]:
    """Fig 17 default: every input read in full, every output written in full."""
    return (
        SegmentSet([x.segment for x in inputs]),
        SegmentSet([x.segment for x in outputs]),
    )
