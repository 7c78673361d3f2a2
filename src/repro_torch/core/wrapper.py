"""``@acs_kernel`` — the ACS_wrapper analogue (paper Fig 16/17); PyTorch
port of ``repro/core/wrapper.py``.

The paper wraps every CUDA kernel in an ``ACE_wrapper`` struct holding a
``get_addresses`` callback that, given the launch arguments, populates
``__read_segments__`` / ``__write_segments__`` just before launch. Here the
wrapper is a decorator producing an :class:`AcsKernel`; launching it onto a
:class:`TaskStream` resolves the segments (default: full operand ranges,
exactly Fig 17's matmul example) and enqueues a :class:`Task`.

If segment ranges cannot be determined (the paper's indirect-access case),
``conservative=True`` marks the task as touching the *entire* address
space, serializing it against everything — the paper's stated fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .buffers import Buffer, BufferView
from .segments import Segment, SegmentSet
from .task import Operand, Task, default_segments, operand_dtype, operand_shape

__all__ = ["acs_kernel", "AcsKernel", "TaskStream", "KERNEL_REGISTRY"]

KERNEL_REGISTRY: Dict[str, "AcsKernel"] = {}

# A segment covering the whole virtual address space (conservative fallback).
_WHOLE_SPACE = Segment(0, 2**62)


GetAddresses = Callable[..., Tuple[List[Segment], List[Segment]]]


_kernel_uid_counter = 0


@dataclasses.dataclass
class AcsKernel:
    """A kernel definition: pure fn + address resolver + cost model."""

    name: str
    fn: Callable[..., Any]
    get_addresses: Optional[GetAddresses] = None
    flops: Optional[Callable[..., float]] = None
    conservative: bool = False
    uid: int = -1

    def __post_init__(self) -> None:
        global _kernel_uid_counter
        if self.uid < 0:
            self.uid = _kernel_uid_counter
            _kernel_uid_counter += 1

    def launch(
        self,
        stream: "TaskStream",
        inputs: Sequence[Operand],
        outputs: Sequence[Operand],
        static_args: Tuple[Any, ...] = (),
    ) -> Task:
        """Resolve segments ("just before kernel launch", §IV-A) and enqueue."""
        inputs = tuple(inputs)
        outputs = tuple(outputs)
        if self.conservative:
            reads = SegmentSet([_WHOLE_SPACE])
            writes = SegmentSet([_WHOLE_SPACE])
        elif self.get_addresses is not None:
            r, w = self.get_addresses(inputs, outputs, *static_args)
            reads, writes = SegmentSet(list(r)), SegmentSet(list(w))
        else:
            reads, writes = default_segments(inputs, outputs)

        flops = float(self.flops(inputs, outputs, *static_args)) if self.flops else _default_flops(inputs, outputs)
        bytes_moved = sum(x.segment.size for x in inputs) + sum(x.segment.size for x in outputs)

        fn = self.fn
        if static_args:
            base = self.fn
            fn = lambda *vals, _b=base, _s=static_args: _b(*vals, *_s)

        task = Task(
            opcode=self.name,
            fn=fn,
            inputs=inputs,
            outputs=outputs,
            read_segments=reads,
            write_segments=writes,
            cost_flops=flops,
            cost_bytes=float(bytes_moved),
            static_args=tuple(static_args),
            kernel_uid=self.uid,
        )
        stream.push(task)
        return task


def _default_flops(inputs: Sequence[Operand], outputs: Sequence[Operand]) -> float:
    # Elementwise default: one flop per output element.
    total = 0.0
    for o in outputs:
        total += float(np.prod(operand_shape(o), dtype=np.float64))
    return total


def acs_kernel(
    name: Optional[str] = None,
    get_addresses: Optional[GetAddresses] = None,
    flops: Optional[Callable[..., float]] = None,
    conservative: bool = False,
) -> Callable[[Callable], AcsKernel]:
    """Decorator: ``@acs_kernel()`` turns a pure tensor function into an
    :class:`AcsKernel` registered under its name."""

    def deco(fn: Callable) -> AcsKernel:
        kname = name or fn.__name__
        kern = AcsKernel(
            name=kname,
            fn=fn,
            get_addresses=get_addresses,
            flops=flops,
            conservative=conservative,
        )
        KERNEL_REGISTRY[kname] = kern
        return kern

    return deco


class TaskStream:
    """The application-visible launch stream (single in-order queue).

    The paper's applications launch kernels into one stream; ACS re-extracts
    the parallelism downstream. ``TaskStream`` records launches in program
    order — batch schedulers consume the recorded list.

    A stream may also be **live**: constructed with a ``sink`` (a
    :class:`~.session.SchedulerSession`, or any callable / object with
    ``submit``), every ``push`` — i.e. every ``AcsKernel.launch`` — feeds
    the consumer immediately, which is exactly the paper's §III-D picture
    of the input FIFO being refilled while kernels execute. ``tag`` stamps
    each pushed task's ``stream_tag`` (per-request / per-tenant accounting
    in the serving runtime).

    ``record=False`` stops the stream from retaining pushed tasks in
    ``self.tasks`` — required for a *long-lived* live stream (a server's
    persistent decode stream would otherwise hold every Task it ever
    pushed, with its buffer references and closures, for the process
    lifetime). The sink is then the only consumer.

    ``priority`` stamps each pushed task's QoS class (lower = more
    urgent; DESIGN §13). Like ``tag`` it is pure metadata: it buckets the
    window's READY index but never enters the task signature.
    """

    def __init__(self, sink: Optional[Any] = None, tag: Optional[str] = None,
                 record: bool = True, priority: Optional[int] = None) -> None:
        self.tasks: List[Task] = []
        self.tag = tag
        self.priority = priority
        self._record = record
        self._subscribers: List[Callable[[Task], Any]] = []
        if sink is not None:
            self.subscribe(sink)

    def subscribe(self, sink: Any) -> None:
        """Attach a live consumer: each subsequent ``push`` is forwarded to
        ``sink.submit(task)`` (sessions) or ``sink(task)`` (callables)."""
        fn = getattr(sink, "submit", sink)
        if not callable(fn):
            raise TypeError(f"stream sink {sink!r} is neither callable nor has .submit")
        self._subscribers.append(fn)

    def push(self, task: Task) -> None:
        if self.tag is not None:
            task.stream_tag = self.tag
        if self.priority is not None:
            task.priority = self.priority
        if self._record:
            self.tasks.append(task)
        for fn in self._subscribers:
            fn(task)

    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks)
