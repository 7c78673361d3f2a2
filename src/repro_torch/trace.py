"""Spans and counters inside the port's steps; off unless :func:`enable`.

A span (``with trace.span("train.forward"):``) marks where a part of a
step runs: ``train.step``, ``train.forward``, ``train.backward``,
``optim.clip``, ``optim.adamw``, each block's ``block.mixer`` and
``block.ffn`` (in the forward and again in the backward's recompute), and
the MoE layer's ``moe.route``, ``moe.experts`` and ``moe.combine``.

Off (the default), a span keeps nothing, records no CUDA event and
launches no kernel: it checks this module's flag and PyTorch's
``torch.autograd.profiler._is_profiler_enabled``, which is set only while a
``torch.profiler`` runs. While one runs, the span opens a host range
``repro_torch.<name>`` (``_RecordFunctionFast``, the range PyTorch's own
generated code opens), so that the trace names the part of the step the
host was in when the device went idle; the program's numbers, kernels and
memory stay what they are without the spans.

On (:func:`enable`), a span also records a pair of CUDA events on the
current stream (where CUDA is initialised; events a collect has read are
used again) and keeps, in memory, its name, host start and end, its
parent and its step. The parent is the innermost
span open on its own thread, else the innermost open on any thread: the
backward's recompute on autograd's thread gets ``train.backward``. The
step is a host count that ``train.step`` advances. :func:`count` adds a
host number or a device tensor into a named counter (a device counter is
never read inside a step). :func:`collect` synchronises once and returns,
and clears, every finished span with its host and device milliseconds,
every counter (the device ones read back in one transfer) and the kernel
modules' launch counters' deltas since :func:`enable` or the last
:func:`collect` (read from those modules, not counted again).
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["PREFIX", "STEP", "LAUNCH_COUNTERS", "enable", "disable", "enabled", "span",
           "count", "collect"]

PREFIX = "repro_torch."
STEP = "train.step"

# The kernel modules' launch counters (ints, or dicts of ints by path) that
# ``collect`` reports as deltas.
LAUNCH_COUNTERS = {
    "adamw": ("launches", "norm_launches", "paths"),
    "flash_attention": ("launches", "backward_launches", "backward_paths"),
    "grouped_matmul": ("launches", "dx_launches", "dw_launches", "dx_paths", "dw_paths"),
    "lru_scan": ("launches", "backward_launches"),
    "selective_scan": ("launches", "backward_launches"),
}

_NULL = contextlib.nullcontext()
_on = False
_rec: Optional["_Recorder"] = None
_EVENTS: List[Any] = []  # CUDA timing events a collect has read, for reuse


def _event():
    return _EVENTS.pop() if _EVENTS else torch.cuda.Event(enable_timing=True)


def _launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for module, names in LAUNCH_COUNTERS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        for name in names:
            value = getattr(mod, name)
            if isinstance(value, dict):
                out.update({f"{module}.{name}.{k}": v for k, v in value.items()})
            else:
                out[f"{module}.{name}"] = value
    return out


class _Recorder:
    """What one recording keeps: finished spans, the spans open on any
    thread (in the order they opened), each thread's own stack, the step
    count, the counters and the launch counters at its start."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.ids = itertools.count()
        self.done: List["_Span"] = []
        self.open: List["_Span"] = []
        self.local = threading.local()
        self.step = 0
        self.steps = 0  # steps begun since the last collect
        self.counters: Dict[str, Any] = {}
        self.launches = _launch_counts()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "step", "t0", "t1", "events", "range")

    def __init__(self, rec: _Recorder, name: str) -> None:
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Span":
        rec = self.rec
        self.range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.range.__enter__()
        stack = rec.local.__dict__.setdefault("stack", [])
        cuda = torch.cuda.is_initialized()
        with rec.lock:
            self.id = next(rec.ids)
            if self.name == STEP:
                rec.step += 1
                rec.steps += 1
            self.step = rec.step
            parent = stack[-1] if stack else (rec.open[-1] if rec.open else None)
            self.parent = None if parent is None else parent.id
            rec.open.append(self)
            self.events = (_event(), _event()) if cuda else None
        stack.append(self)
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        rec = self.rec
        rec.local.stack.pop()
        with rec.lock:
            rec.open.remove(self)
            rec.done.append(self)
        self.range.__exit__(*exc)


def enable() -> None:
    """Start recording (a no-op while on): spans and counters from now on
    are kept until :func:`collect`."""
    global _on, _rec
    if not _on:
        _rec = _Recorder()
        _on = True


def disable() -> None:
    """Stop recording; what was kept waits for :func:`collect`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str):
    """A context manager over the part of a step called ``name``."""
    if _on:
        return _Span(_rec, name)
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _NULL


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor added in place on its device)
    into the counter ``name``; nothing while off. Callers compute a device
    ``value`` only where :func:`enabled`, so that off launches nothing."""
    if not _on:
        return
    rec = _rec
    with rec.lock:
        acc = rec.counters.get(name)
        if acc is None:
            rec.counters[name] = (value.detach().clone() if isinstance(value, torch.Tensor)
                                  else value)
        elif isinstance(acc, torch.Tensor):
            acc.add_(value)
        else:
            rec.counters[name] = acc + value


def _read(counters: Dict[str, Any]) -> Dict[str, Any]:
    """Host numbers as they are; device tensors read back in one transfer
    a device (a 0-d tensor as a number, others as lists)."""
    out = {k: v for k, v in counters.items() if not isinstance(v, torch.Tensor)}
    by_device: Dict[torch.device, List[Any]] = {}
    for k, v in counters.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append((k, v))
    for items in by_device.values():
        flat = torch.cat([v.reshape(-1).to(torch.float64) for _, v in items]).tolist()
        at = 0
        for k, v in items:
            vals = flat[at:at + v.numel()]
            at += v.numel()
            if not v.is_floating_point():
                vals = [int(x) for x in vals]
            out[k] = vals[0] if v.dim() == 0 else vals
    return out


def collect() -> Dict[str, Any]:
    """Synchronise once, then return and clear what was kept:
    ``{"steps": train steps begun, "spans": [{"name", "id", "parent" (an
    id or None), "step", "host_ms", "device_ms" (None without CUDA
    events)}, ...] in the order they ended, "counters": {name: value},
    "launches": {"<module>.<counter>[.<path>]": delta}}``."""
    rec = _rec
    if rec is None:
        return {"steps": 0, "spans": [], "counters": {}, "launches": {}}
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with rec.lock:
        done, rec.done = rec.done, []
        counters, rec.counters = rec.counters, {}
        steps, rec.steps = rec.steps, 0
    now = _launch_counts()
    launches = {k: v - rec.launches.get(k, 0) for k, v in now.items()}
    rec.launches = now
    spans = [{"name": s.name, "id": s.id, "parent": s.parent, "step": s.step,
              "host_ms": (s.t1 - s.t0) * 1e3,
              "device_ms": None if s.events is None else s.events[0].elapsed_time(s.events[1])}
             for s in done]
    _EVENTS.extend(e for s in done if s.events is not None for e in s.events)
    return {"steps": steps, "spans": spans, "counters": _read(counters), "launches": launches}
