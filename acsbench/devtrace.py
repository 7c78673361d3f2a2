"""Device traces under ``torch.profiler``.

``WindowTrace`` records the device operations of a whole measured window
and nothing else (no host operations, no shapes), for the seconds in which
the device was busy. ``profile_steps`` traces a few steps with host
operations and their shapes, reduced to what the per-layer metrics and the
breakdown read: every device operation (kernel, copy, set) with its
interval, the program's operator calls with their input shapes and device
time, and the profiled stretch (from the first step's start to the last
step's end, host clock of the trace).

Either runs one step before the ones it keeps, in the profiler's warm-up
(a trace loses its first device events); each step ``profile_steps``
keeps is a range ``acsbench.step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Op", "Profile", "WindowTrace", "profile_steps", "reduce_events",
           "busy_intervals"]

STEP = "acsbench.step"


@dataclasses.dataclass
class Op:
    """One operator call (the outermost of its name): its input shapes,
    scalar inputs where the profiler kept them, and the device seconds of
    the kernels it launched, its children's included."""

    name: str
    shapes: List[List[int]]
    scalars: Optional[List[object]]
    device_s: float


@dataclasses.dataclass
class Profile:
    kernels: List[Tuple[str, float, float]]       # (name, start_s, end_s)
    ops: List[Op]
    host: List[Tuple[str, float, float, int]]     # (name, start_s, end_s, depth), every thread
    stretch: Tuple[float, float]
    steps: int

    @property
    def window_s(self) -> float:
        return self.stretch[1] - self.stretch[0]

    @property
    def busy_per_step_s(self) -> float:
        """Seconds a profiled step kept the device busy (the union of its
        operations' intervals)."""
        return sum(e - s for s, e in busy_intervals(self.kernels, *self.stretch)) / self.steps

    def ops_named(self, names: Sequence[str]) -> List[Op]:
        return [op for op in self.ops if op.name in names]


def busy_intervals(kernels: Sequence[Tuple[str, float, float]], lo: float, hi: float
                   ) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals inside ``[lo, hi]``."""
    merged: List[List[float]] = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class WindowTrace:
    """The device operations of a window, as a context around its set-up's
    end: entering runs ``warm_step`` in the profiler's warm-up and then
    records every device operation (CUDA activity alone: the host's
    operations are not traced, which keeps the cost to the window's steps
    small) until ``close``, called once the window's last step has been
    read back. ``close`` returns the window's device-busy seconds, the
    union of the operations' intervals."""

    def __init__(self, warm_step: Callable[[], object]) -> None:
        self.warm_step = warm_step
        self.events = 0
        self.quarters: List[float] = []
        self.top_shares: Dict[str, List[float]] = {}
        self._prof = None

    def __enter__(self) -> "WindowTrace":
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._prof.__enter__()
        self.warm_step()
        torch.cuda.synchronize()
        self._prof.step()
        return self

    def close(self) -> float:
        """Stop recording; the busy seconds of what was recorded."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        ops = [(e.name(), e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
        self.events = len(ops)
        if not ops:
            return 0.0
        lo, hi = min(s for _, s, _ in ops), max(e for _, _, e in ops)
        busy = busy_intervals(ops, lo, hi)
        cut = [lo + (hi - lo) * i / 4 for i in range(5)]
        self.quarters = [sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy) / (b - a)
                         for a, b in zip(cut, cut[1:])]
        # the three operations that took most device time: each one's share
        # of the device time of each quarter (by start), to show whether the
        # work of a step drifts through the window
        took: Dict[str, List[float]] = {}
        total = [0.0] * 4
        for name, s, e in ops:
            q = min(int(4 * (s - lo) / (hi - lo)), 3) if hi > lo else 0
            took.setdefault(name, [0.0] * 4)[q] += e - s
            total[q] += e - s
        top = sorted(took, key=lambda n: -sum(took[n]))[:3]
        self.top_shares = {n: [t / max(d, 1e-12) for t, d in zip(took[n], total)] for n in top}
        return sum(e - s for s, e in busy)

    def __exit__(self, *exc) -> None:
        if self._prof is not None:  # the window failed: stop without reading
            self._prof.__exit__(None, None, None)
            self._prof = None


def _device_s(evt) -> float:
    us = getattr(evt, "device_time_total", None)
    if us is None:
        us = getattr(evt, "cuda_time_total", 0.0)
    return float(us) / 1e6


def reduce_events(events, op_names: Sequence[str]) -> Profile:
    """A profiler's ``events()`` reduced to a :class:`Profile`; ``op_names``
    are the operators whose calls are kept."""
    from torch.autograd import DeviceType

    kernels, ops, cpu, step_ranges = [], [], [], []
    wanted = set(op_names)
    for e in events:
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name.startswith("acsbench."):
                continue
            kernels.append((e.name, start, end))
            continue
        if e.name == STEP:
            step_ranges.append((start, end, e.thread))
        cpu.append((e.name, start, end, e.thread, e))
        if e.name in wanted:
            parent, nested = e.cpu_parent, False
            while parent is not None:
                if parent.name == e.name:
                    nested = True
                    break
                parent = parent.cpu_parent
            if not nested:
                ops.append(Op(e.name, [list(s) for s in (e.input_shapes or [])],
                              getattr(e, "concrete_inputs", None), _device_s(e)))
    if not step_ranges:
        raise RuntimeError("the profile holds no step range")
    lo, hi = min(s for s, _, _ in step_ranges), max(e for _, e, _ in step_ranges)
    host = []
    for name, s, e, th, evt in cpu:
        if e < lo or s > hi:
            continue
        depth, parent = 0, evt.cpu_parent
        while parent is not None:
            depth, parent = depth + 1, parent.cpu_parent
        host.append((name, s, e, depth))
    return Profile(kernels=kernels, ops=ops, host=host, stretch=(lo, hi),
                   steps=len(step_ranges))


# The program's operators whose calls the per-layer metrics count.
OPS = ("repro_torch::flash_attention_lse", "repro_torch::flash_attention_bwd",
       "repro_torch::flash_attention", "repro_torch::grouped_matmul_fwd",
       "repro_torch::grouped_matmul_bwd", "repro_torch::grouped_matmul")


def profile_steps(step: Callable[[int], object], n: int) -> Profile:
    """Run ``step(0)`` unkept, then ``step(1..n)`` under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
        for i in range(n + 1):
            with record_function(STEP):
                step(i)
            prof.step()
    torch.cuda.synchronize()
    return reduce_events(prof.events(), OPS)


def breakdown(p: Profile, top: int = 10) -> Dict[str, List[List[object]]]:
    """The device operations that took the most time in the stretch, and
    the longest idle gaps, each named by what the host was doing when it
    began: the outermost benchmark range open then, and the innermost host
    operation open on any thread (the backward runs on autograd's)."""
    lo, hi = p.stretch
    by_name: Dict[str, float] = {}
    for name, s, e in p.kernels:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
    device_ops = sorted(([n, t] for n, t in by_name.items()), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(p.kernels, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = []
    for s, e in gaps:
        around = [h for h in p.host if h[1] <= s < h[2]]
        spans = [h for h in around if h[0].startswith("acsbench.") and h[0] != STEP]
        ops = [h for h in around
               if not h[0].startswith(("acsbench.", "ProfilerStep"))]
        inner = max(ops, key=lambda h: (h[3], h[1]))[0] if ops else "no host operation"
        label = f"{min(spans, key=lambda h: h[3])[0]}: {inner}" if spans else inner
        idle.append([label, e - s])
    return {"device_ops": device_ops, "idle_gaps": idle}
