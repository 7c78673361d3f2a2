"""The program's own spans and counters (``repro_torch.trace``), as the
benchmark reads them.

``idle_split`` divides the idle time of a profiled stretch
(``devtrace.Profile``) by the part of the step the host was in when each
gap began, read from the program's ranges (``repro_torch.<span>``) in the
trace: the program's spans open a host range under any ``torch.profiler``,
tracing on or off, so the traced run's profiled steps carry them. A trace
of a program without them gives None.

``inside_steps`` runs steps with the program's tracing on and no profiler,
and keeps what ``trace.collect()`` gives (:class:`Inside`): each span's
device milliseconds (CUDA events), the MoE counters, the launch counters'
deltas. ``span_ms`` and ``useful_rows_pct`` read it.

Run as a script, it measures one cell's program spans on the card, in one
process after the cell's set-up, and prints a JSON line:

    python3 acsbench/spans.py --workload <name> --seed <n> [--steps 3] [--rounds 8]

the cost of tracing on (``--rounds`` pairs of off and on, 3 steps each,
host ms a step; and one span's host microseconds off and on), the seven
readers' values (``READERS``) on the readings of ``--steps`` steps with
tracing on (the benchmark's own spans around ``launch.steps``' calls
installed too, to compare with) and of the same number profiled as the
traced run profiles them (tracing off), the idle split, each span's count,
host and device ms a step, the counters, the longest idle gaps named by
the phase, the innermost program span and the innermost other host
operation open when each began; and, to compare with, the device events,
stretch and idle of as many steps profiled with the spans stubbed out.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

if __name__ == "__main__":  # a script: the checkout's root and src/ importable
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

from acsbench.devtrace import busy_intervals  # noqa: E402

__all__ = ["PREFIX", "PHASES", "READERS", "Inside", "inside_steps", "span_ms",
           "useful_rows_pct", "gaps", "phase_at", "idle_split", "idle_ms", "named_gaps"]

PREFIX = "repro_torch."
# The train step's parts, which do not nest in one another; an idle gap
# goes to the one open when it began, else to ``train.step`` (inside a step,
# between its parts), else to ``outside`` (no program span open).
PHASES = ("train.forward", "train.backward", "optim.clip", "optim.adamw")
READERS = ("fwd_ms", "bwd_ms", "clip_ms", "adamw_ms", "fwd_idle_ms", "bwd_idle_ms",
           "moe_rows_useful_pct")


@dataclasses.dataclass
class Inside:
    """``trace.collect()``'s readings of ``steps`` steps run with tracing on."""

    steps: int
    spans: List[Dict[str, Any]]
    counters: Dict[str, Any]
    launches: Dict[str, int]


def inside_steps(step: Callable[[int], object], n: int) -> Optional[Inside]:
    """Run ``step(0..n-1)`` (each ending in its host read) with the
    program's tracing on; None for a program without ``repro_torch.trace``."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    trace.enable()
    try:
        trace.collect()
        for i in range(n):
            step(i)
        got = trace.collect()
    finally:
        trace.disable()
    return Inside(steps=got["steps"], spans=got["spans"], counters=got["counters"],
                  launches=got["launches"])


def span_ms(inside: Optional[Inside], name: str, key: str = "device_ms") -> Optional[float]:
    """The milliseconds a step of the spans called ``name`` (summed over
    every such span, over the number of steps), or None where none was
    kept."""
    if inside is None or not inside.steps:
        return None
    ms = [s[key] for s in inside.spans if s["name"] == name and s[key] is not None]
    return sum(ms) / inside.steps if ms else None


def useful_rows_pct(inside: Optional[Inside]) -> Optional[float]:
    """The share of the expert products' capacity rows that hold a kept
    assignment, or None without the MoE counters."""
    c = inside.counters if inside is not None else {}
    if not c.get("moe.capacity_rows"):
        return None
    return 100.0 * c["moe.kept_rows"] / c["moe.capacity_rows"]


def gaps(profile) -> List[Tuple[float, float]]:
    """The stretch's idle gaps: where no device operation runs."""
    lo, hi = profile.stretch
    busy = busy_intervals(profile.kernels, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def _open_at(host, t: float):
    return [h for h in host if h[1] <= t < h[2]]


def phase_at(host, t: float) -> str:
    """The step's part the host was in at ``t``: one of ``PHASES``,
    ``train.step`` or ``outside``."""
    names = {h[0] for h in _open_at(host, t) if h[0].startswith(PREFIX)}
    for phase in PHASES:
        if PREFIX + phase in names:
            return phase
    return "train.step" if PREFIX + "train.step" in names else "outside"


def idle_split(profile) -> Optional[Dict[str, float]]:
    """The stretch's idle seconds by the part of the step open (on any
    thread) when each gap began, and ``total``; None where the trace holds
    no program span."""
    if profile is None:
        return None
    host = [h for h in profile.host if h[0].startswith(PREFIX)]
    if not any(h[0] == PREFIX + "train.forward" for h in host):
        return None
    out = dict.fromkeys(PHASES + ("train.step", "outside", "total"), 0.0)
    for s, e in gaps(profile):
        out[phase_at(host, s)] += e - s
        out["total"] += e - s
    return out


def idle_ms(profile, phase: str) -> Optional[float]:
    """Idle milliseconds a profiled step in gaps that began in ``phase``."""
    split = idle_split(profile)
    return None if split is None else 1e3 * split[phase] / profile.steps


def named_gaps(profile, top: int = 10) -> List[List[object]]:
    """The longest idle gaps, each with the phase, the innermost program
    span and the innermost other host operation open when it began."""
    out = []
    for s, e in sorted(gaps(profile), key=lambda g: g[0] - g[1])[:top]:
        around = _open_at(profile.host, s)
        spans = [h for h in around if h[0].startswith(PREFIX)]
        ops = [h for h in around if not h[0].startswith((PREFIX, "acsbench.", "ProfilerStep"))]
        inner = lambda hs: max(hs, key=lambda h: (h[3], h[1]))[0] if hs else None  # noqa: E731
        out.append([phase_at(profile.host, s), inner(spans), inner(ops), e - s])
    return out


def _summary(inside: Inside) -> Dict[str, Dict[str, float]]:
    """Each span's count, host ms and device ms a step."""
    out: Dict[str, Dict[str, float]] = {}
    for s in inside.spans:
        row = out.setdefault(s["name"], {"count": 0, "host_ms": 0.0, "device_ms": 0.0})
        row["count"] += 1
        row["host_ms"] += s["host_ms"]
        row["device_ms"] += s["device_ms"] or 0.0
    return {k: {f: v / inside.steps for f, v in row.items()} for k, row in out.items()}


def measure(cell, steps: int, rounds: int, log: Callable[[str], None]) -> Dict[str, Any]:
    """One cell's readings on the card (the module's docstring)."""
    import contextlib
    import gc
    import statistics
    import time
    import types

    from repro_torch import trace
    from repro_torch.launch import steps as steps_module

    from acsbench import devtrace, harness
    from acsbench.kinds import train

    prog = train.Program(cell)
    prog.first_steps()
    gc.collect()

    def step(i: int) -> float:
        return float(prog.step()["loss"])

    # -- the cost of tracing on: off and on in turns (off, on, on, off, ...),
    # host ms a step (its wall, ended by the host read); and one span's host
    # microseconds in a loop, off (no profiler) and on (its CUDA events too)
    walls: Dict[str, List[float]] = {"off": [], "on": []}
    by_step = []  # the MoE counters of each round with tracing on, by job step
    for r in range(2 * rounds):
        side = ("off", "on", "on", "off")[r % 4]
        if side == "on":
            trace.enable()
        t0 = time.perf_counter()
        for i in range(3):
            step(i)
        walls[side].append((time.perf_counter() - t0) * 1e3 / 3)
        trace.disable()
        useful = useful_rows_pct(Inside(3, [], trace.collect()["counters"], {}))
        if side == "on" and useful is not None:
            by_step.append([prog.done, useful])
    cost: Dict[str, Any] = {k: {"median": statistics.median(v), "all": v}
                            for k, v in walls.items()}
    cost["on_over_off"] = cost["on"]["median"] / cost["off"]["median"] - 1.0
    for side in ("off", "on_first", "on"):  # on_first takes new CUDA events, on reuses them
        if side != "off":
            trace.enable()
        t0 = time.perf_counter()
        for _ in range(20000):
            with trace.span("cost"):
                pass
        cost[f"span_us_{side}"] = (time.perf_counter() - t0) / 20000 * 1e6
        trace.disable()
        trace.collect()
    log(f"host ms a step, off {walls['off']}, on {walls['on']}; a span's host us "
        f"{cost['span_us_off']:.3f} off, {cost['span_us_on_first']:.3f} on with new "
        f"events, {cost['span_us_on']:.3f} on")

    # -- the readings: tracing on beside the benchmark's outside spans, then
    # the steps profiled as the traced run profiles them (tracing off)
    with train._Spans(steps_module) as outside:
        outside.clear()
        inside = inside_steps(step, steps)
        outer = {k: statistics.fmean(v) for k, v in outside.device_ms().items()}
    profile = devtrace.profile_steps(step, steps)
    # the same number of steps profiled with the spans stubbed out, as a
    # program without them is profiled
    real_span = trace.span
    trace.span = lambda name: contextlib.nullcontext()
    try:
        bare = devtrace.profile_steps(step, steps)
    finally:
        trace.span = real_span
    bare_idle = sum(e - s for s, e in gaps(bare))
    run = types.SimpleNamespace(inside=inside, profile=profile)
    values = {name: harness.per_layer(name, run) for name in READERS}
    split = idle_split(profile)
    c = inside.counters
    moe = {}
    if "moe.kept_rows" in c:
        moe = {"kept_rows": c["moe.kept_rows"], "capacity_rows": c["moe.capacity_rows"],
               "assignments": c["moe.assignments"],
               "dropped_share": 1.0 - c["moe.kept_rows"] / c["moe.assignments"],
               "expert_rows": c["moe.expert_rows"]}
    return {"job_steps": prog.done, "values": values, "outside_ms": outer,
            "inside_vs_outside": {
                "fwd_bwd": (values["fwd_ms"] + values["bwd_ms"]) / outer["loss_and_grads"] - 1.0,
                "optim": (values["clip_ms"] + values["adamw_ms"]) / outer["optim"] - 1.0},
            "idle_split_ms": {k: 1e3 * v / profile.steps for k, v in split.items()},
            "stretch_ms": 1e3 * profile.window_s / profile.steps,
            "device_events": len(profile.kernels),
            "without_spans": {"device_events": len(bare.kernels),
                              "stretch_ms": 1e3 * bare.window_s / bare.steps,
                              "idle_ms": 1e3 * bare_idle / bare.steps},
            "spans": _summary(inside), "moe": moe,
            "launches": {k: v / inside.steps for k, v in inside.launches.items() if v},
            "useful_rows_pct_by_job_step": by_step, "idle_gaps": named_gaps(profile),
            "cost": cost}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    t0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[spans {time.perf_counter() - t0:8.2f} s] {msg}", file=sys.stderr, flush=True)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None, help="default: the traffic's profile_steps")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from acsbench import harness
    from acsbench.kinds import train

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 3
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    found = harness.find_cell(harness.load_benchmark(), args.workload)
    cell = train.Cell(config=found["config"], traffic=found["traffic"], seed=args.seed,
                      seconds=0.0, trace=True, device=torch.device("cuda", 0), log=log)
    out = measure(cell, args.steps or found["traffic"]["profile_steps"], args.rounds, log)
    out.update(workload=args.workload, seed=args.seed, device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
