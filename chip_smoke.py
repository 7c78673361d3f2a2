#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (an exception, exit code != 0):

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: the ready-queue CUDA kernel, from the sources in this checkout.
3. Kernel vs plain: on random DAG streams the kernel's slab, completion
   flags and final ring are bit-equal to ``ready_queue_ref`` on the card.
4. ACS-HW main path: the chain universe (64 chains x width 4096 x depth 32,
   2,048 tasks) and the 24-task mixed-tag hazard stream run through
   ``DeviceWindowRunner(plan_mode="loop")`` on the CUDA kernel, bit-equal
   to ``run_serial`` on the card.
5. ACS-SW main path: the cheetah physics stream (64 envs, 8 groups,
   5 steps) through the serial, wave and threaded (4 CUDA streams)
   schedulers, bit-equal across the three and finite.
6. Numbers: CUDA-event medians of the kernel and its plain version at the
   main path's shape, and the wall time of each phase-4/5 policy.
7. Device busy share: one more pass of each phase-4/5 policy under
   ``torch.profiler``; the union of the CUDA kernels' intervals over the
   pass's wall ("not measured" if the profiler records no kernel).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the ``repro_torch`` package beside this
file, it exits with an error and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet): device memory rate and fp32 rate
# outside the tensor cores, for the kernel's least possible time.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

CHAINS, WIDTH, DEPTH, WINDOW = 64, 4096, 32, 32
SIM_ENVS, SIM_GROUP, SIM_STEPS, SIM_STREAMS = 64, 8, 5, 4
TIMED_RUNS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """A failed phase: raise (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def bits(t):
    """A float tensor's bit pattern (NaN-safe exact comparison)."""
    import torch

    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def bit_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(bits(a), bits(b)))


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

def chain_universe(device, seed=0, n_chains=CHAINS, width=WIDTH, depth=DEPTH):
    """Per-chain state buffers and one shared read-only weight row; each
    chain applies ``depth`` RAW-serialized kernels (axpy/mul alternating),
    chains are mutually independent."""
    from repro_torch.core import BufferPool, Task
    from repro_torch.core.task import default_segments
    from repro_torch.kernels.ops import LOOP_BRANCHES

    rng = np.random.RandomState(seed)
    pool = BufferPool(device)
    states = [pool.alloc((width,), np.float32, name=f"chain{i}",
                         value=rng.randn(width).astype(np.float32))
              for i in range(n_chains)]
    weight = pool.alloc((width,), np.float32, name="weight",
                        value=rng.randn(width).astype(np.float32))
    tasks = []
    for s in states:
        for d in range(depth):
            name = "axpy" if d % 2 == 0 else "mul"
            ins, outs = (s, weight), (s,)
            r, w = default_segments(ins, outs)
            tasks.append(Task(opcode=name, fn=LOOP_BRANCHES[name], inputs=ins,
                              outputs=outs, read_segments=r, write_segments=w))
    return states, tasks


def mixed_tag(device, seed=0, width=WIDTH, n_bufs=6, n_tasks=24):
    """Two tagged tenant streams interleaved over shared buffers: RAW, WAR
    and WAW hazards across tenants."""
    from repro_torch.core import AcsKernel, BufferPool, TaskStream
    from repro_torch.kernels.ops import LOOP_BRANCHES

    rng = np.random.RandomState(seed)
    pool = BufferPool(device)
    bufs = [pool.alloc((width,), np.float32, value=rng.randn(width).astype(np.float32))
            for _ in range(n_bufs)]
    kernels = {k: AcsKernel(name=f"{k}_mixed", fn=LOOP_BRANCHES[k]) for k in LOOP_BRANCHES}
    streams = {t: TaskStream(tag=t) for t in ("tenantA", "tenantB")}
    tasks = []
    for _ in range(n_tasks):
        tag = "tenantA" if rng.rand() < 0.5 else "tenantB"
        kern = kernels["axpy" if rng.rand() < 0.5 else "mul"]
        ins = (bufs[rng.randint(n_bufs)], bufs[rng.randint(n_bufs)])
        outs = (bufs[rng.randint(n_bufs)],)
        tasks.append(kern.launch(streams[tag], inputs=ins, outputs=outs))
    return bufs, tasks


def random_dag(device, seed, n, d, n_bufs=256):
    """A random stream of ``n`` axpy/mul tasks over ``n_bufs`` rows of
    width ``d``, lowered to the kernel's payload."""
    from repro_torch.core import BufferPool, Task
    from repro_torch.core.task import default_segments
    from repro_torch.kernels.ops import LOOP_BRANCHES

    rng = np.random.RandomState(seed)
    pool = BufferPool(device)
    bufs = [pool.alloc((d,), np.float32, value=rng.randn(d).astype(np.float32))
            for _ in range(n_bufs)]
    tasks = []
    for _ in range(n):
        name = "axpy" if rng.rand() < 0.5 else "mul"
        ins = (bufs[rng.randint(n_bufs)], bufs[rng.randint(n_bufs)])
        outs = (bufs[rng.randint(n_bufs)],)
        r, w = default_segments(ins, outs)
        tasks.append(Task(opcode=name, fn=LOOP_BRANCHES[name], inputs=ins,
                          outputs=outs, read_segments=r, write_segments=w))
    return lowered_payload(tasks, device)


def lowered_payload(tasks, device):
    """Lower ``tasks`` as the device runner does; returns the kernel's
    arguments ``(slab, payload, branches)``."""
    from repro_torch.core import DeviceOpRegistry, SlabArena
    from repro_torch.core.device_dispatch import _loop_kernel_parts, lower_epoch_program
    from repro_torch.kernels.ops import register_loop_branches

    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    arena = SlabArena()
    arena.add_tasks(tasks)
    program = lower_epoch_program(tasks, reg, arena)
    parts = _loop_kernel_parts(program, reg, arena)
    check(parts is not None, "stream is not eligible for the ready-queue kernel")
    cid, branches = parts
    slab = arena.pack(device)[cid]
    return slab, program.payload(device), branches


def run_queue(fn, slab, p, branches):
    return fn(slab, p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"], p["tail0"],
              branches=branches)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = out.splitlines()[0].strip()
    log(card)
    return card


def phase_build():
    from repro_torch.kernels import ready_queue as rq

    path, seconds = rq.build()
    log(f"build: {rq.SOURCE.name} -> {path.name} in {seconds:.2f} s (sm_90a)")


def phase_kernel_vs_plain(device):
    import torch
    from repro_torch.kernels.ready_queue import ready_queue
    from repro_torch.kernels.ref import ready_queue_ref

    for seed in range(3):
        for n, d in ((64, 128), (512, 1024), (2048, 4096)):
            slab, p, branches = random_dag(device, seed, n, d)
            got = run_queue(ready_queue, slab, p, branches)
            torch.cuda.synchronize()
            want = run_queue(ready_queue_ref, slab, p, branches)
            torch.cuda.synchronize()
            for name, g, w in zip(("slab", "done", "ring"), got, want):
                check(bit_equal(g, w), f"kernel != plain on {name} (seed {seed}, n {n}, d {d})")
            check(bool(got[1].all()), f"queue did not drain (seed {seed}, n {n})")
            log(f"kernel == plain: seed {seed} n {n} d {d} slab {tuple(slab.shape)}")


def phase_acs_hw(device):
    """Returns (launches on the main path, wall seconds per policy)."""
    import torch
    from repro_torch.core import DeviceOpRegistry, DeviceWindowRunner, run_serial
    from repro_torch.kernels import ready_queue as rq
    from repro_torch.kernels.ops import register_loop_branches

    walls = {}
    for label, build in (("chain_universe", chain_universe), ("mixed_tag", mixed_tag)):
        bufs, tasks = build(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_serial(tasks, device=device)
        walls[f"{label}/serial"] = time.perf_counter() - t0
        expect = torch.stack([b.value for b in bufs])

        bufs, tasks = build(device)
        reg = DeviceOpRegistry(strict=False)
        register_loop_branches(reg)
        for t in tasks:  # the mixed-tag kernels carry their own names
            reg.register_switch_branch(t.opcode, t.fn)
        runner = DeviceWindowRunner(registry=reg, window_size=WINDOW,
                                    plan_mode="loop", device=device)
        torch.cuda.synchronize()
        rq.reset_launches()  # the main path's count starts here
        t0 = time.perf_counter()
        report = runner.run(tasks)
        walls[f"{label}/device_loop"] = time.perf_counter() - t0
        launches = rq.launches
        got = torch.stack([b.value for b in bufs])
        check(report.loop_executor == "cuda", f"{label}: executor {report.loop_executor}")
        check(launches == 1, f"{label}: {launches} kernel launches for 1 run")
        check(bit_equal(got, expect), f"{label}: device loop != run_serial")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite values")
        log(f"ACS-HW {label}: {len(tasks)} tasks, executor {report.loop_executor}, "
            f"launches {launches}, bit-equal to run_serial; host spans: plan+lower "
            f"{report.plan_seconds * 1e3:.3f} ms, payload {report.payload_seconds * 1e3:.3f} ms, "
            f"pack {report.pack_seconds * 1e3:.3f} ms, kernel+sync "
            f"{report.exec_stats['exec_seconds'] * 1e3:.3f} ms, unpack "
            f"{report.unpack_seconds * 1e3:.3f} ms")
        if label == "chain_universe":
            main_launches = launches
    return main_launches, walls


def phase_acs_sw(device):
    """Returns wall seconds per policy."""
    import torch
    from repro_torch.core import TaskStream, make_scheduler
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    snaps, walls = {}, {}
    # Warm-up: the first pass pays the caching allocator's and the eager
    # kernels' first-call costs, which would otherwise land on "serial".
    warm = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=SIM_ENVS,
                         group_size=SIM_GROUP, seed=1, device=device)
    stream = TaskStream()
    warm.emit_step(stream)
    make_scheduler("serial", device=device)(stream.tasks)
    for policy in ("serial", "wave", "threaded"):
        eng = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=SIM_ENVS,
                            group_size=SIM_GROUP, seed=0, device=device)
        kernels, dispatches, syncs = [], 0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SIM_STEPS):
            stream = TaskStream()
            eng.emit_step(stream)
            run = make_scheduler(policy, window_size=WINDOW,
                                 num_streams=SIM_STREAMS, device=device)
            report = run(stream.tasks)
            kernels.append(len(stream.tasks))
            dispatches += report.exec_stats["dispatches"]
            syncs += report.exec_stats["blocking_syncs"]
        torch.cuda.synchronize()
        walls[f"cheetah/{policy}"] = time.perf_counter() - t0
        snaps[policy] = eng.state_snapshot()
        check(bool(np.isfinite(snaps[policy]).all()), f"{policy}: non-finite state")
        log(f"ACS-SW {policy}: kernels per step {kernels}, dispatches {dispatches}, "
            f"host broadphase reads {eng.stats.host_reads}, blocking stream syncs {syncs}, "
            f"mean wave width {report.mean_wave_width:.2f}")
    for policy in ("wave", "threaded"):
        check(np.array_equal(snaps[policy].view(np.int32), snaps["serial"].view(np.int32)),
              f"{policy} state != serial state")
    log("ACS-SW: serial, wave and threaded states bit-equal and finite")
    return walls


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_numbers(device, launches):
    import torch
    from repro_torch.kernels.ops import LOOP_OPCODES
    from repro_torch.kernels.ready_queue import ready_queue
    from repro_torch.kernels.ref import ready_queue_ref

    _, tasks = chain_universe(device)
    slab, p, branches = lowered_payload(tasks, device)
    got = run_queue(ready_queue, slab, p, branches)
    want = run_queue(ready_queue_ref, slab, p, branches)
    torch.cuda.synchronize()
    max_abs_err = float((got[0] - want[0]).abs().max())
    ms = median_ms(lambda: run_queue(ready_queue, slab, p, branches))
    plain_ms = median_ms(lambda: run_queue(ready_queue_ref, slab, p, branches))

    n, d = len(tasks), slab.shape[1]
    ops_tbl = len(branches) * 4
    in_bytes = slab.numel() * 4 + sum(t.numel() * 4 for t in p.values()) + ops_tbl
    out_bytes = slab.numel() * 4 + n * 4 + (n + 1) * 4  # slab', done, ring
    flops_per_elem = {0: 3, 1: 2}  # axpy: mul, add, add; mul: mul, sub
    spec_of = p["task_tbl"][:, 0].cpu().numpy()
    flops = sum(flops_per_elem[LOOP_OPCODES[branches[s]]] for s in spec_of) * d
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOP_PER_S * 1e3
    # Each task's rows through device memory (the source note's bound).
    rows_ms = n * 3 * d * 4 / HBM_BYTES_PER_S * 1e3
    return {
        "name": "ready_queue",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ready_queue.cu",
        "replaces": "src/repro/kernels/ready_queue.py:47",
        "launches": launches,
        "matches_plain": bit_equal(got[0], want[0]),
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
        "row_traffic_bound_ms": rows_ms,
        "shape": f"slab {tuple(slab.shape)} f32, n {n}, m {p['dep_tbl'].shape[1]}",
    }


def device_busy(fn):
    """Run ``fn()`` once under ``torch.profiler``. Returns (wall ms under
    the profiler, device-busy ms: the union of the CUDA kernels' intervals,
    or None when the profiler records no kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall_ms, None
    busy_us, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return wall_ms, (busy_us + hi - lo) / 1e3


def phase_busy(device, card):
    from repro_torch.core import DeviceOpRegistry, DeviceWindowRunner, TaskStream
    from repro_torch.core import make_scheduler, run_serial
    from repro_torch.kernels.ops import register_loop_branches
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    def chain(policy):
        _, tasks = chain_universe(device)
        if policy == "serial":
            return lambda: run_serial(tasks, device=device)
        reg = DeviceOpRegistry(strict=False)
        register_loop_branches(reg)
        runner = DeviceWindowRunner(registry=reg, window_size=WINDOW, device=device)
        return lambda: runner.run(tasks)

    def cheetah(policy):
        eng = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=SIM_ENVS,
                            group_size=SIM_GROUP, seed=0, device=device)
        run = make_scheduler(policy, window_size=WINDOW, num_streams=SIM_STREAMS,
                             device=device)

        def step():
            stream = TaskStream()
            eng.emit_step(stream)
            run(stream.tasks)
        return step

    for label, make in (("chain_universe/serial", lambda: chain("serial")),
                        ("chain_universe/device_loop", lambda: chain("device_loop")),
                        *((f"cheetah step/{p}", lambda p=p: cheetah(p))
                          for p in ("serial", "wave", "threaded"))):
        wall_ms, busy_ms = device_busy(make())
        busy = ("device busy not measured (no kernel in the trace)" if busy_ms is None
                else f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %)")
        log(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, {busy} [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is missing: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = phase_device()
    phase_build()
    phase_kernel_vs_plain(device)
    launches, hw_walls = phase_acs_hw(device)
    sw_walls = phase_acs_sw(device)
    kernel = phase_numbers(device, launches)
    check(kernel["matches_plain"], "kernel != plain at the main path's shape")
    check(kernel["launches"] >= 1, "the main path launched no ready_queue kernel")

    kind = torch.cuda.get_device_name(0)
    for key, secs in {**hw_walls, **sw_walls}.items():
        log(f"wall {key}: {secs * 1e3:.3f} ms [{card}]")
    phase_busy(device, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
