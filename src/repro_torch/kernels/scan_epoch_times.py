"""Time the RG-LRU scan, the ready queue and the device window's kernel
paths on the card at their main-path shapes, through entry points that
every version of the port has, so that two trees can be compared in one
chip call:

    PYTHONPATH=src python -m repro_torch.kernels.scan_epoch_times [label]

* ``lru_scan`` at recurrentgemma-2b's prefill ``[1, 512, 2560]`` and
  decode ``[1, 1, 2560]``, float32: the CUDA-event median of single
  launches (20, after warm-up), 20 launches back to back (per launch,
  median of 5 rounds), and the kernel's own device time per launch from
  ``torch.profiler`` (20 launches);
* ``ready_queue`` over the chain universe's lowered epoch (below), over
  ONE 32-deep chain and over one task, as the loop runner calls it:
  single launches, back to back and device time (the mean over the
  launches the trace holds), as for the scan (the one chain's device
  time over 32 is the queue's hop, the one task's its fixed cost);
* the chain universe (64 chains x width 4096 f32 x depth 32, window 32:
  ``chip_smoke.py``'s) through ``DeviceWindowRunner`` in the loop, wave
  and frontier plan modes: the median over 7 runs of the report's
  kernel(s)+sync span (``exec_stats["exec_seconds"]``) and of the run's
  wall, and the device time by kernel name of one more run under
  ``torch.profiler``;
* recurrentgemma-2b at its published widths (bf16 weights from seed 0),
  the greedy loop over ``prefill``/``decode_step`` that ``chip_smoke.py``
  holds the servers to: 3 prompts of 128-512 tokens (after one more that
  warms up), 16 new tokens each; median prefill and decode-step times
  (host clock, each step ending in the token's host read).

Prints one JSON object: the label, the card's name and power limit, and
the times in ms. To time another tree, copy this file into its
``src/repro_torch/kernels/`` and run it there. Needs a CUDA card and
``nvcc``.

    PYTHONPATH=src python -m repro_torch.kernels.scan_epoch_times --sweep

times the ready queue's launch shapes instead, each a copy of
``csrc/ready_queue.cu`` with its launch constants changed (built into
``_build/variants/``, as ``tile_sweep.py`` builds its variants): grids of
one block an SM, 66 and 264 blocks x 512 and 256 threads x work-first on
and off x a longest spin backoff of 256, 0 and 2048 ns. Each is checked
against the plain version on the chain universe, then timed over the
chain universe, one 32-deep chain and one task (device time over 20
launches, and the CUDA-event median of single launches), one JSON line
per shape.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

RUNS = 20


def _events_ms(fn: Callable[[], object], runs: int = RUNS, warmup: int = 3) -> float:
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


def _back_to_back_ms(fn: Callable[[], object], launches: int = 20, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _profile(fn: Callable[[], object]):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _device_ms(fn: Callable[[], object]) -> Dict[str, float]:
    """Device time (ms) by kernel name of one ``fn()`` under the profiler."""
    out = {a.key[:80]: a.self_device_time_total / 1e3 for a in _profile(fn).key_averages()
           if a.self_device_time_total > 0}
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:6])


def _chain(device: torch.device, n_chains: int = 64, width: int = 4096, depth: int = 32):
    """``chip_smoke.chain_universe``: per-chain state rows and one shared
    weight row; each chain applies ``depth`` alternating axpy/mul tasks."""
    from ..core import BufferPool, Task
    from ..core.task import default_segments
    from .ops import LOOP_BRANCHES

    rng = np.random.RandomState(0)
    pool = BufferPool(device)
    states = [pool.alloc((width,), np.float32, value=rng.randn(width).astype(np.float32))
              for _ in range(n_chains)]
    weight = pool.alloc((width,), np.float32, value=rng.randn(width).astype(np.float32))
    tasks = []
    for s in states:
        for d in range(depth):
            name = "axpy" if d % 2 == 0 else "mul"
            r, w = default_segments((s, weight), (s,))
            tasks.append(Task(opcode=name, fn=LOOP_BRANCHES[name], inputs=(s, weight),
                              outputs=(s,), read_segments=r, write_segments=w))
    return tasks


def scan_times(device: torch.device) -> Dict[str, object]:
    from .lru_scan import lru_scan

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    out: Dict[str, object] = {}
    for label, s in (("prefill", 512), ("decode", 1)):
        a = torch.rand(1, s, 2560, generator=gen, device=device)
        x = torch.randn(1, s, 2560, generator=gen, device=device)
        h0 = torch.randn(1, 2560, generator=gen, device=device)
        call = lambda: lru_scan(a, x, h0)  # noqa: E731
        kernels = _device_ms(lambda: [call() for _ in range(RUNS)])
        scan = sum(ms for name, ms in kernels.items() if "lru_scan" in name)
        out[label] = {"ms": _events_ms(call), "back_to_back_ms": _back_to_back_ms(call),
                      "device_ms": scan / RUNS if scan else None}
    return out


def _queue_inputs(device: torch.device) -> Dict[str, tuple]:
    """The chain universe's lowered epoch, one 32-deep chain's and one
    task's, as the loop runner hands them to ``ready_queue``: label ->
    (slab, payload, branches)."""
    from ..core import DeviceOpRegistry, SlabArena
    from ..core.device_dispatch import _loop_kernel_parts, lower_epoch_program
    from .ops import register_loop_branches

    out = {}
    for label, n_chains, depth in (("chain_universe", 64, 32), ("one_chain", 1, 32),
                                   ("one_task", 1, 1)):
        tasks = _chain(device, n_chains=n_chains, depth=depth)
        reg = DeviceOpRegistry(strict=False)
        register_loop_branches(reg)
        arena = SlabArena()
        arena.add_tasks(tasks)
        program = lower_epoch_program(tasks, reg, arena)
        cid, branches = _loop_kernel_parts(program, reg, arena)
        out[label] = (arena.pack(device)[cid], program.payload(device), branches)
    return out


def _queue_device_ms(call: Callable[[], object]) -> Optional[float]:
    """The ready-queue kernel's device time over ``RUNS`` calls: the mean
    over the launches the trace holds (a process's later traces can lose
    the first device events of a pass; PERF.md)."""
    hits = [a for a in _profile(lambda: [call() for _ in range(RUNS)]).key_averages()
            if "ready_queue" in a.key]
    count = sum(a.count for a in hits)
    return sum(a.self_device_time_total for a in hits) / 1e3 / count if count else None


def queue_times(device: torch.device) -> Dict[str, object]:
    from .ready_queue import ready_queue

    out: Dict[str, object] = {}
    for label, (slab, p, branches) in _queue_inputs(device).items():
        call = functools.partial(ready_queue, slab, p["task_tbl"], p["dep_tbl"], p["ring0"],
                                 p["rem0"], p["tail0"], branches=branches)
        out[label] = {"ms": _events_ms(call), "back_to_back_ms": _back_to_back_ms(call),
                      "device_ms": _queue_device_ms(call)}
    return out


# The ready queue's launch-shape constants (csrc/ready_queue.cu) and the
# values the sweep tries; the first of each is the committed one.
QUEUE_SHAPES = {"constexpr int kGrid = 0;": (0, 66, 264),
                "constexpr int kThreads = 512;": (512, 256),
                "constexpr bool kWorkFirst = true;": ("true", "false"),
                "constexpr int kSleepNs = 256;": (256, 0, 2048)}


def queue_sweep(device: torch.device) -> None:
    """Each launch shape of QUEUE_SHAPES as a copy of the kernel's source,
    built like the kernel, checked against the plain version on the chain
    universe (slab and done bit-equal) and timed over _queue_inputs."""
    from concurrent.futures import ThreadPoolExecutor

    from . import ready_queue as rq
    from ._nvcc import build
    from .ops import branch_table
    from .ref import ready_queue_ref
    from .tile_sweep import _variant_sources

    variants = {}
    for values in itertools.product(*QUEUE_SHAPES.values()):
        name = "grid{}_threads{}_workfirst_{}_sleep{}".format(*values)
        variants[name] = {line: line.replace(str(QUEUE_SHAPES[line][0]).lower() + ";",
                                             f"{str(v).lower()};")
                          for line, v in zip(QUEUE_SHAPES, values)}
    sources = _variant_sources(rq, variants)
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda src: build(src[1], rq._LIB.flags), sources))
    inputs = _queue_inputs(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    slab, p, branches = inputs["chain_universe"]
    want = ready_queue_ref(slab, p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"],
                           p["tail0"], branches=branches)
    for (name, _), (path, _) in zip(sources, built):
        lib = ctypes.CDLL(str(path))
        rq._bind(lib)

        def launch(slab, p, branches, lib=lib):
            n, m = p["dep_tbl"].shape
            out = slab.clone()
            ring = torch.empty(n + 1, dtype=torch.int32, device=device)
            done = torch.empty(n, dtype=torch.int32, device=device)
            scratch = torch.zeros(rq._HEADER + 3 * n, dtype=torch.int32, device=device)
            rc = lib.acs_ready_queue(
                out.data_ptr(), out.shape[0], out.shape[1], p["task_tbl"].data_ptr(),
                p["dep_tbl"].data_ptr(), n, m, branch_table(branches, device).data_ptr(),
                len(branches), p["ring0"].data_ptr(), p["rem0"].data_ptr(),
                p["tail0"].data_ptr(), ring.data_ptr(), done.data_ptr(), scratch.data_ptr(),
                stream)
            if rc != 0:
                raise RuntimeError(f"scan_epoch_times: {name}: CUDA error {rc}")
            return out, done, scratch

        out, done, scratch = launch(slab, p, branches)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in ((out, want[0]), (done, want[1])))
        if not same:
            raise RuntimeError(f"scan_epoch_times: {name} != plain on the chain universe")
        row: Dict[str, object] = {"variant": name, "grid": int(scratch[rq._GRID_SIZE]),
                                  "blocks_ran": int(scratch[rq._BLOCKS_RAN])}
        for label, args in inputs.items():
            call = functools.partial(launch, *args)
            row[f"{label}_device_ms"] = _queue_device_ms(call)
            row[f"{label}_ms"] = _events_ms(call)
        print(json.dumps(row), flush=True)


def window_times(device: torch.device) -> Dict[str, object]:
    from ..core import DeviceOpRegistry, DeviceWindowRunner
    from .ops import register_loop_branches

    out: Dict[str, object] = {}
    for mode in ("loop", "wave", "frontier"):
        reg = DeviceOpRegistry(strict=False)
        register_loop_branches(reg)
        runner = DeviceWindowRunner(registry=reg, window_size=32, plan_mode=mode,
                                    device=device)
        runner.run(_chain(device))  # warm-up: builds, caches
        exec_ms, wall_ms = [], []
        for _ in range(7):
            tasks = _chain(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = runner.run(tasks)
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            exec_ms.append(report.exec_stats["exec_seconds"] * 1e3)
        tasks = _chain(device)
        out[mode] = {"kernels_sync_ms": statistics.median(exec_ms),
                     "wall_ms": statistics.median(wall_ms),
                     "plan_steps": len(report.waves),
                     "device_ms_by_kernel": _device_ms(lambda: runner.run(tasks))}
    return out


def serve_times(device: torch.device, n_prompts: int = 3, max_new: int = 16) -> Dict[str, float]:
    from ..configs import ARCHS
    from ..models import decode_step, init_cache, init_params, prefill

    cfg = ARCHS["recurrentgemma-2b"]
    params = init_params(cfg, 0, device=device)
    rng = np.random.RandomState(0)
    prefill_ms, decode_ms = [], []
    for n in rng.randint(128, 513, n_prompts + 1):
        cache = init_cache(cfg, 1, 1024, device=device)
        tokens = torch.as_tensor(rng.randint(0, cfg.vocab, (1, int(n))).astype(np.int32),
                                 device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, tokens, cache)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        pos = torch.full((), int(n), dtype=torch.int32, device=device)
        for _ in range(max_new):
            t0 = time.perf_counter()
            logits, cache = decode_step(params, cfg, tok[:, None], cache, pos)
            tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
            pos = pos + 1
            int(tok[0])  # the host read ends the step
            decode_ms.append((time.perf_counter() - t0) * 1e3)
    # the first prompt warms the caches and is not counted
    return {"prefill_ms": statistics.median(prefill_ms[1:]),
            "decode_step_ms": statistics.median(decode_ms[max_new:])}


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_epoch_times: no CUDA device", file=sys.stderr)
        return 2
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    if label == "--sweep":
        print(json.dumps({"card": card}), flush=True)
        queue_sweep(device)
        return 0
    print(json.dumps({"label": label, "card": card, "scan": scan_times(device),
                      "queue": queue_times(device), "window": window_times(device),
                      "recurrentgemma": serve_times(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
