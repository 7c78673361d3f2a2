"""Time the RG-LRU scan and the device window's wave-kernel path on the
card at their main-path shapes, through entry points that every version
of the port has, so that two trees can be compared in one chip call:

    PYTHONPATH=src python -m repro_torch.kernels.scan_epoch_times [label]

* ``lru_scan`` at recurrentgemma-2b's prefill ``[1, 512, 2560]`` and
  decode ``[1, 1, 2560]``, float32: the CUDA-event median of single
  launches (20, after warm-up), 20 launches back to back (per launch,
  median of 5 rounds), and the kernel's own device time per launch from
  ``torch.profiler`` (20 launches);
* the chain universe (64 chains x width 4096 f32 x depth 32, window 32:
  ``chip_smoke.py``'s) through ``DeviceWindowRunner`` in the wave and
  frontier plan modes: the median over 7 runs of the report's
  kernels+sync span (``exec_stats["exec_seconds"]``) and of the run's
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
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict

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


def _device_ms(fn: Callable[[], object]) -> Dict[str, float]:
    """Device time (ms) by kernel name of one ``fn()`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {a.key[:80]: a.self_device_time_total / 1e3 for a in prof.key_averages()
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


def window_times(device: torch.device) -> Dict[str, object]:
    from ..core import DeviceOpRegistry, DeviceWindowRunner
    from .ops import register_loop_branches

    out: Dict[str, object] = {}
    for mode in ("wave", "frontier"):
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
    print(json.dumps({"label": label, "card": card, "scan": scan_times(device),
                      "window": window_times(device),
                      "recurrentgemma": serve_times(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
