#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each fatal on failure (an exception, exit code != 0):

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: the five CUDA kernels (ready queue, wave megakernel, flash
   attention, RG-LRU scan, grouped GEMM) from the sources in this
   checkout, one ``nvcc`` each, all started together; each one's build
   seconds and, from ``ptxas -v``, each kernel's registers, static shared
   memory and spills.
3. Kernel vs plain, on the card:
   a. ready queue: the kernel's slab and completion flags bit-equal to
      ``ready_queue_ref``, and its ring a start order (a permutation of
      the tasks and a topological order of the edges; a concurrent queue
      does not fix the order), on random DAG streams (n from 1 to 8,192,
      m up to ~200), the chain universe, one chain 2,048 deep (every
      earlier task an upstream, and one), one task with 1,000 dependents;
      on 14 kinds of corrupted tables nothing runs and the ring is
      ``ring0``, as in the plain version; 20 launches of one random DAG
      give the same bits;
   b. wave megakernel: bit-equal to ``wave_rows_ref`` over S in
      {1, 7, 32, 64} x D in {1, 37, 4096} (repeated input rows, a slot
      reading its own out row); a bad descriptor raises. Its epoch entry
      ``wave_epoch`` (one cooperative launch for a whole plan): bit-equal
      to the plain step loop over random 40-step plans (self-reads, reads
      of another slot's out row) at D in {37, 4096}, staged and with the
      direct steps unstaged, and over steps wider than the co-resident
      grid; a bad descriptor in a middle step raises at the check, and
      every other slot and step still ran;
   c. ``lru_scan``: bit-equal to ``lru_scan_ref`` for B in {1, 4, 8},
      S in {1, 37, 63, 64, 65, 512, 2048}, D in {2560, 1000, 7}, float32
      and bfloat16 (both channel tiles, the 64-step time tile's edges,
      element copies);
   d. ``flash_attention``: within tolerance of ``attention_ref`` (float32
      1e-4, bfloat16 2e-2) at the recurrentgemma-2b, h2o-danube-3-4b and
      granite-moe-3b-a800m prefill shapes and at the edges of the kernel's
      64-row and 64-key tiles: Sq and Sk of 65, 127, 333 and 2500,
      D in {8, 24, 64, 120, 128, 256}, the window edge and ``prefix_len``
      inside a tile, softcap, decode (Sq = 1) and fully masked rows
      (exactly 0, a whole query tile of them included); the same bits on a
      second launch;
   e. ``grouped_matmul``: within tolerance of ``grouped_matmul_ref``
      (float32 1e-4, float16 and bfloat16 8e-3: one bfloat16 ulp) over the
      reference's ragged cases (N off the tile, groups with no tile),
      ``block_m`` in {1, 2, 15, 16, 17, 63, 64, 65, 70, 128} (both tile
      shapes and their edges), K and N off the 16-byte copy width and the
      ring's tile widths, and granite-moe's decode and prefill expert
      products, in float32, float16 and bfloat16; the same bits on a
      second launch; a bad group id raises;
   f. the expert-wave stream of ``benchmarks/bench_moe_waves.py`` (8
      experts, top-2, D 64, d_expert 32, 64 tokens routed from seed 0,
      tiles of 8) through ``run_serial``, ``WaveScheduler`` and the wave
      device window's step path: bit-equal, with an exactly rounded task
      fn and with the benchmark's own ``a @ b`` (on the card a
      contraction's group runs task by task; both fns' dispatch counts
      logged); one
      ``grouped_matmul`` launch over its ragged tiles within 1e-4 of the
      tasks' outputs.
4. ACS-HW main paths, each bit-equal to ``run_serial`` on the card: the
   chain universe (64 chains x width 4096 x depth 32, 2,048 tasks) and the
   24-task mixed-tag hazard stream through
   a. ``DeviceWindowRunner(plan_mode="loop")`` on the ready-queue kernel
      (one launch);
   b. ``DeviceWindowRunner(plan_mode="wave")`` and ``("frontier")`` on the
      wave kernel (``wave_executor == "cuda"``, one epoch launch per run
      whose steps equal the plan's; wave widths and
      ``plan_active_fraction`` logged), and the cheetah
      stream (64 envs, 8 groups, 2 steps) through both modes on the step
      path;
   c. ``DeviceSession`` under each plan mode, the chain universe fed in 4
      interleaved chunks (loop epochs launch the ready-queue kernel, wave
      and frontier epochs the wave kernel: one launch per device
      dispatch, its steps equal to the plan steps).
5. ACS-SW main path: the cheetah physics stream (64 envs, 8 groups,
   5 steps) through the serial, wave and threaded (4 CUDA streams)
   schedulers, bit-equal across the three and finite.
6. Serving main paths, one model after the other (the first one's
   weights freed before the second's are drawn), each at its published
   config with bf16 weights drawn from seed 0: recurrentgemma-2b (26
   layers, d_model 2560), then granite-moe-3b-a800m (32 attention layers
   with MoE FFNs, d_model 1536, 40 experts padded to 48, top-8). Each
   serves 8 seeded prompts of 128-512 tokens, 16 new tokens each, through
   ``SessionServer(scheduler="wave")``, ``SessionServer(scheduler="device")``
   (its ``"loop"`` plan mode; every serving task takes the session's
   in-epoch host path) and ``ContinuousBatchingServer`` (4 slots, max_len
   1024, window 32). Every request gets its 16 tokens, the three servers'
   tokens are identical and equal a plain greedy loop over
   ``prefill``/``decode_step``, every logit is finite, and each server run
   launches exactly: the flash kernel once per request and attention layer
   (recurrentgemma 64, granite 256), the scan once per RG-LRU layer and
   prefill or decode (2,448; granite 0) and the grouped GEMM three times
   per MoE layer and prefill or decode (granite 13,056; recurrentgemma 0).
   After each model's server runs, one more serving pass (2 requests)
   runs under ``torch.profiler`` for its device busy share (as in 8).
7. Numbers: CUDA-event medians of each kernel and its plain version at
   its main path's shape (the wave kernel's epoch entry over the chain
   universe's wave and frontier plans, staged and direct, and its
   single-wave entry at the widest wave and at S = 32; SDPA for attention
   and ``torch.bmm`` for the grouped GEMM as the library calls; flash at
   both serving models' prefills), flash, the grouped GEMM, the scan
   (prefill and decode) and the ready queue also 20 launches back to
   back, each kernel's bound, and the wall time of each phase-4/5/6
   policy and server. The ready queue also: its device time from
   ``torch.profiler`` (the mean over the kernels the trace holds), that
   of ONE 32-deep chain (over 32: the hop that bounds it) and of one
   task, its grid and the blocks that ran tasks.
8. Device busy share, run after phase 5 and before phase 6: one more
   pass of each phase-4/5 policy under ``torch.profiler``; the union of
   the CUDA kernels' intervals over the pass's wall ("not measured" if the
   profiler records no kernel), and whether the loop and wave passes' own
   kernels are in the trace. After phase 6's profiled serving passes
   (58k and 130k kernels), a trace in the same process loses the first
   device events of a pass (the loop pass's ready-queue kernel among
   them): one more loop pass is profiled at the end to show it.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet): device memory rate, the fp32 rate
# outside the tensor cores and the dense bf16 tensor-core rate, for each
# kernel's least possible time.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

CHAINS, WIDTH, DEPTH, WINDOW = 64, 4096, 32, 32
SIM_ENVS, SIM_GROUP, SIM_STEPS, SIM_STREAMS = 64, 8, 5, 4
TIMED_RUNS = 20

# The serving passes: recurrentgemma-2b, then granite-moe-3b-a800m, at
# their published widths.
SERVE_ARCHS, SERVE_SEED = ("recurrentgemma-2b", "granite-moe-3b-a800m"), 0
SERVE_REQUESTS, SERVE_MIN_PROMPT, SERVE_MAX_PROMPT, SERVE_MAX_NEW = 8, 128, 512, 16
SERVE_SLOTS, SERVE_MAX_LEN = 4, 1024


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


# The expert-wave stream of benchmarks/bench_moe_waves.py: 8 experts,
# top-2, d_model 64, d_expert 32, 64 tokens routed from the seed, token
# tiles of 8 rows.
MOE_E, MOE_TOP_K, MOE_D, MOE_DE, MOE_T, MOE_BM = 8, 2, 64, 32, 64, 8


def expert_gemm(a, b):
    return a @ b


def expert_gemm_exact(a, b):
    """``a @ b`` as K rank-1 updates, each multiply and add its own eager
    elementwise kernel: it rounds alike whether the wave executor batches
    it (``vmap``) or not. A library GEMM does not: on the H100 cuBLAS's
    batched product sums in another order than its single one."""
    out = a[:, 0:1] * b[0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[:, k:k + 1] * b[k:k + 1, :]
    return out


def build_expert_stream(device, seed=0, fn=expert_gemm):
    """One task per (expert, token tile) of a routed token batch: the
    paper-style small kernels of an MoE layer, with input-dependent
    assignment; each task computes ``fn(x tile, w[e])``. Returns (tasks,
    (xs [tiles, BM, D], w [E, D, De], tile group ids), output buffers)."""
    from repro_torch.core import BufferPool, Task, TaskStream
    from repro_torch.core.task import default_segments

    rng = np.random.RandomState(seed)
    probs = rng.rand(MOE_T, MOE_E)
    top = np.argsort(-probs, axis=1)[:, :MOE_TOP_K]
    x = rng.randn(MOE_T, MOE_D).astype(np.float32)
    w = rng.randn(MOE_E, MOE_D, MOE_DE).astype(np.float32)

    # sort token slots by expert, pad each expert's rows to whole tiles
    flat = sorted((int(top[t, k]), t) for t in range(MOE_T) for k in range(MOE_TOP_K))
    tiles, rows = [], []
    for e in range(MOE_E):
        toks = [t for ee, t in flat if ee == e]
        for i in range(0, len(toks), MOE_BM):
            chunk = toks[i:i + MOE_BM]
            tiles.append(e)
            rows.append(chunk + [0] * (MOE_BM - len(chunk)))
    xs = np.stack([x[r] for r in rows])  # [tiles, BM, D]

    pool = BufferPool(device)
    stream = TaskStream()
    wbufs = [pool.alloc((MOE_D, MOE_DE), np.float32, value=w[e]) for e in range(MOE_E)]
    outs = []
    for i, e in enumerate(tiles):
        xb = pool.alloc((MOE_BM, MOE_D), np.float32, value=xs[i])
        ob = pool.alloc((MOE_BM, MOE_DE), np.float32,
                        value=np.zeros((MOE_BM, MOE_DE), np.float32))
        outs.append(ob)
        r, wseg = default_segments((xb, wbufs[e]), (ob,))
        stream.push(Task(opcode="expert_gemm", fn=fn, inputs=(xb, wbufs[e]),
                         outputs=(ob,), read_segments=r, write_segments=wseg,
                         cost_flops=2 * MOE_BM * MOE_D * MOE_DE,
                         cost_bytes=4 * (MOE_BM * MOE_D + MOE_D * MOE_DE + MOE_BM * MOE_DE)))
    return stream.tasks, (xs, w, np.asarray(tiles, np.int32)), outs


def run_queue(fn, slab, p, branches):
    return fn(slab, p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"], p["tail0"],
              branches=branches)


def queue_tables(device, slab, tasks, dependents):
    """The ready queue's arguments for an epoch written by hand: ``tasks``
    holds each task's ``(branch, in0, in1, out)`` over ``slab``'s rows (the
    branches are ``wave_branches()``), ``dependents[t]`` the later tasks
    that wait for task ``t``. Returns (slab, payload, branches)."""
    import torch

    n = len(tasks)
    dep = np.full((n, max([1] + [len(d) for d in dependents])), n, np.int32)
    for t, ds in enumerate(dependents):
        dep[t, :len(ds)] = ds
    rem = np.zeros(n + 1, np.int32)
    np.add.at(rem, dep[dep < n], 1)
    ready = np.flatnonzero(rem[:n] == 0)
    ring = np.full(n + 1, n, np.int32)
    ring[:len(ready)] = ready
    task_tbl = np.array([(b, i0, i1, i0, o) for b, i0, i1, o in tasks], np.int32)
    payload = {k: torch.from_numpy(np.asarray(v, np.int32)).to(device)
               for k, v in (("task_tbl", task_tbl), ("dep_tbl", dep), ("ring0", ring),
                            ("rem0", rem), ("tail0", [len(ready)]))}
    return slab.to(device), payload, wave_branches()


def _state_and_weight(seed, rows, width):
    """``rows`` random rows, the second of which is a weight in (-0.6, 0.6):
    a chain x -> (1.5 x + w + 1) w - 0.5 then stays finite however deep."""
    import torch

    rng = np.random.RandomState(seed)
    slab = rng.randn(rows, width).astype(np.float32)
    slab[1] = rng.uniform(-0.6, 0.6, width)
    return torch.from_numpy(slab)


def serial_chain(device, depth, width=WIDTH, all_edges=True, seed=0):
    """One chain of ``depth`` tasks on one state row (row 0), each reading
    the weight row (row 1): pure serial work. With ``all_edges`` every task
    waits for every earlier one, as the lowering's exact upstream sets
    give (task k has in-degree k); else each waits for the one before."""
    tasks = [(k % 2, 0, 1, 0) for k in range(depth)]
    dependents = [np.arange(k + 1, depth if all_edges else min(k + 2, depth))
                  for k in range(depth)]
    return queue_tables(device, _state_and_weight(seed, 2, width), tasks, dependents)


def fan_out(device, fan, width=WIDTH, seed=0):
    """Task 0 writes row 0; ``fan`` tasks each read it and write a row of
    their own: one task with ``fan`` dependents (more than a warp's 32
    lanes retire in one round)."""
    tasks = [(0, 0, 1, 0)] + [(i % 2, 0, 1, 1 + i) for i in range(1, fan + 1)]
    dependents = [np.arange(1, fan + 1)] + [()] * fan
    return queue_tables(device, _state_and_weight(seed, fan + 2, width), tasks, dependents)


def corrupt_tables(kind, slab, p, n_branches):
    """A copy of the ready queue's payload ``p`` with one fault of ``kind``
    (``CORRUPTIONS``); returns (payload, words of the message of
    ``ready_queue_tables_error`` that names it). ``"bad_in2"`` is the one
    harmless kind: no branch reads in2."""
    q = {k: v.clone() for k, v in p.items()}
    n, rows = q["dep_tbl"].shape[0], slab.shape[0]
    waiting = int((q["rem0"][:n] > 0).nonzero()[0])
    t, j = (q["dep_tbl"] < n).nonzero()[0].tolist()
    if kind == "bad_in2":
        q["task_tbl"][:, 3] = rows + 5
        return q, None
    if kind == "dropped_edge":
        q["dep_tbl"][t, j] = n  # the dependent keeps its count: it never wakes
        return q, "in-degrees"
    if kind == "extra_count":
        q["rem0"][waiting] += 1
        return q, "in-degrees"
    if kind in ("bad_in0", "bad_in1", "bad_out"):
        col, bad = {"bad_in0": (1, rows), "bad_in1": (2, -1), "bad_out": (4, rows + 5)}[kind]
        q["task_tbl"][waiting, col] = bad
        return q, "row outside"
    if kind == "bad_branch":
        q["task_tbl"][waiting, 0] = n_branches
        return q, "branch outside"
    if kind in ("negative_edge", "edge_past_n", "backward_edge", "self_edge"):
        q["dep_tbl"][t, j] = {"negative_edge": -7, "edge_past_n": n + 3,
                              "backward_edge": max(t - 1, 0), "self_edge": t}[kind]
        return q, "point forward"
    if kind == "ring_lists_a_waiting_task":
        q["ring0"][0] = waiting
    elif kind == "ring_duplicate":
        q["ring0"][1] = q["ring0"][0]
    elif kind == "tail_short":
        q["tail0"][0] -= 1
    else:
        check(kind == "tail_past_n", f"unknown corruption {kind}")
        q["tail0"][0] = n + 1
        return q, "tail0"
    return q, "ring0"


CORRUPTIONS = ("dropped_edge", "extra_count", "bad_in0", "bad_in1", "bad_out", "bad_branch",
               "negative_edge", "edge_past_n", "backward_edge", "self_edge",
               "ring_lists_a_waiting_task", "ring_duplicate", "tail_short", "tail_past_n")


def is_start_order(ring, dep_tbl) -> bool:
    """The kernel's ``ring``: ``ring[:n]`` a permutation of the tasks and a
    topological order of ``dep_tbl`` (every live edge from an earlier to a
    later place), ``ring[n] == n``."""
    n = dep_tbl.shape[0]
    r = ring.cpu().numpy()
    order = r[:n]
    if r[n] != n or not np.array_equal(np.sort(order), np.arange(n)):
        return False
    where = np.empty(n, np.int64)
    where[order] = np.arange(n)
    dep = dep_tbl.cpu().numpy()
    t, j = np.nonzero(dep < n)
    return bool((where[t] < where[dep[t, j]]).all())


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
    """Build every kernel of the port, one nvcc each, started together."""
    from repro_torch.kernels import (flash_attention, grouped_matmul, lru_scan, ready_queue,
                                     wave_elementwise)
    from repro_torch.kernels._nvcc import resources

    mods = (ready_queue, wave_elementwise, flash_attention, lru_scan, grouped_matmul)
    with ThreadPoolExecutor(len(mods)) as pool:
        built = list(pool.map(lambda m: m.build(), mods))
    for mod, (path, seconds) in zip(mods, built):
        log(f"build: {mod.SOURCE.name} -> {path.name} in {seconds:.2f} s (sm_90a)")
        for line in resources(path):
            log(f"ptxas: {mod.SOURCE.name}: {line}")


def queue_vs_plain(label, slab, p, branches):
    """The ready-queue kernel against its plain version on one epoch: slab
    and ``done`` bit-equal; a valid epoch drains with its ``ring`` a start
    order, a faulty one runs nothing and returns ``ring0``. Returns the
    kernel's outputs."""
    import torch
    from repro_torch.kernels.ready_queue import ready_queue
    from repro_torch.kernels.ref import ready_queue_ref, ready_queue_tables_error

    got = run_queue(ready_queue, slab, p, branches)
    torch.cuda.synchronize()
    want = run_queue(ready_queue_ref, slab, p, branches)
    torch.cuda.synchronize()
    for name, g, w in zip(("slab", "done"), got, want):
        check(bit_equal(g, w), f"ready queue: kernel != plain on {name} ({label})")
    valid = ready_queue_tables_error(p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"],
                                     p["tail0"], rows=slab.shape[0], branches=branches) is None
    if valid:
        check(bool(got[1].all()), f"ready queue: did not drain ({label})")
        check(is_start_order(got[2], p["dep_tbl"]), f"ready queue: ring is no start order "
                                                    f"({label})")
    else:
        check(not bool(got[1].any()) and bit_equal(got[2], p["ring0"]),
              f"ready queue: faulty tables ran tasks or moved the ring ({label})")
    return got


def launched(rq):
    stats = rq.launch_stats()
    return f"{stats['blocks_ran']} of {stats['blocks']} blocks ran tasks"


def phase_kernel_vs_plain(device):
    from repro_torch.kernels import ready_queue as rq

    for seed in range(3):
        for n, d in ((1, 8), (64, 128), (512, 1024), (2048, 4096), (8192, 256)):
            slab, p, branches = random_dag(device, seed, n, d)
            queue_vs_plain(f"random DAG seed {seed} n {n} d {d}", slab, p, branches)
            log(f"ready queue == plain: random DAG seed {seed} n {n} d {d} m "
                f"{p['dep_tbl'].shape[1]}, {launched(rq)}")
    slab, p, branches = random_dag(device, 0, 200, 64)
    for kind in CORRUPTIONS + ("bad_in2",):
        queue_vs_plain(f"corrupted: {kind}", slab, corrupt_tables(kind, slab, p,
                                                                  len(branches))[0], branches)
    log(f"ready queue == plain on {len(CORRUPTIONS)} corrupted tables (nothing ran, ring == "
        "ring0) and with a corrupted in2 (everything ran)")
    _, tasks = chain_universe(device)
    cases = {"chain universe (64 chains x 32)": lowered_payload(tasks, device),
             "one chain 2048 deep, every edge": serial_chain(device, 2048),
             "one chain 2048 deep, one edge a task": serial_chain(device, 2048, all_edges=False),
             "fan-out: one task, 1000 dependents": fan_out(device, 1000, width=256)}
    for label, (slab, p, branches) in cases.items():
        queue_vs_plain(label, slab, p, branches)
        log(f"ready queue == plain: {label}: n {p['dep_tbl'].shape[0]} m "
            f"{p['dep_tbl'].shape[1]}, {launched(rq)}")
    slab, p, branches = random_dag(device, 4, 2048, 4096)
    first = queue_vs_plain("random DAG n 2048, launch 1 of 20", slab, p, branches)
    for i in range(19):
        got = run_queue(rq.ready_queue, slab, p, branches)
        check(bit_equal(got[0], first[0]) and bit_equal(got[1], first[1]),
              f"ready queue: launch {i + 2} of 20 gave other bits")
    log("ready queue: 20 launches of one random DAG (n 2048) gave the same bits")


WAVE_SWEEP_S, WAVE_SWEEP_D = (1, 7, 32, 64), (1, 37, 4096)


def wave_branches():
    from repro_torch.kernels.ops import LOOP_BRANCHES

    return (LOOP_BRANCHES["axpy"], LOOP_BRANCHES["mul"])


def random_wave(device, seed, s, d):
    """A random wave of ``s`` slots over ``s + 5`` rows of width ``d``:
    unique out rows, every slot's second input the same row, slot 0 reading
    its own out row. Returns (slab, desc)."""
    import torch

    rng = np.random.RandomState(seed)
    r = s + 5
    slab = torch.from_numpy(rng.randn(r, d).astype(np.float32)).to(device)
    ops = rng.randint(0, 2, s)
    ins = rng.randint(0, r, (s, 2))
    outs = rng.choice(r, s, replace=False)
    ins[:, 1] = ins[0, 0]
    ins[0, 0] = outs[0]
    desc = np.concatenate([ops[:, None], ins, outs[:, None]], axis=1).astype(np.int32)
    return slab, torch.from_numpy(desc).to(device)


def phase_wave_vs_plain(device):
    import torch
    from repro_torch.kernels.ref import wave_rows_ref
    from repro_torch.kernels.wave_elementwise import wave_elementwise

    br = wave_branches()
    for s in WAVE_SWEEP_S:
        for d in WAVE_SWEEP_D:
            slab, desc = random_wave(device, s * 100 + d, s, d)
            got = wave_elementwise(slab, desc, branches=br)
            want = wave_rows_ref(slab, desc, br)
            torch.cuda.synchronize()
            check(bit_equal(got, want), f"wave kernel != plain (S {s}, D {d})")
    desc[-1, 2] = 10 ** 6
    try:
        wave_elementwise(slab, desc, branches=br)
    except ValueError as exc:
        log(f"wave kernel: a bad descriptor raises ({exc})")
    else:
        check(False, "wave kernel: a descriptor row outside the slab did not raise")
    log(f"wave kernel == plain, bit for bit: S {set(WAVE_SWEEP_S)} x D {set(WAVE_SWEEP_D)}, "
        "float32")
    phase_epoch_vs_plain(device)


def random_plan(seed, n_steps, d, rows=48, min_slots=1, max_slots=6):
    """A random plan of ``n_steps`` steps over a ``[rows, d]`` slab: unique
    out rows per step, a step's first slot reading its own out row or
    another slot's. Returns (slab [host], desc [host], offsets)."""
    rng = np.random.RandomState(seed)
    slab = (rng.randn(rows, d) * 0.5).astype(np.float32)
    descs, offsets = [], [0]
    for _ in range(n_steps):
        s = rng.randint(min_slots, max_slots + 1)
        outs = rng.choice(rows, s, replace=False)
        ins = rng.randint(0, rows, (s, 2))
        kind = rng.randint(3)
        if kind == 1:
            ins[0, 0] = outs[0]
        elif kind == 2 and s > 1:
            ins[0, 1] = outs[1]
        ops = rng.randint(0, 2, s)
        descs.append(np.concatenate([ops[:, None], ins, outs[:, None]], axis=1))
        offsets.append(offsets[-1] + s)
    return slab, np.concatenate(descs).astype(np.int32), offsets


def plain_epoch(slab, desc, offsets, branches):
    """The epoch's plain version on any device, in place: each step's
    ``wave_rows_ref`` rows scattered to their out rows, step after step."""
    from repro_torch.kernels.ref import wave_rows_ref

    for lo, hi in zip(offsets[:-1], offsets[1:]):
        slab[desc[lo:hi, 3].long()] = wave_rows_ref(slab, desc[lo:hi], branches)
    return slab


def phase_epoch_vs_plain(device):
    import torch
    from repro_torch.kernels import wave_elementwise as we

    br = wave_branches()
    cases = [(seed, 40, d, {}) for seed in range(3) for d in (37, 4096)]
    cases += [(5, 3, 4096, {"rows": 2516, "min_slots": 1250, "max_slots": 2500})]
    for seed, n_steps, d, kw in cases:
        slab_np, desc_np, offsets = random_plan(seed, n_steps, d, **kw)
        desc = torch.from_numpy(desc_np).to(device)
        want = plain_epoch(torch.from_numpy(slab_np).to(device), desc, offsets, br)
        direct = we.direct_steps(desc_np, offsets)
        for marks in (None, direct):
            slab = torch.from_numpy(slab_np).to(device)
            we.wave_epoch(slab, desc, offsets, branches=br, direct=marks)
            torch.cuda.synchronize()
            check(bit_equal(slab, want), f"wave epoch != plain (seed {seed}, D {d}, "
                                         f"{'direct marks' if marks else 'staged'})")
        log(f"wave epoch == plain, bit for bit: {n_steps} steps of up to "
            f"{max(np.diff(offsets))} slots, D {d}, staged and with {sum(direct)} direct steps")
    slab_np, desc_np, offsets = random_plan(9, 12, 64)
    k = offsets[6]
    want = plain_epoch(torch.from_numpy(slab_np).to(device),
                       torch.from_numpy(np.delete(desc_np, k, axis=0)).to(device),
                       [o - (o > k) for o in offsets], br)
    desc_np[k, 3] = 10 ** 6
    desc = torch.from_numpy(desc_np).to(device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    slab = torch.from_numpy(slab_np).to(device)
    we.wave_epoch(slab, desc, offsets, branches=br, err=err)
    try:
        we.raise_on_error(err)
    except ValueError as exc:
        log(f"wave epoch: a bad descriptor in step 6 of 12 raises at the check ({exc})")
    else:
        check(False, "wave epoch: a bad descriptor in a middle step did not raise")
    check(bit_equal(slab, want), "wave epoch: the slots and steps around a bad descriptor "
                                 "did not all run")


def _int_bits(t):
    import torch

    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def phase_lru_vs_plain(device):
    import torch
    from repro_torch.kernels.lru_scan import lru_scan
    from repro_torch.kernels.ref import lru_scan_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    sweep_b, sweep_s, sweep_d = (1, 4, 8), (1, 37, 63, 64, 65, 512, 2048), (2560, 1000, 7)
    for d in sweep_d:
        for b in sweep_b:
            for s in sweep_s:
                for dtype in (torch.float32, torch.bfloat16):
                    a = torch.rand(b, s, d, generator=gen, device=device).to(dtype)
                    x = torch.randn(b, s, d, generator=gen, device=device).to(dtype)
                    h0 = torch.randn(b, d, generator=gen, device=device)
                    got = lru_scan(a, x, h0)
                    want = lru_scan_ref(a, x, h0)
                    torch.cuda.synchronize()
                    check(torch.equal(_int_bits(got), _int_bits(want)),
                          f"lru_scan kernel != plain (B {b}, S {s}, D {d}, {dtype})")
    log(f"lru_scan kernel == plain, bit for bit: B {set(sweep_b)} x S {set(sweep_s)} x D "
        f"{set(sweep_d)}, float32 and bfloat16")


# (b, h, hkv, sq, sk, d), attention flags: the serving shapes, then the
# edges of the bfloat16 kernel's tiles (64 query rows, 64 keys; D padded
# to 64, 128 or 256 in shared memory, 16-byte copies only for
# D % 8 == 0).
FLASH_SWEEP = [
    *(((1, 10, 1, s, s, 256), {"window": 2048}) for s in (64, 333, 512, 2048, 2500)),
    *(((1, 32, 8, s, s, 120), {"window": 4096}) for s in (64, 333, 512)),
    ((1, 10, 1, 300, 300, 256), {"window": 2048, "softcap": 30.0}),
    ((1, 10, 1, 300, 300, 256), {"window": 64, "prefix_len": 17}),
    ((1, 10, 1, 1, 1024, 256), {"window": 2048, "q_offset": 1023}),
    ((1, 32, 8, 1, 777, 120), {"window": 4096, "q_offset": 776}),
    ((1, 10, 1, 40, 40, 256), {"q_offset": -8}),  # rows 0-7 see no key
    *(((1, 24, 8, s, s, 64), {}) for s in (128, 512)),  # granite-moe, causal
    ((1, 24, 8, 1, 1024, 64), {"q_offset": 1023}),
    ((1, 4, 2, 65, 65, 64), {}),  # one row and one key past a tile
    ((1, 4, 1, 127, 127, 128), {"window": 50}),  # the window edge inside tiles
    ((2, 4, 2, 333, 333, 24), {}),  # element loads, D padded to 64
    ((1, 8, 8, 100, 100, 8), {"causal": False}),
    ((1, 4, 2, 130, 200, 64), {"q_offset": 70, "prefix_len": 100}),  # prefix past a tile
    ((1, 2, 1, 127, 2500, 128), {"q_offset": 2373, "window": 300, "softcap": 20.0}),
    ((1, 4, 4, 1, 2500, 128), {"q_offset": 2499, "window": 300}),
    ((1, 4, 2, 70, 70, 64), {"q_offset": -66}),  # a whole query tile sees no key
]
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def phase_flash_vs_plain(device):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for (b, h, hkv, sq, sk, d), flags in FLASH_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, h, sq, d, generator=gen, device=device).to(dtype)
            k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
            v = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
            got = flash_attention(q, k, v, **flags)
            want = attention_ref(q, k, v, **flags)
            torch.cuda.synchronize()
            tol = FLASH_TOL[str(dtype).replace("torch.", "")]
            err = (got.float() - want.float()).abs()
            bound = tol + tol * want.float().abs()
            check(bool((err <= bound).all()),
                  f"flash_attention != plain at {(b, h, hkv, sq, sk, d)} {flags} {dtype}: "
                  f"max abs err {float(err.max())}")
            if flags.get("q_offset", 0) < 0:
                check(bool((got[:, :, :-flags["q_offset"]] == 0).all()),
                      "flash_attention: a fully masked row is not 0")
            check(torch.equal(flash_attention(q, k, v, **flags), got),
                  "flash_attention: a second launch gave other bits")
            log(f"flash_attention ~ plain: {(b, h, hkv, sq, sk, d)} {flags} "
                f"{str(dtype).replace('torch.', '')} max abs err {float(err.max()):.3g}")


# (G, K, N, block_m, tile group ids): the reference's ragged cases
# (tests/test_kernels.py: N off the tile, groups 1, 3, 5, 6 with no tile),
# block_m at both tile shapes' edges (16-row tiles up to 16, 64 up to 64,
# 128 above), K and N off the 16-byte copy width (8 elements) and the
# ring's widths (BK 64 / 32, BN 64 / 128), block_m = 1 at M = 48, and
# granite-moe's expert products (48 experts; decode C = 1, a 512-token
# prefill C = 128).
GMM_SWEEP = {
    "ragged_g2": (2, 16, 16, 8, (0, 1)),
    "ragged_g4": (4, 32, 48, 8, (0, 0, 1, 2, 2, 3)),
    "ragged_g8_n24": (8, 64, 24, 16, (0, 2, 2, 4, 7)),
    "k37_n131_bm70": (3, 37, 131, 70, (2, 0, 2)),
    "k13_n11_bm1": (3, 13, 11, 1, (2, 0, 1, 1)),
    "k96_n80_bm2": (8, 96, 80, 2, (0, 3, 3, 7, 1)),
    "k40_n72_bm15": (4, 40, 72, 15, (1, 0, 3)),
    "k128_n136_bm16": (5, 128, 136, 16, (4, 2, 2, 0)),
    "k200_n24_bm17": (3, 200, 24, 17, (2, 2, 0)),
    "k72_n264_bm63": (6, 72, 264, 63, (5, 1, 1, 3)),
    "k1000_n128_bm64": (4, 1000, 128, 64, (3, 3, 0)),
    "k52_n40_bm65": (3, 52, 40, 65, (1, 2)),
    "k136_n200_bm128": (6, 136, 200, 128, (5, 0, 5)),
    "bm1_m48": (48, 256, 96, 1, tuple(range(48))),
    "granite_decode_gate": (48, 1536, 512, 1, tuple(range(48))),
    "granite_decode_down": (48, 512, 1536, 1, tuple(range(48))),
    "granite_prefill_gate": (48, 1536, 512, 128, tuple(range(48))),
    "granite_prefill_down": (48, 512, 1536, 128, tuple(range(48))),
}
GMM_TOL = {"float32": 1e-4, "float16": 8e-3, "bfloat16": 8e-3}


def gmm_inputs(device, gen, g, k, n, bm, tiles, dtype):
    import torch

    x = torch.randn(len(tiles) * bm, k, generator=gen, device=device).to(dtype)
    w = torch.randn(g, k, n, generator=gen, device=device).to(dtype)
    return x, w, torch.tensor(tiles, dtype=torch.int32, device=device)


def phase_gmm_vs_plain(device):
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ref import grouped_matmul_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    for name, (g, k, n, bm, tiles) in GMM_SWEEP.items():
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            x, w, tg = gmm_inputs(device, gen, g, k, n, bm, tiles, dtype)
            got = grouped_matmul(x, w, tg, block_m=bm)
            want = grouped_matmul_ref(x, w, tg, block_m=bm)
            torch.cuda.synchronize()
            tol = GMM_TOL[str(dtype).replace("torch.", "")]
            err = (got.float() - want.float()).abs()
            check(got.dtype == dtype and bool((err <= tol + tol * want.float().abs()).all()),
                  f"grouped_matmul != plain at {name} {dtype}: max abs err {float(err.max())}")
            check(torch.equal(grouped_matmul(x, w, tg, block_m=bm), got),
                  f"grouped_matmul: a second launch gave other bits at {name} {dtype}")
            log(f"grouped_matmul ~ plain: {name} G {g} K {k} N {n} block_m {bm} M "
                f"{len(tiles) * bm} {str(dtype).replace('torch.', '')} max abs err "
                f"{float(err.max()):.3g}")
    for bad in (-1, g, 10 ** 6):
        tg_bad = tg.clone()
        tg_bad[len(tiles) // 2] = bad
        try:
            grouped_matmul(x, w, tg_bad, block_m=bm)
        except ValueError as exc:
            log(f"grouped_matmul: group id {bad} raises ({exc})")
        else:
            check(False, f"grouped_matmul: group id {bad} of {g} groups did not raise")


def phase_expert_stream(device):
    """The expert-wave stream through run_serial, the wave scheduler and
    the device window (wave plan, step path), and one grouped-GEMM launch
    over its ragged tiles. Both task fns, the exactly rounded one and the
    benchmark's own ``a @ b``, leave the wave scheduler's and the device
    window's buffers bit-equal to ``run_serial``'s: the first's group runs
    as one call, the second's, a contraction, task by task on the card."""
    import torch
    from repro_torch.core import DeviceWindowRunner, WaveScheduler, run_serial
    from repro_torch.core.executors import contraction_op
    from repro_torch.kernels.grouped_matmul import grouped_matmul

    got = {}
    for label, fn in (("exact", expert_gemm_exact), ("a @ b", expert_gemm)):
        tasks, (xs, w, tiles), outs = build_expert_stream(device, 0, fn)
        run_serial(tasks, device=device)
        serial = torch.stack([o.value for o in outs])
        tasks, _, outs = build_expert_stream(device, 0, fn)
        report = WaveScheduler(window_size=WINDOW, device=device).run(tasks)
        wave = torch.stack([o.value for o in outs])
        torch.cuda.synchronize()
        diff = float((wave - serial).abs().max())
        got[label] = serial
        log(f"expert stream ({label}): {len(tasks)} tasks over {MOE_E} experts (tiles per "
            f"expert {np.bincount(tiles, minlength=MOE_E).tolist()}); contraction "
            f"{contraction_op(tasks[0])}; dispatches: serial {len(tasks)}, wave scheduler "
            f"{report.exec_stats['dispatches']} in {report.exec_stats['waves']} waves; wave vs "
            f"serial bit-equal {bit_equal(wave, serial)}, max abs diff {diff:.3g}")
        check(bit_equal(wave, serial), f"expert stream ({label}): the wave scheduler != "
                                       f"run_serial (max abs diff {diff})")
        tasks, _, outs = build_expert_stream(device, 0, fn)
        report = DeviceWindowRunner(window_size=WINDOW, plan_mode="wave",
                                    device=device).run(tasks)
        window = torch.stack([o.value for o in outs])
        check(report.wave_executor == "steps" and bit_equal(window, serial),
              f"expert stream ({label}): the device window ({report.wave_executor}) != "
              f"run_serial (max abs diff {float((window - serial).abs().max())})")
        log(f"expert stream ({label}): device window (wave plan, step path, "
            f"{len(report.waves)} plan step) bit-equal to run_serial")
    one = grouped_matmul(torch.from_numpy(xs.reshape(-1, MOE_D)).to(device),
                         torch.from_numpy(w).to(device), torch.from_numpy(tiles).to(device),
                         block_m=MOE_BM)
    torch.cuda.synchronize()
    for label, serial in got.items():
        want = serial.reshape(one.shape)
        err = (one - want).abs()
        check(bool((err <= 1e-4 + 1e-4 * want.abs()).all()),
              f"expert stream: one grouped GEMM != the {label} tasks (max abs err "
              f"{float(err.max())})")
        log(f"expert stream: one grouped GEMM launch over tile ids {tiles.tolist()} within "
            f"1e-4 of the {label} tasks (max abs err {float(err.max()):.3g})")


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


def loop_registry(tasks):
    """An auto-registering registry whose switch table holds the loop
    branches under their own names and under the tasks' opcodes (the
    mixed-tag kernels carry names of their own)."""
    from repro_torch.core import DeviceOpRegistry
    from repro_torch.kernels.ops import register_loop_branches

    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    for t in tasks:
        reg.register_switch_branch(t.opcode, t.fn)
    return reg


def phase_acs_hw_waves(device):
    """The wave and frontier device window: the chain universe and the
    mixed-tag stream on the wave kernel, the cheetah stream on the step
    path. Returns (wave-kernel launches of the chain universe's wave run,
    its widest wave, wall seconds per run)."""
    import torch
    from repro_torch.core import DeviceWindowRunner, TaskStream, run_serial
    from repro_torch.kernels import wave_elementwise as we
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    walls, main = {}, None
    for label, build in (("chain_universe", chain_universe), ("mixed_tag", mixed_tag)):
        bufs, tasks = build(device)
        run_serial(tasks, device=device)
        expect = torch.stack([b.value for b in bufs])
        for mode in ("wave", "frontier"):
            bufs, tasks = build(device)
            runner = DeviceWindowRunner(registry=loop_registry(tasks), window_size=WINDOW,
                                        plan_mode=mode, device=device)
            torch.cuda.synchronize()
            we.reset_launches()  # the main path's count starts here
            t0 = time.perf_counter()
            report = runner.run(tasks)
            walls[f"{label}/device_{mode}"] = time.perf_counter() - t0
            launches, steps = we.launches, we.steps
            got = torch.stack([b.value for b in bufs])
            ex = report.exec_stats
            check(report.wave_executor == "cuda",
                  f"{label} {mode}: executor {report.wave_executor} "
                  f"({report.wave_kernel_refusal})")
            check(launches == report.wave_kernel_launches == 1,
                  f"{label} {mode}: {launches} wave-kernel launches for one epoch")
            check(steps == report.wave_kernel_steps == len(report.waves),
                  f"{label} {mode}: the epoch kernel ran {steps} steps of "
                  f"{len(report.waves)} plan steps")
            check(bit_equal(got, expect), f"{label} {mode}: device window != run_serial")
            log(f"ACS-HW {label} {mode}: {len(tasks)} tasks in {len(report.waves)} plan "
                f"steps (mean width {ex['mean_wave_width']:.3f}, max "
                f"{ex['max_wave_width']}), plan_active_fraction "
                f"{report.plan_active_fraction:.4f}, executor {report.wave_executor}, "
                f"launches {launches} running {steps} steps, bit-equal to run_serial; host "
                f"spans: plan+lower "
                f"{report.plan_seconds * 1e3:.3f} ms, payload "
                f"{report.payload_seconds * 1e3:.3f} ms, pack {report.pack_seconds * 1e3:.3f} "
                f"ms, kernels+sync {report.exec_stats['exec_seconds'] * 1e3:.3f} ms, unpack "
                f"{report.unpack_seconds * 1e3:.3f} ms")
            if (label, mode) == ("chain_universe", "wave"):
                main = (launches, ex["max_wave_width"])

    snaps = {}
    for policy in ("serial", "wave", "frontier"):
        eng = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=SIM_ENVS, group_size=SIM_GROUP,
                            seed=0, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            stream = TaskStream()
            eng.emit_step(stream)
            if policy == "serial":
                run_serial(stream.tasks, device=device)
                continue
            report = DeviceWindowRunner(window_size=WINDOW, plan_mode=policy,
                                        device=device).run(stream.tasks)
            check(report.wave_executor == "steps", f"cheetah {policy}: {report.wave_executor}")
        torch.cuda.synchronize()
        walls[f"cheetah 2 steps/{'serial' if policy == 'serial' else 'device_' + policy}"] = \
            time.perf_counter() - t0
        snaps[policy] = eng.state_snapshot()
    for policy in ("wave", "frontier"):
        check(np.array_equal(snaps[policy].view(np.int32), snaps["serial"].view(np.int32)),
              f"cheetah {policy} device window state != serial state")
    log(f"ACS-HW cheetah: wave and frontier device windows (step path, "
        f"{report.arena_stats['device_steps']} vmapped steps in the last plan) bit-equal "
        "to serial")
    return main[0], main[1], walls


def phase_session(device):
    """``DeviceSession`` under each plan mode: the chain universe fed in 4
    interleaved chunks. Returns wall seconds per mode."""
    import torch
    from repro_torch.core import DeviceSession, run_serial
    from repro_torch.kernels import ready_queue as rq
    from repro_torch.kernels import wave_elementwise as we

    bufs, tasks = chain_universe(device)
    run_serial(tasks, device=device)
    expect = torch.stack([b.value for b in bufs])
    walls = {}
    for mode in ("wave", "frontier", "loop"):
        bufs, tasks = chain_universe(device)
        session = DeviceSession(window_size=WINDOW, registry=loop_registry(tasks),
                                plan_mode=mode, device=device)
        torch.cuda.synchronize()
        rq.reset_launches()
        we.reset_launches()
        t0 = time.perf_counter()
        n = len(tasks) // 4
        for i in range(4):
            session.submit(tasks[i * n:(i + 1) * n])
            session.poll()
        stats = session.close().session_stats
        walls[f"chain_universe/session_{mode}"] = time.perf_counter() - t0
        got = torch.stack([b.value for b in bufs])
        check(bit_equal(got, expect), f"DeviceSession {mode} != run_serial")
        if mode == "loop":
            check(rq.launches == stats["loop_dispatches"] == stats["device_dispatches"] > 0,
                  f"DeviceSession loop: {rq.launches} ready-queue launches for "
                  f"{stats['loop_dispatches']} loop dispatches")
        else:
            check(we.launches == stats["wave_kernel_dispatches"] == stats["device_dispatches"]
                  > 0 and we.steps == len(session.stats.wave_widths),
                  f"DeviceSession {mode}: {we.launches} wave-kernel launches running "
                  f"{we.steps} steps, {len(session.stats.wave_widths)} plan steps, stats {stats}")
        keys = ("epochs", "device_dispatches", "loop_dispatches", "wave_kernel_dispatches",
                "plan_cache_hits", "plan_cache_misses", "host_syncs", "host_syncs_d2h")
        log(f"DeviceSession {mode}: bit-equal to run_serial; ready-queue launches "
            f"{rq.launches}, wave-kernel launches {we.launches} ({we.steps} steps); "
            + ", ".join(f"{k} {stats[k]}" for k in keys))
    return walls


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


def serve_prompts(vocab):
    rng = np.random.RandomState(SERVE_SEED)
    lengths = rng.randint(SERVE_MIN_PROMPT, SERVE_MAX_PROMPT + 1, SERVE_REQUESTS)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def greedy(cfg, params, prompt, device):
    """A plain greedy loop over ``prefill``/``decode_step``, mirroring one
    server slot. Returns (tokens, prefill seconds, decode-step seconds,
    all logits finite)."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill

    cache = init_cache(cfg, 1, SERVE_MAX_LEN, device=device)
    tokens = torch.as_tensor(prompt[None], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens, cache)
    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    pos = torch.full((), len(prompt), dtype=torch.int32, device=device)
    out, t_decode = [], []
    for _ in range(SERVE_MAX_NEW):
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cfg, tok[:, None], cache, pos)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        pos = pos + 1
        out.append(int(tok[0]))  # the host read ends the step
        t_decode.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits).all())
    return out, t_prefill, t_decode, finite


def serve_once(cfg, params, server_cls, prompts, device, **kw):
    """One server run over ``prompts``; returns (per-prompt tokens, wall
    seconds, host reads, {kernel: launches})."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import lru_scan as ls
    from repro_torch.runtime import SessionServer

    server = server_cls(cfg, params, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        window=WINDOW, device=device, **kw)
    torch.cuda.synchronize()
    for mod in (fa, ls, gm):  # the main path's counts start here
        mod.reset_launches()
    t0 = time.perf_counter()
    reqs = [server.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    done = server.run_until_drained()
    if isinstance(server, SessionServer):
        server.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "lru_scan": ls.launches,
                "grouped_matmul": gm.launches}
    check(sorted(r.rid for r in done) == sorted(r.rid for r in reqs),
          f"{server_cls.__name__}: {len(done)} of {len(reqs)} requests finished")
    return [r.generated for r in reqs], wall, server.host_reads, launches


def expected_launches(cfg, n_requests):
    """Each kernel's launches in one server run: flash once per prefill
    and attention layer, the scan once per RG-LRU layer and forward, the
    grouped GEMM three times per MoE layer and forward (prefix layers keep
    a dense FFN)."""
    from repro_torch.models import split_pattern

    prefix, n_stages = split_pattern(cfg)
    kinds = list(prefix) + list(cfg.pattern_unit) * n_stages
    n_attn = sum(kind.startswith("attn") for kind in kinds)
    n_moe = len(cfg.pattern_unit) * n_stages if cfg.moe is not None else 0
    forwards = n_requests * (1 + SERVE_MAX_NEW)
    return {"flash_attention": n_requests * n_attn,
            "lru_scan": kinds.count("rglru") * forwards,
            "grouped_matmul": 3 * n_moe * forwards}


def phase_serve(device, card, arch):
    """Serve ``arch`` at its published widths. Returns (launches per kernel
    on the session server's run, wall seconds per server, the model, its
    config and the prompts)."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.runtime import ContinuousBatchingServer, SessionServer

    cfg = ARCHS[arch]
    t0 = time.perf_counter()
    params = init_params(cfg, SERVE_SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} {cfg.dtype}, "
        f"{n_params} parameters drawn from seed {SERVE_SEED} in "
        f"{time.perf_counter() - t0:.2f} s [{card}]")
    prompts = serve_prompts(cfg.vocab)
    want = expected_launches(cfg, SERVE_REQUESTS)

    plain, prefill_s, decode_s = [], [], []
    for p in prompts:
        toks, t_pre, t_dec, finite = greedy(cfg, params, p, device)
        check(finite, f"serve {cfg.name}: non-finite logits for a prompt of {len(p)} tokens")
        plain.append(toks)
        prefill_s.append(t_pre)
        decode_s.extend(t_dec)

    walls, tokens, main_launches = {}, {}, None
    for name, cls, kw in (("SessionServer(wave)", SessionServer, {"scheduler": "wave"}),
                          ("SessionServer(device)", SessionServer, {"scheduler": "device"}),
                          ("ContinuousBatchingServer", ContinuousBatchingServer, {})):
        toks, wall, reads, launches = serve_once(cfg, params, cls, prompts, device, **kw)
        check(all(len(t) == SERVE_MAX_NEW for t in toks),
              f"{cfg.name} {name}: a request lacks tokens")
        check(all(0 <= x < cfg.vocab for t in toks for x in t),
              f"{cfg.name} {name}: a token out of range")
        check(launches == want, f"{cfg.name} {name}: kernel launches {launches}, "
                                f"expected {want}")
        check(toks == plain, f"{cfg.name} {name}: tokens differ from the plain greedy loop")
        tokens[name], walls[f"serve {cfg.name}/{name}"] = toks, wall
        if main_launches is None:
            main_launches = launches
        n_tok = SERVE_REQUESTS * SERVE_MAX_NEW
        log(f"serve {cfg.name} {name}: {SERVE_REQUESTS} requests x {SERVE_MAX_NEW} tokens, "
            f"wall {wall * 1e3:.3f} ms, {n_tok / wall:.2f} tokens/s, host reads {reads}, "
            f"launches {launches} [{card}]")
    check(tokens["SessionServer(wave)"] == tokens["SessionServer(device)"]
          == tokens["ContinuousBatchingServer"], f"serve {cfg.name}: the servers' tokens differ")
    log(f"serve {cfg.name}: prompt lengths {[len(p) for p in prompts]}; the three servers' "
        f"tokens identical and equal to the plain greedy loop; median prefill "
        f"{statistics.median(prefill_s) * 1e3:.3f} ms, median decode step "
        f"{statistics.median(decode_s) * 1e3:.3f} ms (greedy loop, host clock, "
        f"{len(decode_s)} steps) [{card}]")
    return main_launches, walls, (cfg, params, prompts)


def busy_serve(device, card, served):
    """One more serving pass (SessionServer(wave), 2 requests) under the
    profiler: its device busy share."""
    from repro_torch.runtime import SessionServer

    cfg, params, prompts = served
    profile_pass(f"serve {cfg.name} SessionServer(wave), 2 requests x {SERVE_MAX_NEW} tokens",
                 lambda: serve_once(cfg, params, SessionServer, prompts[:2], device,
                                    scheduler="wave"), card)


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


def back_to_back_ms(fn, launches=20, runs=5):
    """Median over ``runs`` of the CUDA-event time of ``launches`` calls in a
    row, per call: where a call's host work is shorter than its kernel, the
    launches queue up and this is the kernel's own time."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def phase_numbers(device, launches):
    """The ready queue over the chain universe as the loop runner launches
    it: CUDA-event time of single launches and back to back, its device
    time from the profiler, the same for ONE 32-deep chain (its device time
    over 32 is the hop that bounds the kernel: the universe's 64 chains run
    side by side in about one chain's time), its grid and the blocks that
    ran tasks."""
    import torch
    from repro_torch.kernels import ready_queue as rq
    from repro_torch.kernels.ops import LOOP_OPCODES
    from repro_torch.kernels.ref import ready_queue_ref

    _, tasks = chain_universe(device)
    slab, p, branches = lowered_payload(tasks, device)
    got = run_queue(rq.ready_queue, slab, p, branches)
    want = run_queue(ready_queue_ref, slab, p, branches)
    torch.cuda.synchronize()
    stats = rq.launch_stats()
    max_abs_err = float((got[0] - want[0]).abs().max())
    call = lambda: run_queue(rq.ready_queue, slab, p, branches)  # noqa: E731
    ms, b2b_ms = median_ms(call), back_to_back_ms(call)
    device_ms, recorded = kernel_device_ms(call, "ready_queue_kernel")
    plain_ms = median_ms(lambda: run_queue(ready_queue_ref, slab, p, branches))
    chain = {}  # depth -> (events ms, device ms, kernels the trace holds)
    for depth in (1, DEPTH):
        _, one = chain_universe(device, n_chains=1, depth=depth)
        cslab, cp, cbr = lowered_payload(one, device)
        chain_call = lambda: run_queue(rq.ready_queue, cslab, cp, cbr)  # noqa: E731
        chain[depth] = (median_ms(chain_call),) + kernel_device_ms(chain_call,
                                                                    "ready_queue_kernel")
    chain_ms, chain_device_ms, _ = chain[DEPTH]
    fixed_ms = chain[1][1]

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
    hop_us = chain_device_ms / DEPTH * 1e3 if chain_device_ms else None
    ratio = device_ms / chain_device_ms if device_ms and chain_device_ms else None
    log(f"ready queue, chain universe: events {ms:.4f} ms, back to back {b2b_ms:.4f} ms, "
        f"device {device_ms} ms ({recorded} of {TIMED_RUNS} kernels in the trace); one "
        f"{DEPTH}-deep chain: events {chain_ms:.4f} ms, device {chain_device_ms} ms "
        f"({chain[DEPTH][2]} in the trace), hop {hop_us} us; one task: device {fixed_ms} ms "
        f"({chain[1][2]} in the trace); universe / one chain (device) {ratio}; grid {stats['blocks']} blocks, "
        f"{stats['blocks_ran']} ran tasks")
    return {
        "name": "ready_queue",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ready_queue.cu",
        "replaces": "src/repro/kernels/ready_queue.py:47",
        "launches": launches,
        "matches_plain": bit_equal(got[0], want[0]) and bit_equal(got[1], want[1]),
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": None,
        "b2b_ms": b2b_ms,
        "device_ms": device_ms,
        "chain_ms": chain_ms,
        "chain_device_ms": chain_device_ms,
        "hop_us": hop_us,
        "one_task_device_ms": fixed_ms,
        "universe_over_chain": ratio,
        "grid": stats["blocks"],
        "blocks_ran": stats["blocks_ran"],
        "row_traffic_bound_ms": rows_ms,
        "shape": f"slab {tuple(slab.shape)} f32, n {n}, m {p['dep_tbl'].shape[1]}",
    }


def bound(n_bytes, n_ops, ops_per_s):
    """(least ms, "bytes" or "operations") on this card's published peaks."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def numbers_lru(device, launches):
    import torch
    from repro_torch.kernels.lru_scan import lru_scan
    from repro_torch.kernels.ref import lru_scan_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    out = {}
    for label, s in (("prefill", 512), ("decode", 1)):
        a = torch.rand(1, s, 2560, generator=gen, device=device)
        x = torch.randn(1, s, 2560, generator=gen, device=device)
        h0 = torch.randn(1, 2560, generator=gen, device=device)
        got, want = lru_scan(a, x, h0), lru_scan_ref(a, x, h0)
        torch.cuda.synchronize()
        elems = a.numel()
        ms_bound, by = bound((3 * elems + h0.numel()) * 4, 2 * elems, FP32_FLOP_PER_S)
        out[label] = dict(ms=median_ms(lambda: lru_scan(a, x, h0)),
                          b2b_ms=back_to_back_ms(lambda: lru_scan(a, x, h0)),
                          plain_ms=median_ms(lambda: lru_scan_ref(a, x, h0)),
                          bound_ms=ms_bound, bound_by=by,
                          max_abs_err=float((got - want).abs().max()),
                          matches_plain=bool(torch.equal(_int_bits(got), _int_bits(want))))
    pre, dec = out["prefill"], out["decode"]
    return {
        "name": "lru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:27",
        "launches": launches,
        "matches_plain": pre["matches_plain"] and dec["matches_plain"],
        "max_abs_err": max(pre["max_abs_err"], dec["max_abs_err"]),
        "ms": pre["ms"],
        "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a linear recurrence
        "back_to_back_ms": pre["b2b_ms"],
        "decode_ms": dec["ms"],
        "decode_back_to_back_ms": dec["b2b_ms"],
        "decode_plain_ms": dec["plain_ms"],
        "decode_bound_ms": dec["bound_ms"],
        "shape": "prefill a, b [1, 512, 2560] f32; decode [1, 1, 2560] f32",
    }


def numbers_flash(device, launches, granite_launches):
    """Flash at recurrentgemma-2b's prefill ([1, 10, 512, 256] over one kv
    head, window 2048) and granite-moe-3b-a800m's ([1, 24, 512, 64], GQA
    24/8, causal), each with its server run's launch count: single
    launches and 20 back to back, beside SDPA the same two ways."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    b, h, hkv, s, d, window = 1, 10, 1, 512, 256, 2048
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    q, k, v = (torch.randn(b, n, s, d, generator=gen, device=device).to(torch.bfloat16)
               for n in (h, hkv, hkv))
    flags = dict(causal=True, window=window)
    got, want = flash_attention(q, k, v, **flags), attention_ref(q, k, v, **flags)
    torch.cuda.synchronize()
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    mask = (cols <= rows) & (cols > rows - window)
    seen = int(mask.sum())  # (row, key) pairs this input's mask keeps
    ms_bound, by = bound(2 * (q.numel() * 2 + k.numel() + v.numel()), 4 * b * h * seen * d,
                         BF16_FLOP_PER_S)
    rg = lambda: flash_attention(q, k, v, **flags)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,  # noqa: E731
                                                  enable_gqa=True)
    # granite-moe-3b-a800m's prefill: 24 heads over 8 kv heads of 64, causal.
    gq, gk, gv = (torch.randn(1, n, s, 64, generator=gen, device=device).to(torch.bfloat16)
                  for n in (24, 8, 8))
    g_got, g_want = flash_attention(gq, gk, gv), attention_ref(gq, gk, gv)
    torch.cuda.synchronize()
    g_bound, g_by = bound(2 * (gq.numel() * 2 + gk.numel() + gv.numel()),
                          4 * 24 * (s * (s + 1) // 2) * 64, BF16_FLOP_PER_S)
    gr = lambda: flash_attention(gq, gk, gv)  # noqa: E731
    g_sdpa = lambda: F.scaled_dot_product_attention(gq, gk, gv, is_causal=True,  # noqa: E731
                                                    enable_gqa=True)
    ok = (torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
          and torch.allclose(g_got.float(), g_want.float(), rtol=2e-2, atol=2e-2))
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "launches": launches,
        "matches_plain": bool(ok),
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": median_ms(rg),
        "plain_ms": median_ms(lambda: attention_ref(q, k, v, **flags)),
        "bound_ms": ms_bound,
        "bound_by": by,
        "library_ms": median_ms(sdpa),
        "back_to_back_ms": back_to_back_ms(rg),
        "library_back_to_back_ms": back_to_back_ms(sdpa),
        "shape": f"q [1, 10, 512, 256], k, v [1, 1, 512, 256] bf16, causal, window {window}",
        "granite_launches": granite_launches,
        "granite_max_abs_err": float((g_got.float() - g_want.float()).abs().max()),
        "granite_ms": median_ms(gr),
        "granite_plain_ms": median_ms(lambda: attention_ref(gq, gk, gv)),
        "granite_bound_ms": g_bound,
        "granite_bound_by": g_by,
        "granite_library_ms": median_ms(g_sdpa),
        "granite_back_to_back_ms": back_to_back_ms(gr),
        "granite_library_back_to_back_ms": back_to_back_ms(g_sdpa),
        "granite_shape": "q [1, 24, 512, 64], k, v [1, 8, 512, 64] bf16, causal",
    }


def numbers_gmm(device, launches):
    """The grouped GEMM at granite-moe's gate/up product (48 experts of
    [1536, 512] bf16): decode (C = 1, M = 48) and a 512-token prefill
    (C = 128, M = 6144); ``torch.bmm`` over the same capacity layout is the
    library call."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ref import grouped_matmul_ref

    g, k, n = 48, 1536, 512
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    w = torch.randn(g, k, n, generator=gen, device=device).to(torch.bfloat16)
    tiles = torch.arange(g, dtype=torch.int32, device=device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    out = {}
    for label, cap in (("decode", 1), ("prefill", 128)):
        x = torch.randn(g * cap, k, generator=gen, device=device).to(torch.bfloat16)
        got = grouped_matmul(x, w, tiles, block_m=cap)
        want = grouped_matmul_ref(x, w, tiles, block_m=cap)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= GMM_TOL["bfloat16"] * (1 + want.float().abs())).all())
        x3 = x.view(g, cap, k)
        ms_bound, by = bound(2 * (x.numel() + w.numel() + g * cap * n), 2 * g * cap * k * n,
                             BF16_FLOP_PER_S)
        out[label] = dict(
            ms=median_ms(lambda: grouped_matmul(x, w, tiles, block_m=cap, err=err)),
            b2b_ms=back_to_back_ms(lambda: grouped_matmul(x, w, tiles, block_m=cap, err=err)),
            library_b2b_ms=back_to_back_ms(lambda: torch.bmm(x3, w)),
            plain_ms=median_ms(lambda: grouped_matmul_ref(x, w, tiles, block_m=cap)),
            library_ms=median_ms(lambda: torch.bmm(x3, w)),
            bound_ms=ms_bound, bound_by=by, max_abs_err=float(diff.max()), ok=ok)
    dec, pre = out["decode"], out["prefill"]
    return {
        "name": "grouped_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:61",
        "launches": launches,
        "matches_plain": dec["ok"] and pre["ok"],
        "max_abs_err": max(dec["max_abs_err"], pre["max_abs_err"]),
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "back_to_back_ms": dec["b2b_ms"],
        "library_back_to_back_ms": dec["library_b2b_ms"],
        "prefill_ms": pre["ms"],
        "prefill_back_to_back_ms": pre["b2b_ms"],
        "prefill_library_back_to_back_ms": pre["library_b2b_ms"],
        "prefill_plain_ms": pre["plain_ms"],
        "prefill_bound_ms": pre["bound_ms"],
        "prefill_bound_by": pre["bound_by"],
        "prefill_library_ms": pre["library_ms"],
        "shape": f"w [{g}, {k}, {n}] bf16, tile ids arange({g}); decode x [{g}, {k}] "
                 f"(block_m 1); prefill x [{g * 128}, {k}] (block_m 128)",
    }


def wave_program(device, tasks, mode):
    """The chain universe lowered for the wave kernel under ``mode``'s plan,
    as the device window lowers it: (program, the packed slab)."""
    from repro_torch.core import SlabArena
    from repro_torch.core.device_dispatch import _wave_kernel_parts, plan_frontier, plan_waves

    plan = plan_waves(tasks, WINDOW) if mode == "wave" else plan_frontier(tasks, WINDOW)
    arena = SlabArena()
    arena.add_tasks(tasks)
    prog, why = _wave_kernel_parts(plan, loop_registry(tasks), arena)
    check(prog is not None, f"chain universe not wave-kernel eligible: {why}")
    return prog, arena.pack(device)[prog.class_id]


def epoch_ms(slab0, fn, runs=TIMED_RUNS, warmup=3):
    """CUDA-event median of ``fn(slab)`` on a fresh copy of ``slab0`` each
    run (the epoch updates its slab in place; the copy is outside the
    events)."""
    import torch

    slab = slab0.clone()
    for _ in range(warmup):
        slab.copy_(slab0)
        fn(slab)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        slab.copy_(slab0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(slab)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def numbers_epoch(device, tasks, mode):
    """The epoch kernel over the chain universe's ``mode`` plan: its time
    (direct steps unstaged, as the device window runs it, and every step
    staged), the plain step loop's, and the bounds."""
    import torch
    from repro_torch.kernels.ops import LOOP_OPCODES
    from repro_torch.kernels.wave_elementwise import wave_epoch

    prog, slab0 = wave_program(device, tasks, mode)
    desc = torch.from_numpy(prog.desc).to(device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    br, offs = prog.branches, prog.offsets
    got = wave_epoch(slab0.clone(), desc, offs, branches=br, direct=prog.direct)
    want = plain_epoch(slab0.clone(), desc, offs, br)
    torch.cuda.synchronize()
    d = slab0.shape[1]
    flops_per_elem = {0: 3, 1: 2}  # axpy: mul, add, add; mul: mul, sub
    flops = sum(flops_per_elem[LOOP_OPCODES[br[b]]] for b in prog.desc[:, 0]) * d
    tables = (prog.desc.size + 2 * prog.n_steps + 1 + len(br)) * 4
    # The function's bytes: every row it reads at all read once, every row
    # it writes written once.
    read_rows = len(set(prog.desc[:, 1].tolist()) | set(prog.desc[:, 2].tolist()))
    written_rows = len(set(prog.desc[:, 3].tolist()))
    ms_bound, by = bound((read_rows + written_rows) * d * 4 + tables, flops, FP32_FLOP_PER_S)
    # Each step's rows through device memory (read rows + out rows per step).
    step_bytes = sum((len(set(prog.desc[lo:hi, 1:3].flatten().tolist())) + hi - lo) * d * 4
                     for lo, hi in zip(offs[:-1], offs[1:]))
    return dict(
        steps=prog.n_steps, direct_steps=sum(prog.direct), widest=max(np.diff(offs)),
        matches_plain=bit_equal(got, want), max_abs_err=float((got - want).abs().max()),
        ms=epoch_ms(slab0, lambda s: wave_epoch(s, desc, offs, branches=br, err=err,
                                                direct=prog.direct)),
        staged_ms=epoch_ms(slab0, lambda s: wave_epoch(s, desc, offs, branches=br, err=err)),
        plain_ms=epoch_ms(slab0, lambda s: plain_epoch(s, desc, offs, br), runs=5, warmup=1),
        bound_ms=ms_bound, bound_by=by,
        step_bytes_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
        shape=f"{prog.n_steps} {mode} plan steps of 1-{max(np.diff(offs))} slots over slab "
              f"{tuple(slab0.shape)} f32")


def numbers_wave(device, launches, widest):
    """The wave kernel as the main path runs it, one epoch launch over the
    chain universe's wave plan (and over its frontier plan); then the
    single-wave entry at the widest wave of that plan (that step's own
    descriptors over the chain universe's slab) and at S = 32."""
    import torch
    from repro_torch.kernels.ops import LOOP_OPCODES
    from repro_torch.kernels.ref import wave_rows_ref
    from repro_torch.kernels.wave_elementwise import wave_elementwise

    _, tasks = chain_universe(device)
    epoch = {mode: numbers_epoch(device, tasks, mode) for mode in ("wave", "frontier")}
    wave, frontier = epoch["wave"], epoch["frontier"]
    prog, slab = wave_program(device, tasks, "wave")
    i = max(range(prog.n_steps), key=lambda k: prog.offsets[k + 1] - prog.offsets[k])
    desc_np = prog.desc[prog.offsets[i]:prog.offsets[i + 1]]
    check(len(desc_np) == widest, f"widest wave {len(desc_np)} != the run's {widest}")
    desc = torch.from_numpy(desc_np).to(device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    got = wave_elementwise(slab, desc, branches=prog.branches)
    want = wave_rows_ref(slab, desc, prog.branches)
    torch.cuda.synchronize()
    s, d = desc.shape[0], slab.shape[1]
    rows_read = len(set(desc_np[:, 1].tolist()) | set(desc_np[:, 2].tolist()))
    slab32, desc32 = random_wave(device, 0, 32, d)
    br32 = wave_branches()
    flops_per_elem = {0: 3, 1: 2}  # axpy: mul, add, add; mul: mul, sub
    flops = sum(flops_per_elem[LOOP_OPCODES[prog.branches[b]]] for b in desc_np[:, 0]) * d
    single_bound, _ = bound((rows_read + s) * d * 4 + desc.numel() * 4, flops, FP32_FLOP_PER_S)
    return {
        "name": "wave_elementwise",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wave_elementwise.cu",
        "replaces": "src/repro/kernels/wave_elementwise.py:51",
        "launches": launches,
        "matches_plain": (wave["matches_plain"] and frontier["matches_plain"]
                          and bit_equal(got, want)),
        "max_abs_err": max(wave["max_abs_err"], frontier["max_abs_err"],
                           float((got - want).abs().max())),
        "ms": wave["ms"],
        "plain_ms": wave["plain_ms"],
        "bound_ms": wave["bound_ms"],
        "bound_by": wave["bound_by"],
        "library_ms": None,  # no single PyTorch call computes an opcode-switched gather-apply
        "shape": f"wave_epoch: {wave['shape']} ({wave['direct_steps']} direct), one "
                 f"cooperative launch",
        "steps": wave["steps"],
        "staged_ms": wave["staged_ms"],
        "step_bytes_bound_ms": wave["step_bytes_bound_ms"],
        "frontier_ms": frontier["ms"],
        "frontier_staged_ms": frontier["staged_ms"],
        "frontier_plain_ms": frontier["plain_ms"],
        "frontier_bound_ms": frontier["bound_ms"],
        "frontier_step_bytes_bound_ms": frontier["step_bytes_bound_ms"],
        "frontier_shape": frontier["shape"],
        # The single-wave entry, no longer on the main path.
        "single_ms": median_ms(lambda: wave_elementwise(slab, desc, branches=prog.branches,
                                                        err=err)),
        "single_plain_ms": median_ms(lambda: wave_rows_ref(slab, desc, prog.branches)),
        "single_bound_ms": single_bound,
        "single_shape": f"S {s} slots (the widest wave of the chain universe's wave plan) "
                        f"over slab {tuple(slab.shape)} f32, {rows_read} distinct rows read",
        # A 32-slot wave at the same width, for the launch-bound regime.
        "s32_ms": median_ms(lambda: wave_elementwise(slab32, desc32, branches=br32, err=err)),
        "s32_bound_ms": bound((len(set(desc32[:, 1:3].flatten().tolist())) + 32) * d * 4
                              + desc32.numel() * 4, 3 * 32 * d, FP32_FLOP_PER_S)[0],
    }


def profiled(fn):
    """Run ``fn()`` once under ``torch.profiler``. Returns (the profile, the
    wall ms of ``fn`` under it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def kernel_device_ms(fn, name, runs=TIMED_RUNS):
    """The device time of one kernel whose name holds ``name``: the mean
    over the ones the profiler recorded in ``runs`` calls of ``fn`` (a
    trace can lose some, see ``phase_busy``). Returns (ms or None when the
    trace holds none, how many it holds)."""
    prof, _ = profiled(lambda: [fn() for _ in range(runs)])
    hits = [a for a in prof.key_averages() if name in a.key]
    count = sum(a.count for a in hits)
    total = sum(a.self_device_time_total for a in hits)
    return (total / 1e3 / count if count else None), count


def device_busy(fn):
    """Run ``fn()`` once under ``torch.profiler``. Returns (wall ms under
    the profiler, device-busy ms: the union of the CUDA kernels' intervals,
    or None when the profiler records no kernel; the number of CUDA
    kernels; the three host ops with the most self CPU time and the three
    ops with the most self device time; the names of the device events)."""
    from torch.autograd import DeviceType

    prof, wall_ms = profiled(fn)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    avgs = prof.key_averages()
    host = sorted(avgs, key=lambda a: -a.self_cpu_time_total)[:3]
    dev = sorted(avgs, key=lambda a: -a.self_device_time_total)[:3]
    top = (", ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.1f} ms x{a.count}" for a in host)
           + "; most device time: "
           + ", ".join(f"{a.key[:60]} {a.self_device_time_total / 1e3:.1f} ms x{a.count}"
                       for a in dev))
    names = {e.name for e in device}
    if spans:  # where the trace's device events begin, after its first host event
        first = min(e.time_range.start for e in events if e.device_type != DeviceType.CUDA)
        top += f"; first device event +{(spans[0][0] - first) / 1e3:.3f} ms"
    if not spans:
        return wall_ms, None, 0, top, names
    busy_us, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return wall_ms, (busy_us + hi - lo) / 1e3, len(spans), top, names


def profile_pass(label, fn, card, kernel=None):
    """Log one profiled pass; with ``kernel``, also whether the trace holds
    a device event whose name holds it."""
    wall_ms, busy_ms, n_kernels, top, names = device_busy(fn)
    busy = ("device busy not measured (no kernel in the trace)" if busy_ms is None
            else f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    seen = ("" if kernel is None else
            f"; {kernel} in the trace: {any(kernel in name for name in names)}")
    log(f"profile {label}: wall {wall_ms:.3f} ms under the profiler, {busy}, "
        f"{n_kernels} CUDA kernels{seen}; most host time: {top} [{card}]")


def busy_chain(device, policy):
    """One chain-universe pass of ``policy`` ("serial" or "device_<plan
    mode>"), ready to run under the profiler."""
    from repro_torch.core import DeviceOpRegistry, DeviceWindowRunner, run_serial
    from repro_torch.kernels.ops import register_loop_branches

    _, tasks = chain_universe(device)
    if policy == "serial":
        return lambda: run_serial(tasks, device=device)
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    runner = DeviceWindowRunner(registry=reg, window_size=WINDOW,
                                plan_mode=policy.removeprefix("device_"), device=device)
    return lambda: runner.run(tasks)


def phase_busy(device, card):
    from repro_torch.core import TaskStream, make_scheduler
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    def chain(policy):
        return busy_chain(device, policy)

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

    for label, make, kernel in (
            ("chain_universe/serial", lambda: chain("serial"), None),
            ("chain_universe/device_loop", lambda: chain("device_loop"), "ready_queue_kernel"),
            ("chain_universe/device_wave", lambda: chain("device_wave"), "wave_epoch_kernel"),
            *((f"cheetah step/{p}", lambda p=p: cheetah(p), None)
              for p in ("serial", "wave", "threaded"))):
        profile_pass(label, make(), card, kernel)


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

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    card = phase_device()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    timed(phase_build)
    timed(phase_kernel_vs_plain, device)
    timed(phase_wave_vs_plain, device)
    timed(phase_lru_vs_plain, device)
    timed(phase_flash_vs_plain, device)
    timed(phase_gmm_vs_plain, device)
    timed(phase_expert_stream, device)
    launches, hw_walls = timed(phase_acs_hw, device)
    wave_launches, widest, wave_walls = timed(phase_acs_hw_waves, device)
    session_walls = timed(phase_session, device)
    sw_walls = timed(phase_acs_sw, device)
    timed(phase_busy, device, card)
    serve_launches, serve_walls = {}, {}
    for arch in SERVE_ARCHS:
        arch_launches, walls, served = timed(phase_serve, device, card, arch)
        timed(busy_serve, device, card, served)
        serve_launches[arch] = arch_launches
        serve_walls.update(walls)
        del served  # free this model's weights before the next one's are drawn
        torch.cuda.empty_cache()
    rg, granite = (serve_launches[a] for a in SERVE_ARCHS)
    kernels = [timed(phase_numbers, device, launches),
               timed(numbers_wave, device, wave_launches, widest),
               timed(numbers_flash, device, rg["flash_attention"],
                     granite["flash_attention"]),
               timed(numbers_lru, device, rg["lru_scan"]),
               timed(numbers_gmm, device, granite["grouped_matmul"])]
    for kernel in kernels:
        check(kernel["matches_plain"], f"{kernel['name']}: kernel != plain at the main "
                                       "path's shape")
        check(kernel["launches"] >= 1, f"the main path launched no {kernel['name']} kernel")

    kind = torch.cuda.get_device_name(0)
    for key, secs in {**hw_walls, **wave_walls, **session_walls, **sw_walls,
                      **serve_walls}.items():
        log(f"wall {key}: {secs * 1e3:.3f} ms [{card}]")
    profile_pass("chain_universe/device_loop, after the serving passes",
                 busy_chain(device, "device_loop"), card, "ready_queue_kernel")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
