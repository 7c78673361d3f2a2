#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each fatal on failure (an exception, exit code != 0):

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: the eight CUDA kernel libraries (ready queue, wave megakernel,
   flash attention, flash attention's backward on wgmma and its float32
   path, RG-LRU scan and its reverse scan, grouped GEMM and
   its dx and dw entries, selective scan and its backward)
   from the sources in this checkout, one ``nvcc`` each, all started
   together; each one's build seconds and, from ``ptxas -v``, each
   kernel's registers, static shared memory and spills.
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
      element copies); its reverse scan (``lru_scan_bwd``: da, db, dh0)
      bit-equal to ``lru_scan_bwd_ref`` for B in {1, 4}, S in {1, 37, 63,
      64, 65, 512}, D in {2560, 1000, 7}, float32 and bfloat16, the same
      bits on a second launch; the selective scan (SCAN_SWEEP, FUSED_SWEEP):
      ``selective_scan``'s ys and hT within 1e-5 (abs and rel) of
      ``selective_scan_ref`` at falcon-mamba-7b's prefills ([1, 512, 8192]
      and [1, 128, 8192], N 16) and decode (B 1 and 4), S on both sides of
      the kernel's 4-step segments and 64-step chunks (1, 127, 128, 129,
      511, 512, 513, 2049) for B 1, 3 and 4, E off the channel tile and the
      16-byte width, N from 1 to 16; the fused ``mamba_scan`` (softplus,
      the scan, the D skip and the silu gate in one launch) against
      ``mamba_scan_ref`` in float32 and bf16 with z, b and c strided views
      of the projections (bf16: y the rounding of a value within 1e-5 of
      the plain float32 y); the same bits on a second launch; each row of
      a B = 4 launch equal to a B = 1 launch of that row; bad inputs raise;
   d. ``flash_attention``: within tolerance of ``attention_ref`` (float32
      1e-4, bfloat16 2e-2) at the recurrentgemma-2b, h2o-danube-3-4b and
      granite-moe-3b-a800m prefill shapes, musicgen-large's and
      paligemma-3b's prefill and forward shapes (paligemma's 256-key
      prefix over four tiles) and at the edges of the kernel's
      64-row and 64-key tiles: Sq and Sk of 65, 127, 333 and 2500,
      D in {8, 24, 64, 120, 128, 256}, the window edge and ``prefix_len``
      inside a tile, softcap, decode (Sq = 1) and fully masked rows
      (exactly 0, a whole query tile of them included); with v narrower or
      wider than q and k: deepseek-v2's MLA prefill (D 192, Dv 128,
      [1, 128, 512, *]) and the (192, 128) instantiation's edges; the same
      bits on a second launch; head widths with no instantiation raise;
   d'. flash's backward (``flash_attention_bwd``, FLASH_BWD_SWEEP): dq,
      dk and dv within tolerance of ``attention_bwd_ref`` (float32 1e-4,
      bf16 2e-2 of the largest entry) on the forward kernel's o and row
      log-sum-exp, at minicpm-2b's training shape [4, 36, 512, 64] causal
      and over GQA, window, prefix, softcap, a ragged Sk, rows that see no
      key, no causal mask, D 24, 120 and 128; at D 256:
      recurrentgemma-2b's training shape [4, 10, 512, 256] over
      one kv head with window 2048, a window that binds (S 600, window
      100), paligemma-3b's [1, 8, 320, 256] over one kv head with
      ``prefix_len`` 256, softcap, blind rows, D 200 and 136; lse within
      1e-4 of ``attention_lse_ref``; the forward's bits the same with and
      without lse; the same bits on a second launch; each case's path
      (wgmma with TMA on all of them); the same kernels on padded copies
      for q and dO off 16-byte alignment at D 64, 128 and 256, bf16 and
      f16, within the bf16 tolerance, the same bits twice; Dv != D on its
      own (192, 128) instantiation: deepseek-v2's MLA training shape
      [4, 128, 512, 192], v [.., 128], a ragged Sk, Sq off the tiles, GQA
      with a window (also padded), the reduced MLA's 16 / 8; under grad at
      D 192, Dv 128 the Function launches the forward and the wgmma
      backward once each, within tolerance of autograd through the plain
      version;
   d''. the selective scan's backward (``acs_mamba_scan_bwd``,
      SCAN_BWD_SWEEP): the fused entry's nine gradients against
      ``mamba_scan_bwd_ref`` in float32 and bf16 (z, b, c strided; hT's
      gradient given) and the scan alone's six against
      ``selective_scan_bwd_ref``, within SCAN_BWD_TOL of each one's largest
      entry, at falcon-mamba-7b's training shape [4, 512, 8192], N 16, and
      S 1, S off the 64-step chunk, E off the 32-channel tile, N 5 and 1;
      the forward that saves the chunk states keeps the serving call's
      bits; the same bits on a second launch; under grad ``mamba_scan``
      launches its forward and backward once each;
   e. ``grouped_matmul``: within tolerance of ``grouped_matmul_ref``
      (float32 1e-4, float16 and bfloat16 8e-3: one bfloat16 ulp) over the
      reference's ragged cases (N off the tile, groups with no tile),
      ``block_m`` in {1, 2, 15, 16, 17, 63, 64, 65, 70, 128} (both tile
      shapes and their edges), K and N off the 16-byte copy width and the
      ring's tile widths, and granite-moe's decode and prefill expert
      products, in float32, float16 and bfloat16; the same bits on a
      second launch; a bad group id raises;
   e'. the grouped GEMM's backward (``grouped_matmul_bwd``: dx, dw;
      GMM_BWD_SWEEP) within GMM_BWD_TOL of ``grouped_matmul_bwd_ref`` at
      granite-moe-3b-a800m's training shapes (40 experts, C 512: w [40,
      1536, 512] and [40, 512, 1536]), deepseek-v2's expert shapes (160
      experts, C 96: w [160, 5120, 1536] and [160, 1536, 5120]; the
      one-layer train cut runs no MoE layer), a two-dispatch-group capacity
      layout, ragged cases with repeated groups and groups no tile names
      (dw exactly 0), block_m 1, 8, 64, 70 and 512, K and N off the tile
      edges, in float32, float16 and bfloat16; the same bits on a second
      launch; dx counted once on the path ``dx_path`` names (16-bit on
      ``wgmma`` or ``wgmma_padded``, never ``fma_f32``);
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
      dispatch, its steps equal to the plan steps);
   d. ``MeshDeviceSession`` with 1, 2 and 4 shards on ``cuda:0``, each on
      its own CUDA stream, under the loop and wave plan modes: the chain
      universe (4 chunks; its shared weight row keeps it on one shard),
      the same with a weight row a chain (spread over the shards), the
      mixed-tag stream, and the cross-shard
      join stream of ``tests/test_mesh_transfers.py`` (4 chains of two
      rows at width 4096, 4 rounds) under each transfer mode (d2d,
      staged, auto). Every run bit-equal to ``run_serial``; the shards'
      ready-queue launches equal their loop dispatches and their
      wave-kernel launches their wave-kernel dispatches (one launch per
      device dispatch); d2d moves every edge without a host sync, staged
      with them; the transfer table's bytes equal the rows moved times
      16,384; two shards in flight at once on the join stream. Logged: each
      run's wall, and whether two shards' cooperative epochs share the
      card (the kernels' intervals per stream under ``torch.profiler``,
      summed and united: the spread chains through a 2-shard mesh, and
      two half chain universes launched back to back on two streams).
5. ACS-SW main path: the cheetah physics stream (64 envs, 8 groups,
   5 steps) through the serial, wave and threaded (4 CUDA streams)
   schedulers, bit-equal across the three and finite.
5a. The analytic model (``core/perfmodel.py``): the card's launch and sync
   latency (medians of 200 small launches and synchronizes), the values
   ``H100_LIKE`` holds, and ``simulate`` under ``H100_LIKE`` for serial,
   ACS-SW, ACS-HW and the CUDA-graph policy on one cheetah step and on the
   chain universe, beside this run's walls. Logged, not checked.
5b. The dynamic-DNN workloads (``dyn/``): all seven (InstaNAS, Dynamic
   Routing, CondConv; NASNet, AmoebaNet, SqueezeNet, RandWire) at the
   reference's sizes (batch 1, 3x32x32), each on 8 seeded inputs through
   the serial, wave, threaded and frontier schedulers, the device window
   and ``DeviceSession`` in the loop, wave and frontier plan modes, and
   ``DagRunner`` (the static nets also constructing once and replaying):
   every output finite and bit-equal to ``run_serial``'s, InstaNAS's and
   Dynamic Routing's task counts varying with the input and the others'
   not (CondConv's input dependence is in its mixed weights), the
   frontier's ``max_inflight_groups()`` above 1 (InstaNAS's too), and none
   of the six kernels launched (their routes take only padding-free 1-D
   rows; a dyn epoch runs the step path or the loop interpreter). Tasks,
   dispatches, wave widths, blocking syncs, in-flight groups, the DAG's
   construction time and dependency checks, and walls are logged.
5c. The examples (``examples/torch_*.py``), run after phase 7 and before
   phase 9: quickstart, physics_rl,
   dynamic_dnn_inference and serve_continuous, each one's ``main`` in this
   process at its default arguments on the card and again on the CPU.
   Their counts, dispatches, waves and wave widths equal across the two;
   quickstart's ACS states bit-equal to its own serial run on each device
   and the card's within 2e-5 / 1e-6 of the CPU's; the images' classes
   equal where the logits are not within 1e-4 of a tie; every served
   request's tokens equal to a plain greedy loop on that device's weights,
   and on the card also to the loop with ``ops.attention`` swapped for the
   plain ``attention_ref`` (where the plain loop's two best logits are
   more than 1e-4 apart);
   serve_continuous launches flash once per prefill and attention layer
   on the card, and no other example launches a kernel of ours.
6. Serving main paths, one model after the other (each one's weights
   freed before the next one's are drawn), each at its published widths
   with bf16 weights drawn from seed 0: recurrentgemma-2b (26 layers,
   d_model 2560), granite-moe-3b-a800m cut to 16 of its 32 layers
   (SERVE_CUTS: attention with MoE FFNs, d_model 1536, 40 experts padded
   to 48, top-8), falcon-mamba-7b
   whole (64 Mamba layers, d_model 4096, d_inner 8192, N 16) and
   deepseek-v2-236b cut to 4 layers (SERVE_CUTS: its dense first layer and
   3 MoE layers; MLA with 128 heads, kv_lora 512, q_lora 1536; 160
   experts, top-6, 2 shared, d_expert 1536; 13.3 B parameters),
   h2o-danube-3-4b whole (24 layers, 32 heads of 120 over 8 kv, 3.84 B),
   mistral-large-123b cut to 16 of its 88 layers (96 heads of 128 over 8
   kv, 22.95 B) and gemma2-27b cut to 16 of its 46 layers (local and
   global, the attention softcap 50 and the final softcap 30, vocab
   256,000); each cut's bf16 weights within CARD_MAX_BYTES. Each
   serves 8 seeded prompts of 128-512 tokens, 16 new tokens each, through
   ``SessionServer(scheduler="wave")``, ``SessionServer(scheduler="device")``
   (its ``"loop"`` plan mode; every serving task takes the session's
   in-epoch host path), ``SessionServer(scheduler="frontier")`` (the
   default: one task a group, up to 8 in flight, each retired on its CUDA
   event) and ``ContinuousBatchingServer`` (4 slots, max_len 1024, window
   32); recurrentgemma-2b and granite-moe-3b-a800m also through
   ``SessionServer(scheduler="mesh", n_shards=2)`` (two shards on the
   card, a stream each; MESH_SERVE). Every request gets its 16 tokens, the
   servers' tokens are identical and equal a plain greedy loop over
   ``prefill``/``decode_step``, every logit is finite, and each server run
   launches exactly: the flash kernel once per request and attention or
   MLA layer (recurrentgemma 64, granite 128, deepseek 32, danube 192,
   mistral 128, gemma2 128), the RG-LRU
   scan once per RG-LRU layer and prefill or decode (2,448), the
   selective scan once per Mamba layer and prefill or decode (falcon
   8,704) and the grouped GEMM three times per MoE layer and prefill or
   decode (granite 6,528, deepseek 1,224). After recurrentgemma's and
   granite's server runs, one more serving pass (1 request) runs under
   ``torch.profiler`` for its device busy share (as in 8).
6b. The frontend path, at full width, in float32 and then in bf16:
   musicgen-large (48 layers, audio_stub, 256 seeded frame embeddings of
   512) and paligemma-3b (18 layers, vision_stub, prefix_len 256, D 256
   over one kv head; 256 patch embeddings of 1152 and 64 more positions):
   ``forward`` over the whole sequence, ``prefill`` of the prompt and 16
   teacher-forced ``decode_step``s. Prefill's last logits and every
   step's are within FRONTEND_TOL of forward's at that position (float32
   1e-3 abs and rel, bf16 6 % of forward's largest logit). The bf16 pass
   runs again with the plain attention in place of flash, held to the
   same bound: the witness that bf16's distance comes from the GEMMs'
   rounding; flash's forward logits are within that bound of the plain
   pass's. Flash launches
   once per layer in forward and in prefill, never in decode, and never
   in the plain pass.
7. Numbers: CUDA-event medians of each kernel and its plain version at
   its main path's shape (the wave kernel's epoch entry over the chain
   universe's wave and frontier plans, staged and direct, and its
   single-wave entry at the widest wave and at S = 32; SDPA, its backend
   named, for attention and ``torch.bmm`` for the grouped GEMM as the
   library calls; flash at recurrentgemma's, granite's, deepseek's MLA,
   danube's, paligemma's, gemma2's (softcap: ``flex_attention``, compiled,
   as the library call) and mistral's prefills; the grouped GEMM at granite's and deepseek's
   expert products; both scans at prefill and decode, the selective scan
   through the fused entry at S 512 and 128 and a decode step and alone
   in float32 at S 512, with its grid, warps an SM and SASS instructions
   a state and step), flash, the
   grouped GEMM, the scans and the ready queue also 20 launches back to
   back, flash's and the scans' device times, each kernel's bound, the
   backward kernels at their training shapes (flash's at minicpm-2b's, at
   recurrentgemma-2b's D 256, at deepseek-v2's MLA (D 192, Dv 128), at
   h2o-danube-3-4b's D 120 over 8 kv, at paligemma-3b's D 256 with its
   256-position prefix (SDPA through an explicit mask) and at gemma2-27b's
   softcap (``flex_attention``) beside the library call's backward through
   autograd, its output held to the plain version's and its backend named, with its path, its plan's blocks, split key tiles
   and workspace slots, each pass's device time (prologue, dK/dV,
   reduction, dQ) and its kernels' ``ptxas -v``; the grouped GEMM's dx and
   dw at granite's and deepseek-v2's gate/up and down products beside
   ``torch.bmm`` on the capacity layout, dx on ``"wgmma"`` at each with its plan (grid, tile
   width), each width's times, the bytes TMA loads and ``ptxas -v``, dw
   with its path, grid, ``ptxas -v`` and the float32 path's tile-table
   kernel timed alone, and the forward at the same shapes beside
   ``torch.bmm(x, w)``; the RG-LRU reverse scan at [4,
   512, 2560] f32, no library call; the selective scan's backward at
   falcon-mamba-7b's [4, 512, 8192], N 16, bf16, its kernel and reduction
   timed, no library call; the optimizer's clip and AdamW update at
   minicpm-2b's and granite-moe-3b-a800m's whole leaf sets through
   ``optim.clip_by_global_norm`` and ``optim.adamw_update``, held leaf by
   leaf to ``global_norm_ref`` and ``adamw_step_ref`` (``numbers_adamw``),
   ``torch.optim.AdamW(fused=True)`` on float32 copies of the leaves the
   library call), and
   the wall time of each phase-4/5/6 policy and server. The ready queue also: its device time from
   ``torch.profiler`` (the mean over the kernels the trace holds), that
   of ONE 32-deep chain (over 32: the hop that bounds it) and of one
   task, its grid and the blocks that ran tasks.
8. Device busy share, run after phase 5b and before phase 6: one more
   pass of each phase-4/5 policy, and of InstaNAS's 8 inputs under the
   serial and frontier schedulers, under ``torch.profiler``; the union of
   the CUDA kernels' intervals over the pass's wall ("not measured" if the
   profiler records no kernel), and whether the loop and wave passes' own
   kernels are in the trace. After phase 6's profiled serving passes
   (58k and 130k kernels), a trace in the same process loses the first
   device events of a pass (the loop pass's ready-queue kernel among
   them): one more loop pass is profiled at the end to show it.
9. Training, after phase 7 and before phase 6, for each of TRAIN_ARCHS
   whole (each model freed before the next is built): minicpm-2b (40
   layers, 2.72 B parameters), granite-moe-3b-a800m (32 layers, 40
   experts, 3.30 B) and recurrentgemma-2b (26 layers, 18 RG-LRU, D 256,
   2.90 B), h2o-danube-3-4b (24 layers, D 120 over 8 kv, 3.84 B),
   paligemma-3b (18 layers, D 256 over one kv head, prefix 256, 2.51 B)
   and musicgen-large (48 layers of 32-head MHA at D 64, 3.23 B), and cut
   in depth (TRAIN_CUTS) deepseek-v2-236b (its first, dense layer: MLA at
   D 192 / Dv 128, 1.39 B), falcon-mamba-7b (16 of its 64 layers), gemma2-27b (one stage: a local and a global layer, softcap 50,
   2.31 B) and mistral-large-123b (one layer, 96 heads over 8 kv, 2.19 B),
   each within CARD_MAX_BYTES of weights, gradients and AdamW state, bf16
   from seed 0, tp_size 1, AdamW's float32 master, m and v on the card,
   batches of TokenPipeline(vocab, 512, 4, seed=0) (the frontend archs'
   inputs seeded [4, 512, F] embeddings, their labels the pipeline's):
   step 0's loss and gradients through the kernels against the
   same step with ``ops.attention``, ``ops.grouped_matmul``,
   ``ops.lru_scan`` and ``ops.mamba_scan`` swapped for their plain
   versions (TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL,
   TRAIN_MIN_COSINE; a MoE's plain pass replays the kernel pass's routing
   choices, and a plain pass routing for itself is logged beside it), then
   5 ``StepBundle.train_step``s (remat, lr 3e-4, clip 1.0): losses and
   gradient norms finite, each kernel launched exactly so many times a
   step (``expected_train_launches``: minicpm flash 80 / 40; granite flash
   64 / 32, grouped GEMM 192, dx 96 (all on its wgmma path), dw 96;
   recurrentgemma flash 16 / 8,
   RG-LRU 34 (its two prefix layers are not recomputed), reverse 18;
   deepseek flash 1 / 1 (a prefix layer); falcon-mamba scan 64, its
   backward 32; flash: danube 48 / 24, paligemma 36 / 18, musicgen 96 /
   48, gemma2 4 / 2, mistral 2 / 1);
   step ms, tokens/s, MFU (6 N D, a MoE's N its
   active parameters, over the bf16 peak) and peak device memory logged,
   and one more step under ``torch.profiler`` (device time by kernel
   group). Phase 7 also times flash's forward with and without its lse
   output.
9b. The ``Trainer`` at a reduced minicpm (TRAINER_CUT, bf16): 20 steps
   uninterrupted; a run checkpointed every 10 steps crashed at 15 and
   resumed by a fresh ``Trainer``, whose steps 10-19 give the
   uninterrupted run's losses and gradient norms bit for bit.
10. The production-mesh dry run, after phase 9b, in this process: two
   cells traced at published widths over a fake world of H100s
   (``repro_torch.launch.dryrun.run_cell``: fake DTensors, the flash and
   grouped-GEMM ops' fake implementations), minicpm-2b/train_4k on 16 x 16
   and granite-moe-3b-a800m/train_4k on 2 x 16 x 16, each record logged;
   then recurrentgemma-2b/long_500k on 2 x 16 x 16 (channels and ring rows
   folded over all three axes) and falcon-mamba-7b/train_4k on 16 x 16
   (the scans' ops channel-sharded), whose FLOPs, bytes, wire bytes and
   peak bytes must equal the CPU's records (``DRYRUN_RECORDS``, PERF.md
   section 6) exactly; no kernel launch counter moves and
   ``torch.cuda.memory_allocated()`` is the same before and after. The
   card's memory (``get_device_properties``) must be the dry run's
   ``CARD_MEMORY_BYTES``. Then minicpm-2b traced at phase 9's shape
   (4 x 512, remat) in a fake world of 1: its peak bytes beside phase 9's
   measured peak, its FLOPs beside 6 N D. Last, the ops' host cost: a
   flash, a grouped-GEMM, an RG-LRU scan and a Mamba scan call through
   ``torch.ops`` against the same launch through the wrapper's launch
   function, host clock, at a decode step's shapes.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the ``repro_torch`` package beside this
file, it exits with an error and prints no result.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
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
# Exponentials on the special-function units: 16 a clock on each of the
# 132 SMs (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0) at the H100 SXM's 1.98 GHz boost clock.
SFU_EXP_PER_S = 132 * 16 * 1.98e9

CHAINS, WIDTH, DEPTH, WINDOW = 64, 4096, 32, 32
# The mesh-sharded window (phase 4d): logical shards on the one card, each
# on its own stream; tests/test_mesh_transfers.py's join stream at width
# 4096, cut to 4 rounds (at its 6 the values overflow to inf).
MESH_SHARDS, MESH_MODES, TRANSFER_MODES = (1, 2, 4), ("loop", "wave"), ("d2d", "staged", "auto")
JOIN_CHAINS, JOIN_ROUNDS = 4, 4
SIM_ENVS, SIM_GROUP, SIM_STEPS, SIM_STREAMS = 64, 8, 5, 4
TIMED_RUNS = 20

# The serving passes, at their published widths: recurrentgemma-2b and
# falcon-mamba-7b whole, and deepseek-v2-236b cut to its first 4 layers
# (SERVE_CUTS: the dense prefix layer and 3 MoE layers; all 60 would take
# 471 GB in bf16); h2o-danube-3-4b (3.84 B, D 120 over 8 kv heads) whole,
# and mistral-large-123b cut to 16 of its 88 layers (22.95 B, 45.9 GB; all
# 88 would take 245 GB; 96 query heads over 8 kv). granite-moe-3b-a800m
# and gemma2-27b (its attention and final softcaps, local and global
# layers, a 256,000-entry vocab) are cut to 16 layers for the script's
# time limit: they served whole in 110-160 s of its ~1,000 on a slow host.
# The first two also get a profiled pass.
SERVE_ARCHS, SERVE_SEED = ("recurrentgemma-2b", "granite-moe-3b-a800m", "falcon-mamba-7b",
                           "deepseek-v2-236b", "h2o-danube-3-4b", "mistral-large-123b",
                           "gemma2-27b"), 0
SERVE_CUTS = {"deepseek-v2-236b": {"n_layers": 4}, "mistral-large-123b": {"n_layers": 16},
              "granite-moe-3b-a800m": {"n_layers": 16}, "gemma2-27b": {"n_layers": 16}}
PROFILED_SERVE = ("recurrentgemma-2b", "granite-moe-3b-a800m")
# The mesh server (MESH_SERVE_SHARDS shards on the card) serves these two;
# falcon-mamba-7b and deepseek-v2 skip it to keep the script near half its
# time limit.
MESH_SERVE, MESH_SERVE_SHARDS = ("recurrentgemma-2b", "granite-moe-3b-a800m"), 2
SERVE_REQUESTS, SERVE_MIN_PROMPT, SERVE_MAX_PROMPT, SERVE_MAX_NEW = 8, 128, 512, 16
SERVE_SLOTS, SERVE_MAX_LEN = 4, 1024

# The frontend archs, whole: their prompt length in frames or patches
# (paligemma: its 256-patch image prefix and 64 text positions), then
# FRONTEND_STEPS teacher-forced decode steps, in float32 and in bf16. The
# logits are held to forward's at each position within FRONTEND_TOL: abs,
# rel, and a share of forward's largest logit. The decode path attends in
# ``_cached_attention`` where prefill and forward go through flash, and
# the GEMMs have other shapes, over 18-48 layers; a wrong position, mask
# or cache row moves logits by the order of the largest. float32 rounds
# at 2^-24: 1e-3 abs and rel. In bf16 the same paths differ by a few bf16
# ulps of the logits already between prefill and forward (GEMMs over 256
# and 272 rows round differently), and as much with the plain attention
# in place of flash; on an H100 80GB HBM3 at 700 W, musicgen-large: 0.1025
# with flash, 0.1094 with the plain attention, logits up to 4.66. So bf16
# is held to 6 % of the largest logit (0.28 there, 0.031 on paligemma's
# 0.52).
FRONTEND_ARCHS = {"musicgen-large": 256, "paligemma-3b": 256 + 64}
FRONTEND_STEPS = 16
FRONTEND_TOL = {"float32": (1e-3, 1e-3, 0.0), "bfloat16": (0.0, 0.0, 0.06)}

# The training phase (9), for each of TRAIN_ARCHS whole at its published
# widths (minicpm-2b: 40 layers, d_model 2304, 36 heads of 64;
# granite-moe-3b-a800m: 32 layers, d_model 1536, GQA 24/8 of 64, 40
# experts of 512, top-8; recurrentgemma-2b: 26 layers, 18 RG-LRU and 8
# local-attention, d_model 2560, 10 heads of 256 over 1, window 2048), bf16,
# weights from seed 0, tp_size 1, on TokenPipeline(vocab, 512, 4, seed=0)
# batches: TRAIN_STEPS steps of StepBundle.train_step at lr 3e-4 and clip
# 1.0 (each stage recomputed in the backward, the reference's remat). Each
# model is freed before the next is built. TRAIN_ARCH is the one the
# Trainer's crash-and-resume phase (9b) cuts down.
# deepseek-v2-236b and falcon-mamba-7b do not fit whole beside AdamW's
# state (16 bytes a parameter): deepseek's one MoE layer alone is 3.77 B
# parameters (its first, dense layer and the embeddings 1.39 B, 22.2 GB),
# falcon-mamba's 64 layers 6.73 B (107.7 GB; 32 layers 3.50 B, 56.0 GB;
# trained at 16 for the script's time limit).
# h2o-danube-3-4b (24 layers, 3.84 B, 61.4 GB; D 120 over 8 kv heads, the
# tightest fit), paligemma-3b (18 layers, 2.51 B, D 256 over one kv head,
# its 256-position bidirectional prefix) and musicgen-large (48 layers of
# 32-head MHA at D 64, 3.23 B) train whole; the frontend two on seeded
# [4, 512, F] embeddings (FRONTEND_DIMS) with the pipeline's labels.
# gemma2-27b is cut to one stage, a local and a global layer (2.31 B, 37.0
# GB; its 256,000 x 4608 embedding alone is 1.18 B; the softcaps), and
# mistral-large-123b to one layer (2.19 B, 35.0 GB; 96 heads over 8 kv).
TRAIN_ARCHS = ("minicpm-2b", "granite-moe-3b-a800m", "recurrentgemma-2b", "deepseek-v2-236b",
               "falcon-mamba-7b", "h2o-danube-3-4b", "paligemma-3b", "musicgen-large",
               "gemma2-27b", "mistral-large-123b")
TRAIN_CUTS = {"deepseek-v2-236b": {"n_layers": 1}, "falcon-mamba-7b": {"n_layers": 16},
              "gemma2-27b": {"n_layers": 2}, "mistral-large-123b": {"n_layers": 1}}
# CARD_MAX_BYTES bounds each served model's bf16 weights (2 bytes a
# parameter) and each trained one's weights, gradients and AdamW state (16
# bytes a parameter), leaving the card room for caches and activations
# (held by tests/test_torch_smoke_plan.py).
CARD_MAX_BYTES = 70e9
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR, TRAIN_CLIP = (
    "minicpm-2b", 512, 4, 5, 3e-4, 1.0)
# Step 0's loss and gradients through the kernels (flash forward and its
# backward, the grouped GEMM and its dx and dw, the RG-LRU scan and its
# reverse, the selective scan and its backward) held to the same step with
# ops.attention, ops.grouped_matmul, ops.lru_scan and ops.mamba_scan
# swapped for their plain versions (autograd through them),
# both in bf16 on the card. The two paths differ by bf16 roundings only:
# flash rounds P to bf16 before its PV product and P and dS before its
# backward products where the plain attention computes in float32 and
# rounds its output; the grouped GEMM's products round to bf16 once either
# way, in other summation orders (the plain dw sums a group's tiles in
# float32 and rounds once, as the kernel does); the RG-LRU scan runs in
# float32, bit-equal both ways. Each output or gradient is a few bf16 ulps
# (2^-8 relative) apart, and 26-40 layers of bf16 GEMMs carry that into
# the weights' gradients as noise of about that relative size. The loss
# at initialisation is about ln(vocab) (10.8-12.5); a wrong mask, scale,
# row, tile or step moves it by far more than 1e-2 and turns a gradient's
# direction: loss within 1e-2 absolute, the global gradient norm within
# 2 %, and each weight's gradient at cosine >= 0.99 with its plain twin.
# MoE: a bf16 difference upstream flips near-tied top-8 choices and moves
# tokens between experts, and at initialisation the router's 40 scores a
# token are close: on an H100 80GB HBM3, 2,534 of the 2,560 (layer,
# expert) token sets of granite's step 0 differ between a kernel pass and
# a plain pass that route for themselves, and their gradients are then
# another function's (median leaf cosine 0.435). So the plain pass replays
# the kernel pass's routing choices (its probabilities computed from its
# own input, as the router does) and carries the gates; a second plain
# pass that routes for itself is logged beside it.
TRAIN_LOSS_ATOL, TRAIN_GNORM_RTOL, TRAIN_MIN_COSINE = 1e-2, 0.02, 0.99
# The float32 truth: the same weights cast to float32 through the plain
# versions, with the same routing. Even with the routing pinned, granite's
# bf16 step-0 gradient is noisy: on the same card the plain bf16 path's
# leaves stand at median cosine 0.970 (lowest 0.943) from the float32
# ones, the kernel path's at 0.971 (0.950), so no bf16 path meets 0.99
# against another (kernels against plain: median 0.976). The 0.99 bound
# therefore holds where the plain bf16 path's every leaf is within it of
# the float32 gradient (minicpm-2b, recurrentgemma-2b), and for every
# arch each leaf's distance 1 - cosine from the float32 gradient through
# the kernels is at most TRAIN_TRUTH_RATIO times the plain bf16 path's
# plus TRAIN_TRUTH_FLOOR: a wrong tile, row or mask sends a leaf to a
# cosine far below the plain path's.
TRAIN_TRUTH_RATIO, TRAIN_TRUTH_FLOOR = 2.0, 1e-3
# The Trainer's crash and resume on the card (phase 9b), at a reduced
# minicpm: a full-width checkpoint would be ~38 GB of files. 20 steps, a
# checkpoint at step 10, a crash at step 15, a fresh Trainer resuming;
# its losses for steps 10-19 must equal an uninterrupted run's bit for bit.
TRAINER_CUT = {"n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 4, "head_dim": 64,
               "d_ff": 640, "vocab": 8192}
TRAINER_STEPS, TRAINER_EVERY, TRAINER_FAIL = 20, 10, 15


def free_device_memory() -> None:
    """Collect any reference cycles that still hold a freed model and return
    the freed blocks to the card: the next model is drawn into an empty
    card. (The servers form no such cycle since their kernels close over
    the model, not the server; ``tests/test_torch_serve.py`` holds that.)"""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


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

def chain_universe(device, seed=0, n_chains=CHAINS, width=WIDTH, depth=DEPTH,
                   shared_weight=True):
    """Per-chain state buffers and one shared read-only weight row (with
    ``shared_weight=False``, a weight row for each chain); each chain
    applies ``depth`` RAW-serialized kernels (axpy/mul alternating), chains
    are mutually independent."""
    from repro_torch.core import BufferPool, Task
    from repro_torch.core.task import default_segments
    from repro_torch.kernels.ops import LOOP_BRANCHES

    rng = np.random.RandomState(seed)
    pool = BufferPool(device)
    states = [pool.alloc((width,), np.float32, name=f"chain{i}",
                         value=rng.randn(width).astype(np.float32))
              for i in range(n_chains)]
    weights = [pool.alloc((width,), np.float32, name=f"weight{i}",
                          value=rng.randn(width).astype(np.float32))
               for i in range(1 if shared_weight else n_chains)]
    tasks = []
    for i, s in enumerate(states):
        weight = weights[0 if shared_weight else i]
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


def cross_shard_joins(device, seed=0, n_chains=JOIN_CHAINS, width=WIDTH, rounds=JOIN_ROUNDS):
    """``n_chains`` independent two-buffer chains (a mesh spreads them over
    its shards) joined to their neighbour on odd rounds: each join is a
    cross-shard edge once the chains sit on different shards."""
    from repro_torch.core import BufferPool, Task
    from repro_torch.core.task import default_segments
    from repro_torch.kernels.ops import LOOP_BRANCHES

    rng = np.random.RandomState(seed)
    pool = BufferPool(device)
    chains = [[pool.alloc((width,), np.float32, name=f"c{c}b{k}",
                          value=rng.randn(width).astype(np.float32)) for k in range(2)]
              for c in range(n_chains)]
    tasks = []

    def task(name, ins, outs):
        r, w = default_segments(ins, outs)
        tasks.append(Task(opcode=name, fn=LOOP_BRANCHES[name], inputs=ins, outputs=outs,
                          read_segments=r, write_segments=w))

    for r in range(rounds):
        for a, b in chains:
            task("axpy", (a, b), (a,))
            task("mul", (a, b), (b,))
        if r % 2 == 1:
            for c in range(n_chains):
                task("axpy", (chains[(c + 1) % n_chains][0], chains[c][0]), (chains[c][0],))
    return [b for ch in chains for b in ch], tasks


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


def kernel_builds():
    """(source, build) of every kernel library of the port: one per wrapper
    module, and flash attention's backward."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    return [(m.SOURCE, m.build) for m in kernel_modules()] + [
        (fa.BACKWARD_SOURCE, fa.build_backward),
        (fa.BACKWARD_WGMMA_SOURCE, fa.build_backward_wgmma)]


def phase_build():
    """Build every kernel of the port, one nvcc each, started together."""
    from repro_torch.kernels._nvcc import resources

    builds = kernel_builds()
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: b[1](), builds))
    for (source, _), (path, seconds) in zip(builds, built):
        log(f"build: {source.name} -> {path.name} in {seconds:.2f} s (sm_90a)")
        for line in resources(path):
            log(f"ptxas: {source.name}: {line}")


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
    we = importlib.import_module("repro_torch.kernels.wave_elementwise")

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
    phase_lru_bwd_vs_plain(device)


def phase_lru_bwd_vs_plain(device):
    """The reverse scan (``lru_scan_bwd``) bit-equal to ``lru_scan_bwd_ref``
    on da, db and dh0 over the forward's sweep (B 1 and 4) in float32 and
    bf16, h the forward kernel's output; with dh0 not asked for it is not
    written; a bf16 h0 gives a bf16 dh0; a second launch gives the same
    bits."""
    import torch
    from repro_torch.kernels.ref import lru_scan_bwd_ref

    ls = importlib.import_module("repro_torch.kernels.lru_scan")
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    sweep_b, sweep_s, sweep_d = (1, 4), (1, 37, 63, 64, 65, 512), (2560, 1000, 7)
    for d in sweep_d:
        for b in sweep_b:
            for s in sweep_s:
                for dtype in (torch.float32, torch.bfloat16):
                    a = torch.rand(b, s, d, generator=gen, device=device).to(dtype)
                    x = torch.randn(b, s, d, generator=gen, device=device).to(dtype)
                    h0 = torch.randn(b, d, generator=gen, device=device)
                    if dtype == torch.bfloat16 and s == 37:
                        h0 = h0.to(dtype)
                    h = ls.lru_scan(a, x, h0)
                    dh = torch.randn(b, s, d, generator=gen, device=device).to(dtype)
                    got = ls.lru_scan_bwd(a, h, h0, dh)
                    want = lru_scan_bwd_ref(a, h, h0, dh)
                    torch.cuda.synchronize()
                    for name, g, w in zip(("da", "db", "dh0"), got, want):
                        check(g.dtype == w.dtype and torch.equal(_int_bits(g), _int_bits(w)),
                              f"lru_scan reverse {name} != plain (B {b}, S {s}, D {d}, {dtype})")
                    if s == 65:
                        again = ls.lru_scan_bwd(a, h, h0, dh, need_dh0=False)
                        check(again[2] is None and torch.equal(again[0], got[0])
                              and torch.equal(again[1], got[1]),
                              f"lru_scan reverse: a second launch (no dh0) gave other bits "
                              f"(B {b}, D {d}, {dtype})")
    log(f"lru_scan reverse scan == plain, bit for bit (da, db, dh0): B {set(sweep_b)} x S "
        f"{set(sweep_s)} x D {set(sweep_d)}, float32 and bfloat16 (bf16 h0 at S 37); a second "
        f"launch without dh0 gives the same bits")


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
    # musicgen-large (32 heads over 32 kv heads, D 64, causal) and
    # paligemma-3b (8 heads over 1, D 256, a bidirectional 256-key prefix
    # over four query and key tiles): their prefill and forward lengths
    *(((1, 32, 32, s, s, 64), {}) for s in (256, 272)),
    *(((1, 8, 1, s, s, 256), {"prefix_len": 256}) for s in (320, 336)),
    ((1, 24, 8, 1, 1024, 64), {"q_offset": 1023}),
    ((1, 4, 2, 65, 65, 64), {}),  # one row and one key past a tile
    ((1, 4, 1, 127, 127, 128), {"window": 50}),  # the window edge inside tiles
    ((2, 4, 2, 333, 333, 24), {}),  # element loads, D padded to 64
    ((1, 8, 8, 100, 100, 8), {"causal": False}),
    ((1, 4, 2, 130, 200, 64), {"q_offset": 70, "prefix_len": 100}),  # prefix past a tile
    ((1, 2, 1, 127, 2500, 128), {"q_offset": 2373, "window": 300, "softcap": 20.0}),
    ((1, 4, 4, 1, 2500, 128), {"q_offset": 2499, "window": 300}),
    ((1, 4, 2, 70, 70, 64), {"q_offset": -66}),  # a whole query tile sees no key
    # Dv != D, (b, h, hkv, sq, sk, d, dv): deepseek-v2's MLA prefill (q and k
    # 128 nope + 64 rope wide, v 128), then the edges of the (192, 128)
    # instantiation: one row and key past a tile, D and Dv below the
    # padding, element loads, Dv above D, a one-wide v or q, masks inside
    # tiles, decode, fully masked rows.
    ((1, 128, 128, 512, 512, 192, 128), {}),
    ((1, 4, 4, 65, 65, 192, 128), {}),
    ((1, 4, 2, 127, 127, 136, 120), {"window": 50}),
    ((2, 4, 4, 333, 333, 130, 66), {}),
    ((1, 2, 1, 100, 100, 64, 128), {"causal": False}),
    ((1, 2, 2, 90, 90, 192, 1), {}),
    ((1, 2, 2, 90, 90, 1, 128), {}),
    ((1, 4, 4, 300, 300, 192, 128), {"window": 100, "softcap": 30.0, "prefix_len": 17}),
    ((1, 4, 4, 1, 700, 192, 128), {"q_offset": 699}),
    ((1, 4, 4, 70, 70, 192, 128), {"q_offset": -66}),
]
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def phase_flash_vs_plain(device):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    for shape, flags in FLASH_SWEEP:
        (b, h, hkv, sq, sk, d), dv = shape[:6], shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, h, sq, d, generator=gen, device=device).to(dtype)
            k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
            v = torch.randn(b, hkv, sk, dv, generator=gen, device=device).to(dtype)
            got = flash_attention(q, k, v, **flags)
            want = attention_ref(q, k, v, **flags)
            torch.cuda.synchronize()
            tol = FLASH_TOL[str(dtype).replace("torch.", "")]
            err = (got.float() - want.float()).abs()
            bound = tol + tol * want.float().abs()
            check(got.shape == want.shape and bool((err <= bound).all()),
                  f"flash_attention != plain at {shape} {flags} {dtype}: "
                  f"max abs err {float(err.max())}")
            if flags.get("q_offset", 0) < 0:
                check(bool((got[:, :, :-flags["q_offset"]] == 0).all()),
                      "flash_attention: a fully masked row is not 0")
            check(torch.equal(flash_attention(q, k, v, **flags), got),
                  "flash_attention: a second launch gave other bits")
            log(f"flash_attention ~ plain: {shape} {flags} "
                f"{str(dtype).replace('torch.', '')} max abs err {float(err.max()):.3g}")
    for d, dv in ((192, 129), (200, 128), (264, 264)):  # no instantiation takes these
        q = torch.zeros(1, 1, 4, d, device=device, dtype=torch.bfloat16)
        v = torch.zeros(1, 1, 4, dv, device=device, dtype=torch.bfloat16)
        try:
            flash_attention(q, q, v)
        except ValueError as exc:
            log(f"flash_attention: D {d}, Dv {dv} raises ({exc})")
        else:
            check(False, f"flash_attention: D {d}, Dv {dv} did not raise")


# Flash's backward against attention_bwd_ref (phase 3d'), (b, h, hkv, sq,
# sk, d) with Dv == D: minicpm-2b's training shape, GQA, the window, the
# prefix and softcap, a ragged Sk (a chunk at q_offset), rows that see no
# key (a whole query tile of them), no causal mask, element loads (D 24),
# D 120 off the padding, and h2o-danube-3-4b's widths (D 128 over 8 kv
# heads). float32 sums in another order (1e-4 of the largest entry); bf16
# rounds P and dS to bf16 before their products and the gradients on the
# way out (2e-2 of the largest entry).
FLASH_BWD_SWEEP = [
    ((4, 36, 36, 512, 512, 64), {}),
    ((2, 8, 2, 130, 130, 64), {}),
    ((1, 4, 4, 200, 200, 64), {"window": 50}),
    ((1, 4, 1, 150, 150, 128), {"prefix_len": 70}),
    ((1, 4, 2, 97, 97, 128), {"softcap": 2.0}),
    ((1, 4, 2, 33, 300, 64), {"q_offset": 267}),
    ((1, 2, 1, 100, 100, 64), {"q_offset": -70}),
    ((1, 2, 2, 100, 77, 64), {"causal": False, "window": 20}),
    ((2, 4, 2, 70, 70, 24), {}),
    ((1, 4, 4, 129, 129, 120), {"window": 40, "prefix_len": 9}),
    ((1, 32, 8, 512, 512, 128), {"window": 4096}),
    # D 256: recurrentgemma-2b's training shape
    # (10 heads over 1, window 2048), a window that binds, paligemma-3b's
    # 256-key prefix (8 heads over 1), softcap, blind rows, a ragged chunk
    # and D 200 / 136 off the padding.
    ((4, 10, 1, 512, 512, 256), {"window": 2048}),
    ((1, 10, 1, 600, 600, 256), {"window": 100}),
    ((1, 8, 1, 320, 320, 256), {"prefix_len": 256}),
    ((1, 4, 2, 97, 97, 256), {"softcap": 2.0}),
    ((1, 2, 1, 100, 100, 256), {"q_offset": -70}),
    ((1, 4, 2, 65, 130, 200), {"q_offset": 65}),
    ((2, 4, 4, 70, 70, 136), {"causal": False, "window": 20}),
    # Dv != D (a seventh entry, v's width): deepseek-v2's MLA training
    # shape (128 heads, D 192, Dv 128), a ragged Sk, Sq off the 64-row
    # tiles, GQA with a window, and the reduced MLA's 16 / 8 with a prefix.
    ((4, 128, 128, 512, 512, 192, 128), {}),
    ((1, 4, 2, 97, 150, 192, 128), {"q_offset": 53}),
    ((2, 8, 8, 100, 100, 192, 128), {}),
    ((1, 8, 2, 130, 130, 192, 128), {"window": 40}),
    ((2, 4, 4, 70, 70, 16, 8), {"prefix_len": 9}),
]
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The sweep's rows that phase 3d' also runs with q and dO off 16-byte
# alignment (the wgmma kernels on padded copies), one for each tile width:
# GQA at D 64, h2o-danube-3-4b's D 128, recurrentgemma-2b's D 256 and MLA's
# 192 / 128 over GQA.
FLASH_BWD_PADDED = (1, 10, 11, 21)


def _bwd_shape(shape):
    """``(b, h, hkv, sq, sk, d, dv)`` of a FLASH_BWD_SWEEP row (dv = d
    where the row has no seventh entry)."""
    return (*shape[:6], shape[6] if len(shape) > 6 else shape[5])


def phase_flash_bwd_vs_plain(device):
    """The backward kernel against ``attention_bwd_ref`` on the forward
    kernel's o and lse over FLASH_BWD_SWEEP (Dv == D, and MLA's Dv != D),
    float32 and bf16; lse against ``attention_lse_ref`` (1e-4; -inf on a
    row that sees no key); the forward's output bits the same with and
    without lse; the backward's bits the same on a second launch (no
    atomics); under grad at D 192, Dv 128 the Function runs the wgmma
    backward."""
    import torch
    from repro_torch.kernels.ref import attention_bwd_ref, attention_lse_ref, attention_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    for shape, flags in FLASH_BWD_SWEEP:
        b, h, hkv, sq, sk, d, dv = _bwd_shape(shape)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, h, sq, d, generator=gen, device=device).to(dtype)
            do = torch.randn(b, h, sq, dv, generator=gen, device=device).to(dtype)
            k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
            v = torch.randn(b, hkv, sk, dv, generator=gen, device=device).to(dtype)
            out, lse = fa.flash_attention_lse(q, k, v, **flags)
            check(torch.equal(out, fa.flash_attention(q, k, v, **flags)),
                  f"flash_attention: the lse output changed the forward's bits at {flags}")
            want_lse = attention_lse_ref(q, k, **flags)
            check(bool(torch.isclose(lse, want_lse, rtol=1e-4, atol=1e-4).all()),
                  f"flash_attention lse != plain at {(b, h, hkv, sq, sk, d)} {flags} {dtype}")
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
            want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
            torch.cuda.synchronize()
            tol = FLASH_BWD_TOL[str(dtype).replace("torch.", "")]
            rel = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err, scale = float((g.float() - w).abs().max()), float(w.abs().max())
                check(g.dtype == dtype and g.shape == w.shape and err <= tol * scale,
                      f"flash backward {name} != plain at {(b, h, hkv, sq, sk, d, dv)} {flags} "
                      f"{dtype}: max abs err {err}, largest entry {scale}")
                rel.append(err / scale if scale else err)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
            check(all(torch.equal(x, y) for x, y in zip(again, got)),
                  "flash backward: a second launch gave other bits")
            log(f"flash backward ~ plain: {(b, h, hkv, sq, sk, d, dv)} {flags} "
                f"{str(dtype).replace('torch.', '')} max err / largest entry "
                f"dq {rel[0]:.3g} dk {rel[1]:.3g} dv {rel[2]:.3g}; path "
                f"{fa.backward_path(q, k, v, out, do)}")
    # Rows TMA cannot address (q and dO views one element into their
    # buffers, so not 16-byte aligned): the wgmma kernels on aligned copies,
    # at each tile width, in bf16 and f16 (held to the bf16 tolerance).
    for case in FLASH_BWD_PADDED:
        shape, flags = FLASH_BWD_SWEEP[case]
        b, h, hkv, sq, sk, d, dv = _bwd_shape(shape)
        for dtype in (torch.bfloat16, torch.float16):
            q, do = (torch.randn(b * h * sq * w + 1, generator=gen, device=device).to(dtype)
                     [1:].view(b, h, sq, w) for w in (d, dv))
            k = torch.randn(b, hkv, sk, d, generator=gen, device=device).to(dtype)
            v = torch.randn(b, hkv, sk, dv, generator=gen, device=device).to(dtype)
            out, lse = fa.flash_attention_lse(q, k, v, **flags)
            before = dict(fa.backward_paths)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
            want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
            torch.cuda.synchronize()
            check(fa.backward_paths["wgmma_padded"] == before["wgmma_padded"] + 1,
                  f"flash backward: an unaligned q at D {d} did not take the padded path")
            rel = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err, scale = float((g.float() - w).abs().max()), float(w.abs().max())
                check(g.dtype == dtype and err <= FLASH_BWD_TOL["bfloat16"] * scale,
                      f"flash backward (padded path) {name} != plain at "
                      f"{(b, h, hkv, sq, sk, d, dv)} {flags} {dtype}: {err} of {scale}")
                rel.append(err / scale if scale else err)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
            check(all(torch.equal(x, y) for x, y in zip(again, got)),
                  "flash backward (padded path): a second launch gave other bits")
            log(f"flash backward ~ plain on the padded path (q and dO 2 bytes off 16-byte "
                f"alignment) at {(b, h, hkv, sq, sk, d, dv)} {flags} "
                f"{str(dtype).replace('torch.', '')}: max err / largest entry "
                f"dq {rel[0]:.3g} dk {rel[1]:.3g} dv {rel[2]:.3g}")
    # Under grad at MLA's widths: the Function, its forward writing lse and
    # its backward the wgmma kernels, against autograd through the plain
    # version on the same inputs.
    q, k = (torch.randn(1, 4, 96, 192, generator=gen, device=device).to(torch.bfloat16)
            .requires_grad_(True) for _ in range(2))
    v = torch.randn(1, 4, 96, 128, generator=gen, device=device).to(torch.bfloat16)
    v.requires_grad_(True)
    do = torch.randn(1, 4, 96, 128, generator=gen, device=device).to(torch.bfloat16)
    before = (fa.launches, fa.backward_launches, fa.backward_paths["wgmma"])
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(attention_ref(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    counts = (fa.launches - before[0], fa.backward_launches - before[1],
              fa.backward_paths["wgmma"] - before[2])
    errs = [float((g.float() - w.float()).abs().max()) / float(w.float().abs().max())
            for g, w in zip(got, want)]
    check(counts == (1, 1, 1) and max(errs) <= FLASH_BWD_TOL["bfloat16"],
          f"flash_attention under grad at D 192, Dv 128: launches {counts}, errors {errs}")
    log(f"flash_attention under grad at D 192, Dv 128: one forward and one wgmma backward "
        f"launch; gradients within {max(errs):.3g} of autograd through the plain version's "
        f"largest entries")


def scan_inputs(gen, b, s, e, n, device):
    """Selective-scan inputs as a Mamba layer makes them: dt a softplus,
    ``a = -exp(A_log)`` with the reference's ``A_log = log(1..N)`` scaled
    per channel, x, b, c and h0 standard normal."""
    import torch
    import torch.nn.functional as F

    dt = F.softplus(torch.randn(b, s, e, generator=gen, device=device))
    x, bm, cm = (torch.randn(b, s, w, generator=gen, device=device) for w in (e, n, n))
    scale = 0.5 + torch.rand(e, 1, generator=gen, device=device)
    a = -(torch.arange(1, n + 1, device=device, dtype=torch.float32)[None] * scale)
    h0 = torch.randn(b, e, n, generator=gen, device=device)
    return dt, x, bm, cm, a.contiguous(), h0


SCAN_TOL = 1e-5  # float32: the carry into a lane's segment comes from the combine, and
# y sums its N terms in another order than the plain version's einsum

# (B, S, E, N) of the scan's sweep: falcon-mamba-7b's prefill (S 512 and the
# serving runs' shortest prompt, 128) and decode (B 1, and the continuous-
# batching server's 4 slots); S on both sides of the kernel's 8-step
# segments, 128- and 256-step chunks and 2-chunk carries, for B 1, 3, 4,
# with E off the channel tile (1000: 16-byte rows; 37: element copies) and
# N 16 and 5; N from 1 to 16.
SCAN_FALCON = [(1, 512, 8192, 16), (1, 128, 8192, 16), (1, 1, 8192, 16), (4, 1, 8192, 16)]
SCAN_SWEEP = (SCAN_FALCON
              + [(b, s, e, n) for b in (1, 3, 4) for s in (1, 127, 128, 129, 511, 512, 513, 2049)
                 for e, n in ((1000, 16), (37, 5))]
              + [(1, 70, 64, n) for n in range(1, 17)])
# The fused entry at falcon's shapes and the sweep's edges, float32 and bf16.
FUSED_SWEEP = SCAN_FALCON + [(3, 129, 1000, 5), (2, 513, 40, 16), (1, 2049, 37, 16),
                             (4, 1, 1000, 16), (1, 127, 96, 1), (3, 256, 64, 16)]


def fused_inputs(gen, b, s, e, n, dtype, device, rank=256):
    """The fused entry's arguments as a Mamba layer passes them: dt_raw, x
    (a silu output) in the model dtype, z the second half of an in
    projection ``[B, S, 2E]``, b and c slices of an x projection ``[B, S,
    rank + 2N]`` past the dt rank (falcon's 256), dt_bias, A_log =
    log(1..N) plus noise, D and h0 float32."""
    import torch

    xz = torch.randn(b, s, 2 * e, generator=gen, device=device).to(dtype)
    proj = torch.randn(b, s, rank + 2 * n, generator=gen, device=device).to(dtype)
    dt_raw = torch.randn(b, s, e, generator=gen, device=device).to(dtype)
    x = torch.nn.functional.silu(torch.randn(b, s, e, generator=gen, device=device)).to(dtype)
    a_log = (torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32))[None]
             + 0.1 * torch.randn(e, n, generator=gen, device=device))
    return (dt_raw, 0.5 * torch.randn(e, generator=gen, device=device), x, xz[..., e:],
            proj[..., rank: rank + n], proj[..., rank + n:], a_log.contiguous(),
            torch.randn(e, generator=gen, device=device),
            torch.randn(b, e, n, generator=gen, device=device))


def within_scan_tol(got, want32):
    """``got`` (float32 or rounded to a narrower type) is the rounding of a
    value within SCAN_TOL (abs and rel) of the plain version's float32
    ``want32``: rounding is monotonic, so ``got`` lies between the
    roundings of the interval's ends. Returns (ok, max abs err, max err
    over its tolerance; for a narrower type the error includes the cast's
    own rounding, and the share is None)."""
    tol = SCAN_TOL + SCAN_TOL * want32.abs()
    lo, hi = (want32 - tol).to(got.dtype), (want32 + tol).to(got.dtype)
    err = (got.float() - want32).abs()
    ok = got.shape == want32.shape and bool(((got >= lo) & (got <= hi)).all())
    share = float((err / tol).max()) if got.dtype == want32.dtype else None
    return ok, float(err.max()), share


def scan_rows_alone(fn, args, batched):
    """Each row r of a batched launch ``fn(*args)`` against ``fn`` on row r
    alone (the batch-dimension tensors sliced, the weights as they are),
    bit for bit: a row's results must not depend on B or the other rows."""
    import torch

    n_batch = batched[0].shape[0]
    for r in range(n_batch):
        one = [t[r: r + 1] if t.dim() == 3 and t.shape[0] == n_batch else t for t in args]
        alone = fn(*one)
        if not all(torch.equal(a[0], b[r]) for a, b in zip(alone, batched)):
            return False
    return True


def phase_scan_vs_plain(device):
    """The selective scan against its plain versions within SCAN_TOL (abs
    and rel): the scan alone (``selective_scan``: ys and hT against
    ``selective_scan_ref``) over SCAN_SWEEP; the fused layer span
    (``mamba_scan``: y and hT against ``mamba_scan_ref``; in bf16, y is the
    rounding of a value within SCAN_TOL of the plain version's float32 y)
    over FUSED_SWEEP in float32 and bf16, with z, b and c strided views of
    wider projections. A second launch gives the same bits; each row of a
    B = 4 launch equals a B = 1 launch of that row bit for bit (S 1, 129,
    513); bad inputs raise."""
    import torch
    from repro_torch.kernels.ref import mamba_scan_ref, selective_scan_ref
    from repro_torch.kernels.selective_scan import mamba_scan, selective_scan

    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    worst, worst_rel = 0.0, 0.0
    for b, s, e, n in SCAN_SWEEP:
        args = scan_inputs(gen, b, s, e, n, device)
        got = selective_scan(*args)
        want = selective_scan_ref(*args)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("ys", "hT")):
            ok, err, rel = within_scan_tol(g, w)
            check(ok, f"selective_scan {name} != plain at B {b}, S {s}, E {e}, N {n}: "
                      f"max abs err {err}, {rel:.3f} of the tolerance")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
        again = selective_scan(*args)
        check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
              f"selective_scan: a second launch gave other bits at {(b, s, e, n)}")
    log(f"selective_scan ~ plain within {SCAN_TOL} over {len(SCAN_SWEEP)} shapes (B, S, E, N) "
        f"{SCAN_FALCON} ...: max abs err {worst:.3g}, {worst_rel:.3f} of the tolerance; "
        f"a second launch gives the same bits")
    for dtype in (torch.float32, torch.bfloat16):
        worst, worst_rel = 0.0, 0.0
        for b, s, e, n in FUSED_SWEEP:
            args = fused_inputs(gen, b, s, e, n, dtype, device)
            got = mamba_scan(*args)
            want_y, want_h = mamba_scan_ref(*args, out_dtype=torch.float32)
            torch.cuda.synchronize()
            for g, w, name in ((got[0], want_y, "y"), (got[1], want_h, "hT")):
                ok, err, rel = within_scan_tol(g, w)
                check(ok and g.dtype == (dtype if name == "y" else torch.float32),
                      f"mamba_scan {name} != plain at B {b}, S {s}, E {e}, N {n}, {dtype}: "
                      f"max abs err {err}, outside the {dtype} rounding of the tolerance")
                worst = max(worst, err)
                worst_rel = max(worst_rel, rel) if rel is not None else worst_rel
            again = mamba_scan(*args)
            check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
                  f"mamba_scan: a second launch gave other bits at {(b, s, e, n)}, {dtype}")
        log(f"mamba_scan ({dtype}, z, b and c strided) ~ plain within {SCAN_TOL} over "
            f"{len(FUSED_SWEEP)} shapes: max abs err {worst:.3g} (y's own {dtype} rounding "
            f"included); float32 shares of the tolerance at most {worst_rel:.3f}")
    for s in (1, 129, 513):
        args = scan_inputs(gen, 4, s, 1000, 16, device)
        check(scan_rows_alone(selective_scan, args, selective_scan(*args)),
              f"selective_scan: a row of a B = 4 launch differs from its B = 1 launch (S {s})")
        fargs = fused_inputs(gen, 4, s, 1000, 16, torch.bfloat16, device)
        check(scan_rows_alone(mamba_scan, fargs, mamba_scan(*fargs)),
              f"mamba_scan: a row of a B = 4 launch differs from its B = 1 launch (S {s})")
    log("selective_scan, mamba_scan: each row of a B = 4 launch equals its B = 1 launch, bit "
        "for bit (S 1, 129, 513)")
    dt, x, bm, cm, a, h0 = scan_inputs(gen, 1, 8, 64, 16, device)
    fa = fused_inputs(gen, 1, 8, 64, 16, torch.bfloat16, device)
    bad = {"a state size of 17": (selective_scan, (dt, x, bm, cm, torch.zeros(64, 17, device=device),
                                                   torch.zeros(1, 64, 17, device=device))),
           "float64 x": (selective_scan, (dt, x.double(), bm, cm, a, h0)),
           "a non-contiguous b": (selective_scan,
                                  (dt, x, bm.transpose(1, 2).contiguous().transpose(1, 2), cm,
                                   a, h0)),
           "h0 of another batch": (selective_scan, (dt, x, bm, cm, a,
                                                    h0.expand(2, 64, 16).contiguous())),
           "fused: a float32 z in a bf16 span": (mamba_scan, fa[:3] + (fa[3].float(),) + fa[4:]),
           "fused: dt_bias of 63": (mamba_scan, (fa[0], fa[1][:63]) + fa[2:]),
           "fused: c strided along N": (mamba_scan, fa[:5] + (torch.zeros(
               1, 8, 32, dtype=torch.bfloat16, device=device)[..., ::2],) + fa[6:]),
           "fused: h0 on the CPU": (mamba_scan, fa[:8] + (fa[8].cpu(),))}
    for what, (fn, args) in bad.items():
        try:
            fn(*args)
        except (ValueError, TypeError) as exc:
            log(f"{fn.__name__}: {what} raises ({exc})")
        else:
            check(False, f"{fn.__name__}: {what} did not raise")


# (B, S, E, N) of the scan backward's sweep: falcon-mamba-7b's training
# shape, then the edges: one step, S off the 64-step chunk with B > 1, E off
# the 32-channel tile with N < 16, S past 8 chunks, one whole chunk, N 1.
SCAN_BWD_SWEEP = [(TRAIN_BATCH, TRAIN_SEQ, 8192, 16), (1, 1, 8192, 16), (3, 129, 1000, 5),
                  (2, 513, 40, 16), (4, 64, 96, 16), (1, 200, 37, 1)]
# Each gradient within SCAN_BWD_TOL of its largest entry. float32 1e-5: the
# kernel joins each lane's steps by shuffle scans, sums db and dc over
# channels, warps and channel tiles and da, dD and d dt_bias over lanes,
# chunks and batch rows in other orders than the plain version's reverse
# loop and einsums, and its decay is ex2.approx (2 ulp). bf16 2^-7: both
# round each gradient to bf16 once from float32, so a difference in the
# last float32 bits can move that rounding by one bf16 ulp (2^-8 of the
# entry); the float32 parameters' gradients are held to 1e-5 in both.
SCAN_BWD_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def scan_bwd_errors(got, want, tol_of):
    """(ok, {name: max err / largest entry}) of gradients against their
    plain versions, each within ``tol_of(g)`` of its largest entry, in its
    input's dtype and shape."""
    ok, rel = True, []
    for g, w in zip(got, want):
        err, scale = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        ok = ok and g.dtype == w.dtype and g.shape == w.shape and err <= tol_of(g) * scale
        rel.append(err / scale if scale else err)
    return ok, rel


def phase_scan_bwd_vs_plain(device):
    """The selective scan's backward kernel (``acs_mamba_scan_bwd``)
    against its plain versions over SCAN_BWD_SWEEP: the fused entry's
    (``mamba_scan_bwd`` against ``mamba_scan_bwd_ref``, float32 and bf16, z,
    b and c strided views, hT's gradient given) and the scan alone's
    (``selective_scan_bwd`` against ``selective_scan_bwd_ref``, float32, no
    hT gradient), each gradient within SCAN_BWD_TOL of its largest entry;
    the forward that saves the chunk states gives the serving call's bits;
    a second launch gives the same bits. Under grad, ``mamba_scan`` runs
    its Function: one forward and one backward launch, its gradients
    within SCAN_BWD_TOL of autograd through ``mamba_scan_ref``."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import (mamba_scan_bwd_ref, mamba_scan_ref,
                                         selective_scan_bwd_ref)

    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    names = ("dt_raw", "dt_bias", "x", "z", "b", "c", "A_log", "D", "h0")
    tol_of = lambda g: SCAN_BWD_TOL[str(g.dtype).replace("torch.", "")]  # noqa: E731
    for b, s, e, n in SCAN_BWD_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            args = fused_inputs(gen, b, s, e, n, dtype, device)
            y, ht, states = ss.mamba_scan_fwd(*args)
            serve = ss.mamba_scan(*args)
            dy = torch.randn(b, s, e, generator=gen, device=device).to(dtype)
            dht = torch.randn(b, e, n, generator=gen, device=device)
            got = ss.mamba_scan_bwd(*args, states, dy, dht)
            want = mamba_scan_bwd_ref(*args, dy, dht)
            torch.cuda.synchronize()
            check(torch.equal(y, serve[0]) and torch.equal(ht, serve[1]),
                  f"mamba_scan: saving the chunk states changed the forward's bits at "
                  f"{(b, s, e, n)} {dtype}")
            ok, rel = scan_bwd_errors(got, want, tol_of)
            check(ok, f"mamba_scan backward != plain at B {b}, S {s}, E {e}, N {n}, {dtype}: "
                      f"max err / largest entry {dict(zip(names, rel))}")
            again = ss.mamba_scan_bwd(*args, states, dy, dht)
            check(all(torch.equal(u, w) for u, w in zip(again, got)),
                  f"mamba_scan backward: a second launch gave other bits at {(b, s, e, n)}")
            log(f"mamba_scan backward ~ plain: B {b}, S {s}, E {e}, N {n} "
                f"{str(dtype).replace('torch.', '')} (z, b, c strided; dhT given) max err / "
                f"largest entry " + " ".join(f"{k} {r:.3g}" for k, r in zip(names, rel))
                + "; a second launch gives the same bits")
        dt, x, bm, cm, a, h0 = scan_inputs(gen, b, s, e, n, device)
        ys, ht, states = ss.selective_scan_fwd(dt, x, bm, cm, a, h0)
        dys = torch.randn(b, s, e, generator=gen, device=device)
        got = ss.selective_scan_bwd(dt, x, bm, cm, a, h0, states, dys, None)
        want = selective_scan_bwd_ref(dt, x, bm, cm, a, h0, dys, None)
        torch.cuda.synchronize()
        ok, rel = scan_bwd_errors(got, want, tol_of)
        again = ss.selective_scan_bwd(dt, x, bm, cm, a, h0, states, dys, None)
        check(ok and all(torch.equal(u, w) for u, w in zip(again, got)),
              f"selective_scan backward != plain or not repeatable at {(b, s, e, n)}: {rel}")
        log(f"selective_scan backward ~ plain: B {b}, S {s}, E {e}, N {n} float32 max err / "
            f"largest entry " + " ".join(f"{k} {r:.3g}" for k, r in
                                         zip(("dt", "x", "b", "c", "a", "h0"), rel)))
    # Under grad: the Function on z, b and c sliced from wider projections.
    b, s, e, n = 2, 130, 96, 16
    leaves = [torch.randn(b, s, e, generator=gen, device=device).to(torch.bfloat16),
              0.5 * torch.randn(e, generator=gen, device=device),
              torch.randn(b, s, e, generator=gen, device=device).to(torch.bfloat16),
              torch.randn(b, s, 2 * e, generator=gen, device=device).to(torch.bfloat16),
              torch.randn(b, s, 8 + 2 * n, generator=gen, device=device).to(torch.bfloat16),
              torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32))[None]
              + 0.1 * torch.randn(e, n, generator=gen, device=device),
              torch.randn(e, generator=gen, device=device),
              torch.randn(b, e, n, generator=gen, device=device)]
    dy = torch.randn(b, s, e, generator=gen, device=device).to(torch.bfloat16)
    grads = []
    for fn in (ss.mamba_scan, mamba_scan_ref):
        ps = [t.detach().clone().requires_grad_(True) for t in leaves]
        dt_raw, bias, x, xz, proj, a_log, d, h0 = ps
        before = (ss.launches, ss.backward_launches)
        y, _ = fn(dt_raw, bias, x, xz[..., e:], proj[..., 8: 8 + n], proj[..., 8 + n:], a_log, d,
                  h0)
        grads.append(torch.autograd.grad(y, ps, dy))
        torch.cuda.synchronize()
        counts = (ss.launches - before[0], ss.backward_launches - before[1])
        check(counts == ((1, 1) if fn is ss.mamba_scan else (0, 0)),
              f"{fn.__name__} under grad launched {counts}")
    ok, rel = scan_bwd_errors(*grads, tol_of)
    check(ok, f"mamba_scan under grad: gradients off autograd through the plain version: {rel}")
    log(f"mamba_scan under grad (z, b, c slices of wider projections): one forward and one "
        f"backward launch; each leaf's gradient within {max(rel):.3g} of autograd through "
        f"mamba_scan_ref's largest entry")


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


# The grouped GEMM's backward (dx, dw) against grouped_matmul_bwd_ref,
# (G, K, N, block_m, tile group ids): granite-moe-3b-a800m's training shape
# (40 experts, capacity C 512, one tile an expert: w_gate/w_up [40, 1536,
# 512] and w_down [40, 512, 1536]), the capacity layout of two dispatch
# groups (every expert twice, as models/ffn.py _expert_tiles repeats it),
# ragged cases with repeated groups and groups no tile names (dw exactly 0),
# block_m 1, 8 and 512, and K and N off the 8-element copies and off the
# 128-wide tiles. Tolerances are of each gradient's largest entry: float32
# 1e-5 (FMAs against the plain einsum's sums, in another order), float16
# and bfloat16 8e-3 (both sum in float32 and round once to the type, 2^-8;
# dw sums up to 1,024 rows).
GMM_BWD_SWEEP = {
    "granite_train_gate": (40, 1536, 512, 512, tuple(range(40))),
    "granite_train_down": (40, 512, 1536, 512, tuple(range(40))),
    # deepseek-v2's experts (160 of [5120, 1536], top-6 of 2,048 tokens: C 96)
    "deepseek_train_gate": (160, 5120, 1536, 96, tuple(range(160))),
    "deepseek_train_down": (160, 1536, 5120, 96, tuple(range(160))),
    "two_dispatch_groups": (8, 256, 96, 64, tuple(range(8)) * 2),
    "ragged_repeats_unused": (6, 72, 40, 8, (0, 3, 3, 0, 5, 3)),
    "bm1_k37_n131": (5, 37, 131, 1, (4, 0, 4, 2, 2, 4, 0)),
    "bm8_k13_n11": (3, 13, 11, 8, (1, 1, 0)),
    "bm512_k200_n136": (3, 200, 136, 512, (2, 2, 0)),
    "bm70_k130_n264": (4, 130, 264, 70, (3, 1, 3)),
    "groups_past_one_launch": (4100, 16, 24, 4, (4099, 0, 4096, 4095, 4099, 7)),
}
GMM_BWD_TOL = {"float32": 1e-5, "float16": 8e-3, "bfloat16": 8e-3}


def phase_gmm_bwd_vs_plain(device):
    """dx and dw (``grouped_matmul_bwd``) against ``grouped_matmul_bwd_ref``
    over GMM_BWD_SWEEP in float32, float16 and bfloat16, within
    GMM_BWD_TOL of each gradient's largest entry; dw of a group no tile
    names exactly 0; the same bits on a second launch; dx counted once on
    its path (``dx_path``: a 16-bit call never on ``fma_f32``)."""
    import torch
    from repro_torch.kernels.ref import grouped_matmul_bwd_ref

    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    for name, (g, k, n, bm, tiles) in GMM_BWD_SWEEP.items():
        unused = sorted(set(range(g)) - set(tiles))
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            x, w, tg = gmm_inputs(device, gen, g, k, n, bm, tiles, dtype)
            dy = torch.randn(x.shape[0], n, generator=gen, device=device).to(dtype)
            before = dict(gm.dx_paths)
            got = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm)
            want = grouped_matmul_bwd_ref(x, w, tg, dy, block_m=bm)
            torch.cuda.synchronize()
            dx_path = gm.dx_path(dy, w, got[0])
            check({key: gm.dx_paths[key] - before[key] for key in before}
                  == {key: int(key == dx_path) for key in before}
                  and (dx_path == "fma_f32") == (dtype == torch.float32),
                  f"grouped_matmul dx at {name} {dtype}: path {dx_path}, counted "
                  f"{gm.dx_paths} after {before}")
            tol = GMM_BWD_TOL[str(dtype).replace("torch.", "")]
            rel = []
            for label, gt, wt in zip(("dx", "dw"), got, want):
                err, scale = float((gt.float() - wt.float()).abs().max()), float(
                    wt.float().abs().max())
                check(gt.dtype == dtype and gt.shape == wt.shape and err <= tol * scale,
                      f"grouped_matmul {label} != plain at {name} {dtype}: max abs err {err}, "
                      f"largest entry {scale}")
                rel.append(err / scale if scale else err)
            check(all(bool((got[1][u] == 0).all()) for u in unused),
                  f"grouped_matmul dw: a group no tile names is not exactly 0 at {name}")
            again = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm)
            check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
                  f"grouped_matmul backward: a second launch gave other bits at {name} {dtype}")
            log(f"grouped_matmul backward ~ plain: {name} G {g} K {k} N {n} block_m {bm} M "
                f"{len(tiles) * bm} {str(dtype).replace('torch.', '')} max err / largest entry "
                f"dx {rel[0]:.3g} dw {rel[1]:.3g}; unused groups "
                f"{unused if len(unused) <= 8 else f'({len(unused)} of them)'} exactly 0; dx path "
                f"{dx_path}, dw path {gm.dw_path(x, dy, got[1])}")


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
    we = importlib.import_module("repro_torch.kernels.wave_elementwise")
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
    we = importlib.import_module("repro_torch.kernels.wave_elementwise")

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


def mesh_run(device, build, n_shards, mode, transfer_mode="auto", chunks=4):
    """One feed of ``build``'s stream through ``MeshDeviceSession`` in
    ``chunks`` interleaved submits: the shards' ready-queue and wave-kernel
    launches counted from 0. Returns (buffers, session stats, the link's
    moves as (mode, row bytes), launches, wall seconds)."""
    import torch
    from repro_torch.core import MeshDeviceSession
    from repro_torch.kernels import ready_queue as rq
    we = importlib.import_module("repro_torch.kernels.wave_elementwise")

    bufs, tasks = build(device)
    session = MeshDeviceSession(window_size=WINDOW, n_shards=n_shards,
                                registry=loop_registry(tasks), plan_mode=mode,
                                transfer_mode=transfer_mode, device=device)
    check(len({sh.stream.cuda_stream for sh in session.shards}) == n_shards,
          f"mesh {n_shards} shards: not one stream a shard")
    moves = []
    move = session.link.move

    def counted(base, owner, dest):
        nbytes = session.shards[owner].arena.row_nbytes(base)
        used = move(base, owner, dest)
        moves.append((used, nbytes))
        return used

    session.link.move = counted
    torch.cuda.synchronize()
    rq.reset_launches()
    we.reset_launches()
    t0 = time.perf_counter()
    n = -(-len(tasks) // chunks)
    for i in range(chunks):
        session.submit(tasks[i * n:(i + 1) * n])
        session.poll()
    session.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return bufs, session.session_stats(), moves, (rq.launches, we.launches), wall


def phase_mesh(device, card):
    """The mesh-sharded device window on the card: ``MeshDeviceSession`` at
    MESH_SHARDS shards on ``cuda:0`` (each shard its own stream) under the
    loop and wave plan modes, over the chain universe (4 chunks), the
    mixed-tag stream and the cross-shard join stream (every transfer mode).
    Every run is bit-equal to ``run_serial``; its ready-queue launches
    equal the shards' loop dispatches and its wave-kernel launches their
    wave-kernel dispatches, each dispatch one launch; d2d moves no row
    through the host, staged does; the transfer table's bytes are the rows
    moved times the row bytes; the overlapped drain has two shards in
    flight on the join stream. Returns (ready-queue launches, wave-kernel
    launches, wall seconds per run)."""
    import torch
    from repro_torch.core import run_serial

    launched = [0, 0]
    walls = {}
    # The chain universe's shared weight row gives every chain the same
    # read home, so the mesh keeps the whole universe on one shard; with a
    # weight row a chain, placement spreads the chains over the shards.
    builds = {"chain_universe": chain_universe,
              "spread_chains": lambda dev: chain_universe(dev, shared_weight=False),
              "mixed_tag": mixed_tag, "joins": cross_shard_joins}
    for label, build in builds.items():
        bufs, tasks = build(device)
        run_serial(tasks, device=device)
        expect = torch.stack([b.value for b in bufs])
        for n_shards in MESH_SHARDS:
            for mode in MESH_MODES:
                for transfer in (TRANSFER_MODES if label == "joins" else ("auto",)):
                    bufs, stats, moves, (rq_n, we_n), wall = mesh_run(
                        device, build, n_shards, mode, transfer)
                    name = f"mesh {label} {n_shards} shards {mode} {transfer}"
                    launched[0] += rq_n
                    launched[1] += we_n
                    walls[f"{label}/mesh_{n_shards}_{mode}_{transfer}"] = wall
                    got = torch.stack([b.value for b in bufs])
                    check(bit_equal(got, expect), f"{name}: != run_serial")
                    per = stats["per_shard"]
                    check(rq_n == sum(s["loop_dispatches"] for s in per)
                          and we_n == sum(s["wave_kernel_dispatches"] for s in per)
                          and rq_n + we_n == stats["device_dispatches"] > 0,
                          f"{name}: {rq_n} ready-queue and {we_n} wave-kernel launches for "
                          f"{stats['device_dispatches']} device dispatches")
                    table = stats["transfers"]
                    check(table["transfers"] == len(moves)
                          and table["bytes"] == sum(b for _, b in moves)
                          == len(moves) * WIDTH * 4,
                          f"{name}: table {table} against {len(moves)} rows moved")
                    syncs = sum(s["host_syncs_by_tag"].get("mesh-transfer", 0) for s in per)
                    if stats["transfer_mode"] == "d2d":
                        check(syncs == 0 and stats["staged_moves"] == 0,
                              f"{name}: {syncs} mesh-transfer syncs under d2d")
                    elif moves:
                        check(syncs > 0, f"{name}: staged moves without a host sync")
                    if label == "joins" and n_shards >= 2:
                        check(stats["drain_overlap"] >= 2 and moves,
                              f"{name}: drain_overlap {stats['drain_overlap']}, "
                              f"{len(moves)} moves")
                    log(f"{name}: bit-equal to run_serial; transfer {stats['transfer_mode']} "
                        f"({stats['transfer_probe']}); launches: ready queue {rq_n}, wave "
                        f"kernel {we_n}; epochs {stats['epochs']}, sub-epoch barriers "
                        f"{stats['sub_epoch_barriers']}, cross-shard edges "
                        f"{stats['cross_shard_edges']}, moves {len(moves)} "
                        f"({table['bytes']} B), mesh-transfer syncs {syncs}, drain overlap "
                        f"{stats['drain_overlap']}, placements {stats['placements']}, wall "
                        f"{wall * 1e3:.3f} ms [{card}]")
    mesh_overlap(device, card)
    return launched[0], launched[1], walls


def stream_intervals(fn):
    """Run ``fn()`` under ``torch.profiler``; returns {stream: [(start,
    end) us]} of its CUDA kernels, from the exported trace."""
    import os
    import tempfile

    prof, _ = profiled(fn)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    out = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "kernel":
            stream = ev.get("args", {}).get("stream")
            out.setdefault(stream, []).append((ev["ts"], ev["ts"] + ev.get("dur", 0)))
    return out


def overlap_of(intervals):
    """(sum, union) in ms of every stream's intervals: their difference is
    the time two or more ran at once."""
    spans = sorted(iv for ivs in intervals.values() for iv in ivs)
    if not spans:
        return None, None
    total = sum(e - s for s, e in spans)
    union, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            union += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total / 1e3, (union + hi - lo) / 1e3


def mesh_overlap(device, card):
    """Do two shards' cooperative epochs share the card? (a) The chain
    universe with a weight row a chain (so the chains spread over the
    shards) through a 2-shard mesh under the profiler, loop and wave: each
    stream's kernel intervals, their sum and their union. (b) Each
    kernel's epoch over one half of the chain universe, the two halves
    launched back to back on two streams with nothing between: sum and
    union again. Logged, not checked."""
    import torch
    from repro_torch.core import MeshDeviceSession
    from repro_torch.kernels import ready_queue as rq
    from repro_torch.kernels.wave_elementwise import wave_epoch

    for mode in MESH_MODES:
        def run(mode=mode):
            bufs, tasks = chain_universe(device, shared_weight=False)
            session = MeshDeviceSession(window_size=WINDOW, n_shards=2,
                                        registry=loop_registry(tasks), plan_mode=mode,
                                        device=device)
            session.submit(tasks)
            session.close()
        run()  # warm: plans, programs, allocator
        ivs = stream_intervals(run)
        name = "ready_queue_kernel" if mode == "loop" else "wave_epoch_kernel"
        total, union = overlap_of(ivs)
        log(f"mesh overlap, chain universe (a weight row a chain) through 2 shards ({mode}): "
            f"kernels a stream "
            f"{ {k: len(v) for k, v in ivs.items()} }, kernel time summed {total} ms, "
            f"union {union} ms ({name} and the packs' copies) [{card}]")

    half = CHAINS // 2
    _, tasks = chain_universe(device)
    halves = [tasks[:half * DEPTH], tasks[half * DEPTH:]]
    queues = [lowered_payload(h, device) for h in halves]
    waves = [wave_program(device, h, "wave") for h in halves]
    streams = [torch.cuda.Stream(device) for _ in range(2)]

    def both(launch):
        def go():
            torch.cuda.synchronize()
            for i, stream in enumerate(streams):
                with torch.cuda.stream(stream):
                    launch(i)
            torch.cuda.synchronize()
        return go

    runs = {
        "ready queue": both(lambda i: run_queue(rq.ready_queue, *queues[i])),
        "wave epoch": both(lambda i: wave_epoch(waves[i][1], torch.from_numpy(
            waves[i][0].desc).to(device), waves[i][0].offsets, branches=waves[i][0].branches,
            direct=waves[i][0].direct)),
    }
    for label, go in runs.items():
        go()  # warm
        ivs = stream_intervals(lambda: [go() for _ in range(5)])
        total, union = overlap_of(ivs)
        log(f"mesh overlap probe, {label}: two half chain universes ({half} chains each) on two "
            f"streams back to back, 5 rounds: kernels a stream "
            f"{ {k: len(v) for k, v in ivs.items()} }, summed {total} ms, union {union} ms "
            f"(union = sum: one after the other; union = sum / 2: side by side) [{card}]")


def phase_perfmodel(device, card, measured):
    """The analytic model under ``H100_LIKE`` beside this run's walls: the
    card's launch and sync latency measured here (the constants H100_LIKE
    takes), then ``simulate`` for serial, ACS-SW, ACS-HW and the CUDA-graph
    policy on one cheetah step and on the chain universe. Host only; no
    claim that the model predicts the card."""
    import torch
    from repro_torch.core import TaskStream, build_full_dag, level_schedule
    from repro_torch.core.device_dispatch import plan_waves
    from repro_torch.core.perfmodel import H100_LIKE, simulate
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    x = torch.zeros(4, device=device)
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    launch, sync = [], []
    for _ in range(200):
        t0 = time.perf_counter()
        x.add_(1.0)
        launch.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        sync.append(time.perf_counter() - t0)
    launch_us, sync_us = statistics.median(launch) * 1e6, statistics.median(sync) * 1e6
    log(f"perfmodel: one small launch {launch_us:.2f} us (median host time to enqueue), "
        f"torch.cuda.synchronize after it {sync_us:.2f} us (median), 200 each; H100_LIKE "
        f"holds launch_us {H100_LIKE.launch_us}, sync_us {H100_LIKE.sync_us}, hw_dispatch_us "
        f"{H100_LIKE.hw_dispatch_us} [{card}]")

    eng = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=SIM_ENVS, group_size=SIM_GROUP, seed=0,
                        device=device)
    stream = TaskStream()
    eng.emit_step(stream)
    streams = {"cheetah": stream.tasks, "chain_universe": chain_universe(device)[1]}
    for label, tasks in streams.items():
        # The cheetah step is a new graph every step: the CUDA-graph policy
        # pays its construction (the all-pairs DAG, timed here) each time.
        # The chain universe is static: construction amortizes to 0 (and
        # its 2,048-task all-pairs DAG takes a minute of host).
        construct_us = 0.0
        if label == "cheetah":
            t0 = time.perf_counter()
            level_schedule(tasks, build_full_dag(tasks)[0])
            construct_us = (time.perf_counter() - t0) * 1e6
        waves = plan_waves(tasks, WINDOW)
        model = {p: simulate([[t] for t in tasks] if p == "serial" else waves, H100_LIKE, p,
                             construct_us=construct_us if p == "cudagraph" else 0.0)
                 for p in ("serial", "acs_sw", "acs_hw", "cudagraph")}
        walls = {k: f"{v * 1e3:.3f} ms" for k, v in measured.items()
                 if k.startswith(label + "/")}
        steps = f" ({SIM_STEPS} steps)" if label == "cheetah" else ""
        log(f"perfmodel {label}: one pass, {len(tasks)} tasks, {len(waves)} waves, CUDA-graph "
            f"construction {construct_us:.1f} us; H100_LIKE: "
            + ", ".join(f"{p} {m['time_us']:.1f} us (occupancy {m['occupancy']:.3f})"
                        for p, m in model.items())
            + f"; this run's walls{steps}: {walls} [{card}]")


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


DYN_INPUTS, DYN_CHUNK = 8, 8
# The nets whose task graph depends on the input. CondConv's input
# dependence is in its values (weights mixed at run time): its graph is
# fixed, as in the reference.
DYN_GRAPH_VARIES = ("instanas", "dynamic_routing")
DYN_POLICIES = ("serial", "wave", "threaded", "frontier", "device_loop", "device_wave",
                "device_frontier", "session_loop", "session_wave", "session_frontier", "dag")
# One pass of 8 inputs takes 20-60 ms, which the host's noise can swing by
# 1.5x from one run to the next: serial, wave and frontier are timed again
# in rounds, their order rotated each round, and compared by medians.
DYN_TIMED, DYN_ROUNDS = ("serial", "wave", "frontier"), 7


def dyn_input(seed):
    """``benchmarks/bench_dynamic_dnn.py``'s inputs: 3x32x32, scaled by
    1 + 0.3 * seed."""
    rng = np.random.RandomState(seed)
    return rng.randn(1, 3, 32, 32).astype(np.float32) * (1.0 + 0.3 * seed)


def dyn_stream(name, params, seed):
    """One input's task stream of workload ``name``. Returns (the output
    buffer, the tasks)."""
    from repro_torch.core import TaskStream
    from repro_torch.dyn import WORKLOADS

    stream = TaskStream()
    out = WORKLOADS[name][1](params, stream, dyn_input(seed))
    return out, stream.tasks


def dyn_runner(policy, device):
    """A fresh runner of ``policy`` (one of ``DYN_POLICIES``): ``run(tasks)
    -> report``. ``device_*`` is ``DeviceWindowRunner`` and ``session_*``
    a ``DeviceSession`` fed in chunks of ``DYN_CHUNK`` with a poll after
    each, in that plan mode, on the dyn kernel registry; ``dag`` is
    ``DagRunner``, constructing the graph of every input."""
    from repro_torch.core import (DagRunner, DeviceOpRegistry, DeviceSession,
                                  DeviceWindowRunner, make_scheduler)
    from repro_torch.dyn.blocks import register_device_kernels

    kind, _, mode = policy.partition("_")
    if kind == "dag":
        return DagRunner(device=device).execute
    if not mode:
        return make_scheduler(policy, window_size=WINDOW, num_streams=SIM_STREAMS,
                              device=device)
    reg = DeviceOpRegistry()
    register_device_kernels(reg)
    if kind == "device":
        return DeviceWindowRunner(reg, window_size=WINDOW, plan_mode=mode, device=device).run

    def run(tasks):
        session = DeviceSession(window_size=WINDOW, registry=reg, plan_mode=mode,
                                device=device)
        for i in range(0, len(tasks), DYN_CHUNK):
            session.submit(tasks[i:i + DYN_CHUNK])
            session.poll()
        return session.close()
    return run


def kernel_modules():
    """The hand-written kernels' wrapper modules: the six kernels of the
    models and the scheduler, and the optimizer's."""
    return tuple(importlib.import_module(f"repro_torch.kernels.{name}")
                 for name in ("ready_queue", "wave_elementwise", "flash_attention", "lru_scan",
                              "grouped_matmul", "selective_scan", "adamw"))


def phase_dyn(device, card):
    """The paper's dynamic-DNN workloads (``dyn/``), all seven at the
    reference's sizes, each on ``DYN_INPUTS`` seeded inputs through every
    policy of ``DYN_POLICIES`` (the static nets also through a DagRunner
    that constructs once and replays): every output finite and bit-equal to
    ``run_serial``'s; the task counts vary with the input exactly for
    ``DYN_GRAPH_VARIES``; the frontier keeps more than one group in
    flight; none of the six hand-written kernels is launched (their
    routes take only padding-free 1-D rows). Each line's wall is the runs
    alone, ended by a synchronize; building the streams is not in it. The
    dynamic nets are also timed in rounds (:func:`dyn_rounds`)."""
    import torch
    from repro_torch.core import DagRunner
    from repro_torch.dyn import WORKLOADS

    peak_inflight = {}
    for mod in kernel_modules():
        mod.reset_launches()
    for name, (init, _, dynamic) in WORKLOADS.items():
        params = init(0, device=device)
        out, tasks = dyn_stream(name, params, 0)  # warm-up: first calls, the classifier
        dyn_runner("serial", device)(tasks)
        expect, counts = [], []
        for seed in range(DYN_INPUTS):
            out, tasks = dyn_stream(name, params, seed)
            dyn_runner("serial", device)(tasks)
            check(bool(torch.isfinite(out.value).all()), f"{name} input {seed}: non-finite")
            expect.append(out.value)
            counts.append(len(tasks))
        varies = name in DYN_GRAPH_VARIES
        check((len(set(counts)) > 1) == varies,
              f"{name}: task counts {counts} over {DYN_INPUTS} inputs "
              f"({'dynamic' if dynamic else 'static'} net)")
        policies = DYN_POLICIES + (() if dynamic else ("dag_replay",))
        replay = DagRunner(device=device)  # constructs on input 0, replays the rest
        for policy in policies:
            wall, dispatches, widths, syncs, inflight = 0.0, 0, [], 0, []
            construct_s, dep_checks = 0.0, 0
            for seed in range(DYN_INPUTS):
                out, tasks = dyn_stream(name, params, seed)
                run = (replay.execute if policy == "dag_replay" else dyn_runner(policy, device))
                kw = {"construct": seed == 0} if policy == "dag_replay" else {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                report = run(tasks, **kw)
                torch.cuda.synchronize()
                wall += time.perf_counter() - t0
                check(bit_equal(out.value, expect[seed]),
                      f"{name} {policy} input {seed}: output != run_serial")
                ex = report.exec_stats
                check(ex["tasks_run"] == len(tasks),
                      f"{name} {policy} input {seed}: {ex['tasks_run']} of {len(tasks)} tasks ran")
                dispatches += ex["dispatches"]
                widths.append(ex["mean_wave_width"])
                syncs += ex["blocking_syncs"]
                if policy == "frontier":
                    inflight.append(report.max_inflight_groups())
                if policy == "dag":  # a fresh runner an input
                    construct_s += report.construct_seconds
                    dep_checks += report.dep_checks
                elif policy == "dag_replay":  # one runner, its totals
                    construct_s, dep_checks = report.construct_seconds, report.dep_checks
            extra = ""
            if policy == "frontier":
                peak_inflight[name] = max(inflight)
                extra = f", max_inflight_groups {inflight}"
            if policy.startswith("dag"):
                extra = (f", construct {construct_s * 1e3:.3f} ms "
                         f"({100 * construct_s / wall:.1f} % of the wall), dep_checks {dep_checks}")
            log(f"dyn {name} {policy}: {DYN_INPUTS} inputs, tasks {counts}, dispatches "
                f"{dispatches}, mean wave width {statistics.mean(widths):.3f}, blocking syncs "
                f"{syncs}{extra}, wall {wall * 1e3:.3f} ms, bit-equal to run_serial [{card}]")
        if dynamic:
            dyn_rounds(name, params, device, card)
    launched = {mod.__name__.rsplit(".", 1)[1]: mod.launches for mod in kernel_modules()}
    check(not any(launched.values()), f"dyn: the hand-written kernels launched {launched}")
    check(max(peak_inflight.values()) > 1 and peak_inflight["instanas"] > 1,
          f"dyn frontier: max_inflight_groups {peak_inflight}")
    log(f"dyn: {len(WORKLOADS)} workloads x {DYN_INPUTS} inputs bit-equal to run_serial under "
        f"every policy; the six kernels launched {launched}; frontier max_inflight_groups "
        f"{peak_inflight}")


def dyn_rounds(name, params, device, card):
    """Time ``DYN_TIMED`` on workload ``name`` in ``DYN_ROUNDS`` rounds of
    ``DYN_INPUTS`` inputs each (streams built first), the policies' order
    rotated every round; log each policy's median, its range and the
    median's ratio to serial's."""
    import torch

    walls = {policy: [] for policy in DYN_TIMED}
    for r in range(DYN_ROUNDS):
        for i in range(len(DYN_TIMED)):
            policy = DYN_TIMED[(r + i) % len(DYN_TIMED)]
            streams = [dyn_stream(name, params, seed)[1] for seed in range(DYN_INPUTS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for tasks in streams:
                dyn_runner(policy, device)(tasks)
            torch.cuda.synchronize()
            walls[policy].append((time.perf_counter() - t0) * 1e3)
    base = statistics.median(walls["serial"])
    log(f"dyn {name} rounds: {DYN_ROUNDS} x {DYN_INPUTS} inputs, order rotated; " + "; ".join(
        f"{p} median {statistics.median(w):.3f} ms (min {min(w):.3f}, max {max(w):.3f}, "
        f"{statistics.median(w) / base:.3f}x serial)" for p, w in walls.items()) + f" [{card}]")


# The examples (phase 5c): the reference's tolerance for quickstart's
# states across devices, and the logit margin under which two devices may
# pick different classes.
EXAMPLE_RTOL, EXAMPLE_ATOL, EXAMPLE_MARGIN = 2e-5, 1e-6, 1e-4


def load_example(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", Path(__file__).resolve().parent / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(device, card):
    """Each ported example's ``main`` in this process at its default
    arguments on the card, held against the same ``main`` on the CPU:
    quickstart's counts and wave widths equal, its ACS states bit-equal to
    its own serial run on each device (``main`` checks it) and the card's
    within EXAMPLE_RTOL / EXAMPLE_ATOL of the CPU's; physics_rl's and
    dynamic_dnn_inference's per-step or per-image kernels, dispatches,
    waves and widths (and the active blocks) equal, the classes equal
    where the CPU's two largest logits are more than EXAMPLE_MARGIN apart;
    serve_continuous's requests, drains and co-scheduled drains equal, and
    each request's tokens equal to a plain greedy loop on that device's
    weights (``init_params`` draws from each device's own generator). On
    the card serve_continuous launches flash once per prefill and
    attention layer (no decode step does), and no other example launches
    a kernel of ours; so its card tokens are also held to the greedy loop
    with the plain ``attention_ref`` in place of flash, on the same
    weights: equal up to the first token where the plain loop's two best
    logits lie within EXAMPLE_MARGIN of each other (prefill's choice, hidden
    in the served tokens, counts at every position)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    runs = {}
    for name in ("torch_quickstart", "torch_physics_rl", "torch_dynamic_dnn_inference",
                 "torch_serve_continuous"):
        mod = load_example(name)
        for dev in (device, torch.device("cpu")):
            for kernel in kernel_modules():
                kernel.reset_launches()
            t0 = time.perf_counter()
            out = mod.main(["--device", str(dev)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k.__name__.rsplit(".", 1)[1]: k.launches for k in kernel_modules()}
            runs[name, "card" if dev is device else "cpu"] = out
            log(f"example {name} --device {dev}: {seconds:.2f} s; kernel launches {launches} "
                f"[{card if dev is device else 'CPU'}]")
            if name == "torch_serve_continuous" and dev is device:
                n_req = len(out["batch"]["requests"]) + len(out["session"]["requests"])
                want = expected_launches(out["cfg"], n_req)["flash_attention"]
                check(launches.pop("flash_attention") == want > 0,
                      f"{name}: flash launched {fa.launches} times on the card, expected {want}")
            check(not any(launches.values()), f"{name} --device {dev} launched {launches}")

    card_q, cpu_q = runs["torch_quickstart", "card"], runs["torch_quickstart", "cpu"]
    keys = ("kernels", "serial_dispatches", "acs_dispatches", "acs_waves", "mean_wave_width",
            "max_wave_width")
    check(all(card_q[k] == cpu_q[k] for k in keys),
          f"quickstart: {[card_q[k] for k in keys]} on the card, {[cpu_q[k] for k in keys]} "
          f"on the CPU")
    err = float(np.abs(card_q["acs_state"] - cpu_q["acs_state"]).max())
    check(np.allclose(card_q["acs_state"], cpu_q["acs_state"], rtol=EXAMPLE_RTOL,
                      atol=EXAMPLE_ATOL),
          f"quickstart: the card's states {err} off the CPU's")
    log(f"example quickstart: {[card_q[k] for k in keys]} on both devices; states bit-equal to "
        f"serial on each, the card's within {err:.3g} of the CPU's [{card}]")

    card_p, cpu_p = runs["torch_physics_rl", "card"], runs["torch_physics_rl", "cpu"]
    keys = ("kernels", "dispatches", "waves", "wave_width")
    rows = [[row[k] for k in keys] for row in card_p["steps"]]
    check(rows == [[row[k] for k in keys] for row in cpu_p["steps"]] and card_p["finite"],
          f"physics_rl: per step {rows} on the card, "
          f"{[[row[k] for k in keys] for row in cpu_p['steps']]} on the CPU")
    rewards = [(a["reward"], b["reward"]) for a, b in zip(card_p["steps"], cpu_p["steps"])]
    log(f"example physics_rl {card_p['env']} [{card_p['scheduler']}]: {keys} per step {rows} "
        f"on both devices; rewards (card, CPU) {rewards}; wall {card_p['wall']:.3f} s on the "
        f"card, {cpu_p['wall']:.3f} s on the CPU [{card}]")

    card_d, cpu_d = (runs["torch_dynamic_dnn_inference", d] for d in ("card", "cpu"))
    keys = ("active", "kernels", "dispatches", "waves")
    rows = [[img[k] for k in keys] for img in card_d["images"]]
    check(rows == [[img[k] for k in keys] for img in cpu_d["images"]],
          f"dynamic_dnn_inference: {rows} on the card, "
          f"{[[img[k] for k in keys] for img in cpu_d['images']]} on the CPU")
    for a, b in zip(card_d["images"], cpu_d["images"]):
        top2 = np.sort(b["logits"])[-2:]
        check(a["class"] == b["class"] or top2[1] - top2[0] <= EXAMPLE_MARGIN,
              f"dynamic_dnn_inference: class {a['class']} on the card, {b['class']} on the CPU")
    err = max(float(np.abs(a["logits"] - b["logits"]).max())
              for a, b in zip(card_d["images"], cpu_d["images"]))
    log(f"example dynamic_dnn_inference: {keys} per image {rows} on both devices, classes "
        f"{[img['class'] for img in card_d['images']]}, logits within {err:.3g}, compiles "
        f"{card_d['compiles']} [{card}]")

    for dev, key in ((device, "card"), (torch.device("cpu"), "cpu")):
        out = runs["torch_serve_continuous", key]
        cfg, params = out["cfg"], out["params"]
        for kind in ("batch", "session"):
            for req in out[kind]["requests"]:
                toks = greedy(cfg, params, req["prompt"], dev, max_len=48,  # the example's slots
                              max_new=len(req["tokens"]))[0]
                check(toks == req["tokens"], f"serve_continuous {kind} --device {dev}: request "
                                             f"{req['rid']} served {req['tokens']}, greedy "
                                             f"{toks}")
    card_s, cpu_s = runs["torch_serve_continuous", "card"], runs["torch_serve_continuous", "cpu"]
    # The card's tokens against the plain attention on the card's weights.
    kernel, ops.attention, launched = ops.attention, attention_ref, fa.launches
    ties = []
    try:
        for kind in ("batch", "session"):
            for req in card_s[kind]["requests"]:
                gaps = []
                toks = greedy(card_s["cfg"], card_s["params"], req["prompt"], device, max_len=48,
                              max_new=len(req["tokens"]), gaps=gaps)[0]
                first = next((i for i, (a, b) in enumerate(zip(toks, req["tokens"])) if a != b),
                             None)
                tie = first is not None and min(gaps[0], gaps[first + 1]) <= EXAMPLE_MARGIN
                check(first is None or tie,
                      f"serve_continuous {kind} on the card: request {req['rid']} served "
                      f"{req['tokens']}, the plain attention's greedy loop {toks} (margins "
                      f"{gaps})")
                ties += [req["rid"]] if tie else []
    finally:
        ops.attention = kernel
    check(fa.launches == launched, "serve_continuous: the plain attention's loop launched flash")

    def served(out):  # each server's prompts, then the batch server's drains
        return ([[r["prompt"].tolist() for r in out[k]["requests"]] for k in ("batch", "session")],
                out["batch"]["drains"], out["batch"]["co_scheduled"])
    check(served(card_s) == served(cpu_s),
          f"serve_continuous: prompts, drains or co-scheduled drains differ: {served(card_s)} "
          f"on the card, {served(cpu_s)} on the CPU")
    log(f"example serve_continuous: the same prompts on both devices (lengths "
        f"{[len(r['prompt']) for r in card_s['batch']['requests']]}), drains and co-scheduled "
        f"drains {served(card_s)[1:]}, every request's tokens equal to the greedy loop on its "
        f"device, and on the card to the loop with the plain attention (near-ties: requests "
        f"{ties}); the session server's groups in flight {card_s['session']['inflight']} on "
        f"the card [{card}]")
    del runs
    free_device_memory()


def serve_prompts(vocab):
    rng = np.random.RandomState(SERVE_SEED)
    lengths = rng.randint(SERVE_MIN_PROMPT, SERVE_MAX_PROMPT + 1, SERVE_REQUESTS)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def greedy(cfg, params, prompt, device, max_len=None, max_new=None, gaps=None):
    """A plain greedy loop over ``prefill``/``decode_step``, mirroring one
    server slot of ``max_len`` positions (SERVE_MAX_LEN). Returns
    (``max_new`` tokens (SERVE_MAX_NEW), prefill seconds, decode-step
    seconds, all logits finite). A list ``gaps`` collects, outside the
    timed spans, the margin of each chosen token's logit over the
    runner-up's: prefill's first, then each decode step's."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill

    cache = init_cache(cfg, 1, max_len or SERVE_MAX_LEN, device=device)
    tokens = torch.as_tensor(prompt[None], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens, cache)
    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    if gaps is not None:
        gaps.append(top2_gap(logits, vocab=cfg.vocab))
    pos = torch.full((), len(prompt), dtype=torch.int32, device=device)
    out, t_decode = [], []
    for _ in range(max_new or SERVE_MAX_NEW):
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cfg, tok[:, None], cache, pos)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        pos = pos + 1
        out.append(int(tok[0]))  # the host read ends the step
        t_decode.append(time.perf_counter() - t0)
        finite = finite and bool(torch.isfinite(logits).all())
        if gaps is not None:
            gaps.append(top2_gap(logits, vocab=cfg.vocab))
    return out, t_prefill, t_decode, finite


def top2_gap(logits, vocab):
    """The last position's largest logit less its second largest."""
    best = logits[0, -1, :vocab].float().topk(2).values
    return float(best[0] - best[1])


def serve_once(cfg, params, server_cls, prompts, device, **kw):
    """One server run over ``prompts``; returns (per-prompt tokens, wall
    seconds, host reads, {kernel: launches})."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    ls = importlib.import_module("repro_torch.kernels.lru_scan")
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.runtime import SessionServer

    server = server_cls(cfg, params, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        window=WINDOW, device=device, **kw)
    torch.cuda.synchronize()
    for mod in (fa, ls, gm, ss):  # the main path's counts start here
        mod.reset_launches()
    t0 = time.perf_counter()
    reqs = [server.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    done = server.run_until_drained()
    if isinstance(server, SessionServer):
        server.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if getattr(server, "scheduler_name", None) == "mesh":
        entry = server.report_log[-1]
        stats = entry["device_session"]
        log(f"serve {cfg.name} mesh: shards {stats['n_shards']} on {stats['n_devices']} "
            f"device(s), slots a shard (mean) {entry['shard_slots_mean']}, placements "
            f"{stats['placements']}, cross-shard edges {stats['cross_shard_edges']}, transfer "
            f"{entry['transfer_mode']}, drain overlap {entry['drain_overlap']}, host-path tasks "
            f"{stats['host_task_dispatches']}")
    launches = {"flash_attention": fa.launches, "lru_scan": ls.launches,
                "grouped_matmul": gm.launches, "selective_scan": ss.launches}
    check(sorted(r.rid for r in done) == sorted(r.rid for r in reqs),
          f"{server_cls.__name__}: {len(done)} of {len(reqs)} requests finished")
    return [r.generated for r in reqs], wall, server.host_reads, launches


def expected_launches(cfg, n_requests):
    """Each kernel's launches in one server run: flash once per prefill
    and attention or MLA layer (decode attends in plain PyTorch), the
    RG-LRU scan once per RG-LRU layer and forward, the selective scan once
    per Mamba layer and forward, the grouped GEMM three times per MoE
    layer and forward (prefix layers keep a dense FFN)."""
    from repro_torch.models import split_pattern

    prefix, n_stages = split_pattern(cfg)
    kinds = list(prefix) + list(cfg.pattern_unit) * n_stages
    n_attn = sum(kind.startswith("attn") or kind == "mla" for kind in kinds)
    n_moe = len(cfg.pattern_unit) * n_stages if cfg.moe is not None else 0
    forwards = n_requests * (1 + SERVE_MAX_NEW)
    return {"flash_attention": n_requests * n_attn,
            "lru_scan": kinds.count("rglru") * forwards,
            "grouped_matmul": 3 * n_moe * forwards,
            "selective_scan": kinds.count("mamba") * forwards}


def phase_serve(device, card, arch):
    """Serve ``arch`` at its published widths (its depth cut as
    SERVE_CUTS says). Returns (launches per kernel on the session server's
    run, wall seconds per server, the model, its config and the
    prompts)."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.runtime import ContinuousBatchingServer, SessionServer

    cfg = dataclasses.replace(ARCHS[arch], **SERVE_CUTS.get(arch, {}))
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, SERVE_SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    cut = f" (cut: {SERVE_CUTS[arch]})" if arch in SERVE_CUTS else ""
    log(f"serve: {cfg.name} {cfg.n_layers} layers{cut} d_model {cfg.d_model} {cfg.dtype}, "
        f"{n_params} parameters drawn from seed {SERVE_SEED} in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated ({before / 1e9:.2f} GB before) [{card}]")
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
    servers = [("SessionServer(wave)", SessionServer, {"scheduler": "wave"}),
               ("SessionServer(device)", SessionServer, {"scheduler": "device"}),
               ("SessionServer(frontier)", SessionServer, {"scheduler": "frontier"}),
               ("ContinuousBatchingServer", ContinuousBatchingServer, {})]
    if arch in MESH_SERVE:
        servers.append((f"SessionServer(mesh, {MESH_SERVE_SHARDS} shards)", SessionServer,
                        {"scheduler": "mesh", "n_shards": MESH_SERVE_SHARDS}))
    for name, cls, kw in servers:
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
    check(all(t == tokens["SessionServer(wave)"] for t in tokens.values()),
          f"serve {cfg.name}: the servers' tokens differ")
    log(f"serve {cfg.name}: prompt lengths {[len(p) for p in prompts]}; the {len(servers)} "
        f"servers' "
        f"tokens identical and equal to the plain greedy loop; median prefill "
        f"{statistics.median(prefill_s) * 1e3:.3f} ms, median decode step "
        f"{statistics.median(decode_s) * 1e3:.3f} ms (greedy loop, host clock, "
        f"{len(decode_s)} steps) [{card}]")
    if cfg.name in PRIOR_DECODE_MS:
        prior, when = PRIOR_DECODE_MS[cfg.name]
        log(f"serve {cfg.name}: median decode step {statistics.median(decode_s) * 1e3:.3f} ms "
            f"through the torch.library ops, {prior:.3f} ms before {when} became ops "
            f"[{card}]")
    return main_launches, walls, (cfg, params, prompts)


def busy_serve(device, card, served):
    """One more serving pass (SessionServer(wave), one request: the
    profiler's processing of a pass's kernels takes about a minute a
    request) under the profiler: its device busy share."""
    from repro_torch.runtime import SessionServer

    cfg, params, prompts = served
    profile_pass(f"serve {cfg.name} SessionServer(wave), 1 request x {SERVE_MAX_NEW} tokens",
                 lambda: serve_once(cfg, params, SessionServer, prompts[:1], device,
                                    scheduler="wave"), card)


def phase_frontend(device, card, arch):
    """A frontend arch at its published config, weights from seed 0, in
    float32 and then in its bf16: ``forward`` over seeded frame or patch
    embeddings ``[1, S + 16, F]``, then ``prefill`` of the first S and 16
    ``decode_step``s fed the next embeddings (teacher-forced). Prefill's
    last logits and each step's are held to forward's at that position
    within FRONTEND_TOL. The bf16 pass runs again with ``ops.attention``
    swapped for the plain ``attention_ref``: held to the same bound, and
    flash's forward logits to its. Flash launches once per layer in
    forward and once per layer in prefill, never in a decode step or the
    plain pass. Returns the bf16 prefill's flash launches."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import init_params

    for dtype in ("float32", ARCHS[arch].dtype):
        cfg = dataclasses.replace(ARCHS[arch], dtype=dtype)
        params = init_params(cfg, SERVE_SEED, device=device)
        want, launches = frontend_pass(device, card, cfg, params, FRONTEND_ARCHS[arch])
        if dtype != "float32":
            kernel = ops.attention
            ops.attention = attention_ref
            try:
                plain, _ = frontend_pass(device, card, cfg, params, FRONTEND_ARCHS[arch],
                                         plain=True)
            finally:
                ops.attention = kernel
            err = float((want.float() - plain.float()).abs().max())
            limit = FRONTEND_TOL[dtype][2] * float(plain.float().abs().max())
            check(err <= limit, f"frontend {cfg.name} {dtype}: flash's forward logits {err} "
                                f"off the plain attention's, above {limit}")
            log(f"frontend {cfg.name} {dtype}: forward with flash against forward with the "
                f"plain attention: max abs err {err:.4g} (bound {limit:.4g}) [{card}]")
        del params, want
        free_device_memory()
    return launches


def grad_stats(grads):
    """(global norm in float32, {leaf name: gradient in float32}) of a
    gradient tree."""
    import torch
    from repro_torch.tree import tree_leaves_with_names

    leaves = dict(tree_leaves_with_names(grads))
    norm = torch.sqrt(sum(torch.sum(g.float().square()) for g in leaves.values()))
    return float(norm), leaves


def train_counters():
    """The launch counters of the training path's kernels, by name."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    ls = importlib.import_module("repro_torch.kernels.lru_scan")
    ss = importlib.import_module("repro_torch.kernels.selective_scan")
    return {"flash": fa.launches, "flash_bwd": fa.backward_launches, "gmm": gm.launches,
            "gmm_dx": gm.dx_launches, "gmm_dx_wgmma": gm.dx_paths["wgmma"],
            "gmm_dw": gm.dw_launches, "lru": ls.launches, "lru_bwd": ls.backward_launches,
            "mamba": ss.launches, "mamba_bwd": ss.backward_launches}


def reset_train_counters():
    for name in ("flash_attention", "grouped_matmul", "lru_scan", "selective_scan", "adamw"):
        importlib.import_module(f"repro_torch.kernels.{name}").reset_launches()


def optimizer_counters():
    """The fused optimizer's launches (update, norm) and leaves by path."""
    aw = importlib.import_module("repro_torch.kernels.adamw")
    return aw.launches, aw.norm_launches, dict(aw.paths)


def expected_train_launches(cfg):
    """Each training-path kernel's launches in one step: remat runs each
    stage's forward twice (the forward and the backward's recompute), the
    prefix layers before the stages (``models.split_pattern``: the pattern
    remainder, e.g. recurrentgemma-2b's first two RG-LRU layers) once, as
    the reference rematerialises per stage; the backward launches each
    backward entry once a layer (three expert products a MoE layer), dx of
    a 16-bit model on its ``"wgmma"`` path. Flash runs in attention and MLA
    layers, the selective scan in Mamba layers."""
    from repro_torch.models import split_pattern

    prefix, _ = split_pattern(cfg)
    runs = [1] * len(prefix) + [2] * (cfg.n_layers - len(prefix))
    first_moe = cfg.moe.first_dense if cfg.moe is not None else cfg.n_layers

    def count(pick):
        return (sum(r for r, kind in zip(runs, cfg.pattern) if pick(kind)),
                sum(1 for kind in cfg.pattern if pick(kind)))
    flash, flash_bwd = count(lambda kind: kind.startswith("attn") or kind == "mla")
    lru, lru_bwd = count(lambda kind: kind == "rglru")
    mamba, mamba_bwd = count(lambda kind: kind == "mamba")
    moe_layers = range(first_moe, cfg.n_layers)
    return {"flash": flash, "flash_bwd": flash_bwd,
            "gmm": 3 * sum(runs[i] for i in moe_layers), "gmm_dx": 3 * len(moe_layers),
            "gmm_dx_wgmma": 3 * len(moe_layers) if cfg.dtype in ("bfloat16", "float16") else 0,
            "gmm_dw": 3 * len(moe_layers), "lru": lru, "lru_bwd": lru_bwd, "mamba": mamba,
            "mamba_bwd": mamba_bwd}


def plain_gmm(x, w, tile_groups, *, block_m, err=None):
    from repro_torch.kernels.ref import grouped_matmul_ref

    return grouped_matmul_ref(x, w, tile_groups, block_m=block_m)


def recording_routes(calls):
    """A stand-in for ``models.ffn.route_moe`` that appends each call's
    discrete choices (top_e, token_idx, valid) to ``calls``."""
    from repro_torch.models import ffn

    route = ffn.route_moe

    def wrapped(p, x, cfg):
        r = route(p, x, cfg)
        calls.append((r.top_e.detach(), r.token_idx.detach(), r.valid.detach()))
        return r
    return wrapped


def pinned_routes(choices):
    """A stand-in for ``models.ffn.route_moe`` that replays another pass's
    discrete choices (``recording_routes``), call by call, and computes the
    router's probabilities and scores from this pass's own input as
    ``route_moe`` does: the same function, with no near-tied top-8 choice
    flipped by a bf16 difference upstream."""
    import torch
    from repro_torch.models import ffn

    replay = iter(choices)

    def pinned(p, x, cfg):
        top_e, token_idx, _ = next(replay)
        g, tg, _ = ffn._groups(x, cfg)
        xg = x.reshape(g, tg, x.shape[-1])
        probs = torch.softmax(torch.einsum("gtd,de->gte", xg.float(), p.router), dim=-1)
        top_p = probs.gather(-1, top_e)
        top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
        assign = torch.zeros((g, tg, p.w_gate.shape[0]), dtype=torch.float32, device=x.device)
        assign.scatter_(2, top_e, top_p)
        top_scores = assign.transpose(1, 2).gather(2, token_idx)
        return ffn.MoeRouting(top_p, top_e, token_idx, top_scores, top_scores > 0.0)
    return pinned


def differing_token_sets(calls_k, calls_p):
    """{(call, expert)} whose kept token sets differ between two passes'
    routing calls (the same calls in the same order)."""
    out = set()
    for i, ((_, tk, vk), (_, tp, vp)) in enumerate(zip(calls_k, calls_p)):
        tk, vk, tp, vp = tk.cpu(), vk.cpu(), tp.cpu(), vp.cpu()
        for e in range(tk.shape[1]):
            if set(tk[:, e][vk[:, e]].tolist()) != set(tp[:, e][vp[:, e]].tolist()):
                out.add((i, e))
    return out


def plain_pass(cfg, model, batch, route, attention_only=False):
    """Step 0's loss and gradients with ops.attention, ops.grouped_matmul,
    ops.lru_scan and ops.mamba_scan (only ops.attention with
    ``attention_only``) swapped for their plain versions and
    ``models.ffn.route_moe`` for ``route``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref, lru_scan_ref, mamba_scan_ref
    from repro_torch.models import ffn, loss_and_grads

    kernels = (ops.attention, ops.grouped_matmul, ops.lru_scan, ops.mamba_scan, ffn.route_moe)
    ops.attention = attention_ref
    if not attention_only:
        ops.grouped_matmul, ops.lru_scan, ops.mamba_scan = plain_gmm, lru_scan_ref, mamba_scan_ref
    ffn.route_moe = route
    try:
        return loss_and_grads(model, cfg, *batch)
    finally:
        ops.attention, ops.grouped_matmul, ops.lru_scan, ops.mamba_scan, ffn.route_moe = kernels


def step0_distance(loss_k, grads_k, loss_p, grads_p):
    """(|loss difference|, both global gradient norms, each leaf's cosine,
    the lowest leaf's name)."""
    norm_k, leaves_k = grad_stats(grads_k)
    norm_p, leaves_p = grad_stats(grads_p)
    cosines = {}
    for name, a in leaves_k.items():
        b = leaves_p[name].float()
        a = a.float()
        denom = float(a.norm() * b.norm())
        cosines[name] = float((a * b).sum()) / denom if denom else 1.0
    return (abs(float(loss_k) - float(loss_p)), norm_k, norm_p, cosines,
            min(cosines, key=cosines.get))


def train_step0(cfg, model, batch, card):
    """Step 0's loss and gradients through the kernels against the plain
    versions and both against the float32 gradient (see TRAIN_LOSS_ATOL
    and TRAIN_TRUTH_RATIO): checks the gates and the kernels' launches,
    then frees the gradients. A MoE's plain passes replay the kernel
    pass's routing choices (``pinned_routes``); one more plain pass that
    routes for itself is logged: how far the near-tied choices alone move
    the gradients."""
    import copy
    import dataclasses

    import torch
    from repro_torch.models import ffn, loss_and_grads

    want = expected_train_launches(cfg)
    choices_k, choices_free = [], []
    route = ffn.route_moe
    reset_train_counters()
    ffn.route_moe = recording_routes(choices_k)
    try:
        loss_k, grads_k = loss_and_grads(model, cfg, *batch)
    finally:
        ffn.route_moe = route
    torch.cuda.synchronize()
    got = train_counters()
    check(got == want, f"train {cfg.name}: step 0 launched {got}, expected {want}")
    same_routes = (lambda: pinned_routes(choices_k)) if choices_k else (lambda: route)
    loss_p, grads_p = plain_pass(cfg, model, batch, same_routes())
    torch.cuda.synchronize()
    check(train_counters() == want, f"train {cfg.name}: the plain pass launched a kernel")
    loss_err, norm_k, norm_p, cosines, worst = step0_distance(loss_k, grads_k, loss_p, grads_p)
    if choices_k:  # the grouped GEMM's kernels alone: both passes attend plainly
        loss_a, grads_a = plain_pass(cfg, model, batch, same_routes(), attention_only=True)
        _, _, _, cos_a, worst_a = step0_distance(loss_a, grads_a, loss_p, grads_p)
        del grads_a
        log(f"train {cfg.name}: step 0 with only the attention plain (the grouped GEMM and its "
            f"backward through the kernels) against the plain versions: lowest leaf cosine "
            f"{cos_a[worst_a]:.6f} ({worst_a}), median {statistics.median(cos_a.values()):.6f} "
            f"[{card}]")
    wide = copy.deepcopy(model).float()
    loss_t, grads_t = plain_pass(dataclasses.replace(cfg, dtype="float32"), wide, batch,
                                 same_routes())
    del wide
    cos_kt, cos_pt = (step0_distance(loss, grads, loss_t, grads_t)[3]
                      for loss, grads in ((loss_k, grads_k), (loss_p, grads_p)))
    del grads_p, grads_t
    torch.cuda.empty_cache()
    floor = min(cos_pt.values())
    excess = {n: (1 - cos_kt[n]) - (TRAIN_TRUTH_RATIO * (1 - cos_pt[n]) + TRAIN_TRUTH_FLOOR)
              for n in cos_kt}
    over = max(excess, key=excess.get)
    ratio = max((1 - cos_kt[n]) / max(1 - cos_pt[n], 1e-12) for n in cos_kt)
    log(f"train {cfg.name}: step 0 against the float32 gradient (the same weights in float32, "
        f"plain versions, the same routing; loss {float(loss_t):.6f}): leaf cosines through the "
        f"kernels median {statistics.median(cos_kt.values()):.6f}, lowest "
        f"{min(cos_kt.values()):.6f}; the plain bf16 path's median "
        f"{statistics.median(cos_pt.values()):.6f}, lowest {floor:.6f}; the kernels' distance "
        f"1 - cosine over {TRAIN_TRUTH_RATIO} x the plain path's + {TRAIN_TRUTH_FLOOR}: at most "
        f"{excess[over]:.3g} ({over}; bound 0); the largest ratio of the two distances "
        f"{ratio:.3f} [{card}]")
    log(f"train {cfg.name}: step 0 through the kernels against the plain versions"
        + (" (the plain pass replaying the kernel pass's routing choices)" if choices_k else "")
        + f": loss {float(loss_k):.6f} vs {float(loss_p):.6f} (|diff| {loss_err:.3g}, bound "
        f"{TRAIN_LOSS_ATOL}), gradient norm {norm_k:.6g} vs {norm_p:.6g} (rel diff "
        f"{abs(norm_k - norm_p) / norm_p:.3g}, bound {TRAIN_GNORM_RTOL}), lowest leaf cosine "
        f"{cosines[worst]:.6f} ({worst}; bound {TRAIN_MIN_COSINE}), median leaf cosine "
        f"{statistics.median(cosines.values()):.6f}; launches {got} [{card}]")
    if choices_k:
        loss_f, grads_f = plain_pass(cfg, model, batch, recording_routes(choices_free))
        f_err, _, norm_f, f_cos, f_worst = step0_distance(loss_k, grads_k, loss_f, grads_f)
        moved = differing_token_sets(choices_k, choices_free)
        layers = sorted({tuple(int(x) for x in n.split("/")[1:3])
                         for n in f_cos if n.startswith("stages/")})
        low = min((n for n in f_cos if "/ffn/w_" in n), key=f_cos.get)
        layer = layers.index(tuple(int(x) for x in low.split("/")[1:3]))
        log(f"train {cfg.name}: the plain pass routing for itself: {len(moved)} of "
            f"{sum(t.shape[1] for _, t, _ in choices_k)} (call, expert) token sets differ from "
            f"the kernel pass's (calls 0-{cfg.n_layers - 1}: the first forward, in layer order); "
            f"loss {float(loss_f):.6f} (|diff| {f_err:.3g}), gradient norm {norm_f:.6g}, lowest "
            f"leaf cosine {f_cos[f_worst]:.6f} ({f_worst}), median "
            f"{statistics.median(f_cos.values()):.6f}; lowest expert weight {low} at "
            f"{f_cos[low]:.6f} (layer {layer}: {sum(c == layer for c, _ in moved)} of its "
            f"experts' token sets differ) [{card}]")
        del grads_f
    check(loss_err <= TRAIN_LOSS_ATOL, f"train {cfg.name}: step 0's loss through the kernels "
                                       f"{float(loss_k)} off the plain versions' {float(loss_p)}")
    check(abs(norm_k - norm_p) <= TRAIN_GNORM_RTOL * norm_p,
          f"train {cfg.name}: gradient norm through the kernels {norm_k} off the plain "
          f"versions' {norm_p}")
    check(floor < TRAIN_MIN_COSINE or cosines[worst] >= TRAIN_MIN_COSINE,
          f"train {cfg.name}: {worst}'s gradient through the kernels at cosine {cosines[worst]} "
          f"with the plain versions'")
    check(excess[over] <= 0.0,
          f"train {cfg.name}: {over}'s gradient through the kernels at cosine {cos_kt[over]} "
          f"with the float32 gradient, the plain bf16 path's at {cos_pt[over]}")
    del grads_k
    torch.cuda.empty_cache()


def train_batches(cfg):
    """TRAIN_STEPS (inputs, labels) numpy batches of TRAIN_BATCH x
    TRAIN_SEQ from ``TokenPipeline(vocab, seed=0)``; a frontend arch's
    inputs are seeded ``[TRAIN_BATCH, TRAIN_SEQ, F]`` float32 embeddings
    (``FRONTEND_DIMS``, as the CPU tests make them), its labels the
    pipeline's."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import FRONTEND_DIMS

    pipeline = TokenPipeline(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    rng = np.random.RandomState(0)
    out = []
    for _ in range(TRAIN_STEPS):
        inputs, labels = pipeline.next_batch()
        if cfg.frontend:
            inputs = rng.randn(TRAIN_BATCH, TRAIN_SEQ,
                               FRONTEND_DIMS[cfg.frontend]).astype(np.float32)
        out.append((inputs, labels))
    return out


def phase_train(device, card, arch):
    """One of TRAIN_ARCHS, whole or cut in depth as TRAIN_CUTS says,
    trained on the card: step 0 held to the
    plain versions (``train_step0``), then TRAIN_STEPS
    ``StepBundle.train_step``s: every loss and gradient norm finite, each
    kernel of the path launched exactly as ``expected_train_launches``
    says a step. Logs step ms (median of steps 1 on), tokens/s, MFU against
    the bf16 peak from ``model_flops_per_device`` (6 N D, N the active
    parameters of a MoE) and the peak device memory, and one more step
    under ``torch.profiler`` by kernel group. Returns the steps' launch
    counts and the walls."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch.roofline_run import model_flops_per_device
    from repro_torch.launch.steps import StepBundle
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(ARCHS[arch], **TRAIN_CUTS.get(arch, {}))
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=device, tp_size=1).requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    batches = [tuple(torch.from_numpy(a).to(device) for a in batch)
               for batch in train_batches(cfg)]
    torch.cuda.synchronize()
    cut = f" (cut: {TRAIN_CUTS[arch]})" if arch in TRAIN_CUTS else ""
    inputs = (f"seeded [{TRAIN_BATCH}, {TRAIN_SEQ}, {batches[0][0].shape[-1]}] {cfg.frontend} "
              f"embeddings" if cfg.frontend else "tokens")
    log(f"train: {cfg.name} {cfg.n_layers} layers{cut} d_model {cfg.d_model} {cfg.n_heads} heads "
        f"of {cfg.head_dim} over {cfg.n_kv_heads} vocab {cfg.vocab} {cfg.dtype}, {n_params} "
        f"parameters from seed 0, AdamW state {3 * 4 * n_params / 1e9:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s ({before / 1e9:.2f} GB allocated before); batches "
        f"[{TRAIN_BATCH}, {TRAIN_SEQ}] of {inputs} [{card}]")
    train_step0(cfg, model, batches[0], card)

    opt = adamw_init(model.param_tree())
    bundle = StepBundle(cfg, lr=TRAIN_LR, clip=TRAIN_CLIP)
    reset_train_counters()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, gnorms = [], [], []
    for inputs, labels in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, metrics = bundle.train_step(model, opt, inputs, labels)
        losses.append(float(metrics["loss"]))  # a host read: the step has ended
        gnorms.append(float(metrics["gnorm"]))
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    TRAIN_PEAKS[arch] = (peak, before)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train {cfg.name}: non-finite loss or gradient norm: {losses} {gnorms}")
    counts = train_counters()
    want = {k: v * TRAIN_STEPS for k, v in expected_train_launches(cfg).items()}
    check(counts == want, f"train {cfg.name}: {TRAIN_STEPS} steps launched {counts}, "
                          f"expected {want}")
    n_leaves = len(tree_leaves(model.param_tree()))
    opt_counts = optimizer_counters()
    want_opt = (TRAIN_STEPS, 2 * TRAIN_STEPS, {"fused": TRAIN_STEPS * n_leaves, "per_leaf": 0})
    check(opt_counts == want_opt,
          f"train {cfg.name}: the optimizer's {TRAIN_STEPS} steps gave (update launches, norm "
          f"launches, leaves by path) {opt_counts}, expected {want_opt}")
    step_ms = statistics.median(walls[1:]) * 1e3
    flops = model_flops_per_device(cfg, "train", 1,
                                   shapes={"train": (TRAIN_SEQ, TRAIN_BATCH, "train")})
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"train {cfg.name}: {TRAIN_STEPS} steps of {tokens} tokens: losses {losses}, gradient "
        f"norms {gnorms}; step ms {[round(w * 1e3, 3) for w in walls]} (host clock), median of "
        f"steps 1-{TRAIN_STEPS - 1} {step_ms:.3f} ms, {tokens / step_ms * 1e3:.1f} tokens/s, "
        f"model FLOPs {flops:.4g} a step (6 N D) = MFU {flops / (step_ms / 1e3) / BF16_FLOP_PER_S:.4f} "
        f"of {BF16_FLOP_PER_S:.3g} FLOP/s, peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {counts} [{card}]")
    # One more step under torch.profiler: where the step's device time goes.
    from torch.autograd import DeviceType

    prof, wall_ms = profiled(lambda: bundle.train_step(model, opt, *batches[-1]))
    groups = dict.fromkeys(("flash forward", "flash backward", "grouped GEMM forward",
                            "grouped GEMM dx", "grouped GEMM dw", "LRU scan", "LRU reverse scan",
                            "Mamba scan", "Mamba scan backward", "GEMM", "elementwise",
                            "reduction", "other"), 0.0)
    counts_by = dict.fromkeys(groups, 0)
    others = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        group = ("flash backward" if "flash_bwd" in name else
                 "flash forward" if "flash_tc_kernel" in name else
                 "grouped GEMM dw" if "gmm_dw" in name or "gmm_tile_table" in name else
                 "grouped GEMM dx" if "gmm_dx" in name else
                 "grouped GEMM forward" if "gmm_tc_kernel" in name else
                 "LRU reverse scan" if "lru_scan_bwd" in name else
                 "LRU scan" if "lru_scan_kernel" in name else
                 "Mamba scan backward" if "mamba_scan_bwd" in name else
                 "Mamba scan" if "mamba_scan_kernel" in name else
                 "GEMM" if any(k in name for k in ("gemm", "xmma", "cutlass", "nvjet")) else
                 "elementwise" if "elementwise" in name else
                 "reduction" if "reduce" in name else "other")
        groups[group] += e.time_range.elapsed_us() / 1e3
        counts_by[group] += 1
        if group == "other":
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(((a.self_device_time_total / 1e3, a.count, a.key[:70])
                  for a in prof.key_averages() if a.self_device_time_total > 0), reverse=True)[:6]
    log(f"train {cfg.name}: one more step under torch.profiler: wall {wall_ms:.3f} ms; device "
        f"time by kernel group (ms, kernels): "
        + ", ".join(f"{k} {v:.3f} ({counts_by[k]})" for k, v in groups.items())
        + f", sum {sum(groups.values()):.3f}; other's largest: "
        + "; ".join(f"{k} {v:.3f}" for k, v in sorted(others.items(), key=lambda kv: -kv[1])[:4])
        + "; most device time: "
        + "; ".join(f"{key} {ms:.3f} ms x{n}" for ms, n, key in top) + f" [{card}]")
    del model, opt, batches, prof
    free_device_memory()
    counts = {**counts, "adamw": opt_counts[0], "adamw_norm": opt_counts[1]}
    return counts, {f"train {cfg.name} step (median)": step_ms / 1e3}


# Phase 9's measured peak device memory (max_memory_allocated) and what was
# allocated before its model was built, by arch: phase 10 holds the dry
# run's fake-world-of-1 trace against minicpm's.
TRAIN_PEAKS = {}
# Phase 6's median decode step before its kernels became torch.library ops
# (ms, H100 80GB HBM3 at 700 W; PERF.md section 5), at the same depth as
# now: before flash's op, before the scans' ops.
PRIOR_DECODE_MS = {"h2o-danube-3-4b": (53.509, "flash"),
                   "recurrentgemma-2b": (37.295, "the scans"),
                   "falcon-mamba-7b": (52.635, "the scans")}
# The dry run's records of the cells phase 10 traces beyond its first two, as
# the CPU traced them (python -m repro_torch.launch.dryrun; PERF.md section
# 6): (arch, shape, multi_pod) -> FLOPs, bytes, wire bytes and peak bytes
# a device.
DRYRUN_RECORDS = {
    ("recurrentgemma-2b", "long_500k", True): {
        "flops": 549949620.0, "bytes": 656115602.0, "wire": 12717440.0, "peak": 580282572},
    ("falcon-mamba-7b", "train_4k", False): {
        "flops": 789893877858304.0, "bytes": 5811625938240.0, "wire": 1123920283664.0,
        "peak": 45938035724},
}


def all_counters():
    """Every launch counter of the port's kernels, by name."""
    we = importlib.import_module("repro_torch.kernels.wave_elementwise")
    rq = importlib.import_module("repro_torch.kernels.ready_queue")
    return {**train_counters(), "wave": we.launches, "wave_steps": we.steps,
            "ready_queue": rq.launches}


def phase_dryrun(device, card):
    """Phase 10 (see the module docstring): the dry run's two cells at
    published widths, the fake-world-of-1 check against phase 9, and the
    ops' host cost. Returns the records."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    from repro_torch.launch.roofline_run import model_flops_per_device
    from repro_torch.launch.steps import StepBundle

    total = torch.cuda.get_device_properties(device).total_memory
    log(f"dry run: the card's memory {total} B ({total / 2**30:.2f} GiB), the dry run's "
        f"CARD_MEMORY_BYTES {dryrun.CARD_MEMORY_BYTES} ({dryrun.CARD}) [{card}]")
    check(total == dryrun.CARD_MEMORY_BYTES,
          f"dry run: the card has {total} B, dryrun.CARD_MEMORY_BYTES says "
          f"{dryrun.CARD_MEMORY_BYTES}")
    torch.cuda.synchronize()
    counters, allocated = all_counters(), torch.cuda.memory_allocated()
    records = []
    for arch, multi_pod in (("minicpm-2b", False), ("granite-moe-3b-a800m", True)):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, "train_4k", multi_pod, verbose=False)
        coll = rec["collectives"]
        log(f"dry run {arch}/train_4k on {rec['mesh']} ({rec['n_devices']} fake H100s, "
            f"{time.perf_counter() - t0:.1f} s): FLOPs/device {rec['flops_per_device']:.4g}, "
            f"bytes/device {rec['bytes_per_device']:.4g}, wire bytes {coll['total_bytes']:.4g} "
            f"(by kind {({k: coll[k] for k in coll['counts']})}, counts {coll['counts']}, by "
            f"link {coll['by_link']}, by axis {coll['by_axis']}), argument bytes "
            f"{rec['memory']['argument_bytes']}, output bytes {rec['memory']['output_bytes']}, "
            f"peak bytes {rec['peak_bytes']} ({rec['peak_bytes'] / 2**30:.2f} GiB, "
            f"{'fits' if rec['fits'] else 'does NOT fit'} the card's {total / 2**30:.2f} GiB), "
            f"policy {rec['policy']} [{card}]")
        log("dry run record: " + json.dumps(rec, default=str))
        records.append(rec)
    for (arch, shape, multi_pod), want in DRYRUN_RECORDS.items():
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
        got = {"flops": rec["flops_per_device"], "bytes": rec["bytes_per_device"],
               "wire": rec["collectives"]["total_bytes"], "peak": rec["peak_bytes"]}
        log(f"dry run {arch}/{shape} on {rec['mesh']} ({rec['n_devices']} fake H100s, "
            f"{time.perf_counter() - t0:.1f} s): {got} against the CPU's {want}; collectives "
            f"{rec['collectives']['counts']}, by axis {rec['collectives']['by_axis']}, peak "
            f"{rec['peak_bytes'] / 2**30:.2f} GiB ({'fits' if rec['fits'] else 'does NOT fit'}"
            f"), policy {rec['policy']} [{card}]")
        log("dry run record: " + json.dumps(rec, default=str))
        check(got == want, f"dry run {arch}/{shape}: the card's trace counts {got}, the CPU's "
                           f"{want}")
        records.append(rec)
    # phase 9's shape on one fake H100
    cfg = ARCHS["minicpm-2b"]
    shapes = {"train": (TRAIN_SEQ, TRAIN_BATCH, "train")}
    t0 = time.perf_counter()
    with fake_world(1):
        t = StepBundle(cfg, make_local_mesh(device="cuda")).trace("train", shapes)
    torch.cuda.synchronize()
    check(all_counters() == counters, f"dry run: kernel launch counters moved: {counters} -> "
                                      f"{all_counters()}")
    check(torch.cuda.memory_allocated() == allocated,
          f"dry run: memory allocated moved from {allocated} to "
          f"{torch.cuda.memory_allocated()}")
    peak, before = TRAIN_PEAKS["minicpm-2b"]
    six_nd = model_flops_per_device(cfg, "train", 1, shapes=shapes)
    log(f"dry run minicpm-2b at phase 9's shape [{TRAIN_BATCH}, {TRAIN_SEQ}] on a fake world "
        f"of 1 ({time.perf_counter() - t0:.1f} s): peak bytes {t['peak_bytes']} "
        f"({t['peak_bytes'] / 2**30:.2f} GiB) against phase 9's max_memory_allocated {peak} "
        f"({peak / 2**30:.2f} GiB; {before} B allocated before its model): ratio "
        f"{t['peak_bytes'] / peak:.4f} (to the peak less what was there before: "
        f"{t['peak_bytes'] / max(peak - before, 1):.4f}); FLOPs {t['flops']:.6g} against 6 N D "
        f"{six_nd:.6g}: ratio {t['flops'] / six_nd:.4f}; argument bytes "
        f"{t['argument_bytes']}; no launch, no allocation [{card}]")
    host_cost(device, card)
    return records


def host_cost(device, card):
    """The torch.library ops' host cost per call: flash at a decode step's
    shape (granite's: 24 heads over 8, one query row against 512 keys), the
    grouped GEMM at one MoE product's (48 experts of C = 1 row, 1536 to
    512), the RG-LRU scan at recurrentgemma's decode step ([1, 1, 2560]
    float32) and the Mamba scan at falcon-mamba's (bf16 [1, 1, 8192], N 16,
    z, b and c sliced from their projections), each called through the
    wrapper (the op) and through the launch function under it, 2000 times
    back to back, host clock; the medians of 5 rounds, the orders
    alternating."""
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    ls = importlib.import_module("repro_torch.kernels.lru_scan")
    ss = importlib.import_module("repro_torch.kernels.selective_scan")
    gen = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(1, 24, 1, 128, generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn(1, 8, 512, 128, generator=gen, device=device).to(torch.bfloat16)
    x = torch.randn(48, 1536, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(48, 1536, 512, generator=gen, device=device).to(torch.bfloat16)
    tiles = torch.arange(48, dtype=torch.int32, device=device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    masks = fa._masks(True, None, None, 511, 0)
    a = torch.rand(1, 1, 2560, generator=gen, device=device)
    b = torch.randn(1, 1, 2560, generator=gen, device=device)
    h0 = torch.zeros(1, 2560, device=device)
    e, n, rank = 8192, 16, 256
    xz = torch.randn(1, 1, 2 * e, generator=gen, device=device).to(torch.bfloat16)
    proj = torch.randn(1, 1, rank + 2 * n, generator=gen, device=device).to(torch.bfloat16)
    scan = (torch.randn(1, 1, e, generator=gen, device=device).to(torch.bfloat16),
            torch.zeros(e, device=device), xz[..., :e].contiguous(), xz[..., e:],
            proj[..., rank:rank + n], proj[..., rank + n:],
            torch.rand(e, n, generator=gen, device=device), torch.ones(e, device=device),
            torch.zeros(1, e, n, device=device))
    ready = ss._fused_ready(*scan)
    calls = {
        "flash op": lambda: fa.flash_attention(q, k, k, q_offset=511),
        "flash launch": lambda: fa._forward(q, k, k, masks, 128 ** -0.5, False),
        "grouped GEMM op": lambda: gm.grouped_matmul(x, w, tiles, block_m=1, err=err),
        "grouped GEMM launch": lambda: gm._forward(x, w, tiles, 1, err),
        "RG-LRU scan op": lambda: ls.lru_scan(a, b, h0),
        "RG-LRU scan launch": lambda: ls._forward(a, b, h0),
        "Mamba scan op": lambda: ss.mamba_scan(*scan),
        "Mamba scan launch": lambda: ss._mamba_forward(ready, *scan),
    }
    n = 2000
    times = {name: [] for name in calls}
    for rnd in range(5):
        for name in (list(calls) if rnd % 2 == 0 else list(reversed(calls))):
            fn = calls[name]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            host = (time.perf_counter() - t0) / n
            torch.cuda.synchronize()
            times[name].append(host * 1e6)
    med = {name: statistics.median(v) for name, v in times.items()}
    log(f"ops' host cost (us a call, host clock to return, median of 5 x {n}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f"; the op adds {med['flash op'] - med['flash launch']:.2f} us to flash, "
        f"{med['grouped GEMM op'] - med['grouped GEMM launch']:.2f} us to the grouped GEMM, "
        f"{med['RG-LRU scan op'] - med['RG-LRU scan launch']:.2f} us to the RG-LRU scan (18 "
        f"a recurrentgemma-2b decode step) and "
        f"{med['Mamba scan op'] - med['Mamba scan launch']:.2f} us to the Mamba scan (64 a "
        f"falcon-mamba-7b decode step) [{card}]")
    torch.cuda.synchronize()


def phase_trainer(device, card):
    """The fault-tolerant ``Trainer`` on the card at a reduced minicpm
    (TRAINER_CUT, bf16): TRAINER_STEPS steps uninterrupted; the same with a
    checkpoint every TRAINER_EVERY steps and a crash at TRAINER_FAIL; a
    fresh ``Trainer`` on that directory resumes at TRAINER_EVERY and its
    losses and gradient norms equal the uninterrupted run's bit for bit
    (every kernel of the step is deterministic)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.runtime import Trainer, TrainerConfig

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], **TRAINER_CUT)
    tc = TrainerConfig(seq_len=128, batch=4, lr=3e-3, warmup=5, total_steps=TRAINER_STEPS,
                       checkpoint_every=TRAINER_EVERY)
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        whole = Trainer(cfg, tc, Path(tmp) / "whole", device=device).run()
        crashed = Trainer(cfg, tc, Path(tmp) / "crash", fail_at_step=TRAINER_FAIL, device=device)
        try:
            crashed.run()
        except RuntimeError as exc:
            if "injected failure" not in str(exc):
                raise
            log(f"trainer: crashed as injected ({exc})")
        else:
            check(False, "trainer: the injected failure did not happen")
        resumed = Trainer(cfg, tc, Path(tmp) / "crash", device=device)
        check(resumed.start_step == TRAINER_EVERY,
              f"trainer: resumed at step {resumed.start_step}, expected {TRAINER_EVERY}")
        tail = resumed.run()
    want = {m["step"]: (m["loss"], m["gnorm"]) for m in whole if m["step"] >= TRAINER_EVERY}
    got = {m["step"]: (m["loss"], m["gnorm"]) for m in tail}
    check(got == want, f"trainer: resumed losses and norms {got} != uninterrupted {want}")
    check(fa.launches > 0 and fa.backward_launches > 0, "trainer: flash was not launched")
    check(all(np.isfinite(m["loss"]) for m in whole) and whole[-1]["loss"] < whole[0]["loss"],
          f"trainer: the loss did not fall: {[m['loss'] for m in whole]}")
    log(f"trainer: {cfg.name} cut to {TRAINER_CUT} bf16, {TRAINER_STEPS} steps: losses "
        f"{[round(m['loss'], 5) for m in whole]}; crash at {TRAINER_FAIL}, resumed at "
        f"{TRAINER_EVERY}: steps {TRAINER_EVERY}-{TRAINER_STEPS - 1} bit-equal to the "
        f"uninterrupted run; step {statistics.median(m['dt'] for m in whole) * 1e3:.3f} ms "
        f"(median, host clock, batch fetch included); flash {fa.launches} forward and "
        f"{fa.backward_launches} backward launches [{card}]")


def frontend_pass(device, card, cfg, params, s, plain=False):
    """One frontend pass (see ``phase_frontend``): returns forward's
    logits and prefill's flash launches."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    from repro_torch.models import FRONTEND_DIMS, decode_step, forward, init_cache, prefill

    check(not torch.backends.cuda.matmul.allow_tf32, "float32 matmuls must not run in TF32")
    per_pass = 0 if plain else cfg.n_layers  # flash launches in forward and in prefill
    atol, rtol, share = FRONTEND_TOL[cfg.dtype]
    attention = "the plain attention" if plain else "flash"
    n_params = sum(p.numel() for p in params.parameters())
    total = s + FRONTEND_STEPS
    emb = torch.from_numpy(np.random.RandomState(SERVE_SEED).randn(
        1, total, FRONTEND_DIMS[cfg.frontend]).astype(np.float32)).to(device)
    log(f"frontend: {cfg.name} ({cfg.frontend}) {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, {n_params} parameters from seed {SERVE_SEED}, through {attention}; "
        f"embeddings {tuple(emb.shape)}, prefix_len {cfg.prefix_len} [{card}]")
    fa.reset_launches()
    want = forward(params, cfg, emb)
    torch.cuda.synchronize()
    check(fa.launches == per_pass,
          f"frontend {cfg.name}: forward launched flash {fa.launches} times, expected "
          f"{per_pass}")
    check(bool(torch.isfinite(want).all()), f"frontend {cfg.name}: non-finite forward logits")
    scale = float(want.abs().max())
    atol += share * scale

    def compare(got, at, what):
        ref = want[:, at]
        err = (got.float() - ref.float()).abs()
        check(bool(torch.isfinite(got).all()), f"frontend {cfg.name}: non-finite {what} logits")
        check(bool((err <= atol + rtol * ref.float().abs()).all()),
              f"frontend {cfg.name} {cfg.dtype} through {attention}: {what} logits off "
              f"forward's at position {at}: max abs err {float(err.max())} (logits up to "
              f"{scale:.3f})")
        return float(err.max()), bool(torch.equal(got.argmax(-1), ref.argmax(-1)))

    fa.reset_launches()
    t0 = time.perf_counter()
    last, cache = prefill(params, cfg, emb[:, :s], init_cache(cfg, 1, total, device=device))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = fa.launches
    check(launches == per_pass,
          f"frontend {cfg.name}: prefill launched flash {launches} times, expected {per_pass}")
    err, agree = compare(last[:, -1], s - 1, "prefill")
    errs, same = [err], [agree]
    t0 = time.perf_counter()
    for i in range(FRONTEND_STEPS):
        logits, cache = decode_step(params, cfg, emb[:, s + i: s + i + 1], cache, s + i)
        err, agree = compare(logits[:, -1], s + i, f"decode step {i}")
        errs.append(err)
        same.append(agree)
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / FRONTEND_STEPS
    check(fa.launches == per_pass,
          f"frontend {cfg.name}: prefill and decode launched flash {fa.launches} times, "
          f"expected {per_pass}")
    log(f"frontend {cfg.name} {cfg.dtype} through {attention}: prefill of {s} and "
        f"{FRONTEND_STEPS} teacher-forced decode steps within {atol:.4g} abs, {rtol} rel of "
        f"forward's logits (max abs err {max(errs):.4g}, logits up to {scale:.3f}; argmax "
        f"equal at {sum(same)} of {len(same)} positions); flash {per_pass} launches in "
        f"forward and in prefill, 0 in decode; prefill {t_prefill * 1e3:.3f} ms, decode step "
        f"{t_decode * 1e3:.3f} ms (host clock) [{card}]")
    return want, launches


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
        "replaces": "src/repro/kernels/ready_queue.py:107",
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


def numbers_lru(device):
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
        "launches": None,  # main() adds recurrentgemma's server run's
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


def numbers_scan(device):
    """The selective scan at falcon-mamba-7b's main-path shapes, through
    the fused entry the model calls (``mamba_scan``, bf16, z, b and c
    strided): prefill ``[1, 512, 8192]`` and ``[1, 128, 8192]`` (the
    serving runs' longest and shortest prompts), N 16, and a decode launch
    ``[1, 1, 8192]``; each its single launches, 20 back to back, its device
    time, the plain version's time and its bound. Also the scan alone in
    float32 at the 512-step prefill (the first design's timed shape),
    the launch shape (grid, warps an SM, registers, shared memory) and the
    SASS instructions a state and step of both entries' prefill instance.
    The fused span's bound: bytes (dt_raw, x, z and y, b and c in bf16;
    dt_bias, A_log, D, h0 and hT in float32) against the special-function
    work, one exponential a state and step plus the softplus's exp and log
    and the gate's exp and reciprocal a channel and step, on the SFUs."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import mamba_scan_ref, selective_scan_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    name = "mamba_scan_kernel"
    out = {}
    for label, s in (("prefill", 512), ("prefill_128", 128), ("decode", 1)):
        b, e, n = 1, 8192, 16
        args = fused_inputs(gen, b, s, e, n, torch.bfloat16, device)
        got = ss.mamba_scan(*args)
        want = mamba_scan_ref(*args, out_dtype=torch.float32)
        plain_y = mamba_scan_ref(*args)[0]  # the plain version's own bf16 output
        torch.cuda.synchronize()
        (ok_y, _, _), (ok_h, err_h, _) = (within_scan_tol(g, w) for g, w in zip(got, want))
        err_y = float((got[0].float() - plain_y.float()).abs().max())
        n_bytes = 2 * (4 * b * s * e + 2 * b * s * n) + 4 * (2 * e + e * n + 2 * b * e * n)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        sfu_ms = b * s * e * (n + 4) / SFU_EXP_PER_S * 1e3
        flops_ms = (6 * b * s * e * n + 8 * b * s * e) / FP32_FLOP_PER_S * 1e3
        kernel = lambda: ss.mamba_scan(*args)  # noqa: E731
        out[label] = dict(
            ms=median_ms(kernel), b2b_ms=back_to_back_ms(kernel),
            device_ms=kernel_device_ms(kernel, name)[0],
            plain_ms=median_ms(lambda: mamba_scan_ref(*args), runs=5),
            bound_ms=max(bytes_ms, sfu_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= max(sfu_ms, flops_ms) else "operations",
            bytes_ms=bytes_ms, sfu_ms=sfu_ms, flops_ms=flops_ms,
            max_abs_err=max(err_y, err_h), matches_plain=ok_y and ok_h,
            launch=ss.launch_config(torch.bfloat16, b, s, e, n))
        log(f"mamba_scan {label} [{b}, {s}, {e}] N {n} bf16: {out[label]} "
            f"[{torch.cuda.get_device_name(0)}]")
    args = scan_inputs(gen, 1, 512, 8192, 16, device)
    got, want = ss.selective_scan(*args), selective_scan_ref(*args)
    torch.cuda.synchronize()
    kernel = lambda: ss.selective_scan(*args)  # noqa: E731
    alone = dict(ms=median_ms(kernel), b2b_ms=back_to_back_ms(kernel),
                 device_ms=kernel_device_ms(kernel, name)[0],
                 bytes_ms=4 * (3 * 512 * 8192 + 2 * 512 * 16 + 3 * 8192 * 16)
                 / HBM_BYTES_PER_S * 1e3,
                 exp_ms=512 * 8192 * 16 / SFU_EXP_PER_S * 1e3,
                 matches_plain=all(within_scan_tol(g, w)[0] for g, w in zip(got, want)),
                 ht_bit_equal=bool(torch.equal(got[1], want[1])),
                 launch=ss.launch_config(None, 1, 512, 8192, 16))
    lib = ss.build()[0]
    # the prefill instances (4 steps a lane, 16 lanes a channel) of both entries
    sass = {"scan_float32": ss.sass_per_step(lib, "mamba_scan_kernelIfLb0ELi4ELi4E"),
            "fused_bf16": ss.sass_per_step(lib, "mamba_scan_kernelI13__nv_bfloat16Lb1ELi4ELi4E")}
    log(f"selective_scan (the scan alone, float32) [1, 512, 8192] N 16: {alone}; SASS a state "
        f"and step: {sass} [{torch.cuda.get_device_name(0)}]")
    pre, short, dec = out["prefill"], out["prefill_128"], out["decode"]
    return {
        "name": "selective_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/recurrent.py:151 (lax.scan; no pallas_call)",
        "launches": None,  # main() adds falcon-mamba's server run's
        "matches_plain": pre["matches_plain"] and dec["matches_plain"]
        and short["matches_plain"] and alone["matches_plain"],
        # bf16 y against the plain version's bf16 y (where the N-term sum's
        # order tips a rounding, one bf16 ulp), and the float32 hT
        "max_abs_err": max(pre["max_abs_err"], dec["max_abs_err"], short["max_abs_err"]),
        "ms": pre["ms"],
        "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": None,  # no PyTorch call computes a selective scan
        "back_to_back_ms": pre["b2b_ms"],
        "device_ms": pre["device_ms"],
        "bytes_bound_ms": pre["bytes_ms"],
        "sfu_bound_ms": pre["sfu_ms"],
        "grid": pre["launch"]["grid"],
        "warps_an_sm": pre["launch"]["warps_an_sm"],
        "prefill_128_ms": short["ms"],
        "prefill_128_back_to_back_ms": short["b2b_ms"],
        "prefill_128_device_ms": short["device_ms"],
        "prefill_128_bound_ms": short["bound_ms"],
        "prefill_128_warps_an_sm": short["launch"]["warps_an_sm"],
        "decode_ms": dec["ms"],
        "decode_back_to_back_ms": dec["b2b_ms"],
        "decode_device_ms": dec["device_ms"],
        "decode_plain_ms": dec["plain_ms"],
        "decode_bound_ms": dec["bound_ms"],
        "scan_alone_ms": alone["ms"],
        "scan_alone_back_to_back_ms": alone["b2b_ms"],
        "scan_alone_device_ms": alone["device_ms"],
        "scan_alone_exp_bound_ms": alone["exp_ms"],
        "ht_bit_equal": alone["ht_bit_equal"],
        "sass_a_state_and_step": {k: v["instructions_a_state_and_step"] for k, v in sass.items()},
        "shape": "fused bf16: dt_raw, x, z [1, 512, 8192], b, c [1, 512, 16] (strided), decode "
                 "S = 1; the scan alone in float32 at [1, 512, 8192]",
    }


def sdpa_backend(fn):
    """The kernel the library call ``fn`` ran (the CUDA kernel with the most
    device time over TIMED_RUNS profiled calls, after a warm-up call: a
    trace can lose its first device events, see ``phase_busy``, and a call
    may launch one kernel) and the backend that name shows: SDPA's "flash",
    "efficient", "cudnn" or "math", or "flex" for the Triton kernel
    ``flex_attention`` compiles (None, None when the trace holds no
    kernel)."""
    from torch.autograd import DeviceType

    fn()
    prof, _ = profiled(lambda: [fn() for _ in range(TIMED_RUNS)])
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not kernels:
        return None, None
    name = max(kernels, key=kernels.get)
    low = name.lower()
    kind = ("flex" if low.startswith("triton") else "cudnn" if "cudnn" in low
            else "flash" if "flash" in low
            else "efficient" if "fmha" in low or "efficient" in low else "math")
    return kind, name[:120]


# SDPA's keywords for a row's mask: the causal flag, or the visible pairs
# as an explicit mask (a prefix, or a window that cuts into the sequence).
CAUSAL = lambda mask: {"is_causal": True}  # noqa: E731
MASKED = lambda mask: {"attn_mask": mask}  # noqa: E731


def sdpa(kw):
    """The library call ``F.scaled_dot_product_attention`` with the keywords
    ``kw(mask)`` (``enable_gqa`` where the heads are grouped), for
    ``flash_case`` and ``flash_bwd_case``: a function of (q, k, v, the
    visible pairs) giving (the call, the backend SDPA's dispatcher picks
    for these inputs)."""
    def make(q, k, v, mask):
        import torch
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend

        args = {**kw(mask), "enable_gqa": q.shape[1] != k.shape[1]}
        return (lambda: F.scaled_dot_product_attention(q, k, v, **args),
                SDPBackend(torch._fused_sdp_choice(q, k, v, **args)).name)
    return make


@functools.lru_cache(maxsize=None)
def compiled_flex():
    """``flex_attention`` under ``torch.compile`` (its Triton kernels; one
    compile thread, so no worker process outlives the script; the compile
    caches under the kernels' build directory)."""
    import torch
    from repro_torch.kernels._nvcc import BUILD_DIR
    from torch.nn.attention.flex_attention import flex_attention

    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import torch._inductor.config as inductor

    inductor.compile_threads = 1
    return torch.compile(flex_attention, dynamic=False)


def flex_softcap(cap):
    """The library call for causal attention under a logit softcap (gemma2's
    ``cap * tanh(s / cap)`` on the scaled scores): ``flex_attention``,
    compiled, with that ``score_mod`` and a causal block mask. Same
    signature as ``sdpa``'s functions; the backend is "FLEX_ATTENTION"."""
    def make(q, k, v, mask):
        import torch
        from torch.nn.attention.flex_attention import create_block_mask

        s_q, s_k = q.shape[2], k.shape[2]
        causal = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        check(torch.equal(mask, causal), "flex_softcap: the row's mask is not causal")
        block_mask = create_block_mask(lambda b, h, qi, ki: qi >= ki, None, None, s_q, s_k,
                                       device=q.device)
        score_mod = lambda score, b, h, qi, ki: cap * torch.tanh(score / cap)  # noqa: E731
        flex = compiled_flex()
        return (lambda: flex(q, k, v, score_mod=score_mod, block_mask=block_mask,
                             enable_gqa=q.shape[1] != k.shape[1]),
                "FLEX_ATTENTION")
    return make


def flash_case(device, gen, shape, flags, library):
    """Flash at one main-path shape ``(b, h, hkv, s, d, dv)``, bf16: the
    error against the plain version, its bound, single launches (CUDA
    events), 20 back to back, its device time (profiler), the plain
    version's time, and the library call's (``library``: ``sdpa(...)`` or
    ``flex_softcap(...)``) the same ways with the backend it took, after
    its output is held to the plain version's as flash's is."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import attention_ref

    b, h, hkv, s, d, dv = shape
    q, k = (torch.randn(b, n, s, d, generator=gen, device=device).to(torch.bfloat16)
            for n in (h, hkv))
    v = torch.randn(b, hkv, s, dv, generator=gen, device=device).to(torch.bfloat16)
    got, want = flash_attention(q, k, v, **flags), attention_ref(q, k, v, **flags)
    torch.cuda.synchronize()
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    mask = cols <= rows
    if flags.get("window") is not None:
        mask &= cols > rows - flags["window"]
    if flags.get("prefix_len"):
        mask |= cols < flags["prefix_len"]
    seen = int(mask.sum())  # (row, key) pairs this input's mask keeps
    ms_bound, by = bound(2 * (q.numel() + k.numel() + v.numel() + got.numel()),
                         2 * b * h * seen * (d + dv), BF16_FLOP_PER_S)
    kernel = lambda: flash_attention(q, k, v, **flags)  # noqa: E731
    err = (got.float() - want.float()).abs()
    call, choice = library(q, k, v, mask)
    err_lib = (call().float() - want.float()).abs()
    check(bool((err_lib <= 2e-2 + 2e-2 * want.float().abs()).all()),
          f"{choice} at {shape} {flags}: {float(err_lib.max())} off the plain version")
    backend, lib_kernel = sdpa_backend(call)
    return {
        "matches_plain": bool(got.shape == want.shape
                              and (err <= 2e-2 + 2e-2 * want.float().abs()).all()),
        "max_abs_err": float(err.max()),
        "ms": median_ms(kernel),
        "back_to_back_ms": back_to_back_ms(kernel),
        "device_ms": kernel_device_ms(kernel, "flash_tc_kernel")[0],
        "plain_ms": median_ms(lambda: attention_ref(q, k, v, **flags)),
        "bound_ms": ms_bound,
        "bound_by": by,
        "library_ms": median_ms(call),
        "library_back_to_back_ms": back_to_back_ms(call),
        "library_backend": backend,
        "library_kernel": lib_kernel,
        "library_choice": choice,
        "library_max_abs_err": float(err_lib.max()),
    }


def numbers_flash(device):
    """Flash at the serving prefills (main() adds each one's launches in a
    server run): recurrentgemma-2b's ([1, 10, 512, 256] over one kv head, window
    2048), granite-moe-3b-a800m's ([1, 24, 512, 64], GQA 24/8, causal) and
    deepseek-v2's MLA (q, k [1, 128, 512, 192], v [1, 128, 512, 128],
    causal), h2o-danube-3-4b's ([1, 32, 512, 120] over 8 kv heads,
    window 4096, causal at 512), paligemma-3b's ([1, 8, 320, 256] over
    one kv head, causal with a 256-key bidirectional prefix), gemma2-27b's
    ([1, 32, 512, 128] over 16 kv heads, attention softcap 50, beside
    ``flex_attention`` with that softcap) and mistral-large-123b's ([1, 96,
    512, 128] over 8 kv heads, causal), the others beside SDPA."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    cases = {
        "": ((1, 10, 1, 512, 256, 256), {"window": 2048}, sdpa(MASKED),
             "q [1, 10, 512, 256], k, v [1, 1, 512, 256] bf16, causal, window 2048"),
        "granite_": ((1, 24, 8, 512, 64, 64), {}, sdpa(CAUSAL),
                     "q [1, 24, 512, 64], k, v [1, 8, 512, 64] bf16, causal"),
        "mla_": ((1, 128, 128, 512, 192, 128), {}, sdpa(CAUSAL),
                 "q, k [1, 128, 512, 192], v [1, 128, 512, 128] bf16, causal"),
        "danube_": ((1, 32, 8, 512, 120, 120), {"window": 4096}, sdpa(CAUSAL),
                    "q [1, 32, 512, 120], k, v [1, 8, 512, 120] bf16, causal (window 4096)"),
        "paligemma_": ((1, 8, 1, 320, 256, 256), {"prefix_len": 256}, sdpa(MASKED),
                       "q [1, 8, 320, 256], k, v [1, 1, 320, 256] bf16, causal, prefix_len 256"),
        "gemma2_": ((1, 32, 16, 512, 128, 128), {"softcap": 50.0}, flex_softcap(50.0),
                    "q [1, 32, 512, 128], k, v [1, 16, 512, 128] bf16, causal, softcap 50"),
        "mistral_": ((1, 96, 8, 512, 128, 128), {}, sdpa(CAUSAL),
                     "q [1, 96, 512, 128], k, v [1, 8, 512, 128] bf16, causal"),
    }
    out = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:37", "launches": None}
    for prefix, (shape, flags, library, label) in cases.items():
        case = flash_case(device, gen, shape, flags, library)
        if prefix:
            out.update({prefix + key: val for key, val in case.items()})
        else:
            out.update(case)
        out[prefix + "shape"] = label
        log(f"flash {label}: {case} [{torch.cuda.get_device_name(0)}]")
    out["matches_plain"] = all(out[p + "matches_plain"] for p in cases)
    return out


def flash_bwd_case(device, gen, shape, flags, library=sdpa(CAUSAL)):
    """Flash's backward at one training shape ``(b, h, hkv, s, d[, dv])``
    bf16, causal: the error against the plain version, its bound (the
    bytes: q, k, v, o, dO and lse read once, dq, dk, dv written once; the
    operations: the five products over the visible pairs, S, dQ and dK
    over D, dP and dV over Dv), single launches, 20 back to back, device
    time per call and per
    kernel (profiler), the plain version's time, and the backward of the
    library call (``library``, as in ``flash_case``) on the same inputs
    through autograd, its gradients held to the plain version's as
    flash's are, with the backend it took and the one it names."""
    import torch
    from repro_torch.kernels._nvcc import resources
    from repro_torch.kernels.ref import attention_bwd_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    b, h, hkv, s, d = shape[:5]
    dv = shape[5] if len(shape) > 5 else d
    q = torch.randn(b, h, s, d, generator=gen, device=device).to(torch.bfloat16)
    do = torch.randn(b, h, s, dv, generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn(b, hkv, s, d, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(b, hkv, s, dv, generator=gen, device=device).to(torch.bfloat16)
    out, lse = fa.flash_attention_lse(q, k, v, **flags)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
    want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
    torch.cuda.synchronize()
    errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
    scales = [float(w.abs().max()) for w in want]
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(s, device=device)[None, :]
    mask = cols <= rows
    if flags.get("window") is not None:
        mask &= cols > rows - flags["window"]
    if flags.get("prefix_len"):
        mask |= cols < flags["prefix_len"]
    seen = int(mask.sum())  # (row, key) pairs a head sees
    # q, dq, k, dk at D; v, dv, o, dO at Dv; lse in float32
    n_bytes = 2 * 2 * (q.numel() + k.numel() + v.numel() + do.numel()) + 4 * lse.numel()
    ms_bound, by = bound(n_bytes, 2 * (3 * d + 2 * dv) * b * h * seen, BF16_FLOP_PER_S)
    call = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)  # noqa: E731
    path = fa.backward_path(q, k, v, out, do)
    plan = fa.backward_plan(b, h, hkv, s, s, d, causal=True, window=flags.get("window"),
                            prefix_len=flags.get("prefix_len", 0),
                            n_sm=torch.cuda.get_device_properties(device).multi_processor_count,
                            dv=dv)
    # Device time: each pass's kernel's mean over the launches the trace
    # holds (a trace can lose some, see phase_busy), summed over the passes
    # the path launches (the reduction only where the plan splits a key tile).
    prof, _ = profiled(lambda: [call() for _ in range(TIMED_RUNS)])
    per_kernel = {a.key[:60]: (a.self_device_time_total / 1e3 / a.count, a.count)
                  for a in prof.key_averages() if "flash_bwd" in a.key}
    passes = {}
    for label, part in (("prologue", "flash_bwd_dot"), ("dkdv", "flash_bwd_dkdv"),
                        ("reduce", "flash_bwd_reduce"), ("dq", "flash_bwd_dq")):
        hits = [(ms, n) for key, (ms, n) in per_kernel.items() if part in key]
        passes[label] = (sum(ms * n for ms, n in hits) / sum(n for _, n in hits)) if hits else None
    expected = ["prologue", "dkdv", "dq"] + (["reduce"] if path == "wgmma" and plan.red else [])
    device_ms = (sum(passes[p] for p in expected) if all(passes[p] is not None for p in expected)
                 else None)
    lib_path, _ = fa.build_backward_wgmma()
    width, width_v = fa._wgmma_widths(d, dv)
    ptxas = [line for line in resources(lib_path)
             if f"__nv_bfloat16, (int){width}, (int){width_v}>" in line
             or "dot16_kernel<__nv_bfloat16>" in line]
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    forward, choice = library(qs, ks, vs, mask)
    o_lib = forward()
    lib_bwd = lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,  # noqa: E731
                                          retain_graph=True)
    lib_errs = [float((g.float() - w).abs().max()) for g, w in zip(lib_bwd(), want)]
    check(all(e <= FLASH_BWD_TOL["bfloat16"] * sc for e, sc in zip(lib_errs, scales)),
          f"{choice}'s backward at {shape} {flags}: {lib_errs} off the plain version "
          f"(scales {scales})")
    backend, lib_kernel = sdpa_backend(lib_bwd)
    return {
        "matches_plain": all(e <= FLASH_BWD_TOL["bfloat16"] * sc for e, sc in zip(errs, scales)),
        "max_abs_err": max(errs),
        "ms": median_ms(call),
        "plain_ms": median_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do, **flags)),
        "bound_ms": ms_bound,
        "bound_by": by,
        "library_ms": median_ms(lib_bwd),
        "back_to_back_ms": back_to_back_ms(call),
        "device_ms": device_ms,
        "device_ms_prologue": passes["prologue"],
        "device_ms_dkdv": passes["dkdv"],
        "device_ms_reduce": passes["reduce"],
        "device_ms_dq": passes["dq"],
        "device_ms_by_kernel": {key: ms for key, (ms, _) in per_kernel.items()},
        "device_kernels_recorded": sum(n for _, n in per_kernel.values()),
        "path": path,
        # the key-tile pass's units (a block each, or walked by a persistent
        # grid of dkdv_grid blocks at MLA's widths) and the dQ pass's
        "persistent": fa.backward_persistent(d, dv),
        "dkdv_blocks": len(plan.blocks) if path == "wgmma" else None,
        "dkdv_grid": plan.grid if path == "wgmma" else None,
        "split_key_tiles": len(plan.red) if path == "wgmma" else None,
        "workspace_slots": plan.n_slots if path == "wgmma" else None,
        "dq_blocks": plan.dq_blocks if path == "wgmma" else None,
        "dq_grid": plan.dq_grid if path == "wgmma" else None,
        "ptxas": ptxas,
        "library_back_to_back_ms": back_to_back_ms(lib_bwd),
        "library_backend": backend,
        "library_kernel": lib_kernel,
        # the backend SDPA's dispatcher picks for these inputs, without a trace
        "library_choice": choice,
        "library_max_abs_err": max(lib_errs),
    }


def numbers_flash_bwd(device):
    """Flash's backward at minicpm-2b's training shape ([4, 36, 512, 64]
    bf16, causal), as its ``d256_`` keys at recurrentgemma-2b's ([4, 10,
    512, 256] over one kv head, window 2048: causal at 512), as its
    ``mla_`` keys at deepseek-v2's MLA ([4, 128, 512, 192], v [4, 128, 512,
    128], causal), as its ``danube_`` keys at h2o-danube-3-4b's ([4, 32,
    512, 120] over 8 kv heads, window 4096: causal at 512), as its
    ``paligemma_`` keys at paligemma-3b's ([4, 8, 512, 256] over one kv
    head, prefix 256; SDPA takes it only as an explicit mask) and as its
    ``gemma2_`` keys at gemma2-27b's ([4, 32, 512, 128] over 16 kv heads,
    softcap 50; beside ``flex_attention``), each through ``flash_bwd_case``; also the
    forward at minicpm's shape with and without its lse output (the
    serving call must not be slower)."""
    import torch

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    case = flash_bwd_case(device, gen, (TRAIN_BATCH, 36, 36, TRAIN_SEQ, 64), {})
    wide = flash_bwd_case(device, gen, (TRAIN_BATCH, 10, 1, TRAIN_SEQ, 256), {"window": 2048})
    mla = flash_bwd_case(device, gen, (TRAIN_BATCH, 128, 128, TRAIN_SEQ, 192, 128), {})
    more = {
        "danube_": (flash_bwd_case(device, gen, (TRAIN_BATCH, 32, 8, TRAIN_SEQ, 120),
                                   {"window": 4096}),
                    "q, o, dO [4, 32, 512, 120], k, v [4, 8, 512, 120] bf16, causal, window "
                    "4096 (h2o-danube-3-4b's training step)"),
        "paligemma_": (flash_bwd_case(device, gen, (TRAIN_BATCH, 8, 1, TRAIN_SEQ, 256),
                                      {"prefix_len": 256}, sdpa(MASKED)),
                       "q, o, dO [4, 8, 512, 256], k, v [4, 1, 512, 256] bf16, causal, "
                       "prefix_len 256 (paligemma-3b's training step)"),
        "gemma2_": (flash_bwd_case(device, gen, (TRAIN_BATCH, 32, 16, TRAIN_SEQ, 128),
                                   {"softcap": 50.0}, flex_softcap(50.0)),
                    "q, o, dO [4, 32, 512, 128], k, v [4, 16, 512, 128] bf16, causal, softcap "
                    "50 (gemma2-27b's training step)"),
    }
    q = torch.randn(TRAIN_BATCH, 36, TRAIN_SEQ, 64, generator=gen,
                    device=device).to(torch.bfloat16)
    # single calls, host-bound at this size: five rounds in turns, so that a
    # stretch of host noise falls on both
    rounds = {"plain": [], "lse": []}
    for rnd in range(5):
        for name in (("plain", "lse") if rnd % 2 == 0 else ("lse", "plain")):
            fn = fa.flash_attention if name == "plain" else fa.flash_attention_lse
            rounds[name].append(median_ms(lambda: fn(q, q, q)))
    fwd_ms, fwd_lse_ms = (statistics.median(rounds[k]) for k in ("plain", "lse"))
    check(fwd_ms <= 1.25 * fwd_lse_ms, f"flash forward without lse {fwd_ms} ms, slower than "
                                       f"with it ({fwd_lse_ms} ms; rounds {rounds})")
    out_dict = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        "fma_f32_source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "replaces_note": "the Pallas kernel has no backward: the reference trains through "
                         "XLA's derivative of ref.attention_ref",
        "launches": None,
        **case,
        "matches_plain": all(c["matches_plain"]
                             for c in (case, wide, mla, *(c for c, _ in more.values()))),
        "forward_ms": fwd_ms,
        "forward_with_lse_ms": fwd_lse_ms,
        "shape": "q, k, v, o, dO [4, 36, 512, 64] bf16, causal (minicpm-2b's training step)",
        **{f"d256_{key}": val for key, val in wide.items()},
        "d256_shape": "q, o, dO [4, 10, 512, 256], k, v [4, 1, 512, 256] bf16, causal, window "
                      "2048 (recurrentgemma-2b's training step)",
        **{f"mla_{key}": val for key, val in mla.items()},
        "mla_shape": "q, k [4, 128, 512, 192], v, o, dO [4, 128, 512, 128] bf16, causal "
                     "(deepseek-v2's MLA training step)",
    }
    for prefix, (c, label) in more.items():
        out_dict.update({f"{prefix}{key}": val for key, val in c.items()})
        out_dict[f"{prefix}shape"] = label
    log(f"flash backward: {out_dict} [{torch.cuda.get_device_name(0)}]")
    return out_dict


def call_device_ms(fn, names, runs=TIMED_RUNS):
    """Device time per call of ``fn``, which launches one kernel of each
    of ``names`` a call: the sum over ``names`` of each kernel's mean over
    the launches the profiler recorded in ``runs`` calls (a trace can lose
    some, see ``phase_busy``; each call's output is freed before the next
    call). Returns (ms, or None when a name has no recorded launch; the
    launches recorded)."""

    def calls():
        for _ in range(runs):
            fn()
    prof, _ = profiled(calls)
    total_ms, recorded = 0.0, 0
    for name in names:
        hits = [a for a in prof.key_averages() if name in a.key]
        count = sum(a.count for a in hits)
        if not count:
            return None, recorded
        total_ms += sum(a.self_device_time_total for a in hits) / 1e3 / count
        recorded += count
    return total_ms, recorded


# Granite-moe-3b-a800m's training step (tp_size 1): 40 experts, capacity
# C 512 rows an expert (4 x 512 tokens, top-8), x [20480, 1536]; the gate
# and up products' w [40, 1536, 512], the down product's [40, 512, 1536].
GMM_TRAIN = {"": (40, 1536, 512, 512), "down_": (40, 512, 1536, 512),
             # deepseek-v2's experts: 160 of [5120, 1536], top-6 of 2,048 tokens, C 96
             "deepseek_": (160, 5120, 1536, 96), "deepseek_down_": (160, 1536, 5120, 96)}


def dx_call(gm, dy, w, tiles, cap, width):
    """A launch of the dx entry on the wgmma path at one tile width (the
    plan's rule over that width alone), writing into a buffer of its own.
    Returns (the call, its output, the plan)."""
    import torch

    m, n = dy.shape
    g, k, _ = w.shape
    plan = gm.dx_plan(m, k, cap, torch.cuda.get_device_properties(
        dy.device).multi_processor_count, widths=(width,))
    out = torch.empty(m, k, dtype=dy.dtype, device=dy.device)
    entry = gm._LIB.get().acs_grouped_matmul_dx

    def call():
        rc = entry(dy.data_ptr(), w.data_ptr(), tiles.data_ptr(), out.data_ptr(), None, m, k, n,
                   g, cap, 1 if dy.dtype == torch.bfloat16 else 2, plan.grid, plan.width,
                   torch.cuda.current_stream(dy.device).cuda_stream)
        check(rc == 0, f"grouped_matmul dx at width {width}: CUDA error {rc}")
    return call, out, plan


def numbers_gmm_bwd(device):
    """The grouped GEMM's dx and dw entries at granite's training shapes
    (GMM_TRAIN), bf16: errors against ``grouped_matmul_bwd_ref``, single
    launches, 20 back to back, device time (profiler; the float32 path's
    tile-table kernel timed alone beside dw's), the plain version's time,
    the bound (dy and w read, dx written; x and dy read, dw written; 2 M K
    N operations each) and ``torch.bmm`` on the capacity layout as the
    library call (``dy @ w^T`` and ``x^T @ dy``, the transposes as strided
    views). dx must take its ``"wgmma"`` path; its plan (grid, tile width)
    is logged, and each tile width's device time and back-to-back time
    beside it. The forward at the same shapes (``x @ w``, the 192
    launches of a granite step) is timed too: device time, single, back to
    back, ``torch.bmm(x, w)`` and the bound. Returns the dx and the dw
    rows and the forward's training-shape numbers."""
    import torch
    from repro_torch.kernels._nvcc import resources
    from repro_torch.kernels.ref import grouped_matmul_bwd_ref, grouped_matmul_ref

    gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    err_flag = torch.zeros(1, dtype=torch.int32, device=device)
    rows = {"dx": {}, "dw": {}}
    forward = {}
    for prefix, (g, k, n, cap) in GMM_TRAIN.items():
        tiles = torch.arange(g, dtype=torch.int32, device=device)
        x = torch.randn(g * cap, k, generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn(g, k, n, generator=gen, device=device).to(torch.bfloat16)
        dy = torch.randn(g * cap, n, generator=gen, device=device).to(torch.bfloat16)
        before = dict(gm.dx_paths)
        got = gm.grouped_matmul_bwd(x, w, tiles, dy, block_m=cap)
        want = grouped_matmul_bwd_ref(x, w, tiles, dy, block_m=cap)
        torch.cuda.synchronize()
        dx_paths = {key: gm.dx_paths[key] - before[key] for key in before}
        check(dx_paths == {"wgmma": 1, "wgmma_padded": 0, "fma_f32": 0},
              f"dx at granite's {prefix or 'gate/up '}shape took {dx_paths}")
        x3, dy3 = x.view(g, cap, k), dy.view(g, cap, n)
        calls = {
            "dx": (lambda: gm.grouped_matmul_bwd(x, w, tiles, dy, block_m=cap, need_dw=False),
                   lambda: torch.bmm(dy3, w.transpose(1, 2)), ("gmm_dx_wgmma_kernel",),
                   2 * (dy.numel() + w.numel() + x.numel())),
            "dw": (lambda: gm.grouped_matmul_bwd(x, w, tiles, dy, block_m=cap, need_dx=False),
                   lambda: torch.bmm(x3.transpose(1, 2), dy3),
                   ("gmm_dw_wgmma_kernel",),  # finds the groups' tiles itself
                   2 * (x.numel() + dy.numel() + w.numel())),
        }
        plain_ms = median_ms(lambda: grouped_matmul_bwd_ref(x, w, tiles, dy, block_m=cap))
        for i, (which, (call, library, names, n_bytes)) in enumerate(calls.items()):
            err = float((got[i].float() - want[i].float()).abs().max())
            scale = float(want[i].float().abs().max())
            ms_bound, by = bound(n_bytes, 2 * g * cap * k * n, BF16_FLOP_PER_S)
            case = {
                "matches_plain": err <= GMM_BWD_TOL["bfloat16"] * scale,
                "max_abs_err": err,
                "ms": median_ms(call),
                "back_to_back_ms": back_to_back_ms(call),
                "device_ms": call_device_ms(call, names)[0],
                "plain_ms": plain_ms,  # the plain version computes dx and dw together
                "bound_ms": ms_bound,
                "bound_by": by,
                "library_ms": median_ms(library),
                "library_back_to_back_ms": back_to_back_ms(library),
            }
            if which == "dx":
                plan = gm.dx_plan(g * cap, k, cap, n_sm)
                # What TMA copies into shared memory: each tile's steps of
                # N, two 64-row dy boxes (C 512: every chunk is whole) and
                # the width's rows of w a step. All of it comes from L2.
                smem_bytes = plan.tiles * -(-n // gm.DX_STEP_N) * 2 * (2 * 64 + plan.width) * 64
                case.update(path=gm.dx_path(dy, w, got[0]), grid=plan.grid, width=plan.width,
                            tiles=plan.tiles, tma_load_bytes=smem_bytes,
                            tma_load_tb_per_s=(smem_bytes / case["device_ms"] / 1e9
                                               if case["device_ms"] else None))
                for width in gm.DX_TILE_WIDTHS:  # each width the plan could pick
                    fixed, out, fixed_plan = dx_call(gm, dy, w, tiles, cap, width)
                    fixed()
                    torch.cuda.synchronize()
                    width_err = float((out.float() - want[0].float()).abs().max())
                    check(width_err <= GMM_BWD_TOL["bfloat16"] * scale,
                          f"dx at width {width}, {prefix or 'gate/up'}: max abs err {width_err}")
                    case[f"width_{width}"] = {
                        "tiles": fixed_plan.tiles, "grid": fixed_plan.grid,
                        "device_ms": call_device_ms(fixed, names)[0],
                        "back_to_back_ms": back_to_back_ms(fixed), "max_abs_err": width_err}
            if which == "dw":
                case["path"] = gm.dw_path(x, dy, got[1])
                check(case["path"] == "wgmma", f"dw at granite's shape took {case['path']}")
                case["grid"] = gm.dw_grid(g, k, n, n_sm)
                # The float32 path's tile-table launch alone, on the same
                # values in float32 (the 16-bit kernel needs no table).
                x32, w32, dy32 = x.float(), w.float(), dy.float()
                case["table_device_ms"] = call_device_ms(
                    lambda: gm.grouped_matmul_bwd(x32, w32, tiles, dy32, block_m=cap,
                                                  need_dx=False), ("gmm_tile_table_kernel",))[0]
            rows[which].update({prefix + key: val for key, val in case.items()})
            log(f"grouped_matmul {which} {prefix or 'gate/up '}w [{g}, {k}, {n}] block_m {cap}: "
                f"{case} [{torch.cuda.get_device_name(0)}]")
        # The forward x @ w at the same shape, as the train step calls it.
        fwd = lambda: gm.grouped_matmul(x, w, tiles, block_m=cap, err=err_flag)  # noqa: E731
        out = fwd()
        ref = grouped_matmul_ref(x, w, tiles, block_m=cap)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        ms_bound, by = bound(2 * (x.numel() + w.numel() + out.numel()), 2 * g * cap * k * n,
                             BF16_FLOP_PER_S)
        case = {
            "matches_plain": bool((diff <= GMM_TOL["bfloat16"] * (1 + ref.float().abs())).all())
                             and int(err_flag[0]) == 0,
            "max_abs_err": float(diff.max()),
            "ms": median_ms(fwd),
            "back_to_back_ms": back_to_back_ms(fwd),
            "device_ms": call_device_ms(fwd, ("gmm_tc_kernel",))[0],
            "bound_ms": ms_bound,
            "bound_by": by,
            "library_ms": median_ms(lambda: torch.bmm(x3, w)),
            "library_back_to_back_ms": back_to_back_ms(lambda: torch.bmm(x3, w)),
        }
        forward.update({f"train_{prefix}{key}": val for key, val in case.items()})
        log(f"grouped_matmul forward {prefix or 'gate/up '}w [{g}, {k}, {n}] block_m {cap}: "
            f"{case} [{torch.cuda.get_device_name(0)}]")
    shape = ("x [20480, 1536], dy [20480, 512], w [40, 1536, 512] bf16 (gate/up; down_: "
             "x [20480, 512], dy [20480, 1536], w [40, 512, 1536]), block_m 512, tile ids "
             "arange(40): granite-moe-3b-a800m's training step; deepseek_: x [15360, 5120], "
             "w [160, 5120, 1536] (deepseek_down_: [160, 1536, 5120]), block_m 96: "
             "deepseek-v2's experts at 2,048 tokens")
    forward["train_shape"] = shape
    lib_path, _ = gm.build()
    ptxas = resources(lib_path)
    rows["dx"]["ptxas"] = [line for line in ptxas if "gmm_dx_wgmma_kernel<__nv_bfloat16" in line]
    rows["dw"]["ptxas"] = [line for line in ptxas
                           if "gmm_dw_wgmma_kernel<__nv_bfloat16>" in line
                           or "gmm_tile_table_kernel" in line]
    out = []
    for which, label in (("dx", "dy @ w[g]^T on wgmma, dy and w[g] both K-major in place"),
                         ("dw", "sum over a group's tiles of x^T @ dy, in tile order")):
        row = rows[which]
        out.append({
            "name": f"grouped_matmul_{which}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:29",
            "replaces_note": "the Pallas kernel has no backward: the reference trains through "
                             "XLA's derivative of ref.grouped_matmul_ref",
            "computes": label,
            "launches": None,  # main() adds granite's training steps'
            **row,
            "matches_plain": all(row[f"{p}matches_plain"] for p in GMM_TRAIN),
            "shape": shape,
        })
    check(all(forward[f"train_{p}matches_plain"] for p in GMM_TRAIN),
          "grouped_matmul forward != plain at the training shapes")
    return (*out, forward)


def numbers_lru_bwd(device):
    """The reverse scan at recurrentgemma-2b's training shape ([4, 512,
    2560] f32, h0 zeros with no gradient, as the train step calls it):
    bit-equal to ``lru_scan_bwd_ref``, single launches, 20 back to back,
    device time, the plain version's time and the bound (a, h, dh read, da
    and db written; three float operations an element). No single PyTorch
    call computes a reverse linear recurrence."""
    import torch
    from repro_torch.kernels.ref import lru_scan_bwd_ref

    ls = importlib.import_module("repro_torch.kernels.lru_scan")
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    shape = (TRAIN_BATCH, TRAIN_SEQ, 2560)
    a = torch.rand(*shape, generator=gen, device=device)
    x, dh = (torch.randn(*shape, generator=gen, device=device) for _ in range(2))
    h0 = torch.zeros(shape[0], shape[2], device=device)
    h = ls.lru_scan(a, x, h0)
    got = ls.lru_scan_bwd(a, h, h0, dh, need_dh0=False)
    want = lru_scan_bwd_ref(a, h, h0, dh)
    torch.cuda.synchronize()
    call = lambda: ls.lru_scan_bwd(a, h, h0, dh, need_dh0=False)  # noqa: E731
    ms_bound, by = bound(5 * a.numel() * 4 + h0.numel() * 4, 3 * a.numel(), FP32_FLOP_PER_S)
    out = {
        "name": "lru_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:27",
        "replaces_note": "the Pallas kernel has no backward: the reference trains through "
                         "XLA's derivative of ref.lru_scan_ref",
        "launches": None,  # main() adds recurrentgemma's training steps'
        "matches_plain": all(torch.equal(_int_bits(g), _int_bits(w))
                             for g, w in zip(got[:2], want[:2])),
        "max_abs_err": max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2])),
        "ms": median_ms(call),
        "plain_ms": median_ms(lambda: lru_scan_bwd_ref(a, h, h0, dh)),
        "bound_ms": ms_bound,
        "bound_by": by,
        "library_ms": None,
        "back_to_back_ms": back_to_back_ms(call),
        "device_ms": call_device_ms(call, ("lru_scan_bwd_kernel",))[0],
        "shape": "a, h, dh [4, 512, 2560] f32, h0 [4, 2560] zeros (no dh0): recurrentgemma-2b's "
                 "training step",
    }
    log(f"lru_scan reverse: {out} [{torch.cuda.get_device_name(0)}]")
    return out


def numbers_scan_bwd(device):
    """The selective scan's backward at falcon-mamba-7b's training shape
    ([4, 512, 8192], N 16, bf16, through the fused entry as the train step
    calls it: z, b and c strided, h0 zeros, no hT gradient) against
    ``mamba_scan_bwd_ref`` (SCAN_BWD_TOL): single launches, 20 back to
    back, device time (the kernel and its reduction), the plain version's
    time and the bound: the bytes (dt_raw, x, z and dy read and d dt_raw,
    dx and dz written, b and c read and db and dc written, all bf16; the
    chunk states and h0 read and dh0 written in float32; the float32
    parameters and their gradients) against the exponentials (one a state
    and step in the chunk's recompute: 268 M on the SFUs). No PyTorch call
    computes it. What binds it is instruction issue: the state loop's SASS
    instructions a state and step (``sass_per_step``) over the card's
    issue rate (4 warp instructions a clock on each of its SMs, at 1.98
    GHz) give ``issue_bound_ms``, a floor under the state loop alone."""
    import torch
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels._nvcc import resources
    from repro_torch.kernels.ref import mamba_scan_bwd_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    b, s, e, n = TRAIN_BATCH, TRAIN_SEQ, 8192, 16
    args = list(fused_inputs(gen, b, s, e, n, torch.bfloat16, device))
    args[8] = torch.zeros(b, e, n, device=device)
    _, _, states = ss.mamba_scan_fwd(*args)
    dy = torch.randn(b, s, e, generator=gen, device=device).to(torch.bfloat16)
    got = ss.mamba_scan_bwd(*args, states, dy, None)
    want = mamba_scan_bwd_ref(*args, dy, None)
    torch.cuda.synchronize()
    ok, rel = scan_bwd_errors(got, want,
                              lambda g: SCAN_BWD_TOL[str(g.dtype).replace("torch.", "")])
    call = lambda: ss.mamba_scan_bwd(*args, states, dy, None)  # noqa: E731
    n_bytes = (2 * (7 * b * s * e + 4 * b * s * n) + 4 * (states.numel() + 2 * b * e * n)
               + 4 * 2 * (2 * e + e * n))
    n_exp = b * s * e * n
    ms_bound, by = bound(n_bytes, n_exp, SFU_EXP_PER_S)
    lib = ss.build()[0]
    sass = ss.sass_per_step(lib, "mamba_scan_bwd_kernelI13__nv_bfloat16Lb1E")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    issue_ms = (sass["instructions_a_state_and_step"] * n_exp / 32 / (4 * n_sm * 1.98e9)
                * 1e3)
    device_ms = call_device_ms(call, ("mamba_scan_bwd_kernel", "mamba_scan_bwd_reduce_kernel"))[0]
    out = {
        "name": "mamba_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/models/recurrent.py:151 (lax.scan; no pallas_call)",
        "replaces_note": "the reference trains through XLA's derivative of its lax.scan",
        "launches": None,  # main() adds falcon-mamba-7b's training steps'
        "matches_plain": ok,
        "max_abs_err": max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)),
        "max_err_over_largest": dict(zip(("dt_raw", "dt_bias", "x", "z", "b", "c", "A_log", "D",
                                          "h0"), rel)),
        "ms": median_ms(call),
        "plain_ms": median_ms(lambda: mamba_scan_bwd_ref(*args, dy, None), runs=3, warmup=1),
        "bound_ms": ms_bound,
        "bound_by": by,
        "bytes_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "exp_bound_ms": n_exp / SFU_EXP_PER_S * 1e3,
        "library_ms": None,  # no PyTorch call computes a selective scan's backward
        "back_to_back_ms": back_to_back_ms(call),
        "device_ms": device_ms,
        "device_ms_reduce": call_device_ms(call, ("mamba_scan_bwd_reduce_kernel",))[0],
        "sass_a_state_and_step": sass["instructions_a_state_and_step"],
        "issue_bound_ms": issue_ms,
        "issue_share": issue_ms / device_ms if device_ms else None,
        "forward_with_states_ms": median_ms(lambda: ss.mamba_scan_fwd(*args)),
        "forward_ms": median_ms(lambda: ss.mamba_scan(*args)),
        "states_mb": states.numel() * 4 / 1e6,
        "ptxas": [line for line in resources(lib) if "mamba_scan_bwd" in line],
        "shape": "dt_raw, x, z, dy [4, 512, 8192] bf16, b, c [4, 512, 16] (strided), N 16, h0 "
                 "zeros: falcon-mamba-7b's training step",
    }
    check(ok, f"mamba_scan backward != plain at falcon-mamba-7b's training shape: {rel}")
    log(f"mamba_scan backward: {out} [{torch.cuda.get_device_name(0)}]")
    return out


def numbers_gmm(device):
    """The grouped GEMM at granite-moe's gate/up product (48 experts of
    [1536, 512] bf16): decode (C = 1, M = 48) and a 512-token prefill
    (C = 128, M = 6144), and at deepseek-v2's (160 experts of [5120, 1536]):
    decode (C = 1) and a 512-token prefill (C = 24); ``torch.bmm`` over the
    same capacity layout is the library call."""
    import torch
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ref import grouped_matmul_ref

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    out, weights = {}, {}
    for label, (g, k, n), cap in (("decode", (48, 1536, 512), 1),
                                  ("prefill", (48, 1536, 512), 128),
                                  ("deepseek_decode", (160, 5120, 1536), 1),
                                  ("deepseek_prefill", (160, 5120, 1536), 24)):
        if (g, k, n) not in weights:
            weights[(g, k, n)] = torch.randn(g, k, n, generator=gen,
                                             device=device).to(torch.bfloat16)
        w = weights[(g, k, n)]
        tiles = torch.arange(g, dtype=torch.int32, device=device)
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
        log(f"grouped_matmul {label} w [{g}, {k}, {n}] block_m {cap}: {out[label]} "
            f"[{torch.cuda.get_device_name(0)}]")
    dec, pre = out["decode"], out["prefill"]
    ds_dec, ds_pre = out["deepseek_decode"], out["deepseek_prefill"]
    return {
        "name": "grouped_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:61",
        "launches": None,  # main() adds granite's and deepseek's server runs
        "matches_plain": all(case["ok"] for case in out.values()),
        "max_abs_err": max(case["max_abs_err"] for case in out.values()),
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
        "shape": "w [48, 1536, 512] bf16, tile ids arange(48); decode x [48, 1536] "
                 "(block_m 1); prefill x [6144, 1536] (block_m 128)",
        **{f"deepseek_{which}_{key}": case[key]
           for which, case in (("decode", ds_dec), ("prefill", ds_pre))
           for key in ("ms", "b2b_ms", "plain_ms", "library_ms", "library_b2b_ms", "bound_ms",
                       "bound_by")},
        "deepseek_shape": "w [160, 5120, 1536] bf16 (one of a layer's three products); "
                          "decode x [160, 5120] (block_m 1); prefill x [3840, 5120] "
                          "(block_m 24)",
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


# The optimizer's numbers: the train cells' archs, the clip, the learning
# rate and the step whose bias corrections the update takes.
ADAMW_ARCHS = ("minicpm-2b", "granite-moe-3b-a800m")
ADAMW_CLIP, ADAMW_LR, ADAMW_STEP = 1.0, 1.6e-4, 10


def adamw_leaf(shape, dtype, seed, device):
    """One leaf's parameter, gradient, float32 master, m and v, drawn from
    its own ``seed``: the same tensors every time."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    master = 0.02 * torch.randn(shape, generator=gen, device=device)
    g = (1e-3 * torch.randn(shape, generator=gen, device=device)).to(dtype)
    m = 1e-4 * torch.randn(shape, generator=gen, device=device)
    v = 1e-7 * torch.rand(shape, generator=gen, device=device)
    return master.to(dtype), g, master, m, v


def adamw_device_ms(fn, runs=5):
    """Per call of ``fn``: the device ms of the optimizer's three kernels,
    and of every device operation of the call (kernels and copies, each
    counted once)."""
    from torch.autograd import DeviceType

    prof, _ = profiled(lambda: [fn() for _ in range(runs)])
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mine = ("norm_partials_kernel", "norm_finish_kernel", "adamw_update_kernel")
    kernels = sum(e.time_range.elapsed_us() for e in events if any(k in e.name for k in mine))
    return kernels / 1e3 / runs, sum(e.time_range.elapsed_us() for e in events) / 1e3 / runs


def adamw_numbers_at(arch, device):
    """The optimizer's kernels at one arch's whole leaf set: one clip and
    update through ``optim``'s wrappers as the train step calls them, each
    leaf then drawn again from its seed and run through the plain version
    at the kernels' scale (bit-equal: parameter, master, m and v), the norm
    against ``global_norm_ref``'s (within 1e-6), the launches and the paths
    of that step; then the times of the fused pair, of the plain version
    (the per-leaf norm, the float32 copy of every gradient, the per-leaf
    update) and of ``torch.optim.AdamW(fused=True)`` on float32 copies."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import adamw as aw
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_update, clip_by_global_norm
    from repro_torch.tree import tree_leaves

    free_device_memory()
    shapes = [(tuple(t.shape), t.dtype) for t in
              tree_leaves(init_params(ARCHS[arch], device="meta", tp_size=1).param_tree())]
    seeds = [34_000 + i for i in range(len(shapes))]
    leaves = [adamw_leaf(shape, dtype, seed, device) for (shape, dtype), seed
              in zip(shapes, seeds)]
    params, grads, master, m, v = (list(x) for x in zip(*leaves))
    del leaves
    state = {"step": torch.full((), ADAMW_STEP - 1, dtype=torch.int32, device=device),
             "master": master, "m": m, "v": v}
    n_params = sum(p.numel() for p in params)
    least = sum(p.numel() * (3 * p.element_size() + 24) for p in params)  # g twice, p once
    want_norm, _ = aw.global_norm_ref(grads, ADAMW_CLIP)
    aw.reset_launches()
    clipped, gnorm = clip_by_global_norm(grads, ADAMW_CLIP)
    adamw_update(params, clipped, state, ADAMW_LR)
    counts = (aw.launches, aw.norm_launches, dict(aw.paths))
    step = state["step"].float()
    c1, c2 = 1.0 - torch.pow(0.9, step), 1.0 - torch.pow(0.95, step)
    lr = torch.as_tensor(ADAMW_LR, dtype=torch.float32, device=device)
    same, worst = True, 0.0
    for i, ((shape, dtype), seed) in enumerate(zip(shapes, seeds)):
        p0, _, w0, m0, v0 = adamw_leaf(shape, dtype, seed, device)
        aw.adamw_step_ref([p0], [grads[i]], [w0], [m0], [v0], scale=clipped.scale, c1=c1,
                          c2=c2, lr=lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
        for got, want in ((params[i], p0), (master[i], w0), (m[i], m0), (v[i], v0)):
            as_int = torch.int16 if got.element_size() == 2 else torch.int32
            same = same and got.dtype == want.dtype and torch.equal(got.view(as_int),
                                                                    want.view(as_int))
            worst = max(worst, float((got.float() - want.float()).abs().max()))
        del p0, w0, m0, v0
    norm_rel = abs(float(gnorm) - float(want_norm)) / float(want_norm)

    def fused():
        adamw_update(params, clip_by_global_norm(grads, ADAMW_CLIP)[0], state, lr)

    def plain():
        _, scale = aw.global_norm_ref(grads, ADAMW_CLIP)
        scaled = [g.float() * scale for g in grads]
        state["step"] += 1
        t = state["step"].float()
        aw.adamw_step_ref(params, scaled, master, m, v, scale=None, c1=1.0 - torch.pow(0.9, t),
                          c2=1.0 - torch.pow(0.95, t), lr=lr, b1=0.9, b2=0.95, eps=1e-8,
                          weight_decay=0.1)

    kernels_ms, device_ms = adamw_device_ms(fused)
    out = {"leaves": len(shapes), "params": n_params, "launches_a_step": counts,
           "matches_plain": same and norm_rel <= 1e-6 and counts == (1, 2, {
               "fused": len(shapes), "per_leaf": 0}),
           "max_abs_err": worst, "norm_rel_err": norm_rel,
           "bound_ms": least / HBM_BYTES_PER_S * 1e3, "ms": median_ms(fused),
           "b2b_ms": back_to_back_ms(fused), "device_ms": kernels_ms,
           "device_all_ms": device_ms, "plain_ms": median_ms(plain, runs=5, warmup=1),
           "plain_device_ms": adamw_device_ms(plain, runs=2)[1]}
    del params, grads, master, m, v, state, clipped, fused, plain
    free_device_memory()
    gen = torch.Generator(device=device)
    gen.manual_seed(34)
    wide = [torch.randn(shape, generator=gen, device=device).requires_grad_(True)
            for shape, _ in shapes]
    for t in wide:
        t.grad = 1e-3 * torch.randn(t.shape, generator=gen, device=device)
    opt = torch.optim.AdamW(wide, lr=ADAMW_LR, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                            fused=True)
    out.update(library_ms=median_ms(opt.step), library_b2b_ms=back_to_back_ms(opt.step),
               library_bound_ms=28 * n_params / HBM_BYTES_PER_S * 1e3)
    del wide, opt
    free_device_memory()
    return out


def numbers_adamw(device):
    """The optimizer's clip and AdamW update (``kernels/adamw.py``) at the
    benchmark's two train cells' leaf sets (``adamw_numbers_at``):
    minicpm-2b's numbers, granite's beside them under ``granite_``. The
    bound is the least bytes at the HBM rate: a bf16 parameter's gradient
    read twice, its master, m and v read and written, the parameter written,
    30 B; the library's is float32 AdamW's 28 B a parameter."""
    import torch

    at = {arch: adamw_numbers_at(arch, device) for arch in ADAMW_ARCHS}
    mini, granite = at["minicpm-2b"], at["granite-moe-3b-a800m"]
    for arch, r in at.items():
        log(f"optimizer at {arch}'s {r['leaves']} leaves ({r['params']} parameters): "
            f"bit-equal to the plain version {r['matches_plain']} (max abs err "
            f"{r['max_abs_err']:.3g}, norm rel err {r['norm_rel_err']:.3g}, launches a step "
            f"{r['launches_a_step']}); kernels' device {r['device_ms']:.3f} ms (all device "
            f"{r['device_all_ms']:.3f}), single {r['ms']:.3f}, back to back {r['b2b_ms']:.3f}, "
            f"bound {r['bound_ms']:.3f} ms ({100 * r['bound_ms'] / r['b2b_ms']:.1f} % of it "
            f"back to back); plain {r['plain_ms']:.3f} ms (device {r['plain_device_ms']:.3f}); "
            f"torch.optim.AdamW(fused=True) float32 {r['library_ms']:.3f}, back to back "
            f"{r['library_b2b_ms']:.3f} (its bound {r['library_bound_ms']:.3f}) "
            f"[{torch.cuda.get_device_name(device)}]")
    return {
        "name": "adamw",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw.cu",
        "replaces": "none: the reference's optimizer (src/repro/optim/adamw.py) is plain jnp",
        "launches": None,  # main() adds phase 9's
        "matches_plain": mini["matches_plain"] and granite["matches_plain"],
        "max_abs_err": max(mini["max_abs_err"], granite["max_abs_err"]),
        "ms": mini["ms"],
        "plain_ms": mini["plain_ms"],
        "bound_ms": mini["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mini["library_ms"],
        "b2b_ms": mini["b2b_ms"],
        "device_ms": mini["device_ms"],
        "device_all_ms": mini["device_all_ms"],
        "plain_device_ms": mini["plain_device_ms"],
        "library_b2b_ms": mini["library_b2b_ms"],
        "norm_rel_err": max(mini["norm_rel_err"], granite["norm_rel_err"]),
        **{f"granite_{k}": v for k, v in granite.items() if k not in ("matches_plain",)},
        "shape": f"minicpm-2b's {mini['leaves']} leaves ({mini['params']} bf16 parameters), "
                 f"granite-moe-3b-a800m's {granite['leaves']} ({granite['params']})",
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


def busy_dyn(device, policy):
    """InstaNAS on ``DYN_INPUTS`` inputs through ``policy``, the streams
    built first, ready to run under the profiler."""
    from repro_torch.dyn import WORKLOADS

    params = WORKLOADS["instanas"][0](0, device=device)
    streams = [dyn_stream("instanas", params, seed)[1] for seed in range(DYN_INPUTS)]
    return lambda: [dyn_runner(policy, device)(tasks) for tasks in streams]


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
              for p in ("serial", "wave", "threaded")),
            *((f"instanas {DYN_INPUTS} inputs/{p}", lambda p=p: busy_dyn(device, p), None)
              for p in ("serial", "frontier"))):
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
    timed(phase_scan_vs_plain, device)
    timed(phase_flash_vs_plain, device)
    timed(phase_flash_bwd_vs_plain, device)
    timed(phase_scan_bwd_vs_plain, device)
    timed(phase_gmm_vs_plain, device)
    timed(phase_gmm_bwd_vs_plain, device)
    timed(phase_expert_stream, device)
    launches, hw_walls = timed(phase_acs_hw, device)
    wave_launches, widest, wave_walls = timed(phase_acs_hw_waves, device)
    session_walls = timed(phase_session, device)
    mesh_rq, mesh_we, mesh_walls = timed(phase_mesh, device, card)
    sw_walls = timed(phase_acs_sw, device)
    timed(phase_perfmodel, device, card, {**hw_walls, **wave_walls, **session_walls, **mesh_walls,
                                  **sw_walls})
    timed(phase_dyn, device, card)
    timed(phase_busy, device, card)
    serve_launches, serve_walls = {}, {}
    # The kernels' times before the serving passes, whose profiled passes
    # make later traces lose device events; each serving path's launch
    # counts are filled in after it runs.
    kernels = [timed(phase_numbers, device, launches),
               timed(numbers_wave, device, wave_launches, widest),
               timed(numbers_flash, device),
               timed(numbers_lru, device),
               timed(numbers_gmm, device),
               timed(numbers_scan, device),
               timed(numbers_flash_bwd, device)]
    gmm_dx, gmm_dw, gmm_train = timed(numbers_gmm_bwd, device)
    lru_bwd = timed(numbers_lru_bwd, device)
    scan_bwd = timed(numbers_scan_bwd, device)
    adamw = timed(numbers_adamw, device)
    kernels += [gmm_dx, gmm_dw, lru_bwd, scan_bwd, adamw]
    # The examples' servers after the kernels' numbers, as the other servers.
    timed(phase_examples, device, card)
    torch.cuda.empty_cache()
    # Training before the profiled serving passes, each model freed after.
    train_launches, train_walls = {}, {}
    for arch in TRAIN_ARCHS:
        train_launches[arch], walls = timed(phase_train, device, card, arch)
        train_walls.update(walls)
    timed(phase_trainer, device, card)
    timed(phase_dryrun, device, card)
    for arch in SERVE_ARCHS:
        arch_launches, walls, served = timed(phase_serve, device, card, arch)
        if arch in PROFILED_SERVE:
            timed(busy_serve, device, card, served)
        serve_launches[arch] = arch_launches
        serve_walls.update(walls)
        del served  # free this model's weights before the next one's are drawn
        free_device_memory()
    frontend_launches = {arch: timed(phase_frontend, device, card, arch)
                         for arch in FRONTEND_ARCHS}
    rg, granite, mamba, deepseek, danube, mistral, gemma2 = (serve_launches[a]
                                                             for a in SERVE_ARCHS)
    queue, wave, flash, lru, gmm, scan, flash_bwd = kernels[:7]
    # The mesh phase's shards launched both device-window kernels too.
    queue.update(launches=queue["launches"] + mesh_rq, mesh_launches=mesh_rq)
    wave.update(launches=wave["launches"] + mesh_we, mesh_launches=mesh_we)
    # The configs this script trains beside the three above, by key prefix.
    trained = {"danube_": "h2o-danube-3-4b", "paligemma_": "paligemma-3b",
               "musicgen_": "musicgen-large", "gemma2_": "gemma2-27b",
               "mistral_": "mistral-large-123b"}
    flash.update(launches=rg["flash_attention"], granite_launches=granite["flash_attention"],
                 mla_launches=deepseek["flash_attention"],
                 danube_launches=danube["flash_attention"],
                 mistral_launches=mistral["flash_attention"],
                 gemma2_launches=gemma2["flash_attention"],
                 paligemma_launches=frontend_launches["paligemma-3b"],
                 musicgen_launches=frontend_launches["musicgen-large"],
                 train_launches=train_launches["minicpm-2b"]["flash"],
                 granite_train_launches=train_launches["granite-moe-3b-a800m"]["flash"],
                 d256_train_launches=train_launches["recurrentgemma-2b"]["flash"],
                 mla_train_launches=train_launches["deepseek-v2-236b"]["flash"],
                 **{f"{p}train_launches": train_launches[a]["flash"]
                    for p, a in trained.items()})
    flash_bwd.update(launches=train_launches["minicpm-2b"]["flash_bwd"],
                     granite_launches=train_launches["granite-moe-3b-a800m"]["flash_bwd"],
                     d256_launches=train_launches["recurrentgemma-2b"]["flash_bwd"],
                     mla_launches=train_launches["deepseek-v2-236b"]["flash_bwd"],
                     **{f"{p}launches": train_launches[a]["flash_bwd"]
                        for p, a in trained.items()})
    scan_bwd["launches"] = train_launches["falcon-mamba-7b"]["mamba_bwd"]
    gmm_dx["launches"] = train_launches["granite-moe-3b-a800m"]["gmm_dx"]
    gmm_dw["launches"] = train_launches["granite-moe-3b-a800m"]["gmm_dw"]
    lru_bwd["launches"] = train_launches["recurrentgemma-2b"]["lru_bwd"]
    lru["launches"] = rg["lru_scan"]
    adamw.update(launches=train_launches["minicpm-2b"]["adamw"],
                 norm_launches=train_launches["minicpm-2b"]["adamw_norm"],
                 granite_launches=train_launches["granite-moe-3b-a800m"]["adamw"],
                 granite_norm_launches=train_launches["granite-moe-3b-a800m"]["adamw_norm"])
    gmm.update(launches=granite["grouped_matmul"], deepseek_launches=deepseek["grouped_matmul"],
               train_launches=train_launches["granite-moe-3b-a800m"]["gmm"], **gmm_train)
    scan.update(launches=mamba["selective_scan"],
                train_launches=train_launches["falcon-mamba-7b"]["mamba"])
    for kernel in kernels:
        check(kernel["matches_plain"], f"{kernel['name']}: kernel != plain at the main "
                                       "path's shape")
        check(kernel["launches"] >= 1, f"the main path launched no {kernel['name']} kernel")

    kind = torch.cuda.get_device_name(0)
    for key, secs in {**hw_walls, **wave_walls, **session_walls, **mesh_walls, **sw_walls,
                      **serve_walls, **train_walls}.items():
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
