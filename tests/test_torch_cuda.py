"""The port's CUDA kernels on the card.

* ready queue: slab and completion flags bit-equal to its plain version,
  its ring a start order (a permutation and a topological order of the
  edges), on random DAG epochs, one chain 2,048 deep, the chain universe
  and a task with 1,000 dependents (``m`` > 32); nothing run, as in the
  plain version, on corrupted tables; the same bits over 20 launches; the
  wrapper's input checks, and the device runner's route through it;
* wave megakernel: bit-equal to its plain version over S in {1, 7, 32, 64}
  x D in {1, 37, 4096} (repeated input rows, a slot reading its own out
  row), its error on bad descriptors, the wrapper's input checks; the
  epoch entry ``wave_epoch`` bit-equal to its plain version over random
  plans (self-reads, reads of another slot's out row, steps wider than
  the co-resident grid), on its staged and its direct path, with a bad
  descriptor in a middle step (flagged; every other slot and step still
  runs); the wave/frontier device window through it (one launch per run,
  its steps equal to the plan's) and on its step path (the physics
  stream), and the ``DeviceSession`` in all three plan modes, each
  bit-equal to ``run_serial``;
* ``lru_scan``: bit-equal to ``lru_scan_ref``, float32 and bfloat16, over
  the time-tiled kernel's edges (D of 2560, 1000, 40, 7: both channel
  tiles, 16-byte and element copies; B up to 8; S of 1, 63, 64, 65,
  2048: around the 64-step tile);
* ``flash_attention``: within tolerance of ``attention_ref`` over the CPU
  tests' sweep, the serving shapes and the edges of the bfloat16 kernel's
  tiles (Sq and Sk of 65, 127, 333, 2500; D of 8, 24, 64, 120, 128, 256;
  the window edge and ``prefix_len`` inside a tile; float32 1e-4:
  summation order; bfloat16 2e-2: P and the output rounded to bfloat16),
  fully masked rows exactly 0 (a whole query tile of them too), the same
  bits on a second launch; musicgen-large's and paligemma-3b's prefill
  shapes; values of another width than the keys (MLA's D 192 / Dv 128
  and the edges of that instantiation);
* ``selective_scan``: within 1e-5 (abs and rel) of ``selective_scan_ref``
  for ys and hT over falcon-mamba's prefill (S 512 and 128) and decode
  shapes, S on both sides of the kernel's 8-step segments and 128- and
  256-step chunks (1, 127, 128, 129, 511, 512, 513, 2049) for B 1, 3 and 4,
  E off the channel tile and the 16-byte copy width, N from 1 to 16; the
  fused entry ``mamba_scan`` within 1e-5 of ``mamba_scan_ref`` in float32
  and bf16 (bf16: the rounding of a value within 1e-5 of the plain float32
  y) with z, b and c strided views of the projections; the same bits on a
  second launch; each row of a B = 4 launch equal to a B = 1 launch of that
  row; both entries' input checks;
* ``grouped_matmul``: within tolerance of ``grouped_matmul_ref`` over the
  CPU tests' ragged cases, ``block_m`` in {1, 2, 3, 15, 16, 17, 63, 64,
  65, 70, 128} (both tile shapes and their edges), K and N off the 16-byte
  copy width and the ring's tile widths, and the granite-moe-3b-a800m
  decode and prefill expert shapes (float32 1e-4: summation order;
  float16 and bfloat16 8e-3, one bfloat16 ulp: both sum in float32 and
  round once), the same bits on a second launch, its error on bad group
  ids and its input checks; the MoE FFN on the card against its CPU run;
* the wave executor and the device window's step path: the
  ``bench_moe_waves`` expert stream with the benchmark's ``a @ b`` task
  through ``WaveScheduler`` and ``DeviceWindowRunner`` (wave and frontier)
  bit-equal to ``run_serial`` (contraction groups run task by task on the
  card);
* the wrappers' input checks, and model prefills that launch the kernels
  (recurrentgemma: flash and the scan; deepseek: MLA through flash and
  the grouped GEMM; falcon-mamba: the selective scan, in decode too);
* the mesh window on one card: ``MeshDeviceSession`` with 2 and 4 shards,
  each on its own stream, in loop and wave plan modes, on the cross-shard
  join stream at width 4096, bit-equal to ``run_serial``, every dispatch
  a ready-queue or wave-kernel launch, every edge a d2d row copy without a
  host sync; an exported row unchanged by its owner's next epoch; the
  threaded scheduler's 200-task stress on 8 real streams;
* the dynamic-DNN workloads (``dyn/``) bit-equal to ``run_serial`` under
  every ACS-SW and ACS-HW policy and ``DagRunner``, launching none of the
  six kernels; the frontier keeping more than one group in flight on
  InstaNAS; ``GroupExecutor``'s event poll and its ``sync`` counting
  blocking syncs; the frontier server's exact kernel launches and tokens;
* training: flash's backward within tolerance of ``attention_bwd_ref``
  (D up to 256, recurrentgemma's and paligemma's D-256 shapes among
  them), each 16-bit case on the path its shape rule names (wgmma with
  TMA, on the tensors or, for D 36 and pointers off 16-byte alignment, on
  padded copies), the grouped GEMM's ``dx`` and ``dw`` within tolerance
  of ``grouped_matmul_bwd_ref`` (both on both wgmma paths, ``dx`` at
  ``block_m`` 1 to 512 and 4,100 groups, ``dw`` over more groups than one
  launch takes; a group no tile names exactly 0, a ``dx`` tile with a bad
  group id zeros and flagged, the same bits twice), the RG-LRU reverse
  scan bit-equal to
  ``lru_scan_bwd_ref``, flash's backward at MLA's Dv != D (192 / 128, the
  reduced 16 / 8, Dv 36 on padded copies), the selective scan's backward
  (both entries) within tolerance of ``mamba_scan_bwd_ref`` and
  ``selective_scan_bwd_ref``, each autograd Function launching its
  kernels, and reduced configs' gradients on the card (deepseek-v2's MLA
  and falcon-mamba's scan among them) against the CPU's;
* the optimizer (``kernels/adamw.py``): the fused AdamW update bit-equal
  to the per-leaf plain version at a scale of exactly 1 and at a shared
  scale below it, lr a float or a device tensor, over leaves of 1, 7 and
  4,097 elements, bfloat16, float16 and float32 in one tree, views whose
  storage offset breaks 16-byte alignment (all five pointers alike: the
  vector path after a head; one alone: element by element) and a
  283M-element leaf (minicpm-2b's tied embedding) beside small ones; the
  norm within 1e-6 of the per-leaf ``torch.sum`` path and the same bits
  over 20 runs; three launches a step whatever the number of leaves; no
  host sync under ``torch.cuda.set_sync_debug_mode("error")``; no float32
  copy of the gradients (the peak memory of a clip and update); a reduced
  model's ``StepBundle.train_step`` taking the fused path for every leaf
  (``trace.collect()``); the wrappers' refusals.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use), so they carry the ``cuda`` marker and skip without a card.
Run them on the card with::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This module imports no JAX: the card's machine has none.
"""

import functools
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BufferPool, DeviceOpRegistry, DeviceSession, DeviceWindowRunner
from repro_torch.core import (MeshDeviceSession, SlabArena, Task, ThreadedStreamScheduler,
                              run_serial)
from repro_torch.core.device_dispatch import _loop_kernel_parts, lower_epoch_program
from repro_torch.core.task import default_segments
from repro_torch.kernels import adamw as aw
from repro_torch.kernels import ready_queue as rq
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels.ops import LOOP_BRANCHES, register_loop_branches, wave_step
from repro_torch.kernels.ref import (attention_ref, grouped_matmul_bwd_ref, grouped_matmul_ref,
                                     lru_scan_bwd_ref, lru_scan_ref, mamba_scan_ref,
                                     ready_queue_ref, selective_scan_ref, wave_rows_ref)

fa = importlib.import_module("repro_torch.kernels.flash_attention")
gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
ls = importlib.import_module("repro_torch.kernels.lru_scan")
we = importlib.import_module("repro_torch.kernels.wave_elementwise")

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _stream(device, seed, n, d, n_bufs=64):
    """A random epoch of ``n`` axpy/mul tasks over ``n_bufs`` rows of width
    ``d``: dense RAW/WAR/WAW hazards. Returns (buffers, tasks)."""
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
        tasks.append(Task(opcode=name, fn=LOOP_BRANCHES[name], inputs=ins, outputs=outs,
                          read_segments=r, write_segments=w))
    return bufs, tasks


def _kernel_args(device, tasks):
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    arena = SlabArena()
    arena.add_tasks(tasks)
    program = lower_epoch_program(tasks, reg, arena)
    parts = _loop_kernel_parts(program, reg, arena)
    assert parts is not None
    cid, branches = parts
    p = program.payload(device)
    args = (arena.pack(device)[cid], p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"],
            p["tail0"])
    return args, branches


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@functools.lru_cache(maxsize=None)
def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _payload(args):
    return dict(zip(("task_tbl", "dep_tbl", "ring0", "rem0", "tail0"), args[1:]))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n,d", [(1, 8), (64, 128), (300, 1000), (1024, 4096), (8192, 256)])
def test_kernel_bit_equal_to_plain(device, seed, n, d):
    """Slab and done bit for bit; the ring a start order of the tasks (a
    concurrent queue does not fix the order, so it is not compared with
    the plain version's FIFO order)."""
    _, tasks = _stream(device, seed, n, d)
    args, branches = _kernel_args(device, tasks)
    got = rq.ready_queue(*args, branches=branches)
    torch.cuda.synchronize()
    want = ready_queue_ref(*args, branches=branches)
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(_bits(g), _bits(w))
    assert bool(got[1].all())
    assert _smoke().is_start_order(got[2], args[2])


@pytest.mark.parametrize("corrupt", ("bad_in2",) + _smoke().CORRUPTIONS)
def test_kernel_stops_like_plain_on_corrupted_tables(device, corrupt):
    """A fault found by the checks runs no task (slab unchanged, done all 0,
    ring == ring0) on the card as in the plain version; a corrupted in2,
    which no opcode reads, runs everything."""
    _, tasks = _stream(device, 0, 200, 64)
    args, branches = _kernel_args(device, tasks)
    q, _ = _smoke().corrupt_tables(corrupt, args[0], _payload(args), len(branches))
    _smoke().queue_vs_plain(corrupt, args[0], q, branches)


@pytest.mark.parametrize("case", ["chain_2048_every_edge", "chain_2048_one_edge",
                                  "fan_out_1000", "chain_universe"])
def test_kernel_bit_equal_on_deep_and_wide_epochs(device, case):
    """Pure serial work (one chain 2,048 deep), 64 chains side by side, and
    one task whose 1,000 dependents take 32 warp lanes a round."""
    smoke = _smoke()
    if case == "chain_universe":
        _, tasks = smoke.chain_universe(device)
        slab, p, branches = smoke.lowered_payload(tasks, device)
    elif case == "fan_out_1000":
        slab, p, branches = smoke.fan_out(device, 1000, width=256)
    else:
        slab, p, branches = smoke.serial_chain(device, 2048,
                                               all_edges=case.endswith("every_edge"))
    smoke.queue_vs_plain(case, slab, p, branches)


def test_kernel_same_bits_over_20_launches(device):
    _, tasks = _stream(device, 4, 2048, 4096)
    args, branches = _kernel_args(device, tasks)
    first = rq.ready_queue(*args, branches=branches)
    for _ in range(19):
        got = rq.ready_queue(*args, branches=branches)
        assert torch.equal(_bits(got[0]), _bits(first[0])) and torch.equal(got[1], first[1])
    want = ready_queue_ref(*args, branches=branches)
    assert torch.equal(_bits(first[0]), _bits(want[0]))


def test_wrapper_checks_inputs(device):
    _, tasks = _stream(device, 1, 16, 32)
    args, branches = _kernel_args(device, tasks)
    slab, task_tbl, dep_tbl, ring0, rem0, tail0 = args
    with pytest.raises(TypeError, match="int32"):
        rq.ready_queue(slab, task_tbl.long(), dep_tbl, ring0, rem0, tail0, branches=branches)
    with pytest.raises(TypeError, match="float32"):
        rq.ready_queue(slab.double(), task_tbl, dep_tbl, ring0, rem0, tail0, branches=branches)
    with pytest.raises(ValueError, match="contiguous"):
        rq.ready_queue(slab.t().contiguous().t(), task_tbl, dep_tbl, ring0, rem0, tail0,
                       branches=branches)
    with pytest.raises(ValueError, match="is on"):
        rq.ready_queue(slab, task_tbl.cpu(), dep_tbl, ring0, rem0, tail0, branches=branches)
    with pytest.raises(ValueError, match="no kernel opcode"):
        rq.ready_queue(slab, task_tbl, dep_tbl, ring0, rem0, tail0,
                       branches=(lambda x, y: x + y,) * len(branches))


def test_wave_vmap_groups_bit_equal_to_serial(device):
    """The wave executor's vmapped signature groups round exactly as the
    serial baseline's per-task calls on the card."""
    from repro_torch.core import TaskStream, make_scheduler
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    snaps = {}
    for policy in ("serial", "wave"):
        eng = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=16, group_size=4, seed=3,
                            device=device)
        dispatches = tasks = 0
        for _ in range(2):
            stream = TaskStream()
            eng.emit_step(stream)
            report = make_scheduler(policy, window_size=64, device=device)(stream.tasks)
            dispatches += report.exec_stats["dispatches"]
            tasks += len(stream.tasks)
        snaps[policy] = eng.state_snapshot()
    assert dispatches < tasks  # the wave run batched some groups
    np.testing.assert_array_equal(snaps["wave"].view(np.int32), snaps["serial"].view(np.int32))


def test_device_runner_goes_through_the_kernel(device):
    bufs, tasks = _stream(device, 2, 256, 512)
    run_serial(tasks, device=device)
    want = torch.stack([b.value for b in bufs])

    bufs, tasks = _stream(device, 2, 256, 512)
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    before = rq.launches
    report = DeviceWindowRunner(registry=reg, plan_mode="loop", device=device).run(tasks)
    assert report.loop_executor == "cuda"
    assert rq.launches == before + 1
    assert torch.equal(_bits(torch.stack([b.value for b in bufs])), _bits(want))


# ---------------------------------------------------------------------------
# The wave megakernel and the wave/frontier/session device window
# ---------------------------------------------------------------------------

def _wave(device, seed, s, d):
    """A random wave of ``s`` slots over ``s + 5`` rows of width ``d``:
    unique out rows, every slot's second input the same row, slot 0 reading
    its own out row."""
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


WAVE_BRANCHES = (LOOP_BRANCHES["axpy"], LOOP_BRANCHES["mul"])


@pytest.mark.parametrize("s", [1, 7, 32, 64])
@pytest.mark.parametrize("d", [1, 37, 4096])
def test_wave_kernel_bit_equal_to_plain(device, s, d):
    slab, desc = _wave(device, s * 100 + d, s, d)
    before = we.launches
    got = we.wave_elementwise(slab, desc, branches=WAVE_BRANCHES)
    assert we.launches == before + 1
    want = wave_rows_ref(slab, desc, WAVE_BRANCHES)
    assert torch.equal(_bits(got), _bits(want))
    stepped = wave_step(slab, desc, branches=WAVE_BRANCHES)
    torch.cuda.synchronize()
    expect = slab.clone()
    expect[desc[:, 3].long()] = want
    assert torch.equal(_bits(stepped), _bits(expect))


@pytest.mark.parametrize("col,bad", [(0, 2), (1, -1), (2, 10 ** 6), (3, 12)])
def test_wave_kernel_raises_on_bad_descriptors(device, col, bad):
    slab, desc = _wave(device, 0, 7, 64)
    desc[3, col] = bad
    with pytest.raises(ValueError, match="descriptor"):
        we.wave_elementwise(slab, desc, branches=WAVE_BRANCHES)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    we.wave_elementwise(slab, desc, branches=WAVE_BRANCHES, err=err)  # deferred check
    with pytest.raises(ValueError, match="descriptor"):
        we.raise_on_error(err)


def test_wave_wrapper_checks_inputs(device):
    slab, desc = _wave(device, 1, 4, 32)
    with pytest.raises(TypeError, match="int32"):
        we.wave_elementwise(slab, desc.long(), branches=WAVE_BRANCHES)
    with pytest.raises(TypeError, match="float32"):
        we.wave_elementwise(slab.double(), desc, branches=WAVE_BRANCHES)
    with pytest.raises(ValueError, match="is on"):
        we.wave_elementwise(slab, desc.cpu(), branches=WAVE_BRANCHES)
    with pytest.raises(ValueError, match="no kernel opcode"):
        we.wave_elementwise(slab, desc, branches=(lambda x, y: x + y,) * 2)


def _epoch_plan(seed, n_steps, d, **kw):
    """``chip_smoke.random_plan``: ``n_steps`` random steps over a
    ``[48, d]`` slab with self-reads and reads of another slot's out row.
    Returns (slab, desc, offsets) on the host."""
    return _chip_smoke().random_plan(seed, n_steps, d, **kw)


def _plain_epoch(slab, desc, offsets):
    """The plain per-step loop on the CPU (the wrapper's plain path)."""
    return we.wave_epoch(slab.cpu().clone(), desc.cpu(), offsets, branches=WAVE_BRANCHES)


@pytest.mark.parametrize("d", [1, 37, 4096])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_epoch_bit_equal_to_plain(device, seed, d):
    slab_np, desc_np, offsets = _epoch_plan(seed, 40, d)
    desc = torch.from_numpy(desc_np).to(device)
    want = _plain_epoch(torch.from_numpy(slab_np), desc, offsets)
    direct = we.direct_steps(desc_np, offsets)
    assert any(direct) and not all(direct)
    for marks in (None, direct):  # the staged path, then the direct one where allowed
        slab = torch.from_numpy(slab_np).to(device)
        before, steps0 = we.launches, we.steps
        out = we.wave_epoch(slab, desc, offsets, branches=WAVE_BRANCHES, direct=marks)
        torch.cuda.synchronize()
        assert out is slab
        assert (we.launches - before, we.steps - steps0) == (1, len(offsets) - 1)
        assert torch.equal(_bits(slab.cpu()), _bits(want))


@pytest.mark.parametrize("slots,d", [(64, 4096), (2500, 4096), (3000, 37)])
def test_wave_epoch_steps_wider_than_the_grid(device, slots, d):
    """Steps whose (slot, chunk) items outnumber the co-resident blocks:
    each block strides over several items in both phases."""
    slab_np, desc_np, offsets = _epoch_plan(5, 3, d, rows=slots + 16, max_slots=slots,
                                            min_slots=slots // 2)
    desc = torch.from_numpy(desc_np).to(device)
    want = _plain_epoch(torch.from_numpy(slab_np), desc, offsets)
    slab = torch.from_numpy(slab_np).to(device)
    we.wave_epoch(slab, desc, offsets, branches=WAVE_BRANCHES)
    torch.cuda.synchronize()
    assert torch.equal(_bits(slab.cpu()), _bits(want))


@pytest.mark.parametrize("col,bad", [(0, 2), (1, -1), (2, 10 ** 6), (3, 48)])
def test_wave_epoch_flags_a_bad_descriptor_mid_epoch(device, col, bad):
    slab_np, desc_np, offsets = _epoch_plan(9, 12, 64)
    k = offsets[6]  # the first slot of the middle step
    good = np.delete(desc_np, k, axis=0)  # the bad slot writes nothing
    want = _plain_epoch(torch.from_numpy(slab_np), torch.from_numpy(good),
                        [o - (o > k) for o in offsets])
    desc_np[k, col] = bad
    desc = torch.from_numpy(desc_np).to(device)
    with pytest.raises(ValueError, match="descriptor"):
        we.wave_epoch(torch.from_numpy(slab_np).to(device), desc, offsets,
                      branches=WAVE_BRANCHES)
    for marks in (None, we.direct_steps(desc_np, offsets)):
        err = torch.zeros(1, dtype=torch.int32, device=device)
        slab = torch.from_numpy(slab_np).to(device)
        we.wave_epoch(slab, desc, offsets, branches=WAVE_BRANCHES, err=err, direct=marks)
        torch.cuda.synchronize()
        assert int(err) == 1
        assert torch.equal(_bits(slab.cpu()), _bits(want))  # every other slot and step ran


def test_wave_epoch_wrapper_checks_inputs(device):
    slab_np, desc_np, offsets = _epoch_plan(1, 4, 32)
    slab = torch.from_numpy(slab_np).to(device)
    desc = torch.from_numpy(desc_np).to(device)
    with pytest.raises(TypeError, match="int32"):
        we.wave_epoch(slab, desc.long(), offsets, branches=WAVE_BRANCHES)
    with pytest.raises(TypeError, match="float32"):
        we.wave_epoch(slab.double(), desc, offsets, branches=WAVE_BRANCHES)
    with pytest.raises(ValueError, match="is on"):
        we.wave_epoch(slab, desc.cpu(), offsets, branches=WAVE_BRANCHES)
    with pytest.raises(ValueError, match="must not decrease"):
        we.wave_epoch(slab, desc, [0, 3, 2] + offsets[3:], branches=WAVE_BRANCHES)
    with pytest.raises(ValueError, match="from 0 to the"):
        we.wave_epoch(slab, desc, offsets[:-1], branches=WAVE_BRANCHES)


def _chain(device, n_chains=16, width=256, depth=8):
    pool = BufferPool(device)
    rng = np.random.RandomState(4)
    states = [pool.alloc((width,), np.float32, value=rng.randn(width).astype(np.float32))
              for _ in range(n_chains)]
    weight = pool.alloc((width,), np.float32, value=rng.randn(width).astype(np.float32))
    tasks = []
    for st in states:
        for k in range(depth):
            name = "axpy" if k % 2 == 0 else "mul"
            r, w = default_segments((st, weight), (st,))
            tasks.append(Task(opcode=name, fn=LOOP_BRANCHES[name], inputs=(st, weight),
                              outputs=(st,), read_segments=r, write_segments=w))
    return states, tasks


@pytest.mark.parametrize("mode", ["wave", "frontier"])
@pytest.mark.parametrize("build", ["chain", "random"])
def test_device_runner_wave_modes_go_through_the_wave_kernel(device, mode, build):
    make = (lambda: _chain(device)) if build == "chain" else \
        (lambda: _stream(device, 5, 200, 256, n_bufs=24))
    bufs, tasks = make()
    run_serial(tasks, device=device)
    want = torch.stack([b.value for b in bufs])
    bufs, tasks = make()
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    before, steps0 = we.launches, we.steps
    report = DeviceWindowRunner(registry=reg, plan_mode=mode, device=device).run(tasks)
    assert report.wave_executor == "cuda"
    assert report.wave_kernel_launches == we.launches - before == 1  # one epoch launch
    assert report.wave_kernel_steps == we.steps - steps0 == len(report.waves)
    assert torch.equal(_bits(torch.stack([b.value for b in bufs])), _bits(want))


@pytest.mark.parametrize("mode", ["wave", "frontier"])
def test_device_runner_steps_path_bit_equal_on_the_physics_stream(device, mode):
    from repro_torch.core import TaskStream
    from repro_torch.sim import ENVIRONMENTS, PhysicsEngine

    snaps = {}
    for policy in ("serial", mode):
        eng = PhysicsEngine(ENVIRONMENTS["cheetah"], n_envs=16, group_size=4, seed=3,
                            device=device)
        for _ in range(2):
            stream = TaskStream()
            eng.emit_step(stream)
            if policy == "serial":
                run_serial(stream.tasks, device=device)
            else:
                report = DeviceWindowRunner(window_size=32, plan_mode=mode,
                                            device=device).run(stream.tasks)
                assert report.wave_executor == "steps"
        snaps[policy] = eng.state_snapshot()
    np.testing.assert_array_equal(snaps[mode].view(np.int32), snaps["serial"].view(np.int32))


@pytest.mark.parametrize("mode", ["wave", "frontier", "loop"])
def test_device_session_bit_equal_to_serial(device, mode):
    bufs, tasks = _chain(device)
    run_serial(tasks, device=device)
    want = torch.stack([b.value for b in bufs])
    bufs, tasks = _chain(device)
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    session = DeviceSession(window_size=32, registry=reg, plan_mode=mode, device=device)
    wave0, steps0, loop0 = we.launches, we.steps, rq.launches
    n = len(tasks) // 4
    for i in range(4):
        session.submit(tasks[i * n:(i + 1) * n])
        session.poll()
    stats = session.close().session_stats
    assert torch.equal(_bits(torch.stack([b.value for b in bufs])), _bits(want))
    if mode == "loop":
        assert rq.launches - loop0 == stats["loop_dispatches"] == stats["device_dispatches"] > 0
    else:
        assert stats["wave_kernel_dispatches"] == stats["device_dispatches"] > 0
        assert we.launches - wave0 == stats["wave_kernel_dispatches"]  # one per epoch
        assert we.steps - steps0 == len(session.stats.wave_widths)


# ---------------------------------------------------------------------------
# lru_scan and flash_attention
# ---------------------------------------------------------------------------

def _int_bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d", [(1, 1, 2560), (3, 7, 16), (1, 300, 2560), (4, 1000, 130)])
def test_lru_scan_bit_equal_to_plain(device, b, s, d, dtype):
    rng = np.random.RandomState(s + d)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (b, s, d)).astype(np.float32)).to(device, dtype)
    x = torch.from_numpy(rng.randn(b, s, d).astype(np.float32)).to(device, dtype)
    h0 = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(device)
    before = ls.launches
    got = ls.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert ls.launches == before + 1
    want = lru_scan_ref(a, x, h0)
    assert got.dtype == dtype
    assert torch.equal(_int_bits(got), _int_bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2560, 1000, 40, 7])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 2048])
@pytest.mark.parametrize("b", [1, 8])
def test_lru_scan_tiles_bit_equal_to_plain(device, b, s, d, dtype):
    """The time-tiled kernel's edges: 16- and 32-channel tiles (B = 1 and
    8 at D = 2560), a ragged last channel tile (1000, 40, 7), element
    copies (D = 7; bfloat16 at D = 1000, 40 copies 16 bytes), and S around
    the 64-step tile and across many tiles."""
    rng = np.random.RandomState(b * 7 + s + d)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (b, s, d)).astype(np.float32)).to(device, dtype)
    x = torch.from_numpy(rng.randn(b, s, d).astype(np.float32)).to(device, dtype)
    h0 = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(device, dtype)
    before = ls.launches
    got = ls.lru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert ls.launches == before + 1 and got.dtype == dtype
    assert torch.equal(_int_bits(got), _int_bits(lru_scan_ref(a, x, h0)))


# (b, h, hkv, sq, sk, d), flags: tests/test_torch_attention.py's sweep
# plus the serving shapes of recurrentgemma-2b and h2o-danube-3-4b and the
# frontends' prefill shapes.
FLASH = {
    "mha": ((1, 2, 2, 32, 32, 16), {}),
    "gqa_ragged_seq": ((2, 4, 2, 48, 48, 32), {}),
    "mqa_cross": ((1, 8, 1, 16, 64, 8), {"q_offset": 48}),
    "window_17": ((1, 2, 2, 40, 40, 16), {"window": 17}),
    "softcap": ((1, 2, 2, 32, 32, 16), {"softcap": 10.0}),
    "prefix_window": ((1, 4, 2, 40, 40, 16), {"window": 8, "prefix_len": 5}),
    "decode_sq1": ((2, 4, 2, 1, 128, 16), {"q_offset": 127}),
    "noncausal": ((1, 2, 2, 24, 24, 16), {"causal": False}),
    "ragged_sk_odd_d": ((1, 4, 1, 20, 37, 24), {"q_offset": 17}),
    "fully_masked_rows": ((1, 2, 2, 8, 8, 16), {"q_offset": -4}),
    "recurrentgemma_prefill": ((1, 10, 1, 333, 333, 256), {"window": 2048}),
    "recurrentgemma_window": ((1, 10, 1, 2500, 2500, 256), {"window": 2048}),
    "danube_prefill": ((1, 32, 8, 300, 300, 120), {"window": 4096}),
    # The frontends: musicgen-large (32 heads over 32 kv, D 64, causal) and
    # paligemma-3b (8 over 1, D 256, a 256-key bidirectional prefix across
    # four tiles), at their prefill lengths.
    "musicgen_prefill": ((1, 32, 32, 256, 256, 64), {}),
    "paligemma_prefill": ((1, 8, 1, 320, 320, 256), {"prefix_len": 256}),
    # The edges of the bfloat16 kernel's tiles: 64 query rows, 64 keys, D
    # padded to 64/128/256, 16-byte copies at D % 8 == 0.
    "granite_prefill": ((1, 24, 8, 127, 127, 64), {}),
    "one_past_a_tile": ((1, 4, 2, 65, 65, 64), {}),
    "window_edge_in_tile": ((1, 4, 1, 127, 127, 128), {"window": 50}),
    "d24_two_batches": ((2, 4, 2, 333, 333, 24), {}),
    "d8_noncausal": ((1, 8, 8, 100, 100, 8), {"causal": False}),
    "prefix_past_a_tile": ((1, 4, 2, 130, 200, 64), {"q_offset": 70, "prefix_len": 100}),
    "window_softcap_d128": ((1, 2, 1, 127, 2500, 128),
                            {"q_offset": 2373, "window": 300, "softcap": 20.0}),
    "decode_window_edge": ((1, 4, 4, 1, 2500, 128), {"q_offset": 2499, "window": 300}),
    "d256_prefix_window": ((1, 2, 1, 100, 150, 256),
                           {"q_offset": 50, "window": 40, "prefix_len": 33}),
    # Dv != D, (b, h, hkv, sq, sk, d, dv): MLA's widths, the (192, 128)
    # instantiation's edges, values wider than keys, element loads.
    "mla_prefill": ((1, 16, 16, 300, 300, 192, 128), {}),
    "mla_decode": ((1, 8, 8, 1, 300, 192, 128), {"q_offset": 299}),
    "mla_reduced": ((1, 4, 4, 20, 20, 16, 8), {}),
    "dv_wider_gqa": ((1, 4, 2, 70, 70, 64, 128), {"window": 30}),
    "dv_ragged_element_loads": ((2, 4, 4, 100, 100, 130, 66), {"prefix_len": 10}),
}
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _qkv(device, name, dtype):
    shape = FLASH[name][0]
    (b, h, hkv, sq, sk, d), dv = shape[:6], shape[-1]
    rng = np.random.RandomState(sum(map(ord, name)))
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    return make(b, h, sq, d), make(b, hkv, sk, d), make(b, hkv, sk, dv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_attention_matches_plain(device, name, dtype):
    q, k, v = _qkv(device, name, dtype)
    flags = FLASH[name][1]
    before = fa.launches
    got = fa.flash_attention(q, k, v, **flags)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    want = attention_ref(q, k, v, **flags)
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    assert torch.equal(fa.flash_attention(q, k, v, **flags), got)  # the same bits again


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 2, 8, 8, 16), (1, 4, 2, 70, 70, 64)])
def test_flash_attention_fully_masked_rows_are_zero(device, dtype, shape):
    """Rows before the first key see nothing and write exactly 0: a few
    rows of a tile, and (70 rows at offset -66) a whole 64-row tile."""
    b, h, hkv, sq, sk, d = shape
    rng = np.random.RandomState(sq)
    q, k, v = (torch.from_numpy(rng.randn(b, n, s, d).astype(np.float32)).to(device, dtype)
               for n, s in ((h, sq), (hkv, sk), (hkv, sk)))
    blind = sq - 4  # rows 0 .. blind - 1 lie before key 0
    got = fa.flash_attention(q, k, v, q_offset=-blind)
    torch.cuda.synchronize()
    assert bool((got[:, :, :blind] == 0).all())
    assert bool((got[:, :, blind:] != 0).any())
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, q_offset=-blind).float(),
                               **FLASH_TOL[dtype])


def test_kernel_wrappers_check_inputs(device):
    q, k, v = _qkv(device, "mha", torch.float32)
    with pytest.raises(TypeError, match="share one of"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 1, 4, 264, device=device)
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="query heads"):
        fa.flash_attention(torch.zeros(1, 3, 4, 16, device=device), k, v)
    a = torch.rand(1, 4, 8, device=device)
    with pytest.raises(TypeError, match="share one of"):
        ls.lru_scan(a, a.double(), torch.zeros(1, 8, device=device))
    with pytest.raises(ValueError, match="h0 must be"):
        ls.lru_scan(a, a, torch.zeros(2, 8, device=device))
    with pytest.raises(ValueError, match="contiguous"):
        ls.lru_scan(torch.rand(1, 8, 4, device=device).transpose(1, 2), a,
                    torch.zeros(1, 8, device=device))
    with pytest.raises(ValueError, match="at least one step"):
        empty = torch.zeros(1, 0, 8, device=device)
        ls.lru_scan(empty, empty, torch.zeros(1, 8, device=device))


def test_model_prefill_launches_both_kernels(device):
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import init_cache, init_params, prefill

    cfg = dataclasses.replace(ARCHS["recurrentgemma-2b"].reduced(), n_layers=5)
    params = init_params(cfg, 0, device=device)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (1, 20))
                            .astype(np.int32)).to(device)
    fa.reset_launches()
    ls.reset_launches()
    logits, _ = prefill(params, cfg, toks, init_cache(cfg, 1, 32, device=device))
    torch.cuda.synchronize()
    assert fa.launches == 1 and ls.launches == 4  # 1 local-attention, 4 RG-LRU layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch,want", [("deepseek-v2-236b", {"fa": 2, "gm": 3, "ss": 0}),
                                       ("falcon-mamba-7b", {"fa": 0, "gm": 0, "ss": 2})])
def test_model_prefill_and_decode_launch_their_kernels(device, arch, want):
    """Reduced deepseek (MLA prefill through flash at D 16 / Dv 8, one MoE
    layer's three expert products) and falcon-mamba (two Mamba layers):
    each prefill and decode step launches its kernels, and the logits
    match the same model's on the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    cfg = ARCHS[arch].reduced()
    cpu = init_params(cfg, 0, device="cpu")
    params = init_params(cfg, 0, device="cpu").to(device)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (1, 20))
                            .astype(np.int32))
    for mod in (fa, gm, ss):
        mod.reset_launches()
    logits, cache = prefill(params, cfg, toks.to(device), init_cache(cfg, 1, 32, device=device))
    torch.cuda.synchronize()
    assert (fa.launches, gm.launches, ss.launches) == (want["fa"], want["gm"], want["ss"])
    step, _ = decode_step(params, cfg, toks[:, :1].to(device), cache, 20)
    torch.cuda.synchronize()
    assert fa.launches == want["fa"]  # decode attends in plain PyTorch
    assert (gm.launches, ss.launches) == (2 * want["gm"], 2 * want["ss"])
    cpu_logits, cpu_cache = prefill(cpu, cfg, toks, init_cache(cfg, 1, 32, device="cpu"))
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4, atol=1e-4)
    cpu_step, _ = decode_step(cpu, cfg, toks[:, :1], cpu_cache, 20)
    torch.testing.assert_close(step.cpu(), cpu_step, rtol=1e-4, atol=1e-4)


def _scan_args(device, b, s, e, n, seed):
    rng = np.random.RandomState(seed)
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)  # noqa: E731
    dt = torch.nn.functional.softplus(make(b, s, e))
    a = -(torch.arange(1, n + 1, dtype=torch.float32, device=device)[None]
          * (0.5 + torch.from_numpy(rng.rand(e, 1).astype(np.float32)).to(device)))
    return dt, make(b, s, e), make(b, s, n), make(b, s, n), a.contiguous(), make(b, e, n)


# (B, S, E, N): falcon-mamba's prefill (512 and 128) and decode, S around
# the kernel's 8-step segments and its 128- and 256-step chunks for B 1, 3
# and 4, E off the channel tile and the 16-byte width, N from 1 to 16.
SCAN = [(1, 512, 8192, 16), (1, 128, 8192, 16), (1, 1, 8192, 16), (4, 1, 8192, 16),
        (3, 33, 1000, 16), (2, 32, 37, 5), (1, 31, 64, 1), (1, 65, 6, 8), (4, 1, 40, 16),
        (1, 100, 96, 15)]
SCAN += [(b, s, 1000, 16) for b, s in ((1, 127), (3, 128), (4, 129), (1, 511), (3, 512),
                                       (4, 513), (1, 2049), (3, 1))]
SCAN += [(1, 70, 64, n) for n in (2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 16)]
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,e,n", SCAN)
def test_selective_scan_matches_plain(device, b, s, e, n):
    args = _scan_args(device, b, s, e, n, seed=b + s + e + n)
    before = ss.launches
    ys, h_t = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    want_ys, want_h = selective_scan_ref(*args)
    torch.testing.assert_close(ys, want_ys, **SCAN_TOL)
    torch.testing.assert_close(h_t, want_h, **SCAN_TOL)
    again = ss.selective_scan(*args)
    assert torch.equal(again[0], ys) and torch.equal(again[1], h_t)


def _fused_args(device, b, s, e, n, dtype, seed, rank=24):
    """``mamba_scan``'s arguments as ``apply_mamba`` passes them: z the
    second half of an in projection, b and c slices of an x projection."""
    rng = np.random.RandomState(seed)
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)  # noqa: E731
    xz, proj = make(b, s, 2 * e).to(dtype), make(b, s, rank + 2 * n).to(dtype)
    a_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))[None]
             + 0.1 * make(e, n)).contiguous()
    return (make(b, s, e).to(dtype), 0.5 * make(e), torch.nn.functional.silu(make(b, s, e))
            .to(dtype), xz[..., e:], proj[..., rank: rank + n], proj[..., rank + n:], a_log,
            make(e), make(b, e, n))


FUSED = [(1, 512, 8192, 16), (1, 128, 8192, 16), (1, 1, 8192, 16), (4, 1, 8192, 16),
         (3, 129, 1000, 5), (2, 513, 40, 16), (1, 2049, 37, 16), (1, 127, 96, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,e,n", FUSED)
def test_mamba_scan_matches_plain(device, b, s, e, n, dtype):
    """The fused entry against ``mamba_scan_ref`` within 1e-5: in bf16 its
    y is the rounding of a value within 1e-5 of the plain float32 y."""
    args = _fused_args(device, b, s, e, n, dtype, seed=b + s + e + n)
    before = ss.launches
    y, h_t = ss.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ss.launches == before + 1 and y.dtype == dtype and h_t.dtype == torch.float32
    want_y, want_h = mamba_scan_ref(*args, out_dtype=torch.float32)
    tol = SCAN_TOL["atol"] + SCAN_TOL["rtol"] * want_y.abs()
    assert bool(((y >= (want_y - tol).to(dtype)) & (y <= (want_y + tol).to(dtype))).all())
    torch.testing.assert_close(h_t, want_h, **SCAN_TOL)
    again = ss.mamba_scan(*args)
    assert torch.equal(again[0], y) and torch.equal(again[1], h_t)


@pytest.mark.parametrize("s", [1, 129, 513])
def test_scan_rows_do_not_depend_on_the_batch(device, s):
    """Row r of a B = 4 launch equals a B = 1 launch of row r, bit for bit,
    through both entries."""
    plain = _scan_args(device, 4, s, 1000, 16, seed=s)
    fused = _fused_args(device, 4, s, 1000, 16, torch.bfloat16, seed=s)
    for fn, args in ((ss.selective_scan, plain), (ss.mamba_scan, fused)):
        whole = fn(*args)
        for r in range(4):
            alone = fn(*(t[r: r + 1] if t.dim() == 3 and t.shape[0] == 4 else t for t in args))
            assert all(torch.equal(a[0], w[r]) for a, w in zip(alone, whole)), (fn.__name__, r)


def test_selective_scan_checks_inputs(device):
    dt, x, bm, cm, a, h0 = _scan_args(device, 1, 8, 64, 16, seed=0)
    with pytest.raises(TypeError, match="float32"):
        ss.selective_scan(dt, x.bfloat16(), bm, cm, a, h0)
    with pytest.raises(ValueError, match="is on"):
        ss.selective_scan(dt, x, bm.cpu(), cm, a, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan(dt, x, bm, cm.transpose(1, 2).contiguous().transpose(1, 2), a, h0)
    with pytest.raises(ValueError, match="state size"):
        ss.selective_scan(dt, x, torch.zeros(1, 8, 17, device=device),
                          torch.zeros(1, 8, 17, device=device), torch.zeros(64, 17, device=device),
                          torch.zeros(1, 64, 17, device=device))
    fa = _fused_args(device, 1, 8, 64, 16, torch.bfloat16, seed=0)
    with pytest.raises(TypeError, match="z must be"):
        ss.mamba_scan(*fa[:3], fa[3].float(), *fa[4:])
    with pytest.raises(ValueError, match="is on"):
        ss.mamba_scan(*fa[:8], fa[8].cpu())
    with pytest.raises(ValueError, match="unit-stride"):
        ss.mamba_scan(*fa[:5], torch.zeros(1, 8, 32, dtype=torch.bfloat16, device=device)[..., ::2],
                      *fa[6:])
    with pytest.raises(ValueError, match="dt_bias must be"):
        ss.mamba_scan(fa[0], fa[1][:63], *fa[2:])


# (G, K, N, block_m, tile group ids): tests/test_torch_grouped_matmul.py's
# cases, edges of the kernel's tiles, and granite-moe's expert products
# (48 experts of [1536, 512] / [512, 1536]; decode C = 1, a 512-token
# prefill C = 128).
GMM = {
    "two_groups": (2, 16, 16, 8, (0, 1)),
    "ragged": (4, 32, 48, 8, (0, 0, 1, 2, 2, 3)),
    "n_not_tile_multiple": (8, 64, 24, 16, (0, 2, 2, 4, 7)),
    "block_m_1": (6, 24, 40, 1, (5, 0, 0, 3, 1, 2, 4, 4)),
    "moe_capacity_layout": (16, 64, 32, 3, tuple(range(16))),
    "k_n_off_vector_width": (3, 37, 131, 70, (2, 0, 2)),
    "block_m_1_m_48": (48, 256, 96, 1, tuple(range(48))),
    "granite_decode_gate": (48, 1536, 512, 1, tuple(range(48))),
    "granite_decode_down": (48, 512, 1536, 1, tuple(range(48))),
    "granite_prefill_gate": (48, 1536, 512, 128, tuple(range(48))),
    "granite_prefill_down": (48, 512, 1536, 128, tuple(range(48))),
    # block_m at both tile shapes' edges (16 rows up to 16, 64 up to 64, 128
    # above); K and N off 8 elements (the 16-byte copies) and off the ring's
    # tile widths (BK 64 / 32, BN 64 / 128).
    "k13_n11_bm1": (3, 13, 11, 1, (2, 0, 1, 1)),
    "k96_n80_bm2": (8, 96, 80, 2, (0, 3, 3, 7, 1)),
    "k40_n72_bm15": (4, 40, 72, 15, (1, 0, 3)),
    "k128_n136_bm16": (5, 128, 136, 16, (4, 2, 2, 0)),
    "k200_n24_bm17": (3, 200, 24, 17, (2, 2, 0)),
    "k72_n264_bm63": (6, 72, 264, 63, (5, 1, 1, 3)),
    "k1000_n128_bm64": (4, 1000, 128, 64, (3, 3, 0)),
    "k52_n40_bm65": (3, 52, 40, 65, (1, 2)),
    "k136_n200_bm128": (6, 136, 200, 128, (5, 0, 5)),
}
GMM_TOL = {torch.float32: 1e-4, torch.float16: 8e-3, torch.bfloat16: 8e-3}


def _gmm_inputs(device, name, dtype):
    g, k, n, bm, tiles = GMM[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = torch.from_numpy(rng.randn(len(tiles) * bm, k).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.randn(g, k, n).astype(np.float32)).to(device, dtype)
    return x, w, torch.tensor(tiles, dtype=torch.int32, device=device), bm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GMM))
def test_grouped_matmul_matches_plain(device, name, dtype):
    x, w, tiles, bm = _gmm_inputs(device, name, dtype)
    before = gm.launches
    got = gm.grouped_matmul(x, w, tiles, block_m=bm)
    torch.cuda.synchronize()
    assert gm.launches == before + 1 and got.dtype == dtype
    want = grouped_matmul_ref(x, w, tiles, block_m=bm)
    tol = GMM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(gm.grouped_matmul(x, w, tiles, block_m=bm), got)  # the same bits again


@pytest.mark.parametrize("bad", [-1, 4, 10 ** 6])
def test_grouped_matmul_raises_on_bad_group_ids(device, bad):
    x, w, tiles, bm = _gmm_inputs(device, "ragged", torch.bfloat16)
    tiles[3] = bad
    with pytest.raises(ValueError, match=r"outside \[0, G\)"):
        gm.grouped_matmul(x, w, tiles, block_m=bm)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    gm.grouped_matmul(x, w, tiles, block_m=bm, err=err)  # the caller's flag: no raise yet
    with pytest.raises(ValueError, match=r"outside \[0, G\)"):
        gm.raise_on_error(err)


def test_grouped_matmul_wrapper_checks_inputs(device):
    x, w, tiles, bm = _gmm_inputs(device, "ragged", torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2), tiles, block_m=bm)
    with pytest.raises(ValueError, match="is on"):
        gm.grouped_matmul(x, w.cpu(), tiles, block_m=bm)
    with pytest.raises(TypeError, match="share one of"):
        gm.grouped_matmul(x, w.half(), tiles, block_m=bm)
    with pytest.raises(ValueError, match="err must be"):
        gm.grouped_matmul(x, w, tiles, block_m=bm, err=torch.zeros(2, dtype=torch.int32,
                                                                   device=device))


def _granite(device, seed=0):
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params

    cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    return cfg, init_params(cfg, seed, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_the_card_matches_its_cpu_run(device, dtype):
    import dataclasses

    from repro_torch.models import ffn

    cfg, params = _granite(device)
    cfg = dataclasses.replace(cfg, dtype=str(dtype).replace("torch.", ""))
    layer = params.stages[0][0].ffn
    moe = ffn.MoeFfn(cfg, {n: getattr(layer, n).to(dtype if n != "router" else torch.float32)
                           for n in ffn.MoeFfn.NAMES})
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 24, cfg.d_model)
                         .astype(np.float32)).to(device, dtype)
    before = gm.launches
    got = moe(x)
    torch.cuda.synchronize()
    assert gm.launches == before + 3
    route_gpu, route_cpu = ffn.route_moe(moe, x, cfg), ffn.route_moe(moe.cpu(), x.cpu(), cfg)
    assert torch.equal(route_gpu.valid.cpu(), route_cpu.valid)
    assert torch.equal(torch.where(route_gpu.valid, route_gpu.token_idx, -1).cpu(),
                       torch.where(route_cpu.valid, route_cpu.token_idx, -1))
    want = moe(x.cpu())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(moe.to(device)(x), got)


def test_model_prefill_launches_the_grouped_gemm(device):
    from repro_torch.models import decode_step, init_cache, prefill

    cfg, params = _granite(device)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (1, 20))
                            .astype(np.int32)).to(device)
    fa.reset_launches()
    gm.reset_launches()
    logits, cache = prefill(params, cfg, toks, init_cache(cfg, 1, 32, device=device))
    torch.cuda.synchronize()
    assert fa.launches == 2 and gm.launches == 6  # 2 layers: attention, 3 expert products
    logits, _ = decode_step(params, cfg, toks[:, :1], cache, 20)
    torch.cuda.synchronize()
    assert fa.launches == 2 and gm.launches == 12
    assert bool(torch.isfinite(logits).all())


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_wave_scheduler_runs_the_expert_stream_bit_equal_to_serial(device):
    """The ``bench_moe_waves`` expert stream with the benchmark's ``a @ b``:
    a batched GEMM sums in another order than single ones on the card, so
    the wave executor runs this contraction's group task by task, and the
    buffers equal ``run_serial``'s bit for bit."""
    from repro_torch.core import WaveScheduler
    from repro_torch.core.executors import contraction_op

    smoke = _chip_smoke()
    tasks, _, outs = smoke.build_expert_stream(device, 0, smoke.expert_gemm)
    run_serial(tasks, device=device)
    serial = torch.stack([o.value for o in outs])
    tasks, _, outs = smoke.build_expert_stream(device, 0, smoke.expert_gemm)
    assert contraction_op(tasks[0]) == "mm"
    report = WaveScheduler(window_size=32, device=device).run(tasks)
    wave = torch.stack([o.value for o in outs])
    torch.cuda.synchronize()
    assert report.exec_stats["dispatches"] == len(tasks)  # one per task, as run
    assert torch.equal(wave.view(torch.int32), serial.view(torch.int32))


@pytest.mark.parametrize("mode", ["wave", "frontier"])
def test_device_window_runs_the_expert_stream_bit_equal_to_serial(device, mode):
    """The same stream through the device window's step path (one group of
    21 GEMMs): one call per task on the card, bit-equal to ``run_serial``."""
    smoke = _chip_smoke()
    tasks, _, outs = smoke.build_expert_stream(device, 0, smoke.expert_gemm)
    run_serial(tasks, device=device)
    serial = torch.stack([o.value for o in outs])
    tasks, _, outs = smoke.build_expert_stream(device, 0, smoke.expert_gemm)
    report = DeviceWindowRunner(window_size=32, plan_mode=mode, device=device).run(tasks)
    got = torch.stack([o.value for o in outs])
    torch.cuda.synchronize()
    assert report.wave_executor == "steps"
    assert torch.equal(got.view(torch.int32), serial.view(torch.int32))


# The dynamic-DNN workloads, the async frontier and the full-DAG baseline

DYN_POLICIES = ("wave", "threaded", "frontier", "device_loop", "device_wave",
                "device_frontier", "session_loop", "session_wave", "session_frontier", "dag")


@pytest.mark.parametrize("policy", DYN_POLICIES)
@pytest.mark.parametrize("name", ["instanas", "dynamic_routing", "condconv", "nasnet",
                                  "amoebanet", "squeezenet", "randwire"])
def test_dyn_workloads_bit_equal_to_serial_under_every_policy(device, name, policy):
    """``chip_smoke.py``'s phase 5b at three inputs: the policy's output
    bit-equal to ``run_serial``'s, and none of the six kernels launched."""
    from repro_torch.dyn import WORKLOADS

    smoke = _smoke()
    params = WORKLOADS[name][0](0, device=device)
    for mod in smoke.kernel_modules():
        mod.reset_launches()
    for seed in range(3):
        out, tasks = smoke.dyn_stream(name, params, seed)
        run_serial(tasks, device=device)
        want = out.value
        out, tasks = smoke.dyn_stream(name, params, seed)
        report = smoke.dyn_runner(policy, device)(tasks)
        torch.cuda.synchronize()
        assert torch.equal(out.value.view(torch.int32), want.view(torch.int32)), seed
        assert report.exec_stats["tasks_run"] == len(tasks)
    assert not any(mod.launches for mod in smoke.kernel_modules())


def test_frontier_keeps_groups_in_flight_on_instanas(device):
    from repro_torch.dyn import WORKLOADS

    smoke = _smoke()
    params = WORKLOADS["instanas"][0](0, device=device)
    peaks = []
    for seed in range(4):
        _, tasks = smoke.dyn_stream("instanas", params, seed)
        report = smoke.dyn_runner("frontier", device)(tasks)
        peaks.append(report.max_inflight_groups())
        assert report.exec_stats["blocking_syncs"] < report.exec_stats["dispatches"]
    assert max(peaks) > 1, peaks


def test_group_executor_polls_its_event_and_counts_blocking_syncs(device):
    """A launch records an event on the current stream and returns at once;
    ``poll`` queries it, ``sync`` waits on it and counts a blocking sync."""
    from repro_torch.core import GroupExecutor

    pool = BufferPool(device)
    a = pool.alloc((2048, 2048), np.float32, value=np.ones((2048, 2048), np.float32))
    out = pool.alloc((2048, 2048), np.float32)
    r, w = default_segments((a,), (out,))
    def chained(x):  # 32 products of 2048^3, ~8 ms on an H100; ones stay ones
        y = x
        for _ in range(32):
            y = (y @ x) / 2048
        return y

    slow = Task(opcode="slow", fn=chained, inputs=(a,), outputs=(out,), read_segments=r,
                write_segments=w)
    ex = GroupExecutor(device)
    torch.cuda.synchronize()
    handle = ex.launch([slow])
    assert isinstance(handle.event, torch.cuda.Event) and list(ex.inflight) == [handle]
    landed_at_once = ex.poll(handle)
    ex.sync(handle)
    assert ex.poll(handle) and not ex.inflight
    assert ex.stats.blocking_syncs == 1 and ex.stats.dispatches == 1
    assert not landed_at_once  # the products outlast the launch's host call
    torch.testing.assert_close(out.value, torch.ones_like(out.value))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "deepseek-v2-236b"])
def test_frontier_server_launches_exactly_and_matches_the_wave_server(device, arch):
    """Reduced models: the frontier server's tokens equal the wave
    server's, and its flash, scan, selective-scan and grouped-GEMM
    launches equal ``chip_smoke.expected_launches`` (``warm`` launches
    nothing)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.runtime import SessionServer

    smoke = _smoke()
    cfg = ARCHS[arch].reduced()
    params = init_params(cfg, 0, device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, 7).astype(np.int32) for _ in range(3)]
    tokens = {}
    for scheduler in ("wave", "frontier"):
        server = SessionServer(cfg, params, max_slots=2, max_len=64, scheduler=scheduler,
                               device=device)
        for mod in (fa, ls, gm, ss):
            mod.reset_launches()
        reqs = [server.submit(p, max_new=smoke.SERVE_MAX_NEW) for p in prompts]
        server.run_until_drained()
        report = server.close()
        torch.cuda.synchronize()
        launches = {"flash_attention": fa.launches, "lru_scan": ls.launches,
                    "grouped_matmul": gm.launches, "selective_scan": ss.launches}
        assert launches == smoke.expected_launches(cfg, len(prompts)), scheduler
        tokens[scheduler] = [r.generated for r in reqs]
    assert tokens["frontier"] == tokens["wave"]
    assert all(len(t) == smoke.SERVE_MAX_NEW for t in tokens["frontier"])
    assert report.max_inflight_groups() >= 1


# -- the mesh window on one card, and the threaded stress on real streams -----

def _joins(device, seed=0, n_chains=4, width=4096, rounds=6):
    """``tests/test_mesh_transfers.py``'s cross-shard join stream (tasks
    carry the branch opcodes, so both device kernels take them)."""
    rng = np.random.RandomState(seed)
    pool = BufferPool(device)
    chains = [[pool.alloc((width,), np.float32, value=rng.randn(width).astype(np.float32))
               for _ in range(2)] for _ in range(n_chains)]
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


def _bits_of(bufs):
    return torch.stack([b.value for b in bufs]).cpu().numpy().view(np.int32)


@pytest.mark.parametrize("mode", ["loop", "wave"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_mesh_session_on_one_card_bit_equal_to_serial(device, n_shards, mode):
    sbufs, stasks = _joins(device)
    run_serial(stasks, device=device)
    bufs, tasks = _joins(device)
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    rq.reset_launches()
    we.reset_launches()
    session = MeshDeviceSession(window_size=32, n_shards=n_shards, registry=reg,
                                plan_mode=mode, device=device)
    assert len({sh.stream.cuda_stream for sh in session.shards}) == n_shards
    for i in range(0, len(tasks), 12):
        session.submit(tasks[i: i + 12])
        session.poll()
    session.close()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits_of(bufs), _bits_of(sbufs))
    stats = session.session_stats()
    kernel = "loop_dispatches" if mode == "loop" else "wave_kernel_dispatches"
    launched = rq.launches if mode == "loop" else we.launches
    assert launched == stats[kernel] == stats["device_dispatches"] > 0
    assert stats["transfer_mode"] == "d2d" and stats["cross_shard_edges"] > 0
    assert stats["d2d_moves"] > 0 and stats["staged_moves"] == 0
    assert all(s["host_syncs_by_tag"].get("mesh-transfer", 0) == 0 for s in stats["per_shard"])
    assert stats["drain_overlap"] >= 2


def test_exported_row_survives_the_owners_next_epoch(device):
    bufs, tasks = _joins(device, n_chains=1, rounds=2)
    reg = DeviceOpRegistry(strict=False)
    register_loop_branches(reg)
    owner = DeviceSession(window_size=8, registry=reg, plan_mode="loop", device=device,
                          stream=torch.cuda.Stream(device))
    owner.submit(tasks[:2])
    owner.poll()
    row = owner.export_row(bufs[0])
    assert row is not None and row.event is not None
    owner.submit(tasks[2:])  # writes the exported row in place, on the owner's stream
    owner.poll()
    owner.close()
    row.event.synchronize()
    sbufs, stasks = _joins(device, n_chains=1, rounds=2)
    run_serial(stasks[:2], device=device)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(row.value.cpu().numpy().view(np.int32),
                                  sbufs[0].value.cpu().numpy().view(np.int32))
    assert not torch.equal(row.value, bufs[0].value)


def test_threaded_stress_on_real_streams(device):
    """``tests/test_torch_threaded_stress.py``'s shape: 8 workers, each on
    its own CUDA stream, over the 200-task dense stream."""
    sbufs, stasks = _stream(device, 42, 200, 4, n_bufs=10)
    run_serial(stasks, device=device)
    bufs, tasks = _stream(device, 42, 200, 4, n_bufs=10)
    report = ThreadedStreamScheduler(window_size=32, num_streams=8, device=device).run(tasks)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits_of(bufs), _bits_of(sbufs))
    assert report.exec_stats["tasks_run"] == report.window_stats["retired"] == 200


# ---------------------------------------------------------------------------
# Training: flash attention's backward, its forward's row log-sum-exp, and
# the wrappers that have no backward refusing to run under grad
# ---------------------------------------------------------------------------

# (b, h, hkv, sq, sk, d) and masks: minicpm-2b's training shape cut to one
# batch row, GQA, the window, prefix and softcap, a ragged Sk (a chunk at
# q_offset), rows that see no key (a whole query tile of them), no causal
# mask, and widths off the 64/128 padding and the 16-byte copies.
FLASH_BWD = {
    "minicpm": ((1, 36, 36, 512, 512, 64), {}),
    "gqa": ((2, 8, 2, 130, 130, 64), {}),
    "window": ((1, 4, 4, 200, 200, 64), {"window": 50}),
    "prefix_d128": ((1, 4, 1, 150, 150, 128), {"prefix_len": 70}),
    "softcap_gqa_d128": ((1, 4, 2, 97, 97, 128), {"softcap": 2.0}),
    "ragged_chunk": ((1, 4, 2, 33, 300, 64), {"q_offset": 267}),
    "blind_rows": ((1, 2, 1, 100, 100, 64), {"q_offset": -70}),
    "noncausal_window": ((1, 2, 2, 100, 77, 64), {"causal": False, "window": 20}),
    "d24": ((2, 4, 2, 70, 70, 24), {}),
    "d120_window_prefix": ((1, 4, 4, 129, 129, 120), {"window": 40, "prefix_len": 9}),
    "d8": ((1, 2, 1, 65, 65, 8), {"causal": False}),
    # D 256: recurrentgemma-2b's training shape cut to one batch row, a
    # window that binds, paligemma-3b's prefix, softcap, blind rows, and
    # D 200 / 136 (the second column slice part empty).
    "recurrentgemma_d256": ((1, 10, 1, 512, 512, 256), {"window": 2048}),
    "window_d256": ((1, 4, 1, 300, 300, 256), {"window": 100}),
    "paligemma_prefix_d256": ((1, 8, 1, 320, 320, 256), {"prefix_len": 256}),
    "softcap_d256": ((1, 4, 2, 97, 97, 256), {"softcap": 2.0}),
    "blind_rows_d256": ((1, 2, 1, 100, 100, 256), {"q_offset": -70}),
    "ragged_d200": ((1, 4, 2, 65, 130, 200), {"q_offset": 65}),
    "noncausal_d136": ((2, 4, 4, 70, 70, 136), {"causal": False, "window": 20}),
    # Rows TMA cannot address (D 36: 72-byte rows): padded copies.
    "d36": ((1, 4, 2, 70, 70, 36), {}),
    # Dv != D (a seventh entry, v's width): deepseek-v2's MLA cut to one
    # batch row and 16 heads, a ragged Sk, GQA with a window, the reduced
    # MLA's 16 / 8, and Dv 36 off the 16-byte rows (padded copies).
    "mla": ((1, 16, 16, 512, 512, 192, 128), {}),
    "mla_ragged": ((1, 4, 2, 97, 150, 192, 128), {"q_offset": 53}),
    # keys 97.. follow every query row: the last key tile no query sees
    "mla_unseen_keys": ((1, 4, 2, 97, 150, 192, 128), {}),
    "mla_gqa_window": ((1, 8, 2, 130, 130, 192, 128), {"window": 40}),
    "mla_reduced": ((2, 4, 4, 70, 70, 16, 8), {"prefix_len": 9}),
    "mla_dv36": ((1, 4, 2, 70, 70, 64, 36), {}),
}
# float32: summation order only, 1e-4 of the largest gradient entry.
# bfloat16 / float16: P and dS are rounded to the input type (2^-9) before
# their products, and the gradients once more on the way out: 2e-2 of the
# largest entry.
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}


def _bwd_inputs(device, name, dtype):
    shape, flags = FLASH_BWD[name]
    b, h, hkv, sq, sk, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    rng = np.random.RandomState(sum(map(ord, name)))
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    return make(b, h, sq, d), make(b, hkv, sk, d), make(b, hkv, sk, dv), make(b, h, sq, dv), flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(FLASH_BWD))
def test_flash_backward_matches_plain(device, name, dtype):
    """The backward kernel against ``attention_bwd_ref`` on the same q, k,
    v, dO and the forward kernel's o and lse; lse against
    ``attention_lse_ref``; the same bits on a second launch."""
    from repro_torch.kernels.ref import attention_bwd_ref, attention_lse_ref

    q, k, v, do, flags = _bwd_inputs(device, name, dtype)
    out, lse = fa.flash_attention_lse(q, k, v, **flags)
    torch.testing.assert_close(lse, attention_lse_ref(q, k, **flags), rtol=1e-4, atol=1e-4)
    before = fa.backward_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
    torch.cuda.synchronize()
    assert fa.backward_launches == before + 1
    want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
    for name_, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name_
        err = float((g.float() - w).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * float(w.abs().max()), (name_, err)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def _offset_copy(t, offset):
    """``t`` copied into a buffer ``offset`` elements in (contiguous, and
    for an odd offset of a 16-bit type not 16-byte aligned)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


# (case, elements q and dO sit into their buffers, the path it must take):
# the wgmma path at recurrentgemma's 10 heads over one kv head (the plan
# splits each key tile), minicpm's 36 over 36 (no split) and a ragged last
# key tile; aligned, padded copies on the wgmma path for pointers off
# 16-byte alignment at each tile width (64, 128, 256) and for D 36.
FLASH_BWD_PATHS = [
    ("recurrentgemma_d256", 0, "wgmma"),
    ("minicpm", 0, "wgmma"),
    ("gqa", 0, "wgmma"),
    ("gqa", 1, "wgmma_padded"),
    ("softcap_gqa_d128", 1, "wgmma_padded"),
    ("prefix_d128", 3, "wgmma_padded"),
    ("softcap_d256", 1, "wgmma_padded"),
    ("d36", 0, "wgmma_padded"),
    ("mla", 0, "wgmma"),
    ("mla_gqa_window", 1, "wgmma_padded"),
    ("mla_dv36", 0, "wgmma_padded"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,offset,path", FLASH_BWD_PATHS)
def test_flash_backward_takes_its_path(device, name, offset, path, dtype):
    """Each 16-bit call goes by the shape rule to the wgmma kernels on its
    tensors or on padded copies (counted once, launch counter once), within
    tolerance of the plain version, the same bits on a second launch."""
    from repro_torch.kernels.ref import attention_bwd_ref

    q, k, v, do, flags = _bwd_inputs(device, name, dtype)
    if offset:
        q, do = _offset_copy(q, offset), _offset_copy(do, offset)
    out, lse = fa.flash_attention_lse(q, k, v, **flags)
    assert fa.backward_path(q, k, v, out, do) == path
    before, paths = fa.backward_launches, dict(fa.backward_paths)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
    torch.cuda.synchronize()
    assert fa.backward_launches == before + 1
    assert {p: fa.backward_paths[p] - paths[p] for p in paths} == {
        p: int(p == path) for p in paths}
    want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
    for name_, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * float(w.abs().max()), (name_, err)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("n_sm", [3, 132])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_persistent_walks_many_units(device, monkeypatch, n_sm, dtype):
    """MLA's widths run both passes persistent: with the plans narrowed to
    3 SMs each block walks hundreds of key-tile units (its k / v buffers
    alternating, the ring's phases running on across units) and of dQ
    units, within tolerance of the plain version, the same bits twice; a
    ragged Sk whose last key tile no query sees (causal, Sq 97 < Sk 150)
    gives zeros for every key past the last row."""
    from repro_torch.kernels.ref import attention_bwd_ref

    monkeypatch.setattr(fa, "_sm_count", lambda dev: n_sm)
    monkeypatch.setattr(fa, "_PLANS", type(fa._PLANS)())
    for name in ("mla", "mla_unseen_keys"):
        q, k, v, do, flags = _bwd_inputs(device, name, dtype)
        out, lse = fa.flash_attention_lse(q, k, v, **flags)
        plan = fa.backward_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                                q.shape[3], n_sm=n_sm, dv=v.shape[3], **flags)
        assert plan.grid == min(n_sm, len(plan.blocks)) and plan.dq_grid == min(n_sm,
                                                                                  plan.dq_blocks)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
        want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
        torch.cuda.synchronize()
        for name_, g, w in zip(("dq", "dk", "dv"), got, want):
            err = float((g.float() - w).abs().max())
            assert err <= FLASH_BWD_TOL[dtype] * float(w.abs().max()), (name, name_, err)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
        if name == "mla_unseen_keys":
            assert bool((got[1][:, :, 97:] == 0).all()) and bool((got[2][:, :, 97:] == 0).all())


def test_flash_backward_float16(device):
    from repro_torch.kernels.ref import attention_bwd_ref

    q, k, v, do, flags = _bwd_inputs(device, "softcap_gqa_d128", torch.float16)
    out, lse = fa.flash_attention_lse(q, k, v, **flags)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **flags)
    want = attention_bwd_ref(q, k, v, out, lse, do, **flags)
    for g, w in zip(got, want):
        assert float((g.float() - w).abs().max()) <= 2e-2 * float(w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_leaves_the_forward_bits(device, dtype):
    q, k, v, _, flags = _bwd_inputs(device, "window", dtype)
    out, _ = fa.flash_attention_lse(q, k, v, **flags)
    assert torch.equal(fa.flash_attention(q, k, v, **flags), out)
    blind_q, blind_k, blind_v, _, blind = _bwd_inputs(device, "blind_rows", dtype)
    _, lse = fa.flash_attention_lse(blind_q, blind_k, blind_v, **blind)
    assert bool(torch.isneginf(lse[:, :, :70]).all()) and bool(torch.isfinite(lse[:, :, 70:]).all())


@pytest.mark.parametrize("name", ["blind_rows", "mla_ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_goes_through_both_kernels(device, dtype, name):
    """``flash_attention`` on inputs that need a gradient (MLA's D 192 /
    Dv 128 too): one forward and one backward launch, gradients within
    tolerance of autograd through ``attention_ref``, a blind row's
    gradient exactly 0."""
    q, k, v, do, flags = _bwd_inputs(device, name, dtype)
    grads = []
    for fn in (fa.flash_attention, attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (fa.launches, fa.backward_launches)
        fn(*leaves, **flags).backward(do)
        torch.cuda.synchronize()
        launched = (fa.launches - before[0], fa.backward_launches - before[1])
        assert launched == ((1, 1) if fn is fa.flash_attention else (0, 0))
        grads.append([t.grad for t in leaves])
    for g, w in zip(*grads):
        assert bool(torch.isfinite(g).all())
        err = float((g.float() - w.float()).abs().max())
        assert err <= FLASH_BWD_TOL[dtype] * float(w.float().abs().max()) + 1e-6
    if name == "blind_rows":
        assert bool((grads[0][0][:, :, :70] == 0).all())
    with torch.no_grad():  # no gradient: the serving call, no backward state
        before = fa.launches
        fa.flash_attention(*[t.clone().requires_grad_(True) for t in (q, k, v)], **flags)
        assert fa.launches == before + 1


# The selective scan's backward, (B, S, E, N): falcon-mamba-7b's training
# shape cut to one batch row, S 1, S off the 64-step chunk with B > 1, E
# off the 32-channel tile with N < 16, one whole chunk, N 1.
SCAN_BWD = [(1, 512, 8192, 16), (1, 1, 64, 16), (3, 129, 1000, 5), (2, 513, 40, 16),
            (4, 64, 96, 16), (1, 200, 37, 1)]
# Each gradient within this share of its largest entry: float32 1e-5 (the
# kernel's shuffle scans and its sums over channels, lanes, chunks and
# batch rows run in other orders than the plain reverse loop, and its decay
# is ex2.approx); bf16 2^-7 (both round each gradient to bf16 once from
# float32: one bf16 ulp, 2^-8 of the entry).
SCAN_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _scan_bwd_inputs(device, b, s, e, n, dtype, rank=8):
    """The fused entry's arguments as a Mamba layer passes them (z, b and c
    slices of wider projections), and the gradients of y and hT."""
    rng = np.random.RandomState(1000 * b + s + e + n)
    f = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)  # noqa: E731
    xz, proj = f(b, s, 2 * e).to(dtype), f(b, s, rank + 2 * n).to(dtype)
    a_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))[None]
             + 0.1 * f(e, n))
    args = (f(b, s, e).to(dtype), 0.5 * f(e), torch.nn.functional.silu(f(b, s, e)).to(dtype),
            xz[..., e:], proj[..., rank: rank + n], proj[..., rank + n:], a_log.contiguous(),
            f(e), f(b, e, n))
    return args, f(b, s, e).to(dtype), f(b, e, n)


def _within(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol(g) * float(w.float().abs().max()) + 1e-30, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,e,n", SCAN_BWD)
def test_mamba_scan_backward_matches_plain(device, b, s, e, n, dtype):
    """``mamba_scan_bwd`` (the fused entry's nine gradients) against
    ``mamba_scan_bwd_ref``, hT's gradient given; the forward that saves the
    chunk states keeps the serving call's bits; the same bits on a second
    launch; counted once."""
    from repro_torch.kernels.ref import mamba_scan_bwd_ref

    args, dy, dht = _scan_bwd_inputs(device, b, s, e, n, dtype)
    y, ht, states = ss.mamba_scan_fwd(*args)
    serve = ss.mamba_scan(*args)
    assert torch.equal(y, serve[0]) and torch.equal(ht, serve[1])
    before = ss.backward_launches
    got = ss.mamba_scan_bwd(*args, states, dy, dht)
    torch.cuda.synchronize()
    assert ss.backward_launches == before + 1
    want = mamba_scan_bwd_ref(*args, dy, dht)
    _within(got, want, lambda g: SCAN_BWD_TOL[g.dtype])
    again = ss.mamba_scan_bwd(*args, states, dy, dht)
    assert all(torch.equal(u, w) for u, w in zip(again, got))


@pytest.mark.parametrize("b,s,e,n", SCAN_BWD)
def test_selective_scan_backward_matches_plain(device, b, s, e, n):
    """``selective_scan_bwd`` (the scan alone, float32) against
    ``selective_scan_bwd_ref``, with and without hT's gradient."""
    from repro_torch.kernels.ref import selective_scan_bwd_ref

    args, _, dht = _scan_bwd_inputs(device, b, s, e, n, torch.float32)
    dt = torch.nn.functional.softplus(args[0])
    a = -torch.exp(args[6])
    bm, cm = args[4].contiguous(), args[5].contiguous()
    x, h0 = args[2], args[8]
    ys, ht, states = ss.selective_scan_fwd(dt, x, bm, cm, a, h0)
    dys = torch.randn_like(ys)
    for g_ht in (None, dht):
        got = ss.selective_scan_bwd(dt, x, bm, cm, a, h0, states, dys, g_ht)
        want = selective_scan_bwd_ref(dt, x, bm, cm, a, h0, dys, g_ht)
        _within(got, want, lambda g: SCAN_BWD_TOL[torch.float32])


# The backward's chunk edges: one step, one whole 64-step chunk, one step
# past it and falcon-mamba's 512 (8 chunks), at N 16 and an odd N.
SCAN_BWD_EDGES = [(2, s, 96, n) for s in (1, 64, 65, 512) for n in (16, 7)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("b,s,e,n", SCAN_BWD_EDGES)
def test_scan_backward_chunk_edges(device, b, s, e, n, fused):
    """The backward at S 1, 64, 65 and 512 (its chunks' edges: the chunk
    buffers alternate, the last chunk ragged), N 16 and 7, fused (bf16)
    and the scan alone (float32): within tolerance of the plain version,
    the same bits on a second launch, and a workspace of the size the
    Python mirror gives."""
    from repro_torch.kernels.ref import mamba_scan_bwd_ref, selective_scan_bwd_ref

    dtype = torch.bfloat16 if fused else torch.float32
    args, dy, dht = _scan_bwd_inputs(device, b, s, e, n, dtype)
    lib = ss._LIB.get()
    sizes = ss._SIZES(ss.FUSED[dtype] if fused else ss.PLAIN, b, s, e, n)
    assert lib.acs_mamba_scan_bwd_workspace(sizes) == ss.scan_bwd_workspace(b, s, e, n)
    if fused:
        _, _, states = ss.mamba_scan_fwd(*args)
        got = ss.mamba_scan_bwd(*args, states, dy, dht)
        again = ss.mamba_scan_bwd(*args, states, dy, dht)
        want = mamba_scan_bwd_ref(*args, dy, dht)
    else:
        dt = torch.nn.functional.softplus(args[0].float())
        scan = (dt, args[2], args[4].contiguous(), args[5].contiguous(), -torch.exp(args[6]),
                args[8])
        _, _, states = ss.selective_scan_fwd(*scan)
        dys = dy.float()
        got = ss.selective_scan_bwd(*scan, states, dys, dht)
        again = ss.selective_scan_bwd(*scan, states, dys, dht)
        want = selective_scan_bwd_ref(*scan, dys, dht)
    torch.cuda.synchronize()
    _within(got, want, lambda g: SCAN_BWD_TOL[g.dtype])
    assert all(torch.equal(u, w) for u, w in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_autograd_goes_through_its_kernels(device, dtype):
    """``mamba_scan`` and ``selective_scan`` on inputs that need a gradient:
    one forward and one backward launch each, every leaf's gradient within
    tolerance of autograd through the plain version (z, b and c slices of
    wider projections get theirs through autograd's slicing)."""
    from repro_torch.kernels.ref import mamba_scan_ref, selective_scan_ref

    b, s, e, n = 2, 130, 96, 16
    args, dy, _ = _scan_bwd_inputs(device, b, s, e, n, dtype)
    xz, proj = args[3]._base, args[4]._base
    leaves = (args[0], args[1], args[2], xz, proj, args[6], args[7], args[8])
    grads = []
    for fn in (ss.mamba_scan, mamba_scan_ref):
        ps = [t.detach().clone().requires_grad_(True) for t in leaves]
        before = (ss.launches, ss.backward_launches)
        y, _ = fn(ps[0], ps[1], ps[2], ps[3][..., e:], ps[4][..., 8: 8 + n], ps[4][..., 8 + n:],
                  ps[5], ps[6], ps[7])
        grads.append(torch.autograd.grad(y, ps, dy))
        torch.cuda.synchronize()
        launched = (ss.launches - before[0], ss.backward_launches - before[1])
        assert launched == ((1, 1) if fn is ss.mamba_scan else (0, 0))
    _within(*grads, lambda g: SCAN_BWD_TOL[g.dtype])
    scan = [torch.nn.functional.softplus(args[0].float()), args[2].float(),
            args[4].float().contiguous(), args[5].float().contiguous(), -torch.exp(args[6]),
            args[8]]
    grads = []
    for fn in (ss.selective_scan, selective_scan_ref):
        ps = [t.detach().clone().requires_grad_(True) for t in scan]
        ys, ht = fn(*ps)
        grads.append(torch.autograd.grad((ys * ys).sum() + ht.sum(), ps))
    _within(*grads, lambda g: SCAN_BWD_TOL[torch.float32])


# (G, K, N, block_m, tile group ids) for the grouped GEMM's backward:
# granite's training shape cut to 8 experts, repeated groups and groups no
# tile names, block_m 1, 8, 24 (deepseek-v2's capacity), 70 and 512, K and
# N off the 8-element copies and the 128- and 256-wide tiles, and more
# groups than the wgmma dw kernel takes in one launch. Tolerances of the
# largest entry: float32 1e-5 (summation order), float16 / bfloat16 8e-3
# (rounded once to the type).
GMM_BWD = {
    "granite_cut": (8, 1536, 512, 512, tuple(range(8))),
    "groups_past_one_launch": (4100, 16, 24, 4, (4099, 0, 4096, 4095, 4099, 7)),
    "repeats_unused": (6, 72, 40, 8, (0, 3, 3, 0, 5, 3)),
    "bm1_off_edges": (5, 37, 131, 1, (4, 0, 4, 2, 2, 4, 0)),
    "bm1_aligned": (5, 64, 40, 1, (4, 0, 4, 2, 2, 4, 0)),
    "bm24_deepseek_c": (4, 136, 64, 24, (3, 0, 1, 3)),
    "bm70": (3, 328, 72, 70, (2, 0, 2)),
    "bm70_off_edges": (4, 130, 264, 70, (3, 1, 3)),
    "bm512_off_tiles": (3, 200, 136, 512, (2, 2, 0)),
    "two_dispatch_groups": (8, 256, 96, 64, tuple(range(8)) * 2),
}
GMM_BWD_TOL = {torch.float32: 1e-5, torch.float16: 8e-3, torch.bfloat16: 8e-3}

# (case, elements x sits into its buffer, dw's path): the wgmma path on the
# aligned cases (repeated groups and groups no tile names among them);
# aligned, padded copies for K or N off the 8-element rows, for x off
# 16-byte alignment and over runs of groups for G past DW_MAX_GROUPS.
GMM_DW_PATHS = [
    ("granite_cut", 0, "wgmma"),
    ("repeats_unused", 0, "wgmma"),
    ("two_dispatch_groups", 0, "wgmma"),
    ("bm512_off_tiles", 0, "wgmma"),
    ("bm1_off_edges", 0, "wgmma_padded"),
    ("granite_cut", 1, "wgmma_padded"),
    ("repeats_unused", 3, "wgmma_padded"),
    ("groups_past_one_launch", 0, "wgmma_padded"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,offset,path", GMM_DW_PATHS)
def test_grouped_matmul_dw_takes_its_path(device, name, offset, path, dtype):
    """dw by the shape rule on the wgmma kernel (the persistent grid), on x
    and dy or on padded copies: counted once, within tolerance of the
    plain version, a group no tile names exactly 0, the same bits twice."""
    g, k, n, bm, tiles = GMM_BWD[name]
    rng = np.random.RandomState(sum(map(ord, name)) + offset)
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    x, w, dy = make(len(tiles) * bm, k), make(g, k, n), make(len(tiles) * bm, n)
    if offset:
        x = _offset_copy(x, offset)
    tg = torch.tensor(tiles, dtype=torch.int32, device=device)
    before, paths = gm.dw_launches, dict(gm.dw_paths)
    _, dw = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm, need_dx=False)
    torch.cuda.synchronize()
    assert gm.dw_launches == before + 1
    assert {p: gm.dw_paths[p] - paths[p] for p in paths} == {p: int(p == path) for p in paths}
    want = grouped_matmul_bwd_ref(x, w, tg, dy, block_m=bm)[1]
    err = float((dw.float() - want.float()).abs().max())
    assert err <= GMM_BWD_TOL[dtype] * float(want.float().abs().max()), err
    for unused in set(range(g)) - set(tiles):
        assert bool((dw[unused] == 0).all())
    again = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm, need_dx=False)[1]
    assert torch.equal(again, dw)


# (case, elements dy sits into its buffer, dx's path): the wgmma path on
# the aligned cases (block_m 1, 8, 24, 70 and 512; 4,100 groups: dx has no
# group limit); aligned, padded copies for K or N off the 8-element rows
# and for dy off 16-byte alignment.
GMM_DX_PATHS = [
    ("granite_cut", 0, "wgmma"),
    ("repeats_unused", 0, "wgmma"),
    ("bm1_aligned", 0, "wgmma"),
    ("bm24_deepseek_c", 0, "wgmma"),
    ("bm70", 0, "wgmma"),
    ("bm512_off_tiles", 0, "wgmma"),
    ("two_dispatch_groups", 0, "wgmma"),
    ("groups_past_one_launch", 0, "wgmma"),
    ("bm1_off_edges", 0, "wgmma_padded"),
    ("bm70_off_edges", 0, "wgmma_padded"),
    ("granite_cut", 1, "wgmma_padded"),
    ("bm24_deepseek_c", 3, "wgmma_padded"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,offset,path", GMM_DX_PATHS)
def test_grouped_matmul_dx_takes_its_path(device, name, offset, path, dtype):
    """dx by the shape rule on the wgmma kernel (the persistent grid of
    ``dx_plan``), on dy and w or on padded copies: counted once on its
    path, within tolerance of the plain version, the same bits twice."""
    g, k, n, bm, tiles = GMM_BWD[name]
    rng = np.random.RandomState(sum(map(ord, name)) + offset + 1)
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    x, w, dy = make(len(tiles) * bm, k), make(g, k, n), make(len(tiles) * bm, n)
    if offset:
        dy = _offset_copy(dy, offset)
    tg = torch.tensor(tiles, dtype=torch.int32, device=device)
    before, paths = gm.dx_launches, dict(gm.dx_paths)
    dx, _ = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm, need_dw=False)
    torch.cuda.synchronize()
    assert gm.dx_launches == before + 1
    assert {p: gm.dx_paths[p] - paths[p] for p in paths} == {p: int(p == path) for p in paths}
    want = grouped_matmul_bwd_ref(x, w, tg, dy, block_m=bm)[0]
    assert dx.dtype == dtype and dx.shape == want.shape
    err = float((dx.float() - want.float()).abs().max())
    assert err <= GMM_BWD_TOL[dtype] * float(want.float().abs().max()), err
    again = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm, need_dw=False)[0]
    assert torch.equal(again, dx)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("width", [256, 128])
def test_grouped_matmul_dx_bad_group_ids_write_zeros(device, width, dtype):
    """The C entry on the wgmma path, at either tile width: a tile whose
    group id lies outside [0, G) (-1, G) is all zeros and sets err; the
    others are the plain version's."""
    g, k, n, bm = 4, 264, 136, 16
    tiles = (0, -1, 3, 4, 1)
    rng = np.random.RandomState(width)
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    w, dy = make(g, k, n), make(len(tiles) * bm, n)
    dx = torch.full((len(tiles) * bm, k), 7.0, dtype=dtype, device=device)
    tg = torch.tensor(tiles, dtype=torch.int32, device=device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    plan = gm.dx_plan(dx.shape[0], k, bm, 132, widths=(width,))
    rc = gm._LIB.get().acs_grouped_matmul_dx(
        dy.data_ptr(), w.data_ptr(), tg.data_ptr(), dx.data_ptr(), err.data_ptr(), dx.shape[0],
        k, n, g, bm, 1 if dtype == torch.bfloat16 else 2, plan.grid, plan.width,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and int(err[0]) == 1
    for t, gid in enumerate(tiles):
        rows = dx[t * bm:(t + 1) * bm]
        if 0 <= gid < g:
            want = (dy[t * bm:(t + 1) * bm].float() @ w[gid].float().t())
            tol = GMM_BWD_TOL[dtype] * float(want.abs().max())
            assert float((rows.float() - want).abs().max()) <= tol
        else:
            assert bool((rows == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(GMM_BWD))
def test_grouped_matmul_backward_matches_plain(device, name, dtype):
    g, k, n, bm, tiles = GMM_BWD[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    x, w, dy = make(len(tiles) * bm, k), make(g, k, n), make(len(tiles) * bm, n)
    tg = torch.tensor(tiles, dtype=torch.int32, device=device)
    before = (gm.dx_launches, gm.dw_launches)
    got = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm)
    torch.cuda.synchronize()
    assert (gm.dx_launches, gm.dw_launches) == (before[0] + 1, before[1] + 1)
    want = grouped_matmul_bwd_ref(x, w, tg, dy, block_m=bm)
    for label, a, b in zip(("dx", "dw"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, label
        err = float((a.float() - b.float()).abs().max())
        assert err <= GMM_BWD_TOL[dtype] * float(b.float().abs().max()), (label, err)
    for unused in set(range(g)) - set(tiles):
        assert bool((got[1][unused] == 0).all())
    again = gm.grouped_matmul_bwd(x, w, tg, dy, block_m=bm)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_autograd_goes_through_its_kernels(device, dtype):
    """Under grad: one forward, one dx and one dw launch; gradients within
    tolerance of autograd through ``grouped_matmul_ref``; only the inputs
    that need one get a gradient."""
    x0, w0, tiles, bm = _gmm_inputs(device, "ragged", dtype)
    dy = torch.randn(x0.shape[0], w0.shape[2], device=device).to(dtype)
    grads = []
    for fn in (gm.grouped_matmul, grouped_matmul_ref):
        x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
        before = (gm.launches, gm.dx_launches, gm.dw_launches)
        fn(x, w, tiles, block_m=bm).backward(dy)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip((gm.launches, gm.dx_launches, gm.dw_launches),
                                                before))
        assert launched == ((1, 1, 1) if fn is gm.grouped_matmul else (0, 0, 0))
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        err = float((a.float() - b.float()).abs().max())
        assert err <= GMM_BWD_TOL[dtype] * float(b.float().abs().max()) + 1e-6
    w = w0.clone().requires_grad_(True)
    before = (gm.dx_launches, gm.dw_launches)
    gm.grouped_matmul(x0, w, tiles, block_m=bm).backward(dy)
    torch.cuda.synchronize()
    assert (gm.dx_launches, gm.dw_launches) == (before[0], before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2560, 1000, 7])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 512])
@pytest.mark.parametrize("b", [1, 4])
def test_lru_scan_reverse_bit_equal_to_plain(device, b, s, d, dtype):
    rng = np.random.RandomState(b * 11 + s + d)
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (b, s, d)).astype(np.float32)).to(device, dtype)
    h0 = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(device)
    h = ls.lru_scan(a, make(b, s, d), h0)
    dh = make(b, s, d)
    before = ls.backward_launches
    got = ls.lru_scan_bwd(a, h, h0, dh)
    torch.cuda.synchronize()
    assert ls.backward_launches == before + 1
    for name, x, y in zip(("da", "db", "dh0"), got, lru_scan_bwd_ref(a, h, h0, dh)):
        assert x.dtype == y.dtype and torch.equal(_int_bits(x), _int_bits(y)), name


def test_lru_scan_autograd_goes_through_its_kernels(device):
    """Under grad: one forward and one reverse launch, the gradients
    bit-equal to autograd through ``lru_scan_ref`` (float32), dh0 only for
    an h0 that needs one."""
    rng = np.random.RandomState(5)
    a0 = torch.from_numpy(rng.uniform(0.5, 0.99, (2, 70, 40)).astype(np.float32)).to(device)
    b0, dh = (torch.from_numpy(rng.randn(2, 70, 40).astype(np.float32)).to(device)
              for _ in range(2))
    h00 = torch.from_numpy(rng.randn(2, 40).astype(np.float32)).to(device)
    for need_h0 in (False, True):
        grads = []
        for fn in (ls.lru_scan, lru_scan_ref):
            a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
            h0 = h00.clone().requires_grad_(need_h0)
            before = (ls.launches, ls.backward_launches)
            fn(a, b, h0).backward(dh)
            torch.cuda.synchronize()
            launched = (ls.launches - before[0], ls.backward_launches - before[1])
            assert launched == ((1, 1) if fn is ls.lru_scan else (0, 0))
            grads.append((a.grad, b.grad, h0.grad))
        assert (grads[0][2] is not None) == need_h0
        for x, y in zip(*grads):
            assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("name", ["minicpm-2b", "gemma2-27b", "h2o-danube-3-4b",
                                  "musicgen-large", "granite-moe-3b-a800m",
                                  "recurrentgemma-2b", "paligemma-3b", "deepseek-v2-236b",
                                  "falcon-mamba-7b"])
def test_train_gradients_on_the_card_match_the_cpu(device, name):
    """A reduced float32 config's loss and every weight's gradient through
    flash (MLA's Dv != D too), the grouped GEMM, the RG-LRU scan and the
    selective scan and their backward kernels
    on the card against the same weights' on the CPU (the plain versions
    and their plain backward): 1e-5 relative
    on the loss, 1e-4 of each leaf's largest entry (summation order); the
    card's remat gives the bits of no remat (every kernel deterministic)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params, loss_and_grads
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.tree import tree_leaves_with_names

    cfg = ARCHS[name].reduced()
    cpu = init_params(cfg, 0, device="cpu", tp_size=1).requires_grad_(True)
    card = params_from_numpy(params_to_numpy(cpu), cfg, device=device).requires_grad_(True)
    rng = np.random.RandomState(7)
    if cfg.frontend:
        from repro_torch.models import FRONTEND_DIMS
        inputs = torch.from_numpy(rng.randn(2, 24, FRONTEND_DIMS[cfg.frontend]).astype(np.float32))
    else:
        inputs = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 24)).astype(np.int32))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 24)).astype(np.int32))
    want_loss, want = loss_and_grads(cpu, cfg, inputs, labels)
    for mod in (fa, gm, ls, ss):
        mod.reset_launches()
    loss, got = loss_and_grads(card, cfg, inputs.to(device), labels.to(device))
    torch.cuda.synchronize()
    attends = any(kind.startswith("attn") or kind == "mla" for kind in cfg.pattern)
    assert (fa.launches > 0 and fa.backward_launches > 0) == attends
    assert (gm.dx_launches > 0 and gm.dw_launches > 0) == (cfg.moe is not None)
    assert (ls.backward_launches > 0) == ("rglru" in cfg.pattern)
    assert (ss.launches > 0 and ss.backward_launches > 0) == ("mamba" in cfg.pattern)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    mine, theirs = tree_leaves_with_names(got), tree_leaves_with_names(want)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (leaf, g), (_, w) in zip(mine, theirs):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-7, (leaf, err)
    loss_b, no_remat = loss_and_grads(card, cfg, inputs.to(device), labels.to(device),
                                      remat=False)
    assert torch.equal(loss, loss_b)
    for (_, a), (_, b) in zip(mine, tree_leaves_with_names(no_remat)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The torch.library ops against the launch functions under them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_ops_give_the_launch_path_bits_and_counts(device, dtype):
    """``flash_attention`` (the op ``flash_attention``), under grad (the op
    ``flash_attention_lse`` and its autograd, the op
    ``flash_attention_bwd``) and the lse and backward entries give the
    bits of ``_forward`` and ``_backward`` called directly, one launch
    each, as before the ops."""
    gen = torch.Generator(device=device).manual_seed(3)
    q = torch.randn(2, 8, 96, 64, generator=gen, device=device).to(dtype)
    k = torch.randn(2, 4, 96, 64, generator=gen, device=device).to(dtype)
    v = torch.randn(2, 4, 96, 64, generator=gen, device=device).to(dtype)
    do = torch.randn(2, 8, 96, 64, generator=gen, device=device).to(dtype)
    masks, scale = fa._masks(True, None, None, 0, 0), 64 ** -0.5
    want, want_lse = fa._forward(q, k, v, masks, scale, True)
    want_d = fa._backward(q, k, v, want, want_lse, do, masks, scale)
    fa.reset_launches()
    assert torch.equal(fa.flash_attention(q, k, v), want) and fa.launches == 1
    out, lse = fa.flash_attention_lse(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse) and fa.launches == 2
    got = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want_d)) and fa.backward_launches == 1
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves)
    assert torch.equal(out, want) and fa.launches == 3
    out.backward(do)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want_d))
    assert fa.backward_launches == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_matmul_ops_give_the_launch_path_bits_and_counts(device, dtype):
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(6 * 16, 96, generator=gen, device=device).to(dtype)
    w = torch.randn(4, 96, 80, generator=gen, device=device).to(dtype)
    dy = torch.randn(6 * 16, 80, generator=gen, device=device).to(dtype)
    tiles = torch.tensor([0, 1, 1, 3, 2, 0], dtype=torch.int32, device=device)
    err = torch.zeros(1, dtype=torch.int32, device=device)
    want = gm._forward(x, w, tiles, 16, err)
    want_dx, want_dw = gm.grouped_matmul_bwd(x, w, tiles, dy, block_m=16)
    gm.reset_launches()
    assert torch.equal(gm.grouped_matmul(x, w, tiles, block_m=16), want) and gm.launches == 1
    assert torch.equal(gm.grouped_matmul(x, w, tiles, block_m=16, err=err), want)
    xl, wl = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    out = gm.grouped_matmul(xl, wl, tiles, block_m=16, err=err)
    assert torch.equal(out, want) and gm.launches == 3
    out.backward(dy)
    assert torch.equal(xl.grad, want_dx) and torch.equal(wl.grad, want_dw)
    assert (gm.dx_launches, gm.dw_launches) == (1, 1) and int(err) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lru_scan_ops_give_the_launch_path_bits_and_counts(device, dtype):
    """``lru_scan`` (the op ``lru_scan``) and, under grad, its autograd (the
    op ``lru_scan_bwd``) and ``lru_scan_bwd`` give the bits of ``_forward``
    and ``_backward`` called directly, one launch each, as before the
    ops."""
    gen = torch.Generator(device=device).manual_seed(5)
    a = torch.rand(2, 300, 160, generator=gen, device=device).to(dtype)
    b = torch.randn(2, 300, 160, generator=gen, device=device).to(dtype)
    h0 = torch.randn(2, 160, generator=gen, device=device)
    dh = torch.randn(2, 300, 160, generator=gen, device=device).to(dtype)
    want = ls._forward(a, b, h0)
    want_d = ls._backward(a, want, h0, dh)
    ls.reset_launches()
    assert torch.equal(ls.lru_scan(a, b, h0), want) and ls.launches == 1
    got = ls.lru_scan_bwd(a, want, h0, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want_d)) and ls.backward_launches == 1
    leaves = [t.detach().requires_grad_(True) for t in (a, b, h0)]
    out = ls.lru_scan(*leaves)
    assert torch.equal(out, want) and ls.launches == 2
    out.backward(dh)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want_d))
    assert ls.backward_launches == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba_scan_ops_give_the_launch_path_bits_and_counts(device, dtype):
    """``mamba_scan`` (the op ``mamba_scan``: without grad no chunk states,
    under grad the states and, through its autograd, the op
    ``mamba_scan_bwd``) and ``mamba_scan_fwd`` / ``mamba_scan_bwd`` give the
    bits of ``_mamba_forward`` and ``_backward`` called directly on z, b
    and c sliced from their projections, one launch each, as before the
    ops."""
    ss = importlib.import_module("repro_torch.kernels.selective_scan")
    gen = torch.Generator(device=device).manual_seed(6)
    bsz, seq, e, n = 2, 150, 96, 16
    xz = torch.randn(bsz, seq, 2 * e, generator=gen, device=device).to(dtype)
    proj = torch.randn(bsz, seq, 8 + 2 * n, generator=gen, device=device).to(dtype)
    dt_raw = torch.randn(bsz, seq, e, generator=gen, device=device).to(dtype)
    x = torch.randn(bsz, seq, e, generator=gen, device=device).to(dtype)
    dt_bias = 0.5 * torch.randn(e, generator=gen, device=device)
    a_log = torch.rand(e, n, generator=gen, device=device)
    d = torch.randn(e, generator=gen, device=device)
    h0 = torch.randn(bsz, e, n, generator=gen, device=device)
    dy = torch.randn(bsz, seq, e, generator=gen, device=device).to(dtype)
    args = (dt_raw, dt_bias, x, xz[..., e:], proj[..., 8:8 + n], proj[..., 8 + n:], a_log, d,
            h0)
    ready = ss._fused_ready(*args)
    want_y, want_ht, _ = ss._mamba_forward(ready, *args)
    _, _, want_states = ss._mamba_forward(ready, *args, save=True)
    ddt, dx, dz, db, dc, da, dd, dbias, dh0 = ss._backward(
        ready, (dt_raw, x, xz[..., e:], proj[..., 8:8 + n], proj[..., 8 + n:], a_log, dt_bias,
                d, h0), want_states, dy, None, dtype)
    want_d = (ddt, dbias, dx, dz, db, dc, da, dd, dh0)
    ss.reset_launches()
    y, ht = ss.mamba_scan(*args)
    assert torch.equal(y, want_y) and torch.equal(ht, want_ht) and ss.launches == 1
    y, ht, states = ss.mamba_scan_fwd(*args)
    assert torch.equal(y, want_y) and torch.equal(states, want_states) and ss.launches == 2
    got = ss.mamba_scan_bwd(*args, states, dy)
    assert all(torch.equal(g, w) for g, w in zip(got, want_d)) and ss.backward_launches == 1
    leaves = [t.detach().requires_grad_(True) for t in (dt_raw, dt_bias, x, xz, proj, a_log,
                                                         d, h0)]
    dt_l, bias_l, x_l, xz_l, proj_l, alog_l, d_l, h0_l = leaves
    y, _ = ss.mamba_scan(dt_l, bias_l, x_l, xz_l[..., e:], proj_l[..., 8:8 + n],
                         proj_l[..., 8 + n:], alog_l, d_l, h0_l)
    assert torch.equal(y, want_y) and ss.launches == 3
    y.backward(dy)
    assert ss.backward_launches == 2
    for got_g, want_g in ((dt_l.grad, ddt), (bias_l.grad, dbias), (x_l.grad, dx),
                          (xz_l.grad[..., e:], dz), (proj_l.grad[..., 8:8 + n], db),
                          (proj_l.grad[..., 8 + n:], dc), (alog_l.grad, da), (d_l.grad, dd),
                          (h0_l.grad, dh0)):
        assert torch.equal(got_g, want_g)


# ---------------------------------------------------------------------------
# The optimizer: the fused clip and AdamW update (kernels/adamw.py)
# ---------------------------------------------------------------------------

def _opt_leaves(device, specs, seed=0):
    """Params, gradients and AdamW state over ``specs`` ((numel, dtype,
    offset) each): every tensor a contiguous view ``offset`` elements into
    its storage; master a copy of the params, m and v small positive."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def view(n, dtype, offset, fill):
        base = torch.empty(n + offset, dtype=dtype, device=device)
        t = base[offset:]
        t.copy_(fill)
        return t

    out = {k: [] for k in ("p", "g", "master", "m", "v")}
    for n, dtype, offset in specs:
        po, go, so = offset if isinstance(offset, tuple) else (offset,) * 3
        w = torch.randn(n, generator=gen, device=device)
        out["p"].append(view(n, dtype, po, w.to(dtype)))
        out["master"].append(view(n, torch.float32, so, out["p"][-1].float()))
        out["g"].append(view(n, dtype, go, torch.randn(n, generator=gen, device=device)))
        out["m"].append(view(n, torch.float32, so, 0.01 * torch.randn(n, generator=gen,
                                                                      device=device)))
        out["v"].append(view(n, torch.float32, so, 1e-4 * torch.rand(n, generator=gen,
                                                                     device=device)))
    return out


def _opt_clone(leaves):
    return {k: [t.clone() for t in v] for k, v in leaves.items()}


def _opt_bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _opt_step(leaves, step, scale, lr, fused=True):
    c1 = 1.0 - torch.pow(0.9, torch.full((), float(step), device=scale.device))
    c2 = 1.0 - torch.pow(0.95, torch.full((), float(step), device=scale.device))
    fn = aw.adamw_step if fused else aw.adamw_step_ref
    if not fused:
        lr = torch.as_tensor(lr, dtype=torch.float32, device=scale.device)
    fn(leaves["p"], leaves["g"], leaves["master"], leaves["m"], leaves["v"], scale=scale, c1=c1,
       c2=c2, lr=lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


_OPT_MIXED = [(1, torch.bfloat16, 0), (7, torch.float16, 0), (4097, torch.float32, 0),
              (4097, torch.bfloat16, 0), (100_003, torch.bfloat16, 1), (65_536, torch.float32, 3),
              (70_001, torch.float16, (1, 0, 0)), (33_000, torch.float32, (0, 2, 0)),
              (5, torch.float32, 1), (3 * 32768 + 5, torch.bfloat16, 2)]


@pytest.mark.parametrize("max_norm", [1e9, 0.5])  # a scale of exactly 1, and one below it
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_adamw_fused_bit_equal_to_per_leaf(device, max_norm, lr_kind):
    mine = _opt_leaves(device, _OPT_MIXED)
    theirs = _opt_clone(mine)
    for step in (1, 2, 3):
        gnorm, scale = aw.global_norm(mine["g"], max_norm)
        if max_norm > 1e6:
            assert float(scale) == 1.0
        else:
            assert float(scale) < 1.0
        lr = 1e-3 * step
        lr = torch.tensor(lr, device=device) if lr_kind == "tensor" else lr
        _opt_step(mine, step, scale, lr)
        _opt_step(theirs, step, scale, lr, fused=False)
        torch.cuda.synchronize()
        for key in ("p", "master", "m", "v"):
            for a, b in zip(mine[key], theirs[key]):
                assert a.dtype == b.dtype and torch.equal(_opt_bits(a), _opt_bits(b)), key
        for g in mine["g"] + theirs["g"]:  # the next step's gradients
            g.mul_(-0.5)


def test_adamw_fused_state_rows_follow_the_state(device):
    """The update keeps each state's rows of parameters and state between
    steps: two states in turns, one of them given new m tensors every step,
    and an empty leaf, each step still bit-equal to the per-leaf path."""
    a = _opt_leaves(device, _OPT_MIXED + [(0, torch.bfloat16, 0)], seed=3)
    b = _opt_leaves(device, _OPT_MIXED[::-1], seed=4)
    ref_a, ref_b = _opt_clone(a), _opt_clone(b)
    for step in (1, 2, 3):
        for mine, theirs in ((a, ref_a), (b, ref_b)):
            _, scale = aw.global_norm(mine["g"], 0.5)
            _opt_step(mine, step, scale, 1e-3 * step)
            _opt_step(theirs, step, scale, 1e-3 * step, fused=False)
        a["m"] = [t.clone() for t in a["m"]]
    torch.cuda.synchronize()
    for mine, theirs in ((a, ref_a), (b, ref_b)):
        for key in ("p", "master", "m", "v"):
            for x, y in zip(mine[key], theirs[key]):
                assert torch.equal(_opt_bits(x), _opt_bits(y)), key


def test_adamw_fused_on_a_283m_leaf_beside_small_ones(device):
    """minicpm-2b's tied embedding (122,880 x 2,304: its vocab padded) among small
    leaves."""
    specs = [(2304, torch.bfloat16, 0), (122_880 * 2304, torch.bfloat16, 0),
             (7, torch.bfloat16, 1), (5760 * 2304, torch.bfloat16, 0)]
    mine = _opt_leaves(device, specs, seed=1)
    theirs = _opt_clone(mine)
    gnorm, scale = aw.global_norm(mine["g"], 1.0)
    want_norm, want_scale = aw.global_norm_ref(mine["g"], 1.0)
    assert abs(float(gnorm) - float(want_norm)) <= 1e-6 * float(want_norm)
    _opt_step(mine, 1, scale, 3e-4)
    _opt_step(theirs, 1, scale, 3e-4, fused=False)
    torch.cuda.synchronize()
    for key in ("p", "master", "m", "v"):
        for a, b in zip(mine[key], theirs[key]):
            assert torch.equal(_opt_bits(a), _opt_bits(b)), key


def test_global_norm_close_to_per_leaf_sum_and_the_same_bits(device):
    leaves = _opt_leaves(device, _OPT_MIXED + [(3_000_000, torch.bfloat16, 0)], seed=2)["g"]
    want, want_scale = aw.global_norm_ref(leaves, 1.0)
    exact = torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in leaves))
    first = None
    for _ in range(20):
        gnorm, scale = aw.global_norm(leaves, 1.0)
        got = torch.stack([gnorm, scale]).clone()
        first = got if first is None else first
        assert torch.equal(got.view(torch.int32), first.view(torch.int32))
    assert abs(float(first[0]) - float(want)) <= 1e-6 * float(want)
    assert abs(float(first[0]) - float(exact)) <= 1e-6 * float(exact)
    assert float(first[1]) == pytest.approx(float(want_scale), rel=1e-6)
    for max_norm in (1e9, 0.0):  # the clip's bounds: 1 and 0
        _, scale = aw.global_norm(leaves, max_norm)
        assert float(scale) == (1.0 if max_norm else 0.0)


def test_adamw_fused_launches_a_step_do_not_depend_on_the_leaves(device):
    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

    counts = []
    for n_leaves in (3, 300):
        params = [torch.randn(37 + i, device=device).to(torch.bfloat16) for i in range(n_leaves)]
        grads = [torch.randn_like(p) for p in params]
        state = adamw_init(params)
        aw.reset_launches()
        clipped, _ = clip_by_global_norm(grads, 1.0)
        adamw_update(params, clipped, state, 1e-3)
        counts.append((aw.norm_launches, aw.launches, dict(aw.paths)))
    assert counts == [(2, 1, {"fused": 3, "per_leaf": 0}), (2, 1, {"fused": 300, "per_leaf": 0})]


def test_optimizer_syncs_nothing_and_copies_no_gradient(device):
    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm

    n = 64 * 2 ** 20  # a 64M-element bfloat16 leaf: its float32 copy would be 256 MiB
    params = [torch.randn(n, device=device).to(torch.bfloat16),
              torch.randn(1000, device=device).to(torch.bfloat16)]
    grads = [torch.randn_like(p) for p in params]
    state = adamw_init(params)
    lr = torch.tensor(1e-3, device=device)
    clipped, _ = clip_by_global_norm(grads, 1.0)  # the build and the grid's size, first
    adamw_update(params, clipped, state, lr)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        clipped, gnorm = clip_by_global_norm(grads, 1.0)
        adamw_update(params, clipped, state, lr)
        clipped, gnorm = clip_by_global_norm(grads, 1.0)
        adamw_update(params, clipped, state, 2e-3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 2 ** 20  # tables, scalars, partials
    assert torch.isfinite(gnorm)


def test_adamw_fused_refusals(device):
    good = _opt_leaves(device, [(10, torch.float32, 0)])
    one = torch.ones((), device=device)
    args = dict(scale=None, c1=one, c2=one, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1)
    with pytest.raises(TypeError, match="gradient must be one of"):
        aw.global_norm([torch.ones(4, dtype=torch.float64, device=device)], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        aw.global_norm([torch.ones(4, 4, device=device).t()], 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        aw.global_norm([torch.ones(4, device=device), torch.ones(4)], 1.0)
    with pytest.raises(TypeError, match="master"):
        aw.adamw_step(good["p"], good["g"], [t.double() for t in good["master"]], good["m"],
                      good["v"], **args)
    with pytest.raises(ValueError, match="shape"):
        aw.adamw_step(good["p"], [torch.ones(9, device=device)], good["master"], good["m"],
                      good["v"], **args)
    with pytest.raises(ValueError, match="one CUDA device"):
        aw.adamw_step(good["p"], [t.cpu() for t in good["g"]], good["master"], good["m"],
                      good["v"], **args)
    with pytest.raises(ValueError, match="c1"):
        aw.adamw_step(good["p"], good["g"], good["master"], good["m"], good["v"],
                      **dict(args, c1=one.double()))


def test_train_step_takes_the_fused_optimizer_for_every_leaf(device):
    from repro_torch import trace
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import StepBundle
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    cfg = ARCHS["minicpm-2b"].reduced()
    model = init_params(cfg, 0, device=device, tp_size=1).requires_grad_(True)
    opt = adamw_init(model.param_tree())
    bundle = StepBundle(cfg, lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = [torch.randint(0, cfg.vocab, (2, 32), generator=gen, device=device,
                           dtype=torch.int32) for _ in range(2)]
    bundle.train_step(model, opt, *batch)  # builds and warms
    trace.enable()
    try:
        _, _, out = bundle.train_step(model, opt, *batch)
        got = trace.collect()
    finally:
        trace.disable()
        trace.collect()
    n_leaves = len(tree_leaves(model.param_tree()))
    assert got["launches"]["adamw.paths.fused"] == n_leaves
    assert got["launches"]["adamw.paths.per_leaf"] == 0
    assert got["launches"]["adamw.launches"] == 1 and got["launches"]["adamw.norm_launches"] == 2
    assert torch.isfinite(out["loss"]) and torch.isfinite(out["gnorm"])
