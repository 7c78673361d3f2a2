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
  bits on a second launch;
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
* the wrappers' input checks, and model prefills that launch the kernels.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
first use), so they carry the ``cuda`` marker and skip without a card.
Run them on the card with::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This module imports no JAX: the card's machine has none.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BufferPool, DeviceOpRegistry, DeviceSession, DeviceWindowRunner
from repro_torch.core import SlabArena, Task, run_serial
from repro_torch.core.device_dispatch import _loop_kernel_parts, lower_epoch_program
from repro_torch.core.task import default_segments
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import ready_queue as rq
from repro_torch.kernels import wave_elementwise as we
from repro_torch.kernels.ops import LOOP_BRANCHES, register_loop_branches, wave_step
from repro_torch.kernels.ref import (attention_ref, grouped_matmul_ref, lru_scan_ref,
                                     ready_queue_ref, wave_rows_ref)

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
# plus the serving shapes of recurrentgemma-2b and h2o-danube-3-4b.
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
}
FLASH_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _qkv(device, name, dtype):
    (b, h, hkv, sq, sk, d), _ = FLASH[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    make = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)  # noqa: E731
    return make(b, h, sq, d), make(b, hkv, sk, d), make(b, hkv, sk, d)


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
