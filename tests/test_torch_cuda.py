"""The ready-queue CUDA kernel on the card: bit-equal to its plain version
on random DAG epochs, the same early stop on corrupted tables, the
wrapper's input checks, and the device runner's route through it.

Every test here needs a CUDA device and ``nvcc`` (the kernel builds at
first use), so they carry the ``cuda`` marker and skip without a card.
Run them on the card with::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This module imports no JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import BufferPool, DeviceOpRegistry, DeviceWindowRunner, SlabArena, Task
from repro_torch.core import run_serial
from repro_torch.core.device_dispatch import _loop_kernel_parts, lower_epoch_program
from repro_torch.core.task import default_segments
from repro_torch.kernels import ready_queue as rq
from repro_torch.kernels.ops import LOOP_BRANCHES, register_loop_branches
from repro_torch.kernels.ref import ready_queue_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ready-queue kernel has no CPU mode")
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


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n,d", [(1, 8), (64, 128), (300, 1000), (1024, 4096), (8192, 256)])
def test_kernel_bit_equal_to_plain(device, seed, n, d):
    _, tasks = _stream(device, seed, n, d)
    args, branches = _kernel_args(device, tasks)
    got = rq.ready_queue(*args, branches=branches)
    torch.cuda.synchronize()
    want = ready_queue_ref(*args, branches=branches)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    assert bool(got[1].all())


@pytest.mark.parametrize("corrupt", ["dropped_edge", "bad_task_row", "bad_edge", "bad_in2"])
def test_kernel_stops_like_plain_on_corrupted_tables(device, corrupt):
    _, tasks = _stream(device, 0, 200, 64)
    args, branches = _kernel_args(device, tasks)
    slab, task_tbl, dep_tbl, ring0, rem0, tail0 = (a.clone() for a in args)
    n = len(tasks)
    if corrupt == "dropped_edge":
        t, j = (dep_tbl < n).nonzero()[0].tolist()
        dep_tbl[t, j] = n
    elif corrupt == "bad_task_row":
        task_tbl[int(ring0[0]), 4] = slab.shape[0] + 5
    elif corrupt == "bad_in2":
        task_tbl[:, 3] = slab.shape[0] + 5  # no opcode reads in2
    else:
        dep_tbl[0, 0] = -7
    got = rq.ready_queue(slab, task_tbl, dep_tbl, ring0, rem0, tail0, branches=branches)
    torch.cuda.synchronize()
    want = ready_queue_ref(slab, task_tbl, dep_tbl, ring0, rem0, tail0, branches=branches)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    if corrupt != "bad_edge":
        assert bool(got[1].all()) == (corrupt == "bad_in2")


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
    report = DeviceWindowRunner(registry=reg, device=device).run(tasks)
    assert report.loop_executor == "cuda"
    assert rq.launches == before + 1
    assert torch.equal(_bits(torch.stack([b.value for b in bufs])), _bits(want))
