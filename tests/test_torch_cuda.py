"""The port's CUDA kernels on the card.

* ready queue: bit-equal to its plain version on random DAG epochs, the
  same early stop on corrupted tables, the wrapper's input checks, and the
  device runner's route through it;
* ``lru_scan``: bit-equal to ``lru_scan_ref``, float32 and bfloat16;
* ``flash_attention``: within tolerance of ``attention_ref`` over the CPU
  tests' sweep and the serving shapes (float32 1e-4: summation order;
  bfloat16 2e-2: output rounding), fully masked rows exactly 0, the same
  bits on a second launch;
* the two wrappers' input checks, and a model prefill that launches them.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import ready_queue as rq
from repro_torch.kernels.ops import LOOP_BRANCHES, register_loop_branches
from repro_torch.kernels.ref import attention_ref, lru_scan_ref, ready_queue_ref

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
def test_flash_attention_fully_masked_rows_are_zero(device, dtype):
    q, k, v = _qkv(device, "fully_masked_rows", dtype)
    got = fa.flash_attention(q, k, v, q_offset=-4)
    torch.cuda.synchronize()
    assert bool((got[:, :, :4] == 0).all())
    assert bool((got[:, :, 4:] != 0).any())


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
