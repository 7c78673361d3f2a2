"""The port's ACS-HW path on the CPU: the ready-queue lowering against the
reference's, the plain ready queue (``ready_queue_ref``, the oracle of the
CUDA kernel) against ``run_serial`` and the reference's loop interpreter,
its table checks (every lowered stream passes them; each corruption runs
no task), the kernel-path eligibility, and the stall error.

The reference's Pallas ready-queue kernel does not trace on the installed
JAX, so the reference side runs its ``lax.while_loop`` interpreter
(``loop_pallas=False``), which is structurally the same queue. The CUDA
kernel itself runs only on the card (``chip_smoke.py``).
"""

import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _prophelper import given, settings, st

import _torch_streams as S
from repro_torch.kernels import ready_queue as rq
from repro_torch.kernels.ops import LOOP_BRANCHES, LOOP_OPCODES
from repro_torch.kernels.ref import ready_queue_ref, ready_queue_tables_error

# XLA may contract a*b+c into one FMA on the CPU where eager PyTorch
# rounds twice, so the reference side agrees to a few ulps, not bitwise.
RTOL = ATOL = 1e-6

ELIGIBLE = ("mixed_tag", "chain")
# The kernel takes padding-free rows: the arena pads rows to multiples of 8,
# so the mixed-tag stream runs at width 8 where it must be eligible (at the
# differential matrix's width 4 it pads, and goes to the interpreter).
BUILD = {**S.STREAMS, "mixed_tag": lambda side: S.mixed_tag(side, d=8),
         "mixed_tag_d4": S.mixed_tag}


def _loop_registry(side, tasks):
    """A registry whose switch table holds the loop branches under their
    own names and under every task opcode that launches one of them (the
    mixed-tag kernels carry names of their own)."""
    reg = S.PKG[side].DeviceOpRegistry(strict=False)
    S.REGISTER[side](reg)
    branch_fns = set(S.BRANCHES[side].values())
    for t in tasks:
        if t.fn in branch_fns:
            reg.register_switch_branch(t.opcode, t.fn)
    return reg


def _serial_snapshot(side, stream):
    bufs, tasks = BUILD[stream](side)
    S.run_serial(side, tasks)
    return S.snapshot(bufs)


def _port_loop(stream, loop_kernel):
    bufs, tasks = BUILD[stream]("port")
    runner = S.T.DeviceWindowRunner(registry=_loop_registry("port", tasks), plan_mode="loop",
                                    loop_kernel=loop_kernel, device="cpu")
    report = runner.run(tasks)
    return S.snapshot(bufs), report


def _kernel_args(program, arena):
    """The kernel's arguments for an eligible program, on the CPU."""
    parts = S.T_DD._loop_kernel_parts(program, _registry_of(program), arena)
    assert parts is not None
    cid, branches = parts
    p = program.payload("cpu")
    slabs = arena.pack("cpu")
    return slabs, cid, p, branches


def _registry_of(program):
    reg = S.T.DeviceOpRegistry(strict=False)
    for name, fn in zip(program.opnames, program.fns):
        reg.register_switch_branch(name, fn)
    return reg


@pytest.mark.parametrize("stream", ["mixed_tag", "chain", "sim"])
def test_lowering_matches_reference(stream):
    (_, rt), (_, pt) = S.STREAMS[stream]("ref"), S.STREAMS[stream]("port")
    rp, _, _ = S.lower("ref", rt)
    pp, _, _ = S.lower("port", pt)
    for name in ("spec_id", "spec_pos", "indeg", "dep_tbl", "ring0"):
        np.testing.assert_array_equal(getattr(rp, name), getattr(pp, name), err_msg=name)
        assert getattr(pp, name).dtype == np.int32, name
    assert rp.tail0 == pp.tail0
    assert rp.opnames == pp.opnames
    for rtab, ptab in zip(rp.spec_tables, pp.spec_tables):
        assert sorted(rtab) == sorted(ptab)
        for key in rtab:
            np.testing.assert_array_equal(rtab[key], ptab[key], err_msg=key)
    if stream != "sim":  # the sim stream's arity exceeds the kernel's table
        np.testing.assert_array_equal(S.R_DD._loop_task_table(rp),
                                      S.T_DD._loop_task_table(pp))


@pytest.mark.parametrize("stream", ELIGIBLE)
def test_ready_queue_ref_drains_bit_equal_to_interpreter(stream):
    _, tasks = BUILD[stream]("port")
    program, _, arena = S.lower("port", tasks)
    slabs, cid, p, branches = _kernel_args(program, arena)
    before = rq.launches
    slab, done, ring = rq.ready_queue(slabs[cid], p["task_tbl"], p["dep_tbl"], p["ring0"],
                                      p["rem0"], p["tail0"], branches=branches)
    assert rq.launches == before, "a CPU tensor must not count as a kernel launch"
    n = program.n_tasks
    assert done.dtype == torch.int32 and bool(done.all())
    # The pop order is a topological order of the epoch.
    order = ring[:n].tolist()
    assert sorted(order) == list(range(n))
    where = {t: i for i, t in enumerate(order)}
    for t in range(n):
        for d in program.dep_tbl[t]:
            if d < n:
                assert where[t] < where[int(d)]
    interp, idone = S.T_DD._run_loop_interpreter([s.clone() for s in slabs], program)
    assert bool(idone.all())
    assert torch.equal(slab.view(torch.int32), interp[cid].view(torch.int32))
    assert torch.equal(slabs[cid], arena.pack("cpu")[cid]), "the input slab was modified"


@pytest.mark.parametrize("in2", [-3, 10 ** 6])
def test_ready_queue_ref_reads_no_in2_for_two_row_branches(in2):
    """Every kernel opcode reads two rows, so a corrupted in2 column changes
    nothing in the plain version, as in the CUDA kernel, which never reads
    it."""
    _, tasks = BUILD["chain"]("port")
    program, _, arena = S.lower("port", tasks)
    slabs, cid, p, branches = _kernel_args(program, arena)
    args = (slabs[cid], p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"], p["tail0"])
    want = ready_queue_ref(*args, branches=branches)
    bad_tbl = p["task_tbl"].clone()
    bad_tbl[:, 3] = in2
    got = ready_queue_ref(args[0], bad_tbl, *args[2:], branches=branches)
    assert bool(got[1].all())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("stream", ELIGIBLE)
@pytest.mark.parametrize("loop_kernel", [True, False])
def test_loop_runner_matches_serial_and_reference(stream, loop_kernel):
    got, report = _port_loop(stream, loop_kernel)
    assert report.loop_executor == ("ref" if loop_kernel else "interpreter")
    assert report.exec_stats["dispatches"] == 1
    np.testing.assert_array_equal(got.view(np.int32),
                                  _serial_snapshot("port", stream).view(np.int32))

    rbufs, rtasks = BUILD[stream]("ref")
    S.R.DeviceWindowRunner(registry=_loop_registry("ref", rtasks), plan_mode="loop",
                           loop_pallas=False).run(rtasks)
    np.testing.assert_allclose(got, S.snapshot(rbufs), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _serial_snapshot("ref", stream), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stream,eligible", [("chain", True), ("mixed_tag", True),
                                             ("mixed_tag_d4", False), ("sim", False)])
def test_eligibility_routes_to_kernel_path(monkeypatch, stream, eligible):
    calls = []

    def stub(*args, **kwargs):
        calls.append(kwargs["branches"])
        return ready_queue_ref(*args, **kwargs)

    monkeypatch.setattr(rq, "ready_queue", stub)
    bufs, tasks = BUILD[stream]("port")
    reg = _loop_registry("port", tasks)
    if stream == "sim":
        from repro_torch.sim import register_device_kernels

        register_device_kernels(reg)
    report = S.T.DeviceWindowRunner(registry=reg, plan_mode="loop", loop_kernel=True,
                                    device="cpu").run(tasks)
    assert len(calls) == int(eligible)
    assert report.loop_executor == ("ref" if eligible else "interpreter")
    if eligible:
        assert all(fn in LOOP_OPCODES for fn in calls[0])
    np.testing.assert_array_equal(S.snapshot(bufs), _serial_snapshot("port", stream))


@pytest.mark.parametrize("loop_kernel", [True, False])
def test_corrupted_dep_tbl_raises_stall(monkeypatch, loop_kernel):
    real = S.T_DD.dependency_arrays

    def drop_first_edge(tasks):
        indeg, dep_tbl = real(tasks)
        dep_tbl = dep_tbl.copy()
        t, j = np.argwhere(dep_tbl < len(tasks))[0]
        dep_tbl[t, j] = len(tasks)  # the dependent keeps its count: it never wakes
        return indeg, dep_tbl

    monkeypatch.setattr(S.T_DD, "dependency_arrays", drop_first_edge)
    _, tasks = S.STREAMS["chain"]("port")
    runner = S.T.DeviceWindowRunner(registry=_loop_registry("port", tasks), plan_mode="loop",
                                    loop_kernel=loop_kernel, device="cpu")
    with pytest.raises(RuntimeError, match=r"ready-queue epoch stalled: tasks \[\d+"):
        runner.run(tasks)


def test_opcodes_match_the_cuda_source():
    """The wrapper's fn -> opcode table and the kernel's OP_* constants name
    the same branches with the same numbers."""
    src = rq.SOURCE.read_text()
    consts = {m.group(1).lower(): int(m.group(2))
              for m in re.finditer(r"constexpr int OP_(\w+) = (\d+);", src)}
    assert consts == {name: LOOP_OPCODES[fn] for name, fn in LOOP_BRANCHES.items()}


def test_scratch_layout_matches_the_cuda_source():
    """The wrapper reads the grid and the blocks that ran tasks from the
    words of the scratch where the kernel leaves them."""
    src = rq.SOURCE.read_text()
    words = dict(re.findall(r"\b(k[A-Z]\w*) = (\d+)", src))
    assert (int(words["kHeader"]), int(words["kGridSize"]), int(words["kBlocksRan"])) == \
        (rq._HEADER, rq._GRID_SIZE, rq._BLOCKS_RAN)


@pytest.mark.parametrize("name", sorted(LOOP_BRANCHES))
def test_branches_match_reference_formulas(name):
    rng = np.random.RandomState(3)
    x, y = rng.randn(2, 64).astype(np.float32)
    got = LOOP_BRANCHES[name](torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(S.R_BRANCHES[name](S.jnp.asarray(x), S.jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_non_cpu_non_cuda_device():
    slab = torch.zeros((2, 4), device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rq.ready_queue(slab, torch.zeros((1, 5), **i32), torch.zeros((1, 1), **i32),
                       torch.zeros(2, **i32), torch.zeros(2, **i32), torch.zeros(1, **i32),
                       branches=(LOOP_BRANCHES["axpy"],))


# ---------------------------------------------------------------------------
# The table checks that the plain version and the CUDA kernel make first
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _queue_args(stream, seed, size):
    """The kernel's arguments ``(slab, payload, branches)`` for a lowered
    stream on the CPU: the chain universe (``size`` chains of depth 4), the
    mixed-tag hazard stream (``size`` tasks) or ``chip_smoke``'s random DAG
    (``size`` tasks over 12 rows)."""
    if stream == "random_dag":
        return _chip_smoke().random_dag(torch.device("cpu"), seed, size, 8, n_bufs=12)
    if stream == "chain":
        _, tasks = S.chain_universe("port", seed, n_chains=size, width=8)
    else:
        _, tasks = S.mixed_tag("port", seed, d=8, n_tasks=size)
    program, _, arena = S.lower("port", tasks)
    slabs, cid, p, branches = _kernel_args(program, arena)
    return slabs[cid], p, branches


def _table_error(slab, p, branches):
    return ready_queue_tables_error(p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"],
                                    p["tail0"], rows=slab.shape[0], branches=branches)


def _topological(ring, dep_tbl, n):
    order = ring[:n].tolist()
    if sorted(order) != list(range(n)):
        return False
    where = np.empty(n, np.int64)
    where[order] = np.arange(n)
    dep = dep_tbl.numpy()
    t, j = np.nonzero(dep < n)
    return bool((where[t] < where[dep[t, j]]).all())


@given(st.sampled_from(["chain", "mixed_tag", "random_dag"]), st.integers(0, 10_000),
       st.integers(1, 60))
@settings(max_examples=30, deadline=None)
def test_every_lowered_stream_passes_the_checks_and_drains(stream, seed, size):
    slab, p, branches = _queue_args(stream, seed, size)
    assert _table_error(slab, p, branches) is None
    n = p["dep_tbl"].shape[0]
    out, done, ring = ready_queue_ref(slab, p["task_tbl"], p["dep_tbl"], p["ring0"], p["rem0"],
                                      p["tail0"], branches=branches)
    assert bool(done.all())
    assert _topological(ring, p["dep_tbl"], n)
    assert int(ring[n]) == int(p["ring0"][n]) == n


CORRUPTIONS = _chip_smoke().CORRUPTIONS


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("stream", ["chain", "random_dag"])
def test_corrupted_tables_run_no_task(stream, kind):
    """Each fault is named by its check, and the epoch then runs nothing:
    the slab's bits unchanged, ``done`` all 0 and ``ring == ring0``, through
    the plain version and through the wrapper's CPU path."""
    slab, p, branches = _queue_args(stream, 0, 6 if stream == "chain" else 40)
    q, words = _chip_smoke().corrupt_tables(kind, slab, p, len(branches))
    assert words in (_table_error(slab, q, branches) or "")
    args = (slab, q["task_tbl"], q["dep_tbl"], q["ring0"], q["rem0"], q["tail0"])
    for fn in (ready_queue_ref, rq.ready_queue):
        out, done, ring = fn(*args, branches=branches)
        assert torch.equal(out.view(torch.int32), slab.view(torch.int32))
        assert done.dtype == torch.int32 and not bool(done.any())
        assert torch.equal(ring, q["ring0"])


def test_a_lone_task_and_an_empty_epoch():
    """n = 1 runs its task; n = 0 returns the inputs' copies."""
    slab, p, branches = _queue_args("random_dag", 3, 1)
    assert p["dep_tbl"].shape[0] == 1
    out, done, ring = ready_queue_ref(slab, p["task_tbl"], p["dep_tbl"], p["ring0"],
                                      p["rem0"], p["tail0"], branches=branches)
    assert done.tolist() == [1] and ring.tolist() == [0, 1]
    b, i0, i1, _, o = p["task_tbl"][0].tolist()
    want = slab.clone()
    want[o] = branches[b](slab[i0], slab[i1])
    assert torch.equal(out, want)
    i32 = dict(dtype=torch.int32)
    empty = (slab, torch.zeros((0, 5), **i32), torch.zeros((0, 1), **i32),
             torch.zeros(1, **i32), torch.zeros(1, **i32), torch.zeros(1, **i32))
    out, done, ring = ready_queue_ref(*empty, branches=branches)
    assert torch.equal(out, slab) and done.numel() == 0 and ring.tolist() == [0]
