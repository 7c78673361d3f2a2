"""The port's wave and frontier device window on the CPU, against the
reference: the same plans (traces by stream position), the same
``plan_active_fraction``, the same ``lower_plan`` tables as int arrays,
the same step counts and the same run-length segmentation; results
bit-equal to the port's ``run_serial`` and allclose to the reference
runner, on the step path and on the wave-kernel path (the kernel's plain
version here); the wave kernel's eligibility and its report; and the
legacy uniform interpreter with its over-arity and multi-output refusals.

Streams: the mixed-tag hazard stream (at width 4 it pads, at width 8 it is
wave-kernel eligible), the reduced chain universe and one cheetah physics
step (row views, mixed classes, variable arity)."""

import importlib
import dataclasses

import numpy as np
import pytest
import torch

import _torch_streams as S
from repro.core.device_dispatch import _build_program as r_build_program
from repro.core.device_dispatch import _run_tables as r_run_tables
from repro_torch.core.device_dispatch import _build_program as t_build_program
from repro_torch.core.device_dispatch import _run_tables as t_run_tables
from repro_torch.core.device_dispatch import _wave_kernel_parts
we = importlib.import_module("repro_torch.kernels.wave_elementwise")
from repro_torch.kernels.ref import wave_rows_ref

RTOL = ATOL = 1e-6
MODES = ("wave", "frontier")
BUILD = {**S.STREAMS, "mixed_tag8": lambda side: S.mixed_tag(side, d=8)}
STREAMS = ("mixed_tag", "mixed_tag8", "chain", "sim")
WINDOW = 8


def _registry(side, tasks):
    """Auto-registering registry with the loop branches in the switch table
    under their own names and under every task opcode that launches one
    (the mixed-tag kernels carry names of their own)."""
    reg = S.PKG[side].DeviceOpRegistry(strict=False)
    S.REGISTER[side](reg)
    branch_fns = set(S.BRANCHES[side].values())
    for t in tasks:
        if t.fn in branch_fns:
            reg.register_switch_branch(t.opcode, t.fn)
    return reg


def _plan(side, mode, tasks):
    dd = S.DISPATCH[side]
    if mode == "frontier":
        return dd.plan_frontier(tasks, WINDOW)
    return dd.plan_waves(tasks, WINDOW)


def _lowered(side, stream, mode):
    _, tasks = BUILD[stream](side)
    plan = _plan(side, mode, tasks)
    arena = S.PKG[side].SlabArena()
    arena.add_tasks(tasks)
    steps = S.DISPATCH[side].lower_plan(plan, _registry(side, tasks), arena)
    return tasks, plan, steps


def _serial_snapshot(side, stream):
    bufs, tasks = BUILD[stream](side)
    S.run_serial(side, tasks)
    return S.snapshot(bufs)


def _spec_tuple(spec):
    return (spec.opcode, spec.width,
            tuple(dataclasses.astuple(s) for s in spec.inputs),
            tuple(dataclasses.astuple(s) for s in spec.outputs))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stream", STREAMS)
def test_plan_and_lowering_match_reference(stream, mode):
    rt, rplan, rsteps = _lowered("ref", stream, mode)
    pt, pplan, psteps = _lowered("port", stream, mode)
    rpos, ppos = S.positions(rt), S.positions(pt)
    assert [[rpos[t.tid] for t in w] for w in rplan] == [[ppos[t.tid] for t in w] for w in pplan]
    assert S.DISPATCH["ref"].plan_active_fraction(rplan) == \
        S.DISPATCH["port"].plan_active_fraction(pplan)
    assert len(rsteps) == len(psteps)
    for r, p in zip(rsteps, psteps):
        assert _spec_tuple(r.spec) == _spec_tuple(p.spec)
        assert [rpos[t] for t in r.tids] == [ppos[t] for t in p.tids]
        for key, arr in p.tables().items():
            np.testing.assert_array_equal(arr, r.tables()[key], err_msg=key)
            assert arr.dtype == np.int32, key
    # the run-length segmentation and its stacked tables
    _, rruns = r_build_program(rsteps)
    _, pruns = t_build_program(psteps)
    assert [(_spec_tuple(s), n) for s, _, n in rruns] == [(_spec_tuple(s), n) for s, _, n in pruns]
    for rtab, ptab in zip(r_run_tables(rsteps, rruns), t_run_tables(psteps, pruns)):
        assert sorted(rtab) == sorted(ptab)
        for key in rtab:
            np.testing.assert_array_equal(np.asarray(rtab[key]), ptab[key], err_msg=key)


def _port_run(stream, mode, wave_kernel):
    bufs, tasks = BUILD[stream]("port")
    runner = S.T.DeviceWindowRunner(registry=_registry("port", tasks), window_size=WINDOW,
                                    plan_mode=mode, wave_kernel=wave_kernel, device="cpu")
    report = runner.run(tasks)
    return S.snapshot(bufs), report, tasks


@pytest.mark.parametrize("wave_kernel", [None, True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stream", STREAMS)
def test_runner_matches_serial_and_reference(stream, mode, wave_kernel):
    got, report, tasks = _port_run(stream, mode, wave_kernel)
    np.testing.assert_array_equal(got.view(np.int32),
                                  _serial_snapshot("port", stream).view(np.int32))
    eligible = stream in ("mixed_tag8", "chain") and wave_kernel is True
    assert report.wave_executor == ("ref" if eligible else "steps")
    assert report.wave_kernel_launches == 0  # the CPU runs the plain version
    assert report.exec_stats["dispatches"] == 1
    assert report.exec_stats["tasks_run"] == len(tasks)

    rbufs, rtasks = BUILD[stream]("ref")
    rrep = S.R.DeviceWindowRunner(registry=_registry("ref", rtasks), window_size=WINDOW,
                                  plan_mode=mode).run(rtasks)
    np.testing.assert_allclose(got, S.snapshot(rbufs), rtol=RTOL, atol=ATOL)
    rpos, ppos = S.positions(rtasks), S.positions(tasks)
    assert [[rpos[t] for t in w] for w in rrep.waves] == [[ppos[t] for t in w] for w in report.waves]
    assert rrep.plan_active_fraction == report.plan_active_fraction
    assert rrep.exec_stats["waves"] == report.exec_stats["waves"]
    assert rrep.arena_stats["device_steps"] == report.arena_stats["device_steps"]
    assert rrep.window_stats == report.window_stats


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stream,eligible", [("chain", True), ("mixed_tag8", True),
                                             ("mixed_tag", False), ("sim", False)])
def test_wave_kernel_path_launches_once_per_plan_step(monkeypatch, stream, mode, eligible):
    calls = []

    def stub(slab, desc, *, branches, err=None):
        calls.append(desc.shape[0])
        return wave_rows_ref(slab, desc, branches)

    monkeypatch.setattr(we, "wave_elementwise", stub)
    bufs, report, tasks = _port_run(stream, mode, True)
    assert (report.wave_executor == "ref") == eligible
    if eligible:
        assert calls == [len(w) for w in report.waves]
        assert report.wave_kernel_refusal == ""
    else:
        assert calls == [] and report.wave_kernel_refusal
    np.testing.assert_array_equal(bufs.view(np.int32),
                                  _serial_snapshot("port", stream).view(np.int32))


def test_wave_descriptors_address_each_plan_step():
    _, tasks = BUILD["chain"]("port")
    plan = _plan("port", "wave", tasks)
    arena = S.T.SlabArena()
    arena.add_tasks(tasks)
    prog, why = _wave_kernel_parts(plan, _registry("port", tasks), arena)
    assert why == "" and prog.n_steps == len(plan)
    branches = {fn: i for i, fn in enumerate(prog.branches)}
    for step, lo, hi in zip(plan, prog.offsets[:-1], prog.offsets[1:]):
        want = [(branches[t.fn], arena.address(t.inputs[0]).row, arena.address(t.inputs[1]).row,
                 arena.address(t.outputs[0]).row) for t in step]
        assert prog.desc[lo:hi].tolist() == [list(w) for w in want]
        assert len(set(prog.desc[lo:hi, 3].tolist())) == hi - lo  # unique out rows


def test_float64_slab_is_not_wave_kernel_eligible():
    pool = S.pool("port")
    rng = np.random.RandomState(0)
    bufs = [pool.alloc((8,), np.float64, value=rng.randn(8)) for _ in range(3)]
    kern = S.T.AcsKernel(name="axpy", fn=S.T_BRANCHES["axpy"])
    stream = S.T.TaskStream()
    kern.launch(stream, inputs=(bufs[0], bufs[1]), outputs=(bufs[2],))
    kern.launch(stream, inputs=(bufs[2], bufs[1]), outputs=(bufs[0],))
    report = S.T.DeviceWindowRunner(registry=_registry("port", stream.tasks), wave_kernel=True,
                                    device="cpu").run(stream.tasks)
    assert report.wave_executor == "steps"
    assert "float64" in report.wave_kernel_refusal


@pytest.mark.parametrize("mode", ["wave", "frontier", "loop"])
def test_make_scheduler_device_runs_every_plan_mode(mode):
    bufs, tasks = BUILD["mixed_tag"]("port")
    report = S.T.make_scheduler("device", window_size=WINDOW, plan_mode=mode,
                                device="cpu")(tasks)
    assert report.plan_mode == mode
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot("port", "mixed_tag").view(np.int32))


def test_frontier_max_group_caps_groups():
    _, tasks = BUILD["chain"]("port")
    groups = S.T.plan_frontier(tasks, WINDOW, max_group=2)
    _, rtasks = BUILD["chain"]("ref")
    rgroups = S.R.plan_frontier(rtasks, WINDOW, max_group=2)
    assert max(len(g) for g in groups) == 2
    rpos, ppos = S.positions(rtasks), S.positions(tasks)
    assert [[rpos[t.tid] for t in g] for g in rgroups] == [[ppos[t.tid] for t in g] for g in groups]


# -- legacy uniform path ------------------------------------------------------

def _uniform_branches(side):
    br = S.BRANCHES[side]
    return {"axpy": lambda x, y, z: br["axpy"](x, y), "mul": lambda x, y, z: br["mul"](x, y)}


def _uniform_stream(side, seed, n_tasks=30, n_bufs=6, d=8):
    """The reference test's toy universe: (x, y) tasks whose legacy branch
    takes (x, y, z)."""
    pkg = S.PKG[side]
    rng = np.random.RandomState(seed)
    p = S.pool(side)
    bufs = [p.alloc((d,), np.float32, value=S.value(side, rng.randn(d).astype(np.float32)))
            for _ in range(n_bufs)]
    tasks = []
    for _ in range(n_tasks):
        op = "axpy" if rng.rand() < 0.5 else "mul"
        ins = (bufs[rng.randint(n_bufs)], bufs[rng.randint(n_bufs)])
        outs = (bufs[rng.randint(n_bufs)],)
        r, w = S.DEFAULT_SEGMENTS[side](ins, outs)
        tasks.append(pkg.Task(opcode=op, fn=S.BRANCHES[side][op], inputs=ins, outputs=outs,
                              read_segments=r, write_segments=w))
    return bufs, tasks


def _uniform_registry(side):
    reg = S.PKG[side].DeviceOpRegistry()
    for name, fn in _uniform_branches(side).items():
        reg.register(name, fn)
    return reg


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 2])
def test_execute_uniform_matches_serial_and_reference(seed, mode):
    sbufs, stasks = _uniform_stream("port", seed)
    S.run_serial("port", stasks)
    bufs, tasks = _uniform_stream("port", seed)
    runner = S.T.DeviceWindowRunner(_uniform_registry("port"), window_size=16,
                                    plan_mode=mode, device="cpu")
    report = runner.execute_uniform(tasks, bufs)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))
    assert report.exec_stats["dispatches"] == 1

    rbufs, rtasks = _uniform_stream("ref", seed)
    rrep = S.R.DeviceWindowRunner(_uniform_registry("ref"), window_size=16,
                                  plan_mode=mode).execute_uniform(rtasks, rbufs)
    # 30 chained tasks grow values to ~4e5, where XLA's contracted
    # multiply-adds drift a few ulps from eager rounding: the reference's
    # own test of this path holds it to serial at rtol 1e-5; atol covers the
    # values that cancel to near zero.
    np.testing.assert_allclose(S.snapshot(bufs), S.snapshot(rbufs), rtol=1e-5, atol=1e-5)
    assert rrep.plan_active_fraction == report.plan_active_fraction


def test_uniform_tables_match_reference():
    rbufs, rtasks = _uniform_stream("ref", 1)
    pbufs, ptasks = _uniform_stream("port", 1)
    rt = S.R_DD.compile_wave_plan(S.R_DD.plan_waves(rtasks, 16), _uniform_registry("ref"),
                                  {b.name: i for i, b in enumerate(rbufs)}, len(rbufs))
    pt = S.T_DD.compile_wave_plan(S.T_DD.plan_waves(ptasks, 16), _uniform_registry("port"),
                                  {b.name: i for i, b in enumerate(pbufs)}, len(pbufs))
    for key in rt:
        np.testing.assert_array_equal(rt[key], pt[key], err_msg=key)


def _one_task(n_in, n_out):
    pool = S.pool("port")
    bufs = [pool.alloc((8,), np.float32, value=np.ones(8, np.float32)) for _ in range(5)]
    ins, outs = tuple(bufs[:n_in]), tuple(bufs[n_in:n_in + n_out])
    r, w = S.DEFAULT_SEGMENTS["port"](ins, outs)
    return bufs, S.T.Task(opcode="axpy", fn=lambda *a: a, inputs=ins, outputs=outs,
                          read_segments=r, write_segments=w)


@pytest.mark.parametrize("n_in,n_out,match", [(S.T_DD.MAX_ARITY + 1, 1, "legacy uniform-slab path"),
                                              (2, 2, "exactly one")])
def test_legacy_tables_refuse_over_arity_and_multi_output(n_in, n_out, match):
    bufs, task = _one_task(n_in, n_out)
    with pytest.raises(ValueError, match=match):
        S.T_DD.compile_wave_plan([[task]], _uniform_registry("port"),
                                 {b.name: i for i, b in enumerate(bufs)}, len(bufs))


def test_fnless_registration_blocks_legacy_branches():
    reg = S.T.DeviceOpRegistry()
    reg.register("real_kernel")
    with pytest.raises(ValueError, match="legacy uniform path"):
        _ = reg.branches


def test_lowering_notes_the_classes_each_opcode_ran_over():
    (_, rt), (_, pt) = S.STREAMS["sim"]("ref"), S.STREAMS["sim"]("port")
    regs = {}
    for side, tasks in (("ref", rt), ("port", pt)):
        reg = _registry(side, tasks)
        arena = S.PKG[side].SlabArena()
        arena.add_tasks(tasks)
        S.DISPATCH[side].lower_plan(_plan(side, "wave", tasks), reg, arena)
        regs[side] = reg.classes_seen
    assert regs["ref"] == regs["port"]


def test_gathered_operands_are_copies():
    """A step gathers every input before it scatters, and a gathered value
    never aliases the slab (a task may read the row it writes)."""
    slab = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    spec = S.T_DD._OperandSpec(class_id=0, true_shape=(8,), is_view=False, view_rows=0)
    val = S.T_DD._gather_operand([slab], spec, np.array([1]), np.array([0]), 1)
    slab[1] = -1.0
    assert val[0] == 8.0
