"""The port's dynamic-DNN workloads (``repro_torch.dyn``) on the CPU, held
against the reference's ``repro.dyn`` (after ``tests/test_dyn_workloads.py``):

* XLA's ``"SAME"`` padding, the convs and the pools against ``jax.lax``
  directly (strides 1-2, k 1/3/5, sizes 4-32), to 1e-5;
* the seeded weights equal the reference's arrays, the lazily drawn
  classifier included, and ``params_from_numpy`` carries them across;
* the gates and the controller equal the reference's;
* each of the seven workloads: the same task count, opcode sequence,
  window upstream sets and all-pairs edges as the reference's stream, and
  the port's ``run_serial`` output within rtol 2e-4, atol 1e-5 of the
  reference's ``run_serial``;
* input dependence: InstaNAS's and Dynamic Routing's streams vary with
  the input, the others' do not; SqueezeNet's expand branches share a wave;
* every port policy, the device window with ``register_device_kernels``
  (all plan modes, runner and session) and ``DagRunner`` leave exactly the
  port's ``run_serial`` bits; DagRunner's edges, levels and dependency
  checks equal the reference's;
* the CPU conv route: a vmapped conv group is off ``run_serial`` on the
  CPU, and the executors run conv groups task by task, restoring its bits.

The reference's sessions are never used as goldens on these streams: its
interleaved device and frontier legs drift from its own ``run_serial`` by
rounding (ROADMAP queue 3, "The reference's test state").
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prophelper import given, settings, st

import repro.core as R
import repro.dyn as RD
import repro_torch.core as T
import repro_torch.dyn as TD
from repro.dyn import blocks as RB
from repro_torch.core import (BufferPool, DagRunner, DeviceOpRegistry, DeviceSession,
                              DeviceWindowRunner, SCHEDULER_NAMES, SESSION_NAMES, TaskStream,
                              WaveScheduler, group_by_signature, make_scheduler, make_session,
                              run_serial)
from repro_torch.core.executors import _run_group
from repro_torch.dyn import blocks as TB

CPU = dict(device="cpu")
NAMES = sorted(TD.WORKLOADS)
GRAPH_VARIES = ("instanas", "dynamic_routing")  # CondConv varies in its values only
RTOL, ATOL = 2e-4, 1e-5  # tests/test_dyn_workloads.py's
WINDOW = 32
PLAN_MODES = ("wave", "frontier", "loop")


def _input(seed):
    return np.random.RandomState(seed).randn(1, 3, 32, 32).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref(name, input_seed=1):
    """The reference's weights (after one build), its stream's
    :func:`_structure` and its ``run_serial`` output."""
    init, build, _ = RD.WORKLOADS[name]
    params = init(0)
    stream = R.TaskStream()
    out = build(params, stream, _input(input_seed))
    tasks = stream.tasks
    weights = {k: np.asarray(b.value) for k, b in params.weights.items()}
    structure = _structure(R, tasks)
    R.run_serial(tasks)
    return weights, structure, np.asarray(out.value)


def _port(name, input_seed=1, params=None):
    """The port's stream. Returns (params, output buffer, tasks)."""
    init, build, _ = TD.WORKLOADS[name]
    params = params or init(0, **CPU)
    stream = TaskStream()
    out = build(params, stream, _input(input_seed))
    return params, out, stream.tasks


def _window_upstreams(pkg, tasks, size=WINDOW):
    """Each task's upstream set in ``pkg``'s window of ``size``, fed in
    program order and drained wave by wave, by stream position."""
    window = pkg.SchedulingWindow(size)
    pos = {t.tid: i for i, t in enumerate(tasks)}
    window.submit_all(tasks)
    ups = {}
    while not window.drained():
        for tid, slot in window.slots.items():
            ups.setdefault(pos[tid], sorted(pos[u] for u in slot.upstream))
        ready = window.ready_tasks()
        for t in ready:
            window.mark_executing(t)
        window.retire_many(ready)
    return ups


def _structure(pkg, tasks):
    """``pkg``'s view of a stream, tasks named by stream position."""
    pos = {t.tid: i for i, t in enumerate(tasks)}
    edges, checks = pkg.build_full_dag(tasks)
    levels = [[pos[t.tid] for t in lv] for lv in pkg.level_schedule(tasks, edges)]
    return {
        "opcodes": [t.opcode for t in tasks],
        "static_args": [t.static_args for t in tasks],
        "shapes": [t.signature[2:4] for t in tasks],
        "upstreams": _window_upstreams(pkg, tasks),
        "edges": {pos[k]: sorted(pos[u] for u in v) for k, v in edges.items()},
        "levels": levels,
        "dep_checks": checks,
    }


def _bits(t):
    return t.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# Padding, convs and pools against jax.lax
# ---------------------------------------------------------------------------

@given(st.integers(4, 32), st.integers(4, 32), st.sampled_from([1, 3, 5]),
       st.integers(1, 2), st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_property_conv_and_pools_match_jax_lax(h, w, k, stride, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 4, h, w).astype(np.float32)
    wt = rng.randn(6, 4, k, k).astype(np.float32)
    dw = rng.randn(4, 1, k, k).astype(np.float32)
    pads = jax.lax.padtype_to_pads((h, w), (k, k), (stride, stride), "SAME")
    assert [TB.same_pads(h, k, stride), TB.same_pads(w, k, stride)] == [tuple(p) for p in pads]

    dn = ("NCHW", "OIHW", "NCHW")
    want = jax.lax.conv_general_dilated(x, wt, (stride, stride), "SAME", dimension_numbers=dn)
    got = TB._conv_fn(torch.tensor(x), torch.tensor(wt), stride, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jax.lax.conv_general_dilated(x, dw, (stride, stride), "SAME", dimension_numbers=dn,
                                        feature_group_count=4)
    got = TB._dwconv_fn(torch.tensor(x), torch.tensor(dw), stride, True)
    np.testing.assert_allclose(got.numpy(), np.maximum(np.asarray(want), 0), rtol=1e-5, atol=1e-5)

    win, strides = (1, 1, k, k), (1, 1, stride, stride)
    want = jax.lax.reduce_window(x, 0.0, jax.lax.add, win, strides, "SAME") / float(k * k)
    got = TB._pool_fn(torch.tensor(x), "avg", k, stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, win, strides, "SAME")
    got = TB._pool_fn(torch.tensor(x), "max", k, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fn_name, shapes", [
    ("_add2_fn", [(1, 4, 6, 6)] * 2), ("_add3_fn", [(1, 4, 6, 6)] * 3),
    ("_concat2_fn", [(1, 4, 6, 6), (1, 3, 6, 6)]), ("_dense_fn", [(1, 16), (16, 10)]),
    ("_gap_fn", [(1, 8, 16, 16)]), ("_mix_weights_fn", [(4, 6, 6, 3, 3), (1, 4)]),
    ("_upsample2_fn", [(1, 4, 5, 7)]),
])
def test_kernel_bodies_match_the_reference(fn_name, shapes):
    rng = np.random.RandomState(3)
    args = [rng.randn(*s).astype(np.float32) for s in shapes]
    want = np.asarray(getattr(RB, fn_name)(*[jnp.asarray(a) for a in args]))
    got = getattr(TB, fn_name)(*[torch.tensor(a) for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_set_and_registry_match_the_reference():
    assert [k.name for k in TB.DYN_KERNELS] == [k.name for k in RB.DYN_KERNELS]
    assert sorted(TB.SWITCH_BRANCHES) == sorted(RB.SWITCH_BRANCHES)
    reg = DeviceOpRegistry()
    ops = TB.register_device_kernels(reg)
    from repro.core import DeviceOpRegistry as RReg

    assert ops == RB.register_device_kernels(RReg())
    assert reg.switch_branch("add2") is TB.add2.fn


# ---------------------------------------------------------------------------
# Weights, gates, controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_seeded_weights_equal_the_reference(name):
    weights, _, _ = _ref(name)
    assert "classifier" in weights or name == "dynamic_routing"  # drawn at the first build
    params, _, _ = _port(name)
    assert list(params.weights) == list(weights)
    for key, arr in weights.items():
        got = params.weights[key].value
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), arr, err_msg=key)


@pytest.mark.parametrize("name", ["nasnet", "randwire", "instanas"])
def test_params_from_numpy_carries_the_reference_weights(name):
    weights, _, want = _ref(name)
    params = TD.params_from_numpy(name, weights, **CPU)
    for key, arr in weights.items():
        np.testing.assert_array_equal(params.weights[key].value.numpy(), arr)
    _, out, tasks = _port(name, params=params)
    run_serial(tasks, **CPU)
    np.testing.assert_allclose(out.value.numpy(), want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="stem"):
        TD.params_from_numpy(name, {"stem": np.zeros((1, 1, 1, 1), np.float32)}, **CPU)


def test_gates_and_controller_equal_the_reference():
    from repro.dyn import dynamic_routing as r_dr, instanas as r_in
    from repro_torch.dyn import dynamic_routing as t_dr, instanas as t_in

    for seed in range(8):
        x = _input(seed) * (1 + 0.3 * seed)
        assert t_dr.gates(x) == r_dr.gates(x)
        assert t_in.controller(x) == r_in.controller(x)


# ---------------------------------------------------------------------------
# Streams against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_stream_structure_and_serial_output_match_the_reference(name):
    _, ref_structure, want = _ref(name)
    _, out, tasks = _port(name)
    assert _structure(T, tasks) == ref_structure
    assert len(tasks) >= 10  # many small kernels, as in the paper
    run_serial(tasks, **CPU)
    got = out.value.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_graphs_vary_with_the_input_exactly_for_the_dynamic_nets(name):
    init, build, dynamic = TD.WORKLOADS[name]
    assert dynamic == RD.WORKLOADS[name][2]
    params = init(0, **CPU)
    counts, opcodes = set(), set()
    for seed in range(6):
        stream = TaskStream()
        build(params, stream, _input(seed) * (1 + seed))
        counts.add(len(stream.tasks))
        opcodes.add(tuple(t.opcode for t in stream.tasks))
    assert (len(counts) > 1) == (name in GRAPH_VARIES), counts
    assert (len(opcodes) > 1) == (name in GRAPH_VARIES)


def test_squeezenet_expand_branches_share_a_wave():
    _, _, tasks = _port("squeezenet")
    report = WaveScheduler(window_size=WINDOW, **CPU).run(tasks)
    assert report.exec_stats["max_wave_width"] >= 2
    assert report.exec_stats["dispatches"] <= len(tasks)
    by_tid = {t.tid: t for t in tasks}
    pairs = [{by_tid[tid].signature[2][1][0][-1] for tid in w} for w in report.waves if len(w) == 2]
    assert {1, 3} in pairs  # a 1x1 and a 3x3 expand conv in one wave


# ---------------------------------------------------------------------------
# Every port policy leaves run_serial's bits
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _serial_bits(name):
    _, out, tasks = _port(name)
    run_serial(tasks, **CPU)
    return _bits(out.value)


def _dyn_registry():
    reg = DeviceOpRegistry()
    TB.register_device_kernels(reg)
    return reg


def _feed(session, tasks, seed=7):
    """Random submit chunks with polls in between (the live-FIFO pattern)."""
    rng = np.random.RandomState(seed)
    i = 0
    while i < len(tasks):
        k = 1 + rng.randint(6)
        session.submit(tasks[i: i + k])
        i += k
        if rng.rand() < 0.6:
            session.poll()
    return session.close()


@pytest.mark.parametrize("policy", SCHEDULER_NAMES)
@pytest.mark.parametrize("name", NAMES)
def test_every_scheduler_leaves_serial_bits(name, policy):
    _, out, tasks = _port(name)
    report = make_scheduler(policy, window_size=WINDOW, **CPU)(tasks)
    assert torch.equal(_bits(out.value), _serial_bits(name))
    assert report.exec_stats["tasks_run"] == len(tasks)


@pytest.mark.parametrize("kind", [k for k in SESSION_NAMES if k != "device"])
@pytest.mark.parametrize("name", NAMES)
def test_every_host_session_fed_interleaved_leaves_serial_bits(name, kind):
    _, out, tasks = _port(name)
    report = _feed(make_session(kind, window_size=WINDOW, **CPU), tasks)
    assert torch.equal(_bits(out.value), _serial_bits(name))
    assert report.window_stats["retired"] == len(tasks)


@pytest.mark.parametrize("mode", PLAN_MODES)
@pytest.mark.parametrize("name", NAMES)
def test_device_window_leaves_serial_bits(name, mode):
    """Runner and session on the dyn registry, the kernel routes asked for
    wherever eligible: no task fits the ready-queue or wave kernel (NCHW
    maps of many shape classes), so wave and frontier epochs take the step
    path and loop epochs the interpreter."""
    kernels = dict(loop_kernel=True, wave_kernel=True, **CPU)
    _, out, tasks = _port(name)
    report = DeviceWindowRunner(_dyn_registry(), window_size=WINDOW, plan_mode=mode,
                                **kernels).run(tasks)
    assert torch.equal(_bits(out.value), _serial_bits(name))
    assert report.exec_stats["dispatches"] == 1
    assert report.arena_stats["n_classes"] >= 2
    if mode == "loop":
        assert report.loop_executor == "interpreter"
    else:
        assert report.wave_executor == "steps"

    _, out, tasks = _port(name)
    session = DeviceSession(window_size=WINDOW, registry=_dyn_registry(), plan_mode=mode,
                            **kernels)
    stats = _feed(session, tasks).session_stats
    assert torch.equal(_bits(out.value), _serial_bits(name))
    assert stats["wave_kernel_dispatches"] == 0 and stats["device_dispatches"] > 0


# ---------------------------------------------------------------------------
# The full-DAG baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_dag_runner_matches_the_reference_and_leaves_serial_bits(name):
    _, ref_structure, _ = _ref(name)
    _, out, tasks = _port(name)
    runner = DagRunner(**CPU)
    report = runner.execute(tasks)
    assert torch.equal(_bits(out.value), _serial_bits(name))
    assert report.dep_checks == runner.dep_checks == ref_structure["dep_checks"] \
        == len(tasks) * (len(tasks) - 1) // 2
    pos = {t.tid: i for i, t in enumerate(tasks)}
    assert [[pos[t] for t in w] for w in report.waves] == ref_structure["levels"]
    assert report.construct_seconds > 0
    assert report.exec_stats["tasks_run"] == len(tasks)


@pytest.mark.parametrize("name", ["nasnet", "squeezenet", "randwire"])
def test_dag_runner_replays_a_static_graph_on_a_new_input(name):
    params, _, tasks = _port(name, input_seed=1)
    runner = DagRunner(**CPU)
    runner.execute(tasks)
    checks = runner.dep_checks
    _, out, tasks2 = _port(name, input_seed=2, params=params)
    report = runner.execute(tasks2, construct=False)
    assert runner.dep_checks == checks  # nothing constructed
    _, ref_out, ref_tasks = _port(name, input_seed=2, params=params)
    run_serial(ref_tasks, **CPU)
    assert torch.equal(_bits(out.value), _bits(ref_out.value))
    assert report.exec_stats["tasks_run"] == len(tasks2)
    with pytest.raises(ValueError, match="replay"):
        runner.execute(tasks2[:-1], construct=False)


# ---------------------------------------------------------------------------
# The CPU conv route
# ---------------------------------------------------------------------------

def _conv_group(n=6, stride=2):
    """``n`` independent stride-``stride`` 3x3 convs over ``[1,12,16,16]``
    maps: one signature, so one homogeneous group."""
    rng = np.random.RandomState(0)
    pool = BufferPool(**CPU)
    w = pool.from_array(TB.init_conv(rng, 12, 12, 3))
    stream = TaskStream()
    outs = [TB.launch_conv(stream, pool, pool.from_array(rng.randn(1, 12, 16, 16)
                                                         .astype(np.float32)), w, stride=stride)
            for _ in range(n)]
    return outs, stream.tasks


@pytest.mark.parametrize("stride", [1, 2])
def test_vmapped_conv_group_differs_on_the_cpu_and_the_route_restores_serial_bits(stride):
    outs, tasks = _conv_group(stride=stride)
    run_serial(tasks, **CPU)
    want = torch.stack([_bits(o.value) for o in outs])

    outs, tasks = _conv_group(stride=stride)
    assert len(group_by_signature(tasks)) == 1
    _run_group(tasks)  # one vmapped call: what the executors no longer do
    vmapped = torch.stack([_bits(o.value) for o in outs])
    assert not torch.equal(vmapped, want), "the vmapped conv group kept serial's bits"

    assert T.GroupExecutor(**CPU).warm(tasks)  # the frontier's route: task by task
    for policy in ("wave", "frontier"):
        outs, tasks = _conv_group(stride=stride)
        report = make_scheduler(policy, window_size=WINDOW, **CPU)(tasks)
        assert report.exec_stats["dispatches"] == len(tasks)  # task by task
        assert torch.equal(torch.stack([_bits(o.value) for o in outs]), want)
    for mode in ("wave", "frontier"):
        outs, tasks = _conv_group(stride=stride)
        DeviceWindowRunner(_dyn_registry(), window_size=WINDOW, plan_mode=mode,
                           **CPU).run(tasks)
        assert torch.equal(torch.stack([_bits(o.value) for o in outs]), want)


def test_cpu_route_takes_only_convolutions_task_by_task():
    from repro_torch.core.executors import per_task_group

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    found = {}
    for name in NAMES:
        tasks = _port(name)[2]
        run_serial(tasks, **CPU)  # every input holds a value
        for t in tasks:
            vals = t.input_values()
            found[t.opcode] = (per_task_group(t.fn, t.signature, vals, cpu),
                               per_task_group(t.fn, t.signature, vals, cuda))
    # On the CPU the vmapped pools, elementwise ops, gap and mix_weights are
    # bit-equal to per-task calls; on the card every contraction and long
    # reduction runs task by task.
    assert found == {
        "conv": (True, True), "dwconv": (True, True), "pool_avg": (False, False),
        "pool_max": (False, False), "add2": (False, False), "add3": (False, False),
        "concat2": (False, False), "dense": (False, True), "gap": (False, True),
        "mix_weights": (False, True), "upsample2": (False, False)}


def test_no_dense_group_is_wider_than_one_on_a_dyn_stream():
    """A ``[1, C] @ [C, N]`` product vmapped over tasks is ~1e-6 off the
    per-task calls on the CPU (measured at C 16, N 4), and the CPU route
    leaves GEMM groups vmapped. A single input's stream never groups two
    dense tasks (CondConv's routers chain through their blocks)."""
    for name in NAMES:
        _, _, tasks = _port(name)
        for policy in ("wave", "frontier"):
            report = make_scheduler(policy, window_size=WINDOW, **CPU)(tasks)
            by_tid = {t.tid: t for t in tasks}
            for wave in report.waves:
                dense = [tid for tid in wave if by_tid[tid].opcode == "dense"]
                assert len({by_tid[tid].signature for tid in dense}) == len(dense)
