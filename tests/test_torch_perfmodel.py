"""The port's analytic device model (``repro_torch.core.perfmodel``) against
the reference's on the CPU: ``kernel_time_us``, ``kernel_ctas``,
``shelf_makespan`` and ``simulate`` give EQUAL floats (plain arithmetic on
both sides) for the same cheetah, ant and dyn streams under every device
model and policy; the reference's seven orderings (``tests/test_perfmodel.py``)
hold on the port's streams; ``H100_LIKE`` is data for the port's card."""

import dataclasses

import numpy as np
import pytest

import repro.core.perfmodel as RP
import repro.dyn as RD
import repro_torch.core.perfmodel as TP
import repro_torch.dyn as TD
from repro.core.device_dispatch import plan_waves as r_plan_waves
from repro_torch.core import BufferPool, Task
from repro_torch.core.device_dispatch import plan_waves
from repro_torch.core.task import default_segments

import _torch_streams as S

MODELS = ("RTX3060_LIKE", "RTX3070_LIKE", "TPU_V5E_CORE")
POLICIES = ("serial", "acs_sw", "acs_hw", "cudagraph")


def _sim(side, env="cheetah", n_envs=8, group_size=2, steps=2):
    eng = S.sim_engine(side, env=env, n_envs=n_envs, group_size=group_size)
    stream = S.PKG[side].TaskStream()
    for _ in range(steps):
        eng.emit_step(stream)
    return stream.tasks


def _dyn(side, name):
    x = np.random.RandomState(1).randn(1, 3, 32, 32).astype(np.float32)
    if side == "ref":
        init, build, _ = RD.WORKLOADS[name]
        params = init(0)
    else:
        init, build, _ = TD.WORKLOADS[name]
        params = init(0, device="cpu")
    stream = S.PKG[side].TaskStream()
    build(params, stream, x)
    return stream.tasks


STREAMS = {
    "cheetah": _sim,
    "ant": lambda side: _sim(side, env="ant", n_envs=16, group_size=4, steps=3),
    "squeezenet": lambda side: _dyn(side, "squeezenet"),
    "dynamic_routing": lambda side: _dyn(side, "dynamic_routing"),
}
PLAN = {"ref": r_plan_waves, "port": plan_waves}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_model_equals_the_reference_on_the_same_stream(stream):
    tasks = {side: STREAMS[stream](side) for side in S.SIDES}
    assert len(tasks["ref"]) == len(tasks["port"]) > 0
    for rt, pt in zip(tasks["ref"], tasks["port"]):
        assert (rt.opcode, rt.cost_flops, rt.cost_bytes) == (pt.opcode, pt.cost_flops,
                                                           pt.cost_bytes)
    waves = {side: PLAN[side](tasks[side], window_size=32) for side in S.SIDES}
    assert [len(w) for w in waves["ref"]] == [len(w) for w in waves["port"]]
    for name in MODELS:
        rm, pm = getattr(RP, name), getattr(TP, name)
        assert dataclasses.asdict(rm) == dataclasses.asdict(pm)
        for rt, pt in zip(tasks["ref"], tasks["port"]):
            assert RP.kernel_time_us(rt, rm) == TP.kernel_time_us(pt, pm)
            assert RP.kernel_ctas(rt, rm) == TP.kernel_ctas(pt, pm)
        for policy in POLICIES:
            plan = {side: ([[t] for t in tasks[side]] if policy == "serial" else waves[side])
                    for side in S.SIDES}
            construct = 123.25 if policy == "cudagraph" else 0.0
            assert RP.simulate(plan["ref"], rm, policy, construct_us=construct) == \
                TP.simulate(plan["port"], pm, policy, construct_us=construct)


def test_shelf_makespan_equals_the_reference():
    rng = np.random.RandomState(0)
    for _ in range(50):
        items = [(int(rng.randint(1, 40)), float(rng.rand() * 30))
                 for _ in range(rng.randint(1, 30))]
        units = int(rng.randint(1, 140))
        assert TP.shelf_makespan(items, units) == RP.shelf_makespan(items, units)


def test_h100_model_and_refusals():
    h = TP.H100_LIKE
    assert (h.name, h.units) == ("h100", 132)
    assert h.flops_per_us == 67e6 and h.bytes_per_us == 3.35e6
    assert h.launch_us > 0 and h.sync_us > 0 and h.hw_dispatch_us > 0
    tasks = _sim("port")
    waves = plan_waves(tasks, window_size=32)
    times = {p: TP.simulate([[t] for t in tasks] if p == "serial" else waves, h, p)["time_us"]
             for p in POLICIES}
    assert all(t > 0 for t in times.values())
    with pytest.raises(ValueError):
        TP.simulate(waves, h, "teleport")


# -- the reference's seven orderings (tests/test_perfmodel.py), on the port ----

def make_sim_stream(steps=3):
    return _sim("port", env="ant", n_envs=16, group_size=4, steps=steps)


class TestShelf:
    def test_single_item(self):
        span, busy = TP.shelf_makespan([(4, 2.0)], units=8)
        assert span == 2.0 and busy == 8.0

    def test_two_fit_side_by_side(self):
        span, _ = TP.shelf_makespan([(4, 2.0), (4, 3.0)], units=8)
        assert span == 3.0

    def test_overflow_makes_second_shelf(self):
        span, _ = TP.shelf_makespan([(6, 2.0), (6, 3.0)], units=8)
        assert span == 5.0


class TestPolicyOrdering:
    def test_orderings_on_simulation_stream(self):
        tasks = make_sim_stream()
        waves = plan_waves(tasks, window_size=32)
        serial = TP.simulate([[t] for t in tasks], TP.RTX3060_LIKE, "serial")
        sw = TP.simulate(waves, TP.RTX3060_LIKE, "acs_sw")
        hw = TP.simulate(waves, TP.RTX3060_LIKE, "acs_hw")
        assert sw["time_us"] < serial["time_us"], "ACS-SW must beat serial"
        assert hw["time_us"] < sw["time_us"], "ACS-HW must beat ACS-SW"
        assert hw["occupancy"] > serial["occupancy"]

    def test_cudagraph_construction_cost_dominates_dynamic(self):
        tasks = make_sim_stream()
        waves = plan_waves(tasks, window_size=32)
        hw = TP.simulate(waves, TP.RTX3060_LIKE, "acs_hw")
        serial = TP.simulate([[t] for t in tasks], TP.RTX3060_LIKE, "serial")
        construct = 0.47 * serial["time_us"]
        cg = TP.simulate(waves, TP.RTX3060_LIKE, "cudagraph", construct_us=construct)
        assert cg["time_us"] > hw["time_us"]

    def test_cudagraph_amortized_static_competitive(self):
        tasks = make_sim_stream()
        waves = plan_waves(tasks, window_size=32)
        hw = TP.simulate(waves, TP.RTX3060_LIKE, "acs_hw")
        cg = TP.simulate(waves, TP.RTX3060_LIKE, "cudagraph", construct_us=0.0)
        assert cg["time_us"] <= hw["time_us"] * 1.05


class TestKernelModel:
    def test_small_kernel_hits_latency_floor(self):
        pool = BufferPool(device="cpu")
        a = pool.alloc((4,), np.float32, value=np.zeros(4, np.float32))
        b = pool.alloc((4,), np.float32, value=np.zeros(4, np.float32))
        r, w = default_segments((a,), (b,))
        t = Task(opcode="x", fn=lambda v: v, inputs=(a,), outputs=(b,),
                 read_segments=r, write_segments=w, cost_flops=4, cost_bytes=32)
        assert TP.kernel_time_us(t, TP.RTX3060_LIKE) == TP.RTX3060_LIKE.min_kernel_us
        assert TP.kernel_ctas(t, TP.RTX3060_LIKE) == 1
