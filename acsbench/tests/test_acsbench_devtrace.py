"""The reduction of a device trace (``acsbench/devtrace.py``) and the
metrics read from it, on a made-up trace: busy intervals merged, idle
gaps named by what the host was doing, a step's device time, and an
operator's share of its least time, and the idle share of a window
from its busy seconds."""

import types

import pytest

from acsbench import harness
from acsbench.devtrace import Op, Profile, breakdown, busy_intervals


def _profile():
    kernels = [("gemm", 0.10, 0.30), ("add", 0.25, 0.40), ("gemm", 0.60, 0.70),
               ("copy", 1.10, 1.20), ("outside", 2.5, 2.6)]
    host = [("acsbench.step", 0.0, 2.0, 0), ("acsbench.adamw_update", 0.45, 0.9, 1),
            ("aten::mul_", 0.42, 0.55, 2), ("aten::copy_", 0.65, 1.05, 2)]
    ops = [Op("repro_torch::flash_attention_lse",
              [[4, 24, 512, 64], [4, 8, 512, 64], [4, 8, 512, 64]], None, 5e-5),
           Op("repro_torch::flash_attention_bwd",
              [[4, 24, 512, 64], [4, 8, 512, 64], [4, 8, 512, 64], [4, 24, 512, 64],
               [4, 24, 512], [4, 24, 512, 64]], None, 1e-4)]
    return Profile(kernels=kernels, ops=ops, host=host, stretch=(0.0, 2.0), steps=2)


def test_busy_and_gaps():
    p = _profile()
    assert busy_intervals(p.kernels, 0.0, 2.0) == [(0.10, 0.40), (0.60, 0.70), (1.10, 1.20)]
    assert p.busy_per_step_s == pytest.approx((0.3 + 0.1 + 0.1) / 2)
    out = breakdown(p, top=2)
    assert out["device_ops"] == [["gemm", pytest.approx(0.3)], ["add", pytest.approx(0.15)]]
    (first, t1), (second, t2) = out["idle_gaps"]
    assert (t1, t2) == (pytest.approx(0.8), pytest.approx(0.4))
    assert first == "no host operation"                 # 1.2 .. 2.0: the host waits
    assert second == "acsbench.adamw_update: aten::copy_"  # 0.7 .. 1.1


def test_metrics_read_from_the_trace():
    p = _profile()
    spec = types.SimpleNamespace(dtype="bfloat16")
    run = types.SimpleNamespace(profile=p, spec=spec, steps=10, window_s=5.0, busy_s=3.75,
                                span_ms={"optim": [200.0, 220.0]})
    c = harness.counts("flash_attention")
    least = c.bound_s(c.FWD, p.ops[0].shapes) + c.bound_s(c.BWD, p.ops[1].shapes)
    assert harness.per_layer("flash_roofline", run) == pytest.approx(100 * least / 1.5e-4)
    assert harness.per_layer("gmm_roofline", run) is None   # no grouped GEMM call
    assert harness.per_layer("device_idle_pct", run) == pytest.approx(100 * (1 - 3.75 / 5))
    assert harness.per_layer("optim_ms", run) == pytest.approx(210.0)
    assert harness.per_layer("device_idle_pct",
                             types.SimpleNamespace(busy_s=None, window_s=5.0)) is None
