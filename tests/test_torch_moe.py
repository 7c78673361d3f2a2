"""The port's MoE FFN (``repro_torch.models.ffn``) against the reference's
(``repro.models.ffn``) on reduced granite-moe-3b-a800m (4 experts, top-2,
d_model 64, d_expert 32), on the reference's weights and the same seeded
numpy input, with the experts padded for ``tp_size`` 1 (4 experts) and 16
(4 padded to 16, as full width pads 40 to 48), and the variants
``dispatch_groups = 2``, ``combine_dtype = "bfloat16"``, ``n_shared = 1``
and bfloat16 weights.

Held equal: the routing structure (each token's top-k experts and, per
token group, the set of kept (expert, token) pairs), the port's output bit
for bit across two calls, and the padded experts' emptiness. Held close:
the outputs, float32 at 1e-5 (the products and the combine sum in other
orders); a bfloat16 combine at 2^-7 relative (the port sums a token's rows
in float32 and rounds once where the reference rounds each add: at top-2
that is one rounding either way, so the rows' own float32 differences
show as at most one bfloat16 ulp); bfloat16 weights at two bfloat16 ulps
of the output's largest magnitude (2^-6 of it) plus one of each value
(the frameworks round ``silu`` and the products' inputs at different
points, and the combine cancels: single elements differ by one ulp of the
output's scale).

Also the expert-wave stream of ``benchmarks/bench_moe_waves.py`` as
``chip_smoke.py`` builds it for the port: the same tasks and dispatches as
the reference's, run_serial and the wave scheduler bit-equal (with the
benchmark's ``a @ b`` task and with the exactly-rounded one the card's
check uses), and one grouped GEMM over its ragged tiles within 1e-4 of
the tasks' outputs (summation order over D = 64).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as R_ARCHS
from repro.core import WaveScheduler as RWaveScheduler
from repro.models import ffn as RF
from repro_torch.configs import ARCHS
from repro_torch.core import WaveScheduler, run_serial
from repro_torch.kernels import ops
from repro_torch.models import ffn as TF
from repro_torch.models.convert import tensor_from_numpy

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {
    "base": ({}, {}, F32_TOL),
    "dispatch_groups_2": ({"dispatch_groups": 2}, {}, F32_TOL),
    "combine_bfloat16": ({"combine_dtype": "bfloat16"}, {}, dict(rtol=2 ** -7, atol=2 ** -7)),
    "n_shared_1": ({"n_shared": 1}, {}, F32_TOL),
    "bfloat16_weights": ({}, {"dtype": "bfloat16"}, dict(rtol=2 ** -7, scaled_atol=2 ** -6)),
}
B, S = 2, 12


def _cfg(variant):
    moe_kw, cfg_kw, _ = VARIANTS[variant]
    base = ARCHS["granite-moe-3b-a800m"].reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, **moe_kw), **cfg_kw)
    ref_base = R_ARCHS["granite-moe-3b-a800m"].reduced()
    ref_cfg = dataclasses.replace(ref_base, moe=dataclasses.replace(ref_base.moe, **moe_kw),
                                  **cfg_kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return cfg


def _setup(variant, tp_size):
    cfg = _cfg(variant)
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[cfg.dtype]
    ref = RF.init_moe(jax.random.PRNGKey(3), cfg, dtype, tp_size)
    tree = jax.tree.map(np.asarray, ref)
    port_tree = {k: ({kk: tensor_from_numpy(vv, "cpu") for kk, vv in v.items()}
                     if isinstance(v, dict) else tensor_from_numpy(v, "cpu"))
                 for k, v in tree.items()}
    port = TF.MoeFfn(cfg, port_tree)
    x_np = np.random.RandomState(7).randn(B, S, cfg.d_model).astype(np.float32)
    x_ref = jnp.asarray(x_np).astype(dtype)
    x_port = tensor_from_numpy(np.asarray(x_ref), "cpu")
    return cfg, ref, port, x_ref, x_port


def _ref_routing(p, x, cfg):
    """The reference's dispatch, line for line as in ``repro/models/ffn.py``
    ``apply_moe`` (which does not return it)."""
    m = cfg.moe
    b, s, d = x.shape
    e_pad, k = p["w_gate"].shape[0], m.top_k
    g = max(1, min(m.dispatch_groups, b))
    tg = b * s // g
    cap = min(max(int(tg * k / m.n_experts * m.capacity_factor), 1), tg)
    logits = jnp.einsum("gtd,de->gte", x.reshape(g, tg, d).astype(jnp.float32), p["router"])
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    top_p = top_p / (jnp.sum(top_p, axis=-1, keepdims=True) + 1e-9)

    def one_group(tp_g, te_g):
        assign = jnp.zeros((tg, e_pad), jnp.float32)
        assign = assign.at[jnp.arange(tg)[:, None], te_g].set(tp_g)
        return jax.lax.top_k(assign.T, cap)

    top_scores, token_idx = jax.vmap(one_group)(top_p, top_e)
    return tuple(map(np.asarray, (top_p, top_e, token_idx, top_scores, top_scores > 0)))


def _kept_pairs(token_idx, valid):
    """Per token group, the set of kept (expert, token) pairs."""
    return [{(e, int(token_idx[gi, e, c])) for e, c in zip(*np.nonzero(valid[gi]))}
            for gi in range(token_idx.shape[0])]


@pytest.mark.parametrize("tp_size", [1, 16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_routing_structure_equals_the_reference(variant, tp_size):
    cfg, ref, port, x_ref, x_port = _setup(variant, tp_size)
    r_top_p, r_top_e, r_idx, r_scores, r_valid = _ref_routing(ref, x_ref, cfg)
    t = TF.route_moe(port, x_port, cfg)
    assert tuple(t.token_idx.shape) == r_idx.shape
    np.testing.assert_array_equal(np.sort(t.top_e.numpy(), -1), np.sort(r_top_e, -1))
    np.testing.assert_allclose(t.top_p.numpy(), r_top_p, **F32_TOL)
    assert _kept_pairs(t.token_idx.numpy(), t.valid.numpy()) == _kept_pairs(r_idx, r_valid)
    e_pad = port.w_gate.shape[0]
    assert e_pad == TF.padded_experts(cfg, tp_size)
    # padded experts have no router column, so they keep no token
    assert not bool(t.valid[:, cfg.moe.n_experts:].any())
    kept = t.top_scores[t.valid].numpy()
    np.testing.assert_allclose(np.sort(kept), np.sort(r_scores[r_valid]), **F32_TOL)


@pytest.mark.parametrize("tp_size", [1, 16])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_moe_matches_the_reference(variant, tp_size):
    cfg, ref, port, x_ref, x_port = _setup(variant, tp_size)
    want = np.asarray(RF.apply_moe(ref, x_ref, cfg), np.float32)
    got = TF.apply_moe(port, x_port, cfg)
    assert got.dtype == x_port.dtype and tuple(got.shape) == want.shape
    tol = dict(VARIANTS[variant][2])
    if "scaled_atol" in tol:
        tol["atol"] = tol.pop("scaled_atol") * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    again = port(x_port)
    assert torch.equal(again, got)


def test_init_moe_layout_matches_the_reference():
    cfg = _cfg("n_shared_1")
    gen = torch.Generator().manual_seed(0)
    mine = TF.init_moe(gen, cfg, torch.float32, tp_size=16)
    ref = jax.tree.map(np.asarray, RF.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32, 16))
    shapes = lambda tree: {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))  # noqa: E731
                           for k, v in tree.items()}
    assert shapes(mine) == shapes(ref)
    assert mine["router"].dtype == torch.float32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_expert_stream_matches_the_reference_stream():
    from benchmarks.bench_moe_waves import build_expert_stream as ref_stream

    smoke = _chip_smoke()
    r_tasks, (r_xs, r_w, r_tiles), _ = ref_stream(0)
    tasks, (xs, w, tiles), outs = smoke.build_expert_stream("cpu", 0)
    assert len(tasks) == len(r_tasks)
    np.testing.assert_array_equal(tiles, r_tiles)
    np.testing.assert_array_equal(xs, r_xs)
    np.testing.assert_array_equal(w, r_w)
    ours = WaveScheduler(window_size=32, device="cpu").run(tasks)
    theirs = RWaveScheduler(window_size=32).run(r_tasks)
    assert ours.exec_stats["dispatches"] == theirs.exec_stats["dispatches"]
    assert ours.exec_stats["tasks_run"] == len(tasks)


@pytest.mark.parametrize("fn", ["expert_gemm", "expert_gemm_exact"])
def test_expert_stream_serial_wave_and_one_grouped_gemm_agree(fn):
    smoke = _chip_smoke()
    fn = getattr(smoke, fn)
    tasks, (xs, w, tiles), outs = smoke.build_expert_stream("cpu", 0, fn)
    run_serial(tasks, device="cpu")
    serial = torch.stack([o.value for o in outs])
    tasks, _, outs = smoke.build_expert_stream("cpu", 0, fn)
    WaveScheduler(window_size=32, device="cpu").run(tasks)
    wave = torch.stack([o.value for o in outs])
    assert torch.equal(wave.view(torch.int32), serial.view(torch.int32))
    d = xs.shape[-1]
    one = ops.grouped_matmul(torch.from_numpy(xs.reshape(-1, d)), torch.from_numpy(w),
                             torch.from_numpy(tiles), block_m=xs.shape[1])
    np.testing.assert_allclose(one.numpy(), serial.reshape(one.shape).numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fn, op", [("expert_gemm", "mm"), ("expert_gemm_exact", None)])
def test_contraction_op_classifies_the_expert_fns(fn, op):
    """``a @ b`` is a contraction; the exactly rounded fn (elementwise
    multiplies and adds) is not. Both carry the opcode ``expert_gemm``:
    the classification is cached by fn as well as by signature."""
    from repro_torch.core.executors import contraction_op

    smoke = _chip_smoke()
    tasks, _, _ = smoke.build_expert_stream("cpu", 0, getattr(smoke, fn))
    assert contraction_op(tasks[0]) == op


@pytest.mark.parametrize("fn", ["expert_gemm", "expert_gemm_exact"])
def test_expert_stream_cpu_dispatches_equal_the_reference(fn):
    """On the CPU both fns' groups stay one vmapped call each, as in the
    reference (whose benchmark task is ``a @ b``)."""
    from benchmarks.bench_moe_waves import build_expert_stream as ref_stream

    smoke = _chip_smoke()
    tasks, _, _ = smoke.build_expert_stream("cpu", 0, getattr(smoke, fn))
    r_tasks, _, _ = ref_stream(0)
    ours = WaveScheduler(window_size=32, device="cpu").run(tasks)
    theirs = RWaveScheduler(window_size=32).run(r_tasks)
    assert ours.exec_stats["dispatches"] == theirs.exec_stats["dispatches"] < len(tasks)


@pytest.mark.parametrize("fn, per_task", [("expert_gemm", True), ("expert_gemm_exact", False)])
def test_wave_executor_on_a_cuda_device_runs_contraction_groups_task_by_task(
        monkeypatch, fn, per_task):
    """The executor's CUDA route, exercised on CPU tensors: with its device
    set to ``cuda``, the ``a @ b`` group runs one call per task (one
    dispatch each), the exact fn's group stays one call, and both leave
    ``run_serial``'s bits."""
    from repro_torch.core import FusedWaveExecutor
    from repro_torch.core import executors

    smoke = _chip_smoke()
    fn = getattr(smoke, fn)
    tasks, _, outs = smoke.build_expert_stream("cpu", 0, fn)
    run_serial(tasks, device="cpu")
    serial = torch.stack([o.value for o in outs])
    tasks, _, outs = smoke.build_expert_stream("cpu", 0, fn)
    monkeypatch.setattr(executors, "synchronize", lambda device: None)
    ex = FusedWaveExecutor("cpu")
    ex.device = torch.device("cuda")
    report = WaveScheduler(window_size=32, executor=ex, device="cpu").run(tasks)
    wave = torch.stack([o.value for o in outs])
    assert report.exec_stats["dispatches"] == (len(tasks) if per_task else 1)
    assert torch.equal(wave.view(torch.int32), serial.view(torch.int32))


@pytest.mark.parametrize("per_task", [False, True])
@pytest.mark.parametrize("mode", ["wave", "frontier"])
def test_device_window_step_path_runs_the_expert_stream_bit_equal_to_serial(
        monkeypatch, mode, per_task):
    """The device window runs the ``a @ b`` expert stream on its step path
    (one group of 21); vmapped, or (``per_task``, the card's route for a
    contraction, forced on CPU tensors) one call per task, its buffers
    equal ``run_serial``'s bit for bit."""
    from repro_torch.core import DeviceWindowRunner
    from repro_torch.core import device_dispatch

    smoke = _chip_smoke()
    tasks, _, outs = smoke.build_expert_stream("cpu", 0, smoke.expert_gemm)
    run_serial(tasks, device="cpu")
    serial = torch.stack([o.value for o in outs])
    if per_task:
        calls = []
        monkeypatch.setattr(device_dispatch, "_per_task",
                            lambda fn, sig, ins: calls.append(len(ins[0])) or True)
    tasks, _, outs = smoke.build_expert_stream("cpu", 0, smoke.expert_gemm)
    report = DeviceWindowRunner(window_size=32, plan_mode=mode, device="cpu").run(tasks)
    wave = torch.stack([o.value for o in outs])
    assert report.wave_executor == "steps"
    assert torch.equal(wave.view(torch.int32), serial.view(torch.int32))
    if per_task:
        assert calls == [len(tasks)]  # one step group of 21, run task by task


@pytest.mark.parametrize("variant", ["base", "dispatch_groups_2"])
@pytest.mark.parametrize("tp_size", [1, 16])
def test_moe_counters_equal_a_plain_count_of_the_routing(variant, tp_size):
    """With tracing on, the MoE layer's counters are a plain count of the
    dispatch ``route_moe`` gives, and its output is the output off."""
    from repro_torch import trace

    cfg, _, port, _, x_port = _setup(variant, tp_size)
    r = TF.route_moe(port, x_port, cfg)
    off = TF.apply_moe(port, x_port, cfg)
    trace.enable()
    try:
        on = TF.apply_moe(port, x_port, cfg)
        counters = trace.collect()["counters"]
    finally:
        trace.disable()
        trace.collect()
    g, e_pad, cap = r.token_idx.shape
    assert counters["moe.kept_rows"] == int(r.valid.sum())
    assert counters["moe.expert_rows"] == r.valid.sum(dim=(0, 2)).tolist()
    assert counters["moe.capacity_rows"] == g * e_pad * cap
    assert counters["moe.assignments"] == B * S * cfg.moe.top_k
    assert 0 < counters["moe.kept_rows"] <= min(counters["moe.capacity_rows"],
                                                counters["moe.assignments"])
    assert torch.equal(on, off)


def test_moe_rank_branch_is_unchanged_and_uncounted_with_tracing_on():
    """A rank's share of the experts (the mesh branch, ``e_loc != e_pad``)
    gives the same output with tracing on, and adds to no counter."""
    from repro_torch import trace

    cfg, _, port, _, x_port = _setup("base", 1)
    e_pad = port.w_gate.shape[0]
    e0, e_loc = e_pad // 2, e_pad - e_pad // 2
    args = (x_port, port.router, port.w_gate[e0:], port.w_up[e0:], port.w_down[e0:], e0,
            e_pad, None, cfg, torch.float32)
    off = TF._moe_block(*args, cached=False)
    trace.enable()
    try:
        on = TF._moe_block(*args, cached=False)
        got = trace.collect()
    finally:
        trace.disable()
        trace.collect()
    assert e_loc != e_pad and torch.equal(on, off)
    assert got["counters"] == {}
    assert [s["name"] for s in got["spans"]] == ["moe.route", "moe.experts", "moe.combine"]
