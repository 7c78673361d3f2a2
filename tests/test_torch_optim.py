"""The port's optimizer substrate against the reference's, each fed the
same numpy inputs: AdamW (three steps, float32 and bfloat16 params, the
same gradients each step: after its first step AdamW's update is about
lr * sign(g), so a gradient near 0 that differs in its last bit between
two packages' own gradients would flip an update by 2 lr), the global-norm
clip, both schedules, the error-feedback int8 compression and top-k
sparsification (ties at the threshold kept, as ``lax.top_k``'s k-th value
keeps them).

Tolerances: the schedules, the clip and AdamW's state 1e-6 relative (one
or two float32 roundings in another order; XLA may contract a multiply
and an add), the parameters 1e-6 relative in float32 and one bfloat16 ulp
in bfloat16 (the master rounded to bfloat16 once); int8 codes and top-k
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as R_adamw
from repro.optim import compression as R_comp
from repro.optim import schedules as R_sched
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm, cosine_schedule,
                               ef_int8_compress, ef_int8_decompress, topk_compress,
                               wsd_schedule)
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.randn(8, 16)).astype(np.float32),
            "layers": [{"b": (scale * rng.randn(16)).astype(np.float32)},
                       {"b": (scale * rng.randn(16)).astype(np.float32)}],
            "stages": ({"k": (scale * rng.randn(2, 4, 4)).astype(np.float32)},)}


def _np(tree):
    return tree_map(lambda t: np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(
        t, torch.Tensor) else t.float().numpy(), tree)


def _close(a, b, **tol):
    for x, y in zip(tree_leaves(_np(a)), tree_leaves(_np(b))):
        np.testing.assert_allclose(x, y, **(tol or TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference(dtype):
    rng = np.random.RandomState(0)
    params0 = _tree(rng)
    grads = [_tree(rng, scale=s) for s in (1.0, 1e-3, 30.0)]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rparams = tree_map(lambda a: jnp.asarray(a, jdt), params0)
    tparams = tree_map(lambda a: torch.from_numpy(a).to(tdt), params0)
    rstate, tstate = R_adamw.adamw_init(rparams), adamw_init(tparams)
    lr = 3e-3
    for g in grads:
        rparams, rstate = R_adamw.adamw_update(rparams, tree_map(jnp.asarray, g), rstate,
                                               jnp.asarray(lr, jnp.float32))
        out, tstate = adamw_update(tparams, tree_map(torch.from_numpy, g), tstate, lr)
        assert out is tparams
    assert int(tstate["step"]) == int(rstate["step"]) == 3
    for key in ("master", "m", "v"):
        _close(tstate[key], rstate[key])
    if dtype == "float32":
        _close(tparams, rparams)
    else:  # the same float32 master, rounded to bf16 once: at most one ulp apart
        _close(tparams, rparams, rtol=2 ** -7, atol=0)


def test_adamw_init_copies_float32_params():
    p = {"w": torch.ones(3)}
    state = adamw_init(p)
    assert state["master"]["w"] is not p["w"] and state["master"]["w"].dtype == torch.float32
    state["master"]["w"].add_(1)
    assert float(p["w"][0]) == 1.0 and state["step"].dtype == torch.int32


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    g = _tree(np.random.RandomState(1), scale=3.0)
    rg, rn = R_adamw.clip_by_global_norm(tree_map(jnp.asarray, g), max_norm)
    tg, tn = clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
    np.testing.assert_allclose(float(tn), float(rn), **TOL)
    _close(tg, rg)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tg))


def test_schedules_match_the_reference():
    cos_r, cos_t = R_sched.cosine_schedule(3e-4, 20, 400), cosine_schedule(3e-4, 20, 400)
    wsd_r = R_sched.wsd_schedule(1e-2, warmup=10, stable=50, decay=40)
    wsd_t = wsd_schedule(1e-2, warmup=10, stable=50, decay=40)
    for step in (0, 1, 5, 19, 20, 21, 59, 60, 61, 99, 100, 250, 399, 400, 1000):
        for r, t in ((cos_r, cos_t), (wsd_r, wsd_t)):
            want = float(r(jnp.asarray(step)))
            np.testing.assert_allclose(float(t(step)), want, **TOL)
            np.testing.assert_allclose(float(t(torch.tensor(step))), want, **TOL)
    assert t(3).dtype == torch.float32


def test_ef_int8_matches_the_reference():
    rng = np.random.RandomState(2)
    g, e = _tree(rng), _tree(rng, scale=1e-2)
    rq, rs, re = R_comp.ef_int8_compress(tree_map(jnp.asarray, g), tree_map(jnp.asarray, e))
    tq, ts, te = ef_int8_compress(tree_map(torch.from_numpy, g), tree_map(torch.from_numpy, e))
    for a, b in zip(tree_leaves(tq), tree_leaves(rq)):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(ts, rs)
    _close(te, re, rtol=1e-5, atol=1e-6)
    _close(ef_int8_decompress(tq, ts), R_comp.ef_int8_decompress(rq, rs))
    # error feedback: g + e = dequant + new error
    for a, b, c, d in zip(tree_leaves(g), tree_leaves(e), tree_leaves(ef_int8_decompress(tq, ts)),
                          tree_leaves(te)):
        np.testing.assert_allclose((c + d).numpy(), a + b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("frac", [0.01, 0.25, 0.5, 1.0])
def test_topk_matches_the_reference(frac):
    rng = np.random.RandomState(3)
    g = _tree(rng)
    g["ties"] = np.array([0.5, -0.5, 0.5, 0.1, -0.5, 0.2, 0.5, 0.0], np.float32)
    want = R_comp.topk_compress(tree_map(jnp.asarray, g), frac)
    got = topk_compress(tree_map(torch.from_numpy, g), frac)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_keeps_every_tie_at_the_threshold():
    got = topk_compress({"w": torch.tensor([0.1, -5.0, 0.2, 3.0, -3.0])}, frac=0.4)
    np.testing.assert_array_equal(got["w"].numpy(), [0.0, -5.0, 0.0, 3.0, -3.0])
