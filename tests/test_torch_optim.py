"""The port's optimizer substrate against the reference's, each fed the
same numpy inputs: AdamW (three steps, float32 and bfloat16 params, the
same gradients each step: after its first step AdamW's update is about
lr * sign(g), so a gradient near 0 that differs in its last bit between
two packages' own gradients would flip an update by 2 lr), the global-norm
clip, both schedules, the error-feedback int8 compression and top-k
sparsification (ties at the threshold kept, as ``lax.top_k``'s k-th value
keeps them). The clip and AdamW on plain CPU tensors (``ScaledGrads``, the
plain version of ``kernels/adamw.py``) bit for bit against the per-leaf
formulas the port ran before them (a float32 copy of every clipped
gradient, then the update leaf by leaf): over bfloat16, float16 and float32
leaves, at a scale of 1 and below it, lr a float or a tensor, through the
``Trainer``'s error-feedback branch; the wrappers' routing.

Tolerances: the schedules, the clip and AdamW's state 1e-6 relative (one
or two float32 roundings in another order; XLA may contract a multiply
and an add), the parameters 1e-6 relative in float32 and one bfloat16 ulp
in bfloat16 (the master rounded to bfloat16 once); int8 codes and top-k
exact."""

import copy
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as R_adamw
from repro.optim import compression as R_comp
from repro.optim import schedules as R_sched
from repro_torch.optim import (ScaledGrads, adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, ef_int8_compress, ef_int8_decompress,
                               topk_compress, wsd_schedule)
from repro_torch.tree import tree_leaves, tree_map

fused = importlib.import_module("repro_torch.kernels.adamw")

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
    assert isinstance(tg, ScaledGrads)  # on plain tensors: the gradients and the scale
    tg = tg.materialize()
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


# ---------------------------------------------------------------------------
# The clip and AdamW on plain tensors against the per-leaf formulas the port
# ran before ``ScaledGrads`` and ``kernels/adamw.py``
# ---------------------------------------------------------------------------

def _clip_per_leaf(grads, max_norm):
    """The float32 tree and the norm, as the port's clip computed them."""
    sq = torch.zeros((), dtype=torch.float32)
    for g in tree_leaves(grads):
        sq = sq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


@torch.no_grad()
def _adamw_per_leaf(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """The port's per-leaf AdamW update, in place."""
    state["step"] += 1
    step = state["step"].float()
    c1 = 1.0 - torch.pow(b1, step)
    c2 = 1.0 - torch.pow(b2, step)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)
    for p, master, g, m, v in zip(tree_leaves(params), tree_leaves(state["master"]),
                                  tree_leaves(grads), tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        update = (m / c1).div_(torch.sqrt(v / c2).add_(eps)).add_(weight_decay * master)
        master.sub_(lr * update)
        p.copy_(master)


def _mixed_tree(rng, scale=1.0):
    """Leaves of every dtype the kernels take, odd sizes among them."""
    def t(shape, dt):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to(dt)

    return {"w": t((8, 16), torch.bfloat16), "b": t((7,), torch.float16),
            "one": t((1,), torch.float32), "k": t((3, 5, 9), torch.float32),
            "e": t((4097,), torch.bfloat16)}


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def _same_bits(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])  # a scale below 1, and exactly 1
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_clip_and_adamw_equal_the_per_leaf_formulas(max_norm, lr_kind):
    rng = np.random.RandomState(4)
    params = _mixed_tree(rng)
    grads = [_mixed_tree(rng, scale=s) for s in (1.0, 1e-3, 30.0)]
    mine, theirs = params, copy.deepcopy(params)
    s_mine, s_theirs = adamw_init(mine), adamw_init(theirs)
    for step, g in enumerate(grads):
        lr = 3e-3 * (step + 1)
        lr = torch.tensor(lr) if lr_kind == "tensor" else lr
        clipped, gnorm = clip_by_global_norm(g, max_norm)
        want, want_norm = _clip_per_leaf(g, max_norm)
        assert torch.equal(_bits(gnorm), _bits(want_norm))
        assert torch.equal(clipped.scale, torch.clamp(max_norm / (want_norm + 1e-9), max=1.0))
        assert clipped.grads is g  # no copy
        _same_bits(clipped.materialize(), want)
        adamw_update(mine, clipped, s_mine, lr)
        _adamw_per_leaf(theirs, want, s_theirs, lr)
        _same_bits(mine, theirs)
        for key in ("master", "m", "v"):
            _same_bits(s_mine[key], s_theirs[key])
    assert int(s_mine["step"]) == 3
    # a plain tree of gradients (no clip) takes the same formulas
    adamw_update(mine, grads[0], s_mine, 1e-3)
    _adamw_per_leaf(theirs, grads[0], s_theirs, 1e-3)
    _same_bits(mine, theirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_then_adamw_match_the_reference(dtype):
    rng = np.random.RandomState(5)
    params0 = _tree(rng)
    grads = [_tree(rng, scale=s) for s in (1.0, 30.0)]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rparams = tree_map(lambda a: jnp.asarray(a, jdt), params0)
    tparams = tree_map(lambda a: torch.from_numpy(a).to(tdt), params0)
    rstate, tstate = R_adamw.adamw_init(rparams), adamw_init(tparams)
    for g in grads:
        rg, _ = R_adamw.clip_by_global_norm(tree_map(lambda a: jnp.asarray(a, jdt), g), 1.0)
        rparams, rstate = R_adamw.adamw_update(rparams, rg, rstate, jnp.asarray(2e-3, jnp.float32))
        tg, _ = clip_by_global_norm(tree_map(lambda a: torch.from_numpy(a).to(tdt), g), 1.0)
        adamw_update(tparams, tg, tstate, 2e-3)
    for key in ("master", "m", "v"):
        _close(tstate[key], rstate[key], rtol=1e-5, atol=1e-7)
    if dtype == "float32":
        _close(tparams, rparams, rtol=1e-5, atol=1e-7)
    else:
        _close(tparams, rparams, rtol=2 ** -7, atol=0)


def test_trainer_error_feedback_step_equals_the_per_leaf_path(tmp_path):
    from repro_torch.configs import ARCHS
    from repro_torch.models import loss_and_grads
    from repro_torch.runtime.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(ARCHS["h2o-danube-3-4b"].reduced(), n_layers=2, d_model=32,
                              d_ff=64, vocab=128, n_heads=2, n_kv_heads=1, head_dim=16)
    t = Trainer(cfg, TrainerConfig(seq_len=16, batch=4, total_steps=4, checkpoint_every=4,
                                   lr=5e-3, grad_compression=True), tmp_path / "ck",
                device="cpu")
    model, opt = copy.deepcopy(t.model), copy.deepcopy(t.opt)
    err = tree_map(torch.clone, t.err)
    for step in range(2):
        inputs, labels = (torch.from_numpy(a) for a in t.pipeline.next_batch())
        lr = t.schedule(step)
        got = t._step(inputs, labels, lr)
        loss, grads = loss_and_grads(model, cfg, inputs, labels)
        clipped, gnorm = _clip_per_leaf(grads, t.tcfg.clip)
        q, scales, err = ef_int8_compress(clipped, err)
        _adamw_per_leaf(model.param_tree(), ef_int8_decompress(q, scales), opt, lr)
        assert torch.equal(got["loss"], loss) and torch.equal(got["gnorm"], gnorm)
        _same_bits(t.err, err)
        _same_bits(t.model.param_tree(), model.param_tree())
        for key in ("master", "m", "v"):
            _same_bits(t.opt[key], opt[key])


def test_the_wrappers_route_by_what_they_see():
    g = [torch.ones(3), torch.ones(2)]
    before = dict(fused.paths), fused.launches, fused.norm_launches
    gnorm, scale = fused.global_norm(g, 1.0)  # CPU: the plain version, nothing counted
    assert float(gnorm) == pytest.approx(5 ** 0.5) and float(scale) == pytest.approx(5 ** -0.5)
    state = adamw_init(g)
    adamw_update(g, [torch.ones(3), torch.ones(2)], state, 1e-3)
    assert (dict(fused.paths), fused.launches, fused.norm_launches) == before
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.global_norm([torch.ones(3, device="meta")], 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused.adamw_step([torch.ones(2, device="meta")], g[:1], g[:1], g[:1], g[:1], scale=None,
                         c1=scale, c2=scale, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8,
                         weight_decay=0.1)
    with pytest.raises(ValueError, match="gradients"):
        fused.adamw_step(g, g[:1], g, g, g, scale=None, c1=scale, c2=scale, lr=1e-3, b1=0.9,
                         b2=0.95, eps=1e-8, weight_decay=0.1)
    fused.adamw_step([], [], [], [], [], scale=None, c1=scale, c2=scale, lr=1e-3, b1=0.9,
                     b2=0.95, eps=1e-8, weight_decay=0.1)  # no leaves: nothing to do


@pytest.mark.parametrize("ptrs,sizes,width,want", [
    ((0x1000,), (4,), 4, 0), ((0x1004,), (4,), 4, 3), ((0x1008,), (4,), 4, 2),
    ((0x100C,), (4,), 4, 1), ((0x1002,), (2,), 4, 3), ((0x1006,), (2,), 4, 1),
    ((0x1002,), (2,), 8, 7), ((0x100E,), (2,), 8, 1),
    ((0x1002, 0x2004, 0x3004), (2, 4, 4), 4, 3),  # all five of an update share a phase
    ((0x1000, 0x2004), (2, 4), 4, -1), ((0x1002, 0x2000), (2, 4), 4, -1)])
def test_the_first_element_every_pointer_aligns_at(ptrs, sizes, width, want):
    """The elements a kernel runs one by one before its vectors: the first
    index at which every pointer reaches a ``width``-element boundary."""
    assert fused._head(ptrs, sizes, width) == want
    if want >= 0:
        assert all((ptr + want * size) % (width * size) == 0 for ptr, size in zip(ptrs, sizes))


@pytest.mark.parametrize("entry", ["acs_adamw_norm_blocks", "acs_adamw_norm", "acs_adamw_update"])
def test_the_kernels_entry_points_bind_every_argument(entry):
    """Each C entry point's parameters, read from ``csrc/adamw.cu``, match
    the ``argtypes`` the wrapper binds (a missing pointer would shift every
    later argument)."""
    import ctypes
    import re

    text = fused.SOURCE.read_text()
    params = [p.strip() for p in re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                                           text).group(1).split(",") if p.strip()]

    class Lib:
        pass

    lib = Lib()
    for name in re.findall(r'extern "C" int (\w+)\(', text):
        setattr(lib, name, type("Fn", (), {})())
    fused._bind(lib)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float ")
             else ctypes.c_longlong if p.startswith("long long ") else ctypes.c_int
             for p in params]
    assert getattr(lib, entry).argtypes == kinds
    assert getattr(lib, entry).restype is ctypes.c_int


def test_the_wrappers_table_matches_the_source():
    """The chunk size and the table row the wrapper builds are the source's."""
    import re

    text = fused.SOURCE.read_text()
    assert int(re.search(r"constexpr long long kChunk = (\d+);", text).group(1)) == fused.CHUNK
    leaf = re.search(r"struct Leaf \{(.*?)\};", text, re.S).group(1)
    fields = [f for line in leaf.splitlines()
              for f in re.findall(r"(\w+)[,;]", line.split("//")[0])]
    assert fields == ["p", "g", "master", "m", "v", "numel", "meta", "chunk_begin"]
    assert len(fields) == fused._FIELDS


def test_the_state_rows_are_built_once_and_rebuilt_when_the_state_changes():
    """The update's rows of the parameters and the state are checked and
    built when first met and kept while the same tensors hold the same
    storage (CPU tensors stand in for a card's: device index -1)."""
    fused._STATE_ROWS.clear()
    params = [torch.ones(3, dtype=torch.bfloat16), torch.ones(0), torch.ones(2, 5)]
    state = adamw_init(params)
    first = fused._state_rows(params, state["master"], state["m"], state["v"], -1)
    shapes, rows, heads, chunks = first
    assert shapes == [p.shape for p in params] and rows.shape == (2, fused._FIELDS)
    assert rows[:, 0].tolist() == [params[0].data_ptr(), params[2].data_ptr()]
    assert rows[:, 1].tolist() == [0, 0]  # the gradients' column, filled in each step
    assert rows[:, 5].tolist() == [3, 10] and rows[:, 6].tolist() == [1, 0]
    assert rows[:, 7].tolist() == [0, 1] and chunks == 2 and len(heads) == 2
    assert fused._state_rows(params, state["master"], state["m"], state["v"], -1) is first
    state["m"] = [t.clone() for t in state["m"]]  # new tensors: rebuilt
    second = fused._state_rows(params, state["master"], state["m"], state["v"], -1)
    assert second is not first
    assert second[1][:, 3].tolist() == [state["m"][0].data_ptr(), state["m"][2].data_ptr()]
    params[2].data = torch.zeros(2, 5)  # new storage under the same tensor: rebuilt
    third = fused._state_rows(params, state["master"], state["m"], state["v"], -1)
    assert third is not second and third[1][1, 0] == params[2].data_ptr()
    with pytest.raises(TypeError, match="m must be one of"):
        fused._state_rows(params, state["master"], [t.double() for t in state["m"]],
                          state["v"], -1)
    with pytest.raises(ValueError, match="shape"):
        fused._state_rows(params, state["master"], state["m"],
                          [torch.zeros(4)] + state["v"][1:], -1)


class _Sub(torch.Tensor):
    """A tensor subclass, which the kernels refuse."""


@pytest.mark.parametrize("case,want", [
    ("good", None), ("float64", "gradient must be one of"), ("strided", "contiguous"),
    ("shape", "shape"), ("device", "one CUDA device"), ("subclass", "one CUDA device")])
def test_one_check_takes_or_refuses_a_leaf(case, want):
    """``_fault``: what the kernels take and the error each refusal raises
    (CPU tensors stand in for a card's: device index -1)."""
    t = {"good": torch.ones(2, 3), "float64": torch.ones(2, 3, dtype=torch.float64),
         "strided": torch.ones(3, 2).t(), "shape": torch.ones(3, 2),
         "device": torch.ones(2, 3), "subclass": torch.ones(2, 3).as_subclass(_Sub)}[case]
    err = fused._fault("adamw_step", "gradient", t, 0 if case == "device" else -1,
                       (torch.float32, torch.bfloat16), torch.Size((2, 3)))
    if want is None:
        assert err is None
    else:
        assert isinstance(err, TypeError if case == "float64" else ValueError)
        assert want in str(err)


@pytest.mark.parametrize("seed", range(4))
def test_the_update_table_heads_equal_the_five_pointers_head(seed):
    """``_with_grads`` fills in each row's gradient and the head of all
    five pointers as ``_head`` finds it."""
    rng = np.random.RandomState(seed)
    rows, heads, want, ptrs, sizes, codes = [], [], [], [], [], []
    for i in range(64):
        p_size, g_size = (2, 4)[rng.randint(2)], (2, 4)[rng.randint(2)]
        if i % 2:  # anywhere within a 16-byte line
            p, g = (0x10000 + size * rng.randint(0, 8) for size in (p_size, g_size))
            w, m, v = (0x10000 * j + 4 * rng.randint(0, 4) for j in (2, 3, 4))
        else:  # all five at one phase
            k = rng.randint(0, 4)
            p, g = 0x10000 + p_size * k, 0x50000 + g_size * k
            w, m, v = (0x10000 * j + 4 * k for j in (2, 3, 4))
        rows.append((p, 0, w, m, v, 100, 1 if p_size == 2 else 0, i))
        heads.append(fused._head((p, w, m, v), (p_size, 4, 4, 4), 4))
        want.append(fused._head((p, g, w, m, v), (p_size, g_size, 4, 4, 4), 4))
        ptrs.append(g)
        sizes.append(g_size)
        codes.append(1 if g_size == 2 else 0)
    table = fused._with_grads(np.array(rows, dtype=np.int64), np.array(heads), ptrs, sizes,
                              codes)
    assert table[:, 1].tolist() == ptrs
    assert (table[:, 6] & 0xFF).tolist() == [r[6] for r in rows]
    assert ((table[:, 6] >> 8) & 0xFF).tolist() == codes
    assert ((table[:, 6] >> 16) - 1).tolist() == want
    assert any(h >= 0 for h in want) and any(h < 0 for h in want)
