"""The backward kernels' plain versions and autograd Functions on the CPU,
held to the reference on the same seeded numpy inputs.

* ``grouped_matmul_bwd_ref`` (dx, dw) against ``jax.vjp`` of the
  reference's ``grouped_matmul_ref``: one tile a group, repeated groups, a
  group no tile names (dw exactly 0), ``block_m`` 1 and 8, the two-group
  capacity layout; float32 and bfloat16.
* ``lru_scan_bwd_ref`` (da, db, dh0) against ``jax.vjp`` of the
  reference's ``lru_scan_ref``, B {1, 3} x S {1, 37, 64} x D {7, 40};
  float32, and bfloat16 at D 40.
* ``attention_bwd_ref`` at D 256 against ``jax.vjp`` of the reference's
  ``attention_ref``: MQA, a window shorter than S, ``prefix_len``,
  softcap; and at Dv != D (the reduced MLA's 16 / 8 and 48 / 32): causal,
  a window, ``prefix_len``, a ragged Sk, softcap without the causal mask.
* ``selective_scan_bwd_ref`` and ``mamba_scan_bwd_ref`` (the selective
  scan's plain backwards, from the formulas) against ``torch.autograd``
  through ``selective_scan_ref`` / ``mamba_scan_ref``: B {1, 3} x S {1, 37,
  70} x E {8, 24} x N {1, 4, 16}, float32 and bfloat16, with hT's gradient
  too; z, b and c strided views of wider projections for the fused entry.
* The port's ``apply_mamba`` under grad (its scan through
  ``_MambaScanFunction``, whose backward is ``mamba_scan_bwd_ref`` on the
  CPU): every weight's gradient and the input's (and the initial state's)
  against ``jax.vjp`` of the reference's ``apply_mamba``.
* Each Function (``grouped_matmul``, ``lru_scan`` under grad) on the CPU
  against ``torch.autograd`` through its plain forward, and which inputs
  get a gradient.
* Reduced granite-moe-3b-a800m, recurrentgemma-2b, falcon-mamba-7b and
  deepseek-v2-236b through ``loss_and_grads`` against
  ``jax.value_and_grad``, with the backward going through the Functions'
  plain backward once per expert product, RG-LRU layer and Mamba layer.

Tolerances, each relative to the largest entry of the reference's
gradient (``_close``):
* float32 1e-5: the same sums in another order (XLA's dot and scan
  transpose against torch's einsum and the step loop).
* grouped GEMM bfloat16 2^-7: both sum each tile's product in float32
  and round to bfloat16, but XLA's transpose of the gather rounds each
  tile's dw to bfloat16 and adds the tiles of a group in bfloat16, where
  the port adds them in float32 and rounds once: a bfloat16 ulp (2^-8)
  a tile sum apart, two at most over these cases.
* The selective scan's plain backwards against autograd: float32 1e-5
  (the same formulas, summed in other orders: einsum against autograd's
  reductions); bfloat16 2^-7: both compute in float32 from the same
  bfloat16 inputs and round each gradient to bfloat16 once, so a float32
  difference in the last bits can move a rounding by one bfloat16 ulp
  (2^-8 of the entry).
* ``apply_mamba`` against the reference, float32 1e-5: XLA's transpose of
  its ``lax.scan`` and the plain backward's reverse loop sum in other
  orders.
* RG-LRU bfloat16 2e-2 (the forward's own test tolerance): the
  reference's derivative multiplies by the float32 carry h_{t-1}, the port
  by the saved output h, rounded to bfloat16 (2^-9 relative each step).
* The Functions against autograd through their plain forwards: float32
  bit for bit (the same products and sums in the same order), the grouped
  GEMM's repeated groups 1e-6 (autograd's index backward adds a group's
  tiles in its own order); bfloat16 as the grouped GEMM above.
* The reduced models: test_torch_train.py's (loss 1e-5 relative, each
  leaf 1e-4 of its largest entry).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro.kernels import ref as R
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T
from repro_torch.models import loss_and_grads, params_from_numpy
from repro_torch.models.convert import tree_to_numpy
from repro_torch.tree import tree_leaves_with_names

gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
ls = importlib.import_module("repro_torch.kernels.lru_scan")
ss = importlib.import_module("repro_torch.kernels.selective_scan")

T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _close(got, want, rel, what=""):
    """``got`` within ``rel`` of ``want``'s largest entry, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-30, err_msg=what)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# grouped GEMM
# ---------------------------------------------------------------------------

# (G, K, N, block_m, tile group ids)
GMM_CASES = {
    "one_tile_a_group": (4, 24, 16, 8, (0, 1, 2, 3)),
    "repeated_groups": (4, 32, 48, 8, (0, 0, 1, 2, 2, 3)),
    "unused_group": (5, 16, 40, 8, (0, 4, 4, 1, 3)),  # group 2 has no tile
    "block_m_1": (6, 24, 40, 1, (5, 0, 0, 3, 1, 2, 4, 4)),
    "two_dispatch_groups": (4, 16, 24, 3, (0, 1, 2, 3) * 2),
}
GMM_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _gmm_inputs(case, seed=0):
    g, k, n, bm, tiles = GMM_CASES[case]
    rng = np.random.RandomState(seed + sum(map(ord, case)))
    m = len(tiles) * bm
    return (rng.randn(m, k).astype(np.float32), rng.randn(g, k, n).astype(np.float32),
            np.asarray(tiles, np.int32), rng.randn(m, n).astype(np.float32), bm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_bwd_ref_matches_jax_vjp(case, dtype):
    x, w, tiles, dy, bm = _gmm_inputs(case)
    xt, wt, dyt = (torch.from_numpy(a).to(T_DTYPES[dtype]) for a in (x, w, dy))
    dx, dw = T.grouped_matmul_bwd_ref(xt, wt, torch.from_numpy(tiles), dyt, block_m=bm)
    assert dx.dtype == dw.dtype == T_DTYPES[dtype]
    jd = J_DTYPES[dtype]
    _, vjp = jax.vjp(lambda a, b: R.grouped_matmul_ref(a, b, jnp.asarray(tiles), block_m=bm),
                     jnp.asarray(_np(xt), jd), jnp.asarray(_np(wt), jd))
    want_dx, want_dw = vjp(jnp.asarray(_np(dyt), jd))
    _close(_np(dx), want_dx, GMM_TOL[dtype], "dx")
    _close(_np(dw), want_dw, GMM_TOL[dtype], "dw")
    for unused in sorted(set(range(w.shape[0])) - set(tiles.tolist())):
        assert bool((dw[unused] == 0).all())


def test_grouped_matmul_bwd_ref_sums_tiles_in_tile_order():
    """dw of a repeated group is the float32 sum of its tiles' products in
    tile order, rounded once; a tile with a bad id gets dx 0 and adds
    nothing to dw."""
    x, w, tiles, dy, bm = _gmm_inputs("repeated_groups")
    tiles = tiles.copy()
    tiles[3] = 9  # outside [0, G)
    xt, wt, dyt = (torch.from_numpy(a) for a in (x, w, dy))
    dx, dw = T.grouped_matmul_bwd_ref(xt, wt, torch.from_numpy(tiles), dyt, block_m=bm)
    assert bool((dx[3 * bm: 4 * bm] == 0).all())
    want = torch.zeros_like(wt)
    for t, gid in enumerate(tiles):
        if gid < wt.shape[0]:
            want[gid] += xt[t * bm: (t + 1) * bm].T @ dyt[t * bm: (t + 1) * bm]
    torch.testing.assert_close(dw, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one_tile_a_group", "repeated_groups", "block_m_1"])
def test_grouped_matmul_function_matches_autograd_through_plain(case, dtype):
    x, w, tiles, dy, bm = _gmm_inputs(case, seed=3)
    grads = []
    for fn in (ops.grouped_matmul, T.grouped_matmul_ref):
        xt, wt = (torch.from_numpy(a).to(T_DTYPES[dtype]).requires_grad_(True) for a in (x, w))
        out = fn(xt, wt, torch.from_numpy(tiles), block_m=bm)
        if fn is ops.grouped_matmul:
            assert type(out.grad_fn).__name__ == (
                "GeneratedBackwardFor_repro_torch_grouped_matmul_fwd_defaultBackward")
        out.backward(torch.from_numpy(dy).to(T_DTYPES[dtype]))
        grads.append((xt.grad, wt.grad))
    (gx, gw), (wx, ww) = grads
    if dtype == "float32" and case != "repeated_groups":
        assert torch.equal(gx, wx) and torch.equal(gw, ww)
    tol = 1e-6 if dtype == "float32" else GMM_TOL[dtype]
    _close(_np(gx), _np(wx), tol, "dx")
    _close(_np(gw), _np(ww), tol, "dw")


def test_grouped_matmul_function_grads_only_what_needs_one():
    """Only the inputs that need a gradient get one; the tile ids and the
    error flag get none; the forward's bits are the plain version's."""
    x, w, tiles, dy, bm = _gmm_inputs("unused_group")
    tg = torch.from_numpy(tiles)
    for need_x, need_w in ((True, False), (False, True), (True, True)):
        xt = torch.from_numpy(x).requires_grad_(need_x)
        wt = torch.from_numpy(w).requires_grad_(need_w)
        out = gm.grouped_matmul(xt, wt, tg, block_m=bm)
        assert torch.equal(out.detach(), T.grouped_matmul_ref(xt.detach(), wt.detach(), tg,
                                                              block_m=bm))
        out.backward(torch.from_numpy(dy))
        assert (xt.grad is not None) == need_x and (wt.grad is not None) == need_w
    assert gm.launches == 0 and gm.dx_launches == 0 and gm.dw_launches == 0


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

LRU_SWEEP = ([(b, s, d, "float32") for b in (1, 3) for s in (1, 37, 64) for d in (7, 40)]
             + [(b, s, 40, "bfloat16") for b in (1, 3) for s in (1, 37, 64)])
LRU_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _lru_inputs(b, s, d, seed=0):
    rng = np.random.RandomState(seed + 100 * b + 10 * s + d)
    return (rng.uniform(0.5, 0.99, (b, s, d)).astype(np.float32),
            rng.randn(b, s, d).astype(np.float32), rng.randn(b, d).astype(np.float32),
            rng.randn(b, s, d).astype(np.float32))


@pytest.mark.parametrize("b,s,d,dtype", LRU_SWEEP,
                         ids=[f"b{b}-s{s}-d{d}-{dt}" for b, s, d, dt in LRU_SWEEP])
def test_lru_scan_bwd_ref_matches_jax_vjp(b, s, d, dtype):
    a, x, h0, dh = _lru_inputs(b, s, d)
    at, xt, dht = (torch.from_numpy(v).to(T_DTYPES[dtype]) for v in (a, x, dh))
    h0t = torch.from_numpy(h0)
    h = T.lru_scan_ref(at, xt, h0t)
    da, db, dh0 = T.lru_scan_bwd_ref(at, h, h0t, dht)
    assert da.dtype == db.dtype == T_DTYPES[dtype] and dh0.dtype == torch.float32
    jd = J_DTYPES[dtype]
    _, vjp = jax.vjp(R.lru_scan_ref, jnp.asarray(_np(at), jd), jnp.asarray(_np(xt), jd),
                     jnp.asarray(h0))
    want = vjp(jnp.asarray(_np(dht), jd))
    for name, got, w in zip(("da", "db", "dh0"), (da, db, dh0), want):
        _close(_np(got), w, LRU_TOL[dtype], name)


@pytest.mark.parametrize("need_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_function_matches_autograd_through_plain(dtype, need_h0):
    a, x, h0, dh = _lru_inputs(2, 37, 40, seed=5)
    grads = []
    for fn in (ops.lru_scan, T.lru_scan_ref):
        at, xt = (torch.from_numpy(v).to(T_DTYPES[dtype]).requires_grad_(True) for v in (a, x))
        h0t = torch.from_numpy(h0).requires_grad_(need_h0)
        out = fn(at, xt, h0t)
        if fn is ops.lru_scan:
            assert type(out.grad_fn).__name__ == (
                "GeneratedBackwardFor_repro_torch_lru_scan_defaultBackward")
            assert torch.equal(out.detach(), T.lru_scan_ref(at.detach(), xt.detach(),
                                                            h0t.detach()))
        out.backward(torch.from_numpy(dh).to(T_DTYPES[dtype]))
        grads.append((at.grad, xt.grad, h0t.grad))
    assert (grads[0][2] is not None) == need_h0
    for name, g, w in zip(("da", "db", "dh0"), *grads):
        if w is None:
            continue
        if dtype == "float32":
            assert torch.equal(g, w), name
        else:
            _close(_np(g), _np(w), LRU_TOL[dtype], name)
    assert ls.launches == 0 and ls.backward_launches == 0


# ---------------------------------------------------------------------------
# Attention at D 256
# ---------------------------------------------------------------------------

# (b, h, hkv, s, d), flags: recurrentgemma's MQA with a window shorter than
# S, paligemma's prefix (with a window inside it), softcap over GQA.
ATTN_D256 = [((1, 4, 1, 40, 256), {"window": 16}),
             ((2, 4, 1, 36, 256), {"window": 8, "prefix_len": 12}),
             ((1, 4, 2, 33, 256), {"softcap": 3.0, "prefix_len": 5})]


@pytest.mark.parametrize("case", range(len(ATTN_D256)))
def test_attention_bwd_ref_at_d256_matches_jax_vjp(case):
    (b, h, hkv, s, d), flags = ATTN_D256[case]
    rng = np.random.RandomState(40 + case)
    q, do = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, hkv, s, d).astype(np.float32) for _ in range(2))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out = T.attention_ref(qt, kt, vt, **flags)
    lse = T.attention_lse_ref(qt, kt, **flags)
    got = T.attention_bwd_ref(qt, kt, vt, out, lse, dot, **flags)
    rout, vjp = jax.vjp(lambda a, b_, c: R.attention_ref(a, b_, c, **flags),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(_np(out), rout, 1e-5, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        _close(_np(g), w, 1e-5, name)


# Dv != D: (b, h, hkv, sq, sk, d, dv), flags. The reduced MLA's 16 / 8 and a
# wider 48 / 32: causal, a window, a prefix, Sk past Sq (a query offset),
# softcap without the causal mask over GQA.
ATTN_DV = [((1, 4, 4, 20, 20, 16, 8), {}),
           ((2, 4, 2, 24, 24, 16, 8), {"window": 7}),
           ((1, 4, 1, 30, 30, 48, 32), {"prefix_len": 6}),
           ((1, 2, 2, 17, 29, 48, 32), {"q_offset": 12}),
           ((1, 4, 2, 20, 20, 16, 8), {"causal": False, "window": 5, "softcap": 3.0})]


@pytest.mark.parametrize("case", range(len(ATTN_DV)))
def test_attention_bwd_ref_at_dv_ne_d_matches_jax_vjp(case):
    (b, h, hkv, sq, sk, d, dv), flags = ATTN_DV[case]
    rng = np.random.RandomState(60 + case)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    do = rng.randn(b, h, sq, dv).astype(np.float32)
    k = rng.randn(b, hkv, sk, d).astype(np.float32)
    v = rng.randn(b, hkv, sk, dv).astype(np.float32)
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out = T.attention_ref(qt, kt, vt, **flags)
    lse = T.attention_lse_ref(qt, kt, **flags)
    got = T.attention_bwd_ref(qt, kt, vt, out, lse, dot, **flags)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    rout, vjp = jax.vjp(lambda a, b_, c: R.attention_ref(a, b_, c, **flags),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(_np(out), rout, 1e-5, "out")
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        _close(_np(g), w, 1e-5, name)


# ---------------------------------------------------------------------------
# The selective scan
# ---------------------------------------------------------------------------

SCAN_GRID = [(b, s, e, n) for b in (1, 3) for s in (1, 37, 70) for e in (8, 24)
             for n in (1, 4, 16)]
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


def _scan_arrays(b, s, e, n, seed, rank=5):
    """Seeded numpy inputs as a Mamba layer makes them: dt_raw, x, the
    in projection [B, S, 2E] (z its second half) and the x projection
    [B, S, rank + 2N] (b and c past the dt rank), dt_bias, A_log = log(1..N)
    plus noise, D, h0, and the gradients of y and hT."""
    rng = np.random.RandomState(seed)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    return {"dt_raw": f(b, s, e), "x": f(b, s, e), "xz": f(b, s, 2 * e),
            "proj": f(b, s, rank + 2 * n), "dt_bias": 0.5 * f(e),
            "a_log": (np.log(np.arange(1, n + 1, dtype=np.float32))[None]
                      + 0.1 * f(e, n)).astype(np.float32),
            "d": f(e), "h0": f(b, e, n), "dy": f(b, s, e), "dht": f(b, e, n)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,e,n", SCAN_GRID, ids=[f"b{b}-s{s}-e{e}-n{n}" for b, s, e, n in SCAN_GRID])
def test_mamba_scan_bwd_ref_matches_autograd(b, s, e, n, dtype):
    arr = _scan_arrays(b, s, e, n, seed=b * 1000 + s * 10 + e + n)
    md = T_DTYPES[dtype]
    dt_raw, x, xz, proj = (torch.from_numpy(arr[k]).to(md).requires_grad_(True)
                           for k in ("dt_raw", "x", "xz", "proj"))
    dt_bias, a_log, d, h0 = (torch.from_numpy(arr[k]).requires_grad_(True)
                             for k in ("dt_bias", "a_log", "d", "h0"))
    z, bm, cm = xz[..., e:], proj[..., 5: 5 + n], proj[..., 5 + n:]
    args = (dt_raw, dt_bias, x, z, bm, cm, a_log, d, h0)
    y, ht = T.mamba_scan_ref(*args)
    dy, dht = torch.from_numpy(arr["dy"]).to(md), torch.from_numpy(arr["dht"])
    want = torch.autograd.grad((y.float() * dy.float()).sum() + (ht * dht).sum(), args)
    got = T.mamba_scan_bwd_ref(*(t.detach() for t in args), dy, dht)
    names = ("dt_raw", "dt_bias", "x", "z", "b", "c", "A_log", "D", "h0")
    for name, g, w, t in zip(names, got, want, args):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _close(_np(g), _np(w), SCAN_TOL[dtype], name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,e,n", SCAN_GRID, ids=[f"b{b}-s{s}-e{e}-n{n}" for b, s, e, n in SCAN_GRID])
def test_selective_scan_bwd_ref_matches_autograd(b, s, e, n, dtype):
    arr = _scan_arrays(b, s, e, n, seed=7 + b * 1000 + s * 10 + e + n)
    md = T_DTYPES[dtype]
    dt = torch.nn.functional.softplus(torch.from_numpy(arr["dt_raw"])).to(md).requires_grad_(True)
    x = torch.from_numpy(arr["x"]).to(md).requires_grad_(True)
    bm = torch.from_numpy(arr["proj"][..., :n].copy()).to(md).requires_grad_(True)
    cm = torch.from_numpy(arr["proj"][..., n: 2 * n].copy()).to(md).requires_grad_(True)
    a = (-torch.exp(torch.from_numpy(arr["a_log"]))).to(md).requires_grad_(True)
    h0 = torch.from_numpy(arr["h0"]).requires_grad_(True)
    args = (dt, x, bm, cm, a, h0)
    ys, ht = T.selective_scan_ref(*args)
    dys, dht = torch.from_numpy(arr["dy"]), torch.from_numpy(arr["dht"])
    want = torch.autograd.grad((ys * dys).sum() + (ht * dht).sum(), args)
    got = T.selective_scan_bwd_ref(*(t.detach() for t in args), dys, dht)
    for name, g, w in zip(("dt", "x", "b", "c", "a", "h0"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(_np(g), _np(w), SCAN_TOL[dtype], name)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 12, 70])
def test_apply_mamba_function_matches_jax_vjp(with_state, s, monkeypatch):
    """The port's reduced falcon-mamba layer under grad on the CPU, its
    scan through ``_MambaScanFunction`` (whose backward is the plain
    backward, counted once), against ``jax.vjp`` of the reference's
    ``apply_mamba`` on the same weights and inputs."""
    from repro.models import recurrent as RR
    from repro_torch.models import recurrent as TR

    calls = _counting(monkeypatch, ss, "mamba_scan_bwd_ref")
    cfg, rcfg = ARCHS["falcon-mamba-7b"].reduced(), R_ARCHS["falcon-mamba-7b"].reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(5), tp_size=1)
    rp = jax.tree.map(lambda a: np.asarray(a[0]), rparams["stages"][0]["mixer"])
    rng = np.random.RandomState(70 + s)
    # non-zero dt_bias and D, so every term counts
    rp["dt_bias"] = (0.5 * rng.randn(*rp["dt_bias"].shape)).astype(np.float32)
    rp["D"] = rng.randn(*rp["D"].shape).astype(np.float32)
    model = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    mixer = model.stages[0][0].mixer
    for name, val in rp.items():
        getattr(mixer, name).data.copy_(torch.from_numpy(np.array(val)))
    mixer.requires_grad_(True)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    x = rng.randn(2, s, cfg.d_model).astype(np.float32)
    h0 = rng.randn(2, di, n).astype(np.float32)
    conv = rng.randn(2, cfg.d_conv - 1, di).astype(np.float32)
    dout = rng.randn(2, s, cfg.d_model).astype(np.float32)
    dh = rng.randn(2, di, n).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    h0t = torch.from_numpy(h0).requires_grad_(True)
    state = (h0t, torch.from_numpy(conv)) if with_state else None
    out, new = TR.apply_mamba(mixer, xt, cfg, state=state)
    loss = (out * torch.from_numpy(dout)).sum()
    if with_state:
        loss = loss + (new[0] * torch.from_numpy(dh)).sum()
    names = sorted(rp)
    inputs = [xt] + [getattr(mixer, k) for k in names] + ([h0t] if with_state else [])
    got = torch.autograd.grad(loss, inputs)
    assert len(calls) == 1

    def ref(xj, pj, h0j):
        st = (h0j, jnp.asarray(conv)) if with_state else None
        y, new_j = RR.apply_mamba(dict(zip(names, pj)), xj, rcfg, state=st)
        return (y, new_j[0]) if with_state else (y,)
    _, vjp = jax.vjp(ref, jnp.asarray(x), [jnp.asarray(rp[k]) for k in names], jnp.asarray(h0))
    cot = (jnp.asarray(dout), jnp.asarray(dh)) if with_state else (jnp.asarray(dout),)
    wx, wp, wh0 = vjp(cot)
    want = [wx] + list(wp) + ([wh0] if with_state else [])
    for name, g, w in zip(["x"] + names + ["h0"], got, want):
        _close(_np(g), np.asarray(w), 1e-5, name)


# ---------------------------------------------------------------------------
# Reduced models through the Functions
# ---------------------------------------------------------------------------

def _counting(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "recurrentgemma-2b",
                                  "falcon-mamba-7b", "deepseek-v2-236b"])
def test_reduced_model_trains_through_the_functions(name, monkeypatch):
    """loss_and_grads on the reduced config against the reference's
    jax.value_and_grad, with every expert product's, RG-LRU layer's and
    Mamba layer's backward through the Function's plain backward
    (counted)."""
    gmm_calls = _counting(monkeypatch, gm, "grouped_matmul_bwd_ref")
    lru_calls = _counting(monkeypatch, ls, "lru_scan_bwd_ref")
    mamba_calls = _counting(monkeypatch, ss, "mamba_scan_bwd_ref")
    cfg, rcfg = ARCHS[name].reduced(), R_ARCHS[name].reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(3), tp_size=1)
    rng = np.random.RandomState(11)
    inputs = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    rloss, rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, jnp.asarray(inputs), jnp.asarray(labels)))(rparams)
    model = params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    model.requires_grad_(True)
    loss, grads = loss_and_grads(model, cfg, torch.from_numpy(inputs), torch.from_numpy(labels))
    n_moe = cfg.n_layers - cfg.moe.first_dense if cfg.moe is not None else 0
    n_lru = sum(kind == "rglru" for kind in cfg.pattern)
    n_mamba = sum(kind == "mamba" for kind in cfg.pattern)
    assert (len(gmm_calls), len(lru_calls), len(mamba_calls)) == (3 * n_moe, n_lru, n_mamba)
    assert len(gmm_calls) + len(lru_calls) + len(mamba_calls) > 0
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    mine = tree_leaves_with_names(tree_to_numpy(grads))
    theirs = tree_leaves_with_names(jax.tree.map(np.asarray, rgrads))
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (leaf, got), (_, want) in zip(mine, theirs):
        _close(got, want, 1e-4, leaf)
