"""The port's models against the reference's, on the reference's weights
carried across with ``models.convert``: the layer primitives, the GQA
mixer (training, prefill and ring-cache decode), the MLA mixer (training,
prefill, decode against a filled cache), the RG-LRU and Mamba mixers
(with and without state, S of 1 and 12), and whole models (prefill logits
and caches, then three decode steps teacher-forced with the reference's
greedy tokens, or with the next seeded embeddings for a frontend arch;
and ``forward``).

Sizes are the reduced configs in float32: recurrentgemma with 5 layers
(its 2-layer prefix and one stage), h2o-danube, and gemma2, minicpm and
mistral-large (softcaps, global caches, an untied head), danube with
its 4 heads padded to 8 (``pad_heads_to``), granite-moe (MoE FFNs, 4
experts padded to 16 by both packages' default ``tp_size`` of 16),
deepseek-v2 (MLA with q and k 16 wide and v 8, a dense first layer, then
MoE with a shared expert), falcon-mamba (Mamba layers, no FFN), and the
frontend archs musicgen and paligemma (seeded ``[1, S, F]`` frame or
patch embeddings through ``frontend_proj``; paligemma's bidirectional
prefix). On the CPU ``apply_mamba`` gives the bits of the eager
composition the fused ``mamba_scan`` replaced, in float32 and bfloat16.
The reference's MLA prefill takes its jnp attention on the CPU:
its Pallas kernel is wrong where v is narrower than q (ROADMAP queue 3).
Layers are held to 1e-5; whole models to 1e-4, because XLA and torch sum
the products in different orders across the layers. Argmax tokens are
not compared against JAX: near-ties may break either way.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as RM
from repro.configs import ARCHS as R_ARCHS
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import recurrent as RR
from repro.models.transformer import FRONTEND_DIMS as R_FRONTEND_DIMS
from repro_torch import models as TM
from repro_torch.configs import ARCHS
from repro_torch.kernels import ref as TK
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

CONFIGS = {
    "recurrentgemma": ("recurrentgemma-2b", {"n_layers": 5}),
    "danube": ("h2o-danube-3-4b", {}),
    "gemma2": ("gemma2-27b", {}),
    "minicpm": ("minicpm-2b", {}),
    "mistral": ("mistral-large-123b", {}),
    "danube_padded_heads": ("h2o-danube-3-4b", {"pad_heads_to": 8}),
    "granite_moe": ("granite-moe-3b-a800m", {}),
    "deepseek": ("deepseek-v2-236b", {}),
    "falcon_mamba": ("falcon-mamba-7b", {}),
    "musicgen": ("musicgen-large", {}),
    "paligemma": ("paligemma-3b", {}),
}
TP_SIZE = 16  # MoE expert padding, both packages' default
PROMPT, MAX_LEN = 20, 32  # a prompt longer than the reduced window (16)


@functools.lru_cache(maxsize=None)
def _cfg(key):
    name, kw = CONFIGS[key]
    cfg = dataclasses.replace(ARCHS[name].reduced(), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(R_ARCHS[name].reduced(), **kw))
    return cfg


@functools.lru_cache(maxsize=None)
def _models(key):
    cfg = _cfg(key)
    ref = RM.init_params(cfg, jax.random.PRNGKey(0), tp_size=TP_SIZE)
    port = TM.params_from_numpy(jax.tree.map(np.asarray, ref), cfg, device="cpu")
    return ref, port


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _tokens(cfg, n, seed=0):
    """``n`` seeded tokens [1, n], or for a frontend arch ``n`` seeded
    embeddings [1, n, F]."""
    rng = np.random.RandomState(seed)
    if cfg.frontend:
        assert TM.FRONTEND_DIMS == R_FRONTEND_DIMS
        return rng.randn(1, n, TM.FRONTEND_DIMS[cfg.frontend]).astype(np.float32)
    return rng.randint(0, cfg.vocab, (1, n)).astype(np.int32)


def _ref_leaf(tree, name):
    """The reference leaf named like the port's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "stages":
        si, ui, rest = int(parts[1]), int(parts[2]), parts[3:]
        node = tree["stages"][ui]
        for p in rest:
            node = node[p]
        return np.asarray(node)[si]
    node = tree
    for p in parts:
        node = node[int(p)] if isinstance(node, list) else node[p]
    return np.asarray(node)


def _flat_cache(cache):
    out = []
    for entry in cache["prefix"]:
        out.extend(entry)
    for stage in cache["stages"]:
        for entry in stage:
            out.extend(entry)
    return out


def _flat_ref_cache(cache, cfg):
    return _flat_cache(TM.cache_from_numpy(jax.tree.map(np.asarray, cache), cfg, device="cpu"))


# ---------------------------------------------------------------------------
# weights carried across, and the port's own init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_params_from_numpy_round_trips_exactly(key):
    ref, port = _models(key)
    named = dict(port.named_parameters())
    n_ref = sum(np.asarray(leaf).shape[0] if path[0].key == "stages" else 1
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(named) == n_ref
    for name, t in named.items():
        want = _ref_leaf(ref, name)
        assert tuple(t.shape) == want.shape, name
        np.testing.assert_array_equal(t.numpy(), want.astype(np.float32), err_msg=name)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_init_params_matches_reference_layout(key):
    cfg = _cfg(key)
    _, converted = _models(key)
    mine = TM.init_params(cfg, 0, device="cpu", tp_size=TP_SIZE)
    want = {n: (tuple(t.shape), t.dtype) for n, t in converted.named_parameters()}
    assert {n: (tuple(t.shape), t.dtype) for n, t in mine.named_parameters()} == want
    again = TM.init_params(cfg, 0, device="cpu")
    other = TM.init_params(cfg, 1, device="cpu")
    assert torch.equal(mine.embed, again.embed)
    assert not torch.equal(mine.embed, other.embed)


@pytest.mark.parametrize("kind", sorted(TM.LAYER_KINDS))
def test_layer_kind_table_builds_what_the_reference_builds(kind):
    # one entry per kind decides the mixer, its params, its cache and its
    # FFN; a reduced config that uses the kind shows each
    key = next(k for k in sorted(CONFIGS) if kind in _cfg(k).pattern)
    cfg = _cfg(key)
    spec = TM.LAYER_KINDS[kind]
    ref = RM.init_params(cfg, jax.random.PRNGKey(0), tp_size=TP_SIZE)
    prefix, _ = TM.split_pattern(cfg)
    for where, kinds in (("prefix", prefix), ("stages", cfg.pattern_unit)):
        if kind in kinds:
            layer = ref[where][kinds.index(kind)]
            assert ("ffn" in layer) == spec.ffn
    model = TM.init_params(cfg, 0, device="cpu", tp_size=TP_SIZE)
    blocks = [b for b in (*model.prefix, *(b for st in model.stages for b in st))
              if b.kind == kind]
    assert blocks and all((b.ffn is not None) == spec.ffn for b in blocks)
    assert all(b.recurrent == spec.recurrent for b in blocks)
    cache = TM.init_cache(cfg, 2, MAX_LEN, device="cpu")
    rcache = RM.init_cache(cfg, 2, MAX_LEN)
    kinds = (*prefix, *cfg.pattern_unit)
    entries = (*cache["prefix"], *cache["stages"][0])
    rentries = (*rcache["prefix"], *(jax.tree.map(lambda a: a[0], rcache["stages"])))
    for k, got, want in zip(kinds, entries, rentries):
        if k == kind:
            assert [(tuple(t.shape), str(t.dtype)[len("torch."):]) for t in got] == [
                (tuple(a.shape), str(a.dtype)) for a in want]


def test_unknown_layer_kind_raises():
    with pytest.raises(ValueError, match="unknown layer kind"):
        TM.layer_kind("conv")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.RandomState(0)
    x, w = rng.randn(2, 5, 16).astype(np.float32), rng.randn(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(RL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **LAYER_TOL)


def test_rope_and_apply_rope():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 7, 16).astype(np.float32)
    pos = np.arange(5, 12)
    rc, rs = RL.rope(jnp.asarray(pos), 16)
    tc, ts = TL.rope(torch.from_numpy(pos), 16)
    np.testing.assert_allclose(_np(tc), _np(rc), **LAYER_TOL)
    np.testing.assert_allclose(_np(ts), _np(rs), **LAYER_TOL)
    np.testing.assert_allclose(_np(TL.apply_rope(torch.from_numpy(x), tc, ts)),
                               _np(RL.apply_rope(jnp.asarray(x), rc, rs)), **LAYER_TOL)


def _attn_layer(key):
    """(cfg, reference mixer params, port mixer) of the first local layer."""
    ref, port = _models(key)
    cfg = _cfg(key)
    ui = list(cfg.pattern_unit).index("attn_local")
    r = jax.tree.map(lambda a: a[0], ref["stages"][ui]["mixer"])
    return cfg, r, port.stages[0][ui].mixer


@pytest.mark.parametrize("key", ["danube", "recurrentgemma"])
@pytest.mark.parametrize("mode", ["train", "prefill", "ring_decode"])
def test_apply_attn(key, mode):
    cfg, rp, tp = _attn_layer(key)
    rng = np.random.RandomState(2)
    s = 1 if mode == "ring_decode" else PROMPT
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    cache = pos = None
    if mode != "train":
        cache_np = tuple(np.zeros((1, cfg.eff_kv_heads, min(cfg.window, MAX_LEN), cfg.head_dim),
                                  np.float32) for _ in range(2))
        if mode == "ring_decode":  # a cache left by a prompt longer than the window
            cache_np = tuple(rng.randn(*c.shape).astype(np.float32) for c in cache_np)
            pos = PROMPT
        cache = cache_np
    positions = np.arange(s) + (pos or 0)
    ry, rc = RA.apply_attn(
        rp, jnp.asarray(x), cfg, local=True, positions=jnp.asarray(positions),
        cache=None if cache is None else tuple(map(jnp.asarray, cache)),
        pos=None if pos is None else jnp.asarray(pos, jnp.int32), prefill=(mode == "prefill"))
    ty, tc = TA.apply_attn(
        tp, torch.from_numpy(x), cfg, local=True, positions=torch.from_numpy(positions),
        cache=None if cache is None else tuple(map(torch.from_numpy, cache)),
        pos=None if pos is None else torch.tensor(pos, dtype=torch.int32),
        prefill=(mode == "prefill"))
    np.testing.assert_allclose(_np(ty), _np(ry), **LAYER_TOL)
    if cache is not None:
        for t, r in zip(tc, rc):
            np.testing.assert_allclose(_np(t), _np(r), **LAYER_TOL)


def _rglru_layer():
    ref, port = _models("recurrentgemma")
    return _cfg("recurrentgemma"), ref["prefix"][0]["mixer"], port.prefix[0].mixer


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    rng = np.random.RandomState(3)
    x, w = rng.randn(2, 9, 8).astype(np.float32), rng.randn(4, 8).astype(np.float32)
    st = rng.randn(2, 3, 8).astype(np.float32) if with_state else None
    ry, rs = RR._causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if st is None else jnp.asarray(st))
    ty, ts = TR._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(_np(ty), _np(ry), **LAYER_TOL)
    np.testing.assert_allclose(_np(ts), _np(rs), **LAYER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 12])
def test_apply_rglru(with_state, s):
    cfg, rp, tp = _rglru_layer()
    w = cfg.rglru_width or cfg.d_model
    rng = np.random.RandomState(4 + s)
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    state = ((rng.randn(1, w).astype(np.float32), rng.randn(1, cfg.d_conv - 1, w).astype(np.float32))
             if with_state else None)
    ry, rst = RR.apply_rglru(rp, jnp.asarray(x), cfg,
                             state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, tst = TR.apply_rglru(tp, torch.from_numpy(x), cfg,
                             state=None if state is None else tuple(map(torch.from_numpy, state)))
    np.testing.assert_allclose(_np(ty), _np(ry), **LAYER_TOL)
    assert (tst is None) == (rst is None)
    if with_state:
        assert tst[0].dtype == torch.float32
        for t, r in zip(tst, rst):
            np.testing.assert_allclose(_np(t), _np(r), **LAYER_TOL)


def _mla_layer():
    """(cfg, reference mixer params, port mixer) of deepseek's dense first
    (MLA) layer."""
    ref, port = _models("deepseek")
    return _cfg("deepseek"), ref["prefix"][0]["mixer"], port.prefix[0].mixer


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_apply_mla(mode):
    cfg, rp, tp = _mla_layer()
    m = cfg.mla
    rng = np.random.RandomState(7)
    s = 1 if mode == "decode" else PROMPT
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    cache = pos = None
    if mode != "train":
        shapes = ((1, MAX_LEN, m.kv_lora), (1, MAX_LEN, m.rope_dim))
        if mode == "decode":  # a cache filled by an earlier prompt
            cache = tuple(rng.randn(*sh).astype(np.float32) for sh in shapes)
            pos = PROMPT
        else:
            cache = tuple(np.zeros(sh, np.float32) for sh in shapes)
            pos = 0
    positions = np.arange(s) + (pos or 0)
    ry, rc = RA.apply_mla(
        rp, jnp.asarray(x), cfg, positions=jnp.asarray(positions),
        cache=None if cache is None else tuple(map(jnp.asarray, cache)),
        pos=None if pos is None else jnp.asarray(pos, jnp.int32), prefill=(mode == "prefill"))
    ty, tc = TA.apply_mla(
        tp, torch.from_numpy(x), cfg, positions=torch.from_numpy(positions),
        cache=None if cache is None else tuple(map(torch.from_numpy, cache)),
        pos=None if pos is None else torch.tensor(pos, dtype=torch.int32),
        prefill=(mode == "prefill"))
    np.testing.assert_allclose(_np(ty), _np(ry), **LAYER_TOL)
    assert (tc is None) == (rc is None)
    if cache is not None:
        for t, r in zip(tc, rc):
            assert tuple(t.shape) == r.shape
            np.testing.assert_allclose(_np(t), _np(r), **LAYER_TOL)


def _mamba_layer():
    ref, port = _models("falcon_mamba")
    r = jax.tree.map(lambda a: a[0], ref["stages"][0]["mixer"])
    return _cfg("falcon_mamba"), r, port.stages[0][0].mixer


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 12])
def test_apply_mamba(with_state, s):
    cfg, rp, tp = _mamba_layer()
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    rng = np.random.RandomState(8 + s)
    x = rng.randn(1, s, cfg.d_model).astype(np.float32)
    state = ((rng.randn(1, di, n).astype(np.float32),
              rng.randn(1, cfg.d_conv - 1, di).astype(np.float32)) if with_state else None)
    ry, rst = RR.apply_mamba(rp, jnp.asarray(x), cfg,
                             state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, tst = TR.apply_mamba(tp, torch.from_numpy(x), cfg,
                             state=None if state is None else tuple(map(torch.from_numpy, state)))
    np.testing.assert_allclose(_np(ty), _np(ry), **LAYER_TOL)
    assert (tst is None) == (rst is None)
    if with_state:
        assert tst[0].dtype == torch.float32
        for t, r in zip(tst, rst):
            assert tuple(t.shape) == r.shape
            np.testing.assert_allclose(_np(t), _np(r), **LAYER_TOL)


def _eager_mamba(p, x, cfg, state):
    """``apply_mamba`` as the port ran it before the fused ``mamba_scan``:
    every op of the span around the scan its own eager kernel."""
    b, di, n = x.shape[0], cfg.expand * cfg.d_model, cfg.ssm_state
    dt_rank = p.dt_proj.shape[0]
    xz = torch.einsum("bsd,de->bse", x, p.w_in)
    xi, z = xz[..., :di], xz[..., di:]
    xi, new_conv = TR._causal_conv1d(xi, p.conv_w, state[1] if state is not None else None)
    xi = torch.nn.functional.silu(xi)
    proj = torch.einsum("bse,ef->bsf", xi, p.x_proj)
    dt = torch.nn.functional.softplus(torch.einsum("bsr,re->bse", proj[..., :dt_rank], p.dt_proj)
                                      + p.dt_bias[None, None]).float()
    bmat = proj[..., dt_rank: dt_rank + n].float().contiguous()
    cmat = proj[..., dt_rank + n:].float().contiguous()
    a = -torch.exp(p.A_log)
    h0 = state[0].float() if state is not None else torch.zeros((b, di, n))
    xf = xi.float()
    ys, h_t = TK.selective_scan_ref(dt.contiguous(), xf.contiguous(), bmat, cmat, a.contiguous(),
                                    h0.contiguous())
    y = ys + p.D[None, None] * xf
    y = (y * torch.nn.functional.silu(z.float())).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p.w_out)
    return out, ((h_t, new_conv) if state is not None else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 12])
def test_apply_mamba_on_cpu_is_the_eager_composition(dtype, with_state, s):
    """On the CPU the fused entry is its plain version: ``apply_mamba``
    gives the bits of the eager composition it replaced (non-zero
    ``dt_bias`` and ``D``, so every term counts)."""
    cfg = dataclasses.replace(ARCHS["falcon-mamba-7b"].reduced(), dtype=dtype)
    mixer = TM.init_params(cfg, 0, device="cpu").stages[0][0].mixer
    rng = np.random.RandomState(30 + s)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    with torch.no_grad():
        mixer.dt_bias.copy_(torch.from_numpy(0.5 * rng.randn(di).astype(np.float32)))
        mixer.D.copy_(torch.from_numpy(rng.randn(di).astype(np.float32)))
    md = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(2, s, cfg.d_model).astype(np.float32)).to(md)
    state = ((torch.from_numpy(rng.randn(2, di, n).astype(np.float32)),
              torch.from_numpy(rng.randn(2, cfg.d_conv - 1, di).astype(np.float32)).to(md))
             if with_state else None)
    got, got_state = TR.apply_mamba(mixer, x, cfg, state=state)
    want, want_state = _eager_mamba(mixer, x, cfg, state)
    assert got.dtype == md and torch.equal(got, want)
    if with_state:
        assert all(torch.equal(g, w) for g, w in zip(got_state, want_state))
    else:
        assert got_state is None and want_state is None


def test_mamba_params_stay_float32_in_a_bf16_model():
    cfg = dataclasses.replace(ARCHS["falcon-mamba-7b"].reduced(), dtype="bfloat16")
    model = TM.init_params(cfg, 0, device="cpu")
    mixer = model.stages[0][0].mixer
    assert {mixer.A_log.dtype, mixer.D.dtype, mixer.dt_bias.dtype} == {torch.float32}
    assert mixer.w_in.dtype == torch.bfloat16
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    h, conv = cache["stages"][0][0]
    assert h.dtype == torch.float32 and conv.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_prefill_then_teacher_forced_decode(key):
    cfg = _cfg(key)
    ref, port = _models(key)
    seq = _tokens(cfg, PROMPT + 3)  # a frontend arch decodes the next embeddings
    toks = seq[:, :PROMPT]
    rl, rc = RM.prefill(ref, cfg, jnp.asarray(toks), RM.init_cache(cfg, 1, MAX_LEN))
    tl, tc = TM.prefill(port, cfg, torch.from_numpy(toks), TM.init_cache(cfg, 1, MAX_LEN, device="cpu"))
    np.testing.assert_allclose(_np(tl), _np(rl), **MODEL_TOL)
    ref_entries, port_entries = _flat_ref_cache(rc, cfg), _flat_cache(tc)
    assert len(ref_entries) == len(port_entries)
    for t, r in zip(port_entries, ref_entries):
        assert t.shape == r.shape and t.dtype == r.dtype
        np.testing.assert_allclose(_np(t), _np(r), **MODEL_TOL)
    tok = int(np.argmax(np.asarray(rl)[0, -1, : cfg.vocab]))
    for step in range(3):
        pos = PROMPT + step
        nxt = (seq[:, pos: pos + 1] if cfg.frontend
               else np.asarray([[tok]], np.int32))
        rl, rc = RM.decode_step(ref, cfg, jnp.asarray(nxt), rc, jnp.asarray(pos, jnp.int32))
        tl, tc = TM.decode_step(port, cfg, torch.from_numpy(nxt), tc,
                                torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), _np(rl), **MODEL_TOL)
        tok = int(np.argmax(np.asarray(rl)[0, -1, : cfg.vocab]))  # teacher-forced


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_forward_logits(key):
    cfg = _cfg(key)
    ref, port = _models(key)
    toks = _tokens(cfg, 12, seed=5)
    np.testing.assert_allclose(_np(TM.forward(port, cfg, torch.from_numpy(toks))),
                               _np(RM.forward(ref, cfg, jnp.asarray(toks))), **MODEL_TOL)
