"""The selective scan's plain version against the reference's recurrence,
and the plain attention with values narrower or wider than the keys.

* ``selective_scan_ref`` against the reference's ``lax.scan`` over its
  ``step`` (``repro/models/recurrent.py`` ``apply_mamba``, written out
  here with the same products in the same order, since the reference
  keeps it inside ``apply_mamba``) on numpy-seeded float32 inputs, over
  ragged S, channel counts and state sizes, within 1e-6: the same float32
  products, summed over N in another order. ``apply_mamba`` itself is held
  to the reference in ``tests/test_torch_models.py``.
* On the CPU ``ops.selective_scan`` is the plain version bit for bit and
  launches nothing; the wrapper refuses bad shapes, dtypes and layouts on
  every device.
* ``mamba_scan_ref`` (the plain version of the fused entry ``mamba_scan``:
  softplus of the biased dt projection, ``-exp(A_log)``, the scan, the
  ``D`` skip and the ``silu(z)`` gate) against the reference's same span
  of ``repro/models/recurrent.py`` ``apply_mamba``, written out with
  ``lax.scan`` of its ``step``, in float32 within 1e-5 (torch's softplus,
  exp and log round apart from XLA's by an ulp or so, over S steps) and
  in bfloat16 within one bfloat16 ulp (2^-7 relative: those float32
  differences can tip the final cast). On the CPU ``ops.mamba_scan`` with
  strided ``z``, ``b`` and ``c`` equals, bit for bit, the eager composition
  the models ran before it (written out here), launches nothing, and its
  wrapper refuses bad dtypes, shapes, state sizes, widths, strides and
  devices on every device.
* ``attention_ref`` with Dv != D (MLA) against the reference's
  ``attention_ref`` (causal, a ``q_offset``, a window, no mask) within
  1e-6, and ``ops.attention`` on the CPU equal to it; ``ops.attention``
  refuses head-width pairs the CUDA kernel has no instantiation for, on
  every device; the widths it admits are the ones the build passes to the
  CUDA source as defines. The reference's Pallas flash kernel is left out: its v
  and output take q's width, so it is wrong for Dv != D (ROADMAP queue 3).

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

import importlib
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as R
fa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T
from repro_torch.kernels import selective_scan as ss
import torch.nn.functional as F

SCAN_TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=1e-6, atol=1e-6)

# (B, S, E, N): ragged S, channels and states, falcon-mamba's N of 16
SCANS = [(1, 1, 8, 16), (1, 7, 5, 4), (2, 33, 40, 16), (1, 12, 16, 1), (3, 20, 9, 5),
         (2, 64, 32, 8)]


def _scan_inputs(b, s, e, n, seed=0):
    rng = np.random.RandomState(seed + 100 * s + e + n)
    dt = np.log1p(np.exp(rng.randn(b, s, e))).astype(np.float32)  # softplus
    x = rng.randn(b, s, e).astype(np.float32)
    bm = rng.randn(b, s, n).astype(np.float32)
    cm = rng.randn(b, s, n).astype(np.float32)
    a = -np.exp(np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (e, n)))
                + 0.1 * rng.randn(e, n)).astype(np.float32)
    h0 = rng.randn(b, e, n).astype(np.float32)
    return dt, x, bm, cm, a, h0


def _reference_scan(dt, x, bm, cm, a, h0):
    """The reference's recurrence: ``lax.scan`` of ``apply_mamba``'s
    ``step`` over time-major inputs."""
    a = jnp.asarray(a)

    def step(h, inputs):
        dt_t, b_t, c_t, x_t = inputs  # [B,di], [B,N], [B,N], [B,di]
        da = jnp.exp(dt_t[..., None] * a[None])             # [B, di, N]
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        y = jnp.einsum("ben,bn->be", h, c_t)                # [B, di]
        return h, y

    h_t, ys = jax.lax.scan(
        step, jnp.asarray(h0),
        tuple(jnp.asarray(v).transpose(1, 0, 2) for v in (dt, bm, cm, x)))
    return np.asarray(ys).transpose(1, 0, 2), np.asarray(h_t)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,s,e,n", SCANS)
def test_plain_scan_matches_reference_lax_scan(b, s, e, n):
    args = _scan_inputs(b, s, e, n)
    want_ys, want_h = _reference_scan(*args)
    ys, h_t = T.selective_scan_ref(*_t(*args))
    assert ys.dtype == h_t.dtype == torch.float32
    np.testing.assert_allclose(ys.numpy(), want_ys, **SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), want_h, **SCAN_TOL)


@pytest.mark.parametrize("b,s,e,n", SCANS[:3])
def test_ops_selective_scan_on_cpu_takes_plain_version(b, s, e, n):
    args = _t(*_scan_inputs(b, s, e, n, seed=1))
    before = ss.launches
    got = ops.selective_scan(*args)
    want = T.selective_scan_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert ss.launches == before


def test_zero_step_sizes_keep_state():
    dt, x, bm, cm, a, h0 = _scan_inputs(1, 6, 8, 4)
    ys, h_t = T.selective_scan_ref(*_t(np.zeros_like(dt), x, bm, cm, a, h0))
    np.testing.assert_array_equal(h_t.numpy(), h0)
    np.testing.assert_allclose(ys[:, -1].numpy(), np.einsum("ben,bn->be", h0, cm[:, -1]),
                               rtol=1e-6, atol=1e-6)


def _bad_scan_args():
    dt, x, bm, cm, a, h0 = _t(*_scan_inputs(1, 5, 8, 4))
    return {
        "dt_and_x_differ": ((dt, x[:, :4], bm, cm, a, h0), ValueError, "equal"),
        "empty_sequence": ((dt[:, :0], x[:, :0], bm[:, :0], cm[:, :0], a, h0),
                           ValueError, "empty"),
        "a_rows": ((dt, x, bm, cm, a[:7], h0), ValueError, "a must be"),
        "state_17": ((dt, x, torch.zeros(1, 5, 17), torch.zeros(1, 5, 17), torch.zeros(8, 17),
                      torch.zeros(1, 8, 17)), ValueError, "state size"),
        "b_shape": ((dt, x, bm[:, :, :3], cm, a, h0), ValueError, "b must be"),
        "h0_shape": ((dt, x, bm, cm, a, h0[:, :7]), ValueError, "h0 must be"),
        "float64": ((dt.double(), x, bm, cm, a, h0), TypeError, "float32"),
        "bfloat16_h0": ((dt, x, bm, cm, a, h0.bfloat16()), TypeError, "float32"),
        "non_contiguous_c": ((dt, x, bm, cm.transpose(1, 2).contiguous().transpose(1, 2), a,
                              h0), ValueError, "contiguous"),
    }


@pytest.mark.parametrize("case", sorted(_bad_scan_args()))
def test_selective_scan_refuses_bad_inputs(case):
    args, exc, match = _bad_scan_args()[case]
    with pytest.raises(exc, match=match):
        ss.selective_scan(*args)


# (B, S, E, N, projection rank): ragged S, E and N, falcon-mamba's N of
# 16, S on both sides of the kernel's 8-step segments and 256-step chunks
FUSED = [(1, 1, 8, 16, 4), (2, 7, 5, 4, 3), (1, 33, 40, 16, 8), (3, 12, 16, 1, 2),
         (1, 129, 9, 5, 4)]
FUSED_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}


def _fused_inputs(b, s, e, n, rank, seed=0):
    """numpy float32 inputs of the fused span: dt_raw, dt_bias, x, the in
    projection xz (z is its second half), the x projection proj (b and c
    are slices of it past ``rank``), A_log, D, h0."""
    rng = np.random.RandomState(seed + 1000 * s + 10 * e + n)
    f = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa: E731
    a_log = (np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (e, n)))
             + 0.1 * rng.randn(e, n)).astype(np.float32)
    return (f(b, s, e), 0.5 * f(e), f(b, s, e), f(b, s, 2 * e), f(b, s, rank + 2 * n), a_log,
            f(e), f(b, e, n))


def _split(xz, proj, e, n, rank):
    return xz[..., e:], proj[..., rank: rank + n], proj[..., rank + n:]


def _reference_span(dt_raw, dt_bias, x, xz, proj, a_log, d, h0, dtype, rank):
    """The reference's ``apply_mamba`` from the dt projection's output to
    the gated output (``repro/models/recurrent.py``), with the model-dtype
    tensors in ``dtype``."""
    e, n = a_log.shape
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731
    z, bm, cm = _split(cast(xz), cast(proj), e, n, rank)
    dt = jax.nn.softplus(cast(dt_raw) + jnp.asarray(dt_bias)[None, None]).astype(jnp.float32)
    a = -jnp.exp(jnp.asarray(a_log))
    xf = cast(x).astype(jnp.float32)
    ys, h_t = _reference_scan(dt, xf, bm.astype(jnp.float32), cm.astype(jnp.float32), a, h0)
    y = ys + jnp.asarray(d)[None, None] * xf
    y = (y * jax.nn.silu(z.astype(jnp.float32))).astype(dtype)
    return np.asarray(y.astype(jnp.float32)), h_t


def _torch_span(dt_raw, dt_bias, x, xz, proj, a_log, d, h0, dtype, rank):
    """The fused entry's arguments as ``apply_mamba`` passes them: z, b and
    c strided slices of the projections."""
    e, n = a_log.shape
    md = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    z, bm, cm = _split(md(xz), md(proj), e, n, rank)
    return (md(dt_raw), torch.from_numpy(dt_bias), md(x), z, bm, cm, torch.from_numpy(a_log),
            torch.from_numpy(d), torch.from_numpy(h0))


def _eager_span(dt_raw, dt_bias, x, z, bmat, cmat, a_log, d, h0):
    """``apply_mamba``'s span as the models ran it eagerly before the fused
    entry: softplus, the float32 casts and copies, the plain scan, the skip,
    the gate, the cast."""
    dt = F.softplus(dt_raw + dt_bias[None, None]).float()
    bmat = bmat.float().contiguous()
    cmat = cmat.float().contiguous()
    a = -torch.exp(a_log)
    xf = x.float()
    ys, h_t = T.selective_scan_ref(dt.contiguous(), xf.contiguous(), bmat, cmat, a.contiguous(),
                                   h0.contiguous())
    y = ys + d[None, None] * xf
    return (y * F.silu(z.float())).to(x.dtype), h_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,e,n,rank", FUSED)
def test_plain_fused_span_matches_reference(b, s, e, n, rank, dtype):
    args = _fused_inputs(b, s, e, n, rank)
    want_y, want_h = _reference_span(*args, dtype=getattr(jnp, dtype), rank=rank)
    y, h_t = T.mamba_scan_ref(*_torch_span(*args, dtype=getattr(torch, dtype), rank=rank))
    assert y.dtype == getattr(torch, dtype) and h_t.dtype == torch.float32
    assert tuple(y.shape) == (b, s, e) and tuple(h_t.shape) == (b, e, n)
    np.testing.assert_allclose(y.float().numpy(), want_y, **FUSED_TOL[dtype])
    np.testing.assert_allclose(h_t.numpy(), want_h, **FUSED_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,e,n,rank", FUSED[:3])
def test_ops_mamba_scan_on_cpu_is_the_eager_composition(b, s, e, n, rank, dtype):
    args = _torch_span(*_fused_inputs(b, s, e, n, rank, seed=3), dtype=getattr(torch, dtype),
                       rank=rank)
    assert args[3].storage_offset() > 0 and args[4].storage_offset() > 0  # views into projections
    before = ss.launches
    got = ops.mamba_scan(*args)
    want = _eager_span(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert ss.launches == before


def _bad_fused_args():
    args = _torch_span(*_fused_inputs(1, 5, 8, 4, 3), dtype=torch.bfloat16, rank=3)
    dt_raw, dt_bias, x, z, bm, cm, a_log, d, h0 = args

    def with_(**kw):
        names = ("dt_raw", "dt_bias", "x", "z", "b", "c", "a_log", "d", "h0")
        return tuple(kw.get(k, v) for k, v in zip(names, args))

    wide = torch.zeros(1, 5, 34, dtype=torch.bfloat16)
    return {
        "float64_dt_raw": (with_(dt_raw=dt_raw.double(), x=x.double(), z=z.double(),
                                 b=bm.double(), c=cm.double()), TypeError, "dt_raw must be"),
        "x_other_dtype": (with_(x=x.float()), TypeError, "x must be"),
        "c_other_dtype": (with_(c=cm.float()), TypeError, "c must be"),
        "bfloat16_a_log": (with_(a_log=a_log.bfloat16()), TypeError, "A_log must be float32"),
        "float16_h0": (with_(h0=h0.half()), TypeError, "h0 must be float32"),
        "x_shape": (with_(x=x[:, :4]), ValueError, "x must be"),
        "z_shape": (with_(z=z[..., :7]), ValueError, "z must be"),
        "b_shape": (with_(b=bm[..., :3]), ValueError, "b must be"),
        "dt_bias_width": (with_(dt_bias=torch.zeros(9)), ValueError, "dt_bias must be"),
        "d_width": (with_(d=torch.zeros(7)), ValueError, "D must be"),
        "a_log_rows": (with_(a_log=a_log[:7]), ValueError, "A_log must be"),
        "h0_shape": (with_(h0=h0[:, :7]), ValueError, "h0 must be"),
        "state_0": (with_(a_log=torch.zeros(8, 0), b=wide[..., :0], c=wide[..., :0],
                          h0=torch.zeros(1, 8, 0)), ValueError, "state size"),
        "state_17": (with_(a_log=torch.zeros(8, 17), b=wide[..., :17], c=wide[..., 17:],
                           h0=torch.zeros(1, 8, 17)), ValueError, "state size"),
        "empty": (with_(dt_raw=dt_raw[:, :0], x=x[:, :0], z=z[:, :0], b=bm[:, :0], c=cm[:, :0]),
                  ValueError, "empty"),
        "dt_raw_2d": (with_(dt_raw=dt_raw[0]), ValueError, "dt_raw must be"),
        "z_strided_last_dim": (with_(z=torch.zeros(1, 5, 16, dtype=torch.bfloat16)[..., ::2]),
                               ValueError, "unit-stride"),
        "c_transposed": (with_(c=cm.transpose(1, 2).contiguous().transpose(1, 2)),
                         ValueError, "unit-stride"),
        "non_contiguous_a_log": (with_(a_log=torch.zeros(4, 8).t()), ValueError, "contiguous"),
        "b_on_meta": (with_(b=bm.to("meta")), ValueError, "is on meta"),
    }


@pytest.mark.parametrize("case", sorted(_bad_fused_args()))
def test_mamba_scan_refuses_bad_inputs(case):
    args, exc, match = _bad_fused_args()[case]
    with pytest.raises(exc, match=match):
        ss.mamba_scan(*args)


def test_mamba_scan_refuses_a_device_with_no_kernel():
    args = tuple(t.to("meta") for t in _torch_span(*_fused_inputs(1, 5, 8, 4, 3),
                                                   dtype=torch.float32, rank=3))
    with pytest.raises(ValueError, match="unsupported device"):
        ss.mamba_scan(*args)


# (b, h, hkv, sq, sk, d, dv), flags: MLA's 192 / 128 and the reduced
# deepseek's 16 / 8, values wider than keys, GQA, decode at an offset
ATTN = {
    "mla_causal": ((1, 4, 4, 24, 24, 192, 128), {}),
    "mla_reduced": ((1, 4, 4, 20, 20, 16, 8), {}),
    "mla_decode_offset": ((1, 4, 4, 1, 30, 192, 128), {"q_offset": 29}),
    "q_offset_block": ((2, 4, 2, 5, 17, 24, 40), {"q_offset": 12}),
    "window": ((1, 2, 1, 30, 30, 64, 32), {"window": 7}),
    "noncausal": ((1, 2, 2, 9, 13, 8, 16), {"causal": False}),
}


def _qkv(name):
    (b, h, hkv, sq, sk, d, dv), _ = ATTN[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return (rng.randn(b, h, sq, d).astype(np.float32), rng.randn(b, hkv, sk, d).astype(np.float32),
            rng.randn(b, hkv, sk, dv).astype(np.float32))


@pytest.mark.parametrize("name", sorted(ATTN))
def test_plain_attention_with_dv_matches_reference(name):
    q, k, v = _qkv(name)
    flags = ATTN[name][1]
    want = np.asarray(R.attention_ref(*map(jnp.asarray, (q, k, v)), **flags))
    got = T.attention_ref(*_t(q, k, v), **flags)
    assert tuple(got.shape) == want.shape == q.shape[:3] + (v.shape[3],)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    before = fa.launches
    assert torch.equal(ops.attention(*_t(q, k, v), **flags), got)
    assert fa.launches == before


@pytest.mark.parametrize("d,dv", [(192, 129), (200, 128), (264, 264), (256, 128)])
def test_attention_refuses_widths_with_no_kernel(d, dv):
    q = torch.zeros(1, 1, 4, d)
    with pytest.raises(ValueError, match="no kernel for head dims"):
        ops.attention(q, q, torch.zeros(1, 1, 4, dv))


@pytest.mark.parametrize("d,dv", [(192, 128), (1, 128), (192, 1), (64, 64), (256, 256)])
def test_kernel_takes_the_model_widths(d, dv):
    assert fa.kernel_takes(d, dv)


@pytest.mark.parametrize("macro,const,value", [
    ("ACS_FLASH_MAX_D", "kMaxD", fa.MAX_HEAD_DIM),
    ("ACS_FLASH_SPLIT_D", "kMlaD", fa.MAX_QK_DIM_SPLIT),
    ("ACS_FLASH_SPLIT_DV", "kMlaDv", fa.MAX_V_DIM_SPLIT),
])
def test_kernel_widths_come_from_the_wrapper(macro, const, value):
    # the widths kernel_takes admits are the ones the build instantiates
    assert f"-D{macro}={value}" in fa._LIB.flags
    src = fa.SOURCE.read_text()
    assert f"constexpr int {const} = {macro};" in src
    assert "#error" in src and f"defined({macro})" in src
