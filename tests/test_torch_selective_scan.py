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
* ``attention_ref`` with Dv != D (MLA) against the reference's
  ``attention_ref`` (causal, a ``q_offset``, a window, no mask) within
  1e-6, and ``ops.attention`` on the CPU equal to it; ``ops.attention``
  refuses head-width pairs the CUDA kernel has no instantiation for, on
  every device; the widths it admits are the ones the build passes to the
  CUDA source as defines. The reference's Pallas flash kernel is left out: its v
  and output take q's width, so it is wrong for Dv != D (ROADMAP queue 3).

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as R
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T
from repro_torch.kernels import selective_scan as ss

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
