"""The port's attention plain version against the reference's: its oracle
``attention_ref`` and its Pallas ``flash_attention`` in interpret mode (as
``tests/test_kernels.py`` runs it on the CPU), over the same shape and
flag sweep, on the same numpy inputs.

A query row that sees no key gives 0 in both oracles. The Pallas kernel
fills masked logits with -1e30 and gives such a row the mean of ``v``
(ROADMAP queue 3), so its comparison leaves those rows out. On the CPU
``ops.attention`` takes the plain version and launches no kernel.
"""

import importlib
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention as pallas_flash
from repro.kernels import ref as R
fa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T

# (b, h, hkv, sq, sk, d), attention flags, Pallas blocks
CASES = {
    "mha": ((1, 2, 2, 32, 32, 16), {}, (16, 16)),
    "gqa_ragged_seq": ((2, 4, 2, 48, 48, 32), {}, (16, 16)),
    "mqa_cross": ((1, 8, 1, 16, 64, 8), {"q_offset": 48}, (16, 16)),
    "window_8": ((1, 2, 2, 40, 40, 16), {"window": 8}, (8, 8)),
    "window_17": ((1, 2, 2, 40, 40, 16), {"window": 17}, (8, 8)),
    "softcap": ((1, 2, 2, 32, 32, 16), {"softcap": 10.0}, (16, 16)),
    "prefix_window": ((1, 4, 2, 40, 40, 16), {"window": 8, "prefix_len": 5}, (8, 8)),
    "decode_sq1": ((2, 4, 2, 1, 128, 16), {"q_offset": 127}, (1, 32)),
    "noncausal": ((1, 2, 2, 24, 24, 16), {"causal": False}, (8, 8)),
    "ragged_sk_odd_d": ((1, 4, 1, 20, 37, 24), {"q_offset": 17}, (8, 8)),
    "fully_masked_rows": ((1, 2, 2, 8, 8, 16), {"q_offset": -4}, (8, 8)),
}
SWEEP = [(name, np.float32) for name in CASES] + [
    (name, np.float16) for name in ("mha", "gqa_ragged_seq", "mqa_cross")]
TOL = {np.float32: dict(rtol=2e-5, atol=2e-5), np.float16: dict(rtol=2e-2, atol=2e-2)}


def _inputs(name, dtype):
    (b, h, hkv, sq, sk, d), _, _ = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return (rng.randn(b, h, sq, d).astype(dtype), rng.randn(b, hkv, sk, d).astype(dtype),
            rng.randn(b, hkv, sk, d).astype(dtype))


def _port(fn, arrays, flags):
    return fn(*(torch.from_numpy(a) for a in arrays), **flags).float().numpy()


def _visible_rows(name):
    """Rows that see at least one key (from the plain mask)."""
    (_, _, _, sq, sk, _), flags, _ = CASES[name]
    rows = flags.get("q_offset", 0) + np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    mask = cols <= rows if flags.get("causal", True) else np.ones((sq, sk), bool)
    if flags.get("window") is not None:
        mask &= cols > rows - flags["window"]
    if flags.get("prefix_len"):
        mask |= cols < flags["prefix_len"]
    return mask.any(axis=1)


@pytest.mark.parametrize("name,dtype", SWEEP, ids=[f"{n}-{np.dtype(d).name}" for n, d in SWEEP])
def test_plain_matches_reference_oracle(name, dtype):
    arrays = _inputs(name, dtype)
    flags = CASES[name][1]
    want = np.asarray(R.attention_ref(*(jnp.asarray(a) for a in arrays), **flags), np.float32)
    got = _port(T.attention_ref, arrays, flags)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("name,dtype", SWEEP, ids=[f"{n}-{np.dtype(d).name}" for n, d in SWEEP])
def test_plain_matches_pallas_interpret(name, dtype):
    arrays = _inputs(name, dtype)
    flags = CASES[name][1]
    block_q, block_k = CASES[name][2]
    want = np.asarray(pallas_flash(*(jnp.asarray(a) for a in arrays), block_q=block_q,
                                   block_k=block_k, **flags), np.float32)
    got = _port(T.attention_ref, arrays, flags)
    rows = _visible_rows(name)
    np.testing.assert_allclose(got[:, :, rows], want[:, :, rows], **TOL[dtype])


def test_fully_masked_rows_are_zero():
    arrays = _inputs("fully_masked_rows", np.float32)
    flags = CASES["fully_masked_rows"][1]
    rows = _visible_rows("fully_masked_rows")
    assert rows.sum() == 4 and not rows[:4].any()
    got = _port(T.attention_ref, arrays, flags)
    want = np.asarray(R.attention_ref(*(jnp.asarray(a) for a in arrays), **flags))
    assert np.all(got[:, :, ~rows] == 0.0)
    np.testing.assert_array_equal(got[:, :, ~rows], want[:, :, ~rows])


@pytest.mark.parametrize("name", sorted(CASES))
def test_ops_attention_on_cpu_takes_plain_version(name):
    arrays = _inputs(name, np.float32)
    flags = CASES[name][1]
    before = fa.launches
    got = _port(ops.attention, arrays, flags)
    np.testing.assert_array_equal(got, _port(T.attention_ref, arrays, flags))
    assert fa.launches == before
