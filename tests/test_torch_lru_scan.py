"""The port's scan plain version against the reference's: its oracle
``lru_scan_ref`` and its Pallas ``lru_scan`` in interpret mode, on the same
numpy inputs, for S in {1, 7, 256, 300} (300 takes the Pallas padding
path), B in {1, 3}, float32 and bfloat16. On the CPU ``ops.lru_scan`` takes
the plain version and launches no kernel.

Tolerances: float32 2e-5 (the reference's own kernel tests); bfloat16
2e-2, because bf16 rounds at other places in the two frameworks.
"""

import importlib
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import lru_scan as pallas_lru
from repro.kernels import ref as R
ls = importlib.import_module("repro_torch.kernels.lru_scan")
from repro_torch.kernels import ops
from repro_torch.kernels import ref as T

D = 16
SWEEP = [(b, s, dt) for b in (1, 3) for s in (1, 7, 256, 300) for dt in ("float32", "bfloat16")]
IDS = [f"b{b}-s{s}-{dt}" for b, s, dt in SWEEP]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(b, s, seed=0):
    rng = np.random.RandomState(seed + 10 * b + s)
    return (rng.uniform(0.5, 0.99, (b, s, D)).astype(np.float32),
            rng.randn(b, s, D).astype(np.float32), rng.randn(b, D).astype(np.float32))


def _ref_side(a, x, h0, dt):
    return jnp.asarray(a, dt), jnp.asarray(x, dt), jnp.asarray(h0)


def _port(fn, a, x, h0, dt):
    tdt = getattr(torch, dt)
    out = fn(torch.from_numpy(a).to(tdt), torch.from_numpy(x).to(tdt), torch.from_numpy(h0))
    assert out.dtype == tdt
    return out.float().numpy()


@pytest.mark.parametrize("b,s,dt", SWEEP, ids=IDS)
def test_plain_matches_reference_oracle(b, s, dt):
    a, x, h0 = _inputs(b, s)
    want = np.asarray(R.lru_scan_ref(*_ref_side(a, x, h0, dt)), np.float32)
    np.testing.assert_allclose(_port(T.lru_scan_ref, a, x, h0, dt), want, **TOL[dt])


@pytest.mark.parametrize("b,s,dt", SWEEP, ids=IDS)
def test_plain_matches_pallas_interpret(b, s, dt):
    a, x, h0 = _inputs(b, s)
    want = np.asarray(pallas_lru(*_ref_side(a, x, h0, dt)), np.float32)
    np.testing.assert_allclose(_port(T.lru_scan_ref, a, x, h0, dt), want, **TOL[dt])


@pytest.mark.parametrize("s", [1, 7, 300])
def test_ops_lru_scan_on_cpu_takes_plain_version(s):
    a, x, h0 = _inputs(2, s)
    before = ls.launches
    got = _port(ops.lru_scan, a, x, h0, "float32")
    np.testing.assert_array_equal(got, _port(T.lru_scan_ref, a, x, h0, "float32"))
    assert ls.launches == before


def test_identity_decay_keeps_state():
    h0 = np.random.RandomState(3).randn(1, D).astype(np.float32)
    out = T.lru_scan_ref(torch.ones(1, 8, D), torch.zeros(1, 8, D), torch.from_numpy(h0))
    np.testing.assert_array_equal(out[:, -1].numpy(), h0)
