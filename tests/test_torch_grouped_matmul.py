"""The port's ragged grouped GEMM on the CPU (its plain version) against
the reference's Pallas kernel in interpret mode and its oracle
``grouped_matmul_ref``, on the same seeded numpy inputs: the reference's
ragged cases (``tests/test_kernels.py``: N not a multiple of the tile,
groups with no tile), ``block_m = 1`` (the MoE decode layout: one row per
expert) and the uniform MoE capacity layout (``tile_groups =
arange(E_pad)``, ``block_m = C``). Also the wrapper's checks, which hold on
every device (a group id outside ``[0, G)`` raises), and
``ops.register_device_ops`` against the reference's.

Tolerances: float32 2e-5 (the reference's own for this kernel: summation
order); float16 and bfloat16 one output ulp of the type (2^-10 and 2^-7
relative), since every version sums in float32 and rounds once.
"""

import importlib
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.device_dispatch import DeviceOpRegistry as RRegistry
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.grouped_matmul import grouped_matmul as r_gmm
from repro_torch.core import DeviceOpRegistry
gm = importlib.import_module("repro_torch.kernels.grouped_matmul")
from repro_torch.kernels import ops
from repro_torch.kernels.ref import grouped_matmul_ref

from _prophelper import given, settings, st

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "float16": dict(rtol=2 ** -10, atol=2 ** -10),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
NP_DTYPES = {"float32": np.float32, "float16": np.float16}
T_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}

# (G, K, N, block_m, tile group ids): tests/test_kernels.py's ragged cases,
# then block_m = 1 (MoE decode) and the uniform capacity layout.
CASES = {
    "two_groups": (2, 16, 16, 8, (0, 1)),
    "ragged": (4, 32, 48, 8, (0, 0, 1, 2, 2, 3)),
    "n_not_tile_multiple": (8, 64, 24, 16, (0, 2, 2, 4, 7)),  # groups 1, 3, 5, 6 have no tile
    "block_m_1": (6, 24, 40, 1, (5, 0, 0, 3, 1, 2, 4, 4)),
    "moe_capacity_layout": (16, 64, 32, 3, tuple(range(16))),
}


def _inputs(case, dtype, seed=0):
    g, k, n, bm, tiles = CASES[case]
    rng = np.random.RandomState(seed)
    x = rng.randn(len(tiles) * bm, k).astype(np.float32)
    w = rng.randn(g, k, n).astype(np.float32)
    return x, w, np.asarray(tiles, np.int32), bm


def _port(arr, dtype):
    return torch.from_numpy(arr).to(T_DTYPES[dtype])


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_the_reference_kernel_and_oracle(case, dtype):
    x, w, tiles, bm = _inputs(case, dtype)
    x, w = x.astype(NP_DTYPES[dtype]), w.astype(NP_DTYPES[dtype])
    before = gm.launches
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tiles),
                            block_m=bm)
    assert gm.launches == before  # the CPU takes the plain version
    assert got.dtype == T_DTYPES[dtype] and tuple(got.shape) == (x.shape[0], w.shape[2])
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(tiles))
    oracle = np.asarray(r_ref.grouped_matmul_ref(*args, block_m=bm), np.float32)
    kernel = np.asarray(r_gmm(*args, block_m=bm, block_n=16, interpret=True), np.float32)
    np.testing.assert_allclose(_f32(got), oracle, **TOL[dtype])
    np.testing.assert_allclose(_f32(got), kernel, **TOL[dtype])


@pytest.mark.parametrize("case", sorted(CASES))
def test_bfloat16_matches_the_reference_oracle(case):
    x, w, tiles, bm = _inputs(case, "bfloat16", seed=1)
    xt, wt = _port(x, "bfloat16"), _port(w, "bfloat16")
    got = ops.grouped_matmul(xt, wt, torch.from_numpy(tiles), block_m=bm)
    assert got.dtype == torch.bfloat16
    # the same bfloat16 inputs on both sides
    want = r_ref.grouped_matmul_ref(jnp.asarray(_f32(xt), jnp.bfloat16),
                                    jnp.asarray(_f32(wt), jnp.bfloat16),
                                    jnp.asarray(tiles), block_m=bm)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), **TOL["bfloat16"])


def test_plain_version_is_the_per_row_product():
    x, w, tiles, bm = _inputs("ragged", "float32")
    got = grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tiles),
                             block_m=bm).numpy()
    for t in range(x.shape[0]):
        want = x[t].astype(np.float64) @ w[tiles[t // bm]].astype(np.float64)
        np.testing.assert_allclose(got[t], want, rtol=1e-5, atol=1e-5)


@given(st.integers(1, 6), st.integers(1, 4), st.integers(1, 5))
@settings(max_examples=10, deadline=None)
def test_property_random_tiling(n_tiles, g, bm):
    rng = np.random.RandomState(n_tiles * 31 + g * 7 + bm)
    tiles = rng.randint(0, g, n_tiles).astype(np.int32)
    k, n = 16, 20
    x = rng.randn(n_tiles * bm, k).astype(np.float32)
    w = rng.randn(g, k, n).astype(np.float32)
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tiles),
                            block_m=bm)
    want = r_ref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tiles),
                                    block_m=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("bad", [-1, 4])
def test_group_id_outside_the_groups_raises(bad):
    x, w, tiles, bm = _inputs("ragged", "float32")
    tiles[2] = bad
    with pytest.raises(ValueError, match=r"outside \[0, G\)"):
        gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tiles),
                          block_m=bm)


def test_wrapper_checks_inputs():
    x, w, tiles, bm = _inputs("ragged", "float32")
    x, w, tiles = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tiles)
    with pytest.raises(ValueError, match="does not divide"):
        gm.grouped_matmul(x[:-1], w, tiles, block_m=bm)
    with pytest.raises(ValueError, match="does not divide"):
        gm.grouped_matmul(x, w, tiles, block_m=0)
    with pytest.raises(ValueError, match="tile ids"):
        gm.grouped_matmul(x, w, tiles[:-1], block_m=bm)
    with pytest.raises(ValueError, match="does not match"):
        gm.grouped_matmul(x, w[:, :-1], tiles, block_m=bm)
    with pytest.raises(TypeError, match="share one of"):
        gm.grouped_matmul(x, w.double(), tiles, block_m=bm)
    with pytest.raises(TypeError, match="int32"):
        gm.grouped_matmul(x, w, tiles.long(), block_m=bm)
    with pytest.raises(ValueError, match=r"x \[M, K\]"):
        gm.grouped_matmul(x[None], w, tiles, block_m=bm)


def test_register_device_ops_matches_the_reference():
    ours, theirs = DeviceOpRegistry(strict=False), RRegistry(strict=False)
    assert ops.register_device_ops(ours) == r_ops.register_device_ops(theirs)
    assert set(ops.register_device_ops(ours)) == {"attention", "grouped_matmul", "lru_scan"}
