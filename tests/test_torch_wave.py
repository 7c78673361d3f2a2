"""The port's wave megakernel on the CPU: the plain path of
``wave_elementwise``/``wave_step`` (``wave_rows_ref``, the oracle of the
CUDA kernel) against the reference's Pallas ``wave_elementwise`` in
interpret mode and its loop oracle, over random waves with unique out rows
and the ready queue's branch table; the wrapper's refusals of unknown
branch fns and bad descriptors; and its opcode table against the CUDA
source. The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prophelper import given, settings, st

from repro.kernels import ref as r_ref
from repro.kernels.ops import LOOP_BRANCHES as R_BRANCHES
from repro.kernels.ops import wave_step as r_wave_step
from repro.kernels.wave_elementwise import apply_wave as r_apply_wave
from repro.kernels.wave_elementwise import wave_elementwise as r_wave_elementwise
we = importlib.import_module("repro_torch.kernels.wave_elementwise")
from repro_torch.kernels.ops import LOOP_BRANCHES, LOOP_OPCODES, wave_step
from repro_torch.kernels.ref import wave_elementwise_ref, wave_rows_ref

# The branches round their multiply-add once, as XLA contracts it; where the
# reference runs eagerly it rounds twice, so the packages agree to a few
# ulps, not bitwise.
RTOL = ATOL = 1e-6

NAMES = ("axpy", "mul")
T_BR = tuple(LOOP_BRANCHES[n] for n in NAMES)
R_BR = tuple(R_BRANCHES[n] for n in NAMES)


def _wave(seed, r, d, s, self_read=False):
    """A random wave: slab ``[r, d]`` and ``s`` slots with unique out rows;
    ``self_read`` makes slot 0 read its own out row and every slot share
    one input row."""
    rng = np.random.RandomState(seed)
    slab = rng.randn(r, d).astype(np.float32)
    ops = rng.randint(0, len(NAMES), s)
    ins = rng.randint(0, r, (s, 2))
    outs = rng.choice(r, s, replace=False)  # unique out rows (window invariant)
    if self_read:
        ins[:, 1] = ins[0, 0]
        ins[0, 0] = outs[0]
    desc = np.concatenate([ops[:, None], ins, outs[:, None]], axis=1).astype(np.int32)
    return slab, desc


def _ref_step(slab, desc):
    rows = r_wave_elementwise(jnp.asarray(slab), jnp.asarray(desc), branches=R_BR,
                              interpret=True)
    return np.asarray(rows), np.asarray(r_apply_wave(jnp.asarray(slab), jnp.asarray(desc), rows))


@given(st.integers(0, 10_000), st.integers(1, 12), st.sampled_from([1, 8, 37, 128]))
@settings(max_examples=20, deadline=None)
def test_property_random_waves_match_reference(seed, s, d):
    slab, desc = _wave(seed, max(s, 4) + 2, d, s, self_read=seed % 2 == 0)
    want_rows, want = _ref_step(slab, desc)
    ts, td = torch.from_numpy(slab), torch.from_numpy(desc)
    rows = we.wave_elementwise(ts, td, branches=T_BR)
    np.testing.assert_allclose(rows.numpy(), want_rows, rtol=RTOL, atol=ATOL)
    got = wave_step(ts, td, branches=T_BR)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the reference's loop oracle, and the port's copy of it, agree too
    oracle = r_ref.wave_elementwise_ref(jnp.asarray(slab), desc[:, 0], desc[:, 1:3],
                                        desc[:, 3], R_BR)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=RTOL, atol=ATOL)
    port_oracle = wave_elementwise_ref(ts, desc[:, 0], desc[:, 1:3], desc[:, 3], T_BR)
    assert torch.equal(port_oracle, got)
    assert torch.equal(ts, torch.from_numpy(slab)), "the input slab was modified"


@pytest.mark.parametrize("s,d", [(1, 1), (7, 37), (32, 4096), (64, 16)])
def test_plain_path_is_one_eager_call_per_slot(s, d):
    """``wave_rows_ref`` row ``si`` is exactly the branch's eager call on
    the unmodified slab (the bits the CUDA kernel reproduces)."""
    slab, desc = _wave(s * 31 + d, s + 5, d, s, self_read=True)
    ts = torch.from_numpy(slab)
    rows = wave_rows_ref(ts, torch.from_numpy(desc), T_BR)
    for si, (b, i0, i1, _) in enumerate(desc):
        want = T_BR[b](ts[i0], ts[i1])
        assert torch.equal(rows[si].view(torch.int32), want.view(torch.int32))


def test_reference_wave_step_matches_port_wave_step():
    slab, desc = _wave(3, 10, 16, 6)
    want = np.asarray(r_wave_step(jnp.asarray(slab), jnp.asarray(desc), branches=R_BR,
                                  use_pallas=False))
    got = wave_step(torch.from_numpy(slab), torch.from_numpy(desc), branches=T_BR)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_calls_count_no_kernel_launch():
    slab, desc = _wave(0, 8, 8, 4)
    before = we.launches
    wave_step(torch.from_numpy(slab), torch.from_numpy(desc), branches=T_BR)
    assert we.launches == before


def test_unknown_branch_fn_is_refused():
    slab, desc = _wave(0, 8, 8, 4)
    with pytest.raises(ValueError, match="no kernel opcode"):
        we.wave_elementwise(torch.from_numpy(slab), torch.from_numpy(desc),
                            branches=(T_BR[0], lambda x, y: x - y))


@pytest.mark.parametrize("col,bad", [(0, 2), (0, -1), (1, 8), (2, -3), (3, 10 ** 6)])
def test_bad_descriptor_raises(col, bad):
    slab, desc = _wave(1, 8, 8, 4)
    desc[2, col] = bad
    with pytest.raises(ValueError, match=r"descriptor slots \[2\]"):
        wave_step(torch.from_numpy(slab), torch.from_numpy(desc), branches=T_BR)


def test_wrapper_rejects_non_cpu_non_cuda_device():
    with pytest.raises(ValueError, match="unsupported device"):
        we.wave_elementwise(torch.zeros((2, 4), device="meta"),
                            torch.zeros((1, 4), dtype=torch.int32, device="meta"),
                            branches=T_BR)


def test_opcodes_match_the_cuda_source():
    """The wrapper's fn -> opcode table and the wave kernel's OP_* constants
    name the same branches with the same numbers."""
    src = we.SOURCE.read_text()
    consts = {m.group(1).lower(): int(m.group(2))
              for m in re.finditer(r"constexpr int OP_(\w+) = (\d+);", src)}
    assert consts == {name: LOOP_OPCODES[fn] for name, fn in LOOP_BRANCHES.items()}
