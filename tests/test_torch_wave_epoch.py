"""The port's wave-epoch entry on the CPU: ``wave_epoch``'s plain path (one
``wave_elementwise`` call and scatter per plan step, in place) against the
reference's per-step loop — ``repro.kernels.ops.wave_step(...,
use_pallas=False)`` and the Pallas ``wave_elementwise`` in interpret mode
with ``apply_wave`` — step after step, over random plans of 1-40 steps
with self-reads and reads of another slot's out row within a step; bit for
bit against the port's own single-step loop, with and without the
``direct`` marks of :func:`direct_steps`; its offset and ``direct``
checks; the device window (``DeviceWindowRunner`` and ``DeviceSession``,
wave and frontier) through it, bit-equal to ``run_serial``, one
``wave_epoch`` call per dispatch; and no launch counted on the CPU. The
CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance against the reference: rtol = atol = 1e-6, as in
``tests/test_torch_wave.py`` (XLA may contract a multiply-add on the CPU
where eager PyTorch rounds twice); each step is compared from the same
input slab, so the differences do not compound. A contracted step differs
by up to half an ulp of its largest intermediate term, which that
tolerance covers while the terms stay O(1): the plans spread their steps
over 48 rows, so a row is rewritten a few times in an epoch, not dozens
(over 12 rows, 40 steps grow rows past 1e3, and the half ulp of such a
term exceeds 1e-6 where it cancels)."""

import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prophelper import given, settings, st

import _torch_streams as S
from repro.kernels.ops import LOOP_BRANCHES as R_BRANCHES
from repro.kernels.ops import wave_step as r_wave_step
from repro.kernels.wave_elementwise import apply_wave as r_apply_wave
from repro.kernels.wave_elementwise import wave_elementwise as r_wave_elementwise
from repro_torch.core.device_dispatch import _wave_kernel_parts, plan_waves
from repro_torch.kernels import lru_scan as ls
from repro_torch.kernels import ready_queue as rq
from repro_torch.kernels import wave_elementwise as we
from repro_torch.kernels.ops import LOOP_BRANCHES, wave_step

RTOL = ATOL = 1e-6
NAMES = ("axpy", "mul")
T_BR = tuple(LOOP_BRANCHES[n] for n in NAMES)
R_BR = tuple(R_BRANCHES[n] for n in NAMES)
ROWS = 48
WINDOW = 8


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _plan(seed, n_steps, d):
    """``chip_smoke.random_plan``: a slab ``[ROWS, d]`` and ``n_steps`` steps
    of 1-6 slots with unique out rows per step; a step's first slot may
    read its own out row, or another slot's out row. Returns (slab, desc,
    offsets)."""
    return _chip_smoke().random_plan(seed, n_steps, d, rows=ROWS)


def _steps(desc, offsets):
    return [desc[lo:hi] for lo, hi in zip(offsets[:-1], offsets[1:])]


def _bits(t):
    return t.contiguous().view(torch.int32)


@given(st.integers(0, 10_000), st.integers(1, 40), st.sampled_from([8, 37]))
@settings(max_examples=20, deadline=None)
def test_property_random_epochs_match_reference_step_after_step(seed, n_steps, d):
    slab, desc, offsets = _plan(seed, n_steps, d)
    got = we.wave_epoch(torch.from_numpy(slab.copy()), torch.from_numpy(desc), offsets,
                        branches=T_BR)
    cur = torch.from_numpy(slab.copy())
    for step in _steps(desc, offsets):
        before = cur.numpy().copy()
        cur = we.wave_epoch(cur.clone(), torch.from_numpy(step), [0, len(step)], branches=T_BR)
        want = np.asarray(r_wave_step(jnp.asarray(before), jnp.asarray(step), branches=R_BR,
                                      use_pallas=False))
        np.testing.assert_allclose(cur.numpy(), want, rtol=RTOL, atol=ATOL)
        rows = r_wave_elementwise(jnp.asarray(before), jnp.asarray(step), branches=R_BR,
                                  interpret=True)
        pallas = np.asarray(r_apply_wave(jnp.asarray(before), jnp.asarray(step), rows))
        np.testing.assert_allclose(cur.numpy(), pallas, rtol=RTOL, atol=ATOL)
    # the whole epoch is the port's single-step loop, bit for bit
    assert torch.equal(_bits(got), _bits(cur))
    loop = torch.from_numpy(slab.copy())
    for step in _steps(desc, offsets):
        loop = wave_step(loop, torch.from_numpy(step), branches=T_BR)
    assert torch.equal(_bits(got), _bits(loop))
    marked = we.wave_epoch(torch.from_numpy(slab.copy()), torch.from_numpy(desc), offsets,
                           branches=T_BR, direct=we.direct_steps(desc, offsets))
    assert torch.equal(_bits(marked), _bits(got))


def test_epoch_updates_the_slab_in_place():
    slab, desc, offsets = _plan(3, 5, 8)
    t = torch.from_numpy(slab.copy())
    out = we.wave_epoch(t, torch.from_numpy(desc), offsets, branches=T_BR)
    assert out is t and not np.array_equal(t.numpy(), slab)


def test_direct_steps_marks_the_disjoint_steps():
    desc = np.array([[0, 0, 1, 2], [1, 2, 2, 3],   # slot 1 reads slot 0's out row
                     [0, 3, 4, 3],                 # a self-read only
                     [1, 0, 1, 1], [0, 1, 0, 0],   # each reads the other's out row
                     [0, 5, 6, 7], [1, 5, 6, 8],   # reads of rows nobody writes
                     [0, 1, 2, 9], [1, 1, 2, 9]],  # a repeated out row
                    np.int32)
    offsets = [0, 2, 3, 5, 7, 9]
    assert we.direct_steps(desc, offsets) == (False, True, False, True, False)
    assert we.direct_steps(desc[:0], [0]) == ()


def test_chain_universe_steps_are_all_direct():
    _, tasks = S.chain_universe("port")
    plan = plan_waves(tasks, WINDOW)
    arena = S.T.SlabArena()
    arena.add_tasks(tasks)
    prog, why = _wave_kernel_parts(plan, _registry(tasks), arena)
    assert why == "" and len(prog.direct) == prog.n_steps == len(plan)
    assert all(prog.direct)


def test_a_wrong_direct_mark_is_refused():
    desc = np.array([[0, 0, 1, 2], [1, 2, 2, 3]], np.int32)
    slab = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="marked direct"):
        we.wave_epoch(slab, torch.from_numpy(desc), [0, 2], branches=T_BR, direct=[True])
    with pytest.raises(ValueError, match="direct flags"):
        we.wave_epoch(slab, torch.from_numpy(desc), [0, 2], branches=T_BR, direct=[True, False])


@pytest.mark.parametrize("offsets,match", [
    ([0, 3, 2, 5], "must not decrease"),
    ([0, 2, 4], "from 0 to the 5"),
    ([0, 2, 6], "from 0 to the 5"),
    ([1, 2, 5], "from 0 to the 5"),
    ([], "1-D sequence"),
    ([[0, 5]], "1-D sequence"),
    ([0.0, 5.0], "1-D sequence"),
])
def test_offset_checks(offsets, match):
    desc = np.array([[0, 1, 2, 3]] * 5, np.int32)
    with pytest.raises(ValueError, match=match):
        we.wave_epoch(torch.zeros(ROWS, 8), torch.from_numpy(desc), offsets, branches=T_BR)


def test_empty_steps_and_an_empty_epoch_run():
    slab, desc, offsets = _plan(5, 3, 8)
    padded = [0] + [o for o in offsets[1:] for _ in range(2)]  # an empty step after each
    got = we.wave_epoch(torch.from_numpy(slab.copy()), torch.from_numpy(desc), padded,
                        branches=T_BR)
    want = we.wave_epoch(torch.from_numpy(slab.copy()), torch.from_numpy(desc), offsets,
                         branches=T_BR)
    assert torch.equal(_bits(got), _bits(want))
    empty = torch.from_numpy(slab.copy())
    we.wave_epoch(empty, torch.zeros((0, 4), dtype=torch.int32), [0], branches=T_BR)
    assert np.array_equal(empty.numpy(), slab)


@pytest.mark.parametrize("col,bad", [(0, 2), (1, -1), (2, ROWS), (3, 10 ** 6)])
def test_a_bad_descriptor_in_a_middle_step_raises(col, bad):
    slab, desc, offsets = _plan(7, 6, 8)
    desc[offsets[3], col] = bad
    with pytest.raises(ValueError, match="descriptor slots"):
        we.wave_epoch(torch.from_numpy(slab), torch.from_numpy(desc), offsets, branches=T_BR)


def test_unknown_branch_and_device_are_refused():
    slab, desc, offsets = _plan(1, 2, 8)
    with pytest.raises(ValueError, match="no kernel opcode"):
        we.wave_epoch(torch.from_numpy(slab), torch.from_numpy(desc), offsets,
                      branches=(T_BR[0], lambda x, y: x - y))
    with pytest.raises(ValueError, match="unsupported device"):
        we.wave_epoch(torch.zeros((ROWS, 8), device="meta"),
                      torch.zeros((len(desc), 4), dtype=torch.int32, device="meta"), offsets,
                      branches=T_BR)


def test_cpu_epoch_counts_no_launch():
    slab, desc, offsets = _plan(2, 10, 8)
    launches, steps = we.launches, we.steps
    we.wave_epoch(torch.from_numpy(slab), torch.from_numpy(desc), offsets, branches=T_BR)
    assert (we.launches, we.steps) == (launches, steps)


# ---------------------------------------------------------------------------
# The device window through wave_epoch
# ---------------------------------------------------------------------------

BUILD = {"chain": S.chain_universe, "mixed_tag8": lambda side: S.mixed_tag(side, d=8)}


def _registry(tasks):
    reg = S.T.DeviceOpRegistry(strict=False)
    S.REGISTER["port"](reg)
    for t in tasks:
        if t.fn in set(LOOP_BRANCHES.values()):
            reg.register_switch_branch(t.opcode, t.fn)
    return reg


def _serial(stream):
    bufs, tasks = BUILD[stream]("port")
    S.run_serial("port", tasks)
    return S.snapshot(bufs)


def _count_epochs(monkeypatch):
    calls = []
    real = we.wave_epoch

    def counting(slab, desc, offsets, **kw):
        calls.append(len(offsets) - 1)
        return real(slab, desc, offsets, **kw)

    monkeypatch.setattr(we, "wave_epoch", counting)
    return calls


@pytest.mark.parametrize("mode", ["wave", "frontier"])
@pytest.mark.parametrize("stream", sorted(BUILD))
def test_runner_runs_one_epoch_bit_equal_to_serial(monkeypatch, stream, mode):
    calls = _count_epochs(monkeypatch)
    bufs, tasks = BUILD[stream]("port")
    launches, steps = we.launches, we.steps
    report = S.T.DeviceWindowRunner(registry=_registry(tasks), window_size=WINDOW,
                                    plan_mode=mode, wave_kernel=True, device="cpu").run(tasks)
    assert report.wave_executor == "ref"
    assert calls == [len(report.waves)]  # one epoch call runs every plan step
    assert report.wave_kernel_launches == report.wave_kernel_steps == 0  # the plain version
    assert (we.launches, we.steps) == (launches, steps)
    assert report.exec_stats["dispatches"] == 1
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial(stream).view(np.int32))


@pytest.mark.parametrize("mode", ["wave", "frontier"])
@pytest.mark.parametrize("stream", sorted(BUILD))
def test_session_runs_one_epoch_per_dispatch_bit_equal_to_serial(monkeypatch, stream, mode):
    calls = _count_epochs(monkeypatch)
    bufs, tasks = BUILD[stream]("port")
    session = S.T.DeviceSession(window_size=WINDOW, registry=_registry(tasks), plan_mode=mode,
                                wave_kernel=True, device="cpu")
    n = max(1, len(tasks) // 4)
    for i in range(0, len(tasks), n):
        session.submit(tasks[i:i + n])
        session.poll()
    stats = session.close().session_stats
    assert stats["wave_kernel_dispatches"] == stats["device_dispatches"] == len(calls) > 0
    assert sum(calls) == len(session.stats.wave_widths)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial(stream).view(np.int32))


# ---------------------------------------------------------------------------
# The C entry points the wrappers bind, against the sources
# ---------------------------------------------------------------------------

class _Lib:
    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("mod,entries", [(we, ("acs_wave_elementwise", "acs_wave_epoch")),
                                         (ls, ("acs_lru_scan",)),
                                         (rq, ("acs_ready_queue",))])
def test_bound_argtypes_match_the_c_entry_points(mod, entries):
    """ctypes passes each argument as its ``argtypes`` entry says; a count
    that differs from the C signature would shift every argument after it.
    Pointers must be ``c_void_p`` (a 64-bit value), ints ``c_int``."""
    lib = _Lib()
    mod._bind(lib)
    src = mod.SOURCE.read_text()
    for name in entries:
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert getattr(lib, name).argtypes == kinds, name
