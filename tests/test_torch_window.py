"""The port's copied dependency engine against the reference: on random
interleaved streams both windows report the same upstream sets, the same
READY order ``(priority bucket, seq, tid)``, the same ``WindowStats``, and
``dependency_arrays`` gives the same tables. Tasks are compared by stream
position (each package numbers tids with its own counter)."""

import numpy as np
import pytest
from _prophelper import given, settings, st

import _torch_streams as S
from repro.core.scoreboard import dependency_arrays as r_dependency_arrays
from repro_torch.core.scoreboard import dependency_arrays as t_dependency_arrays

DEP_ARRAYS = {"ref": r_dependency_arrays, "port": t_dependency_arrays}


def _segset(side, spans):
    pkg = S.PKG[side]
    return pkg.SegmentSet([pkg.Segment(a, b) for a, b in spans])


def _random_specs(rng, n, span=1 << 10, max_size=48):
    """Per task: (read spans, write spans, priority) over a small address
    span, so hazards are dense."""
    def spans():
        return [(int(rng.randint(0, span)), int(rng.randint(0, max_size)))
                for _ in range(rng.randint(1, 4))]
    return [(spans(), spans(), int(rng.randint(0, 3))) for _ in range(n)]


def _tasks(side, specs):
    pkg = S.PKG[side]
    return [pkg.Task(opcode="t", fn=None, inputs=(), outputs=(),
                     read_segments=_segset(side, r), write_segments=_segset(side, w),
                     priority=p)
            for r, w, p in specs]


def _observe(window, pos):
    """Resident upstream sets and READY order, by stream position."""
    ups = {pos[tid]: sorted(pos[u] for u in slot.upstream)
           for tid, slot in window.slots.items()}
    ready = [pos[t.tid] for t in window.ready_tasks()]
    return ups, ready


@given(st.integers(0, 10_000), st.integers(1, 24))
@settings(max_examples=25, deadline=None)
def test_property_interleaved_window_matches_reference(seed, size):
    rng = np.random.RandomState(seed)
    specs = _random_specs(rng, 60)
    ref, port = _tasks("ref", specs), _tasks("port", specs)
    rpos, ppos = S.positions(ref), S.positions(port)
    wr, wp = S.R.SchedulingWindow(size), S.T.SchedulingWindow(size)
    wr.open_input()
    wp.open_input()
    fed = 0
    while fed < len(specs) or not wp.idle():
        if fed < len(specs) and rng.rand() < 0.5:
            k = int(rng.randint(1, 6))
            for i in range(fed, min(fed + k, len(specs))):
                wr.submit(ref[i])
                wp.submit(port[i])
            fed = min(fed + k, len(specs))
        else:
            ready_r, ready_p = wr.ready_tasks(), wp.ready_tasks()
            if not ready_p:
                continue
            pick = [i for i in range(len(ready_p)) if rng.rand() < 0.6] or [0]
            for i in pick:
                wr.mark_executing(ready_r[i])
                wp.mark_executing(ready_p[i])
            for i in pick:
                wr.retire(ready_r[i])
                wp.retire(ready_p[i])
        assert _observe(wr, rpos) == _observe(wp, ppos)
        assert wr.stats.as_dict() == wp.stats.as_dict()
        assert wr.backlog() == wp.backlog()


@pytest.mark.parametrize("seed", range(4))
def test_drain_program_order_matches_reference(seed):
    specs = _random_specs(np.random.RandomState(seed), 80)
    ref, port = _tasks("ref", specs), _tasks("port", specs)
    wr, wp = S.R.SchedulingWindow(16), S.T.SchedulingWindow(16)
    wr.submit_all(ref)
    wp.submit_all(port)
    rpos, ppos = S.positions(ref), S.positions(port)
    assert [rpos[t.tid] for t in wr.drain_program_order()] == \
        [ppos[t.tid] for t in wp.drain_program_order()]
    assert wr.stats.as_dict() == wp.stats.as_dict()


@pytest.mark.parametrize("stream", ["random", "sim", "mixed_tag", "chain"])
def test_dependency_arrays_match_reference(stream):
    if stream == "random":
        specs = _random_specs(np.random.RandomState(7), 120)
        ref, port = _tasks("ref", specs), _tasks("port", specs)
    else:
        (_, ref), (_, port) = S.STREAMS[stream]("ref"), S.STREAMS[stream]("port")
    r_indeg, r_dep = DEP_ARRAYS["ref"](ref)
    p_indeg, p_dep = DEP_ARRAYS["port"](port)
    np.testing.assert_array_equal(r_indeg, p_indeg)
    np.testing.assert_array_equal(r_dep, p_dep)
    assert p_indeg.dtype == np.int32 and p_dep.dtype == np.int32
