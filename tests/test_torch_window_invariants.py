"""The reference's window invariants (``tests/test_window_invariants.py``,
its 20 tests) held against the port on the CPU: each test drives the same
scripted operations through ``repro.core.SchedulingWindow`` and
``repro_torch.core.SchedulingWindow`` and requires the same structure from
both (READY order, retire order and errors, by stream position, since
tids differ between the packages), besides the reference's own
assertions on the port: serial degeneracy at size 1, the residency cap,
retire-state validation, no deadlock on full-window streams, the
incremental ``retire_many`` path, and priority-bucketed READY order.

Property tests run through ``tests/_prophelper.py``: the same seeded
scripts reach both packages."""

import random
import re

import numpy as np
from _prophelper import given, settings, st

import _torch_streams as S

SIDES = S.SIDES


def make_task(side, reads, writes, priority=1):
    r, w = S.DEFAULT_SEGMENTS[side](reads, writes)
    return S.PKG[side].Task(opcode="op", fn=lambda *xs: xs[0] if xs else None,
                            inputs=tuple(reads), outputs=tuple(writes),
                            read_segments=r, write_segments=w, priority=priority)


def bufs(side, n, d=4):
    pool = S.pool(side)
    return [pool.alloc((d,), np.float32, value=S.value(side, np.zeros(d, np.float32)))
            for _ in range(n)]


def random_stream(side, seed, n_tasks, n_buffers):
    """Random read/write pattern over a shared pool: dense hazards."""
    rng = np.random.RandomState(seed)
    bs = bufs(side, n_buffers)
    tasks = []
    for _ in range(n_tasks):
        i0, i1 = rng.randint(n_buffers), rng.randint(n_buffers)
        o = rng.randint(n_buffers)
        tasks.append(make_task(side, [bs[i0], bs[i1]], [bs[o]]))
    return tasks


def window(side, size):
    return S.PKG[side].SchedulingWindow(size=size)


def drain(w):
    """Drive the window to empty, oldest READY first; returns retire order.
    Raises on stall."""
    order = []
    while not w.drained():
        ready = w.ready_tasks()
        if not ready:
            raise RuntimeError("stall: no READY kernels but window non-empty")
        t = ready[0]
        w.mark_executing(t)
        w.retire(t)
        order.append(t.tid)
    return order


def both(run):
    """``run(side)`` on both packages; the results must be equal."""
    got = {side: run(side) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


def error_of(call):
    """(exception type, message with task ids masked), or None."""
    try:
        call()
    except Exception as exc:  # the test compares what each package raises
        return type(exc).__name__, re.sub(r"\d+", "#", str(exc))
    return None


def drained_positions(side, tasks, size):
    pos = S.positions(tasks)
    w = window(side, size)
    w.submit_all(tasks)
    order = [pos[t] for t in drain(w)]
    return order, w.stats.max_resident, w.stats.inserted, w.stats.retired


class TestSerialDegeneracy:
    @given(st.integers(0, 10_000))
    @settings(max_examples=25, deadline=None)
    def test_property_window_one_is_program_order(self, seed):
        order, *_ = both(lambda side: drained_positions(side, random_stream(side, seed, 20, 4),
                                                        1))
        assert order == list(range(20))

    def test_window_one_single_ready_at_a_time(self):
        def run(side):
            tasks = random_stream(side, 0, 10, 3)
            pos = S.positions(tasks)
            w = window(side, 1)
            w.submit_all(tasks)
            seen = []
            while not w.drained():
                ready = w.ready_tasks()
                assert len(ready) == 1
                seen.append(pos[ready[0].tid])
                w.mark_executing(ready[0])
                w.retire(ready[0])
            return seen

        assert both(run) == list(range(10))


class TestRetireValidation:
    def _case(self, side, what):
        a, b, c = bufs(side, 3)
        w = window(side, 4)
        t1 = make_task(side, [a], [b])
        t2 = make_task(side, [b], [c])  # RAW on b: PENDING
        if what == "pending":
            w.submit_all([t1, t2])
            return error_of(lambda: w.retire(t2))
        if what == "ready":
            w.submit_all([t1])
            return error_of(lambda: w.retire(t1))  # READY, never EXECUTING
        if what == "unknown":
            return error_of(lambda: w.retire(t1))
        w.submit_all([t1])
        w.mark_executing(t1)
        w.retire(t1)
        return error_of(lambda: w.retire(t1))

    def test_retire_pending_raises(self):
        assert both(lambda side: self._case(side, "pending"))[0] == "RuntimeError"

    def test_retire_ready_but_not_executing_raises(self):
        assert both(lambda side: self._case(side, "ready"))[0] == "RuntimeError"

    def test_retire_unknown_task_raises(self):
        assert both(lambda side: self._case(side, "unknown"))[0] == "RuntimeError"

    def test_double_retire_raises(self):
        assert both(lambda side: self._case(side, "double"))[0] == "RuntimeError"


class TestResidencyCap:
    @given(st.integers(0, 10_000), st.integers(1, 9))
    @settings(max_examples=25, deadline=None)
    def test_property_max_resident_never_exceeds_size(self, seed, size):
        _, max_resident, inserted, retired = both(
            lambda side: drained_positions(side, random_stream(side, seed, 30, 5), size))
        assert max_resident <= size
        assert inserted == retired == 30


class TestNoDeadlock:
    @given(st.integers(0, 10_000))
    @settings(max_examples=25, deadline=None)
    def test_property_full_window_stream_never_stalls(self, seed):
        order, *_ = both(lambda side: drained_positions(side, random_stream(side, seed, 40, 3),
                                                        8))
        assert sorted(order) == list(range(40))

    def test_conservative_chain_fills_window_and_drains(self):
        def run(side):
            (shared,) = bufs(side, 1)
            tasks = [make_task(side, [shared], [shared]) for _ in range(12)]
            return drained_positions(side, tasks, 4)[0]

        assert both(run) == list(range(12))


class TestRetireMany:
    def test_matches_sequential_retires(self):
        def run(side, seed, many):
            tasks = random_stream(side, seed, 24, 6)
            pos = S.positions(tasks)
            w = window(side, 8)
            w.submit_all(tasks)
            order = []
            while not w.drained():
                ready = w.ready_tasks()
                for t in ready:
                    w.mark_executing(t)
                if many:
                    w.retire_many(ready)
                else:
                    for t in ready:
                        w.retire(t)
                order.append([pos[t.tid] for t in ready])
            return order

        for seed in range(3):
            waves = both(lambda side: run(side, seed, True))
            assert waves == both(lambda side: run(side, seed, False))

    def test_retire_many_validates_states(self):
        def run(side):
            a, b, c = bufs(side, 3)
            w = window(side, 4)
            t1 = make_task(side, [a], [b])
            t2 = make_task(side, [a], [c])
            w.submit_all([t1, t2])
            w.mark_executing(t1)
            return error_of(lambda: w.retire_many([t1, t2]))  # t2 not EXECUTING

        assert both(run)[0] == "RuntimeError"

    def test_ready_tasks_oldest_first_after_partial_retire(self):
        def run(side):
            a, b, c, d, e = bufs(side, 5)
            w = window(side, 8)
            ts = [make_task(side, [a], [b]), make_task(side, [b], [c]),  # t2 waits on t1
                  make_task(side, [d], [e])]  # t3 independent
            pos = S.positions(ts)
            w.submit_all(ts)
            first = [pos[t.tid] for t in w.ready_tasks()]
            w.mark_executing(ts[0])
            w.retire(ts[0])
            return first, [pos[t.tid] for t in w.ready_tasks()]

        assert both(run) == ([0, 2], [1, 2])


class TestReadyOrdering:
    @given(st.integers(0, 10_000), st.integers(1, 9))
    @settings(max_examples=25, deadline=None)
    def test_property_ready_always_program_order(self, seed, size):
        def run(side):
            tasks = random_stream(side, seed, 30, 4)
            pos = S.positions(tasks)
            w = window(side, size)
            w.submit_all(tasks)
            rng = random.Random(seed)
            trace = []
            while not w.drained():
                ready = w.ready_tasks()
                assert ready, "stall"
                positions = [pos[t.tid] for t in ready]
                assert positions == sorted(positions), "ready not oldest-first"
                assert w._ready == sorted(w._ready)
                # retire a RANDOM ready task so wakes land mid-index
                t = ready[rng.randrange(len(ready))]
                w.mark_executing(t)
                w.retire(t)
                trace.append((positions, pos[t.tid]))
            return trace

        both(run)

    def test_wake_bisects_into_place_between_ready_peers(self):
        def run(side):
            a, b, c, d, e, f, g = bufs(side, 7)
            w = window(side, 8)
            ts = [make_task(side, [a], [b]), make_task(side, [b], [c]),
                  make_task(side, [d], [e]), make_task(side, [f], [g])]
            pos = S.positions(ts)
            w.submit_all(ts)
            w.mark_executing(ts[2])  # launch the middle READY task first
            w.mark_executing(ts[0])
            w.retire(ts[0])  # wakes t2
            return [pos[t.tid] for t in w.ready_tasks()]

        assert both(run) == [1, 3]


class TestPriorityOrdering:
    def test_urgent_fresh_insert_jumps_ahead_of_background_ready(self):
        def run(side):
            bs = bufs(side, 8)
            w = window(side, 8)
            low = [make_task(side, [bs[2 * i]], [bs[2 * i + 1]], priority=2) for i in range(3)]
            w.submit_all(low)
            urgent = make_task(side, [bs[6]], [bs[7]], priority=0)
            w.submit(urgent)  # arrives LAST, must list FIRST
            pos = S.positions(low + [urgent])
            assert w._ready == sorted(w._ready)
            return [pos[t.tid] for t in w.ready_tasks()]

        assert both(run) == [3, 0, 1, 2]

    def test_program_order_preserved_within_a_bucket(self):
        def run(side):
            bs = bufs(side, 12)
            w = window(side, 16)
            tasks = [make_task(side, [bs[2 * i]], [bs[2 * i + 1]], priority=(0 if i % 2 else 2))
                     for i in range(6)]
            w.submit_all(tasks)
            pos = S.positions(tasks)
            return [pos[t.tid] for t in w.ready_tasks()]

        assert both(run) == [1, 3, 5, 0, 2, 4]

    def test_woken_dependent_bisects_into_its_bucket(self):
        def run(side):
            a, b, c, d, e, f, g = bufs(side, 7)
            w = window(side, 8)
            ts = [make_task(side, [a], [b], priority=2),
                  make_task(side, [b], [c], priority=0),  # urgent, waits on t1
                  make_task(side, [d], [e], priority=0),  # urgent, READY
                  make_task(side, [f], [g], priority=2)]  # background, READY
            pos = S.positions(ts)
            w.submit_all(ts)
            first = [pos[t.tid] for t in w.ready_tasks()]
            w.mark_executing(ts[0])
            w.retire(ts[0])
            assert w._ready == sorted(w._ready)
            return first, [pos[t.tid] for t in w.ready_tasks()]

        assert both(run) == ([2, 0, 3], [1, 2, 3])

    def test_priority_never_reorders_dependent_chain(self):
        def run(side):
            a, b, c = bufs(side, 3)
            w = window(side, 4)
            ts = [make_task(side, [a], [b], priority=2),
                  make_task(side, [b], [c], priority=0)]  # reads lo's write
            w.submit_all(ts)
            pos = S.positions(ts)
            return [pos[t.tid] for t in w.ready_tasks()]

        assert both(run) == [0]

    @given(st.integers(0, 10_000), st.integers(1, 9))
    @settings(max_examples=25, deadline=None)
    def test_property_bucket_order_and_in_bucket_program_order(self, seed, size):
        def run(side):
            rng = np.random.RandomState(seed)
            tasks = random_stream(side, seed, 30, 4)
            for t in tasks:
                t.priority = int(rng.randint(0, 3))
            pos = S.positions(tasks)
            prio = {t.tid: t.priority for t in tasks}
            w = window(side, size)
            w.submit_all(tasks)
            pyr = random.Random(seed)
            trace = []
            while not w.drained():
                ready = w.ready_tasks()
                assert ready, "stall"
                keys = [(prio[t.tid], pos[t.tid]) for t in ready]
                assert keys == sorted(keys), "ready not bucket-then-program order"
                assert w._ready == sorted(w._ready)
                t = ready[pyr.randrange(len(ready))]
                w.mark_executing(t)
                w.retire(t)
                trace.append(keys)
            return trace

        both(run)

    @given(st.integers(0, 10_000))
    @settings(max_examples=25, deadline=None)
    def test_property_single_class_index_identical_to_seq_order(self, seed):
        def run(side):
            tasks = random_stream(side, seed, 24, 4)
            pos = S.positions(tasks)
            w = window(side, 6)
            w.submit_all(tasks)
            trace = []
            while not w.drained():
                positions = [pos[t.tid] for t in w.ready_tasks()]
                assert positions == sorted(positions)
                t = w.ready_tasks()[0]
                w.mark_executing(t)
                w.retire(t)
                trace.append(positions)
            return trace

        both(run)

