"""The reference's threaded-scheduler stress (``tests/test_threaded_stress.py``)
held against the port on the CPU: 8, 12 and 16 scheduler threads race
over dense 80-200-task streams with shared read/write buffers. Both
packages see the same streams: their all-pairs dependency edges and window
upstream sets are equal, the port's threaded run drains every task, its
retire order respects every edge, and its buffers equal the port's
``run_serial`` bit for bit (the order of the threads varies from run to
run; the result must not). The ``cuda`` case of ``tests/test_torch_cuda.py``
runs the same shape on real CUDA streams."""

import sys

import numpy as np
import pytest

import _torch_streams as S

D = 4


def _axpy(x, y):
    return 1.5 * x + y + 1.0


def _mul(x, y):
    return x * y - 0.5


OPS = {"axpy": _axpy, "mul": _mul}


def build_stream(side, seed, n_tasks, n_buffers):
    rng = np.random.RandomState(seed)
    pool = S.pool(side)
    buffers = [pool.alloc((D,), np.float32, value=S.value(side, rng.randn(D).astype(np.float32)))
               for _ in range(n_buffers)]
    tasks = []
    for _ in range(n_tasks):
        op = ("axpy", "mul")[rng.randint(2)]
        i0, i1, o = rng.randint(n_buffers), rng.randint(n_buffers), rng.randint(n_buffers)
        ins, outs = (buffers[i0], buffers[i1]), (buffers[o],)
        r, w = S.DEFAULT_SEGMENTS[side](ins, outs)
        tasks.append(S.PKG[side].Task(opcode=op, fn=OPS[op], inputs=ins, outputs=outs,
                                      read_segments=r, write_segments=w))
    return buffers, tasks


def _edges(side, tasks):
    pos = S.positions(tasks)
    edges, checks = S.PKG[side].build_full_dag(tasks)
    return {pos[k]: sorted(pos[u] for u in v) for k, v in edges.items()}, checks


def _upstreams(side, tasks, size):
    window = S.PKG[side].SchedulingWindow(size)
    pos = S.positions(tasks)
    window.submit_all(tasks)
    ups = {}
    while not window.drained():
        for tid, slot in window.slots.items():
            ups.setdefault(pos[tid], sorted(pos[u] for u in slot.upstream))
        ready = window.ready_tasks()
        for t in ready:
            window.mark_executing(t)
        window.retire_many(ready)
    return ups


def _stress(seed, n_tasks, n_buffers, window_size, num_streams):
    structure = {}
    for side in S.SIDES:
        _, tasks = build_stream(side, seed, n_tasks, n_buffers)
        structure[side] = (_edges(side, tasks), _upstreams(side, tasks, window_size))
    assert structure["port"] == structure["ref"]
    (edges, _), _ = structure["port"]

    sbufs, stasks = build_stream("port", seed, n_tasks, n_buffers)
    S.run_serial("port", stasks)
    bufs, tasks = build_stream("port", seed, n_tasks, n_buffers)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more thread switches: lost updates would show
    try:
        report = S.T.ThreadedStreamScheduler(window_size=window_size, num_streams=num_streams,
                                              device="cpu").run(tasks)
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))
    assert report.exec_stats["tasks_run"] == n_tasks
    assert report.window_stats["retired"] == n_tasks
    pos = S.positions(tasks)
    order = [pos[t] for wave in report.waves for t in wave]
    assert sorted(order) == list(range(n_tasks))
    when = {p: i for i, p in enumerate(order)}
    for task, ups in edges.items():
        assert all(when[u] < when[task] for u in ups), (task, ups)


class TestThreadedStress:
    @pytest.mark.parametrize("num_streams", [8, 12])
    def test_large_stream_drains_and_matches_serial(self, num_streams):
        _stress(42, 200, 10, 32, num_streams)

    def test_more_streams_than_parallelism(self):
        """16 threads over a 3-buffer stream (nearly total order)."""
        _stress(7, 120, 3, 16, 16)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_repeated_runs_stable(self, seed):
        _stress(seed, 80, 6, 32, 8)
