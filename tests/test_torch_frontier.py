"""The port's async frontier (``repro_torch.core.frontier``) on the CPU, after
``tests/test_frontier.py``: serial equivalence (bit for bit against the
port's ``run_serial``) over seeds, windows and in-flight caps on random,
physics, mixed-tag and dyn streams; never retiring before an upstream;
launch order; ``max_group`` splits; the ``DispatchQueue``'s dedup,
coalescing and flip; ``GroupTrace`` stamps; ``max_inflight`` validation;
one live session per executor; the blocking fallback; the same launch
groups and retire order as the reference's frontier; and
``SessionServer(scheduler="frontier")`` on reduced recurrentgemma and
granite, its tokens equal to a greedy loop and to the other servers'.

The reference's frontier polls JAX's ``is_ready``, which may say "not yet"
for a while on the CPU, so its schedule depends on timing; the structure
comparison treats every reference launch as landed at its first poll (the
``_is_ready`` fallback the reference uses where arrays cannot be asked),
which is what the port's CPU executor does (a CPU launch has landed when
it returns). Its session outputs are never goldens (ROADMAP queue 3).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from _prophelper import given, settings, st

import _torch_streams as S
import repro.core.executors as R_EXEC
from repro_torch.configs import ARCHS
from repro_torch.core import (AsyncFrontierScheduler, BufferPool, DispatchQueue,
                              FrontierSession, GroupExecutor, Task, TaskStream, build_full_dag,
                              make_scheduler, make_session, run_serial)
from repro_torch.core.task import default_segments
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.runtime import ContinuousBatchingServer, SessionServer

CPU = dict(device="cpu")
D = 4


def _axpy(x, y):
    return 1.5 * x + y + 1.0


def _mul(x, y):
    return x * y - 0.5


def _neg(x, y):
    return -x + 0.25 * y


OPS = {"axpy": _axpy, "mul": _mul, "neg": _neg}


def build_stream(seed: int, n_tasks: int, n_buffers: int):
    """``tests/test_frontier.py``'s random stream, on the port's CPU pool."""
    rng = np.random.RandomState(seed)
    pool = BufferPool(**CPU)
    buffers = [pool.alloc((D,), np.float32, value=rng.randn(D).astype(np.float32))
               for _ in range(n_buffers)]
    tasks = []
    names = list(OPS)
    for _ in range(n_tasks):
        op = names[rng.randint(len(names))]
        ins = (buffers[rng.randint(n_buffers)], buffers[rng.randint(n_buffers)])
        outs = (buffers[rng.randint(n_buffers)],)
        r, w = default_segments(ins, outs)
        tasks.append(Task(opcode=op, fn=OPS[op], inputs=ins, outputs=outs,
                          read_segments=r, write_segments=w))
    return pool, buffers, tasks


def _bits(buffers):
    return np.stack([b.value.numpy() for b in buffers]).view(np.int32)


def _serial_bits(seed, n_tasks, n_buffers):
    _, bufs, tasks = build_stream(seed, n_tasks, n_buffers)
    run_serial(tasks, **CPU)
    return _bits(bufs)


def _frontier(**kw):
    return AsyncFrontierScheduler(**kw, **CPU)


class TestFrontierSerialEquivalence:
    @pytest.mark.parametrize("window", [1, 2, 8, 32])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_serial(self, window, seed):
        _, bufs, tasks = build_stream(seed, 40, 8)
        _frontier(window_size=window).run(tasks)
        np.testing.assert_array_equal(_bits(bufs), _serial_bits(seed, 40, 8))

    @given(st.integers(0, 10_000), st.integers(1, 33), st.integers(1, 8))
    @settings(max_examples=20, deadline=None)
    def test_property_any_seed_window_inflight(self, seed, window, inflight):
        _, bufs, tasks = build_stream(seed, 24, 6)
        _frontier(window_size=window, max_inflight=inflight).run(tasks)
        np.testing.assert_array_equal(_bits(bufs), _serial_bits(seed, 24, 6))

    def test_max_group_cap_still_equivalent(self):
        _, bufs, tasks = build_stream(5, 40, 12)
        report = _frontier(window_size=32, max_group=2).run(tasks)
        np.testing.assert_array_equal(_bits(bufs), _serial_bits(5, 40, 12))
        assert report.exec_stats["max_wave_width"] <= 2

    @pytest.mark.parametrize("inflight", [1, 3, 8])
    @pytest.mark.parametrize("window", [2, 16])
    @pytest.mark.parametrize("stream", ["sim", "mixed_tag", "chain"])
    def test_streams_match_serial(self, stream, window, inflight):
        bufs, tasks = S.STREAMS[stream]("port")
        report = make_scheduler("frontier", window_size=window, max_inflight=inflight,
                                **CPU)(tasks)
        sbufs, stasks = S.STREAMS[stream]("port")
        S.run_serial("port", stasks)
        np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                      S.snapshot(sbufs).view(np.int32))
        assert report.window_stats["retired"] == len(tasks)

    @pytest.mark.parametrize("inflight", [1, 8])
    @pytest.mark.parametrize("window", [4, 32])
    @pytest.mark.parametrize("name", ["instanas", "dynamic_routing", "nasnet"])
    def test_dyn_streams_match_serial(self, name, window, inflight):
        from repro_torch.dyn import WORKLOADS

        init, build, _ = WORKLOADS[name]
        params = init(0, **CPU)
        x = np.random.RandomState(3).randn(1, 3, 32, 32).astype(np.float32)
        outs = []
        for policy in ("serial", "frontier"):
            stream = TaskStream()
            out = build(params, stream, x)
            make_scheduler(policy, window_size=window, max_inflight=inflight,
                           **CPU)(stream.tasks)
            outs.append(out.value)
        assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


class TestFrontierRetirementOrder:
    @given(st.integers(0, 10_000))
    @settings(max_examples=15, deadline=None)
    def test_property_never_retires_before_upstreams(self, seed):
        """A kernel's retire stamp comes after every true upstream's: the
        frontier reorders independent kernels only."""
        _, _, tasks = build_stream(seed, 30, 6)
        edges, _ = build_full_dag(tasks)
        report = _frontier(window_size=16).run(tasks)
        pos = {tid: i for i, tid in enumerate(report.retire_order())}
        assert len(pos) == len(tasks)  # every task retired exactly once
        for t in tasks:
            for up in edges[t.tid]:
                assert pos[up] < pos[t.tid], f"task {t.tid} retired before upstream {up}"

    def test_launch_order_respects_dependencies(self):
        _, _, tasks = build_stream(3, 40, 6)
        edges, _ = build_full_dag(tasks)
        report = _frontier(window_size=32).run(tasks)
        launch_pos = {}
        for i, group in enumerate(report.waves):
            for tid in group:
                launch_pos[tid] = i
        for t in tasks:
            for up in edges[t.tid]:
                assert launch_pos[up] < launch_pos[t.tid]


def _ref_stream(stream, seed):
    if stream == "random":
        import jax.numpy as jnp
        import repro.core as R

        rng = np.random.RandomState(seed)
        pool = R.BufferPool()
        bufs = [pool.alloc((D,), np.float32, value=jnp.asarray(rng.randn(D).astype(np.float32)))
                for _ in range(8)]
        tasks = []
        for _ in range(40):
            op = list(OPS)[rng.randint(3)]
            ins = (bufs[rng.randint(8)], bufs[rng.randint(8)])
            outs = (bufs[rng.randint(8)],)
            r, w = S.DEFAULT_SEGMENTS["ref"](ins, outs)
            tasks.append(R.Task(opcode=op, fn=OPS[op], inputs=ins, outputs=outs,
                                read_segments=r, write_segments=w))
        return tasks
    return S.STREAMS[stream]("ref", seed=seed)[1]


@pytest.mark.parametrize("inflight", [1, 2, 8])
@pytest.mark.parametrize("stream", ["random", "sim", "mixed_tag"])
def test_launch_groups_and_retire_order_match_the_reference(stream, inflight, monkeypatch):
    monkeypatch.setattr(R_EXEC, "_is_ready", lambda arr: True)
    rtasks = _ref_stream(stream, 1)
    ptasks = (build_stream(1, 40, 8)[2] if stream == "random"
              else S.STREAMS[stream]("port", seed=1)[1])
    rrep = S.R.AsyncFrontierScheduler(window_size=8, max_inflight=inflight).run(rtasks)
    prep = _frontier(window_size=8, max_inflight=inflight).run(ptasks)
    rpos, ppos = S.positions(rtasks), S.positions(ptasks)
    assert [[rpos[t] for t in w] for w in rrep.waves] == [[ppos[t] for t in w] for w in prep.waves]
    assert [rpos[t] for t in rrep.retire_order()] == [ppos[t] for t in prep.retire_order()]
    assert [g.blocking for g in rrep.groups] == [g.blocking for g in prep.groups]
    assert rrep.max_inflight_groups() == prep.max_inflight_groups()
    assert rrep.window_stats == prep.window_stats
    assert rrep.exec_stats["dispatches"] == prep.exec_stats["dispatches"]


class TestFrontierAsyncProperties:
    def test_blocking_syncs_fewer_than_dispatches(self):
        _, _, tasks = build_stream(0, 60, 10)
        stats = _frontier(window_size=32).run(tasks).exec_stats
        assert stats["dispatches"] > 0
        assert stats["blocking_syncs"] < stats["dispatches"]

    def test_groups_overlap_on_independent_stream(self):
        """Independent heterogeneous tasks: several groups in flight at once
        (no wave barrier between them)."""
        pool = BufferPool(**CPU)
        tasks = []
        for i in range(12):
            op = list(OPS)[i % 3]
            a = pool.alloc((D,), np.float32, value=np.ones(D, np.float32))
            b = pool.alloc((D,), np.float32, value=np.zeros(D, np.float32))
            r, w = default_segments((a, a), (b,))
            tasks.append(Task(opcode=op, fn=OPS[op], inputs=(a, a), outputs=(b,),
                              read_segments=r, write_segments=w))
        report = _frontier(window_size=32, max_inflight=8).run(tasks)
        assert report.max_inflight_groups() > 1
        assert len(report.groups) == len(report.waves)
        assert report.as_dict()["max_inflight_groups"] == report.max_inflight_groups()

    def test_group_trace_stamps_ordered(self):
        _, _, tasks = build_stream(1, 30, 8)
        report = _frontier(window_size=16).run(tasks)
        for g in report.groups:
            assert 0.0 <= g.t_launch <= g.t_retire
            assert g.as_dict()["tids"] == g.tids
        assert sum(len(g.tids) for g in report.groups) == 30

    def test_executor_reuse_keeps_its_stats(self):
        """A reused executor's stats accumulate across runs; eager PyTorch
        compiles nothing."""
        ex = GroupExecutor(**CPU)
        for seed in (0, 0, 0):
            _, _, tasks = build_stream(seed, 20, 5)
            _frontier(window_size=16, executor=ex).run(tasks)
        assert ex.stats.compiles == 0
        assert ex.stats.tasks_run == 60 and not ex.inflight

    def test_warm_does_no_work(self):
        """``warm`` only classifies: no task runs, no buffer changes."""
        _, bufs, tasks = build_stream(4, 6, 6)
        before = _bits(bufs)
        ex = GroupExecutor(**CPU)
        assert ex.warm(tasks[:1]) is False and ex.warm(tasks[:3]) is False
        assert ex.stats.dispatches == ex.stats.tasks_run == 0 and not ex.inflight
        np.testing.assert_array_equal(_bits(bufs), before)

    def test_invalid_max_inflight(self):
        with pytest.raises(ValueError):
            _frontier(max_inflight=0)
        with pytest.raises(ValueError):
            FrontierSession(max_inflight=0, **CPU)
        with pytest.raises(ValueError):
            make_session("frontier", max_inflight=0, **CPU)

    def test_one_live_session_per_executor(self):
        ex = GroupExecutor(**CPU)
        _, _, tasks = build_stream(2, 4, 4)
        ex.launch(tasks[:1])
        with pytest.raises(RuntimeError, match="in-flight"):
            FrontierSession(executor=ex, **CPU)
        assert ex.poll_landed() and not ex.inflight
        FrontierSession(executor=ex, **CPU).close()

    def test_sync_counts_blocking_syncs(self):
        ex = GroupExecutor(**CPU)
        _, _, tasks = build_stream(2, 4, 4)
        handle = ex.launch(tasks[:1])
        assert handle.event is None and ex.poll(handle)
        ex.sync(handle)
        assert ex.stats.blocking_syncs == 1 and not ex.inflight
        assert ex.sync_oldest() is None

    def test_stalled_pipeline_falls_back_to_a_blocking_sync(self):
        """With no group ever polling complete, ``drive`` and ``close``
        retire the oldest in-flight group by a blocking sync, and the
        result still equals serial."""
        _, bufs, tasks = build_stream(6, 24, 6)
        ex = GroupExecutor(**CPU)
        ex.poll = lambda handle: False
        session = FrontierSession(window_size=8, executor=ex, max_inflight=2, **CPU)
        session.submit(tasks[:5])
        session.poll()
        assert ex.inflight and session.drive()
        session.submit(tasks[5:])
        report = session.close()
        np.testing.assert_array_equal(_bits(bufs), _serial_bits(6, 24, 6))
        assert report.exec_stats["blocking_syncs"] == len(report.groups) > 0
        assert all(g.blocking for g in report.groups)


class TestDispatchQueue:
    def _tasks(self, n):
        pool = BufferPool(**CPU)
        out = []
        for _ in range(n):
            a = pool.alloc((D,), np.float32, value=np.ones(D, np.float32))
            b = pool.alloc((D,), np.float32, value=np.zeros(D, np.float32))
            r, w = default_segments((a, a), (b,))
            out.append(Task(opcode="axpy", fn=_axpy, inputs=(a, a), outputs=(b,),
                            read_segments=r, write_segments=w))
        return out

    def test_stage_dedups_already_queued(self):
        q = DispatchQueue()
        tasks = self._tasks(4)
        assert q.stage(tasks) == 1  # one homogeneous bucket opened
        assert q.stage(tasks) == 0  # all queued already

    def test_stage_coalesces_batchable_siblings(self):
        q = DispatchQueue()
        tasks = self._tasks(6)  # all share one signature
        assert q.stage(tasks[:2]) == 1
        assert q.stage(tasks[2:5]) == 0  # merged into the open bucket
        q.flip(GroupExecutor(**CPU))
        assert len(q.pop()) == 5

    def test_flip_only_when_front_drained(self):
        q = DispatchQueue()
        ex = GroupExecutor(**CPU)
        q.stage(self._tasks(2))
        assert q.flip(ex)
        q.stage(self._tasks(2))
        assert not q.flip(ex)  # front still holds the first group
        assert q.pop() is not None
        assert q.flip(ex)  # now the back buffer promotes
        assert q.pop() is not None
        assert q.pop() is None
        assert q.empty()

    def test_max_group_splits(self):
        q = DispatchQueue(max_group=3)
        assert q.stage(self._tasks(8)) == 1  # one bucket; split at flip
        q.flip(GroupExecutor(**CPU))
        sizes = []
        while (g := q.pop()) is not None:
            sizes.append(len(g))
        assert sizes == [3, 3, 2]


@pytest.mark.parametrize("history_limit", [None, 4])
def test_interleaved_frontier_session_matches_serial(history_limit):
    bufs, tasks = S.STREAMS["mixed_tag"]("port")
    session = make_session("frontier", window_size=16, max_inflight=3,
                           history_limit=history_limit, **CPU)
    tickets = [session.ticket(t) for t in tasks[:5]]
    seen = []
    session.add_retire_listener(lambda t: seen.append(t.tid))
    rng = np.random.RandomState(7)
    i = 0
    while i < len(tasks):
        k = 1 + rng.randint(6)
        session.submit(tasks[i: i + k])
        i += k
        if rng.rand() < 0.6:
            session.poll()
    report = session.close()
    assert all(tk.done() for tk in tickets)
    assert sorted(seen) == sorted(t.tid for t in tasks)
    assert sum(session.retired_by_tag.values()) == len(tasks)
    assert report.window_stats["retired"] == len(tasks)
    late = []
    session.on_task_retired(tasks[0], late.append)
    assert late == [tasks[0]]
    sbufs, stasks = S.STREAMS["mixed_tag"]("port")
    S.run_serial("port", stasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))


# ---------------------------------------------------------------------------
# The frontier server
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(key):
    if key == "granite":  # MoE FFNs
        cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    else:
        cfg = dataclasses.replace(ARCHS["recurrentgemma-2b"].reduced(), n_layers=5)
    return cfg, init_params(cfg, 0, **CPU)


def _greedy(cfg, params, prompt, max_new, max_len):
    cache = init_cache(cfg, 1, max_len, **CPU)
    logits, cache = prefill(params, cfg, torch.tensor(prompt[None], dtype=torch.int32), cache)
    out, pos = [], len(prompt)
    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
    for _ in range(max_new):
        logits, cache = decode_step(params, cfg, tok[:, None], cache, pos)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1).to(torch.int32)
        out.append(int(tok[0]))
        pos += 1
    return out


def _serve(server, prompts, max_new):
    for p in prompts:
        server.submit(p, max_new=max_new)
    done = server.run_until_drained()
    report = server.close() if isinstance(server, SessionServer) else None
    return {tuple(r.prompt): r.generated for r in done}, report


@pytest.mark.parametrize("inflight", [1, 8])
@pytest.mark.parametrize("key", ["recurrentgemma", "granite"])
def test_frontier_server_matches_the_other_servers_and_a_greedy_loop(key, inflight):
    cfg, params = _model(key)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab, 7) for _ in range(5)]
    kw = dict(max_slots=2, max_len=32, **CPU)
    server = SessionServer(cfg, params, scheduler="frontier", max_inflight=inflight, **kw)
    assert isinstance(server.session, FrontierSession)
    assert server.session.queue.max_group == 1 and server.session.max_inflight == inflight
    got, report = _serve(server, prompts, 3)
    assert len(got) == len(prompts) and all(len(t) == 3 for t in got.values())
    for p in prompts:
        assert got[tuple(p)] == _greedy(cfg, params, p, 3, 32)
    for name, other in (("wave", SessionServer(cfg, params, scheduler="wave", **kw)),
                        ("device", SessionServer(cfg, params, scheduler="device", **kw)),
                        ("batch", ContinuousBatchingServer(cfg, params, **kw))):
        assert _serve(other, prompts, 3)[0] == got, name
    assert report.exec_stats["max_wave_width"] == 1  # opaque slot values: one task a group
    assert report.exec_stats["tasks_run"] == len(prompts) * (1 + 3)
    assert report.max_inflight_groups() <= inflight
    assert server.host_reads == 3 * len(prompts)
    assert [b.name for b in server.pool.buffers() if b.name.endswith("_prompt")] == []
