"""The port's persistent ``DeviceSession`` on the CPU (after the device legs
of ``tests/test_session.py``): all three plan modes on interleaved feeds
bit-equal to the port's ``run_serial``, and the session's counters equal
to the reference's on the same feed (epochs, dispatches, host-path tasks,
plan-cache hits and misses, host syncs d2h/h2d and per tag); the in-epoch
host path for opaque operands; retirement observers that see fresh
values; plan-cache hits on a recurring stream, LRU eviction and
invalidation after compaction; row recycling through ``release_buffer``;
and ``launch``/``poll_inflight`` retiring in FIFO order without blocking.

The reference's interleaved device legs drift from its own ``run_serial``
by rounding (ROADMAP queue 3), so values are compared with it only within
a tolerance, never as a golden."""

import numpy as np
import pytest
import torch

import _torch_streams as S

RTOL = ATOL = 1e-6
MODES = ("wave", "frontier", "loop")
WINDOW = 8
COUNTERS = ("epochs", "device_dispatches", "loop_dispatches", "host_task_dispatches",
            "plan_cache_hits", "plan_cache_misses", "plan_cache_entries", "host_syncs",
            "host_syncs_d2h", "host_syncs_h2d", "host_syncs_by_tag", "arena_live_rows",
            "n_classes", "dep_checks")
BUILD = {**S.STREAMS, "mixed_tag8": lambda side: S.mixed_tag(side, d=8)}


def _registry(side, tasks):
    reg = S.PKG[side].DeviceOpRegistry(strict=False)
    S.REGISTER[side](reg)
    branch_fns = set(S.BRANCHES[side].values())
    for t in tasks:
        if t.fn in branch_fns:
            reg.register_switch_branch(t.opcode, t.fn)
    return reg


def _session(side, mode, tasks=(), **kw):
    if side == "ref":
        return S.R.DeviceSession(window_size=WINDOW, registry=_registry(side, tasks),
                                 plan_mode=mode, loop_pallas=False, **kw)
    return S.T.DeviceSession(window_size=WINDOW, registry=_registry(side, tasks),
                             plan_mode=mode, device="cpu", **kw)


def _feed(session, tasks, seed=7, poll_prob=0.6):
    """Random submit chunks with polls in between (the live-FIFO pattern)."""
    rng = np.random.RandomState(seed)
    i = 0
    while i < len(tasks):
        k = 1 + rng.randint(6)
        session.submit(tasks[i: i + k])
        i += k
        if rng.rand() < poll_prob:
            session.poll()
    return session.close()


def _serial_snapshot(stream):
    bufs, tasks = BUILD[stream]("port")
    S.run_serial("port", tasks)
    return S.snapshot(bufs)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("stream", ["mixed_tag", "mixed_tag8", "chain", "sim"])
def test_interleaved_feed_matches_serial_and_reference_counters(stream, mode):
    bufs, tasks = BUILD[stream]("port")
    session = _session("port", mode, tasks, wave_kernel=True, loop_kernel=True)
    tickets = [session.ticket(t) for t in tasks[:3]]
    report = _feed(session, tasks)
    assert all(tk.done() for tk in tickets)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot(stream).view(np.int32))
    assert report.window_stats["retired"] == len(tasks)

    rbufs, rtasks = BUILD[stream]("ref")
    rsession = _session("ref", mode, rtasks)
    [rsession.ticket(t) for t in rtasks[:3]]
    rreport = _feed(rsession, rtasks)
    np.testing.assert_allclose(S.snapshot(bufs), S.snapshot(rbufs), rtol=RTOL, atol=ATOL)
    ps, rs = report.session_stats, rreport.session_stats
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    rpos, ppos = S.positions(rtasks), S.positions(tasks)
    assert [[rpos[t] for t in w] for w in rreport.waves] == \
        [[ppos[t] for t in w] for w in report.waves]
    assert [e["plan_steps"] for e in rsession.epoch_log] == \
        [e["plan_steps"] for e in session.epoch_log]
    kernel_path = stream in ("mixed_tag8", "chain") and mode != "loop"
    assert (ps["wave_kernel_dispatches"] > 0) == kernel_path
    if kernel_path:
        assert ps["wave_kernel_dispatches"] == ps["device_dispatches"]


@pytest.mark.parametrize("mode", MODES)
def test_make_session_device_is_a_device_session(mode):
    bufs, tasks = BUILD["mixed_tag"]("port")
    session = S.T.make_session("device", window_size=WINDOW, plan_mode=mode, device="cpu")
    assert isinstance(session, S.T.DeviceSession) and session.plan_mode == mode
    _feed(session, tasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot("mixed_tag").view(np.int32))


@pytest.mark.parametrize("name", ["serial", "wave", "threaded"])
def test_make_session_host_policies_match_serial(name):
    bufs, tasks = BUILD["mixed_tag"]("port")
    _feed(S.T.make_session(name, window_size=WINDOW, device="cpu"), tasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot("mixed_tag").view(np.int32))


def test_session_names_and_refusals():
    assert S.T.SESSION_NAMES == S.R.SESSION_NAMES == (
        "serial", "wave", "threaded", "frontier", "device", "mesh")
    assert isinstance(S.T.make_session("mesh", device="cpu"), S.T.MeshDeviceSession)
    with pytest.raises(ValueError, match="device"):
        S.T.make_session("teleport", device="cpu")
    with pytest.raises(ValueError, match="loop"):
        S.T.make_session("device", plan_mode="bogus", device="cpu")
    # The reference's XLA retrace guard: eager PyTorch does not trace.
    with pytest.raises(NotImplementedError, match="does not trace"):
        S.T.DeviceSession(device="cpu", pad_payloads=True)
    with pytest.raises(ValueError, match="CUDA stream"):
        S.T.DeviceSession(device="cpu", stream=object())


def test_runner_session_shares_registry():
    runner = S.T.DeviceWindowRunner(window_size=WINDOW, plan_mode="frontier", device="cpu")
    session = runner.session()
    assert session.registry is runner.registry and session.plan_mode == "frontier"
    bufs, tasks = BUILD["chain"]("port")
    _feed(session, tasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot("chain").view(np.int32))


# -- the in-epoch host path -----------------------------------------------------

def _opaque_stream(side):
    """Array tasks around a task whose buffer holds an opaque value: the
    opaque task reads a device-produced row (a d2h sync) and writes an
    array buffer host-side (an h2d refresh before the next dispatch)."""
    pkg = S.PKG[side]
    p = S.pool(side)
    rng = np.random.RandomState(5)
    a, b, c = (p.alloc((8,), np.float32, value=S.value(side, rng.randn(8).astype(np.float32)))
               for _ in range(3))
    box = p.alloc((1,), np.float32, name="box", value={"scale": 2.0})
    axpy = S.BRANCHES[side]["axpy"]

    def opaque(x, o):
        return [x * o["scale"], {"scale": o["scale"] + 1.0}]

    tasks = []
    for ins, outs, fn, name in (((a, b), (c,), axpy, "axpy"),
                                ((c, box), (b, box), opaque, "opaque"),
                                ((b, a), (a,), axpy, "axpy"),
                                ((a, c), (c,), axpy, "axpy")):
        r, w = S.DEFAULT_SEGMENTS[side](ins, outs)
        tasks.append(pkg.Task(opcode=name, fn=fn, inputs=ins, outputs=outs,
                              read_segments=r, write_segments=w, stream_tag=f"t{len(tasks) % 2}"))
    return [a, b, c], tasks


@pytest.mark.parametrize("mode", MODES)
def test_opaque_operands_take_the_host_path(mode):
    bufs, tasks = _opaque_stream("port")
    session = _session("port", mode)
    for t in tasks:
        session.submit(t)
    report = session.close()
    sbufs, stasks = _opaque_stream("port")
    S.run_serial("port", stasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))
    rbufs, rtasks = _opaque_stream("ref")
    rsession = _session("ref", mode)
    for t in rtasks:
        rsession.submit(t)
    rreport = rsession.close()
    np.testing.assert_allclose(S.snapshot(bufs), S.snapshot(rbufs), rtol=RTOL, atol=ATOL)
    ps, rs = report.session_stats, rreport.session_stats
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert ps["host_task_dispatches"] == 1
    assert ps["host_syncs_d2h"] >= 1 and ps["host_syncs_h2d"] >= 1


# -- retirement observers -------------------------------------------------------

def _one_task():
    pool = S.pool("port")
    x = pool.alloc((8,), np.float32, value=np.ones(8, np.float32))
    y = pool.alloc((8,), np.float32, value=np.zeros(8, np.float32))
    r, w = S.DEFAULT_SEGMENTS["port"]((x, x), (y,))
    return y, S.T.Task(opcode="axpy", fn=S.T_BRANCHES["axpy"], inputs=(x, x), outputs=(y,),
                       read_segments=r, write_segments=w)


@pytest.mark.parametrize("mode", MODES)
def test_observers_see_fresh_values(mode):
    y, task = _one_task()
    s = S.T.make_session("device", window_size=4, plan_mode=mode, device="cpu")
    s.submit(task)
    tk = s.ticket(task)
    s.poll()
    assert tk.done() and torch.equal(y.value, torch.full((8,), 3.5))
    s.close()

    y, task = _one_task()
    s = S.T.make_session("device", window_size=4, plan_mode=mode, device="cpu")
    s.submit(task)
    s.poll()  # unwatched epoch: the sync is deferred
    assert s.session_stats()["host_syncs"] == 0
    seen = []
    s.on_task_retired(task, lambda t: seen.append(y.value.clone()))
    assert len(seen) == 1 and torch.equal(seen[0], torch.full((8,), 3.5))
    assert s.session_stats()["host_syncs"] == 1
    s.close()


def test_unwatched_values_require_sync():
    y, task = _one_task()
    s = S.T.make_session("device", window_size=4, device="cpu")
    s.submit(task)
    s.poll()
    assert torch.equal(y.value, torch.zeros(8))  # the pre-epoch value
    s.sync()
    assert s.session_stats()["host_syncs"] == 1
    assert torch.equal(y.value, torch.full((8,), 3.5))
    s.close()


# -- plan cache, recycling, compaction -------------------------------------------

def _chain_burst(side, session, pool, value):
    """One request-like burst: four fresh buffers, a 2-task chain, flush."""
    bufs = [pool.alloc((8,), np.float32,
                       value=S.value(side, np.full(8, value + i, np.float32)))
            for i in range(4)]
    tasks = []
    for src, dst in ((0, 2), (2, 3)):
        ins, outs = (bufs[src], bufs[1]), (bufs[dst],)
        r, w = S.DEFAULT_SEGMENTS[side](ins, outs)
        tasks.append(S.PKG[side].Task(opcode="axpy", fn=S.BRANCHES[side]["axpy"], inputs=ins,
                                      outputs=outs, read_segments=r, write_segments=w))
    session.submit(tasks)
    session.flush()
    return bufs


@pytest.mark.parametrize("mode", MODES)
def test_release_recycles_rows_and_keeps_the_cache_hot(mode):
    stats = {}
    for side in S.SIDES:
        s = _session(side, mode)
        pool = S.pool(side)
        rows = []
        for phase in range(8):
            for b in _chain_burst(side, s, pool, float(phase)):
                assert s.release_buffer(b)
            rows.append(s.arena.live_rows() + s.arena.free_rows())
        stats[side] = s.session_stats()
        assert rows[-1] == rows[0]  # the slab never grows past the first burst
        s.close()
    assert stats["port"]["arena_recycled_rows"] > 0
    assert stats["port"]["plan_cache_hits"] >= 5
    keys = COUNTERS + ("arena_recycled_rows", "arena_free_rows", "slab_bytes")
    assert {k: stats["port"][k] for k in keys} == {k: stats["ref"][k] for k in keys}


@pytest.mark.parametrize("shape,dtype", [((8,), np.float32), ((3, 5), np.float64),
                                         ((), np.int32)])
def test_arena_row_nbytes_matches_reference(shape, dtype):
    sizes = []
    for side in S.SIDES:
        buf = S.pool(side).alloc(shape, dtype)
        sizes.append(S.PKG[side].SlabArena(pad_multiple=8).row_nbytes(buf))
    assert sizes[0] == sizes[1]


def _arena_lifecycle(side):
    """pack, free, recycle into the packed watermark, grow past capacity,
    refresh a host-changed row, compact: returns the slabs and addresses
    after each stage."""
    rng = np.random.RandomState(11)
    pool = S.pool(side)
    arena = S.PKG[side].SlabArena(pad_multiple=8, compact_waste=0.5, compact_min_rows=4)

    def new_buf(shape):
        return pool.alloc(shape, np.float32,
                          value=S.value(side, rng.randn(*shape).astype(np.float32)))

    bufs = [new_buf((5,)) for _ in range(6)] + [new_buf((2, 3))]
    for b in bufs:
        arena.add(b)
    slabs = arena.pack() if side == "ref" else arena.pack("cpu")
    stages = []

    def snap():
        stages.append(([np.array(x, copy=True) for x in slabs],
                       [arena.addr_of(b) for b in bufs],
                       arena.generation, arena.free_rows(), arena.live_rows()))

    for b in bufs[1:4]:
        arena.free(b)
    fresh = [new_buf((5,)) for _ in range(2)]  # recycled rows below the watermark
    for b in fresh:
        arena.add(b)
    bufs += fresh
    more = [new_buf((5,)) for _ in range(6)]   # past the class's capacity of 8
    for b in more:
        arena.add(b)
    bufs += more
    slabs = arena.pack_incremental(slabs, device=None if side == "ref" else "cpu")
    snap()
    bufs[0].value = S.value(side, np.full(5, 7.0, np.float32))
    slabs = arena.update_rows(slabs, [bufs[0]])
    snap()
    for b in bufs[4:6] + bufs[7:13]:
        assert arena.free(b)
    assert arena.needs_compaction() == [0]
    slabs, moved = arena.compact(slabs)
    snap()
    return stages, moved


def test_arena_persistent_half_matches_reference():
    ref, rmoved = _arena_lifecycle("ref")
    port, pmoved = _arena_lifecycle("port")
    assert rmoved == pmoved
    for (rs, ra, rg, rf, rl), (ps, pa, pg, pf, pl) in zip(ref, port):
        assert (ra, rg, rf, rl) == (pa, pg, pf, pl)
        assert [x.shape for x in rs] == [x.shape for x in ps]
        for r, p in zip(rs, ps):
            np.testing.assert_array_equal(r, p)


def test_recurring_stream_hits_the_plan_cache():
    pool = S.pool("port")
    s = _session("port", "wave")
    bufs = [pool.alloc((8,), np.float32, value=np.full(8, float(i), np.float32))
            for i in range(3)]
    for _ in range(5):
        ins, outs = (bufs[0], bufs[1]), (bufs[2],)
        r, w = S.DEFAULT_SEGMENTS["port"](ins, outs)
        s.submit(S.T.Task(opcode="axpy", fn=S.T_BRANCHES["axpy"], inputs=ins, outputs=outs,
                          read_segments=r, write_segments=w))
        s.poll()
    stats = s.session_stats()
    assert (stats["plan_cache_misses"], stats["plan_cache_hits"]) == (1, 4)
    assert stats["compiled_programs"] == 1
    s.close()


def test_compaction_invalidates_exactly_moved_classes():
    """Two shape classes; compacting one drops only ITS cached plan, the
    other class's entry survives and keeps hitting, and surviving values
    stay bit-exact across the device-side gather."""
    s = S.T.DeviceSession(window_size=8, compact_min_rows=8, compact_waste=0.5, device="cpu")
    pool = S.pool("port")
    a = [pool.alloc((8,), np.float32, value=np.full(8, 1.0 + i, np.float32)) for i in range(8)]
    b = [pool.alloc((2, 8), np.float32, value=np.full((2, 8), 50.0 + i, np.float32))
         for i in range(2)]
    axpy = S.T_BRANCHES["axpy"]

    def task_over(ins, outs):
        r, w = S.DEFAULT_SEGMENTS["port"](ins, outs)
        return S.T.Task(opcode="axpy", fn=axpy, inputs=ins, outputs=outs,
                        read_segments=r, write_segments=w)

    s.submit([task_over((a[i], a[i + 1]), (a[i + 1],)) for i in range(0, 8, 2)])
    s.flush()
    s.submit(task_over((b[0], b[1]), (b[1],)))
    s.flush()
    keys_before = set(s._plan_cache)
    assert len(keys_before) == 2
    for buf in a[2:]:
        assert s.release_buffer(buf)
    s.submit(task_over((b[0], b[1]), (b[1],)))  # same class-B structure
    s.flush()
    stats = s.session_stats()
    assert stats["arena_compactions"] == 1 and stats["arena_generation"] == 1
    assert stats["plan_cache_invalidations"] == 1
    assert len(keys_before & set(s._plan_cache)) == 1 and stats["plan_cache_hits"] >= 1
    s.sync()
    assert torch.equal(a[1].value, axpy(torch.full((8,), 1.0), torch.full((8,), 2.0)))
    want = axpy(torch.full((2, 8), 50.0), axpy(torch.full((2, 8), 50.0), torch.full((2, 8), 51.0)))
    assert torch.equal(b[1].value, want)
    s.close()


def test_plan_cache_lru_cap():
    s = S.T.DeviceSession(window_size=8, plan_cache_limit=2, device="cpu")
    pool = S.pool("port")
    bufs = [pool.alloc((8,), np.float32, value=np.ones(8, np.float32)) for _ in range(6)]
    for i in range(0, 6, 2):
        ins, outs = (bufs[i], bufs[i + 1]), (bufs[i + 1],)
        r, w = S.DEFAULT_SEGMENTS["port"](ins, outs)
        s.submit(S.T.Task(opcode="axpy", fn=S.T_BRANCHES["axpy"], inputs=ins, outputs=outs,
                          read_segments=r, write_segments=w))
        s.poll()
    stats = s.session_stats()
    assert (stats["plan_cache_entries"], stats["plan_cache_evictions"]) == (2, 1)
    s.close()


def test_epoch_log_rotates_under_history_limit():
    s = S.T.DeviceSession(window_size=4, history_limit=3, device="cpu")
    for seed in range(5):
        _, tasks = S.mixed_tag("port", seed=seed, n_tasks=4)
        s.submit(tasks)
        s.poll()
    assert len(s.epoch_log) <= 3 and s.session_stats()["epochs"] == 5
    s.close()


# -- launch / poll_inflight ------------------------------------------------------

class _Event:
    """A stand-in CUDA event: not reached until ``land()``."""

    def __init__(self):
        self.reached = False
        self.waits = 0

    def query(self):
        return self.reached

    def synchronize(self):
        self.waits += 1
        self.reached = True


@pytest.mark.parametrize("mode", MODES)
def test_launch_defers_retirement_and_poll_inflight_is_fifo(monkeypatch, mode):
    bufs, tasks = BUILD["chain"]("port")
    s = _session("port", mode, tasks)
    events = []

    real = type(s)._dispatched

    def dispatched(self, *args):
        real(self, *args)
        events.append(_Event())
        self._last_event = events[-1]

    monkeypatch.setattr(type(s), "_dispatched", dispatched)
    retired = []
    s.add_retire_listener(lambda t: retired.append(t.tid))
    half = len(tasks) // 2
    s.submit(tasks[:half])
    assert s.launch()
    s.submit(tasks[half:])
    assert s.launch()
    assert s.inflight_segments == len(events) == 2 and retired == []
    assert s.poll_inflight() == 0  # nothing landed: returns without blocking
    assert all(e.waits == 0 for e in events)
    events[1].reached = True
    assert s.poll_inflight() == 0  # the newer one landed, but retirement is FIFO
    events[0].reached = True
    assert s.poll_inflight() == len(tasks)
    assert sorted(retired) == sorted(t.tid for t in tasks)
    pos = S.positions(tasks)
    first = [pos[t] for t in retired[:half]]
    assert sorted(first) == list(range(half))  # the first launch retired first
    s.close()
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot("chain").view(np.int32))


def test_poll_inflight_block_waits_for_the_oldest_only():
    bufs, tasks = BUILD["chain"]("port")
    s = _session("port", "wave", tasks)
    ev = [_Event(), _Event()]
    s.submit(tasks[:4])
    s.launch()
    s.submit(tasks[4:])
    s.launch()
    s._inflight = type(s._inflight)((plan, e) for (plan, _), e in zip(s._inflight, ev))
    retired = s.poll_inflight(block=True)
    assert ev[0].waits == 1 and ev[1].waits == 0
    assert retired == 4 and s.inflight_segments == 1
    s.close()  # flush retires the rest
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  _serial_snapshot("chain").view(np.int32))
