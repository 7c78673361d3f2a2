"""The reference's stateful session fuzz (``tests/test_session_fuzz.py``)
held against the port on the CPU: the same seeded scripts of ``submit`` /
``poll`` / ``drive`` / ``flush`` / ``close`` go to a port session and a
reference session of every kind in ``SESSION_NAMES`` (``"mesh"``
included) plus the device session's ``"loop"`` plan mode, and

* the port's final buffers equal the port's ``run_serial`` over exactly
  the submitted prefix, bit for bit;
* every step gives both packages the same outcome: the backlog depth a
  submit returns (for the kinds whose schedule does not depend on
  timing), the outstanding count after a flush, and every error (submit
  or close after close, double close);
* the window invariants hold on the port at every step (an open session
  is never drained; backlog, idle and outstanding agree; a closed session
  is drained and refuses input);
* the retire order (``report.waves``, by stream position) equals the
  reference's for the kinds whose schedule does not depend on timing
  (serial, wave, device, device_loop, mesh); the threaded and frontier
  kinds are compared by counts.

The reference's buffers are never the golden. Scripts come from
``tests/_prophelper.py`` (hypothesis when installed), identical per test
name for both packages."""

import numpy as np
import pytest
from _prophelper import given, settings, st

import _torch_streams as S

D = 4
N_TASKS = 24
N_BUFFERS = 5
SUBMIT, POLL, DRIVE, FLUSH, CLOSE = range(5)
ACTION_WEIGHTS = (SUBMIT, SUBMIT, SUBMIT, POLL, DRIVE, FLUSH, CLOSE)
FUZZ_KINDS = tuple(S.T.SESSION_NAMES) + ("device_loop",)
TIMED = ("threaded", "frontier")  # schedules that depend on timing


def _make(side, kind, window_size=4):
    pkg = S.PKG[side]
    kw = {} if side == "ref" else {"device": "cpu"}
    if kind == "device_loop":
        if side == "ref":
            return pkg.DeviceSession(window_size=window_size, plan_mode="loop",
                                     loop_pallas=False)
        return pkg.make_session("device", window_size=window_size, plan_mode="loop", **kw)
    if kind == "mesh" and side == "ref":
        from repro.core.mesh_session import MeshDeviceSession

        return MeshDeviceSession(window_size=window_size, loop_pallas=False)
    return pkg.make_session(kind, window_size=window_size, **kw)


def build_stream(side, seed):
    pkg, br = S.PKG[side], S.BRANCHES[side]
    rng = np.random.RandomState(seed)
    pool = S.pool(side)
    bufs = [pool.alloc((D,), np.float32, value=S.value(side, rng.randn(D).astype(np.float32)))
            for _ in range(N_BUFFERS)]
    tasks = []
    for _ in range(N_TASKS):
        op = ("axpy", "mul")[rng.randint(2)]
        ins = (bufs[rng.randint(N_BUFFERS)], bufs[rng.randint(N_BUFFERS)])
        outs = (bufs[rng.randint(N_BUFFERS)],)
        r, w = S.DEFAULT_SEGMENTS[side](ins, outs)
        tasks.append(pkg.Task(opcode=op, fn=br[op], inputs=ins, outputs=outs,
                              read_segments=r, write_segments=w))
    return bufs, tasks


def _raises(call):
    try:
        call()
    except RuntimeError:
        return "RuntimeError"
    return None


def _check_open_invariants(session):
    with session._lock:
        assert not session.window.drained()
        backlog = session.window.backlog()
        assert backlog == session.backlog()
        assert session.window.idle() == (backlog == 0)
        assert session.outstanding == backlog


def _run_script(side, kind, seed, script):
    """Run one script as the reference's test does; returns (bufs, tasks, report,
    per-step outcomes, submitted prefix length)."""
    bufs, tasks = build_stream(side, seed)
    session = _make(side, kind)
    cursor = 0
    report = None
    steps = []
    for code, arg in script:
        action = ACTION_WEIGHTS[code]
        if session.closed:
            if action is SUBMIT and cursor < len(tasks):
                steps.append(("submit-closed", _raises(lambda: session.submit(tasks[cursor]))))
            elif action is CLOSE:
                steps.append(("close-closed", _raises(session.close)))
            elif action is POLL:
                session.poll()
                steps.append(("poll-closed", len(session.poll())))
            elif action is FLUSH:
                session.flush()
            continue
        if action is SUBMIT:
            chunk = tasks[cursor: cursor + arg]
            if not chunk:
                continue
            depth = session.submit(chunk)
            cursor += len(chunk)
            assert depth >= 1
            steps.append(("submit", len(chunk), None if kind in TIMED else depth))
        elif action is POLL:
            session.poll()
        elif action is DRIVE:
            session.drive()
        elif action is FLUSH:
            session.flush()
            with session._lock:
                steps.append(("flush", session.outstanding, session.window.idle()))
        else:
            report = session.close()
            steps.append(("close",))
        if not session.closed and side == "port":
            _check_open_invariants(session)
    if not session.closed:
        report = session.close()
    assert session.window.drained() and session.outstanding == 0
    steps.append(("re-close", _raises(session.close)))
    assert report.window_stats["retired"] == cursor
    assert sum(len(w) for w in report.waves) == cursor
    return bufs, tasks, report, steps, cursor


def _compare(kind, seed, script):
    pbufs, ptasks, prep, psteps, cursor = _run_script("port", kind, seed, script)
    _, rtasks, rrep, rsteps, rcursor = _run_script("ref", kind, seed, script)
    assert (psteps, cursor) == (rsteps, rcursor)
    if kind not in TIMED:
        ppos, rpos = S.positions(ptasks), S.positions(rtasks)
        assert [[ppos[t] for t in w] for w in prep.waves] == \
            [[rpos[t] for t in w] for w in rrep.waves]
    assert prep.window_stats["retired"] == rrep.window_stats["retired"] == cursor
    sbufs, stasks = build_stream("port", seed)
    S.run_serial("port", stasks[:cursor])
    np.testing.assert_array_equal(S.snapshot(pbufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))


class TestSessionFuzz:
    @pytest.mark.parametrize("kind", FUZZ_KINDS)
    def test_random_interleavings(self, kind):
        @given(st.integers(0, 10_000),
               st.lists(st.tuples(st.integers(0, len(ACTION_WEIGHTS) - 1),
                                  st.integers(1, 5)),
                        min_size=1, max_size=30))
        @settings(max_examples=8, deadline=None)
        def prop(seed, script):
            _compare(kind, seed, script)

        prop()

    @pytest.mark.parametrize("kind", FUZZ_KINDS)
    def test_callbacks_fire_once_under_interleaving(self, kind):
        got = {}
        for side in S.SIDES:
            _, tasks = build_stream(side, 3)
            for t in tasks:
                t.stream_tag = "fuzz"
            session = _make(side, kind)
            seen = []
            i = 0
            rng = np.random.RandomState(11)
            while i < len(tasks):
                k = 1 + rng.randint(4)
                session.submit(tasks[i: i + k], on_retire=lambda t: seen.append(t.tid))
                i += k
                if rng.rand() < 0.5:
                    session.poll()
            session.close()
            pos = S.positions(tasks)
            order = [pos[t] for t in seen]
            got[side] = (sorted(order) if kind in TIMED else order, session.retired_by_tag)
        assert got["port"] == got["ref"]
        assert sorted(got["port"][0]) == list(range(N_TASKS))
        assert got["port"][1] == {"fuzz": N_TASKS}
