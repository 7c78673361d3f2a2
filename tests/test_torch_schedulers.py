"""The port's ACS-SW and ACS-HW policies on the CPU: every ported policy
leaves exactly the buffers the port's ``run_serial`` leaves, agrees with
the reference's ``run_serial`` to float32 rounding, and the wave-synchronous
policies schedule the same waves as the reference's."""

import numpy as np
import pytest
import torch

import _torch_streams as S

WINDOW = 16
STREAMS = ("sim", "mixed_tag")
# The reference's XLA kernels may fuse or contract (FMA) where eager
# PyTorch rounds op by op; the physics step's norms and divisions then
# differ in the last bits.
RTOL, ATOL = 1e-5, 1e-6


def _run(side, policy, stream):
    bufs, tasks = S.STREAMS[stream](side)
    if side == "ref":
        report = S.R.make_scheduler(policy, window_size=WINDOW)(tasks)
    else:
        report = S.T.make_scheduler(policy, window_size=WINDOW, device="cpu")(tasks)
    return S.snapshot(bufs), report, S.positions(tasks)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("policy", S.T.SCHEDULER_NAMES)
def test_policy_matches_serial(policy, stream):
    got, report, _ = _run("port", policy, stream)
    bufs, tasks = S.STREAMS[stream]("port")
    S.run_serial("port", tasks)
    np.testing.assert_array_equal(got.view(np.int32), S.snapshot(bufs).view(np.int32))
    assert report.exec_stats["tasks_run"] == len(tasks)
    assert report.window_stats["retired"] == len(tasks)

    rbufs, rtasks = S.STREAMS[stream]("ref")
    S.run_serial("ref", rtasks)
    np.testing.assert_allclose(got, S.snapshot(rbufs), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("policy", ["serial", "wave"])
def test_wave_trace_matches_reference(policy, stream):
    _, rrep, rpos = _run("ref", policy, stream)
    _, prep, ppos = _run("port", policy, stream)
    assert [[rpos[t] for t in w] for w in rrep.waves] == \
        [[ppos[t] for t in w] for w in prep.waves]
    assert rrep.window_stats == prep.window_stats


@pytest.mark.parametrize("stream", ["sim", "chain"])
def test_wave_executor_runs_one_call_per_signature_group(stream):
    """The wave policy batches each wave's signature groups (vmap), and the
    batched result is bit-equal to serial (``test_policy_matches_serial``
    covers the sim stream; this covers the chain universe too)."""
    bufs, tasks = S.STREAMS[stream]("port")
    by_tid = {t.tid: t for t in tasks}
    report = S.T.make_scheduler("wave", window_size=WINDOW, device="cpu")(tasks)
    groups = sum(len({by_tid[t].signature for t in w}) for w in report.waves)
    assert report.exec_stats["dispatches"] == groups < len(tasks)

    sbufs, stasks = S.STREAMS[stream]("port")
    S.run_serial("port", stasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))


def test_unknown_names_fail_with_choices():
    with pytest.raises(ValueError, match="frontier"):
        S.T.make_scheduler("mesh", device="cpu")
    with pytest.raises(ValueError, match="loop"):
        S.T.make_scheduler("device", plan_mode="bogus", device="cpu")


def _feed_interleaved(session, tasks, seed=7):
    """Random submit chunks with polls in between (the live-FIFO pattern)."""
    rng = np.random.RandomState(seed)
    i = 0
    while i < len(tasks):
        k = 1 + rng.randint(6)
        session.submit(tasks[i: i + k])
        i += k
        if rng.rand() < 0.6:
            session.poll()
    return session.close()


def _session(side, kind, history_limit):
    pkg = S.PKG[side]
    dev = {} if side == "ref" else {"device": "cpu"}
    if kind == "wave":
        return pkg.WaveSession(window_size=WINDOW, history_limit=history_limit, **dev)
    return pkg.ThreadedSession(window_size=WINDOW, num_streams=4,
                               history_limit=history_limit, **dev)


@pytest.mark.parametrize("history_limit", [None, 4])
@pytest.mark.parametrize("kind", ["wave", "threaded"])
def test_interleaved_session_matches_serial(kind, history_limit):
    bufs, tasks = S.STREAMS["mixed_tag"]("port")
    session = _session("port", kind, history_limit)
    tickets = [session.ticket(t) for t in tasks[:5]]
    seen = []
    session.add_retire_listener(lambda t: seen.append(t.tid))
    report = _feed_interleaved(session, tasks)
    assert all(tk.done() for tk in tickets)
    assert sorted(seen) == sorted(t.tid for t in tasks)
    assert sum(session.retired_by_tag.values()) == len(tasks)
    assert report.window_stats["retired"] == len(tasks)
    # A callback on a long-retired task fires at once, bounded history or not.
    late = []
    session.on_task_retired(tasks[0], late.append)
    assert late == [tasks[0]]

    sbufs, stasks = S.STREAMS["mixed_tag"]("port")
    S.run_serial("port", stasks)
    np.testing.assert_array_equal(S.snapshot(bufs).view(np.int32),
                                  S.snapshot(sbufs).view(np.int32))
    if kind == "wave":
        rbufs, rtasks = S.STREAMS["mixed_tag"]("ref")
        rrep = _feed_interleaved(_session("ref", kind, history_limit), rtasks)
        rpos, ppos = S.positions(rtasks), S.positions(tasks)
        assert [[rpos[t] for t in w] for w in rrep.waves] == \
            [[ppos[t] for t in w] for w in report.waves]


def test_sink_stream_feeds_a_live_session():
    session = _session("port", "wave", None)
    pool = S.pool("port")
    a = pool.alloc((4,), np.float32, value=np.ones(4, np.float32))
    stream = S.T.TaskStream(sink=session, tag="live", record=False)
    kern = S.T.AcsKernel(name="axpy", fn=S.T_BRANCHES["axpy"])
    for _ in range(3):
        kern.launch(stream, (a, a), (a,))
    assert len(stream) == 0 and session.backlog() == 3
    session.close()
    assert session.retired_by_tag == {"live": 3}
    want = np.ones(4, np.float32)
    for _ in range(3):
        want = 1.5 * want + want + 1.0
    np.testing.assert_array_equal(a.value.numpy(), want)


@pytest.mark.parametrize("stream", ["sim", "mixed_tag", "chain"])
def test_contraction_op_keeps_elementwise_streams_fused(stream):
    """The physics kernels (3-vector norms and sums) and ``LOOP_BRANCHES``
    (elementwise) run no contraction: their wave groups stay one call on
    the card too."""
    from repro_torch.core.executors import contraction_op

    _, tasks = S.STREAMS[stream]("port")
    assert {t.opcode: contraction_op(t) for t in tasks} == {t.opcode: None for t in tasks}


def _one_task(fn, *shapes):
    pool = S.pool("port")
    ins = tuple(pool.alloc(s, np.float32, value=np.ones(s, np.float32)) for s in shapes)
    out = pool.alloc(shapes[0][:1], np.float32, value=np.zeros(shapes[0][:1], np.float32))
    r, w = S.t_default_segments(ins, (out,))
    return S.T.Task(opcode="probe", fn=fn, inputs=ins, outputs=(out,), read_segments=r,
                    write_segments=w)


@pytest.mark.parametrize("fn, shapes, want", [
    (lambda a, b: (a @ b)[:, 0], [(8, 16), (16, 4)], "mm"),
    (lambda a, b: torch.einsum("ik,kj->ij", a, b)[:, 0], [(8, 16), (16, 4)], "bmm"),
    (lambda a: torch.nn.functional.linear(a, a)[:, 0], [(8, 16)], "mm"),
    (lambda a: a.sum(-1), [(8, 33)], "sum"),
    (lambda a: a.sum(-1), [(8, 32)], None),
    (lambda a: torch.softmax(a, -1)[:, 0], [(8, 64)], "_softmax"),
    (lambda a: torch.linalg.vector_norm(a, dim=-1), [(8, 3)], None),
    (lambda a: (a * 2 + 1).amax(-1), [(8, 100)], None),
])
def test_contraction_op_finds_order_sensitive_ops(fn, shapes, want):
    from repro_torch.core.executors import contraction_op

    assert contraction_op(_one_task(fn, *shapes)) == want


def test_contraction_op_counts_a_fn_meta_cannot_run():
    from repro_torch.core.executors import contraction_op

    got = contraction_op(_one_task(lambda a: a * float(a[0, 0]), (8, 4)))
    assert got is not None and got.startswith("unknown")
