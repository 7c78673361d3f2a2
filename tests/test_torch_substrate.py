"""The port's data model against the reference: the same launches give the
same segments, the same tid order and the same ``Task.signature`` (dtype
normalised, ``kernel_uid`` excluded); row-view writes never mutate a
tensor a reader holds; ``BufferPool.from_numpy`` carries a reference
pool's state across."""

import numpy as np
import pytest
import torch

import _torch_streams as S


def _mk(side, scenario):
    """Launch one small scenario's kernels in ``side``'s package."""
    pkg = S.PKG[side]
    pool = S.pool(side)
    rng = np.random.RandomState(0)
    a = pool.alloc((8, 4), np.float32, name="a",
                   value=S.value(side, rng.randn(8, 4).astype(np.float32)))
    b = pool.alloc((8, 4), np.float32, name="b",
                   value=S.value(side, rng.randn(8, 4).astype(np.float32)))
    c = pool.alloc((4,), np.int32, name="c", value=S.value(side, np.arange(4, dtype=np.int32)))
    stream = pkg.TaskStream()
    add = pkg.AcsKernel(name="add", fn=lambda x, y: x + y)
    scale = pkg.AcsKernel(name="scale", fn=lambda x, k: x * k)
    if scenario == "full":
        add.launch(stream, (a, b), (b,))
        add.launch(stream, (b, b), (a,))
    elif scenario == "row_views":
        for r in range(4):
            add.launch(stream, (a.row_view(r, 1), b.row_view(r + 4, 1)), (a.row_view(r + 4, 1),))
    elif scenario == "static_args":
        scale.launch(stream, (a,), (a,), static_args=(2.0,))
        scale.launch(stream, (c,), (c,), static_args=(3,))
    elif scenario == "conservative":
        pkg.AcsKernel(name="opaque", fn=lambda x: x, conservative=True).launch(
            stream, (a,), (b,))
    elif scenario == "get_addresses":
        def halves(ins, outs):
            seg = pkg.Segment
            return ([seg(ins[0].segment.start, ins[0].segment.size // 2)],
                    [seg(outs[0].segment.start + 16, 16)])
        pkg.AcsKernel(name="half", fn=lambda x: x, get_addresses=halves).launch(
            stream, (a,), (b,))
    return stream.tasks


def _spans(segments):
    return [(s.start, s.size) for s in segments]


def _strip_uid(sig):
    return (sig[0],) + tuple(sig[2:])


@pytest.mark.parametrize("scenario", ["full", "row_views", "static_args",
                                      "conservative", "get_addresses"])
def test_launches_match_reference(scenario):
    ref, port = _mk("ref", scenario), _mk("port", scenario)
    assert len(ref) == len(port) > 0
    # tids grow in launch order in both packages
    assert [t.tid for t in port] == sorted(t.tid for t in port)
    for r, p in zip(ref, port):
        assert r.opcode == p.opcode
        assert _strip_uid(r.signature) == _strip_uid(p.signature)
        for kind in ("read_segments", "write_segments"):
            np.testing.assert_array_equal(getattr(r, kind).starts, getattr(p, kind).starts)
            np.testing.assert_array_equal(getattr(r, kind).ends, getattr(p, kind).ends)
        assert r.cost_flops == p.cost_flops and r.cost_bytes == p.cost_bytes


def test_sim_stream_launches_match_reference():
    (_, ref), (_, port) = S.sim("ref"), S.sim("port")
    assert [t.opcode for t in ref] == [t.opcode for t in port]
    for r, p in zip(ref, port):
        assert _strip_uid(r.signature) == _strip_uid(p.signature)
        for kind in ("read_segments", "write_segments"):
            assert _spans(getattr(r, kind)) == _spans(getattr(p, kind))


def test_row_view_write_never_mutates_a_held_tensor():
    pool = S.pool("port")
    buf = pool.alloc((4, 3), np.float32, name="x", value=np.zeros((4, 3), np.float32))
    held = buf.value
    view = buf.row_view(1, 2)
    held_rows = view.get_value()
    view.set_value(torch.ones(2, 3))
    assert float(held.abs().sum()) == 0.0
    assert float(held_rows.abs().sum()) == 0.0
    assert buf.value is not held
    np.testing.assert_array_equal(buf.value.numpy()[1:3], np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(buf.value.numpy()[[0, 3]], np.zeros((2, 3), np.float32))


def test_from_numpy_carries_reference_pool_state():
    eng = S.sim_engine("ref")
    arrays = {b.name: np.asarray(b.value) for b in eng.buffers()}
    port_pool = S.T.BufferPool.from_numpy(arrays, device="cpu")
    for rb, pb in zip(eng.buffers(), port_pool.buffers()):
        assert (rb.name, rb.shape, rb.dtype) == (pb.name, pb.shape, pb.dtype)
        assert _spans([rb.segment]) == _spans([pb.segment])
        np.testing.assert_array_equal(np.asarray(rb.value), pb.value.numpy())
