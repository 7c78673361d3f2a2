"""The port's mesh-sharded device window (``MeshDeviceSession``,
``ShardLink``, ``ShardTransferTable``, ``make_window_mesh``) and the mesh
server on the CPU, after ``tests/test_mesh_transfers.py``, the in-process
legs of ``TestMeshMatrix`` (``tests/test_differential_matrix.py``) and the
mesh server's test of ``tests/test_serve.py``:

* at 1, 2 and 4 logical shards, under the ``"loop"`` and ``"wave"`` plan
  modes and every transfer mode, the buffers are bit-equal to the port's
  ``run_serial`` and within a tolerance of the reference's ``run_serial``,
  and the placement, sub-epoch, cross-shard, transfer, dispatch and sync
  counters EQUAL the reference's mesh's on the same feed (its values are
  no golden: its mesh legs drift from its own ``run_serial`` on the CPU,
  ROADMAP queue 3);
* the transfer table's bytes equal the rows moved, on both paths; forced
  d2d needs no ``mesh-transfer`` host sync and staged does; an unknown
  mode is refused; a late observer syncs only the owners; the overlapped
  drain overlaps, a stall names each shard's backlog and an idle shard is
  no stall; an exported row is a copy the owner's next epoch leaves alone;
* ``SessionServer(scheduler="mesh")`` on reduced configs, with the
  reference's weights carried across by ``params_from_numpy``, gives the
  frontier server's tokens and leaves no prompt buffer.

The reference's forced multi-device leg (a subprocess with
``--xla_force_host_platform_device_count``) has no CPU counterpart in
torch, which has one CPU device: the CPU shards share it, and the
``cuda`` cases of ``tests/test_torch_cuda.py`` run the shards on the
card's streams.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import _torch_streams as S
from repro.core.mesh_session import MeshDeviceSession as RMesh
from repro.models import init_params as r_init_params
from repro_torch.configs import ARCHS
from repro_torch.core import MeshDeviceSession, ShardLink
from repro_torch.core.scoreboard import IntervalScoreboard
from repro_torch.launch import make_window_mesh
from repro_torch.models import params_from_numpy
from repro_torch.runtime import SessionServer

WINDOW = 16
# Against the reference's run_serial. XLA and eager torch round the
# branches' arithmetic differently and the multiply chains compound it: the
# two packages' run_serial differ by up to 1.7e-5 relative on these streams
# (magnitudes to 1e10). The dyn stream takes tests/test_dyn_workloads.py's.
RTOL, ATOL = 1e-4, 1e-5
DYN_RTOL, DYN_ATOL = 2e-4, 1e-5
# The joins stream at 4 rounds: at test_mesh_transfers.py's 6 its values
# overflow to inf, where rounding cannot be compared.
BUILD = {"sim": S.sim, "dyn": S.dyn_routing, "mixed_tag": S.mixed_tag,
         "chain": S.chain_universe,
         "joins": lambda side: S.cross_shard_joins(side, rounds=4)}
MESH_COUNTERS = (
    "plan_mode", "n_shards", "n_devices", "epochs", "sub_epoch_barriers", "cross_shard_edges",
    "placements", "transfers", "transfer_mode", "transfer_mode_requested", "d2d_moves",
    "staged_moves", "d2d_fallbacks", "overlap_drains", "drain_overlap", "d2d_row_exports",
    "d2d_row_imports", "row_invalidations", "device_dispatches", "loop_dispatches",
    "host_task_dispatches", "plan_cache_hits", "plan_cache_misses", "host_syncs",
    "host_syncs_d2h", "host_syncs_h2d", "arena_live_rows", "arena_free_rows", "dep_checks")
SHARD_COUNTERS = ("epochs", "device_dispatches", "loop_dispatches", "host_task_dispatches",
                  "host_syncs", "host_syncs_by_tag", "d2d_row_exports", "d2d_row_imports",
                  "row_invalidations", "arena_live_rows")


def _registry(side, tasks):
    reg = S.PKG[side].DeviceOpRegistry(strict=False)
    S.REGISTER[side](reg)
    branch_fns = set(S.BRANCHES[side].values())
    for t in tasks:
        if t.fn in branch_fns:
            reg.register_switch_branch(t.opcode, t.fn)
    return reg


def _mesh(side, tasks, n_shards, plan_mode="loop", **kw):
    if side == "ref":
        return RMesh(window_size=WINDOW, n_shards=n_shards, plan_mode=plan_mode,
                     registry=_registry(side, tasks), loop_pallas=False, **kw)
    return MeshDeviceSession(window_size=WINDOW, n_shards=n_shards, plan_mode=plan_mode,
                             registry=_registry(side, tasks), loop_kernel=True,
                             wave_kernel=True, device="cpu", **kw)


def _feed(session, tasks, seed=13, poll_prob=0.6):
    """Random submit chunks with polls in between (the matrix's feed)."""
    rng = np.random.RandomState(seed)
    i = 0
    while i < len(tasks):
        k = 1 + rng.randint(6)
        session.submit(tasks[i: i + k])
        i += k
        if rng.rand() < poll_prob:
            session.poll()
    return session.close()


@functools.lru_cache(maxsize=None)
def _serial(stream, side="port"):
    bufs, tasks = BUILD[stream](side)
    S.run_serial(side, tasks)
    return S.snapshot(bufs)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _run_both(stream, n_shards, plan_mode="loop", **kw):
    """The same feed through the port's mesh and the reference's; returns
    ((port buffers, port session, report), (ref buffers, ref session,
    report), (port tasks, ref tasks))."""
    out, tasks = {}, {}
    for side in S.SIDES:
        bufs, tasks[side] = BUILD[stream](side)
        session = _mesh(side, tasks[side], n_shards, plan_mode, **kw)
        report = _feed(session, tasks[side])
        out[side] = (S.snapshot(bufs), session, report)
    return out["port"], out["ref"], (tasks["port"], tasks["ref"])


def _assert_like_reference(port, ref, tasks, stream):
    (pvals, psess, prep), (_, rsess, rrep) = port, ref
    np.testing.assert_array_equal(_bits(pvals), _bits(_serial(stream)))
    rtol, atol = (DYN_RTOL, DYN_ATOL) if stream == "dyn" else (RTOL, ATOL)
    np.testing.assert_allclose(pvals, _serial(stream, "ref"), rtol=rtol, atol=atol)
    ps, rs = psess.session_stats(), rsess.session_stats()
    assert {k: ps[k] for k in MESH_COUNTERS} == {k: rs[k] for k in MESH_COUNTERS}
    assert [{k: s[k] for k in SHARD_COUNTERS} for s in ps["per_shard"]] == \
        [{k: s[k] for k in SHARD_COUNTERS} for s in rs["per_shard"]]
    ppos, rpos = S.positions(tasks[0]), S.positions(tasks[1])
    assert [[ppos[t] for t in w] for w in prep.waves] == \
        [[rpos[t] for t in w] for w in rrep.waves]
    assert prep.window_stats["retired"] == len(tasks[0])
    assert ps["plan_mode"] == "mesh" and len(ps["per_shard"]) == ps["n_shards"]
    assert ps["n_devices"] == 1


# -- the matrix: shard counts x plan modes x streams, then x transfer modes ----

@pytest.mark.parametrize("plan_mode", ["loop", "wave"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("stream", ["sim", "dyn", "mixed_tag", "chain"])
def test_interleaved_feed_matches_serial_and_reference(stream, n_shards, plan_mode):
    port, ref, tasks = _run_both(stream, n_shards, plan_mode)
    _assert_like_reference(port, ref, tasks, stream)
    stats = port[1].session_stats()
    if n_shards == 1:
        assert stats["cross_shard_edges"] == 0  # one shard stages no edge
    kernel = "loop_dispatches" if plan_mode == "loop" else "wave_kernel_dispatches"
    if stream == "chain":  # padding-free f32 rows: every dispatch takes the kernel
        assert stats[kernel] == stats["device_dispatches"] > 0
    assert stats[kernel] == sum(s[kernel] for s in stats["per_shard"])


@pytest.mark.parametrize("transfer_mode", ["auto", "d2d", "staged"])
@pytest.mark.parametrize("plan_mode", ["loop", "wave"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_transfer_modes_match_serial_and_reference(n_shards, plan_mode, transfer_mode):
    port, ref, tasks = _run_both("joins", n_shards, plan_mode, transfer_mode=transfer_mode)
    _assert_like_reference(port, ref, tasks, "joins")
    stats = port[1].session_stats()
    assert stats["transfer_mode"] == ("d2d" if transfer_mode == "auto" else transfer_mode)
    assert (stats["transfers"]["transfers"] > 0) == (n_shards > 1)
    kernel = "loop_dispatches" if plan_mode == "loop" else "wave_kernel_dispatches"
    assert stats[kernel] == stats["device_dispatches"] > 0


def test_placement_respects_same_epoch_raw_upstream():
    """A task whose reads RAW-depend on a writer placed in the SAME
    admission epoch lands on one of those writers' shards."""
    _, tasks = S.mixed_tag("port")
    session = MeshDeviceSession(window_size=WINDOW, n_shards=4, device="cpu")
    checked = []
    orig = session._place_epoch

    def spy(order):
        shard_of = orig(order)
        sb = IntervalScoreboard()
        for t in order:
            raw = sb.probe_writers(t.read_segments)
            sb.insert(t.tid, t.read_segments, t.write_segments)
            same_epoch = [u for u in raw if u in shard_of and u != t.tid]
            if same_epoch:
                checked.append((t.tid, shard_of[t.tid], {shard_of[u] for u in same_epoch}))
        return shard_of

    session._place_epoch = spy
    session.submit(tasks)
    session.close()
    assert checked, "stream produced no same-epoch RAW pairs"
    for tid, shard, upstream in checked:
        assert shard in upstream, (tid, shard, upstream)


def test_make_session_mesh_and_window_mesh():
    session = S.T.make_session("mesh", window_size=WINDOW, device="cpu")
    assert isinstance(session, MeshDeviceSession) and session.n_shards == 1
    assert make_window_mesh(device="cpu") == [torch.device("cpu")]
    assert make_window_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="n >= 1"):
        make_window_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        MeshDeviceSession(n_shards=0, device="cpu")
    mesh = MeshDeviceSession(n_shards=3, devices=make_window_mesh(2, device="cpu"))
    assert [sh.device for sh in mesh.shards] == [torch.device("cpu")] * 3
    assert all(sh.stream is None for sh in mesh.shards)  # CPU shards have no stream
    assert mesh.link.probe.startswith("one device")


# -- ShardLink and the transfer table (tests/test_mesh_transfers.py) ----------

def _mesh_transfer_syncs(stats):
    return sum(s["host_syncs_by_tag"].get("mesh-transfer", 0) for s in stats["per_shard"])


def _joins_run(mode=None, seed=0, **kw):
    bufs, tasks = S.cross_shard_joins("port", seed=seed)
    if mode is not None:
        kw["transfer_mode"] = mode
    session = MeshDeviceSession(window_size=32, n_shards=4, device="cpu", **kw)
    return bufs, tasks, session


class TestShardLinkAudit:
    @pytest.mark.parametrize("mode", ["d2d", "staged"])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_table_bytes_match_rows_moved(self, mode, seed):
        bufs, tasks, session = _joins_run(mode, seed)
        expected = {}
        orig_move = session.link.move

        def spy(base, owner, dest):
            nbytes = session.shards[owner].arena.row_nbytes(base)
            used = orig_move(base, owner, dest)
            slot = expected.setdefault(used, {"transfers": 0, "bytes": 0})
            slot["transfers"] += 1
            slot["bytes"] += nbytes
            return used

        session.link.move = spy
        session.submit(tasks)
        session.close()
        table = session.transfer_table.as_dict()
        assert table["transfers"] > 0, "stream produced no cross-shard moves"
        assert table["by_mode"] == expected and set(expected) == {mode}
        assert table["transfers"] == sum(v["transfers"] for v in expected.values())
        assert table["bytes"] == sum(v["bytes"] for v in expected.values())
        np.testing.assert_array_equal(
            _bits(S.snapshot(bufs)), _bits(_serial_joins(seed)))
        # The reference's table on the same stream is the same ledger.
        rbufs, rtasks = S.cross_shard_joins("ref", seed=seed)
        rsession = RMesh(window_size=32, n_shards=4, transfer_mode=mode, loop_pallas=False)
        rsession.submit(rtasks)
        rsession.close()
        assert rsession.transfer_table.as_dict() == table

    def test_d2d_eliminates_mesh_transfer_syncs(self):
        results = {}
        for mode in ("staged", "d2d"):
            bufs, tasks, session = _joins_run(mode)
            session.submit(tasks)
            session.close()
            results[mode] = (S.snapshot(bufs), session.session_stats())
        d2d_vals, d2d = results["d2d"]
        staged_vals, staged = results["staged"]
        assert (d2d["transfer_mode"], staged["transfer_mode"]) == ("d2d", "staged")
        assert d2d["d2d_moves"] > 0 and d2d["staged_moves"] == 0
        assert staged["staged_moves"] > 0 and staged["d2d_moves"] == 0
        assert _mesh_transfer_syncs(d2d) == 0
        assert _mesh_transfer_syncs(staged) > 0
        assert d2d["transfers"]["bytes"] == staged["transfers"]["bytes"]
        assert d2d["row_invalidations"] > 0
        np.testing.assert_array_equal(_bits(d2d_vals), _bits(staged_vals))
        np.testing.assert_array_equal(_bits(d2d_vals), _bits(_serial_joins(0)))

    def test_link_rejects_unknown_mode(self):
        with pytest.raises(ValueError, match="transfer_mode"):
            MeshDeviceSession(window_size=16, n_shards=2, transfer_mode="teleport",
                              device="cpu")
        with pytest.raises(ValueError, match="transfer_mode"):
            ShardLink([], None, mode="bogus")


@functools.lru_cache(maxsize=None)
def _serial_joins(seed):
    bufs, tasks = S.cross_shard_joins("port", seed=seed)
    S.run_serial("port", tasks)
    return S.snapshot(bufs)


class TestLateObserverSync:
    def test_late_observe_syncs_only_owner_shards(self):
        bufs, tasks, session = _joins_run()
        session.submit(tasks)
        session.flush()
        calls = {i: [] for i in range(4)}
        for i, sh in enumerate(session.shards):
            def spy(bufs_arg, _orig=sh.sync_buffers, _i=i, **kw):
                calls[_i].append(list(bufs_arg))
                return _orig(bufs_arg, **kw)

            sh.sync_buffers = spy
        task = tasks[0]
        owners = {session._owner[id(b)] for b in tuple(task.inputs) + tuple(task.outputs)
                  if id(b) in session._owner}
        assert owners
        fired = []
        session.on_task_retired(task, fired.append)
        assert fired == [task]
        synced = {i for i, c in calls.items() if c}
        assert synced == owners and len(synced) < 4
        operand_ids = {id(b) for b in tuple(task.inputs) + tuple(task.outputs)}
        for i in synced:
            assert len(calls[i]) == 1
            assert {id(b) for b in calls[i][0]} <= operand_ids
        session.close()


class TestOverlappedDrain:
    def test_overlap_bit_identical_and_actually_overlaps(self):
        stats = {}
        for overlap in (True, False):
            bufs, tasks, session = _joins_run(overlap_drains=overlap)
            session.submit(tasks)
            session.close()
            np.testing.assert_array_equal(_bits(S.snapshot(bufs)), _bits(_serial_joins(0)))
            stats[overlap] = session.session_stats()
        assert stats[True]["overlap_drains"] is True
        assert stats[True]["drain_overlap"] >= 2
        assert stats[False]["overlap_drains"] is False
        assert stats[False]["drain_overlap"] == 0

    def test_stall_error_reports_per_shard_outstanding(self):
        session = MeshDeviceSession(window_size=16, n_shards=2, device="cpu")

        class _Stuck:
            outstanding = 3
            inflight_segments = 0

            def launch(self):
                return False

            def poll_inflight(self, block=False):
                return 0

        session._shards = [_Stuck(), _Stuck()]
        with pytest.raises(RuntimeError) as exc:
            session._drain_overlapped([0, 1])
        assert "full round-robin pass" in str(exc.value)
        assert "{0: 3, 1: 3}" in str(exc.value)

    def test_idle_shard_is_not_a_stall(self):
        class _Draining:
            def __init__(self, segments):
                self.outstanding = segments
                self.inflight_segments = segments

            def launch(self):
                return self.outstanding > 0

            def poll_inflight(self, block=False):
                if self.outstanding:
                    self.outstanding -= 1
                    self.inflight_segments -= 1
                    return 1
                return 0

        class _Idle:
            outstanding = 0
            inflight_segments = 0

            def launch(self):
                return False

            def poll_inflight(self, block=False):
                return 0

        session = MeshDeviceSession(window_size=16, n_shards=2, device="cpu")
        session._shards = [_Draining(3), _Idle()]
        session._drain_overlapped([0, 1])
        assert session._shards[0].outstanding == 0


# -- the DeviceSession halves the link drives ----------------------------------

def _one_chain(width=8):
    pool = S.pool("port")
    a = pool.alloc((width,), np.float32, name="a", value=np.arange(width, dtype=np.float32))
    w = pool.alloc((width,), np.float32, name="w", value=np.ones(width, np.float32))
    kern = S.T.AcsKernel(name="axpy_row", fn=S.BRANCHES["port"]["axpy"])
    stream = S.T.TaskStream()
    return a, w, lambda: kern.launch(stream, inputs=(a, w), outputs=(a,))


def test_exported_row_is_a_copy_the_next_epoch_leaves_alone():
    a, _, step = _one_chain()
    owner = S.T.DeviceSession(window_size=8, plan_mode="loop", device="cpu")
    owner.submit(step())
    owner.poll()
    row = owner.export_row(a)
    assert row is not None and row.event is None  # the CPU copies at once
    before = row.value.clone()
    owner.submit(step())  # the owner's next epoch writes the row in place
    owner.poll()
    torch.testing.assert_close(row.value, before, rtol=0, atol=0)
    owner.sync()
    assert not torch.equal(a.value, before[: a.value.shape[0]])
    peer = S.T.DeviceSession(window_size=8, plan_mode="loop", device="cpu")
    assert peer.import_row(a, row)
    peer.sync()
    torch.testing.assert_close(a.value, before, rtol=0, atol=0)
    stats = (owner.session_stats(), peer.session_stats())
    assert (stats[0]["d2d_row_exports"], stats[1]["d2d_row_imports"]) == (1, 1)
    assert peer.invalidate_row(a) is False  # synced: no device claim left
    owner.close()
    peer.close()


def test_sync_buffers_and_mark_host_dirty_tag_the_staged_halves():
    a, _, step = _one_chain()
    owner = S.T.DeviceSession(window_size=8, plan_mode="loop", device="cpu")
    owner.submit(step())
    owner.poll()
    assert owner.export_row(a) is not None
    owner.sync_buffers([a], tags=("mesh-transfer",))
    assert owner.export_row(a) is None  # host value current: stage through the host
    owner.mark_host_dirty(a, tag="mesh-transfer")
    owner.submit(step())
    owner.poll()
    stats = owner.session_stats()
    assert stats["host_syncs_by_tag"]["mesh-transfer"] == 2  # the d2h and the h2d
    assert (stats["host_syncs_d2h"], stats["host_syncs_h2d"]) == (1, 1)
    owner.close()


def test_release_buffer_reaches_every_shard():
    bufs, tasks, session = _joins_run("d2d")
    session.submit(tasks)
    session.flush()
    crossed = [b for b in bufs if sum(b in sh.arena for sh in session.shards) > 1]
    assert crossed, "no buffer holds rows on two shards"
    buf = crossed[0]
    assert session.release_buffer(buf)
    assert not any(buf in sh.arena for sh in session.shards)
    assert session.shard_of(buf) is None
    session.close()


# -- the mesh server (tests/test_serve.py), on reduced configs -----------------

@functools.lru_cache(maxsize=None)
def _model(key):
    cfg = ARCHS[key].reduced()
    ref = r_init_params(cfg, jax.random.PRNGKey(0), tp_size=1)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, ref), cfg, device="cpu")


def _serve(server, prompts, max_new):
    for p in prompts:
        server.submit(p, max_new=max_new)
    got = {tuple(r.prompt): r.generated for r in server.run_until_drained()}
    server.close()
    return got


@pytest.mark.parametrize("key,n_shards", [("h2o-danube-3-4b", 1), ("h2o-danube-3-4b", 2),
                                          ("recurrentgemma-2b", 2),
                                          ("granite-moe-3b-a800m", 2)])
def test_mesh_tokens_identical_to_frontier(key, n_shards):
    cfg, params = _model(key)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab, 5) for _ in range(4)]
    kw = dict(max_slots=2, max_len=32, device="cpu")
    ref = _serve(SessionServer(cfg, params, scheduler="frontier", **kw), prompts, 3)
    mesh = SessionServer(cfg, params, scheduler="mesh", n_shards=n_shards, **kw)
    assert isinstance(mesh.session, MeshDeviceSession)
    assert mesh.session.n_shards == n_shards
    got = _serve(mesh, prompts, 3)
    assert got == ref and all(len(t) == 3 for t in got.values())
    assert [b.name for b in mesh.pool.buffers() if b.name.endswith("_prompt")] == []
    entry = mesh.report_log[-1]
    assert entry["shard_slots_mean"] and all(v >= 0 for v in entry["shard_slots_mean"].values())
    assert entry["transfer_mode"] == "d2d" and entry["device_session"]["plan_mode"] == "mesh"
    stats = entry["device_session"]
    assert stats["host_task_dispatches"] == len(prompts) * (1 + 3)
    if n_shards == 2:
        assert set(entry["shard_slots_mean"]) <= {"0", "1"}
