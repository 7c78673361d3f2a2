"""Mesh-sharded device window: per-device slab shards behind one global
admission plane (PyTorch port of ``repro/core/mesh_session.py``).

Everything below `DeviceSession` runs on ONE device with one slab arena
and one plan cache. :class:`MeshDeviceSession` partitions the live window
across a list of devices (``launch.mesh.make_window_mesh``):

* each **shard** is a full `DeviceSession` (its own arena, a shard-local
  address space; its plan and program caches; its epoch executor, the
  ready-queue kernel under ``plan_mode="loop"``, the default, or the wave
  kernel's one-launch epoch under ``"wave"``/``"frontier"``) pinned to one
  device and, on the card, to its OWN CUDA stream: shards placed on one
  card issue their epochs on separate streams;
* the **admission plane** is the outer scheduling window: producers submit
  in program order as with any session, and each epoch the plane drains
  the window in program order, replays a fresh
  :class:`~.scoreboard.IntervalScoreboard` over the epoch to recover each
  task's same-epoch RAW producers (``probe_writers``) and full hazard set
  (``insert``), and **places** the task:

  1. a task with same-epoch RAW producers goes to its latest producer's
     shard (dependent chains never leave their shard);
  2. else any same-epoch hazard upstream (WAR/WAW) decides the same way;
  3. else **affinity**: the shard that last wrote one of its operands;
  4. else **read affinity**: the shard that first read one of them (a
     read-only working set, such as a tenant's weights);
  5. else **priority-aware balance**: the shard with the least placed
     equal-or-more-urgent work for the task's priority bucket, total load
     as tie-break (with one priority class: least-loaded).

* within an epoch, tasks stream to their shards in **sub-epochs**: the
  plane walks program order and cuts a barrier only when a task touches a
  base buffer another shard wrote (or writes one another shard read) in
  the current sub-epoch, so inside a sub-epoch shards dispatch
  independently;
* only true **cross-shard edges** move data, through a :class:`ShardLink`
  at sub-epoch boundaries: **d2d** copies the owner's slab row on the
  owner's stream and writes it into the consumer's slab after the
  consumer's stream waits for that copy (no host hop; the row arrives
  device-authoritative), **staged** goes through the host (owner
  ``sync_buffers``, a counted d2h tagged ``mesh-transfer``; consumer
  ``mark_host_dirty``, re-uploaded at its next dispatch, a counted h2d of
  the same tag). Every move lands in the
  :class:`~.arena.ShardTransferTable`. A per-buffer copy set memoizes
  clean replicas, and a write **invalidates** every other holder's claim
  (``invalidate_row``);
* shard drains **overlap** (``overlap_drains=True``): a sub-epoch launches
  every involved shard's epoch back to back with retirement deferred
  (``DeviceSession.launch``), then retires them through a non-blocking
  round-robin ``poll_inflight`` pump. ``drain_overlap`` records the most
  shards in flight at once; a stall raises only when a full pass (plus
  one blocking poll) advances nothing.

Streams: a shard's stream waits for its producer's stream before each
dispatch; a staged edge makes the consumer's stream wait for the owner's;
a write that supersedes copies on other shards makes the writer's stream
wait for theirs. A host value a shard's host path made (an opaque serving
slot) is therefore never read or recycled on another stream early.

Placement decides only WHERE a task runs; order comes from program order
and the same interval hazards every session uses, so the mesh leaves the
same buffers as ``run_serial`` at any shard count, including counts above
the device count (shards then share devices round-robin, each with its own
stream on the card: the CPU tests' logical-shard mode).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from .arena import ShardTransferTable
from .buffers import Buffer, DeviceLike
from .device_dispatch import DeviceOpRegistry, DeviceSession
from .executors import ExecStats
from .scheduler import SchedulerReport
from .scoreboard import IntervalScoreboard
from .session import SchedulerSession
from .task import Task, operand_base

__all__ = ["MeshDeviceSession", "ShardLink"]


def _order_after(waiter: DeviceSession, producer: DeviceSession) -> None:
    """Make ``waiter``'s stream wait (on the device) for the work queued on
    ``producer``'s: nothing to do without streams or on one stream."""
    if waiter.stream is not None and producer.stream is not None \
            and waiter.stream != producer.stream:
        waiter.stream.wait_stream(producer.stream)


class ShardLink:
    """Cross-shard row mover: the transfer layer between a mesh session's
    shards.

    One link per session. ``mode`` selects the path:

    * ``"d2d"``: the owner exports a copy of its device-resident slab row
      (:meth:`DeviceSession.export_row`, queued on its stream with an
      event after it) and the destination imports it
      (:meth:`DeviceSession.import_row`, its stream waits for the event):
      no host round trip, no ``host_syncs``;
    * ``"staged"``: through the host (owner d2h, destination marks the row
      host-dirty and re-uploads at its next dispatch), both halves tagged
      ``mesh-transfer`` in the sync audit;
    * ``"auto"``: probe once at construction (``probe`` says what it
      found): shards on one device take ``d2d`` (a copy within the
      device); shards on distinct CUDA devices take ``d2d`` when every
      pair has peer access (``torch.cuda.can_device_access_peer``), else
      ``staged``, the reference's fallback for backends without p2p.

    Even under ``d2d``, a row whose authoritative value lives host-side
    falls back to the staged path for that row (``d2d_fallbacks``). Every
    move is recorded in the :class:`~.arena.ShardTransferTable` with the
    mode it took.
    """

    MODES = ("auto", "d2d", "staged")

    def __init__(self, shards: Sequence[DeviceSession], table: ShardTransferTable,
                 mode: str = "auto"):
        if mode not in self.MODES:
            raise ValueError(f"transfer_mode must be one of {self.MODES}, got {mode!r}")
        self.shards = list(shards)
        self.table = table
        self.requested_mode = mode
        self.probe = ""
        if mode == "auto":
            self.selected_mode = "d2d" if self._probe_p2p() else "staged"
        else:
            self.selected_mode = mode
        self.d2d_moves = 0
        self.staged_moves = 0
        self.d2d_fallbacks = 0

    def _probe_p2p(self) -> bool:
        """Can a slab row move device to device between every two shard
        devices? One distinct device: yes (a copy within it)."""
        devs: List[torch.device] = []
        for sh in self.shards:
            if sh.device not in devs:
                devs.append(sh.device)
        if not devs:
            self.probe = "no shards"
            return False
        if len(devs) == 1:
            self.probe = f"one device ({devs[0]}): d2d is a copy within it"
            return True
        if any(d.type != "cuda" for d in devs):
            self.probe = f"devices {[str(d) for d in devs]} are not all CUDA: staged"
            return False
        missing = [(a.index, b.index) for a in devs for b in devs
                   if a != b and not torch.cuda.can_device_access_peer(a.index, b.index)]
        if missing:
            self.probe = f"no peer access between cuda pairs {missing}: staged"
            return False
        self.probe = f"peer access between all of {[str(d) for d in devs]}: d2d"
        return True

    def move(self, base: Buffer, owner: int, dest: int) -> str:
        """Move ``base``'s row from shard ``owner`` to shard ``dest``;
        returns the mode actually used (``"d2d"`` or ``"staged"``)."""
        src, dst = self.shards[owner], self.shards[dest]
        label = src.arena.class_of(base).label
        nbytes = src.arena.row_nbytes(base)
        if self.selected_mode == "d2d":
            row = src.export_row(base)
            if row is not None and dst.import_row(base, row):
                self.d2d_moves += 1
                self.table.record(owner, dest, label, nbytes, mode="d2d")
                return "d2d"
            self.d2d_fallbacks += 1
        src.sync_buffers([base], tags=("mesh-transfer",))
        dst.mark_host_dirty(base, tag="mesh-transfer")
        # A host value the owner's host path made (no arena row) is still
        # queued on the owner's stream.
        _order_after(dst, src)
        self.staged_moves += 1
        self.table.record(owner, dest, label, nbytes, mode="staged")
        return "staged"

    def stats(self) -> Dict[str, Any]:
        return {
            "transfer_mode": self.selected_mode,
            "transfer_mode_requested": self.requested_mode,
            "transfer_probe": self.probe,
            "d2d_moves": self.d2d_moves,
            "staged_moves": self.staged_moves,
            "d2d_fallbacks": self.d2d_fallbacks,
        }


class MeshDeviceSession(SchedulerSession):
    """A live-fed session whose window is sharded across devices.

    ``n_shards=None`` opens one shard per device of ``devices`` (default
    ``make_window_mesh(device=device)``: every visible card, or one CPU);
    an explicit ``n_shards`` may exceed the device count, and shards then
    share devices round-robin. On the card every shard gets its own
    ``torch.cuda.Stream``. ``transfer_mode`` selects the cross-shard edge
    path (:class:`ShardLink`); ``overlap_drains=False`` drains the shards
    of a sub-epoch one after the other (the overlap A/B baseline). The
    other knobs go to each shard's :class:`DeviceSession`.
    """

    def __init__(
        self,
        window_size: int = 32,
        n_shards: Optional[int] = None,
        registry: Optional[DeviceOpRegistry] = None,
        plan_mode: str = "loop",
        devices: Optional[Sequence[Any]] = None,
        history_limit: Optional[int] = None,
        loop_kernel: Optional[bool] = None,
        wave_kernel: Optional[bool] = None,
        plan_cache_limit: Optional[int] = 512,
        pad_payloads: bool = False,
        transfer_mode: str = "auto",
        overlap_drains: bool = True,
        device: DeviceLike = "cuda",
    ):
        if devices is None:
            from ..launch.mesh import make_window_mesh

            devices = make_window_mesh(device=device)
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh session needs at least one device")
        if n_shards is None:
            n_shards = len(devices)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        super().__init__(window_size, history_limit=history_limit)
        self.n_shards = n_shards
        self.devices = devices
        self.registry = registry if registry is not None else DeviceOpRegistry(strict=False)
        self.plan_mode = plan_mode
        self._shards: List[DeviceSession] = []
        for i in range(n_shards):
            dev = devices[i % len(devices)]
            self._shards.append(DeviceSession(
                window_size=window_size, registry=self.registry, plan_mode=plan_mode,
                history_limit=history_limit, loop_kernel=loop_kernel,
                wave_kernel=wave_kernel, plan_cache_limit=plan_cache_limit,
                pad_payloads=pad_payloads, device=dev,
                stream=torch.cuda.Stream(dev) if dev.type == "cuda" else None))
        # id(buffer) -> shard that last WROTE it (its row is authoritative
        # while device-dirty), and -> the shards holding a CURRENT copy
        # (owner + shards a transfer already reached). A write collapses
        # the copy set to the writer.
        self._owner: Dict[int, int] = {}
        self._copies: Dict[int, Set[int]] = {}
        # id(buffer) -> shard that first READ it: a read-only working set
        # has no writer, and its read home keeps its readers together.
        self._read_home: Dict[int, int] = {}
        # Per-shard placement totals, and the same split by priority
        # bucket (the balance rule's key).
        self._placed: List[int] = [0] * n_shards
        self._placed_by_bucket: List[Dict[int, int]] = [{} for _ in range(n_shards)]
        self.transfer_table = ShardTransferTable()
        self.link = ShardLink(self._shards, self.transfer_table, mode=transfer_mode)
        self.overlap_drains = overlap_drains
        # Most shards in flight at once inside one sub-epoch drain.
        self.drain_overlap = 0
        self.cross_shard_edges = 0
        self.sub_epoch_barriers = 0
        self.epochs = 0
        self.placements: Dict[str, int] = {
            "raw_upstream": 0, "hazard_upstream": 0,
            "affinity": 0, "read_affinity": 0, "balance": 0,
        }

    @property
    def shards(self) -> List[DeviceSession]:
        return list(self._shards)

    # -- placement plane ---------------------------------------------------
    def _place_epoch(self, order: List[Task]) -> Dict[int, int]:
        """Decide every task's shard for one epoch (program order in);
        returns ``shard_of_tid``."""
        sb = IntervalScoreboard()
        pos: Dict[int, int] = {}
        shard_of: Dict[int, int] = {}
        for i, t in enumerate(order):
            raw = sb.probe_writers(t.read_segments)
            haz = sb.insert(t.tid, t.read_segments, t.write_segments)
            pos[t.tid] = i
            if raw:
                latest = max(raw, key=lambda tid: pos[tid])
                shard, reason = shard_of[latest], "raw_upstream"
            elif haz:
                latest = max(haz, key=lambda tid: pos[tid])
                shard, reason = shard_of[latest], "hazard_upstream"
            else:
                bids = [id(operand_base(op)) for op in tuple(t.inputs) + tuple(t.outputs)]
                owners = [self._owner[b] for b in bids if b in self._owner]
                homes = [self._read_home[b] for b in bids if b in self._read_home]
                if owners:
                    # the most-represented owning shard (ties: first seen)
                    shard = max(set(owners), key=owners.count)
                    reason = "affinity"
                elif homes:
                    shard = max(set(homes), key=homes.count)
                    reason = "read_affinity"
                else:
                    bucket = t.priority
                    shard = min(
                        range(self.n_shards),
                        key=lambda s: (
                            sum(c for b, c in self._placed_by_bucket[s].items() if b <= bucket),
                            self._placed[s], s))
                    reason = "balance"
            shard_of[t.tid] = shard
            for op in t.inputs:
                self._read_home.setdefault(id(operand_base(op)), shard)
            self._placed[shard] += 1
            by_bucket = self._placed_by_bucket[shard]
            by_bucket[t.priority] = by_bucket.get(t.priority, 0) + 1
            self.placements[reason] += 1
        return shard_of

    # -- cross-shard staging ----------------------------------------------
    def _stage_transfers(self, task: Task, shard: int) -> None:
        """Materialize one task's cross-shard edges before its shard
        dispatches: every operand another shard owns moves through the
        link, memoized per (buffer, shard) in the copy set until the next
        write. A write collapses the copy set to the writer, drops every
        superseded copy's claim and orders the writer after the readers
        of those copies."""
        for op in tuple(task.inputs) + tuple(task.outputs):
            base = operand_base(op)
            bid = id(base)
            owner = self._owner.get(bid)
            if owner is not None and owner != shard:
                self.cross_shard_edges += 1
                if shard not in self._copies.get(bid, ()):
                    self.link.move(base, owner, shard)
                    self._copies.setdefault(bid, {owner}).add(shard)
        for op in task.outputs:
            base = operand_base(op)
            bid = id(base)
            for s in self._copies.get(bid, ()):
                if s != shard:
                    self._shards[s].invalidate_row(base)
                    _order_after(self._shards[shard], self._shards[s])
            self._owner[bid] = shard
            self._copies[bid] = {shard}

    # -- the epoch ---------------------------------------------------------
    def _dispatch_sub_epoch(self, sub: List[Tuple[Task, int]]) -> None:
        """One barrier-free slice: stage its cross-shard inputs, feed each
        shard its tasks (program order kept per shard), drain every
        involved shard, then retire through the outer plane. A watched
        slice (listener, per-task callback or ticket) retires each task as
        its shard retires it, so a callback sees each intermediate value
        as under `DeviceSession`; an unwatched one retires wholesale after
        the drain."""
        watched = bool(self._listeners) or any(
            t.tid in self._watchers or t.tid in self._tickets for t, _ in sub)
        involved: List[int] = []
        for task, shard in sub:
            self._stage_transfers(task, shard)
            if shard not in involved:
                involved.append(shard)
            if watched:
                self._shards[shard].submit(task, on_retire=self._note_retired)
            else:
                self._shards[shard].submit(task)
        self.waves.append([t.tid for t, _ in sub])
        if self.overlap_drains:
            self._drain_overlapped(involved)
        else:
            self._drain_sequential(involved)
        if not watched:
            for task, _ in sub:
                self._note_retired(task)

    def _drain_sequential(self, involved: List[int]) -> None:
        """Block each involved shard to empty in turn (the A/B control for
        the overlapped pump)."""
        for shard in involved:
            sh = self._shards[shard]
            while sh.outstanding:
                before = sh.outstanding
                sh.poll()
                if sh.outstanding == before:
                    raise RuntimeError(
                        f"mesh shard {shard} stalled with {sh.outstanding} tasks outstanding")

    def _drain_overlapped(self, involved: List[int]) -> None:
        """Launch every involved shard's epoch back to back with retirement
        deferred (:meth:`DeviceSession.launch`), so the shards' dispatches
        are in flight together, then retire them through a non-blocking
        round-robin ``poll_inflight``. A shard idle in one round is not a
        stall while others advance: only when a full pass advances nothing
        does the pump block on the oldest pending shard, and only a
        fruitless blocking poll raises, with every pending shard's
        outstanding count in the error."""
        for shard in involved:
            self._shards[shard].launch()
        pending = [s for s in involved if self._shards[s].outstanding]
        self.drain_overlap = max(self.drain_overlap, len(pending))
        while pending:
            progressed = False
            for s in list(pending):
                sh = self._shards[s]
                if sh.poll_inflight(block=False) > 0:
                    progressed = True
                if sh.outstanding and not sh.inflight_segments:
                    # Backlog past the shard window: dispatch the next
                    # epoch (still deferred) instead of spinning on it.
                    progressed = sh.launch() or progressed
                if not sh.outstanding:
                    pending.remove(s)
                    progressed = True
            if pending and not progressed:
                sh = self._shards[pending[0]]
                if sh.poll_inflight(block=True) == 0:
                    counts = {s: self._shards[s].outstanding for s in pending}
                    raise RuntimeError(
                        "mesh drain stalled: a full round-robin pass advanced no shard; "
                        f"outstanding per shard: {counts}")
                if not sh.outstanding:
                    pending.pop(0)

    def _pump(self) -> bool:
        if self.window.idle():
            return False
        order = self.window.drain_program_order()
        shard_of = self._place_epoch(order)
        # Sub-epoch walk: cut only at cross-shard conflicts within the
        # current slice, at BASE-BUFFER granularity (two shards writing
        # disjoint row views of one buffer would split its row ownership).
        # Read-read sharing across shards stays barrier-free.
        sub: List[Tuple[Task, int]] = []
        readers: Dict[int, Set[int]] = {}  # id(base) -> shards reading
        writers: Dict[int, Set[int]] = {}  # id(base) -> shards writing
        for t in order:
            shard = shard_of[t.tid]
            rb = {id(operand_base(op)) for op in t.inputs}
            wb = {id(operand_base(op)) for op in t.outputs}
            conflict = any(s != shard for b in rb | wb for s in writers.get(b, ())) or \
                any(s != shard for b in wb for s in readers.get(b, ()))
            if conflict:
                self._dispatch_sub_epoch(sub)
                self.sub_epoch_barriers += 1
                sub, readers, writers = [], {}, {}
            for b in rb:
                readers.setdefault(b, set()).add(shard)
            for b in wb:
                writers.setdefault(b, set()).add(shard)
            sub.append((t, shard))
        if sub:
            self._dispatch_sub_epoch(sub)
        self.epochs += 1
        return True

    # -- retirement observation --------------------------------------------
    def _pre_observe_retired(self, task: Task) -> None:
        # A late observer reads the task's operands host-side: sync exactly
        # those buffers on the shards that OWN them, not every shard.
        per_shard: Dict[int, List[Buffer]] = {}
        for op in tuple(task.inputs) + tuple(task.outputs):
            base = operand_base(op)
            owner = self._owner.get(id(base))
            if owner is not None:
                per_shard.setdefault(owner, []).append(base)
        for shard, bufs in per_shard.items():
            self._shards[shard].sync_buffers(bufs, tags=DeviceSession._tags_of([task]))

    def shard_of(self, buf: Buffer) -> Optional[int]:
        """The shard that last wrote ``buf``, or None. Serving uses it for
        per-shard slot accounting."""
        with self._lock:
            return self._owner.get(id(buf))

    # -- row lifecycle -----------------------------------------------------
    def release_buffer(self, buf: Buffer) -> bool:
        """Forward a producer's release to every shard (each holds its own
        row when the buffer crossed shards) and drop the ownership entry.
        True if any shard recycled a row."""
        with self._lock:
            freed = False
            for sh in self._shards:
                freed = sh.release_buffer(buf) or freed
            self._owner.pop(id(buf), None)
            self._copies.pop(id(buf), None)
            self._read_home.pop(id(buf), None)
            return freed

    # -- lifecycle ---------------------------------------------------------
    def sync(self) -> None:
        """Force every shard's device-resident values back to host."""
        with self._lock:
            for sh in self._shards:
                sh.sync()

    def flush(self) -> None:
        super().flush()
        for sh in self._shards:
            sh.flush()

    def session_stats(self) -> Dict[str, Any]:
        """Mesh counters and every shard's ``session_stats()``
        (``per_shard``). The aggregate keys mirror `DeviceSession`'s."""
        with self._lock:
            per_shard = [sh.session_stats() for sh in self._shards]

            def total(key: str) -> int:
                return sum(s[key] for s in per_shard)

            return {
                "plan_mode": "mesh",
                "n_shards": self.n_shards,
                "n_devices": len(set(self.devices)),
                "epochs": self.epochs,
                "sub_epoch_barriers": self.sub_epoch_barriers,
                "cross_shard_edges": self.cross_shard_edges,
                "placements": dict(self.placements),
                "transfers": self.transfer_table.as_dict(),
                **self.link.stats(),
                "overlap_drains": self.overlap_drains,
                "drain_overlap": self.drain_overlap,
                "d2d_row_exports": total("d2d_row_exports"),
                "d2d_row_imports": total("d2d_row_imports"),
                "row_invalidations": total("row_invalidations"),
                "device_dispatches": total("device_dispatches"),
                "loop_dispatches": total("loop_dispatches"),
                "wave_kernel_dispatches": total("wave_kernel_dispatches"),
                "host_task_dispatches": total("host_task_dispatches"),
                "plan_cache_hits": total("plan_cache_hits"),
                "plan_cache_misses": total("plan_cache_misses"),
                "compiled_programs": total("compiled_programs"),
                "host_syncs": total("host_syncs"),
                "host_syncs_d2h": total("host_syncs_d2h"),
                "host_syncs_h2d": total("host_syncs_h2d"),
                "slab_bytes": total("slab_bytes"),
                "arena_live_rows": total("arena_live_rows"),
                "arena_free_rows": total("arena_free_rows"),
                "arena_recycled_rows": total("arena_recycled_rows"),
                "arena_compactions": total("arena_compactions"),
                "dep_checks": self.window.stats.dep_checks,
                "scoreboard_probes": self.window.stats.scoreboard_probes,
                "per_shard": per_shard,
            }

    def _finalize(self) -> SchedulerReport:
        wall = time.perf_counter() - self._t0
        for sh in self._shards:
            if not sh.closed:
                sh.close()
        stats = ExecStats()
        for sh in self._shards:
            stats.dispatches += sh.stats.dispatches
            stats.tasks_run += sh.stats.tasks_run
            stats.compiles += sh.stats.compiles
            stats.wave_widths.extend(sh.stats.wave_widths)
        stats.exec_seconds = wall
        report = SchedulerReport(self.window, stats, wall, self.waves)
        report.plan_mode = "mesh"  # type: ignore[attr-defined]
        report.session_stats = self.session_stats()  # type: ignore[attr-defined]
        report.arena_stats = {  # type: ignore[attr-defined]
            "n_classes": sum(sh.arena.n_classes() for sh in self._shards),
            "per_shard": [sh.arena.padding_waste() for sh in self._shards],
        }
        return report
