"""Interval scoreboard — the window's incremental dependency authority.

The seed window reproduced Algorithm 1 literally: every insertion checked
the incoming kernel's read/write segments against *every* resident's
segments (``segments.window_upstreams``, a stacked O(window x segments^2)
interval pass). The paper budgets 0.41-1.64us per check (Table II) and
picks N=32 largely because that scan grows linearly with the window — the
check cost caps how much concurrency the scheduler can even *see*.

Out-of-order CPUs solved the same problem decades ago by replacing
all-pairs comparison with renaming/scoreboard structures keyed on the
*resource*, not the instruction pair; Atos tracks dynamic dependencies
through shared frontier state, and Jangda et al. key fine-grained kernel
waits on producer tiles rather than scanning consumers. This module makes
the same move for address intervals:

* the scoreboard maintains, per virtual-address interval, the set of
  resident **writer** tids and the set of resident **reader** tids, in a
  sorted half-open boundary structure (an interval map: each boundary
  starts a cell that extends to the next boundary);
* **inserting** a task probes only the cells its own segments touch and
  returns the exact RAW/WAR/WAW upstream set — O(segments x log
  boundaries + cells touched), independent of window size;
* **retiring** a task removes only its own interval claims (recorded at
  insert), coalescing cells that became identical so the structure stays
  O(live claims) for arbitrarily long sessions.

Exactness note — writer *sets*, not a single last-writer: a classic
renaming scoreboard keeps only the last writer per resource, which is
enough for *schedule* correctness (a WAW chain serializes transitively).
The refactor gate here is stronger — bit-identical upstream sets against
the pairwise oracle (``window_upstreams``) — and under WAW an address
interval legitimately has several resident writers (A wrote, B wrote
after; both still resident), all of which the pairwise scan reports. So
each cell carries the full writer set and probe unions match the oracle
exactly (property-tested in ``tests/test_scoreboard.py``).

The boundary structure is a two-level (blocked) sorted list: positions
live in blocks of ~``_BLOCK`` entries, so a split/merge memmoves one
small block (C-speed) instead of one flat window-sized list — the flat
``list.insert`` variant measurably degrades to O(window) per insertion.

Segments are registered **coalesced** (``SegmentSet.coalesced()``):
adjacent/overlapping intervals — e.g. a task reading many contiguous row
views of one buffer — merge into one claim, cutting probe counts and
boundary churn without changing the claimed address set.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .segments import SegmentSet

__all__ = ["IntervalScoreboard", "dependency_arrays"]

_BLOCK = 256  # target block width; blocks split at 2x, merge below 1/8x


class _Cell:
    """Claims over one half-open interval [boundary, next boundary)."""

    __slots__ = ("readers", "writers")

    def __init__(self, readers=(), writers=()):
        self.readers: Set[int] = set(readers)
        self.writers: Set[int] = set(writers)

    def empty(self) -> bool:
        return not self.readers and not self.writers

    def same(self, other: "_Cell") -> bool:
        return self.readers == other.readers and self.writers == other.writers


class _BoundMap:
    """Blocked sorted map: boundary position -> cell covering the interval
    from that boundary to the next. Two-level so mutation memmoves stay
    block-sized; lookups are a bisect over block minima + one in-block."""

    __slots__ = ("pos", "cells", "mins", "n")

    def __init__(self):
        self.pos: List[List[int]] = [[]]
        self.cells: List[List[_Cell]] = [[]]
        self.mins: List[int] = []  # first position per non-empty block
        self.n = 0

    def __len__(self) -> int:
        return self.n

    # -- cursors -----------------------------------------------------------
    def locate(self, p: int) -> Tuple[int, int]:
        """(block, index) of the rightmost boundary <= p; (0, -1) if none."""
        if not self.n:
            return 0, -1
        bi = bisect.bisect_right(self.mins, p) - 1
        if bi < 0:
            return 0, -1
        ii = bisect.bisect_right(self.pos[bi], p) - 1
        return bi, ii

    def nxt(self, bi: int, ii: int) -> Optional[Tuple[int, int]]:
        ii += 1
        pos = self.pos
        while bi < len(pos) and ii >= len(pos[bi]):
            bi += 1
            ii = 0
        return (bi, ii) if bi < len(pos) else None

    def first(self) -> Optional[Tuple[int, int]]:
        return self.nxt(0, -1) if self.n else None

    # -- mutation ----------------------------------------------------------
    def _insert_at(self, bi: int, ii: int, p: int, cell: _Cell) -> None:
        ps, cs = self.pos[bi], self.cells[bi]
        ps.insert(ii, p)
        cs.insert(ii, cell)
        self.n += 1
        if self.n == 1:
            self.mins.append(p)
        elif ii == 0:
            self.mins[bi] = p
        if len(ps) > 2 * _BLOCK:
            half = len(ps) // 2
            self.pos.insert(bi + 1, ps[half:])
            del ps[half:]
            self.cells.insert(bi + 1, cs[half:])
            del cs[half:]
            self.mins.insert(bi + 1, self.pos[bi + 1][0])

    def ensure(self, p: int) -> None:
        """Ensure a boundary at ``p``. A fresh boundary splits its covering
        cell (the new cell inherits copies of the claims); a boundary ahead
        of every existing one starts an unclaimed cell."""
        bi, ii = self.locate(p)
        if ii >= 0 and self.pos[bi][ii] == p:
            return
        if ii < 0:
            self._insert_at(0, 0, p, _Cell())
        else:
            c = self.cells[bi][ii]
            self._insert_at(bi, ii + 1, p, _Cell(c.readers, c.writers))

    def delete(self, bi: int, ii: int) -> None:
        ps, cs = self.pos[bi], self.cells[bi]
        del ps[ii]
        del cs[ii]
        self.n -= 1
        if not ps:
            if len(self.pos) > 1:
                del self.pos[bi]
                del self.cells[bi]
                del self.mins[bi]
            else:
                self.mins.clear()
            return
        self.mins[bi] = ps[0]
        # Fold a dwindled block into its successor so deletions cannot
        # fragment the structure into thousands of near-empty blocks.
        if len(ps) < _BLOCK // 8 and bi + 1 < len(self.pos) \
                and len(ps) + len(self.pos[bi + 1]) <= 2 * _BLOCK:
            self.pos[bi + 1][:0] = ps
            self.cells[bi + 1][:0] = cs
            self.mins[bi + 1] = self.pos[bi + 1][0]
            del self.pos[bi]
            del self.cells[bi]
            del self.mins[bi]

    def prev_cell(self, bi: int, ii: int) -> Optional[_Cell]:
        if ii > 0:
            return self.cells[bi][ii - 1]
        if bi > 0:
            return self.cells[bi - 1][-1]
        return None


class IntervalScoreboard:
    """Per-interval last-writers/active-readers tracking (module docstring).

    ``insert(tid, reads, writes)`` probes the claims its segments touch and
    returns the exact RAW/WAR/WAW upstream tid set, then registers the
    task's own claims; ``retire(tid)`` removes exactly those claims. The
    address universe is the virtual space of ``core.buffers`` — any int
    half-open intervals work.
    """

    __slots__ = ("_map", "_claims", "probe_cells", "inserted", "retired")

    def __init__(self) -> None:
        self._map = _BoundMap()
        # tid -> (read pairs, write pairs) as registered (coalesced).
        self._claims: Dict[int, Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]] = {}
        self.probe_cells = 0  # cells inspected by probes (the Table II unit)
        self.inserted = 0
        self.retired = 0

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._claims)

    def __contains__(self, tid: int) -> bool:
        return tid in self._claims

    @property
    def boundaries(self) -> int:
        """Live boundary count — O(live claims), the structure-size bound
        long sessions rely on (retire coalesces its own claims away)."""
        return len(self._map)

    # -- probe / insert ----------------------------------------------------
    def _pairs(self, segs: SegmentSet) -> List[Tuple[int, int]]:
        return [(int(s), int(e))
                for s, e in zip(segs.starts, segs.ends) if s < e]

    def probe(self, reads: SegmentSet, writes: SegmentSet) -> Set[int]:
        """Exact upstream set for a task with these segments, without
        registering any claims: RAW (reads vs writers) | WAR (writes vs
        readers) | WAW (writes vs writers)."""
        return self._probe(self._pairs(reads.coalesced()),
                           self._pairs(writes.coalesced()))

    def probe_writers(self, reads: SegmentSet) -> Set[int]:
        """RAW-only probe: active tasks whose WRITE claims overlap the given
        read segments, without registering anything. The mesh admission
        plane uses this to find the true data-flow upstreams of an incoming
        task (the producers whose outputs it consumes) — the placement
        signal — separately from the full RAW/WAR/WAW hazard set that
        decides sub-epoch barriers."""
        return self._probe(self._pairs(reads.coalesced()), [])

    def _probe(self, reads, writes) -> Set[int]:
        m = self._map
        up: Set[int] = set()
        if not m.n:
            return up
        probes = 0
        for pairs, include_readers in ((writes, True), (reads, False)):
            for ss, ee in pairs:
                bi, ii = m.locate(ss)
                if ii >= 0:
                    # the cell containing ss overlaps iff it extends past ss
                    cur = m.nxt(bi, ii)
                    if cur is None or m.pos[cur[0]][cur[1]] > ss:
                        c = m.cells[bi][ii]
                        probes += 1
                        up |= c.writers
                        if include_readers:
                            up |= c.readers
                else:
                    cur = m.first()
                # every further cell starts inside (ss, ee): all overlap
                while cur is not None:
                    b, i = cur
                    if m.pos[b][i] >= ee:
                        break
                    c = m.cells[b][i]
                    probes += 1
                    up |= c.writers
                    if include_readers:
                        up |= c.readers
                    cur = m.nxt(b, i)
        self.probe_cells += probes
        return up

    def insert(self, tid: int, reads: SegmentSet, writes: SegmentSet) -> Set[int]:
        """Probe + claim: returns the exact upstream tid set among active
        (inserted, not yet retired) tasks, then registers ``tid``'s own
        read/write interval claims (coalesced)."""
        if tid in self._claims:
            raise ValueError(f"task {tid} is already on the scoreboard")
        rp = self._pairs(reads.coalesced())
        wp = self._pairs(writes.coalesced())
        upstream = self._probe(rp, wp)
        m = self._map
        for pairs, attr in ((rp, "readers"), (wp, "writers")):
            for ss, ee in pairs:
                m.ensure(ss)
                m.ensure(ee)
                cur = m.locate(ss)  # exact boundary at ss
                while cur is not None:
                    b, i = cur
                    if m.pos[b][i] >= ee:
                        break
                    getattr(m.cells[b][i], attr).add(tid)
                    cur = m.nxt(b, i)
        self._claims[tid] = (rp, wp)
        self.inserted += 1
        return upstream

    # -- retire ------------------------------------------------------------
    def retire(self, tid: int) -> None:
        """Remove exactly ``tid``'s interval claims and coalesce cells that
        became indistinguishable from their neighbour."""
        claims = self._claims.pop(tid, None)
        if claims is None:
            raise KeyError(f"task {tid} is not on the scoreboard")
        rp, wp = claims
        m = self._map
        for pairs, attr in ((rp, "readers"), (wp, "writers")):
            for ss, ee in pairs:
                cur = m.locate(ss)
                while cur is not None:
                    b, i = cur
                    if m.pos[b][i] >= ee:
                        break
                    getattr(m.cells[b][i], attr).discard(tid)
                    cur = m.nxt(b, i)
        for ss, ee in rp + wp:
            self._coalesce(ss, ee)
        self.retired += 1

    def _coalesce(self, ss: int, ee: int) -> None:
        """Drop boundaries in [ss, ee] whose cell equals its predecessor
        (or is an unclaimed leading cell). Positions, not cursors: each
        candidate is re-located so deletions cannot invalidate the walk."""
        m = self._map
        candidates: List[int] = []
        cur = m.locate(ss)
        if cur[1] < 0:
            cur = m.first()
        while cur is not None:
            p = m.pos[cur[0]][cur[1]]
            if p > ee:
                break
            if p >= ss:
                candidates.append(p)
            cur = m.nxt(*cur)
        for p in candidates:
            bi, ii = m.locate(p)
            if ii < 0 or m.pos[bi][ii] != p:
                continue  # already merged away
            cell = m.cells[bi][ii]
            prev = m.prev_cell(bi, ii)
            if prev is None:
                if cell.empty():
                    m.delete(bi, ii)
            elif cell.same(prev):
                m.delete(bi, ii)


def dependency_arrays(tasks: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Exact intra-batch dependency structure as dense device operands.

    Inserting ``tasks`` in the given (program) order into a fresh
    scoreboard yields, for each task, the exact RAW/WAR/WAW upstream set
    among its predecessors in the batch — the same edges the live window
    tracks, restricted to this batch. Returned in the layout the
    ready-queue lowering consumes (DESIGN §2 A3):

    * ``indeg`` — ``[n] int32``, the per-task remaining-dependency counter
      initial values (number of in-batch upstreams);
    * ``dep_tbl`` — ``[n, max_out] int32`` forward edges: row *i* lists
      the batch positions that depend on task *i*, padded with the
      sentinel ``n`` (``max_out`` >= 1 so the table is never 0-wide).

    Positions index into ``tasks``; retiring position *i* on device
    decrements ``remaining[dep_tbl[i]]`` (the sentinel lands in a trash
    slot) and zero-crossings join the ready ring.
    """
    n = len(tasks)
    board = IntervalScoreboard()
    pos = {t.tid: i for i, t in enumerate(tasks)}
    out_edges: List[List[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, np.int32)
    for i, t in enumerate(tasks):
        ups = board.insert(t.tid, t.read_segments, t.write_segments)
        indeg[i] = len(ups)
        for up in ups:
            out_edges[pos[up]].append(i)
    max_out = max((len(e) for e in out_edges), default=0)
    dep_tbl = np.full((n, max(max_out, 1)), n, np.int32)
    for i, edges in enumerate(out_edges):
        for j, d in enumerate(sorted(edges)):
            dep_tbl[i, j] = d
    return indeg, dep_tbl
