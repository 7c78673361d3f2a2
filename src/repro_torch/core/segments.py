"""Memory segment algebra — the dependency primitive of ACS.

The paper (Fig 13, Algorithm 1) detects inter-kernel dependencies by
checking overlap between the *write segments* of a newly arriving kernel
and the *read+write segments* of every kernel already in the scheduling
window (and vice versa: its reads against their writes — RAW, WAR and WAW
hazards all serialize).

A segment is a half-open interval ``[start, start+size)`` in a virtual
device address space (see ``buffers.py``). Overlap check is the classic
``start_1 < end_2 and end_1 > start_2`` from Algorithm 1.

Two implementations are provided:

* ``segments_overlap`` / ``any_overlap`` — scalar reference, used by the
  property tests as the oracle.
* ``SegmentSet`` — a small-array numpy representation enabling vectorized
  window-wide checks (the paper budgets ~0.4–1.6 us per check, Table II).

The vectorized whole-window scan (``window_upstreams`` / ``StackedWindow``)
is O(window x segments^2) per insertion, which caps usable window sizes
around the paper's N=32. The live dependency authority is the incremental
``core.scoreboard.IntervalScoreboard`` (O(segments x log intervals) per
insertion); the pairwise scan is kept as the oracle the scoreboard is held
against, as in the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Segment",
    "SegmentSet",
    "segments_overlap",
    "any_overlap",
    "depends_on",
    "window_upstreams",
    "StackedWindow",
    "pairwise_window_replay",
]


@dataclasses.dataclass(frozen=True)
class Segment:
    """Half-open address interval ``[start, start + size)``."""

    start: int
    size: int

    def __post_init__(self) -> None:
        if self.size < 0:
            raise ValueError(f"segment size must be >= 0, got {self.size}")

    @property
    def end(self) -> int:
        return self.start + self.size

    def overlaps(self, other: "Segment") -> bool:
        return segments_overlap(self, other)


def segments_overlap(a: Segment, b: Segment) -> bool:
    """Algorithm 1 inner test: half-open interval intersection.

    Empty segments (size 0) contain no addresses and never overlap — the
    strict inequalities only guarantee this when both intervals are
    non-empty, so guard explicitly.
    """
    if a.size == 0 or b.size == 0:
        return False
    return a.start < b.end and a.end > b.start


def any_overlap(xs: Iterable[Segment], ys: Sequence[Segment]) -> bool:
    """True iff any segment in ``xs`` overlaps any segment in ``ys``.

    O(|xs|*|ys|) scalar loop — the oracle the vectorized path is tested
    against (and a direct transcription of Algorithm 1's double loop).
    """
    for a in xs:
        for b in ys:
            if segments_overlap(a, b):
                return True
    return False


class SegmentSet:
    """Vectorized set of segments as parallel (start, end) numpy arrays.

    The window module holds one ``SegmentSet`` per kernel for its reads and
    one for its writes; a dependency check between a window-resident kernel
    and an incoming kernel is then 3 vectorized interval intersections
    (W_new x RW_old, R_new x W_old covered by RW_new x W_old + W_new x R_old).
    """

    __slots__ = ("starts", "ends", "_coalesced")

    def __init__(self, segments: Sequence[Segment] | None = None):
        if segments:
            self.starts = np.asarray([s.start for s in segments], dtype=np.int64)
            self.ends = np.asarray([s.end for s in segments], dtype=np.int64)
        else:
            self.starts = np.empty((0,), dtype=np.int64)
            self.ends = np.empty((0,), dtype=np.int64)
        self._coalesced: "SegmentSet | None" = None

    @classmethod
    def from_arrays(cls, starts: np.ndarray, ends: np.ndarray) -> "SegmentSet":
        out = cls()
        out.starts = np.asarray(starts, dtype=np.int64)
        out.ends = np.asarray(ends, dtype=np.int64)
        return out

    def __len__(self) -> int:
        return int(self.starts.shape[0])

    def __iter__(self):
        for s, e in zip(self.starts, self.ends):
            yield Segment(int(s), int(e - s))

    def union(self, other: "SegmentSet") -> "SegmentSet":
        return SegmentSet.from_arrays(
            np.concatenate([self.starts, other.starts]),
            np.concatenate([self.ends, other.ends]),
        )

    def coalesced(self) -> "SegmentSet":
        """Canonical form: sorted, empty segments dropped, adjacent or
        overlapping intervals merged. The covered address set — and hence
        every hazard verdict — is unchanged, but a task touching many
        contiguous row views of one buffer registers ONE scoreboard claim
        instead of one per row, cutting probe counts and boundary churn.
        Cached (segment sets are de facto immutable once built); returns
        ``self`` when already canonical."""
        if self._coalesced is not None:
            return self._coalesced
        n = len(self)
        if n == 0:
            self._coalesced = self
            return self
        starts, ends = self.starts, self.ends
        if bool(np.all(starts < ends)) and (
            n == 1 or bool(np.all(starts[1:] > ends[:-1]))
        ):
            self._coalesced = self  # already sorted, non-empty, disjoint
            return self
        keep = starts < ends
        ss, ee = starts[keep], ends[keep]
        order = np.argsort(ss, kind="stable")
        ss, ee = ss[order], ee[order]
        out_s: list = []
        out_e: list = []
        for s, e in zip(ss, ee):
            if out_e and s <= out_e[-1]:
                if e > out_e[-1]:
                    out_e[-1] = e
            else:
                out_s.append(s)
                out_e.append(e)
        merged = SegmentSet.from_arrays(
            np.asarray(out_s, dtype=np.int64), np.asarray(out_e, dtype=np.int64)
        )
        merged._coalesced = merged
        self._coalesced = merged
        return merged

    def intersects(self, other: "SegmentSet") -> bool:
        """Vectorized all-pairs interval overlap (broadcasted Algorithm 1)."""
        if len(self) == 0 or len(other) == 0:
            return False
        # (n, 1) vs (1, m) broadcast; tiny n*m for window-scale sets.
        # Empty segments (start == end) must not report overlap.
        return bool(
            np.any(
                (self.starts[:, None] < other.ends[None, :])
                & (self.ends[:, None] > other.starts[None, :])
                & (self.ends[:, None] > self.starts[:, None])
                & (other.ends[None, :] > other.starts[None, :])
            )
        )


class StackedWindow:
    """Pre-stacked (starts, ends, owner) arrays for a window's resident
    read and write segments: one broadcasted interval pass checks an
    incoming kernel against the whole window (Table II fast path).

    Demoted from the production dependency path to the *pairwise oracle*:
    the live window now maintains an incremental interval scoreboard
    (``core.scoreboard``), and this all-pairs form is what the scoreboard's
    upstream sets are property-tested against — plus the baseline leg of
    ``benchmarks/bench_depcheck.py`` showing where the O(window) scan
    stopped scaling."""

    __slots__ = ("n", "rs", "re", "own_r", "ws", "we", "own_w")

    def __init__(self, resident_reads: Sequence[SegmentSet],
                 resident_writes: Sequence[SegmentSet]):
        self.n = len(resident_reads)
        if self.n == 0:
            z = np.empty(0, np.int64)
            self.rs = self.re = self.ws = self.we = z
            self.own_r = self.own_w = z
            return
        self.rs = np.concatenate([r.starts for r in resident_reads])
        self.re = np.concatenate([r.ends for r in resident_reads])
        self.ws = np.concatenate([w.starts for w in resident_writes])
        self.we = np.concatenate([w.ends for w in resident_writes])
        self.own_r = np.concatenate(
            [np.full(len(r), i) for i, r in enumerate(resident_reads)]
        )
        self.own_w = np.concatenate(
            [np.full(len(w), i) for i, w in enumerate(resident_writes)]
        )

    def check(self, reads_new: SegmentSet, writes_new: SegmentSet) -> np.ndarray:
        """Boolean upstream mask over residents (RAW | WAR | WAW)."""
        n = self.n
        if n == 0:
            return np.zeros(0, dtype=bool)

        def hits(starts_a, ends_a, starts_b, ends_b, owners):
            if len(starts_a) == 0 or len(starts_b) == 0:
                return np.zeros(n, dtype=bool)
            m = (
                (starts_a[:, None] < ends_b[None])
                & (ends_a[:, None] > starts_b[None])
                & (ends_a[:, None] > starts_a[:, None])
                & (ends_b[None] > starts_b[None])
            ).any(axis=0)
            out = np.zeros(n, dtype=bool)
            np.logical_or.at(out, owners[m], True)
            return out

        dep = hits(reads_new.starts, reads_new.ends, self.ws, self.we, self.own_w)
        dep |= hits(writes_new.starts, writes_new.ends, self.rs, self.re, self.own_r)
        dep |= hits(writes_new.starts, writes_new.ends, self.ws, self.we, self.own_w)
        return dep


def window_upstreams(
    reads_new: SegmentSet,
    writes_new: SegmentSet,
    resident_reads: Sequence[SegmentSet],
    resident_writes: Sequence[SegmentSet],
) -> np.ndarray:
    """Vectorized whole-window check (stack + one broadcasted pass).

    The seed window called this per insertion; it is now the oracle the
    scoreboard path is asserted bit-identical against."""
    return StackedWindow(resident_reads, resident_writes).check(
        reads_new, writes_new
    )


def pairwise_window_replay(tasks, window_size: int):
    """Oracle replay of the seed scheduling window: fill each vacancy by
    dep-checking the incoming task against ALL residents via the
    whole-window scan, then drain in waves of dependency-free residents.

    Returns the wave schedule as lists of tids. This is the single shared
    copy of the demoted pairwise dependency logic: the scoreboard property
    tests assert the production window's schedule equals this replay
    bit-for-bit, and ``benchmarks/bench_window_size.py`` times it to show
    where the O(window x segments^2) path stopped scaling. ``tasks`` need
    only ``tid``/``read_segments``/``write_segments``.
    """
    import collections

    fifo = collections.deque(tasks)
    resident: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()

    def fill():
        while fifo and len(resident) < window_size:
            t = fifo.popleft()
            tids = list(resident)
            mask = window_upstreams(
                t.read_segments, t.write_segments,
                [resident[x][0].read_segments for x in tids],
                [resident[x][0].write_segments for x in tids],
            )
            resident[t.tid] = (t, {x for x, hit in zip(tids, mask) if hit})

    fill()
    waves = []
    while resident:
        ready = [x for x, (_, up) in resident.items() if not up]
        if not ready:
            raise RuntimeError("pairwise replay stalled")
        waves.append(ready)
        for x in ready:
            del resident[x]
        for _, up in resident.values():
            up.difference_update(ready)
        fill()
    return waves


def depends_on(
    reads_new: SegmentSet,
    writes_new: SegmentSet,
    reads_old: SegmentSet,
    writes_old: SegmentSet,
) -> bool:
    """True iff the *new* kernel must wait for the *old* kernel.

    Hazards (paper §III-C: "checking for overlaps between read segments and
    write segments"):
      RAW: new reads  ∩ old writes
      WAR: new writes ∩ old reads
      WAW: new writes ∩ old writes
    """
    return (
        reads_new.intersects(writes_old)
        or writes_new.intersects(reads_old)
        or writes_new.intersects(writes_old)
    )
