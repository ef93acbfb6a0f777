"""Binary-counter ladder of sorted runs — the shared core of
stream-sorted accumulation (see table.compactor and dist.sharded).

Arriving raw plane tuples accumulate in `pending`; once `chunk` lanes
are buffered they are sliced off, sorted (hidden under host ingest,
which leaves the device idle), and carry-merged with any equal-size
run like a binary counter increment — so at most one run per power of
two ever exists and every merge is between equal sizes.

`planes()` folds the whole state into ONE sorted tuple: the sub-chunk
tail is sentinel-padded to a power of two and sorted, then every run
merges smallest-first (a smaller `cur` sentinel-pads up to its partner
— sentinels sort last, so padding costs one concat, not merge stages).
The fold replaces the ladder with the result — freeing the source runs
(a 2^28-lane stream would otherwise keep ~2x the planes alive after
finalization) — but first SLICES the result down to
max(min_pad, next_pow2(raw lanes added)): every real key sorts before
the pad sentinels, so the slice only drops padding, and it is what
keeps interleaved add/fold cycles from compounding (re-laddering the
padded result unsliced would re-merge it one power of two larger each
cycle, growing resident planes without bound relative to the data).

The reference has no analog (khashl inserts in place as it reads,
kc-c4.c:116-128); this is the sort-based engine's form
of "insertion overlaps reading".

Callers parameterize the plane-tuple mechanics (flat (n,) planes for
the single-chip compactor; per-device (D, S, L) planes under shard_map
for the mesh engine) via five callables; the carry/fold invariants live
here once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

Planes = Tuple  # tuple of same-shaped arrays; comparisons use them all


class StreamLadder:
    def __init__(
        self,
        chunk: int,
        min_pad: int,
        sort_fn: Callable[[Planes], Planes],
        merge_fn: Callable[[Planes, Planes], Planes],
        pad_fn: Callable[[Planes, int], Planes],
        concat_fn: Callable[[List[Planes]], Planes],
        slice_fn: Callable[[Planes, int, Optional[int]], Planes],
        size_fn: Callable[[Planes], int],
        on_push: Optional[Callable[[Planes], None]] = None,
    ):
        self.chunk = chunk
        self.min_pad = min_pad
        self._sort = sort_fn
        self._merge = merge_fn
        self._pad = pad_fn
        self._concat = concat_fn
        self._slice = slice_fn
        self._size = size_fn
        # called with each freshly-sorted chunk: engines hook dispatch
        # backpressure here (without it, a fast reader can enqueue every
        # chunk's sort+merge before the device runs any, holding all
        # their buffers at once — observed as a device OOM at 256 Mbases)
        self._on_push = on_push
        self.pending: List[Planes] = []
        self.pending_lanes = 0
        self.data_lanes = 0  # raw lanes ever added (bounds the fold size)
        self.ladder: dict = {}  # log2(run lanes) -> sorted planes
        self._merged: Optional[Planes] = None

    def __bool__(self) -> bool:
        return bool(self.pending or self.ladder or self._merged is not None)

    def add(self, planes: Planes) -> None:
        self._merged = None
        self.pending.append(planes)
        self.pending_lanes += self._size(planes)
        self.data_lanes += self._size(planes)
        while self.pending_lanes >= self.chunk:
            cat = (self.pending[0] if len(self.pending) == 1
                   else self._concat(self.pending))
            self.pending_lanes -= self.chunk
            self.pending = (
                [self._slice(cat, self.chunk, None)]
                if self.pending_lanes else []
            )
            run = self._sort(self._slice(cat, 0, self.chunk))
            if self._on_push is not None:
                self._on_push(run)
            self._push(run)

    def _push(self, planes: Planes) -> None:
        lv = self._size(planes).bit_length() - 1  # sizes are powers of two
        while lv in self.ladder:
            planes = self._merge(self.ladder.pop(lv), planes)
            lv += 1
        self.ladder[lv] = planes

    def planes(self) -> Planes:
        """The whole state as one sorted plane tuple (cached until the
        next add; replaces the ladder with the size-bounded result —
        see module docstring)."""
        assert self, "planes() on an empty ladder"
        if self._merged is not None:
            return self._merged
        runs = []
        if self.pending:
            cat = (self.pending[0] if len(self.pending) == 1
                   else self._concat(self.pending))
            n = self._size(cat)
            target = max(self.min_pad, 1 << max(0, (n - 1).bit_length()))
            runs.append(self._sort(self._pad(cat, target)))
        runs.extend(self.ladder.values())
        runs.sort(key=self._size)
        cur = runs[0]
        for r in runs[1:]:
            # ladder sizes are distinct powers >= chunk and the tail is
            # <= chunk, so ascending order keeps size(cur) <= size(r)
            cur = self._merge(self._pad(cur, self._size(r)), r)
        # bound, then re-ladder: lanes past next_pow2(data_lanes) can
        # only hold pad sentinels (every real key sorts before them)
        bound = max(self.min_pad,
                    1 << max(0, (self.data_lanes - 1).bit_length()))
        if self._size(cur) > bound:
            cur = self._slice(cur, 0, bound)
        self.pending, self.pending_lanes = [], 0
        self.ladder = {self._size(cur).bit_length() - 1: cur}
        self._merged = cur
        return cur

    def clear(self) -> None:
        self.pending, self.pending_lanes = [], 0
        self.data_lanes = 0
        self.ladder, self._merged = {}, None
