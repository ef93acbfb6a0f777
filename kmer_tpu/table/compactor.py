"""Sort-based k-mer count engine ("compactor") — the device count table.

Why not a hash table: the reference's khashl tables are a CPU-cache
design built on random access; the data-parallel equivalent is sort +
segment reduction, the same shift KMC made over jellyfish on CPUs
(SURVEY.md §6 table).

Operation:
  add_batch    — append the batch's (hi, lo) key planes (invalid lanes
                 pre-mapped to the all-ones sentinel) to a device-
                 resident run list.  O(1) work per batch beyond
                 extraction.
  compact      — fold all runs into one (keys, counts) compacted run
                 (giant 2-key sort + segment sums + compaction *by
                 sort*, no scatters).  Triggered on a memory budget or
                 at finalization.
  hist         — histogram of per-key total counts, restricted to
                 counts in [min_keep, max] (one scatter-add).
  counts_for   — counts of an explicit query key set (sort-join).

All count semantics match sequential insertion: total multiplicity
min(c, max_count) equals the reference's gated saturating increments
(kc-c2.c:71, kc-c4.c:126).
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import segops
from ..kernels import u64 as u
from ..utils.cli import env_flag

I32 = jnp.int32
U32 = jnp.uint32
SENT = jnp.uint32(0xFFFFFFFF)

# stream-sorted mode: blocks are folded into sorted runs of this many
# lanes as they arrive (the sorts can hide under host->device ingest),
# and finalization pays only a bitonic merge cascade (kernels/bitonic.py)
# instead of the one giant sort.  The reference's analog is insertion
# overlapping reading (kc-c4.c:130-179 kt_pipeline); there is no
# reference analog of the merge itself (khashl inserts in place).
_STREAM_CHUNK = 1 << 24
_STREAM_MIN = 1 << 16

# Default accumulation mode of every engine: off.  `ktc kc-c4` at 256
# Mbases took ~3 s longer per run on the card with it on: each process
# traces and loads the ladder's extra programs, while the shorter
# finalization it buys is within the spread of a warm pass
# (scripts/ab_kernels.py; PERF.md).
STREAM_SORTED_DEFAULT = False


def stream_sorted_default() -> bool:
    """Whether engines stream-sort arriving blocks.
    KMER_TPU_STREAM_SORT=1/0 overrides STREAM_SORTED_DEFAULT."""
    return env_flag("KMER_TPU_STREAM_SORT", STREAM_SORTED_DEFAULT)


@jax.jit
def _sort_run2(hi, lo):
    return jax.lax.sort((hi, lo), num_keys=2)


@jax.jit
def _sort_run1(lo):
    return jax.lax.sort(lo)


def _sort_kl(hi, lo, payloads=(), extra_keys=0, one_plane=False):
    """Sort by (key, payloads) where key is (hi, lo) or just lo when
    one_plane (keys < 2^31, so the hi plane is all zero except sentinel
    lanes and need not be sorted — half the comparator work and one
    plane less of data movement).  extra_keys payload planes directly
    after the key also participate in the comparison (e.g. the
    query-after-data tag).  Returns (hi_s, lo_s, payloads_s)."""
    if one_plane:
        out = jax.lax.sort((lo,) + tuple(payloads), num_keys=1 + extra_keys)
        lo_s = out[0]
        hi_s = jnp.where(lo_s == SENT, SENT, jnp.uint32(0))
        return hi_s, lo_s, out[1:]
    out = jax.lax.sort((hi, lo) + tuple(payloads), num_keys=2 + extra_keys)
    return out[0], out[1], out[2:]


def _size_class(n: int, quantum: int = 1 << 20) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def prep_queries(query_hi, query_lo, one_plane: bool):
    """Host-side query prep shared by counts_for implementations
    (single-chip and sharded): dedup (the device sort-joins require
    unique query keys), split to u32 planes, sentinel-pad to a size
    class.  Returns (qhi, qlo, q, inverse) — slice the device result to
    q and index with inverse to restore caller order/duplicates."""
    packed = (np.asarray(query_hi, np.uint64) << np.uint64(32)) | np.asarray(
        query_lo, np.uint64
    )
    uniq, inverse = np.unique(packed, return_inverse=True)
    qhi = (uniq >> np.uint64(32)).astype(np.uint32)
    qlo = (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if one_plane:
        assert not qhi.any(), (
            "counts_for: query keys exceed the declared key_bits <= 31"
        )
    q = len(qhi)
    qsize = _size_class(q, 1 << 12)
    pad_hi = np.full(qsize, 0xFFFFFFFF, np.uint32)
    pad_lo = np.full(qsize, 0xFFFFFFFF, np.uint32)
    pad_hi[:q] = qhi
    pad_lo[:q] = qlo
    return pad_hi, pad_lo, q, inverse


@partial(jax.jit, donate_argnums=())
def _sentinelize(keys_hi, keys_lo, valid):
    return (
        jnp.where(valid, keys_hi, SENT),
        jnp.where(valid, keys_lo, SENT),
    )


_PAD_QUANTUM = 1 << 23  # large-run shape quantum so jit compiles are reused


def _pad_to(n: int) -> int:
    """Total size to pad a concatenated run to: small size classes for
    small inputs (tests, small files — keeps CPU sorts proportional to
    the data), then multiples of the 8M quantum."""
    for cls in (1 << 16, 1 << 18, 1 << 20, 1 << 22):
        if n <= cls:
            return cls
    return ((n + _PAD_QUANTUM - 1) // _PAD_QUANTUM) * _PAD_QUANTUM


def _concat_runs(runs: List[Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]]):
    """Concatenate (hi, lo, counts) runs, padded with sentinel lanes to a
    shape quantum; raw runs (counts=None) get implicit count 1."""
    n = sum(r[0].size for r in runs)
    pad = _pad_to(n) - n
    pad_hi = jnp.full((pad,), SENT, U32)
    his = jnp.concatenate([r[0] for r in runs] + [pad_hi])
    los = jnp.concatenate([r[1] for r in runs] + [pad_hi])
    any_counts = any(r[2] is not None for r in runs)
    if any_counts:
        cs = jnp.concatenate(
            [
                r[2] if r[2] is not None else jnp.ones_like(r[0], U32)
                for r in runs
            ]
            + [jnp.zeros((pad,), U32)]
        )
    else:
        cs = None
    return his, los, cs


def _presorted_planes(hi, lo, one_plane):
    """Adopt already-sorted planes (stream-sorted mode): one-plane
    callers pass lo twice and the hi plane is derived (it is 0 for data
    keys < 2^31 and all-ones for sentinels)."""
    if one_plane:
        return jnp.where(lo == SENT, SENT, jnp.uint32(0)), lo
    return hi, lo


def hist_core(hi, lo, counts, n_bins, max_count, min_keep, has_counts,
              one_plane=False, pre_sorted=False):
    """Sort everything, reduce counts per key segment, histogram.
    Returns (hist[n_bins] i32, n_distinct i32).  Un-jitted so the mesh
    engine can call it per device inside shard_map
    (kmer_tpu/dist/sharded.py); single-device callers use _hist_impl.

    Weighted runs use modular u32 ends-diff arithmetic (see
    _compact_impl): segment count = csum[this end] - csum[previous end],
    exact regardless of global-total wraps — the ends are compacted by a
    1-key sort first so the diff is between adjacent lanes."""
    n = hi.shape[0]
    pos = jnp.arange(n, dtype=I32)
    if has_counts:
        s_hi, s_lo, (cnt,) = _sort_kl(hi, lo, (counts,), one_plane=one_plane)
        keys = u.U64(s_hi, s_lo)
        csum = jnp.cumsum(cnt.astype(jnp.uint32), dtype=jnp.uint32)
        starts = segops.segment_starts(keys)
        is_end = jnp.concatenate([starts[1:], jnp.ones((1,), jnp.bool_)])
        is_sent = (keys.hi == SENT) & (keys.lo == SENT)
        rank = jnp.where(is_end, pos, I32(0x7FFFFFFF))
        sent_flag = is_sent.astype(U32)
        _, e_csum, e_sent = jax.lax.sort(
            (rank, csum, sent_flag), num_keys=1
        )
        prev = jnp.concatenate([jnp.zeros((1,), U32), e_csum[:-1]])
        n_ends = jnp.sum(is_end.astype(I32))
        seg_count_u = e_csum - prev  # modular, exact per segment
        mask = (
            (pos < n_ends) & (e_sent == 0) & (seg_count_u >= U32(min_keep))
        )
        if max_count is not None:
            seg_count_u = jnp.minimum(seg_count_u, U32(max_count))
        seg_count = jnp.minimum(seg_count_u, U32(n_bins - 1)).astype(I32)
    else:
        if pre_sorted:
            s_hi, s_lo = _presorted_planes(hi, lo, one_plane)
        else:
            s_hi, s_lo, _ = _sort_kl(hi, lo, one_plane=one_plane)
        keys = u.U64(s_hi, s_lo)
        starts = segops.segment_starts(keys)
        start_pos = jax.lax.cummax(jnp.where(starts, pos, I32(0)))
        is_end = jnp.concatenate([starts[1:], jnp.ones((1,), jnp.bool_)])
        seg_count = pos - start_pos + 1
        # remove the sentinel tail: it is exactly the lanes whose key is
        # all-ones *minus* any true all-ones keys, which callers
        # guarantee cannot occur (hash64 output < 2^(2k) <= 2^62 for
        # k <= 31; the k == 32 path collapses keys to 0 instead).
        is_sent = (keys.hi == SENT) & (keys.lo == SENT)
        mask = is_end & ~is_sent & (seg_count >= min_keep)
        if max_count is not None:
            seg_count = jnp.minimum(seg_count, I32(max_count))
    total = segops.histogram(seg_count, mask, n_bins)
    n_distinct = jnp.sum(mask.astype(I32))
    return total, n_distinct


_hist_impl = jax.jit(hist_core, static_argnames=(
    "n_bins", "max_count", "min_keep", "has_counts", "one_plane",
    "pre_sorted"))


class KmerCompactor:
    """Accumulate-and-sort count engine (see module docstring)."""

    # Budget default 2 GiB of raw key planes: compaction transiently
    # peaks near 3x the accumulated run bytes (concat + sort in/out
    # temps, or the stream ladder's fold) on top of previously compacted
    # counted runs.  The 256 Mbase headline (~1.6 GB of planes) streams
    # without a trip; PERF.md says why the default stays fixed rather
    # than scaling with device memory.
    def __init__(self, budget_bytes: int = 2 << 30,
                 key_bits: Optional[int] = None,
                 stream_sorted: bool = False):
        self.runs: List[Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]] = []
        self.budget_bytes = budget_bytes
        self._bytes = 0
        # keys < 2^31 (k <= 15 after hash64) leave the hi plane all-zero:
        # every sort drops to one key plane (half the comparator work)
        self.one_plane = key_bits is not None and key_bits <= 31
        # stream-sorted accumulation (see _STREAM_CHUNK): raw planes fold
        # into sorted pow2 runs as they arrive; a binary-counter "ladder"
        # carry-merges equal-size runs eagerly so the only finalization
        # work left is the top merges + the segment pass.
        self.stream_sorted = bool(stream_sorted)
        from collections import deque

        self._sync_q: "deque" = deque()
        self._sync_window = None  # resolved at first push (env override)
        # time the dispatch thread spent BLOCKED on throttle syncs
        # (device behind the slack window) — engines report it
        # separately from real dispatch so the two are never conflated
        # in a bench breakdown
        self.throttle_wait_s = 0.0
        self.last_n_unique = 0  # distinct keys as of the last compact()
        self.stream = self._make_ladder() if self.stream_sorted else None

    def add_batch(self, keys: u.U64, valid: jnp.ndarray) -> None:
        hi, lo = _sentinelize(keys.hi, keys.lo, valid)
        self.add_raw(hi, lo)

    def add_raw(self, hi: jnp.ndarray, lo: jnp.ndarray) -> None:
        """Append pre-sentinelized key planes (invalid lanes already
        mapped to all-ones)."""
        if self.stream_sorted:
            self._stream_add(hi, lo)
        else:
            self.runs.append((hi, lo, None))
            self._bytes += hi.size * 8
        if self._bytes > self.budget_bytes:
            self.compact()

    # -- stream-sorted accumulation ------------------------------------
    # (carry/fold invariants live in table.stream_ladder, shared with
    # the mesh engine dist.sharded.ShardedSortEngine)

    def _make_ladder(self):
        from .stream_ladder import StreamLadder

        arity = 1 if self.one_plane else 2
        return StreamLadder(
            chunk=_STREAM_CHUNK,
            min_pad=_STREAM_MIN,
            sort_fn=self._sort_planes,
            merge_fn=self._merge_runs,
            pad_fn=self._pad_run,
            concat_fn=lambda runs: tuple(
                jnp.concatenate([r[i] for r in runs]) for i in range(arity)
            ),
            slice_fn=lambda p, a, b: tuple(x[a:b] for x in p),
            size_fn=lambda p: int(p[0].shape[0]),
            on_push=self._throttle_push,
        )

    def _throttle_push(self, planes) -> None:
        """Bound how far dispatch can run ahead of the device in stream
        mode: wait until the chunk sorted `window` chunks ago is ready
        (every queued op holds its buffers, and an unthrottled fast
        reader would run device memory out at bench scale).
        KMER_TPU_THROTTLE_WINDOW sets the slack (default 4 chunks)."""
        if self._sync_window is None:
            try:
                self._sync_window = max(
                    1, int(os.environ.get("KMER_TPU_THROTTLE_WINDOW", "")))
            except ValueError:
                self._sync_window = 4
        # a one-lane slice: waiting on it proves the chunk's sort ran
        # without holding the chunk (the ladder may donate it to a merge)
        self._sync_q.append(planes[0][:1])
        if len(self._sync_q) > self._sync_window:
            import time as _time

            t0 = _time.perf_counter()
            self._sync_q.popleft().block_until_ready()
            self.throttle_wait_s += _time.perf_counter() - t0

    def _stream_add(self, hi, lo):
        # _bytes counts RAW lanes only, as in classic mode: both modes
        # peak near 3x that during finalization (classic: concat + sort
        # in/out temps; stream: ladder + the fold's in/out planes), so
        # the budget threshold means the same thing in either mode
        self.stream.add((lo,) if self.one_plane else (hi, lo))
        self._bytes += int(lo.shape[0]) * (4 if self.one_plane else 8)

    def _sort_planes(self, planes):
        if len(planes) == 1:
            return (_sort_run1(planes[0]),)
        return tuple(_sort_run2(*planes))

    def _merge_runs(self, a, b):
        """Merge two equal-length sorted runs with the bitonic merge
        cascade (kernels/bitonic.py) — only the last log2(n) stages of
        what a fresh sort would redo.  The concatenated temporaries are
        donated (their device memory becomes the output's — the fold
        peaks at multiple GB-scale plane pairs otherwise)."""
        from ..kernels import bitonic

        cat = tuple(jnp.concatenate([x, y]) for x, y in zip(a, b))
        if len(cat) == 1:
            return (bitonic.merge_sorted_halves1_donated(cat[0]),)
        return tuple(bitonic.merge_sorted_halves_donated(cat[0], cat[1]))

    @staticmethod
    def _pad_run(planes, target: int):
        n = planes[0].shape[0]
        if target == n:
            return planes
        pad = jnp.full((target - n,), SENT, U32)
        return tuple(jnp.concatenate([p, pad]) for p in planes)

    def _has_stream_state(self) -> bool:
        return bool(self.stream)

    def _stream_hi_lo(self):
        planes = self.stream.planes()
        lo = planes[-1]
        hi = planes[0] if len(planes) == 2 else lo
        return hi, lo

    def _absorb_stream(self) -> None:
        """Mixed state (counted runs + stream runs): hand the merged
        stream planes to the classic concat+sort path as one raw run."""
        if not (self.stream_sorted and self.stream):
            return
        hi, lo = self._stream_hi_lo()
        if self.one_plane:
            hi = jnp.where(lo == SENT, SENT, jnp.uint32(0))
        self.runs.append((hi, lo, None))
        self.stream.clear()

    def add_counted(self, keys: u.U64, counts: jnp.ndarray) -> None:
        self.runs.append((keys.hi, keys.lo, counts))
        self._bytes += keys.hi.size * 12

    def _plane_hi_lo(self, planes):
        lo = planes[-1]
        hi = planes[0] if len(planes) == 2 else lo
        if self.one_plane:
            hi = jnp.where(lo == SENT, SENT, jnp.uint32(0))
        return hi, lo

    def _compact_stream_piecewise(self) -> None:
        """Budget-trip compaction that never folds the ladder into one
        giant plane pair: each ladder run is already sorted, so it
        compacts on its own (pre_sorted), its raw planes free, and the
        per-run counted results fold with the classic weighted path.
        Bounds the transient peak to ~3x the LARGEST run plus the
        remaining raw runs, instead of ~3x the whole stream."""
        lad = self.stream
        runs = []
        if lad.pending:
            cat = (lad.pending[0] if len(lad.pending) == 1
                   else lad._concat(lad.pending))
            n = lad._size(cat)
            target = max(lad.min_pad, 1 << max(0, (n - 1).bit_length()))
            runs.append(lad._sort(lad._pad(cat, target)))
        runs.extend(lad.ladder.values())
        lad.clear()
        runs.sort(key=lambda p: p[-1].shape[0], reverse=True)
        for planes in runs:
            hi, lo = self._plane_hi_lo(planes)
            out = _compact_impl(hi, lo, hi, False, self.one_plane,
                                pre_sorted=True)
            chi, clo, ccnt, n_unique = out
            nu = int(n_unique)  # sync: prior run's raw planes reclaim
            size = min(_size_class(nu), chi.shape[0])
            self.runs.append((
                jax.lax.dynamic_slice(chi, (0,), (size,)),
                jax.lax.dynamic_slice(clo, (0,), (size,)),
                jax.lax.dynamic_slice(ccnt, (0,), (size,)),
            ))

    def compact(self) -> None:
        """Fold all runs into one (key, count) run via sort; compaction
        (moving segment-end entries to the front) is itself done with a
        sort rather than a scatter.  Stream-sorted state with no counted
        runs compacts straight off the merged planes (no sort at all)
        when the stream is small; past one fold quantum it compacts
        ladder-run-by-run to bound the transient memory peak."""
        if self.stream_sorted and self._has_stream_state():
            if (not self.runs
                    and self.stream.data_lanes <= _STREAM_CHUNK * 2):
                hi, lo = self._stream_hi_lo()
                out = _compact_impl(hi, lo, hi, False, self.one_plane,
                                    pre_sorted=True)
                self.stream.clear()
                self._store_compacted(out)
                return
            self._compact_stream_piecewise()
        if not self.runs:
            return
        hi, lo, cnt = _concat_runs(self.runs)
        has_counts = cnt is not None
        out = _compact_impl(hi, lo, cnt if has_counts else hi, has_counts,
                            self.one_plane)
        self._store_compacted(out)

    def _store_compacted(self, out) -> None:
        chi, clo, ccnt, n_unique = out
        nu = int(n_unique)
        self.last_n_unique = nu  # distinct keys as of this compaction
        size = min(_size_class(nu), chi.shape[0])
        self.runs = [
            (
                jax.lax.dynamic_slice(chi, (0,), (size,)),
                jax.lax.dynamic_slice(clo, (0,), (size,)),
                jax.lax.dynamic_slice(ccnt, (0,), (size,)),
            )
        ]
        # slices beyond nu hold sentinel keys with count 0 -> harmless
        self._bytes = size * 12

    def hist(self, n_bins: int, max_count: Optional[int], min_keep: int = 1):
        """(histogram, n_distinct) over all accumulated keys."""
        pre_sorted = False
        if (self.stream_sorted and self._has_stream_state() and self.runs
                and self.stream.data_lanes > _STREAM_CHUNK * 2):
            # big mixed state: the classic absorb would concat+sort the
            # whole stream alongside the counted runs — compact
            # piecewise first so the final sort sees counted runs only
            self.compact()
        if self.stream_sorted and self._has_stream_state():
            if self.runs:
                self._absorb_stream()  # mixed with counted runs: classic
            else:
                hi, lo = self._stream_hi_lo()
                cnt, has_counts, pre_sorted = None, False, True
        if not pre_sorted:
            if not self.runs:
                return np.zeros(n_bins, np.int64), 0
            hi, lo, cnt = _concat_runs(self.runs)
            has_counts = cnt is not None
        h, nd = _hist_impl(
            hi,
            lo,
            cnt if has_counts else hi,
            n_bins,
            max_count,
            min_keep,
            has_counts,
            self.one_plane,
            pre_sorted,
        )
        if os.environ.get("KMER_TPU_DEBUG"):
            # debug mode (SURVEY.md §5 sanitizer analog): cross-check the
            # one-plane/pre-sorted fast paths against the general
            # two-plane sort-everything one
            h2, nd2 = _hist_impl(
                hi, lo, cnt if has_counts else hi,
                n_bins, max_count, min_keep, has_counts,
                self.one_plane if pre_sorted else False,
            )
            assert np.array_equal(np.asarray(h), np.asarray(h2)) and int(
                nd
            ) == int(nd2), "KMER_TPU_DEBUG: fast-path histogram mismatch"
        return np.asarray(h).astype(np.int64), int(nd)

    def counts_for(self, query_hi: np.ndarray, query_lo: np.ndarray) -> np.ndarray:
        """Total multiplicity of each query key (0 if absent), in query
        order.  Sort-join: queries are tagged to sort after data lanes
        of the same key; counts return to query order via a second sort
        on the query-index payload — no gathers or scatters."""
        pre_sorted = False
        if self.stream_sorted and self._has_stream_state():
            if self.runs:
                self._absorb_stream()  # mixed with counted runs: classic
            else:
                hi, lo = self._stream_hi_lo()
                cnt, has_counts, pre_sorted = None, False, True
        if not pre_sorted:
            if not self.runs:
                return np.zeros(len(query_hi), np.int64)
            hi, lo, cnt = _concat_runs(self.runs)
            has_counts = cnt is not None
        # the device paths require unique query keys (a duplicate would
        # count its twin as data); dedup host-side and expand back
        qhi, qlo, q, inverse = prep_queries(query_hi, query_lo,
                                            self.one_plane)
        out = _counts_for_bs_impl(
            hi, lo, cnt if has_counts else hi, jnp.asarray(qhi),
            jnp.asarray(qlo), has_counts, self.one_plane, pre_sorted,
        )
        if os.environ.get("KMER_TPU_DEBUG"):
            # cross-check the binary-search join against the tag-based
            # sort-join formulations (two independent derivations)
            if has_counts:
                out2 = _counts_for_impl(
                    hi, lo, cnt, jnp.asarray(qhi), jnp.asarray(qlo), True,
                    self.one_plane,
                )
            else:
                dhi = (jnp.where(lo == SENT, SENT, jnp.uint32(0))
                       if (pre_sorted and self.one_plane) else hi)
                out2 = _counts_for_sortjoin_impl(
                    dhi, lo, jnp.asarray(qhi), jnp.asarray(qlo),
                    self.one_plane,
                )
            assert np.array_equal(
                np.asarray(out)[:q], np.asarray(out2)[:q]
            ), "KMER_TPU_DEBUG: counts_for binary-search/sort-join mismatch"
        return np.asarray(out)[:q].astype(np.int64)[inverse]


@partial(jax.jit, static_argnames=("has_counts", "one_plane", "pre_sorted"))
def _compact_impl(hi, lo, cnt, has_counts, one_plane=False, pre_sorted=False):
    n = hi.shape[0]
    pos = jnp.arange(n, dtype=I32)
    if has_counts:
        s_hi, s_lo, (c,) = _sort_kl(hi, lo, (cnt,), one_plane=one_plane)
        keys = u.U64(s_hi, s_lo)
        # modular u32 running sum: a segment's count is the DIFFERENCE of
        # csum at consecutive segment ends, exact mod 2^32 no matter how
        # often the global total wraps (totals beyond 2^32 k-mers are
        # routine at scale; only a single key with >= 2^32 multiplicity
        # would alias, matching the reference's own u32 counters)
        csum = jnp.cumsum(c.astype(jnp.uint32), dtype=jnp.uint32)
    else:
        if pre_sorted:
            s_hi, s_lo = _presorted_planes(hi, lo, one_plane)
        else:
            s_hi, s_lo, _ = _sort_kl(hi, lo, one_plane=one_plane)
        keys = u.U64(s_hi, s_lo)
        csum = None
    starts = segops.segment_starts(keys)
    start_pos = jax.lax.cummax(jnp.where(starts, pos, I32(0)))
    is_end = jnp.concatenate([starts[1:], jnp.ones((1,), jnp.bool_)])
    is_sent = (keys.hi == SENT) & (keys.lo == SENT)
    keep = is_end & ~is_sent
    # compact by sort: keep-lanes get rank = their order, others go last
    rank = jnp.where(keep, pos, I32(0x7FFFFFFF))
    klo = jnp.where(keep, keys.lo, SENT)
    if has_counts:
        pay = csum  # diff adjacent compacted ends below
    else:
        pay = (pos - start_pos + 1).astype(U32)
        pay = jnp.where(keep, pay, U32(0))
    if one_plane:
        _, clo, cpay = jax.lax.sort((rank, klo, pay), num_keys=1)
        chi = jnp.where(clo == SENT, SENT, jnp.uint32(0))
    else:
        khi = jnp.where(keep, keys.hi, SENT)
        _, chi, clo, cpay = jax.lax.sort(
            (rank, khi, klo, pay), num_keys=1
        )
    n_unique = jnp.sum(keep.astype(I32))
    if has_counts:
        prev = jnp.concatenate([jnp.zeros((1,), U32), cpay[:-1]])
        ccnt = jnp.where(pos < n_unique, cpay - prev, U32(0))
    else:
        ccnt = cpay
    return chi, clo, ccnt, n_unique


def _lex_lower_bound(s_hi, s_lo, qhi, qlo):
    """First index i with (s_hi, s_lo)[i] >= (qhi, qlo) lexicographically,
    vectorized over all queries: a fixed-trip binary search whose probes
    are tiny gathers (2 planes x n_queries lanes per step).  The data
    planes stay put — no payload planes ride the sort and no second
    full-size reorder sort is needed (cf. the superseded sort-join tag
    scheme), which is what makes counts_for O(sort(n) + q log n)."""
    n = s_hi.shape[0]
    steps = max(1, n.bit_length())
    low = jnp.zeros(qhi.shape, I32)
    high = jnp.full(qhi.shape, n, I32)

    def body(_, lh):
        low, high = lh
        mid = (low + high) >> 1
        m = jnp.minimum(mid, n - 1)
        mhi = jnp.take(s_hi, m)
        mlo = jnp.take(s_lo, m)
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        # mid == n only once low == high == n (query > every key); the
        # clamped probe re-reads keys[n-1] there and, left unchecked,
        # pushes low past n on every remaining trip — off-by-one for
        # any query equal to the dataset maximum when no sentinel lane
        # follows it (planes sliced to exactly next_pow2(data lanes))
        less = less & (mid < n)
        return jnp.where(less, mid + 1, low), jnp.where(less, high, mid)

    low, _ = jax.lax.fori_loop(0, steps, body, (low, high))
    return low


def _key_succ(qhi, qlo):
    """(qhi, qlo) + 1 as a u64 with carry — the exclusive upper bound of
    a key's segment.  The all-ones sentinel wraps to (0, 0); sentinel
    queries only occur in the size-class padding, whose results are
    sliced away by the caller."""
    nlo = qlo + jnp.uint32(1)
    carry = nlo == 0
    return qhi + carry.astype(U32), nlo


@partial(jax.jit, static_argnames=("one_plane", "pre_sorted"))
def _counts_for_raw_impl(hi, lo, qhi, qlo, one_plane=False, pre_sorted=False):
    """Unweighted fast path: sort the data planes once (the same sort
    hist would do — no tag payload), then binary-search each unique
    query key's segment bounds; count = upper - lower.  q probe rounds
    of 2 tiny gathers replace a payload plane and a full-size reorder
    sort of the superseded sort-join formulation (~1.7x on the 21k-SNP
    vaf bench).  With pre_sorted (stream-sorted mode) the whole join is
    just the binary searches — no full-size work at all."""
    if pre_sorted:
        s_hi, s_lo = _presorted_planes(hi, lo, one_plane)
    else:
        s_hi, s_lo, _ = _sort_kl(hi, lo, one_plane=one_plane)
    lb = _lex_lower_bound(s_hi, s_lo, qhi, qlo)
    nhi, nlo = _key_succ(qhi, qlo)
    ub = _lex_lower_bound(s_hi, s_lo, nhi, nlo)
    return jnp.maximum(ub - lb, 0).astype(U32)


@partial(jax.jit, static_argnames=("has_counts", "one_plane", "pre_sorted"))
def _counts_for_bs_impl(hi, lo, cnt, qhi, qlo, has_counts, one_plane=False,
                        pre_sorted=False):
    """Weighted binary-search join: sort (key, count) planes, one modular
    u32 cumsum, then each query's total = csum[ub-1] - csum[lb-1]
    (exact per segment regardless of global wraps, see _compact_impl)."""
    if not has_counts:
        return _counts_for_raw_impl(hi, lo, qhi, qlo, one_plane, pre_sorted)
    s_hi, s_lo, (c,) = _sort_kl(hi, lo, (cnt,), one_plane=one_plane)
    csum = jnp.cumsum(c.astype(jnp.uint32), dtype=jnp.uint32)

    def csum_before(i):
        # csum[i-1] with csum[-1] == 0
        return jnp.where(i > 0, jnp.take(csum, jnp.maximum(i - 1, 0)),
                         jnp.uint32(0))

    lb = _lex_lower_bound(s_hi, s_lo, qhi, qlo)
    nhi, nlo = _key_succ(qhi, qlo)
    ub = _lex_lower_bound(s_hi, s_lo, nhi, nlo)
    total = csum_before(ub) - csum_before(lb)
    return jnp.where(ub > lb, total, jnp.uint32(0))


@partial(jax.jit, static_argnames=("one_plane",))
def _counts_for_sortjoin_impl(hi, lo, qhi, qlo, one_plane=False):
    """Unweighted tag-based sort-join, retained as the KMER_TPU_DEBUG
    oracle for the binary-search path: every data lane has multiplicity
    1, and query keys are unique, so after sorting (hi, lo, tag) — tag 0
    for data, 1+query_index for queries (queries sort after their data
    segment) — each query lane's count is simply pos - segment_start."""
    n = hi.shape[0]
    q = qhi.shape[0]
    m_hi = jnp.concatenate([hi, qhi])
    m_lo = jnp.concatenate([lo, qlo])
    tag = jnp.concatenate(
        [jnp.zeros((n,), jnp.uint32), 1 + jnp.arange(q, dtype=jnp.uint32)]
    )
    s_hi, s_lo, (s_tag,) = _sort_kl(
        m_hi, m_lo, (tag,), extra_keys=1, one_plane=one_plane
    )
    starts = segops.segment_starts(u.U64(s_hi, s_lo))
    pos = jnp.arange(n + q, dtype=I32)
    start_pos = jax.lax.cummax(jnp.where(starts, pos, I32(0)))
    # count of data lanes before this query lane within its segment:
    # tag==0 lanes sort first within a key; queries are unique per key,
    # so at a query lane every earlier in-segment lane is data.
    data_count = pos - start_pos
    is_q = s_tag > 0
    # return to query order: 1-key sort on the query tag
    _, out = jax.lax.sort(
        (jnp.where(is_q, s_tag, jnp.uint32(0xFFFFFFFF)),
         jnp.where(is_q, data_count, 0)),
        num_keys=1,
    )
    return out[:q]


@partial(jax.jit, static_argnames=("has_counts", "one_plane"))
def _counts_for_impl(hi, lo, cnt, qhi, qlo, has_counts, one_plane=False):
    n = hi.shape[0]
    q = qhi.shape[0]
    # merged key space: data lanes origin 0, query lanes origin 1 (query
    # sorts after equal data keys); payloads: count, query index
    m_hi = jnp.concatenate([hi, qhi])
    m_lo = jnp.concatenate([lo, qlo])
    origin = jnp.concatenate(
        [jnp.zeros((n,), U32), jnp.ones((q,), U32)]
    )
    c = (
        jnp.concatenate([cnt.astype(U32), jnp.zeros((q,), U32)])
        if has_counts
        else jnp.concatenate([jnp.ones((n,), U32), jnp.zeros((q,), U32)])
    )
    qidx = jnp.concatenate(
        [jnp.full((n,), 0x7FFFFFFF, I32), jnp.arange(q, dtype=I32)]
    )
    s_hi, s_lo, (s_orig, s_c, s_qidx) = _sort_kl(
        m_hi, m_lo, (origin, c, qidx), extra_keys=1, one_plane=one_plane
    )
    keys = u.U64(s_hi, s_lo)
    starts = segops.segment_starts(keys)
    csum = jnp.cumsum(s_c, dtype=jnp.uint32)
    # modular ends-diff (see _compact_impl): a query lane is always its
    # segment's last lane (queries are unique and sort after their data),
    # so its key's total = csum[this end] - csum[previous segment's end],
    # exact mod 2^32 regardless of how often the global csum wraps
    pos = jnp.arange(n + q, dtype=I32)
    is_end = jnp.concatenate([starts[1:], jnp.ones((1,), jnp.bool_)])
    at_query = s_orig == 1
    rank = jnp.where(is_end, pos, I32(0x7FFFFFFF))
    eq_idx = jnp.where(at_query & is_end, s_qidx, I32(0x7FFFFFFF))
    _, e_csum, e_qidx = jax.lax.sort((rank, csum, eq_idx), num_keys=1)
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), e_csum[:-1]])
    seg_count = (e_csum - prev).astype(I32)
    # return to query order: sort by query index, take the first q lanes
    _, out = jax.lax.sort((e_qidx, seg_count), num_keys=1)
    return out[:q]
