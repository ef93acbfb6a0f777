"""Deferred exact yak admission — the per-batch bloom bookkeeping
without per-block bloom work.

The reference's pass-1 stderr lines (`[M] processed N sequences; M
distinct k-mers in the hash table`, /root/reference/yak-count.c:427)
need, per pipeline batch, the cumulative number of distinct keys the
bloom-gated table has ADMITTED (yak_ch_insert_list gates a key's entry
on `yak_bf_insert(...) == n_hash`, yak-count.c:162-163, with the bloom
probed sequentially per k-mer, yak-count.c:91-108).

Simulating that eagerly costs ~13x the count itself (round-4 verdict):
per block, the sequential test-and-set reconstruction pays two sorts +
gathers + scatters over n_hashes x lanes against a 2^b-byte bits
array, and the running distinct total pays a full compaction per
batch.  This module replaces all of it with a DEFERRED formulation
built on two exact identities:

1. **Only first occurrences matter to the bloom.**  Every occurrence
   of key K probes the same bits, so "bit b is set before lane l" is
   equivalent to "some key K' whose FIRST occurrence lane l1(K') < l
   probes b".  The bits array disappears: admission verdicts reduce to
   per-bit comparisons between first-occurrence lanes.
2. **A key's second occurrence is always admitted** (its own first
   occurrence set all its bits), so key K enters the table at
     l1(K)  if all its probe bits were set by earlier keys'
              first occurrences (the bloom false-positive case), else
     l2(K)  if K occurs at least twice, else never.

So the streaming side only records (key_hi, key_lo, global lane index)
— zero device work per block beyond a lazy iota — and finalization
computes per-batch admitted-distinct totals with a handful of sorts:

  a. fold the stream to (key -> first two occurrence lanes) with a
     3-key sort + keep-first-2-per-segment compaction (FirstSeen-
     Compactor; budget trips bound device memory like
     table.compactor);
  b. one (bit, l1) sort over n_hashes x n_keys probe entries resolves
     every first-occurrence lane's false-positive verdict: an entry is
     "pre-set" iff an entry with the same bit and a strictly smaller
     l1 exists (lane indices are unique per key, and a key's own
     duplicate probes — possible only at h2 == 256, multiplicity <= 2
     — carry equal l1, so a 2-step unrolled neighbor rule needs no
     scan, gather, or scatter);
  c. bucket each key's admission lane against the recorded batch
     boundaries and histogram (one scatter-add).

The per-batch totals are byte-identical to the sequential reference
(pinned by tests/test_golden_counters.py::test_yak_stderr_progress_
parity); the [M] lines are emitted when counting finishes rather than
live — the one observable difference is timing, not content.

Lane indices are u32: a single run is limited to 2^32 - 2^26 extracted
lanes (~4.2 Gbases); beyond that ingest raises with a pointer to
KMER_TPU_FAST_YAK=1 (which skips the simulation entirely).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import bloom
from ..kernels import segops
from ..kernels import u64 as u
from ..table.compactor import _pad_to, _size_class

I32 = jnp.int32
U32 = jnp.uint32
SENT = jnp.uint32(0xFFFFFFFF)
_MAX_LANES = (1 << 32) - (1 << 26)  # u32 index headroom
_BOUNDS_CLASSES = (32, 128, 1024, 8192)  # padded batch-count classes


def _first2_keep_core(s_hi, s_lo, s_idx):
    """Keep each key's first TWO entries of (key, lane)-sorted planes,
    compacted to the front by a rank sort (compaction by sort, no
    scatter — the table.compactor idiom).  Input may mix raw lanes and
    previously compacted first-2 lanes: keeping the first two of the
    merged order is exactly the first two overall, because every
    surviving entry is a genuine occurrence lane.  Returns
    (hi, lo, idx, n_keep) with the tail sentinel-filled."""
    n = s_hi.shape[0]
    pos = jnp.arange(n, dtype=I32)
    starts = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
    ])
    second = jnp.concatenate([jnp.zeros((1,), jnp.bool_), starts[:-1]]) & ~starts
    is_sent = (s_hi == SENT) & (s_lo == SENT)
    keep = (starts | second) & ~is_sent
    rank = jnp.where(keep, pos, I32(0x7FFFFFFF))
    _, chi, clo, cidx = jax.lax.sort(
        (rank,
         jnp.where(keep, s_hi, SENT),
         jnp.where(keep, s_lo, SENT),
         jnp.where(keep, s_idx, SENT)),
        num_keys=1,
    )
    return chi, clo, cidx, jnp.sum(keep.astype(I32))


def _first2_core(hi, lo, idx):
    """Full-sort form of the first-2 reduction (classic mode): sort by
    (key, lane), then keep-first-2."""
    return _first2_keep_core(*jax.lax.sort((hi, lo, idx), num_keys=3))


_first2_compact = jax.jit(_first2_core)
_first2_keep = jax.jit(_first2_keep_core)


@partial(jax.jit, static_argnames=("n",))
def _iota_base(n, base):
    return jnp.arange(n, dtype=U32) + base


@jax.jit
def _sort_run3(hi, lo, idx):
    return jax.lax.sort((hi, lo, idx), num_keys=3)


# The finalize programs below run DIRECTLY on the first-2 compacted
# planes (key-sorted, <= 2 lanes per key, sentinels at the tail), with
# segment starts carrying l1 and the next-lane shift carrying l2 — no
# reduction to one-row-per-key exists.  (An earlier design rank-sorted
# 5 planes into per-key rows first; that single program took the
# compiler past 15 minutes at bench sizes.  Every finalize program here
# contains at most ONE large sort.)


def _first2_meta(hi, lo, idx):
    """Elementwise segment metadata on first-2 planes: (starts, l2).
    starts marks each distinct key's first lane (sentinels excluded);
    l2 is the key's second occurrence lane at its start, else SENT."""
    same_prev = jnp.concatenate([
        jnp.zeros((1,), jnp.bool_),
        (hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1]),
    ])
    is_sent = (hi == SENT) & (lo == SENT)
    starts = ~same_prev & ~is_sent
    next_same = jnp.concatenate([same_prev[1:], jnp.zeros((1,), jnp.bool_)])
    l2 = jnp.where(next_same, jnp.concatenate([idx[1:], idx[:1]]), SENT)
    return starts, l2


def _pack_ok(m: int, n_hashes: int) -> bool:
    """True when probe-entry flat positions fit 31 bits, so (pos <<
    1) | verdict packs into one u32 plane (positions are unique)."""
    return m * n_hashes < (1 << 31)


def _fp_sort_core(hi, lo, idx, spec):
    """Bloom FP resolution, program A (one big sort): probe entries for
    each key's START lane, sorted by (bit, l1).  An entry's verdict is
    "this bit was set before lane l1" = NOT the first entry of its bit
    segment: entries with a smaller l1 are other keys' earlier first
    occurrences; entries with EQUAL l1 are the same key's duplicate
    probes of one bit (h2 cycling, yak-count.c:100) — and the reference
    counts those as set too, because yak_bf_insert tests AFTER setting
    earlier probes of the same call (`cnt += !!(*q & u); *q |= u;`,
    yak-count.c:103-104); the AND in program B consumes the
    segment-start entry's False in their place, so the verdict multiset
    per key matches the reference for any probe multiplicity.
    Returns (s_r, verdict) entry planes for program B."""
    m = hi.shape[0]
    starts, _l2 = _first2_meta(hi, lo, idx)
    keys = u.U64(hi, lo)
    idxs = bloom._probe_indices(keys, spec)
    # non-start lanes (second occurrences, sentinels) must NOT emit
    # probes: a second occurrence probes its key's own bits and would
    # wrongly pre-set them for the start lane
    fb = jnp.concatenate(
        [jnp.where(starts, ix.astype(U32), SENT) for ix in idxs]
    )
    fl1 = jnp.tile(idx, spec.n_hashes)
    # restore payload = FLAT position (probe plane j's lane i at
    # j*m + i): program B's restore sort then yields verdicts in
    # probe-plane order, so the AND is a (n_hashes, m) reshape with the
    # long dimension minor (an (m, n_hashes) layout would put a minor
    # dimension of 4 on every tile)
    fpos = jnp.arange(m * spec.n_hashes, dtype=U32)
    s_b, _s_l1, s_pos = jax.lax.sort((fb, fl1, fpos), num_keys=2)
    bit_starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), s_b[1:] != s_b[:-1]]
    )
    verdict = (~bit_starts).astype(U32)
    if _pack_ok(m, spec.n_hashes):
        # positions fit 31 bits: carry (pos, verdict) as ONE plane
        # (pos << 1 | verdict) so program B's restore sort moves half
        # the data (positions are unique, so the packed order is the
        # position order)
        return ((s_pos << 1) | verdict,)
    return s_pos, verdict


def _admits_hist(admitted, admit_idx, bounds, n_bins):
    """Per-batch newly-admitted counts.  bounds holds each batch's
    EXCLUSIVE end lane index, sentinel-padded; a key admitted at lane x
    lands in batch sum(x >= bounds) (admitted lanes are < the sentinel,
    so padding never miscounts).  Batch b maps to histogram bin b + 1
    (bin 0 stays empty)."""

    def body(j, acc):
        return acc + (admit_idx >= bounds[j]).astype(I32)

    batch = jax.lax.fori_loop(
        0, bounds.shape[0], body, jnp.ones(admit_idx.shape, I32)
    )
    hist = segops.histogram(
        jnp.minimum(batch, I32(n_bins - 1)), admitted, n_bins
    )
    return hist, jnp.sum(admitted.astype(I32))


def _fp_admits_core(entries, hi, lo, idx, bounds, n_hashes, n_bins):
    """Bloom FP resolution, program B (one big sort): verdicts return
    to probe-plane order via a 1-key sort on the packed (position,
    verdict) plane when positions fit 31 bits (see _fp_sort_core), else
    a scatter by position, so the per-lane AND is a (n_hashes, m) reshape row-min (minor dim m;
    see _fp_sort_core).  Then the per-batch admission
    bookkeeping: a key enters the table at l1 when all its probe bits
    were pre-set (fp), else at its second occurrence l2 (its own first
    occurrence set the bits), else never.  Returns (khi, klo, hist,
    tot): the admitted key planes (non-admitted lanes collapsed to the
    sentinel; still key-sorted) + per-batch counts."""
    m = hi.shape[0]
    if len(entries) == 1:
        sv = jax.lax.sort(entries[0]) & U32(1)
    else:
        s_pos, verdict = entries
        # s_pos is a permutation: scatter back (see bloom.insert_sequential)
        sv = jnp.zeros_like(verdict).at[s_pos].set(verdict,
                                                   unique_indices=True)
    fp = sv.reshape(n_hashes, m).min(axis=0) == 1
    starts, l2 = _first2_meta(hi, lo, idx)
    admitted = starts & (fp | (l2 != SENT))
    admit_idx = jnp.where(fp, idx, l2)
    hist, tot = _admits_hist(admitted, admit_idx, bounds, n_bins)
    khi = jnp.where(admitted, hi, SENT)
    klo = jnp.where(admitted, lo, SENT)
    return khi, klo, hist, tot


def _admits_nobloom_core(hi, lo, idx, bounds, n_bins):
    """No-bloom admission (yak_ch_insert_list without a bloom inserts
    unconditionally, yak-count.c:166-168): every key is admitted at its
    first occurrence.  Elementwise + histogram only — no sort."""
    starts, _l2 = _first2_meta(hi, lo, idx)
    hist, tot = _admits_hist(starts, idx, bounds, n_bins)
    khi = jnp.where(starts, hi, SENT)
    klo = jnp.where(starts, lo, SENT)
    return khi, klo, hist, tot


_fp_sort = partial(jax.jit, static_argnames=("spec",))(_fp_sort_core)
_fp_admits = partial(jax.jit, static_argnames=("n_hashes", "n_bins"))(
    _fp_admits_core)
_admits_nobloom = partial(jax.jit, static_argnames=("n_bins",))(
    _admits_nobloom_core)


class FirstSeenCompactor:
    """Accumulate (key, global lane index) planes; maintain, under a
    memory budget, a compacted run holding each distinct key's first
    two occurrence lanes.

    Two accumulation modes (mirroring table.compactor.KmerCompactor):

    * classic (the default): raw runs store only the planes the engine
      already extracted plus an integer base — the index plane is a
      lazy iota materialized at compaction, so streaming adds ZERO
      device work; each budget trip pays one full 3-key sort over
      everything accumulated.
    * stream-sorted (`table.compactor.stream_sorted_default`): each
      ~2^24-lane chunk is 3-key-sorted as it arrives — under the
      host->device ingest — and carry-merged into a binary-counter ladder of sorted runs
      with the 3-plane bitonic merge (kernels/bitonic.py), so budget
      trips and finalization pay only merges plus ONE rank sort
      (keep-first-2), never a bulk re-sort.  The lane index rides as a
      third lex key: it is globally unique, so (key_hi, key_lo, idx)
      is a total order and merge results are exactly the (key, lane)
      order the admission programs need.  Costs 12 B/lane of raw-run
      device memory (the idx plane is materialized) vs classic's 8.
    """

    def __init__(self, budget_bytes: int = 1 << 30,
                 stream_sorted: Optional[bool] = None):
        from ..table.compactor import stream_sorted_default

        # (hi, lo, idx_plane_or_base) — int base marks a raw run
        self.runs: List[Tuple] = []
        self.budget_bytes = budget_bytes
        self._bytes = 0
        self.stream_sorted = (stream_sorted_default()
                              if stream_sorted is None else bool(stream_sorted))
        self.stream = self._make_ladder() if self.stream_sorted else None
        self._compacted: Optional[Tuple] = None  # stream mode first-2 run

    def _make_ladder(self):
        from ..table.compactor import _STREAM_CHUNK, _STREAM_MIN
        from ..table.stream_ladder import StreamLadder

        return StreamLadder(
            chunk=_STREAM_CHUNK,
            min_pad=_STREAM_MIN,
            sort_fn=lambda p: tuple(_sort_run3(*p)),
            merge_fn=self._merge_runs,
            pad_fn=self._pad_run,
            concat_fn=lambda runs: tuple(
                jnp.concatenate([r[i] for r in runs]) for i in range(3)
            ),
            slice_fn=lambda p, a, b: tuple(x[a:b] for x in p),
            size_fn=lambda p: int(p[0].shape[0]),
        )

    @staticmethod
    def _merge_runs(a, b):
        """Merge two equal-length (key, lane)-sorted triples with the
        3-plane bitonic merge, donating the concatenated temporaries
        (as KmerCompactor._merge_runs)."""
        from ..kernels import bitonic

        cat = tuple(jnp.concatenate([x, y]) for x, y in zip(a, b))
        return tuple(bitonic.merge_sorted_halves3_donated(*cat))

    @staticmethod
    def _pad_run(planes, target: int):
        n = planes[0].shape[0]
        if target == n:
            return planes
        pad = jnp.full((target - n,), SENT, U32)
        return tuple(jnp.concatenate([p, pad]) for p in planes)

    def add_raw(self, hi, lo, base: int) -> None:
        n = int(hi.shape[0])
        if self.stream_sorted:
            self.stream.add((hi, lo, _iota_base(n, np.uint32(base))))
            self._bytes += n * 12
        else:
            self.runs.append((hi, lo, int(base)))
            self._bytes += n * 8
        if self._bytes > self.budget_bytes:
            self.compact()

    def _concat(self):
        n = sum(int(r[0].shape[0]) for r in self.runs)
        pad = _pad_to(n) - n
        pad_p = jnp.full((pad,), SENT, U32)
        his = jnp.concatenate([r[0] for r in self.runs] + [pad_p])
        los = jnp.concatenate([r[1] for r in self.runs] + [pad_p])
        idxs = jnp.concatenate(
            [
                (jnp.arange(int(r[0].shape[0]), dtype=U32) + U32(r[2]))
                if isinstance(r[2], int) else r[2]
                for r in self.runs
            ]
            + [pad_p]
        )
        return his, los, idxs

    def compact(self) -> None:
        if self.stream_sorted:
            self._compact_stream()
            return
        if not self.runs:
            return
        hi, lo, idx = self._concat()
        chi, clo, cidx, n_keep = _first2_compact(hi, lo, idx)
        self._shrink(chi, clo, cidx, n_keep)

    def _compact_stream(self) -> None:
        if not self.stream:
            return  # no new lanes since the last compact
        planes = self.stream.planes()
        self.stream.clear()
        if self._compacted is not None:
            # merge the standing first-2 run with the new sorted lanes:
            # pad both to a power of two (sentinels sort last) so the
            # bitonic halves are equal
            p = 1 << max(int(planes[0].shape[0]) - 1,
                         int(self._compacted[0].shape[0]) - 1).bit_length()
            planes = self._merge_runs(self._pad_run(self._compacted, p),
                                      self._pad_run(planes, p))
        chi, clo, cidx, n_keep = _first2_keep(*planes)
        self._shrink(chi, clo, cidx, n_keep)

    def _shrink(self, chi, clo, cidx, n_keep) -> None:
        nk = int(n_keep)  # sync: lets prior raw planes reclaim
        size = min(_size_class(nk), int(chi.shape[0]))
        run = (
            jax.lax.dynamic_slice(chi, (0,), (size,)),
            jax.lax.dynamic_slice(clo, (0,), (size,)),
            jax.lax.dynamic_slice(cidx, (0,), (size,)),
        )
        if self.stream_sorted:
            self._compacted = run
        else:
            self.runs = [run]
        self._bytes = size * 12
        # first-2 lanes >= distinct keys; the exact distinct count
        # comes from finalize()'s admission programs

    def first2_planes(self):
        """The compacted first-2 (hi, lo, idx) planes, or None if
        nothing was ever added."""
        self.compact()
        if self.stream_sorted:
            return self._compacted
        return self.runs[0] if self.runs else None


def _pad_bounds(bounds: List[int]) -> np.ndarray:
    n = max(1, len(bounds))
    for cls in _BOUNDS_CLASSES:
        if n <= cls:
            n = cls
            break
    else:
        raise ValueError(f"too many batches ({len(bounds)})")
    out = np.full((n,), 0xFFFFFFFF, np.uint32)
    out[: len(bounds)] = np.asarray(bounds, np.uint32)
    return out


class DeferredYakAdmission:
    """Driver: feed extracted key planes per block (with reference
    batch_end flags), then resolve every per-batch admitted-distinct
    total at once.  `spec` None (or use_bloom False) means no bloom:
    every valid k-mer is admitted at its first occurrence
    (yak_ch_insert_list without a bloom inserts unconditionally,
    yak-count.c:166-168)."""

    def __init__(self, spec: Optional[bloom.BloomSpec], use_bloom: bool,
                 budget_bytes: int = 1 << 30,
                 stream_sorted: Optional[bool] = None):
        self.spec = spec
        self.use_bloom = bool(use_bloom and spec is not None)
        self.fs = FirstSeenCompactor(budget_bytes, stream_sorted)
        self._base = 0
        self.bounds: List[int] = []  # exclusive end lane per batch
        self._pending = False

    def add_block(self, hi, lo, batch_end: bool) -> None:
        n = int(hi.shape[0])
        if self._base + n > _MAX_LANES:
            raise RuntimeError(
                "yak admission simulation exceeds the u32 lane-index "
                "range (~4.2 Gbases per run); rerun with "
                "KMER_TPU_FAST_YAK=1 to skip the stderr simulation"
            )
        self.fs.add_raw(hi, lo, self._base)
        self._base += n
        self._pending = True
        if batch_end:
            self.bounds.append(self._base)
            self._pending = False

    def finish(self) -> Tuple[np.ndarray, int]:
        """Returns (per-batch newly-admitted counts, total admitted).
        Call once, after the last block."""
        if self._pending:
            self.bounds.append(self._base)
            self._pending = False
        planes = self.fs.first2_planes()
        if not self.bounds or planes is None:
            return np.zeros((len(self.bounds),), np.int64), 0
        hi, lo, idx = planes
        bounds = jnp.asarray(_pad_bounds(self.bounds))
        n_bins = int(bounds.shape[0]) + 2
        if self.use_bloom:
            entries = _fp_sort(hi, lo, idx, self.spec)
            _khi, _klo, hist, tot = _fp_admits(
                entries, hi, lo, idx, bounds,
                self.spec.n_hashes, n_bins,
            )
        else:
            _khi, _klo, hist, tot = _admits_nobloom(hi, lo, idx, bounds,
                                                    n_bins)
        per_batch = np.asarray(hist).astype(np.int64)[
            1 : len(self.bounds) + 1
        ]
        return per_batch, int(tot)


# -- mesh forms -------------------------------------------------------
#
# The deferred formulation shards cleanly by key ownership: two keys
# can interact through the bloom only by sharing a probe bit, bits
# live in per-prefix subtables, and a subtable's prefix determines the
# owning device (BloomSpec.owner_bits <= pre), so every (bit, l1)
# comparison is device-local.  Per-device lane indices are the global
# stream order restricted to the device's keys (the routing sort is
# stable and the tiled all_to_all concatenates source segments in
# order — dist.sharded._bucketize_by_sort), and routed chunks have
# identical shapes on every device, so batch boundaries are shared
# scalars.  Per-batch counts and totals psum exactly (unique key
# ownership).

from functools import lru_cache

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

_CHUNK_SPEC = P("data", "shard", None)


@lru_cache(maxsize=None)
def sharded_attach_idx_fn(mesh):
    """Per-device local lane-index plane for one routed chunk: the
    device's running lane base (replicated scalar) + iota."""

    def per_device(hi, base):
        n = hi.shape[2]
        return (jnp.arange(n, dtype=U32) + base)[None, None]

    fn = shard_map(per_device, mesh=mesh, in_specs=(_CHUNK_SPEC, P()),
                   out_specs=_CHUNK_SPEC, check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def sharded_first2_fn(mesh):
    """Per-device first-two-occurrences fold; n_keep is the pmax over
    devices (every process must slice the SAME size class)."""

    def per_device(hi, lo, idx):
        chi, clo, cidx, n = _first2_core(hi[0, 0], lo[0, 0], idx[0, 0])
        nmax = jax.lax.pmax(jax.lax.pmax(n, "shard"), "data")
        return chi[None, None], clo[None, None], cidx[None, None], nmax

    fn = shard_map(per_device, mesh=mesh, in_specs=(_CHUNK_SPEC,) * 3,
                   out_specs=(_CHUNK_SPEC,) * 3 + (P(),), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def sharded_fp_sort_fn(mesh, spec):
    """Per-device bloom FP program A (_fp_sort_core): keys sharing a
    bloom bit always share an owner, so the (bit, l1) sort is
    device-local."""

    def per_device(hi, lo, idx):
        entries = _fp_sort_core(hi[0, 0], lo[0, 0], idx[0, 0], spec)
        return tuple(e[None, None] for e in entries)

    @lru_cache(maxsize=None)
    def jitted(arity):
        fn = shard_map(per_device, mesh=mesh, in_specs=(_CHUNK_SPEC,) * 3,
                       out_specs=(_CHUNK_SPEC,) * arity, check_vma=False)
        return jax.jit(fn)

    def wrapper(hi, lo, idx):
        # entry arity is static per shape (packed single-plane when
        # positions fit 31 bits)
        arity = 1 if _pack_ok(int(hi.shape[2]), spec.n_hashes) else 2
        return jitted(arity)(hi, lo, idx)

    return wrapper


@lru_cache(maxsize=None)
def sharded_fp_admits_fn(mesh, n_hashes: int, n_bins: int):
    """Per-device bloom FP program B + batch bookkeeping; hist/tot are
    psum'd (unique key ownership makes per-device sums exact).  Returns
    the admitted pass-1 key planes + (hist, tot)."""

    def per_device(*args):
        *entries, hi, lo, idx, bounds = args
        khi, klo, h, tot = _fp_admits_core(
            tuple(e[0, 0] for e in entries), hi[0, 0], lo[0, 0],
            idx[0, 0], bounds, n_hashes, n_bins,
        )
        h = jax.lax.psum(jax.lax.psum(h, "shard"), "data")
        tot = jax.lax.psum(jax.lax.psum(tot, "shard"), "data")
        return khi[None, None], klo[None, None], h, tot

    @lru_cache(maxsize=None)
    def jitted(arity):
        fn = shard_map(
            per_device, mesh=mesh,
            in_specs=(_CHUNK_SPEC,) * (arity + 3) + (P(),),
            out_specs=(_CHUNK_SPEC, _CHUNK_SPEC, P(), P()),
            check_vma=False,
        )
        return jax.jit(fn)

    def wrapper(entries, hi, lo, idx, bounds):
        return jitted(len(entries))(*entries, hi, lo, idx, bounds)

    return wrapper


@lru_cache(maxsize=None)
def sharded_admits_nobloom_fn(mesh, n_bins: int):
    """Per-device no-bloom admission (first occurrences) + psum'd
    batch bookkeeping."""

    def per_device(hi, lo, idx, bounds):
        khi, klo, h, tot = _admits_nobloom_core(
            hi[0, 0], lo[0, 0], idx[0, 0], bounds, n_bins)
        h = jax.lax.psum(jax.lax.psum(h, "shard"), "data")
        tot = jax.lax.psum(jax.lax.psum(tot, "shard"), "data")
        return khi[None, None], klo[None, None], h, tot

    fn = shard_map(
        per_device, mesh=mesh,
        in_specs=(_CHUNK_SPEC,) * 3 + (P(),),
        out_specs=(_CHUNK_SPEC, _CHUNK_SPEC, P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedDeferredYak:
    """Mesh driver: feed per-device routed chunk planes (D, S, L), then
    resolve per-step admitted-distinct totals and the admitted pass-1
    key planes at once.  Budget trips fold to first-2 form per device
    (same invariants as FirstSeenCompactor, axis=2)."""

    def __init__(self, mesh, spec, use_bloom: bool,
                 budget_bytes: int = 1 << 30):
        self.mesh = mesh
        self.spec = spec
        self.use_bloom = bool(use_bloom and spec is not None)
        self.runs = []  # (hi, lo, idx) (D, S, L) planes
        self.budget_bytes = budget_bytes
        self._bytes = 0
        self._base = 0  # per-device local lane count (uniform shapes)
        self.bounds = []

    def add_chunk(self, hi, lo, step_end: bool = True) -> None:
        n = int(hi.shape[2])
        if self._base + n > _MAX_LANES:
            raise RuntimeError(
                "mesh yak admission exceeds the u32 lane-index range"
            )
        idx = sharded_attach_idx_fn(self.mesh)(
            hi, jnp.uint32(self._base))
        self.runs.append((hi, lo, idx))
        self._base += n
        self._bytes += n * 12
        if step_end:
            self.bounds.append(self._base)
        if self._bytes > self.budget_bytes:
            self.compact()

    def _concat(self):
        n = sum(int(r[0].shape[2]) for r in self.runs)
        pad = _pad_to(n) - n
        d, s = (self.mesh.shape["data"], self.mesh.shape["shard"])
        parts = []
        for i in range(3):
            ps = [r[i] for r in self.runs]
            if pad:
                ps.append(jnp.full((d, s, pad), SENT, U32))
            parts.append(jnp.concatenate(ps, axis=2))
        return parts

    def compact(self) -> None:
        if not self.runs:
            return
        hi, lo, idx = self._concat()
        chi, clo, cidx, nmax = sharded_first2_fn(self.mesh)(hi, lo, idx)
        nk = int(nmax)  # replicated scalar
        size = min(_size_class(nk), int(chi.shape[2]))
        self.runs = [(chi[:, :, :size], clo[:, :, :size],
                      cidx[:, :, :size])]
        self._bytes = size * 12

    def finish(self):
        """(admitted_key_planes (hi, lo), per-step new counts, total).
        The key planes are per-device key-sorted with non-admitted and
        pad rows collapsed to the sentinel — ready for the sharded
        shrink merge-join."""
        self.compact()
        if not self.runs or not self.bounds:
            d, s = (self.mesh.shape["data"], self.mesh.shape["shard"])
            z = jnp.full((d, s, 1), SENT, U32)
            return (z, z), np.zeros((len(self.bounds),), np.int64), 0
        hi, lo, idx = self.runs[0]
        bounds = jnp.asarray(_pad_bounds(self.bounds))
        n_bins = int(bounds.shape[0]) + 2
        if self.use_bloom:
            entries = sharded_fp_sort_fn(self.mesh, self.spec)(
                hi, lo, idx)
            khi, klo, h, tot = sharded_fp_admits_fn(
                self.mesh, self.spec.n_hashes, n_bins,
            )(entries, hi, lo, idx, bounds)
        else:
            khi, klo, h, tot = sharded_admits_nobloom_fn(
                self.mesh, n_bins)(hi, lo, idx, bounds)
        per_step = np.asarray(h).astype(np.int64)[1 : len(self.bounds) + 1]
        return (khi, klo), per_step, int(tot)
