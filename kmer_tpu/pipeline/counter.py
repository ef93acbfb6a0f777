"""The end-to-end k-mer counting engine.

Replaces the reference's kt_pipeline 3-step flow (read block -> extract
k-mers -> insert; /root/reference/kc-c4.c:130-179) with:

  host thread:  read + pack blocks into fixed-shape buffers (ASCII, or
                2-bit packed + validity bitmask over slow host->device
                links) and upload them — overlapping the device's work
                on the previous block (the P1 pipeline analog)
  device step:  one jit program per block: encode -> canonical k-mer
                extraction -> hash64 -> sentinelized key planes,
                appended to the sort-based compactor
                (kmer_tpu.table.compactor), which folds runs into
                (key, count) state under a memory budget

GROW_LOAD is the load factor at which the bloom-gated yak path's device
hash table rebuilds 2x (khashl's incremental rehash, khashl.h:152-195,
turned into occasional whole-table rebuilds)."""

from __future__ import annotations

import queue
import threading
import time
from functools import partial
from typing import Iterator, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io import fastx, packing
from ..kernels.encode import encode_bases
from ..kernels.kmer import extract_canonical
from ..utils.cli import env_flag

GROW_LOAD = 0.65

# byte -> popcount (mask-elision check without unpackbits' 8x blowup)
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


class IngestStats:
    """Per-stage wall accounting for one count_paths run (the engine
    analog of the reference's -v perf_stats, vaf-counter.c:32-51).

    All fields are thread-seconds except loop_s (main-thread wall):
      reader_s    producer time inside the host reader (decompress +
                  parse + pack), measured in the prefetch thread
      upload_s    summed per-stream host->device transfer time
      upload_bytes  bytes actually moved over the link
      wait_s      main-thread time blocked on the reader/uploader
                  pipeline (ingest is the bottleneck when this is big)
      dispatch_s  main-thread time dispatching device work, including
                  the stream ladder's backpressure syncs (the device is
                  the bottleneck when this is big)
    """

    def __init__(self):
        self.reader_s = 0.0
        self.upload_s = 0.0
        self.upload_bytes = 0
        self.upload_n = 0
        self.wait_s = 0.0
        self.dispatch_s = 0.0
        self.throttle_s = 0.0  # subset of dispatch_s: backpressure waits
        self.loop_s = 0.0
        self._lock = threading.Lock()

    def add_upload(self, nbytes: int, dt: float) -> None:
        with self._lock:
            self.upload_s += dt
            self.upload_bytes += nbytes
            self.upload_n += 1

    def report(self) -> str:
        up_mb = self.upload_bytes / 1e6
        per_stream = up_mb / self.upload_s if self.upload_s else 0.0
        # throttle_s is INSIDE dispatch_s: time blocked on the stream
        # ladder's backpressure syncs (compactor.throttle_wait_s) —
        # split out so waiting on the device is never mistaken for real
        # dispatch cost
        thr = f", of which throttle wait {self.throttle_s:.2f}s" \
            if self.throttle_s else ""
        return (
            f"loop {self.loop_s:.2f}s (reader {self.reader_s:.2f}s, "
            f"upload {up_mb:.0f} MB @ {per_stream:.1f} MB/s/stream, "
            f"main wait {self.wait_s:.2f}s, "
            f"dispatch {self.dispatch_s:.2f}s{thr})"
        )


def _timed_iter(it, stats: "IngestStats"):
    """Accumulate producer-side time (runs inside the prefetch thread)."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            stats.reader_s += time.perf_counter() - t0
            return
        stats.reader_s += time.perf_counter() - t0
        yield item


def _trim_to_class(buf: np.ndarray, n: int) -> np.ndarray:
    """Trim a packed buffer to the smallest size class >= n bytes used.
    Bytes past n are zero (an invalid base), so every window there is
    invalid — trimming never changes the k-mer multiset.  Keeps device
    work proportional to the input (small files / tests) while bounding
    the number of compiled shapes."""
    for cls in (1 << 16, 1 << 20, 1 << 23):
        if n <= cls < buf.shape[0]:
            return buf[:cls]
    return buf


def _iter_packed(
    paths: Sequence[str], k: int, block_bases: int, capacity: int,
    qual_policy=None,
) -> Iterator[Tuple[np.ndarray, int, int, Optional[int], bool]]:
    """Yield (ascii_u8[<=capacity], n_bases, n_seqs, row_bytes,
    batch_end).

    n_bases/n_seqs are TRUE per-read totals — each read >= k counts
    once, with its full length, regardless of how buffer-boundary
    splitting cut it into (k-1)-overlap pieces (the reference counts
    per kseq read, vaf-counter.c:505-507; a piece-based count inflated
    both totals on long-read input).

    row_bytes is L+1 when every read packed into the buffer has the same
    length L (uniform Illumina reads) — consumers can then drop the
    per-read invalid window positions with a reshape+slice instead of
    sorting them as sentinels (~20% of lanes for 150bp reads at k=31).

    batch_end is True when the buffer completes one reference pipeline
    batch (summed kept-read lengths reached block_bases, the
    yak-count.c:381-383 step-0 rule); a batch too large for one buffer
    spans several yields with batch_end False until its last.

    Uses the native C++ reader (kmer_tpu/io/native) when buildable —
    the host runtime analog of the reference's kseq + kt_pipeline read
    step — with a pure-Python fallback."""
    if all(p != "-" for p in paths):
        from ..io import native

        if native.available():
            for buf, used, n_bases, n_seqs, rb, be in native.iter_packed_native(
                paths, k, block_bases, capacity, qual_policy
            ):
                yield _trim_to_class(buf, used), n_bases, n_seqs, rb, be
            return
    max_len = capacity - 1
    step = max_len - (k - 1)
    for blk in fastx.read_blocks(paths, k, block_bases,
                                 qual_policy=qual_policy):
        # split over-long sequences (chromosomes) into (k-1)-overlap chunks;
        # consecutive chunks tile the window sequence exactly once.
        seqs = []
        for s in blk.seqs:
            if len(s) + 1 > capacity:
                for off in range(0, len(s) - (k - 1), step):
                    seqs.append(s[off : off + max_len])
            else:
                seqs.append(s)
        lens = {len(s) for s in seqs}
        rb = (lens.pop() + 1) if len(lens) == 1 else None
        # true totals (reads once, full lengths once) ride the block's
        # FIRST pack; continuation packs report zero.  read_blocks
        # already batches by the reference rule, so the LAST pack of a
        # block is a batch end.
        n_seqs = sum(1 for s in blk.seqs if len(s) >= k)
        n_bases = blk.sum_len
        blk = fastx.Block(seqs, blk.sum_len, blk.n_kmers)
        packs = list(packing.pack_block(blk, capacity))
        for i, (buf, n) in enumerate(packs):
            yield (_trim_to_class(buf, n), n_bases, n_seqs, rb,
                   i == len(packs) - 1)
            n_seqs = n_bases = 0


# 2-bit packed host->device ingest (0.375 or 0.25 B/base over the host
# link instead of 1) stays off by default: kc-c4 at 256 Mbases timed a
# little slower with it on the card, where the link is not the
# bottleneck (PERF.md).  KMER_TPU_PACKED=0/1 overrides.
PACKED_INGEST_DEFAULT = False


def _use_packed_ingest(paths) -> bool:
    """Packed ingest needs real files through the native reader."""
    if not env_flag("KMER_TPU_PACKED", PACKED_INGEST_DEFAULT):
        return False
    if any(p == "-" for p in paths):
        return False
    from ..io import native

    return native.available()


def _iter_packed2(paths, k: int, block_bases: int, capacity: int,
                  qual_policy=None):
    """Packed-ingest analog of _iter_packed: yields (packed, mask,
    n_bytes_used, n_bases, n_seqs, row_bytes, batch_end) with buffers
    trimmed to the smallest size class (slots past the packed region
    are mask-invalid, so trimming never changes the k-mer multiset).
    n_bytes_used is the packed-region layout boundary; n_bases/n_seqs
    are true per-read totals and batch_end flags reference-batch
    completion (see _iter_packed).

    mask is None when it is purely STRUCTURAL — uniform rows with no
    N/invalid bases, so every set bit is a row separator or the tail
    past n — detected by popcount (any in-read invalid adds a bit; bits
    are never cleared).  The consumer rebuilds it on device from
    (n, row_bytes), saving a third of the host->device bytes
    (0.25 B/base instead of 0.375)."""
    from ..io import native

    for packed, mask, n, n_bases, n_seqs, rb, be in (
            native.iter_packed2bit_native(
                paths, k, block_bases, capacity, qual_policy)):
        for cls in (1 << 16, 1 << 20, 1 << 23):
            if n <= cls < 4 * packed.shape[0]:
                packed, mask = packed[: cls // 4], mask[: cls // 8]
                break
        if rb and rb > k:
            slots = 8 * mask.shape[0]
            expected = (slots - n) + n // rb
            if int(_POPCNT8[mask].sum(dtype=np.int64)) == expected:
                mask = None
        yield packed, mask, n, n_bases, n_seqs, rb, be


def _to_device_ascii(item, stats: Optional[IngestStats] = None):
    """Upload a block inside an uploader thread so the host->device
    transfer overlaps the reader and the previous block's compute (the
    P1 pipeline overlap, extended to the copy).  Buffers are freshly
    allocated per block, so the zero-copy-alias hazard (CLAUDE.md) does
    not apply.  Waiting for the copy here keeps the upload time honest
    and gives the pipeline backpressure."""
    buf, n, ns, rb, be = item
    t0 = time.perf_counter()
    nbytes = buf.nbytes
    buf = jax.device_put(buf).block_until_ready()
    if stats is not None:
        stats.add_upload(nbytes, time.perf_counter() - t0)
    return buf, n, ns, rb, be


def _to_device_packed(item, stats: Optional[IngestStats] = None):
    p, m, n, nb, ns, rb, be = item
    t0 = time.perf_counter()
    nbytes = p.nbytes + (m.nbytes if m is not None else 0)
    p = jax.device_put(p)
    if m is not None:
        m = jax.device_put(m).block_until_ready()
    p.block_until_ready()
    if stats is not None:
        stats.add_upload(nbytes, time.perf_counter() - t0)
    return p, m, n, nb, ns, rb, be


class _maybe_profile:
    """KMER_TPU_PROFILE=<dir> captures a jax.profiler trace of the
    streaming loop (the observability analog of the reference's -v
    perf_stats, SURVEY.md §5 row 1)."""

    def __enter__(self):
        import os

        self.dir = os.environ.get("KMER_TPU_PROFILE")
        if self.dir:
            jax.profiler.start_trace(self.dir)
        return self

    def __exit__(self, *exc):
        if self.dir:
            jax.profiler.stop_trace()
        return False


# uploader threads between the reader and the dispatch loop: 1, 2, 4 and
# 16 timed alike on the card, where the host reader bounds the loop
# (PERF.md); 2 keeps one copy in flight while the next block lands.
# KMER_TPU_UPLOAD_THREADS overrides.
UPLOAD_THREADS = 2


def _upload_threads() -> int:
    import os

    try:
        return max(1, int(os.environ.get("KMER_TPU_UPLOAD_THREADS", "")))
    except ValueError:
        return UPLOAD_THREADS


def _pipelined_map(fn, it, workers=2, depth=4):
    """Order-preserving map over `it` with `workers` threads and at most
    `depth` items in flight (the kt_pipeline middle-step analog): runs
    host->device uploads concurrently, and the bounded depth keeps
    host/device buffering proportional to the pipeline, not the file."""
    import concurrent.futures as cf
    from collections import deque

    ex = cf.ThreadPoolExecutor(max_workers=workers)
    dq: "deque" = deque()
    try:
        for item in it:
            dq.append(ex.submit(fn, item))
            if len(dq) >= depth:
                yield dq.popleft().result()
        while dq:
            yield dq.popleft().result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def _prefetch(it, depth=2):
    """Run an iterator in a background thread (kt_pipeline step-0 analog).
    Reader exceptions (e.g. unreadable input) re-raise in the consumer
    instead of dying silently in the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def work():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - forwarded verbatim
            q.put((sentinel, e))
        finally:
            q.put(sentinel)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
            raise item[1]
        yield item


def _extract_planes(ascii_u8: jnp.ndarray, k: int):
    """Fused encode -> canonical extraction -> hash64 -> sentinelize.

    Returns (hi, lo, n_kmers): uint32 planes where invalid lanes are the
    all-ones sentinel, ready for the sort-based compactor.  Zero bytes
    encode as invalid, so zero padding never changes the k-mer
    multiset.  Shared by the single-device step and the mesh engine's
    shard_map body (dist/sharded.py)."""
    codes = encode_bases(ascii_u8)
    out = extract_canonical(codes, k, apply_hash64=True)
    hi = jnp.where(out.valid, out.kmer.hi, jnp.uint32(0xFFFFFFFF))
    lo = jnp.where(out.valid, out.kmer.lo, jnp.uint32(0xFFFFFFFF))
    n_kmers = jnp.sum(out.valid.astype(jnp.int32))
    return hi, lo, n_kmers


_extract_step = partial(jax.jit, static_argnames=("k",))(_extract_planes)


def _unpack_codes(packed: jnp.ndarray) -> jnp.ndarray:
    """(n/4,) packed 2-bit base codes -> (n,) codes 0..3."""
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    return ((packed[:, None] >> shifts[None, :]) & 3).reshape(-1)


def _codes_ascii(codes: jnp.ndarray) -> jnp.ndarray:
    """base code 0..3 -> ASCII 'A'/'C'/'G'/'T'."""
    return jnp.where(
        codes == 0,
        jnp.uint8(65),
        jnp.where(
            codes == 1,
            jnp.uint8(67),
            jnp.where(codes == 2, jnp.uint8(71), jnp.uint8(84)),
        ),
    )


def _unpack_ascii(packed: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Expand the native reader's 2-bit base codes + invalid bitmask
    (io/native/fastx_reader.cpp ktp_read_block_packed) into the ASCII
    byte stream the plain reader would have produced: code 0..3 ->
    'A'/'C'/'G'/'T', masked slots -> NUL (an invalid base either way).
    One cheap elementwise pass on device; the payoff is 0.375 bytes per
    base over the host->device link instead of 1."""
    n4 = packed.shape[0]
    codes = _unpack_codes(packed)
    bits = jnp.arange(8, dtype=jnp.uint8)
    inv = ((mask[:, None] >> bits[None, :]) & 1).reshape(8 * mask.shape[0])
    return jnp.where(inv[: 4 * n4] == 1, jnp.uint8(0), _codes_ascii(codes))


def _structural_ascii(packed: jnp.ndarray, n_used, row_bytes: int,
                      ) -> jnp.ndarray:
    """Packed unpack without a transferred mask: the block is uniform
    rows with no in-read invalid bases (see _iter_packed2), so invalid
    slots are exactly the per-row separators plus the tail past n_used
    — rebuilt from an iota instead of 0.125 B/base of host link.  The
    ONE definition of that predicate, shared by the single-chip step
    and the mesh engine's shard_map body (dist/sharded.py); the host
    (numpy) twin for pre-assembled mesh batches lives in
    MeshSortCountEngine._assemble_packed."""
    codes = _unpack_codes(packed)
    n = codes.shape[0]
    n_rows = n // row_bytes
    span = n_rows * row_bytes
    # separator = last column of each row; tail = at/past n_used.  The
    # 2D broadcasted-iota form avoids a per-lane integer mod (an ALU
    # pass over 4 lanes/byte that showed up as ~7% of the device-path
    # headline vs the plain rows ingest).
    col = jnp.arange(row_bytes, dtype=jnp.uint32)[None, :]
    row0 = jnp.arange(n_rows, dtype=jnp.uint32)[:, None] * jnp.uint32(
        row_bytes)
    inv = (col == jnp.uint32(row_bytes - 1)) | (row0 + col >= n_used)
    body = jnp.where(inv.reshape(-1), jnp.uint8(0),
                     _codes_ascii(codes[:span]))
    if span == n:
        return body
    return jnp.concatenate([body, jnp.zeros((n - span,), jnp.uint8)])


@partial(jax.jit, static_argnames=("k", "row_bytes"))
def _extract_step_packed(packed: jnp.ndarray, mask: jnp.ndarray, k: int,
                         row_bytes):
    ascii_u8 = _unpack_ascii(packed, mask)
    if row_bytes and row_bytes > k:
        return _extract_step_rows(ascii_u8, k, row_bytes)
    return _extract_step(ascii_u8, k)


@partial(jax.jit, static_argnames=("k", "row_bytes"))
def _extract_step_packed_structural(packed: jnp.ndarray, n_used, k: int,
                                    row_bytes: int):
    return _extract_step_rows(
        _structural_ascii(packed, n_used, row_bytes), k, row_bytes)


@partial(jax.jit, static_argnames=("k", "row_bytes"))
def _extract_step_rows(ascii_u8: jnp.ndarray, k: int, row_bytes: int):
    """_extract_step for uniform-length reads: every read occupies
    exactly row_bytes = L+1 bytes (L bases + one NUL), so the only lanes
    that can ever be valid are window ends at in-row offsets k-1..L-1.
    Slicing those columns drops the guaranteed-invalid ~(k/row_bytes)
    fraction of lanes before they reach the sort (~20% for 150bp reads
    at k=31).  Rows past the packed region are all-zero -> all-sentinel,
    and remain so after slicing."""
    hi, lo, n_kmers = _extract_step(ascii_u8, k)
    n_rows = ascii_u8.shape[0] // row_bytes
    span = n_rows * row_bytes
    hi = hi[:span].reshape(n_rows, row_bytes)[:, k - 1 : row_bytes - 1]
    lo = lo[:span].reshape(n_rows, row_bytes)[:, k - 1 : row_bytes - 1]
    return hi.reshape(-1), lo.reshape(-1), n_kmers


class SortCountEngine:
    """Streaming counter on the sort-based compactor (see
    kmer_tpu.table.compactor) — zero random access in the hot loop."""

    def __init__(
        self,
        k: int,
        block_bases: int = 10_000_000,
        budget_bytes: int = 2 << 30,
        prefetch: bool = True,
        qual_policy=None,
    ):
        from ..table.compactor import KmerCompactor, stream_sorted_default

        self.k = k
        self.block_bases = block_bases
        # separator headroom: one reference batch per buffer (see
        # _iter_packed batch_end)
        self.capacity = int(block_bases) + max(4096, int(block_bases) // 32)
        self.prefetch = prefetch
        self.qual_policy = qual_policy  # see io.fastx.FastxReader
        # hash64 output is < 2^(2k): for k <= 15 the compactor's sorts
        # can run single-plane (half the comparator work).  With
        # stream_sorted the compactor sorts arriving blocks under ingest
        # so finalization pays a bitonic merge, not the giant sort.
        self.compactor = KmerCompactor(
            budget_bytes=budget_bytes, key_bits=2 * k,
            stream_sorted=stream_sorted_default(),
        )
        self.total_bases = 0
        self.total_seqs = 0
        self.stats = IngestStats()  # refreshed per count_paths run
        # per-block valid-window counts stay ON DEVICE during streaming:
        # an int() per block is a blocking device sync that stalls
        # dispatch; total_kmers folds them lazily instead
        self._nk_host = 0
        self._nk_dev: list = []

    @property
    def total_kmers(self) -> int:
        if self._nk_dev:
            self._nk_host += int(np.asarray(
                jax.device_get(jnp.stack(self._nk_dev)).sum()
            ))
            self._nk_dev.clear()
        return self._nk_host

    @total_kmers.setter
    def total_kmers(self, v: int) -> None:
        self._nk_dev.clear()
        self._nk_host = int(v)

    def count_paths(self, paths: Sequence[str], progress=None,
                    tap=None) -> None:
        """Stream every path's k-mers into the compactor.  `tap`, when
        given, is called per device block as
        tap(hi, lo, n_valid, n_seqs, batch_end) AFTER the block is
        appended — the single-file yak CLI uses it to run the bloom
        admission simulation on the same extracted planes without a
        second pass over the input (tools/yak_count.py)."""
        st = self.stats = IngestStats()
        t_loop = time.perf_counter()
        thr0 = getattr(self.compactor, "throttle_wait_s", 0.0)
        packed_mode = _use_packed_ingest(paths)
        if packed_mode:
            it = _iter_packed2(paths, self.k, self.block_bases, self.capacity,
                               self.qual_policy)
            to_dev = partial(_to_device_packed, stats=st)
        else:
            it = _iter_packed(paths, self.k, self.block_bases, self.capacity,
                              self.qual_policy)
            to_dev = partial(_to_device_ascii, stats=st)
        if self.prefetch:
            # 3-stage host pipeline (the kt_pipeline analog): reader
            # thread -> N uploader streams -> this thread's dispatch
            w = _upload_threads()
            it = _pipelined_map(to_dev, _prefetch(_timed_iter(it, st)),
                                workers=w, depth=2 * w)
        else:
            it = map(to_dev, _timed_iter(it, st))
        with _maybe_profile():
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    st.wait_s += time.perf_counter() - t0
                    break
                t1 = time.perf_counter()
                st.wait_s += t1 - t0
                if packed_mode:
                    (packed, mask, n_used, n_bases, n_seqs, row_bytes,
                     batch_end) = item
                    rb = row_bytes if row_bytes and row_bytes > self.k else None
                    if mask is None:
                        hi, lo, n_kmers = _extract_step_packed_structural(
                            packed, jnp.uint32(n_used), self.k, rb
                        )
                    else:
                        hi, lo, n_kmers = _extract_step_packed(
                            packed, mask, self.k, rb
                        )
                else:
                    buf, n_bases, n_seqs, row_bytes, batch_end = item
                    if row_bytes and row_bytes > self.k:
                        hi, lo, n_kmers = _extract_step_rows(
                            buf, self.k, row_bytes)
                    else:
                        hi, lo, n_kmers = _extract_step(buf, self.k)
                self.compactor.add_raw(hi, lo)
                self.total_bases += int(n_bases)
                self.total_seqs += n_seqs
                self._nk_dev.append(n_kmers)
                if tap is not None:
                    tap(hi, lo, n_kmers, n_seqs, batch_end)
                st.dispatch_s += time.perf_counter() - t1
                if progress is not None:
                    progress(self)
        st.loop_s = time.perf_counter() - t_loop
        st.throttle_s = (
            getattr(self.compactor, "throttle_wait_s", 0.0) - thr0
        )

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        h, self._n_distinct = self.compactor.hist(n_bins, max_count, min_keep)
        return h

    def counts_for(self, query_hi, query_lo):
        return self.compactor.counts_for(query_hi, query_lo)

    def save_checkpoint(self, path: str) -> None:
        """Dump the device count state as arrays (npz) — the
        checkpoint/resume analog of SURVEY.md §5 (the reference's only
        checkpoints are its inter-tool files).  The stream folds to one
        (key, count) run first, so the file holds exactly the distinct
        keys seen; a killed run resumes from the last saved input
        boundary with resume_checkpoint."""
        self.compactor.compact()
        if self.compactor.runs:
            hi, lo, cnt = self.compactor.runs[0]
            hi, lo, cnt = np.asarray(hi), np.asarray(lo), np.asarray(cnt)
        else:
            hi = lo = np.zeros(0, np.uint32)
            cnt = np.zeros(0, np.uint32)
        import os

        tmp = path + ".tmp.npz"  # atomic publish: write-then-rename
        np.savez_compressed(
            tmp, hi=hi, lo=lo, cnt=cnt,
            meta=np.asarray(
                [self.k, self.total_bases, self.total_seqs,
                 self.total_kmers], np.int64,
            ),
        )
        os.replace(tmp, path)

    @classmethod
    def resume_checkpoint(cls, path: str, **kw) -> "SortCountEngine":
        """Rebuild an engine from save_checkpoint output; counting can
        continue over the remaining inputs and the final histogram is
        identical to an uninterrupted run."""
        from ..kernels import u64 as u

        z = np.load(path)
        k, tb, ts, tk = (int(x) for x in z["meta"])
        eng = cls(k=k, **kw)
        if z["hi"].size:
            eng.compactor.add_counted(
                u.U64(jnp.asarray(z["hi"]), jnp.asarray(z["lo"])),
                jnp.asarray(z["cnt"]),
            )
        eng.total_bases, eng.total_seqs, eng.total_kmers = tb, ts, tk
        return eng


def use_mesh() -> bool:
    """Whether the CLI tools should count on the multi-device sharded
    engine.  Mirrors the reference flagship engaging its parallel
    runtime by default (kc-c4.c:181-191): with more
    than one device the mesh path is automatic.  KMER_TPU_FORCE_MESH=1
    forces it, =0 disables."""
    return env_flag("KMER_TPU_FORCE_MESH", len(jax.devices()) > 1)


class MeshSortCountEngine:
    """SortCountEngine's interface on the multi-chip sharded engine
    (dist.sharded.ShardedSortEngine): the host reader splits each block
    across the mesh's devices as rows of a (n_dev, row_bases) batch; the
    device step extracts, routes every k-mer to its owning device
    (all_to_all over the interconnect), and accumulates per-device
    sorted state.

    This is what makes the reference's default-on parallel runtime
    (kc-c4.c:181-191, 2 pipeline + 4 worker threads) reachable from the
    CLI tools on a multi-chip system: kc-c4's -b block splits across
    chips the way it splits across insert workers."""

    def __init__(
        self,
        k: int,
        block_bases: int = 10_000_000,
        budget_bytes: int = 2 << 30,
        prefetch: bool = True,
        qual_policy=None,
    ):
        from ..dist import sharded

        self.k = k
        self.mesh = sharded.make_mesh()
        self.n_dev = len(self.mesh.devices.reshape(-1))
        # the reference's -b is bases per pipeline block; one mesh batch
        # consumes a whole block, one row per device
        self.row_bases = max(int(block_bases) // self.n_dev, 1 << 16)
        self.capacity = self.row_bases + max(4096, self.row_bases // 32)
        self.prefetch = prefetch
        self.qual_policy = qual_policy
        self.eng = sharded.ShardedSortEngine(
            self.mesh, k, lanes_per_dest=None, budget_bytes=budget_bytes
        )
        self.total_bases = 0
        self.total_seqs = 0

    @property
    def total_kmers(self):
        return self.eng.total_kmers

    def _assemble(self, rows, rbs):
        width = max(r.shape[0] for r in rows)
        batch = np.zeros((self.n_dev, width), np.uint8)
        for i, r in enumerate(rows):
            batch[i, : r.shape[0]] = r
        # uniform-read row slicing applies only when every row in the
        # batch shares one row stride (zero pad-rows slice to sentinels
        # either way); see dist.sharded.sharded_extract_step_fn
        rb = rbs[0] if len(set(rbs)) == 1 else None
        return self._put_rows(batch), rb

    def _put_rows(self, x):
        """Upload a (n_dev, W) batch with each row on its owning device
        (the step's in_specs layout), in the prefetch thread."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        return jax.device_put(
            x, NamedSharding(self.mesh, P(("data", "shard"), None)))

    def _assemble_packed(self, items):
        """One packed mesh batch from up to n_dev reader items of
        (packed, mask_or_None, n_bytes, rb): structural mode (codes +
        per-device used-byte counts, 0.25 B/base over the host link)
        when every row's mask was elided with one shared row stride,
        masked mode otherwise (missing masks are rebuilt host-side)."""
        w4 = max(p.shape[0] for p, _m, _n, _rb in items)
        pk = np.zeros((self.n_dev, w4), np.uint8)
        for i, (p, _m, _n, _rb) in enumerate(items):
            pk[i, : p.shape[0]] = p
        rbs = {rb for _p, _m, _n, rb in items}
        rb = rbs.pop() if len(rbs) == 1 else None
        structural = (
            rb is not None and rb > self.k
            and all(m is None for _p, m, _n, _rb in items)
        )
        if structural:
            nused = np.zeros((self.n_dev, 1), np.int32)
            for i, (_p, _m, n, _rb) in enumerate(items):
                nused[i, 0] = n
            aux, mode = nused, "packed_structural"
        else:
            mask = np.full((self.n_dev, w4 // 2), 0xFF, np.uint8)
            for i, (p, m, n, irb) in enumerate(items):
                if m is None:  # structural row in a mixed batch
                    pos = np.arange(4 * p.shape[0], dtype=np.int64)
                    inv = (pos % irb == irb - 1) | (pos >= n)
                    m = np.packbits(inv, bitorder="little")
                mask[i, : m.shape[0]] = m
            aux, mode = mask, "packed"
        return (self._put_rows(pk), rb if (rb and rb > self.k) else None,
                self._put_rows(aux), mode)

    def count_paths(self, paths: Sequence[str], progress=None) -> None:
        packed_mode = _use_packed_ingest(paths)

        def batches():
            # group + assemble + upload inside the prefetch thread so
            # the host copy overlaps the previous batch's device step
            rows, rbs, items, nb, ns = [], [], [], 0, 0
            if packed_mode:
                src = _iter_packed2(paths, self.k, self.row_bases,
                                    self.capacity, self.qual_policy)
            else:
                src = _iter_packed(paths, self.k, self.row_bases,
                                   self.capacity, self.qual_policy)
            for item in src:
                if packed_mode:
                    packed, mask, n_used, n_bases, n_seqs, rb, _be = item
                    items.append((packed, mask, int(n_used), rb))
                else:
                    buf, n_bases, n_seqs, rb, _be = item
                    rows.append(np.asarray(buf))
                    rbs.append(rb)
                nb += int(n_bases)  # true per-read totals (_iter_packed)
                ns += int(n_seqs)
                if len(rows) + len(items) == self.n_dev:
                    got = (self._assemble_packed(items) if packed_mode
                           else self._assemble(rows, rbs) + (None, "ascii"))
                    yield got + (nb, ns)
                    rows, rbs, items, nb, ns = [], [], [], 0, 0
            if rows or items:
                got = (self._assemble_packed(items) if packed_mode
                       else self._assemble(rows, rbs) + (None, "ascii"))
                yield got + (nb, ns)

        it = batches()
        if self.prefetch:
            it = _prefetch(it)
        with _maybe_profile():
            for dev, rb, aux, mode, nb, ns in it:
                self.eng.add_batch(dev, row_bytes=rb, aux=aux, ingest=mode)
                self.total_bases += nb
                self.total_seqs += ns
                if progress is not None:
                    progress(self)

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        h = self.eng.hist(n_bins, max_count, min_keep)
        self._n_distinct = self.eng._n_distinct
        return h

    def counts_for(self, query_hi, query_lo):
        return self.eng.counts_for(query_hi, query_lo)

    def save_checkpoint(self, path: str) -> None:
        """Per-device planes + stream totals (see
        SortCountEngine.save_checkpoint).  This engine is the
        single-process multi-chip path; multi-process pods checkpoint
        through MultihostSortEngine.save_checkpoint (one shard file per
        process, dist/multihost.py)."""
        import os

        self.eng.save_checkpoint(path)
        tmp = path + ".totals.tmp.npz"
        np.savez(tmp, totals=np.asarray(
            [self.total_bases, self.total_seqs], np.int64))
        os.replace(tmp, path + ".totals.npz")

    def resume_checkpoint_into(self, path: str) -> None:
        self.eng.restore_checkpoint(path)
        z = np.load(path + ".totals.npz")
        self.total_bases, self.total_seqs = (int(x) for x in z["totals"])


def make_count_engine(
    k: int,
    block_bases: int = 10_000_000,
    budget_bytes: int = 2 << 30,
    prefetch: bool = True,
    qual_policy=None,
):
    """The CLI tools' engine factory: cross-host engine on a multi-
    process run (pods — jax.distributed must be initialized before the
    tool starts, dist.multihost.initialize), multi-device mesh engine on
    a multi-chip host (see use_mesh), single-device sort engine
    otherwise.  All produce identical histograms/counts."""
    if jax.process_count() > 1:
        from ..dist.multihost import MultihostSortEngine

        return MultihostSortEngine(k, block_bases, budget_bytes, prefetch,
                                   qual_policy)
    if use_mesh():
        return MeshSortCountEngine(k, block_bases, budget_bytes, prefetch,
                                   qual_policy)
    return SortCountEngine(k, block_bases, budget_bytes, prefetch,
                           qual_policy)


