"""yak-count engine: bloom-prefiltered two-pass counting.

Mirrors yak_count / yak_count_file (/root/reference/yak-count.c:433-464):

  pass 1 (create_new=1): count with an optional blocked bloom filter in
    front of the table — a k-mer only enters the table once the bloom
    has seen it (so most singletons never allocate a slot).
  if bf_shift > 0: drop the bloom, zero the counts, re-count the second
    file (or the same file) incrementing only existing keys, then shrink
    keeping counts in [2, 1023].
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import bloom
from ..kernels import u64 as u
from ..table import count_table as ct
from .counter import GROW_LOAD, _iter_packed, _prefetch

YAK_COUNTER_BITS = 10  # yak-count.c:9
YAK_N_COUNTS = 1 << YAK_COUNTER_BITS
YAK_MAX_COUNT = YAK_N_COUNTS - 1
BLK_SHIFT = bloom.BLK_SHIFT


def _yak_ingest_core(
    table: ct.CountTable,
    bits: jnp.ndarray,
    hi: jnp.ndarray,
    lo: jnp.ndarray,
    spec: Optional[bloom.BloomSpec],
    create_new: bool,
    use_bloom: bool,
    exact_bloom: bool = False,
):
    """Bloom-gate + table-insert one block of sentinelized key planes
    (from pipeline.counter._extract_step).  Extraction lives in its own jit program: fusing it with the
    insert is the same XLA compile-time hazard the vaf step hit.  Valid
    lanes are the non-sentinel ones — unambiguous for every k: a hash64
    output masked to 2k bits can never be all-ones for k < 32, and at
    k = 32 the reproduced x86-64 shift UB (mask = 0, see
    kernels/kmer.py) collapses every real key to 0."""
    valid = ~((hi == jnp.uint32(0xFFFFFFFF)) & (lo == jnp.uint32(0xFFFFFFFF)))
    kmer = u.U64(hi, lo)
    n_dead = jnp.zeros((), jnp.int32)
    if create_new:
        if use_bloom:
            # exact_bloom: the reference's sequential test-and-set
            # semantics (KMER_TPU_EXACT_BLOOM=1; lanes arrive in read
            # order on the single-chip path, so "earlier lane" means
            # exactly what yak_bf_insert's loop order means)
            ins = (bloom.insert_sequential if exact_bloom
                   else bloom.insert)
            bits, preset = ins(bits, kmer, valid, spec)
            table, n_new, n_dead = ct.insert_gated(
                table, kmer, valid, preset, YAK_MAX_COUNT
            )
        else:
            table, n_new = ct.insert(table, kmer, valid, YAK_MAX_COUNT)
    else:
        table = ct.add_existing(table, kmer, valid, YAK_MAX_COUNT)
        n_new = jnp.zeros((), jnp.int32)
    return table, bits, n_new, n_dead


# the table + bloom planes' device memory is reused in place
_yak_ingest = partial(
    jax.jit, static_argnames=("spec", "create_new", "use_bloom",
                              "exact_bloom"),
    donate_argnums=(0, 1),
)(_yak_ingest_core)


def _clamp_bf_shift(bf_shift: int, owner_bits: int = 0) -> int:
    """Largest supported bloom size is 2^31 bits per shard (byte-per-bit
    device layout; kernels/bloom.py make_bits).  The reference accepts
    -b up to 64-BLK_SHIFT and simply allocates host RAM (yak-count.c:75)
    — an oversized request here clamps with a warning instead of
    crashing.  For single-file two-pass runs the FINAL histogram is
    bloom-size independent (a key's own first insert admits its second
    occurrence regardless of collisions, and shrink(count>=2) drops
    false-positive-admitted singletons after the recount), so the clamp
    only perturbs the two-file mode's false-positive set (PARITY.md).
    """
    cap = 31 + owner_bits
    if bf_shift > cap:
        from ..utils.log import warn

        warn("yak_count",
             f"bloom size 2^{bf_shift} exceeds the per-device budget; "
             f"using 2^{cap} bits")
        return cap
    return bf_shift


def _exact_bloom_default(use_bloom: bool) -> bool:
    """Default ON: yak_bf_insert runs strictly sequentially
    (yak-count.c:91-108) and the batched approximation is observable in
    two-file output (PARITY.md divergence 10), so engines pay the
    sequential reconstruction by default; KMER_TPU_EXACT_BLOOM=0 opts
    out for speed (strictly fewer bloom false positives, never a wrong
    count)."""
    import os

    return bool(use_bloom) and os.environ.get(
        "KMER_TPU_EXACT_BLOOM", "1"
    ).strip() not in ("0", "false", "off", "no")


def _bloom_geometry_ok(bf_shift: int, pre: int, owner_bits: int = 0) -> bool:
    """True when a (possibly clamped) bloom still satisfies make_bits'
    one-block-per-subtable invariant (BLK_SHIFT <= n_shift - pre).  A
    large -p with a clamped -b can violate it (e.g. -b37 -p25 clamps to
    31 bits, leaving 2^6 bits per subtable) — the engine then disables
    the bloom with a warning instead of crashing in make_bits."""
    clamped = min(bf_shift, 31 + owner_bits)
    if clamped - pre >= BLK_SHIFT:
        return True
    from ..utils.log import warn

    warn("yak_count",
         f"clamped bloom (2^{clamped} bits) leaves fewer than one "
         f"512-bit block per -p{pre} subtable; bloom prefilter disabled")
    return False




def _make_bloom(pre: int, bf_shift: int, bf_n_hash: int,
                make_bits_array: bool = True):
    """The ONE bloom-geometry gate shared by YakEngine and YakSimTap
    (the tap's admission must stay provably identical to the engine's):
    returns (use_bloom, bf_shift, spec, bits, exact_bloom) with the
    single-chip dummy-bits fallback.  Gates mirror yak_ch_init
    (n_shift > pre, yak-count.c:122) and yak_bf_init
    (BLK_SHIFT <= n_shift-pre <= 64-BLK_SHIFT, yak-count.c:75).
    make_bits_array=False skips allocating the device bits plane (the
    deferred admission path needs only the spec/gates)."""
    use_bloom = (
        bf_n_hash > 0
        and bf_shift > pre
        and (bf_shift - pre) >= BLK_SHIFT
        and _bloom_geometry_ok(bf_shift, pre)
    )
    if use_bloom:
        bf_shift = _clamp_bf_shift(bf_shift)
        spec = bloom.BloomSpec(pre, bf_shift, bf_n_hash)
        bits = bloom.make_bits(spec) if make_bits_array else None
    else:
        spec = None
        bits = jnp.zeros((8,), jnp.uint8) if make_bits_array else None
    return use_bloom, bf_shift, spec, bits, _exact_bloom_default(use_bloom)


@partial(jax.jit, static_argnames=("spec", "use_bloom", "exact_bloom"),
         donate_argnums=(0,))
def _tap_admit(bits, hi, lo, spec, use_bloom, exact_bloom):
    """Per-lane admission for the stderr simulation tap: a lane is
    admitted iff the reference's yak_bf_insert would return n_hash for
    it (all bloom bits pre-set — by earlier blocks or earlier lanes of
    this block under the sequential-exact semantics); non-admitted
    lanes collapse to the sentinel so a sort-based distinct count over
    the output planes equals the reference's h->tot.  Without a bloom
    every valid lane is admitted (the reference inserts every k-mer)."""
    sent = jnp.uint32(0xFFFFFFFF)
    valid = ~((hi == sent) & (lo == sent))
    if use_bloom:
        ins = bloom.insert_sequential if exact_bloom else bloom.insert
        bits, preset = ins(bits, u.U64(hi, lo), valid, spec)
        adm = valid & preset
    else:
        adm = valid
    return jnp.where(adm, hi, sent), jnp.where(adm, lo, sent), bits




def _extracted_blocks(paths: Sequence[str], k: int, chunk_size: int,
                      capacity_block: int, prefetch: bool):
    """Shared reader loop for the single-chip yak engines: stream the
    inputs through the (packed when available) reader + extraction,
    yielding (hi, lo, n_kmers, n_seqs, batch_end) sentinelized key
    planes per buffer.  Identical batching to the reference's pipeline
    step 0 (yak-count.c:381-383; reader batch_end flags)."""
    from .counter import (
        _extract_step,
        _extract_step_packed,
        _extract_step_packed_structural,
        _extract_step_rows,
        _iter_packed2,
        _to_device_ascii,
        _to_device_packed,
        _use_packed_ingest,
    )

    packed_mode = _use_packed_ingest(paths)
    # yak's pipelined reader resumes after a malformed-quality record
    # unless its chunk was empty (see io.fastx.FastxReader)
    policy = ("resume", k, 3)
    if packed_mode:
        it = map(
            _to_device_packed,
            _iter_packed2(paths, k, chunk_size, capacity_block, policy),
        )
    else:
        it = map(
            _to_device_ascii,
            _iter_packed(paths, k, chunk_size, capacity_block, policy),
        )
    if prefetch:
        it = _prefetch(it)
    for item in it:
        if packed_mode:
            (packed, mask, n_used, _n_bases, n_seqs, row_bytes,
             batch_end) = item
            rb = row_bytes if row_bytes and row_bytes > k else None
            if mask is None:
                hi, lo, nk = _extract_step_packed_structural(
                    packed, jnp.uint32(n_used), k, rb
                )
            else:
                hi, lo, nk = _extract_step_packed(packed, mask, k, rb)
        else:
            buf, _n_bases, n_seqs, row_bytes, batch_end = item
            if row_bytes and row_bytes > k:
                hi, lo, nk = _extract_step_rows(buf, k, row_bytes)
            else:
                hi, lo, nk = _extract_step(buf, k)
        yield hi, lo, nk, n_seqs, batch_end


class YakSimTap:
    """Single-file stderr progress simulation WITHOUT a device hash
    table OR per-block bloom work: the per-batch `[M] processed N
    sequences; M distinct ...` totals (yak-count.c:427) come from the
    deferred admission engine (pipeline.yak_admit) — streaming records
    only (key planes, global lane index) at zero device cost, and
    finish_batches() resolves every batch's admitted-distinct total in
    a handful of sorts (first-two-occurrences fold + one global
    (bit, l1) sort for the bloom's sequential false-positive
    semantics).  Totals are byte-identical to the sequential
    reference; the [M] lines print when counting finishes instead of
    live — content, not timing, is the parity claim
    (tests/test_golden_counters.py::test_yak_stderr_progress_parity).

    History: earlier taps ran the open-addressing insert_gated per
    block (a data-parallel probe loop whose single programs ran for
    minutes at GB scale), then the sequential bloom reconstruction + a
    full sort-compaction per batch (many times the engine's own cost).
    The deferred form removes both."""

    def __init__(self, k=31, pre=10, bf_shift=0, bf_n_hash=4,
                 chunk_size=10_000_000, log=None):
        import os

        from .yak_admit import DeferredYakAdmission

        self.k = k
        self.log = log
        (self.use_bloom, _bf, self.spec, _bits,
         self.exact_bloom) = _make_bloom(pre, bf_shift, bf_n_hash,
                                         make_bits_array=False)
        # 2 GiB default: in stream mode each budget trip costs a keep
        # rank sort on the device-bound path, so fewer trips are a
        # direct tap-pass win; 2 GiB keeps the 256 Mbase default to one
        # trip beside the engine's own planes (2 GiB budget)
        budget = int(os.environ.get("KMER_TPU_TAP_BUDGET", str(2 << 30)))
        self.adm = DeferredYakAdmission(self.spec, self.use_bloom,
                                        budget_bytes=budget)
        self.tot = 0
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def begin_batches(self) -> None:
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def ingest_planes(self, hi, lo, n_valid, n_seqs, batch_end,
                      create_new: bool = True) -> None:
        self.adm.add_block(hi, lo, bool(batch_end))
        self._batch_seqs += int(n_seqs)
        if batch_end:
            self.batch_seq_counts.append(self._batch_seqs)
            self._batch_seqs = 0

    def finish_batches(self) -> None:
        if self._batch_seqs or self.adm._pending:
            self.batch_seq_counts.append(self._batch_seqs)
            self._batch_seqs = 0
        per_batch, self.tot = self.adm.finish()
        if self.log is not None:
            running = 0
            for n_seqs, new in zip(self.batch_seq_counts, per_batch):
                running += int(new)
                self.log(n_seqs, running)


class YakEngine:
    def __init__(
        self,
        k: int = 31,
        pre: int = 10,
        bf_shift: int = 0,
        bf_n_hash: int = 4,
        chunk_size: int = 10_000_000,
        init_capacity: int = 1 << 20,
        prefetch: bool = True,
        log=None,
    ):
        self.k = k
        self.pre = pre
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.chunk_size = chunk_size
        # headroom covers per-read separators so a whole reference
        # batch (summed read LENGTHS = chunk_size) usually fits one
        # buffer (batch_end yields); shortfalls split via carry
        self.capacity_block = int(chunk_size) + max(4096, chunk_size // 32)
        self.prefetch = prefetch
        self.log = log
        self.batch_seq_counts = []  # per-batch n_seqs of the last count()
        self._batch_seqs, self._batch_pending = 0, False
        self.table = ct.make(init_capacity)
        self._n_dead = 0  # DELETED tombstones since the last rebuild
        (self.use_bloom, self.bf_shift, self.spec, self.bits,
         self.exact_bloom) = _make_bloom(pre, bf_shift, bf_n_hash)
        self.tot = 0  # cumulative distinct insertions (yak's h->tot)

    def _maybe_grow(self, incoming: int = 0):
        """Grow/sweep the table so occupied slots (FULL + DELETED
        tombstones) plus a worst case of `incoming` new keys stay under
        the load factor.  Pre-sizing BEFORE a batch is required for
        liveness: the jitted insert's probe loop never terminates if a
        batch holds more distinct keys than free slots (the device
        analog of khashl growing before the insert, khashl.h:200-202).
        Tombstones count because they are probe-opaque; the rebuild
        clears them (khashl's rehash-in-place analog), so the NEW
        capacity is sized from live keys alone — on a singleton-heavy
        stream this rebuilds at the same size every few batches instead
        of letting chains grow until the data-parallel probe loop runs
        minutes long."""
        n_full = int(self.table.n_full)
        cap = self.table.capacity
        while n_full + incoming > GROW_LOAD * cap:
            cap *= 2
        if (cap != self.table.capacity
                or n_full + self._n_dead + incoming
                > GROW_LOAD * self.table.capacity):
            self.table = ct.rebuild(self.table, cap)
            self._n_dead = 0

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        # per-batch stderr progress uses the reference's batch rule
        # (reader batch_end flags; yak-count.c:427 prints once per
        # pipeline batch per pass) — buffers aggregate until a batch
        # completes.  batch_seq_counts records each batch's sequence
        # count for pass-2 replay by the single-file hybrid (the second
        # pass re-reads the same file, so its batches are identical).
        self.begin_batches()
        for hi, lo, nk, n_seqs, batch_end in _extracted_blocks(
                paths, self.k, self.chunk_size, self.capacity_block,
                self.prefetch):
            self.ingest_planes(hi, lo, nk, n_seqs, batch_end, create_new)
        self.finish_batches()

    def begin_batches(self) -> None:
        self.batch_seq_counts = []
        self._batch_seqs, self._batch_pending = 0, False

    def ingest_planes(self, hi, lo, n_valid, n_seqs, batch_end,
                      create_new: bool = True) -> None:
        """One extracted block (sentinelized key planes, lanes in read
        order) through the bloom gate + table insert, with per-batch
        stderr accounting.  count() drives it from its own reader loop;
        the single-file CLI hybrid drives it as a SortCountEngine tap on
        the same planes, so the input is read and extracted once
        (tools/yak_count.py)."""
        if create_new:
            # worst case every VALID k-mer is a distinct new key;
            # insert claims a slot per distinct key even when
            # bloom-gated (padded/invalid lanes claim nothing).  DELETED
            # tombstones (bloom-rejected claims rolled back by
            # insert_gated) occupy probe chains too, hence n_dead in the
            # load estimate — the rebuild sweeps them.
            self._maybe_grow(incoming=int(n_valid))
        self.table, self.bits, n_new, n_dead = _yak_ingest(
            self.table, self.bits, hi, lo,
            self.spec, create_new, self.use_bloom,
            self.exact_bloom,
        )
        if create_new:
            self.tot += int(n_new)
            self._n_dead += int(n_dead)
        self._batch_seqs += int(n_seqs)
        self._batch_pending = True
        if batch_end:
            self._flush_batch()

    def _flush_batch(self) -> None:
        if self.log is not None:
            self.log(self._batch_seqs, self.tot)
        self.batch_seq_counts.append(self._batch_seqs)
        self._batch_seqs, self._batch_pending = 0, False

    def finish_batches(self) -> None:
        """Emit the final partial batch (the reference prints its last
        block too: sum_len > 0 at EOF still runs steps 1-2)."""
        if self._batch_pending:
            self._flush_batch()

    def destroy_bloom(self):
        self.use_bloom = False
        self.exact_bloom = False
        self.spec = None
        self.bits = jnp.zeros((8,), jnp.uint8)

    def clear(self):
        self.table = ct.clear_counts(self.table)

    def shrink(self, min_count: int, max_count: int):
        self.table = ct.rebuild(
            self.table, self.table.capacity, min_count, max_count
        )
        self._n_dead = 0  # the rebuild swept any tombstones
        self.tot = int(self.table.n_full)

    def hist(self) -> np.ndarray:
        return np.asarray(ct.hist(self.table, YAK_N_COUNTS))

    def save_checkpoint(self, path: str) -> None:
        """Device hash table + bloom bits as arrays (npz; SURVEY.md §5
        checkpoint analog) — e.g. between the two passes of the yak
        flow, so a killed pass 2 resumes without redoing pass 1."""
        import os

        t = self.table
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            state=np.asarray(t.state), key_hi=np.asarray(t.key_hi),
            key_lo=np.asarray(t.key_lo), cnt=np.asarray(t.cnt),
            bits=np.asarray(self.bits),
            meta=np.asarray(
                [self.k, self.pre, self.bf_shift, self.bf_n_hash,
                 int(t.n_full), self.tot, int(self.use_bloom),
                 self.chunk_size], np.int64,
            ),
        )
        os.replace(tmp, path)

    @classmethod
    def resume_checkpoint(cls, path: str, log=None) -> "YakEngine":
        z = np.load(path)
        k, pre, bfs, bfh, n_full, tot, use_bloom, chunk = (
            int(x) for x in z["meta"]
        )
        eng = cls(k=k, pre=pre, bf_shift=bfs, bf_n_hash=bfh,
                  chunk_size=chunk, log=log)
        eng.table = ct.CountTable(
            jnp.asarray(z["state"]), jnp.asarray(z["key_hi"]),
            jnp.asarray(z["key_lo"]), jnp.asarray(z["cnt"]),
            jnp.asarray(np.int32(n_full)),
        )
        eng.tot = tot
        if use_bloom:
            eng.bits = jnp.asarray(z["bits"])
        else:
            eng.destroy_bloom()
        return eng


def _mesh_row_batches(eng, paths: Sequence[str], policy):
    """Yield (global_rows_batch, row_bytes, n_seqs) mesh step batches —
    the reader/grouping shared by the mesh yak engines (table-based
    MeshYakEngine and sort-based MeshSortYakEngine must step identical
    batches for their outputs to be comparable).

    Single process: group n_dev reader buffers per step, zero-padded to
    a common width; row_bytes engages only when every buffer shares it.

    Multi-process pod: files shard per host and every process steps the
    same collectives in lockstep, exhausted hosts contributing zero
    blocks (the dist.multihost coordination).  KMER_TPU_SINGLE_READER=1
    instead has process 0 read every file and broadcast global batches
    — batch composition and bloom admission order then match a
    1-process run of the SAME mesh, removing the per-host file-sharding
    residual of PARITY.md divergences 8/10 (the mesh-vs-reference row
    geometry remains)."""
    if eng.n_proc > 1:
        from jax.experimental import multihost_utils

        from ..dist.multihost import (_bcast_batches, _local_batches,
                                      shard_files, single_reader)

        if single_reader():
            # capacity_block (not row_bases) so buffers split exactly
            # where the 1-process mesh run's packer splits them — the
            # stderr (n_seqs, tot) parity claim is per-BUFFER
            for rows, _nb, ns, rb in _bcast_batches(
                    paths, eng.k, eng.row_bases, eng.n_dev, policy,
                    capacity=eng.capacity_block):
                batch = jax.make_array_from_callback(
                    (eng.n_dev, eng.capacity_block),
                    eng._global_sharding, lambda idx: rows[idx],
                )
                yield batch, rb, int(ns)
            return

        it = _local_batches(shard_files(paths), eng.k, eng.row_bases,
                            eng.n_local, policy)
        if eng.prefetch:
            it = _prefetch(it)
        while True:
            item = next(it, None)
            has = item is not None
            if has:
                local, _nb, ns, rb = item
            else:
                local, ns, rb = (
                    np.zeros((eng.n_local, eng.row_bases), np.uint8), 0,
                    None,
                )
            # ONE collective agrees on continuation, row stride (the
            # fast path engages only when EVERY host shares it), and
            # the global sequence total (same rule and shape as
            # MultihostSortEngine.count_paths)
            state = multihost_utils.process_allgather(
                np.asarray([1 if has else 0, rb if rb else -1, ns],
                           np.int64)
            )
            if int(state[..., 0].sum()) == 0:
                break
            rbs = state[..., 1].ravel()
            rb = int(rbs[0])
            rb = rb if rb > 0 and (rbs == rb).all() else None
            batch = jax.make_array_from_process_local_data(
                eng._global_sharding, local
            )
            yield batch, rb, int(state[..., 2].sum())
        return

    def _group(rows, rbs):
        width = max(r.shape[0] for r in rows)
        batch = np.zeros((eng.n_dev, width), np.uint8)
        for i, r in enumerate(rows):
            batch[i, : r.shape[0]] = r
        rb = rbs[0] if len(set(rbs)) == 1 else None
        return jnp.asarray(batch), rb

    it = _iter_packed(paths, eng.k, eng.row_bases, eng.capacity_block,
                      policy)
    if eng.prefetch:
        it = _prefetch(it)
    rows, rbs, n_seqs = [], [], 0
    for buf, _nb, ns, rb, _be in it:
        rows.append(np.asarray(buf))
        rbs.append(rb)
        n_seqs += int(ns)
        if len(rows) == eng.n_dev:
            batch, rb = _group(rows, rbs)
            yield batch, rb, n_seqs
            rows, rbs, n_seqs = [], [], 0
    if rows:
        batch, rb = _group(rows, rbs)
        yield batch, rb, n_seqs


class MeshYakEngine:
    """YakEngine on the device mesh: the bloom-gated two-pass flow with
    every structure partitioned by key ownership (the same hash-prefix
    routing as dist.sharded.ShardedSortEngine).  Each chip holds the
    bloom subtables and hash slots of the prefixes it owns, so
    yak_ch_insert_list's gate + insert (yak-count.c:150-177) runs
    chip-local after one all_to_all; clear/shrink/hist are per-chip maps
    with psum'd reductions (yak-count.c:190-277).  Bloom probe VALUES
    are identical to the single-chip layout (BloomSpec.owner_bits), and
    admission reproduces yak_bf_insert's sequential test-and-set by
    default even here: each owner chip's received lane order equals the
    global stream order restricted to its keys (stable routing sort +
    source-ordered all_to_all; see dist.sharded.sharded_yak_ingest_fn),
    so sequential reconstruction is chip-local.  In multi-PROCESS pod
    runs files are sharded per host, so the global read order itself
    differs from the reference's single stream (PARITY.md div. 10)."""

    def __init__(
        self,
        k: int = 31,
        pre: int = 10,
        bf_shift: int = 0,
        bf_n_hash: int = 4,
        chunk_size: int = 10_000_000,
        init_capacity: int = 1 << 16,
        prefetch: bool = True,
        log=None,
    ):
        from ..dist import sharded

        self.k = k
        self.pre = pre
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.prefetch = prefetch
        self.log = log
        self.mesh = sharded.make_mesh()
        self.n_dev = int(np.prod(list(self.mesh.shape.values())))
        self.owner_bits = self.n_dev.bit_length() - 1
        self.row_bases = max(int(chunk_size) // self.n_dev, 1 << 16)
        self.capacity_block = self.row_bases + 4096
        self.cap_local = init_capacity
        self.tables = sharded.make_sharded_tables(self.mesh, init_capacity)
        bloom_wanted = (
            bf_n_hash > 0
            and bf_shift > pre
            and (bf_shift - pre) >= BLK_SHIFT
        )
        self.use_bloom = (bloom_wanted and pre >= self.owner_bits
                          and _bloom_geometry_ok(bf_shift, pre,
                                                 self.owner_bits))
        if bloom_wanted and not self.use_bloom:
            # the per-device bloom partition needs at least one prefix
            # bit per owner (kernels/bloom.py owner_bits <= pre); with
            # fewer, pass 1 admits every key — observable in two-file
            # mode (PARITY.md divergence 10 scope), so say so
            from ..utils.log import warn

            warn("yak_count",
                 f"-p{pre} has fewer prefix bits than the {self.n_dev}"
                 f"-device mesh needs ({self.owner_bits}); bloom "
                 "prefilter disabled (two-file admission differs from "
                 "a single-chip run)")
        if self.use_bloom:
            bf_shift = _clamp_bf_shift(bf_shift, self.owner_bits)
            self.bf_shift = bf_shift
            self.spec = bloom.BloomSpec(pre, bf_shift, bf_n_hash,
                                        self.owner_bits)
            local = bloom.make_bits(self.spec)
            d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
            self.bits = jnp.zeros((d, s, local.shape[0]), jnp.uint8)
        else:
            self.spec = None
            d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
            self.bits = jnp.zeros((d, s, 8), jnp.uint8)
        self.exact_bloom = _exact_bloom_default(self.use_bloom)
        self.tot = 0
        self._n_dead = 0  # worst-device tombstones since the last rebuild
        self._route = sharded.ShardedSortEngine(self.mesh, k)  # routing only
        self._valid_max = sharded.sharded_chunk_valid_max_fn(self.mesh)
        self._nfull_stats = sharded.sharded_nfull_stats_fn(self.mesh)
        self._ingest_cache = {}
        self.n_proc = jax.process_count()
        self.n_local = len(jax.local_devices())
        if self.n_proc > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._global_sharding = NamedSharding(
                self.mesh, P(("data", "shard"), None)
            )

    def _ingest_fn(self, create_new: bool):
        from ..dist import sharded

        key = (create_new, self.use_bloom, self.exact_bloom,
               self.cap_local, self.bits.shape[2])
        if key not in self._ingest_cache:
            self._ingest_cache[key] = sharded.sharded_yak_ingest_fn(
                self.mesh, self.spec, create_new, self.use_bloom,
                YAK_MAX_COUNT, self.exact_bloom,
            )
        return self._ingest_cache[key]

    def _maybe_grow(self, incoming: int):
        """Pre-size every device's table so the worst-case batch fits
        (liveness: see YakEngine._maybe_grow).  All devices share one
        static capacity = grown to the most loaded device's need.
        Tombstones (max per device) count toward the load and are swept
        by the rebuild — see YakEngine._maybe_grow."""
        from ..dist import sharded

        n_full = int(self._nfull_stats(self.tables)[0])  # replicated max
        cap = self.cap_local
        while n_full + incoming > GROW_LOAD * cap:
            cap *= 2
        if (cap != self.cap_local
                or n_full + self._n_dead + incoming
                > GROW_LOAD * self.cap_local):
            self.tables = sharded.sharded_rebuild_fn(self.mesh, cap)(
                self.tables
            )
            self._n_dead = 0
            self.cap_local = cap

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        policy = ("resume", self.k, 3)
        for batch, rb, ns in _mesh_row_batches(self, paths, policy):
            self._step_rows(batch, rb, ns, create_new)

    def _step_rows(self, batch, rb, n_seqs: int, create_new: bool) -> None:
        hi, lo = self._route.route_batch(batch, row_bytes=rb)
        if create_new:
            incoming = int(self._valid_max(hi, lo))
            self._maybe_grow(incoming)
        self.tables, self.bits, n_new, n_dead = self._ingest_fn(create_new)(
            self.tables, self.bits, hi, lo
        )
        if create_new:
            self.tot += int(n_new)
            self._n_dead += int(n_dead)
        if self.log is not None:
            self.log(n_seqs, self.tot)

    def destroy_bloom(self):
        self.use_bloom = False
        self.exact_bloom = False
        self.spec = None
        d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
        self.bits = jnp.zeros((d, s, 8), jnp.uint8)
        self._ingest_cache = {}

    def clear(self):
        from ..dist import sharded

        self.tables = sharded.sharded_clear_fn(self.mesh)(self.tables)

    def shrink(self, min_count: int, max_count: int):
        from ..dist import sharded

        self.tables = sharded.sharded_rebuild_fn(
            self.mesh, self.cap_local, min_count, max_count
        )(self.tables)
        self._n_dead = 0  # the rebuild swept any tombstones
        self.tot = int(self._nfull_stats(self.tables)[1])  # replicated sum

    def hist(self) -> np.ndarray:
        from ..dist import sharded

        return np.asarray(
            sharded.sharded_hist_fn(self.mesh, YAK_N_COUNTS)(self.tables)
        )


class MeshSortYakEngine:
    """Sort-based two-pass yak engine on the device mesh — the mesh
    default (KMER_TPU_TABLE_YAK=1 restores the table-based
    MeshYakEngine).  Retires the open-addressing probe loop, whose
    single programs run for minutes at GB scale: every step is routing
    sorts, the deferred admission fold
    (pipeline.yak_admit.ShardedDeferredYak — per-device, since keys
    sharing a bloom bit share an owner), compactions, and one shrink
    merge-join, each a bounded-size program.

    Pass 1 routes each step's k-mers to their owners and records
    (key, local lane index) — per-owner lane order equals the global
    stream order restricted to the owner's keys (the stable routing
    sort + source-ordered all_to_all, dist.sharded._bucketize_by_sort),
    so the deferred bloom semantics are chip-local and byte-exact.  The
    per-step `[M]` totals resolve when pass 1 finishes (deferred), with
    identical content to the table engine's live lines.  Pass 2
    accumulates fn2's counts in the ShardedSortEngine; shrink joins the
    admitted pass-1 key planes against them (yak_ch_shrink,
    yak-count.c:243-277).  With bf_shift == 0 there is no pass 2
    (yak_count_file, yak-count.c:457): pass 1 then also accumulates
    counts so hist() can answer directly."""

    def __init__(
        self,
        k: int = 31,
        pre: int = 10,
        bf_shift: int = 0,
        bf_n_hash: int = 4,
        chunk_size: int = 10_000_000,
        init_capacity: int = None,
        prefetch: bool = True,
        log=None,
    ):
        import os

        from ..dist import sharded
        from .yak_admit import ShardedDeferredYak

        self.k = k
        self.pre = pre
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.prefetch = prefetch
        self.log = log
        self.mesh = sharded.make_mesh()
        self.n_dev = int(np.prod(list(self.mesh.shape.values())))
        self.owner_bits = self.n_dev.bit_length() - 1
        self.row_bases = max(int(chunk_size) // self.n_dev, 1 << 16)
        self.capacity_block = self.row_bases + 4096
        self._route = sharded.ShardedSortEngine(self.mesh, k)
        bloom_wanted = (
            bf_n_hash > 0
            and bf_shift > pre
            and (bf_shift - pre) >= BLK_SHIFT
        )
        self.use_bloom = (bloom_wanted and pre >= self.owner_bits
                          and _bloom_geometry_ok(bf_shift, pre,
                                                 self.owner_bits))
        if bloom_wanted and not self.use_bloom:
            # same gate + message as MeshYakEngine: the per-device bloom
            # partition needs at least one prefix bit per owner
            from ..utils.log import warn

            warn("yak_count",
                 f"-p{pre} has fewer prefix bits than the {self.n_dev}"
                 f"-device mesh needs ({self.owner_bits}); bloom "
                 "prefilter disabled (two-file admission differs from "
                 "a single-chip run)")
        if self.use_bloom:
            self.bf_shift = _clamp_bf_shift(bf_shift, self.owner_bits)
            self.spec = bloom.BloomSpec(pre, self.bf_shift, bf_n_hash,
                                        self.owner_bits)
        else:
            self.spec = None
        budget = int(os.environ.get("KMER_TPU_TAP_BUDGET", str(1 << 30)))
        self.adm = ShardedDeferredYak(self.mesh, self.spec, self.use_bloom,
                                      budget_bytes=budget)
        self.tot = 0
        self._k1 = None  # admitted pass-1 key planes (hi, lo)
        self._hist = None  # post-shrink histogram
        self._p1_seqs = []
        self.n_proc = jax.process_count()
        self.n_local = len(jax.local_devices())
        if self.n_proc > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._global_sharding = NamedSharding(
                self.mesh, P(("data", "shard"), None)
            )

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        policy = ("resume", self.k, 3)
        if create_new:
            # pass-1 counts are only observable when no pass 2 follows
            keep_counts = not (self.bf_shift > 0)
            self._p1_seqs = []
            for batch, rb, ns in _mesh_row_batches(self, paths, policy):
                hi, lo = self._route.route_batch(batch, row_bytes=rb)
                self.adm.add_chunk(hi, lo, step_end=True)
                if keep_counts:
                    self._route.add_chunk_planes(hi, lo)
                self._p1_seqs.append(int(ns))
            self._k1, per_step, self.tot = self.adm.finish()
            if self.log is not None:
                running = 0
                for ns, new in zip(self._p1_seqs, per_step):
                    running += int(new)
                    self.log(ns, running)
        else:
            # pass 2 never inserts: every line repeats the pass-1 total
            # (yak-count.c:170-174), printed live
            for batch, rb, ns in _mesh_row_batches(self, paths, policy):
                self._route.add_batch(batch, row_bytes=rb)
                if self.log is not None:
                    self.log(ns, self.tot)
            self._route._flush_inflight()

    def destroy_bloom(self):
        pass  # bits-free: admission already resolved at pass-1 finish

    def clear(self):
        # pass-2 counts accumulate in the (empty) route engine; the
        # admitted key planes stay in self._k1 untouched
        self._route.reset()

    def shrink(self, min_count: int, max_count: int):
        self._route.compact()
        if self._route.weighted is not None:
            whi, wlo, wcnt = self._route.weighted
        else:  # empty pass 2: every pass-1 key counts 0
            d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
            whi = wlo = jnp.full((d, s, 1), jnp.uint32(0xFFFFFFFF))
            wcnt = jnp.zeros((d, s, 1), jnp.uint32)
        h, tot = _sharded_shrink_join_fn(self.mesh)(
            self._k1[0], self._k1[1], whi, wlo, wcnt,
            jnp.uint32(min_count), jnp.uint32(max_count),
        )
        self._hist = np.asarray(h).astype(np.int64)
        self._hist[0] = 0  # bin 0 collects the dropped lanes' zeros
        self.tot = int(tot)

    def hist(self) -> np.ndarray:
        if self._hist is not None:
            return self._hist
        # bf_shift == 0 flow: exact counts accumulated during pass 1
        h = self._route.hist(YAK_N_COUNTS, max_count=YAK_MAX_COUNT)
        return np.asarray(h).astype(np.int64)






def _shrink_join_core(k1hi, k1lo, k2hi, k2lo, c2, min_count, max_count):
    """Counts of the pass-1 keys (A) within the pass-2 counted run (B)
    as ONE sorted merge-join: 3-key sort orders each A entry
    immediately before its B partner, a neighbor compare takes the
    partner's count, and a 1024-bin scatter builds the histogram on
    device.  Replaces counts_for here because a 47M-query binary-search
    join runs ~30 gather rounds in one program (a long-running single
    program at GB scale, like the table probe loop); this is a single
    sort + two passes.  Returns (hist[1024], tot)."""
    sent = jnp.uint32(0xFFFFFFFF)
    n1 = k1hi.shape[0]
    hi = jnp.concatenate([k1hi, k2hi])
    lo = jnp.concatenate([k1lo, k2lo])
    srcv = jnp.concatenate([
        jnp.zeros((n1,), jnp.uint32),
        jnp.ones((k2hi.shape[0],), jnp.uint32),
    ])
    cnt = jnp.concatenate([jnp.zeros((n1,), jnp.uint32), c2])
    shi, slo, ssrc, scnt = jax.lax.sort((hi, lo, srcv, cnt), num_keys=3)
    nxt_same = (shi[1:] == shi[:-1]) & (slo[1:] == slo[:-1])
    take_next = nxt_same & (ssrc[:-1] == 0) & (ssrc[1:] == 1)
    a_cnt = jnp.concatenate([
        jnp.where(take_next, scnt[1:], 0),
        jnp.zeros((1,), jnp.uint32),
    ])
    c = jnp.minimum(a_cnt, jnp.uint32(YAK_MAX_COUNT))
    keep = ((ssrc == 0) & ~((shi == sent) & (slo == sent))
            & (c >= min_count) & (c <= max_count))
    hist = jnp.zeros((YAK_N_COUNTS,), jnp.int32).at[
        jnp.where(keep, c, 0)
    ].add(keep.astype(jnp.int32))
    return hist, jnp.sum(keep.astype(jnp.int32))


_shrink_join = jax.jit(_shrink_join_core)


_SHRINK_JOIN_CACHE = {}


def _sharded_shrink_join_fn(mesh):
    """Per-device shrink merge-join + psum — the mesh form of
    _shrink_join (keys are uniquely owned, so per-device joins sum
    exactly)."""
    if mesh not in _SHRINK_JOIN_CACHE:
        try:
            from jax import shard_map
        except ImportError:  # older jax
            from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        spec = P("data", "shard", None)

        def per_device(k1hi, k1lo, k2hi, k2lo, c2, min_c, max_c):
            h, tot = _shrink_join_core(
                k1hi[0, 0], k1lo[0, 0], k2hi[0, 0], k2lo[0, 0],
                c2[0, 0], min_c, max_c,
            )
            return (jax.lax.psum(jax.lax.psum(h, "shard"), "data"),
                    jax.lax.psum(jax.lax.psum(tot, "shard"), "data"))

        fn = jax.jit(shard_map(
            per_device, mesh=mesh,
            in_specs=(spec,) * 5 + (P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        ))
        _SHRINK_JOIN_CACHE[mesh] = fn
    return _SHRINK_JOIN_CACHE[mesh]


class SortYakEngine:
    """Sort-based two-pass yak engine (single chip) — the default for
    the two-file yak_count_file flow; KMER_TPU_TABLE_YAK=1 restores the
    open-addressing YakEngine.

    Key identity that makes the table unnecessary: with the
    sequential-exact bloom, every occurrence of a key AFTER its
    in-block first sees all bloom bits set, so insert_gated's
    per-occurrence contribution (c-1+preset) equals `preset` for EVERY
    occurrence — i.e. pass-1 counts ARE the multiplicities of the
    bloom-ADMITTED occurrences, and those flow through the sort-based
    compactor directly (counting by sort, not by hash).  Pass 2 counts
    fn2's k-mers in a second compactor and resolves the pass-1 keys
    against it with the sort-join (counts_for); shrink filters on the
    host.  Unlike the table's data-parallel probe loop (whose runtime
    grows with capacity x probe rounds), every step here is sorts and
    merges at streaming cost."""

    def __init__(self, k=31, pre=10, bf_shift=0, bf_n_hash=4,
                 chunk_size=10_000_000, init_capacity=None,
                 prefetch=True, log=None):
        from ..table.compactor import KmerCompactor, stream_sorted_default

        self.k = k
        self.log = log
        self.prefetch = prefetch
        self.chunk_size = chunk_size
        self.capacity_block = int(chunk_size) + max(4096, chunk_size // 32)
        (self.use_bloom, self.bf_shift, self.spec, self.bits,
         self.exact_bloom) = _make_bloom(pre, bf_shift, bf_n_hash)
        self._mk = lambda: KmerCompactor(
            key_bits=2 * k, stream_sorted=stream_sorted_default())
        self.comp1 = self._mk()  # admitted-occurrence stream (pass 1)
        self.comp2 = None        # fn2 occurrence stream (pass 2)
        self.tot = 0
        self._hist = None        # post-shrink histogram (host)
        self.batch_seq_counts = []
        self._batch_seqs = 0

    def count(self, paths: Sequence[str], create_new: bool) -> None:
        self.batch_seq_counts = []
        self._batch_seqs = 0
        pending = False
        for hi, lo, _nk, n_seqs, batch_end in _extracted_blocks(
                paths, self.k, self.chunk_size, self.capacity_block,
                self.prefetch):
            if create_new:
                hi, lo, self.bits = _tap_admit(
                    self.bits, hi, lo, self.spec, self.use_bloom,
                    self.exact_bloom)
                self.comp1.add_raw(hi, lo)
            else:
                self.comp2.add_raw(hi, lo)
            self._batch_seqs += int(n_seqs)
            pending = True
            if batch_end:
                self._flush_batch(create_new)
                pending = False
        if pending:
            self._flush_batch(create_new)

    def _flush_batch(self, create_new: bool) -> None:
        if create_new:
            self.comp1.compact()
            self.tot = self.comp1.last_n_unique
        # pass 2 never inserts: every line repeats the pass-1 total
        # (yak-count.c:170-174)
        if self.log is not None:
            self.log(self._batch_seqs, self.tot)
        self.batch_seq_counts.append(self._batch_seqs)
        self._batch_seqs = 0

    def destroy_bloom(self):
        self.use_bloom = False
        self.exact_bloom = False
        self.spec = None
        self.bits = jnp.zeros((8,), jnp.uint8)

    def clear(self):
        # pass-2 counts accumulate in their own compactor; pass-1 keys
        # (the membership set) stay in comp1 untouched
        self.comp2 = self._mk()

    def shrink(self, min_count: int, max_count: int):
        """Resolve the pass-1 key set against the pass-2 counts (the
        yak_ch_shrink rebuild, yak-count.c:243-277) with the merge-join
        (_shrink_join); stores the final histogram + tot."""
        self.comp1.compact()
        khi, klo, c1 = self.comp1.runs[0]
        if self.comp2 is None:
            n1 = self.comp1.last_n_unique
            c = np.minimum(np.asarray(c1)[:n1].astype(np.int64),
                           YAK_MAX_COUNT)
            keep = (c >= min_count) & (c <= max_count)
            self._hist = np.bincount(
                c[keep], minlength=YAK_N_COUNTS)[:YAK_N_COUNTS]
            self.tot = int(keep.sum())
            return
        self.comp2.compact()
        k2hi, k2lo, c2 = self.comp2.runs[0]
        h, tot = _shrink_join(khi, klo, k2hi, k2lo, c2,
                              jnp.uint32(min_count), jnp.uint32(max_count))
        self._hist = np.asarray(h).astype(np.int64)
        self._hist[0] = 0  # bin 0 collects the dropped lanes' zeros
        self.tot = int(tot)

    def hist(self) -> np.ndarray:
        if self._hist is not None:
            return self._hist
        self.comp1.compact()
        _khi, _klo, c1 = self.comp1.runs[0]
        n1 = self.comp1.last_n_unique
        c = np.minimum(np.asarray(c1)[:n1].astype(np.int64),
                       YAK_MAX_COUNT)
        return np.bincount(c, minlength=YAK_N_COUNTS)[:YAK_N_COUNTS]


def make_yak_engine(**kw):
    """Sort-based engines by default — SortYakEngine on one device,
    MeshSortYakEngine when the system has a multi-device mesh or is a
    multi-process pod (same gates as pipeline.counter.make_count_engine;
    the mesh engine handles cross-host coordination itself).
    KMER_TPU_TABLE_YAK=1 restores the open-addressing table engines
    (YakEngine / MeshYakEngine) as the cross-check."""
    import os

    from .counter import use_mesh

    table = os.environ.get("KMER_TPU_TABLE_YAK", "") == "1"
    if jax.process_count() > 1 or use_mesh():
        return MeshYakEngine(**kw) if table else MeshSortYakEngine(**kw)
    return YakEngine(**kw) if table else SortYakEngine(**kw)


def yak_count_file(
    fn1: str, fn2: Optional[str], opt
) -> "YakEngine":
    """The yak_count_file flow (yak-count.c:453-464)."""
    opt.count([fn1], create_new=True)
    if opt.bf_shift > 0:
        opt.destroy_bloom()
        opt.clear()
        opt.count([fn2 if fn2 else fn1], create_new=False)
        opt.shrink(2, YAK_MAX_COUNT)
    return opt
