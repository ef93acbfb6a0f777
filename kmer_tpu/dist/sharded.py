"""Multi-chip sharded k-mer counting over a device mesh.

This is the distributed form of the reference's central concurrency
trick (SURVEY.md §2.3 P3): kc-c4 routes each hashed k-mer to one of
2^p subtables by its low bits so each worker owns whole subtables and
insertion is lock-free (/root/reference/kc-c4.c:74-83,116-128).  Here
the same routing becomes the mesh layout:

  mesh axes ("data", "shard")
    data  — read blocks are data-parallel across this axis (the P2
            block parallelism of kc-c4.c:151)
    shard — the count table is partitioned by the low bits of the
            hashed k-mer; an all_to_all over the interconnect delivers
            every k-mer to its owning device (the c4x_insert_buf
            routing made physical), where the insert is device-local
            and conflict-free

  pipeline parallelism (P1) stays on the host: the prefetch thread in
  kmer_tpu.pipeline overlaps IO with device steps.  No sequence/expert
  parallelism exists in this workload (SURVEY.md §2.3 P6): reads are
  independent 100bp windows, so "sp" degenerates into dp.

Histograms merge with jax.lax.psum over both axes (the per-thread
count-array reduction of kc-c4.c:227-230).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import u64 as u
from ..kernels.encode import encode_bases
from ..kernels.kmer import extract_canonical
from ..table import count_table as ct


def default_lanes_per_dest(block: int, n_dev: int) -> int:
    """Send-buffer lanes per destination for a given block size: the
    expected block/n_dev keys per device plus 30% Poisson slack, rounded
    to the lane quantum.  Callers must still check total_dropped — a
    pathologically low-complexity input (poly-A, adapter dimers) can
    concentrate arbitrarily many identical k-mers on one destination."""
    return (int(block / n_dev * 1.3) // 128) * 128 + 256


def make_mesh(devices=None, data: Optional[int] = None, shard: Optional[int] = None) -> Mesh:
    """Build a ("data", "shard") mesh.  With no sizes given, picks the
    most square power-of-two-ish factorization of the device count."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if data is None or shard is None:
        shard = 1
        for s in range(int(math.isqrt(n)), 0, -1):
            if n % s == 0:
                data, shard = s, n // s
                break
    assert data * shard == n
    dev_array = np.asarray(devices).reshape(data, shard)
    return Mesh(dev_array, ("data", "shard"))


def _bucketize(keys: u.U64, valid, dest, n_dest: int, lanes: int):
    """(n_dest, lanes) send buffers grouped by destination (the linear
    per-prefix buffers of kc-c4.c:69-83 with static shapes).  Built on
    the sort-based router, so the compiled program size is O(1) in
    n_dest; the routing sort is STABLE on the destination id alone, so
    within-destination lane order is the original stream order — a
    contract the mesh exact-bloom path depends on (see
    _bucketize_by_sort).  Returns (hi, lo, ok, n_dropped)."""
    s_hi, s_lo, n_drop = _bucketize_by_sort(keys, valid, dest, n_dest, lanes)
    # a real key is never all-ones: hash64 output < 2^(2k) <= 2^62 for
    # k < 32, and the k = 32 path collapses keys to 0 (kernels/kmer.py)
    ok = ~((s_hi == jnp.uint32(0xFFFFFFFF)) & (s_lo == jnp.uint32(0xFFFFFFFF)))
    return s_hi, s_lo, ok, n_drop


# the 5-plane CountTable PartitionSpec, shared by every table
# shard_map below (one definition: an arity change that missed a
# copy would only surface as a trace-time spec mismatch)
_TABLE_SPEC = (
    P("data", "shard", None),
    P("data", "shard", None),
    P("data", "shard", None),
    P("data", "shard", None),
    P("data", "shard"),
)


@lru_cache(maxsize=None)
def sharded_count_step_fn(mesh: Mesh, k: int, max_count: Optional[int],
                          lanes_per_dest: int):
    """Build the jitted multi-chip counting step.

    tables: CountTable with planes shaped (D, S, cap_local), sharded
            P("data", "shard", None)
    ascii:  (D*S, block) uint8, rows sharded over both axes
    Returns (tables', n_new_total, n_dropped_total).
    """
    n_dev = mesh.shape["data"] * mesh.shape["shard"]

    def per_device(table_planes, ascii_row):
        state, key_hi, key_lo, cnt, n_full = table_planes
        local = ct.CountTable(state[0, 0], key_hi[0, 0], key_lo[0, 0],
                              cnt[0, 0], n_full[0, 0])
        codes = encode_bases(ascii_row[0])
        out = extract_canonical(codes, k, apply_hash64=True)
        # route by low bits of the hashed k-mer (kc-c4.c:76 `y & (2^p-1)`)
        # over BOTH mesh axes: a key must have exactly one owning device
        # or the same k-mer arriving via different data rows would be
        # counted in two tables and the merged histogram would split it.
        dest = (out.kmer.lo & jnp.uint32(n_dev - 1)).astype(jnp.int32)
        s_hi, s_lo, s_ok, n_drop = _bucketize(
            out.kmer, out.valid, dest, n_dev, lanes_per_dest
        )
        axes = ("data", "shard")
        r_hi = jax.lax.all_to_all(s_hi, axes, 0, 0, tiled=True)
        r_lo = jax.lax.all_to_all(s_lo, axes, 0, 0, tiled=True)
        r_ok = jax.lax.all_to_all(s_ok, axes, 0, 0, tiled=True)
        keys = u.U64(r_hi.reshape(-1), r_lo.reshape(-1))
        local, n_new = ct.insert(local, keys, r_ok.reshape(-1), max_count)
        n_new_tot = jax.lax.psum(jax.lax.psum(n_new, "shard"), "data")
        n_drop_tot = jax.lax.psum(jax.lax.psum(n_drop, "shard"), "data")
        planes = (
            local.state[None, None],
            local.key_hi[None, None],
            local.key_lo[None, None],
            local.cnt[None, None],
            local.n_full[None, None],
        )
        return planes, n_new_tot, n_drop_tot

    table_spec = _TABLE_SPEC
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(table_spec, P(("data", "shard"), None)),
        out_specs=(table_spec, P(), P()),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


@lru_cache(maxsize=None)
def sharded_hist_fn(mesh: Mesh, n_bins: int):
    """Jitted global histogram: local bincount + psum over both axes
    (the reduction of kc-c4.c:219-233)."""

    def per_device(table_planes):
        state, key_hi, key_lo, cnt, n_full = table_planes
        local = ct.CountTable(state[0, 0], key_hi[0, 0], key_lo[0, 0],
                              cnt[0, 0], n_full[0, 0])
        h = ct.hist(local, n_bins)
        return jax.lax.psum(jax.lax.psum(h, "shard"), "data")

    table_spec = _TABLE_SPEC
    fn = shard_map(
        per_device, mesh=mesh, in_specs=(table_spec,), out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def _bucketize_by_sort(keys: u.U64, valid, dest, n_dest: int, lanes: int,
                       one_plane: bool = False):
    """Sort-based routing: ONE sort by destination groups each device's
    k-mers, then n_dest fixed-size windows are sliced at the bucket
    boundaries (sentinel-padded so slices never clamp).  Replaces the
    per-destination cumsum/scatter loop for the sort engine — the same
    "partition is a sort" principle as the count engine itself.
    one_plane (k <= 15: keys < 2^31): the hi plane is all-zero except
    sentinels, so it is dropped from the sort and synthesized from lo.
    Returns ((n_dest, lanes) hi/lo with sentinel empties, n_dropped).

    STABILITY IS LOAD-BEARING: num_keys=1 sorts on the destination id
    only and lax.sort is stable by default, so each destination's lanes
    keep their original stream order.  sharded_yak_ingest_fn's
    exact_bloom path relies on exactly this (each owner chip replays
    yak_bf_insert sequentially over the global stream order restricted
    to its keys) — do NOT add the key planes as extra sort keys for
    locality, and do not pass is_stable=False."""
    d = jnp.where(valid, dest, n_dest).astype(jnp.uint32)
    if one_plane:
        sd, s_lo = jax.lax.sort(
            (d, jnp.where(valid, keys.lo, jnp.uint32(0xFFFFFFFF))),
            num_keys=1,
        )
        s_hi = jnp.where(s_lo == jnp.uint32(0xFFFFFFFF),
                         jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    else:
        sd, s_hi, s_lo = jax.lax.sort(
            (d, jnp.where(valid, keys.hi, jnp.uint32(0xFFFFFFFF)),
             jnp.where(valid, keys.lo, jnp.uint32(0xFFFFFFFF))),
            num_keys=1,
        )
    # per-destination boundaries by binary search on the sorted dest ids:
    # O(n_dest log n) work and O(1) compiled program size in n_dest
    bounds = jnp.searchsorted(
        sd, jnp.arange(n_dest + 1, dtype=jnp.uint32)
    ).astype(jnp.int32)
    starts, cnt = bounds[:-1], bounds[1:] - bounds[:-1]
    pad = jnp.full((lanes,), jnp.uint32(0xFFFFFFFF))
    s_hi = jnp.concatenate([s_hi, pad])
    s_lo = jnp.concatenate([s_lo, pad])
    j = jnp.arange(lanes, dtype=jnp.int32)

    def _row(start, c):
        h = jax.lax.dynamic_slice(s_hi, (start,), (lanes,))
        l = jax.lax.dynamic_slice(s_lo, (start,), (lanes,))
        m = j < c
        return (jnp.where(m, h, jnp.uint32(0xFFFFFFFF)),
                jnp.where(m, l, jnp.uint32(0xFFFFFFFF)))

    # vmapped dynamic_slice lowers to one gather: still one op at n_dest=64
    rows_hi, rows_lo = jax.vmap(_row)(starts, cnt)
    n_drop = jnp.sum(jnp.maximum(cnt - lanes, 0))
    return rows_hi, rows_lo, n_drop


@lru_cache(maxsize=None)
def sharded_extract_step_fn(mesh: Mesh, k: int, lanes_per_dest: int,
                            row_bytes: Optional[int] = None,
                            ingest: str = "ascii"):
    """Build the jitted extract+route step of the sort-based multi-chip
    engine (the production counting path; see module docstring).

    ascii: (D*S, block) uint8, rows sharded over both axes.
    Returns (chunk_hi, chunk_lo) shaped (D, S, n_dev*lanes) — each
    device's newly OWNED k-mers (routed by the low bits of hash64 over
    both mesh axes, so every key has exactly one owner), sentinel-padded
    — plus (n_kmers_total, n_dropped_total).

    For k <= 15 (keys < 2^31) the hi plane is all-zero except sentinels:
    it is dropped from the routing sort AND from the all_to_all (half
    the interconnect bytes), then synthesized from lo on the receiving
    device.

    row_bytes (uniform reads, every read exactly row_bytes = L+1 ASCII
    bytes): the only possibly-valid lanes are window ends at in-row
    offsets k-1..L-1, so the guaranteed-invalid ~k/row_bytes fraction is
    sliced off before the routing sort and the all_to_all (~20% fewer
    lanes and interconnect bytes for 150 bp reads at k=31) — the mesh
    form of pipeline.counter._extract_step_rows.

    ingest: "ascii" (one u8/base), "packed" (2-bit codes + validity
    bitmask, 0.375 B/base over the host link), or "packed_structural"
    (codes + per-device used-byte count; the mask is rebuilt on device
    from row_bytes — 0.25 B/base; requires row_bytes).  The packed forms
    are the mesh twins of pipeline.counter._extract_step_packed[_structural]."""
    n_dev = mesh.shape["data"] * mesh.shape["shard"]
    one_plane = 2 * k <= 31
    assert ingest in ("ascii", "packed", "packed_structural")
    assert ingest != "packed_structural" or (row_bytes and row_bytes > k)

    def per_device(*args):
        from ..pipeline.counter import (_extract_planes, _structural_ascii,
                                        _unpack_ascii)

        if ingest == "ascii":
            ascii_row = args[0]
        elif ingest == "packed":
            packed_row, mask_row = args
            ascii_row = _unpack_ascii(packed_row[0], mask_row[0])[None]
        else:  # packed_structural: shared separator/tail predicate
            packed_row, n_used = args
            ascii_row = _structural_ascii(
                packed_row[0], n_used[0, 0].astype(jnp.uint32), row_bytes
            )[None]
        n_in = ascii_row.shape[1]
        e_hi, e_lo, _nk = _extract_planes(ascii_row[0], k)
        if row_bytes and row_bytes > k:
            n_rows = n_in // row_bytes
            span = n_rows * row_bytes
            e_hi = e_hi[:span].reshape(n_rows, row_bytes)[
                :, k - 1 : row_bytes - 1].reshape(-1)
            e_lo = e_lo[:span].reshape(n_rows, row_bytes)[
                :, k - 1 : row_bytes - 1].reshape(-1)
        kmer = u.U64(e_hi, e_lo)
        valid = ~(
            (e_hi == jnp.uint32(0xFFFFFFFF))
            & (e_lo == jnp.uint32(0xFFFFFFFF))
        )
        dest = (kmer.lo & jnp.uint32(n_dev - 1)).astype(jnp.int32)
        s_hi, s_lo, n_drop = _bucketize_by_sort(
            kmer, valid, dest, n_dev, lanes_per_dest, one_plane
        )
        axes = ("data", "shard")
        r_lo = jax.lax.all_to_all(s_lo, axes, 0, 0, tiled=True)
        if one_plane:
            r_hi = jnp.where(r_lo == jnp.uint32(0xFFFFFFFF),
                             jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
        else:
            r_hi = jax.lax.all_to_all(s_hi, axes, 0, 0, tiled=True)
        n_k = jax.lax.psum(
            jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), "shard"), "data"
        )
        n_d = jax.lax.psum(jax.lax.psum(n_drop, "shard"), "data")
        return (
            r_hi.reshape(1, 1, -1),
            r_lo.reshape(1, 1, -1),
            n_k,
            n_d,
        )

    row_spec = P(("data", "shard"), None)
    in_specs = (row_spec,) if ingest == "ascii" else (row_spec, row_spec)
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data", "shard", None), P("data", "shard", None), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


@lru_cache(maxsize=None)
def sharded_hist_from_chunks_fn(mesh: Mesh, n_bins: int, max_count=None,
                                min_keep: int = 1, weighted: bool = False,
                                one_plane: bool = False,
                                pre_sorted: bool = False):
    """Jitted global histogram over accumulated owned-key chunks:
    per-device sort + segment reduction (the single-chip engine's XLA
    core) + psum over both axes.  Keys are uniquely owned (see
    sharded_extract_step_fn), so local histograms sum exactly.
    pre_sorted: the per-device planes are already merged/sorted
    (stream-sorted mode) — skip the local sort."""
    from ..table.compactor import hist_core

    def per_device(hi, lo, cnt=None):
        h, nd = hist_core(hi[0, 0], lo[0, 0],
                          cnt[0, 0] if weighted else hi[0, 0],
                          n_bins, max_count, min_keep, weighted, one_plane,
                          pre_sorted)
        h = jax.lax.psum(jax.lax.psum(h, "shard"), "data")
        nd = jax.lax.psum(jax.lax.psum(nd, "shard"), "data")
        return h, nd

    spec = P("data", "shard", None)
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec, spec, spec) if weighted else (spec, spec),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


@lru_cache(maxsize=None)
def sharded_compact_fn(mesh: Mesh, one_plane: bool = False,
                       pre_sorted_raw: bool = False):
    """Jitted per-device compaction: fold each device's (keys, counts)
    lanes into unique (key, count) pairs (sort + segment sums, the
    single-chip compactor's core) — the distributed analog of
    KmerCompactor.compact, bounding memory on long streams.  Returns
    (chi, clo, ccnt) full-length with sentinel/zero tails plus the
    per-device unique count (callers slice to the max).
    pre_sorted_raw: the planes are already-sorted raw lanes (implicit
    count 1, stream-sorted mode) — skip the sort; cnt is ignored."""
    from ..table.compactor import _compact_impl

    def per_device(hi, lo, cnt):
        chi, clo, ccnt, nu = _compact_impl(
            hi[0, 0], lo[0, 0], cnt[0, 0],
            has_counts=not pre_sorted_raw,
            one_plane=one_plane, pre_sorted=pre_sorted_raw,
        )
        return (
            chi[None, None],
            clo[None, None],
            ccnt[None, None],
            nu[None, None],
        )

    spec = P("data", "shard", None)
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec, P("data", "shard")),
        check_vma=False,
    )
    return jax.jit(fn)


_SENT = jnp.uint32(0xFFFFFFFF)

# stream-sorted mode: per-DEVICE run quantum (smaller than the single-
# chip compactor's 2^24 — each device owns 1/n_dev of the lanes)
_MESH_STREAM_CHUNK = 1 << 22
_MESH_STREAM_MIN = 1 << 12


@lru_cache(maxsize=None)
def sharded_sort_chunk_fn(mesh: Mesh, one_plane: bool = False):
    """Sort each device's (1, 1, L) owned-key planes locally —
    stream-sorted mode's per-chunk sort, dispatched while the host is
    ingesting the next batch (the device is otherwise idle there)."""

    def per_device(hi, lo):
        if one_plane:
            s_lo = jax.lax.sort(lo[0, 0])
            s_hi = jnp.where(s_lo == _SENT, _SENT, jnp.uint32(0))
        else:
            s_hi, s_lo = jax.lax.sort((hi[0, 0], lo[0, 0]), num_keys=2)
        return s_hi[None, None], s_lo[None, None]

    spec = P("data", "shard", None)
    fn = shard_map(per_device, mesh=mesh, in_specs=(spec, spec),
                   out_specs=(spec, spec), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def sharded_merge_fn(mesh: Mesh, one_plane: bool = False):
    """Merge two equal-length per-device sorted runs with the bitonic
    merge cascade (kernels/bitonic.py), device-locally under shard_map —
    the multi-chip form of the single-chip stream ladder's carry."""
    from ..kernels import bitonic

    def per_device(ahi, alo, bhi, blo):
        cat_lo = jnp.concatenate([alo[0, 0], blo[0, 0]])
        if one_plane:
            m_lo = bitonic.merge_sorted_halves1(cat_lo)
            m_hi = jnp.where(m_lo == _SENT, _SENT, jnp.uint32(0))
        else:
            cat_hi = jnp.concatenate([ahi[0, 0], bhi[0, 0]])
            m_hi, m_lo = bitonic.merge_sorted_halves(cat_hi, cat_lo)
        return m_hi[None, None], m_lo[None, None]

    spec = P("data", "shard", None)
    fn = shard_map(per_device, mesh=mesh, in_specs=(spec,) * 4,
                   out_specs=(spec, spec), check_vma=False)
    return jax.jit(fn)


class ShardedSortEngine:
    """Multi-chip streaming counter on the sort-based engine.

    Each step consumes one (D*S, block) batch of packed ASCII rows,
    extracts and routes k-mers to their owning device (all_to_all over
    the interconnect), and appends the owned chunk to a per-device run
    list; when the per-device run bytes exceed budget_bytes the runs
    fold into unique
    (key, count) pairs (compaction by sort, as in the single-chip
    compactor), bounding memory on long streams.  hist() concatenates
    the state device-side and reduces.  This is the distributed form of
    kmer_tpu.pipeline.counter.SortCountEngine."""

    def __init__(self, mesh: Mesh, k: int, lanes_per_dest: Optional[int] = None,
                 budget_bytes: int = 2 << 30,
                 stream_sorted: Optional[bool] = None):
        from ..table.compactor import stream_sorted_default

        self.mesh = mesh
        self.k = k
        # same trick as the single-chip compactor: k <= 15 keys fit one
        # u32 plane, halving every per-device sort's comparator work
        self.one_plane = 2 * k <= 31
        self.n_dev = mesh.shape["data"] * mesh.shape["shard"]
        # low-bit routing and the per-chip bloom partition
        # (BloomSpec.owner_bits) both assume a power-of-two device count
        assert self.n_dev & (self.n_dev - 1) == 0, (
            f"mesh must have a power-of-two device count, got {self.n_dev}"
        )
        # None = auto-size send buffers per batch row length; an explicit
        # value fixes them for every shape (tests, fixed-block callers)
        self.lanes_per_dest = lanes_per_dest
        self._lane_mult = {}  # row_len -> overflow-doubling multiplier
        self._steps = {}  # lanes -> compiled extract+route step
        self.budget_bytes = budget_bytes
        self.chunks = []
        self.weighted = None  # (hi, lo, cnt) compacted (D, S, L) planes
        self._bytes = 0  # per-device run bytes
        self._inflight = None  # one-batch dispatch pipeline (add_batch)
        self.total_kmers = 0
        self.total_dropped = 0  # always 0 once flushed (auto-retry)
        self.total_retries = 0
        # stream-sorted accumulation (the multi-chip form of
        # KmerCompactor's stream mode): owned chunks fold into sorted
        # per-device runs as they arrive and a binary-counter ladder
        # (table.stream_ladder, shared with the single-chip compactor)
        # carry-merges them, all dispatched while the host ingests
        self.stream_sorted = (stream_sorted_default()
                              if stream_sorted is None else bool(stream_sorted))
        self.stream = self._make_ladder() if self.stream_sorted else None
        self._sort_fn = None
        self._merge_fn = None

    def _lanes_for(self, row_len: int) -> int:
        base = self.lanes_per_dest or default_lanes_per_dest(row_len,
                                                             self.n_dev)
        return base * self._lane_mult.get(row_len, 1)

    def _step_for(self, lanes: int, row_bytes: Optional[int] = None,
                  ingest: str = "ascii"):
        key = (lanes, row_bytes, ingest)
        if key not in self._steps:
            self._steps[key] = sharded_extract_step_fn(
                self.mesh, self.k, lanes, row_bytes, ingest
            )
        return self._steps[key]

    def reset(self) -> None:
        """Drop accumulated state, keeping compiled steps (for reuse
        across runs/benchmarks)."""
        self.chunks = []
        self.weighted = None
        self._bytes = 0
        self._inflight = None
        self.total_kmers = 0
        self.total_dropped = 0
        if self.stream is not None:
            self.stream.clear()

    def _dispatch(self, rows, row_bytes: Optional[int], aux,
                  ingest: str):
        """Extract + route one batch WITHOUT resolving its overflow
        check: returns a pending record whose counters (globally psum'd
        inside the step — identical on every process, so deferred
        resolution stays SPMD-consistent) are read by _resolve."""
        rb = row_bytes if row_bytes and row_bytes > self.k else None
        if ingest == "packed_structural" and rb is None:
            raise ValueError("structural packed ingest needs row_bytes")
        row_len = rows.shape[1] * (4 if ingest != "ascii" else 1)
        args = (rows,) if ingest == "ascii" else (rows, aux)
        hi, lo, nk, nd = self._step_for(self._lanes_for(row_len),
                                        rb, ingest)(*args)
        return (hi, lo, nk, nd, args, row_len, rb, ingest)

    def _resolve(self, pending):
        """Block on a pending batch's drop counter, replaying with
        doubled send lanes on overflow (the static-shape form of the
        reference's buffer realloc, kc-c4.c:78-80 — routing never
        drops).  Returns the per-device owned (hi, lo) chunk planes."""
        hi, lo, nk, nd, args, row_len, rb, ingest = pending
        while int(nd) > 0:
            self._lane_mult[row_len] = 2 * self._lane_mult.get(row_len, 1)
            self.total_retries += 1
            hi, lo, nk, nd = self._step_for(
                self._lanes_for(row_len), rb, ingest)(*args)
        self._total_kmers += int(nk)
        return hi, lo

    def route_batch(self, rows, row_bytes: Optional[int] = None,
                    aux=None, ingest: str = "ascii"):
        """Extract + route one batch WITHOUT accumulating: returns the
        per-device owned (hi, lo) chunk planes, never dropping (see
        _resolve).  Consumers that keep their own per-device state
        (MeshYakEngine's bloom-gated tables) build on this.

        ingest "packed"/"packed_structural": rows are (n_dev, W/4) 2-bit
        code planes and aux is the (n_dev, W/8) validity bitmask /
        (n_dev, 1) used-byte counts (see sharded_extract_step_fn)."""
        self._flush_inflight()
        return self._resolve(self._dispatch(rows, row_bytes, aux, ingest))

    def add_batch(self, rows, row_bytes: Optional[int] = None,
                  aux=None, ingest: str = "ascii") -> None:
        # one-batch-deep dispatch pipeline: resolve the PREVIOUS batch's
        # overflow counter (its step has already retired — the device
        # queue is in order — so the readback does not wait for the
        # batch just dispatched) while this batch computes.  This keeps
        # a host sync from sitting between consecutive mesh batches,
        # and bounds in-flight state at one batch + its input rows.
        pending = self._dispatch(rows, row_bytes, aux, ingest)
        prev, self._inflight = self._inflight, pending
        if prev is not None:
            self._commit(prev)

    def _commit(self, pending) -> None:
        hi, lo = self._resolve(pending)
        self.add_chunk_planes(hi, lo)

    def add_chunk_planes(self, hi, lo) -> None:
        """Accumulate an already-routed owned chunk (route_batch
        output) — for callers that need both the routed planes and the
        accumulated counts (MeshSortYakEngine's no-bloom pass 1)."""
        if self.stream_sorted:
            self._stream_add(hi, lo)
        else:
            self.chunks.append((hi, lo))
        self._bytes += hi.shape[2] * 8
        if self._bytes > self.budget_bytes:
            self.compact()

    def _flush_inflight(self) -> None:
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._commit(prev)

    @property
    def total_kmers(self) -> int:
        self._flush_inflight()
        return self._total_kmers

    @total_kmers.setter
    def total_kmers(self, v: int) -> None:
        self._total_kmers = int(v)

    # -- stream-sorted accumulation (see KmerCompactor counterpart; the
    # carry/fold invariants live in table.stream_ladder) ---------------

    def _make_ladder(self):
        from ..table.stream_ladder import StreamLadder

        return StreamLadder(
            chunk=_MESH_STREAM_CHUNK,
            min_pad=_MESH_STREAM_MIN,
            sort_fn=self._sort_chunk,
            merge_fn=self._s_merge,
            pad_fn=self._s_pad,
            concat_fn=lambda runs: tuple(
                jnp.concatenate([r[i] for r in runs], axis=2)
                for i in range(2)
            ),
            slice_fn=lambda p, a, b: tuple(x[:, :, a:b] for x in p),
            size_fn=lambda p: int(p[0].shape[2]),
        )

    def _stream_add(self, hi, lo) -> None:
        self.stream.add((hi, lo))

    def _sort_chunk(self, planes):
        if self._sort_fn is None:
            self._sort_fn = sharded_sort_chunk_fn(self.mesh, self.one_plane)
        return tuple(self._sort_fn(*planes))

    def _s_merge(self, a, b):
        if self._merge_fn is None:
            self._merge_fn = sharded_merge_fn(self.mesh, self.one_plane)
        return tuple(self._merge_fn(a[0], a[1], b[0], b[1]))

    @staticmethod
    def _s_pad(planes, target: int):
        n = planes[0].shape[2]
        if target == n:
            return planes
        d, s = planes[0].shape[:2]
        pad = jnp.full((d, s, target - n), _SENT, jnp.uint32)
        return tuple(jnp.concatenate([p, pad], axis=2) for p in planes)

    def _s_state(self) -> bool:
        return bool(self.stream)

    def _s_planes(self):
        return self.stream.planes()

    def _s_absorb(self) -> None:
        """Mixed state (compacted planes + stream runs): hand the merged
        stream planes to the classic chunk path (sorted raw lanes are a
        valid chunk)."""
        if not self.stream:
            return
        self.chunks.append(self.stream.planes())
        self.stream.clear()

    def _merged_planes(self):
        """Per-device (hi, lo, cnt) over raw chunks (implicit count 1)
        and any compacted state."""
        his = [c[0] for c in self.chunks]
        los = [c[1] for c in self.chunks]
        cnts = [jnp.ones_like(c[0]) for c in self.chunks]
        if self.weighted is not None:
            his.append(self.weighted[0])
            los.append(self.weighted[1])
            cnts.append(self.weighted[2])
        return (
            jnp.concatenate(his, axis=2),
            jnp.concatenate(los, axis=2),
            jnp.concatenate(cnts, axis=2),
        )

    def compact(self) -> None:
        self._flush_inflight()
        if self.stream_sorted and self._s_state():
            if self.weighted is None and not self.chunks:
                # pure stream state: compact straight off the merged
                # per-device planes (no sort at all)
                hi, lo = self._s_planes()
                fn = sharded_compact_fn(self.mesh, self.one_plane,
                                        pre_sorted_raw=True)
                self._store_weighted(*fn(hi, lo, hi))
                self.stream.clear()
                return
            self._s_absorb()
        if not self.chunks and self.weighted is None:
            return
        hi, lo, cnt = self._merged_planes()
        fn = sharded_compact_fn(self.mesh, self.one_plane)
        self._store_weighted(*fn(hi, lo, cnt))

    def _store_weighted(self, chi, clo, ccnt, nu) -> None:
        # slice every device to the largest unique count (static shape),
        # rounded to a size class; tails are sentinel keys with count 0.
        # On a multi-process run nu spans non-addressable devices: max
        # the local shards, then agree globally (every process must pick
        # the SAME size — the slice below is a collective program)
        local_max = max(
            (int(np.asarray(s.data).max()) for s in nu.addressable_shards),
            default=0,
        )
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            nu_max = int(multihost_utils.process_allgather(
                np.asarray([local_max], np.int64)).max())
        else:
            nu_max = local_max
        size = min(max(1 << 16, 1 << (max(nu_max - 1, 1)).bit_length()),
                   chi.shape[2])
        self.weighted = (
            chi[:, :, :size], clo[:, :, :size], ccnt[:, :, :size]
        )
        self.chunks = []
        self._bytes = size * 12

    def save_checkpoint(self, path: str) -> None:
        """Per-device compacted (key, count) planes as arrays (npz) —
        the multi-chip checkpoint analog (SURVEY.md §5).  Restoring
        requires the same mesh shape (keys stay with their owners)."""
        import os

        self.compact()
        if self.weighted is None:  # empty stream
            d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
            w = (np.full((d, s, 1), 0xFFFFFFFF, np.uint32),) * 2 + (
                np.zeros((d, s, 1), np.uint32),
            )
        else:
            w = tuple(np.asarray(p) for p in self.weighted)
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp, hi=w[0], lo=w[1], cnt=w[2],
            meta=np.asarray(
                [self.k, self.total_kmers, self.total_dropped], np.int64
            ),
        )
        os.replace(tmp, path)

    def restore_checkpoint(self, path: str) -> None:
        z = np.load(path)
        assert int(z["meta"][0]) == self.k, "checkpoint k mismatch"
        assert z["hi"].shape[:2] == (
            self.mesh.shape["data"], self.mesh.shape["shard"],
        ), "checkpoint mesh shape mismatch"
        self.reset()
        self.weighted = (
            jnp.asarray(z["hi"]), jnp.asarray(z["lo"]), jnp.asarray(z["cnt"])
        )
        self._bytes = z["hi"].shape[2] * 12
        self.total_kmers = int(z["meta"][1])
        self.total_dropped = int(z["meta"][2])

    def counts_for(self, query_hi, query_lo):
        """Total multiplicity of each query key (0 if absent), in query
        order — the distributed analog of KmerCompactor.counts_for."""
        self._flush_inflight()
        if (not self.chunks and self.weighted is None
                and not self._s_state()):
            return np.zeros(len(query_hi), np.int64)
        from ..table.compactor import prep_queries

        if self.stream_sorted and self._s_state():
            if self.weighted is None and not self.chunks:
                hi, lo = self._s_planes()
                pad_hi, pad_lo, q, inverse = prep_queries(
                    query_hi, query_lo, self.one_plane)
                fn = sharded_counts_for_fn(self.mesh, weighted=False,
                                           one_plane=self.one_plane,
                                           pre_sorted=True)
                out = fn(hi, lo, jnp.asarray(pad_hi), jnp.asarray(pad_lo))
                return np.asarray(out)[:q].astype(np.int64)[inverse]
            self._s_absorb()
        pad_hi, pad_lo, q, inverse = prep_queries(query_hi, query_lo,
                                                  self.one_plane)
        if self.weighted is None:
            hi = jnp.concatenate([c[0] for c in self.chunks], axis=2)
            lo = jnp.concatenate([c[1] for c in self.chunks], axis=2)
            fn = sharded_counts_for_fn(self.mesh, weighted=False,
                                       one_plane=self.one_plane)
            out = fn(hi, lo, jnp.asarray(pad_hi), jnp.asarray(pad_lo))
        else:
            hi, lo, cnt = self._merged_planes()
            fn = sharded_counts_for_fn(self.mesh, weighted=True,
                                       one_plane=self.one_plane)
            out = fn(hi, lo, jnp.asarray(pad_hi), jnp.asarray(pad_lo), cnt)
        return np.asarray(out)[:q].astype(np.int64)[inverse]

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        self._flush_inflight()
        if (not self.chunks and self.weighted is None
                and not self._s_state()):
            self._n_distinct = 0  # no input: empty histogram, like the
            return np.zeros((n_bins,), np.int32)  # single-chip compactor
        if self.stream_sorted and self._s_state():
            if self.weighted is None and not self.chunks:
                hi, lo = self._s_planes()
                fn = sharded_hist_from_chunks_fn(
                    self.mesh, n_bins, max_count, min_keep,
                    one_plane=self.one_plane, pre_sorted=True,
                )
                h, nd = fn(hi, lo)
                self._n_distinct = int(nd)
                return np.asarray(h)
            self._s_absorb()
        if self.weighted is None and self.chunks:
            hi = jnp.concatenate([c[0] for c in self.chunks], axis=2)
            lo = jnp.concatenate([c[1] for c in self.chunks], axis=2)
            fn = sharded_hist_from_chunks_fn(
                self.mesh, n_bins, max_count, min_keep,
                one_plane=self.one_plane,
            )
            h, nd = fn(hi, lo)
        else:
            hi, lo, cnt = self._merged_planes()
            fn = sharded_hist_from_chunks_fn(
                self.mesh, n_bins, max_count, min_keep, weighted=True,
                one_plane=self.one_plane,
            )
            h, nd = fn(hi, lo, cnt)
        self._n_distinct = int(nd)
        return np.asarray(h)


@lru_cache(maxsize=None)
def sharded_counts_for_fn(mesh: Mesh, weighted: bool, one_plane: bool = False,
                          pre_sorted: bool = False):
    """Jitted distributed sort-join (the multi-chip form of vaf-counter's
    global join).  Queries are REPLICATED to every device: each key's
    data lanes live on exactly one device (routing invariant of
    sharded_extract_step_fn), so non-owning devices report count 0 for
    it and a psum of the per-device answers is the global answer — no
    query routing collective needed.  Query keys must be unique
    (callers dedup, as in KmerCompactor.counts_for)."""
    from ..table.compactor import _counts_for_bs_impl

    def per_device(hi, lo, qhi, qlo, cnt=None):
        out = _counts_for_bs_impl(
            hi[0, 0], lo[0, 0], cnt[0, 0] if weighted else hi[0, 0],
            qhi, qlo, weighted, one_plane, pre_sorted,
        )
        return jax.lax.psum(jax.lax.psum(out, "shard"), "data")

    spec = P("data", "shard", None)
    in_specs = (spec, spec, P(), P()) + ((spec,) if weighted else ())
    fn = shard_map(
        per_device, mesh=mesh, in_specs=in_specs, out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)




def _local_table(table_planes):
    state, key_hi, key_lo, cnt, n_full = table_planes
    return ct.CountTable(state[0, 0], key_hi[0, 0], key_lo[0, 0],
                         cnt[0, 0], n_full[0, 0])


def _pack_table(local: ct.CountTable):
    return (
        local.state[None, None],
        local.key_hi[None, None],
        local.key_lo[None, None],
        local.cnt[None, None],
        local.n_full[None, None],
    )


@lru_cache(maxsize=None)
def sharded_yak_ingest_fn(mesh: Mesh, spec, create_new: bool,
                          use_bloom: bool, max_count: int,
                          exact_bloom: bool = False):
    """Jitted per-device bloom-gate + table-insert over routed owned
    chunks — the distributed yak_ch_insert_list (yak-count.c:150-177).
    Each device holds the bloom subtables and hash slots of the key
    prefixes it owns (spec.owner_bits partitioning), so gating and
    insertion are chip-local and conflict-free; only n_new is summed.

    exact_bloom reproduces yak_bf_insert's sequential test-and-set
    byte-exactly even on the mesh: the routing sort is STABLE on the
    destination key alone (_bucketize_by_sort), and the tiled
    all_to_all concatenates received segments in source-device order —
    the same order the stream chunks were laid out in (MeshYakEngine
    _step) — so each owner chip's local lane index increases with
    global stream position.  Every bloom bit and table slot has exactly
    one owner, so the reference's sequential process restricted to this
    chip's keys IS the sequential process over the received lanes in
    local order; no order ids need routing."""
    from ..kernels import bloom as bl

    def per_device(table_planes, bits, hi, lo):
        local = _local_table(table_planes)
        h, l = hi[0, 0], lo[0, 0]
        valid = ~((h == jnp.uint32(0xFFFFFFFF))
                  & (l == jnp.uint32(0xFFFFFFFF)))
        kmer = u.U64(h, l)
        b = bits[0, 0]
        n_dead = jnp.zeros((), jnp.int32)
        if create_new:
            if use_bloom:
                ins = bl.insert_sequential if exact_bloom else bl.insert
                b, preset = ins(b, kmer, valid, spec)
                local, n_new, n_dead = ct.insert_gated(
                    local, kmer, valid, preset, max_count)
            else:
                local, n_new = ct.insert(local, kmer, valid, max_count)
        else:
            local = ct.add_existing(local, kmer, valid, max_count)
            n_new = jnp.zeros((), jnp.int32)
        n_new_tot = jax.lax.psum(jax.lax.psum(n_new, "shard"), "data")
        # MAX per-device tombstones: growth must relieve the worst
        # device's probe chains, not the average's
        n_dead_max = jax.lax.pmax(jax.lax.pmax(n_dead, "shard"), "data")
        return _pack_table(local), b[None, None], n_new_tot, n_dead_max

    chunk_spec = P("data", "shard", None)
    fn = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(_TABLE_SPEC, chunk_spec, chunk_spec, chunk_spec),
        out_specs=(_TABLE_SPEC, chunk_spec, P(), P()),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))


@lru_cache(maxsize=None)
def sharded_clear_fn(mesh: Mesh):
    """Per-device count zeroing (yak_ch_clear, yak-count.c:190-204)."""

    def per_device(table_planes):
        return _pack_table(ct.clear_counts(_local_table(table_planes)))

    fn = shard_map(per_device, mesh=mesh, in_specs=(_TABLE_SPEC,),
                   out_specs=_TABLE_SPEC, check_vma=False)
    return jax.jit(fn, donate_argnums=(0,))


@lru_cache(maxsize=None)
def sharded_rebuild_fn(mesh: Mesh, new_capacity: int, min_count: int = 0,
                       max_count=None):
    """Per-device rebuild into fresh tables of new_capacity keeping
    counts in [min_count, max_count] — the distributed yak_ch_shrink
    (yak-count.c:243-277) and the growth rehash (khashl.h:152-195)."""

    def per_device(table_planes):
        return _pack_table(
            ct.rebuild(_local_table(table_planes), new_capacity,
                       min_count, max_count)
        )

    fn = shard_map(per_device, mesh=mesh, in_specs=(_TABLE_SPEC,),
                   out_specs=_TABLE_SPEC, check_vma=False)
    return jax.jit(fn, donate_argnums=(0,))


@lru_cache(maxsize=None)
def sharded_chunk_valid_max_fn(mesh: Mesh):
    """Replicated MAX over devices of non-sentinel lanes in a routed
    chunk — the pre-insert sizing input (a batch can at worst create one
    key per valid lane, so every table needs that much headroom for the
    probe loop to terminate; see pipeline.yak._maybe_grow).  Replicated
    output so multi-process hosts can read it without owning all
    shards."""

    def per_device(hi, lo):
        valid = ~((hi[0, 0] == jnp.uint32(0xFFFFFFFF))
                  & (lo[0, 0] == jnp.uint32(0xFFFFFFFF)))
        n = jnp.sum(valid.astype(jnp.int32))
        return jax.lax.pmax(jax.lax.pmax(n, "shard"), "data")

    spec = P("data", "shard", None)
    fn = shard_map(per_device, mesh=mesh, in_specs=(spec, spec),
                   out_specs=P(), check_vma=False)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def sharded_nfull_stats_fn(mesh: Mesh):
    """Replicated (max, sum) of the per-device table occupancy — grow
    decisions and the post-shrink distinct total, multi-process-safe."""

    def per_device(table_planes):
        nf = table_planes[4][0, 0]
        mx = jax.lax.pmax(jax.lax.pmax(nf, "shard"), "data")
        sm = jax.lax.psum(jax.lax.psum(nf, "shard"), "data")
        return mx, sm

    fn = shard_map(per_device, mesh=mesh, in_specs=(_TABLE_SPEC,),
                   out_specs=(P(), P()), check_vma=False)
    return jax.jit(fn)


def make_sharded_tables(mesh: Mesh, cap_local: int):
    """Allocate (D, S, cap_local) table planes with the mesh sharding."""
    d, s = mesh.shape["data"], mesh.shape["shard"]
    specs = [
        P("data", "shard", None),
        P("data", "shard", None),
        P("data", "shard", None),
        P("data", "shard", None),
        P("data", "shard"),
    ]
    arrays = (
        jnp.zeros((d, s, cap_local), jnp.uint8),
        jnp.zeros((d, s, cap_local), jnp.uint32),
        jnp.zeros((d, s, cap_local), jnp.uint32),
        jnp.zeros((d, s, cap_local), jnp.uint32),
        jnp.zeros((d, s), jnp.int32),
    )
    return tuple(
        jax.device_put(a, NamedSharding(mesh, sp)) for a, sp in zip(arrays, specs)
    )
