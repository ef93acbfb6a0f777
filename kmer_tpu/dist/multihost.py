"""Multi-host runtime: jax.distributed init, per-host input sharding,
and the cross-host driver loop for the sharded sort engine.

The reference is single-node shared memory (pthreads + atomics,
SURVEY.md §2.3 P7) — this module is the new-build territory SURVEY.md §5
(last row) calls for: FASTQ files data-parallel across hosts over DCN,
k-mer routing by hash prefix across devices over the interconnect
(kmer_tpu.dist.sharded), histogram merges via psum, process-0 output.

Host coordination: every host must participate in every collective, but
file shards drain at different rates, so each step first agrees (one
tiny psum) whether any host still has data; exhausted hosts contribute
all-zero blocks (zero bytes are invalid bases — no k-mers, no effect).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..pipeline.counter import _iter_packed
from ..utils.cli import env_flag
from . import sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var defaults
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or
    the cluster auto-detection JAX ships).  Call before any
    other JAX use on every host.  A single-process run needs no init."""
    if num_processes in (None, 1) and os.environ.get("JAX_NUM_PROCESSES", "1") == "1" \
            and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard_files(paths: Sequence[str], process_index: Optional[int] = None,
                process_count: Optional[int] = None) -> List[str]:
    """Deterministic round-robin file assignment for this host (the
    multi-host form of the reference's one-reader kt_pipeline step 0)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [p for i, p in enumerate(paths) if i % pc == pi]


def single_reader() -> bool:
    """KMER_TPU_SINGLE_READER=1: process 0 reads EVERY file and
    broadcasts each global batch over DCN, instead of per-host file
    sharding.  Batch composition (and with it the yak per-batch stderr
    totals and bloom admission order — PARITY.md divergences 8/10) then
    matches a 1-process run of the same mesh; the cost is that ingest
    is bounded by one host's reader + the broadcast."""
    return env_flag("KMER_TPU_SINGLE_READER", False)


def _bcast_batches(paths: Sequence[str], k: int, block: int, n_rows: int,
                   qual_policy=None, capacity: Optional[int] = None):
    """Single-reader iterator: process 0 packs GLOBAL (n_rows, width)
    batches over all files; every process receives identical
    (rows, n_bases, n_seqs, row_bytes) via broadcast_one_to_all.  Every
    yield is a collective — all processes must consume in lockstep (no
    prefetch thread: interleaving two threads' collectives deadlocks).
    `capacity` (row width, >= block) must match the comparison target's
    packing geometry: batch-composition parity with a 1-process
    MeshYakEngine run requires its capacity_block, because buffers
    split where the PACKER runs out of room, not at the batch rule."""
    from jax.experimental import multihost_utils

    pid = jax.process_index()
    width = capacity or block
    it = (_local_batches(paths, k, block, n_rows, qual_policy, capacity)
          if pid == 0 else None)
    zeros = None
    while True:
        item = next(it, None) if pid == 0 else None
        if pid == 0:
            hdr = np.asarray(
                [0, 0, 0, -1] if item is None else
                [1, item[1], item[2], item[3] if item[3] else -1],
                np.int64)
        else:
            hdr = np.zeros(4, np.int64)
        hdr = multihost_utils.broadcast_one_to_all(hdr)
        if int(hdr[0]) == 0:
            return
        if pid == 0:
            rows = item[0]
        else:
            if zeros is None:
                zeros = np.zeros((n_rows, width), np.uint8)
            rows = zeros
        rows = np.asarray(multihost_utils.broadcast_one_to_all(rows))
        yield (rows, int(hdr[1]), int(hdr[2]),
               int(hdr[3]) if int(hdr[3]) > 0 else None)


def _local_batches(paths: Sequence[str], k: int, block: int,
                   n_local_rows: int, qual_policy=None,
                   capacity: Optional[int] = None):
    """Pack this host's files into (n_local_rows, width) uint8 batches
    (width = capacity or block); yields
    (rows, n_bases, n_seqs, row_bytes_if_uniform)."""
    width = capacity or block
    rows, rbs, nb, ns = [], [], 0, 0
    for buf, b_nb, b_ns, rb, _be in _iter_packed(paths, k, block, width,
                                            qual_policy):
        b = buf if buf.shape[0] == width else np.pad(buf, (0, width - buf.shape[0]))
        rows.append(b)
        rbs.append(rb)
        nb += int(b_nb)  # _iter_packed reports TRUE bases already
        ns += int(b_ns)
        if len(rows) == n_local_rows:
            yield (np.stack(rows), nb, ns,
                   rbs[0] if len(set(rbs)) == 1 else None)
            rows, rbs, nb, ns = [], [], 0, 0
    if rows:
        pad = [np.zeros(width, np.uint8)] * (n_local_rows - len(rows))
        yield (np.stack(rows + pad), nb, ns,
               rbs[0] if len(set(rbs)) == 1 else None)


class MultihostSortEngine:
    """The local engines' interface (count_paths / hist / counts_for /
    totals) across every device of every host.  EVERY method is a
    collective: the CLI runs SPMD on all hosts, so each process calls
    the same methods in the same order (files shard round-robin per
    host, exhausted hosts contribute all-zero blocks, histograms and
    joins psum; see module docstring).  Output emission is gated to
    process 0 by the tools (utils.log.is_primary)."""

    def __init__(self, k: int, block_bases: int = 10_000_000,
                 budget_bytes: int = 2 << 30, prefetch: bool = True,
                 qual_policy=None,
                 lanes_per_dest: Optional[int] = None):
        self.k = k
        self.mesh = sharded.make_mesh(jax.devices())
        self.n_dev = len(jax.devices())
        self.n_local = len(jax.local_devices())
        self.row_bases = max(int(block_bases) // self.n_dev, 1 << 16)
        self.qual_policy = qual_policy
        self.prefetch = prefetch
        self.eng = sharded.ShardedSortEngine(
            self.mesh, k, lanes_per_dest=lanes_per_dest,
            budget_bytes=budget_bytes,
        )
        self._sharding = NamedSharding(self.mesh, P(("data", "shard"), None))
        self.total_bases = 0  # GLOBAL totals (allgathered per count_paths)
        self.total_seqs = 0

    @property
    def total_kmers(self):
        return self.eng.total_kmers  # psum'd inside the step: global

    def count_paths(self, paths: Sequence[str], progress=None) -> None:
        if single_reader() and jax.process_count() > 1:
            self._count_single_reader(paths, progress)
            return
        local_it = _local_batches(
            shard_files(paths), self.k, self.row_bases, self.n_local,
            self.qual_policy,
        )
        if self.prefetch:
            # read/pack the NEXT local batch while this one is in the
            # collective step (the P1 overlap; the collectives
            # themselves must stay on the calling thread)
            from ..pipeline.counter import _prefetch

            local_it = _prefetch(local_it)
        local_bases = local_seqs = 0
        while True:
            item = next(local_it, None)
            has = item is not None
            if has:
                local, nb, ns, rb = item
                local_bases += nb
                local_seqs += ns
            else:
                local = np.zeros((self.n_local, self.row_bases), np.uint8)
                rb = None
            if jax.process_count() > 1:
                # agree on continuation AND row stride in one collective:
                # every host must run the SAME program each step (SPMD),
                # so the row-sliced fast path engages only when every
                # host reports the identical row_bytes — an exhausted
                # host's filler batch (rb None -> -1) downgrades the
                # step to the generic path for everyone (the same rule
                # as MeshYakEngine._count_multiprocess)
                from jax.experimental import multihost_utils

                state = multihost_utils.process_allgather(
                    np.asarray([1 if has else 0, rb if rb else -1],
                               np.int64)
                )
                if int(state[..., 0].sum()) == 0:
                    break
                rbs = state[..., 1].ravel()
                rb = int(rbs[0])
                rb = rb if rb > 0 and (rbs == rb).all() else None
            elif not has:
                break
            global_rows = jax.make_array_from_process_local_data(
                self._sharding, local
            )
            self.eng.add_batch(global_rows, row_bytes=rb)
            if progress is not None:
                progress(self)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            tot = multihost_utils.process_allgather(
                np.asarray([local_bases, local_seqs], np.int64)
            )
            self.total_bases += int(tot[..., 0].sum())
            self.total_seqs += int(tot[..., 1].sum())
        else:
            self.total_bases += local_bases
            self.total_seqs += local_seqs
        # resolve the deferred last batch so retry totals are final (and
        # every process leaves count_paths at the same collective step)
        self.eng._flush_inflight()
        if self.eng.total_retries and jax.process_index() == 0:
            import sys

            sys.stderr.write(
                f"[W::count_multihost] key skew overflowed the routing "
                f"buffers {self.eng.total_retries}x; auto-doubled the "
                f"send lanes and replayed (no k-mers dropped)\n"
            )

    def _count_single_reader(self, paths: Sequence[str], progress) -> None:
        """Single-reader mode (see single_reader()): consume broadcast
        GLOBAL batches; the n_bases/n_seqs in each header are already
        global totals, so no end-of-run allgather."""
        for rows, nb, ns, rb in _bcast_batches(
                paths, self.k, self.row_bases, self.n_dev,
                self.qual_policy):
            self.total_bases += nb
            self.total_seqs += ns
            global_rows = jax.make_array_from_callback(
                (self.n_dev, self.row_bases), self._sharding,
                lambda idx: rows[idx],
            )
            self.eng.add_batch(global_rows, row_bytes=rb)
            if progress is not None:
                progress(self)
        self.eng._flush_inflight()
        if self.eng.total_retries and jax.process_index() == 0:
            import sys

            sys.stderr.write(
                f"[W::count_multihost] key skew overflowed the routing "
                f"buffers {self.eng.total_retries}x; auto-doubled the "
                f"send lanes and replayed (no k-mers dropped)\n"
            )

    def hist(self, n_bins: int, max_count=None, min_keep: int = 1):
        h = self.eng.hist(n_bins, max_count, min_keep)
        self._n_distinct = self.eng._n_distinct
        return h

    def counts_for(self, query_hi, query_lo):
        """Queries must be IDENTICAL on every host (each host loads the
        same pattern file); the join is a collective."""
        return self.eng.counts_for(query_hi, query_lo)

    def _ckpt_file(self, path: str, pid=None, pc=None) -> str:
        pid = jax.process_index() if pid is None else pid
        pc = jax.process_count() if pc is None else pc
        return f"{path}.proc{pid}of{pc}.npz"

    def save_checkpoint(self, path: str) -> None:
        """Pod-safe checkpoint: one shard file PER PROCESS
        (path.procIofN.npz), each holding only that host's addressable
        device planes — no cross-host gather.  save is a collective
        (the compaction runs on every process) and ends with a barrier
        so no process returns before every shard file is published."""
        self.eng.compact()  # collective: all processes participate
        pid, pc = jax.process_index(), jax.process_count()
        d, s = self.mesh.shape["data"], self.mesh.shape["shard"]
        blocks = {}
        if self.eng.weighted is None:  # empty stream: sentinel planes
            for dev in jax.local_devices():
                pos = [i for i, dv in enumerate(self.mesh.devices.ravel())
                       if dv == dev]
                di, si = divmod(pos[0], s)
                blocks[f"hi_{di}_{si}"] = np.full((1, 1, 1), 0xFFFFFFFF,
                                                  np.uint32)
                blocks[f"lo_{di}_{si}"] = blocks[f"hi_{di}_{si}"]
                blocks[f"cnt_{di}_{si}"] = np.zeros((1, 1, 1), np.uint32)
            size = 1
        else:
            for name, arr in zip(("hi", "lo", "cnt"), self.eng.weighted):
                for sh in arr.addressable_shards:
                    di = sh.index[0].start or 0
                    si = sh.index[1].start or 0
                    blocks[f"{name}_{di}_{si}"] = np.asarray(sh.data)
            size = self.eng.weighted[0].shape[2]
        import os as _os

        f = self._ckpt_file(path)
        tmp = f + ".tmp.npz"
        np.savez_compressed(
            tmp,
            meta=np.asarray(
                [self.k, d, s, pc, pid, size,
                 self.eng.total_kmers, self.eng.total_dropped,
                 self.total_bases, self.total_seqs], np.int64),
            **blocks,
        )
        _os.replace(tmp, f)
        if pc > 1:  # barrier: every shard file on disk before returning
            from jax.experimental import multihost_utils

            multihost_utils.process_allgather(np.asarray([1], np.int64))

    def resume_checkpoint_into(self, path: str) -> None:
        """Rebuild from per-process shard files.  Validates that k, the
        mesh shape and the process layout match the saving run (keys
        must stay with their owning devices)."""
        pid, pc = jax.process_index(), jax.process_count()
        z = np.load(self._ckpt_file(path))
        k, d, s, zpc, zpid, size, tk, td, tb, ts = (
            int(x) for x in z["meta"])
        if k != self.k:
            raise ValueError(f"checkpoint k={k} != engine k={self.k}")
        if (d, s) != (self.mesh.shape["data"], self.mesh.shape["shard"]):
            raise ValueError(
                f"checkpoint mesh {d}x{s} != current "
                f"{self.mesh.shape['data']}x{self.mesh.shape['shard']}")
        if (zpc, zpid) != (pc, pid):
            raise ValueError(
                f"checkpoint written by process {zpid}/{zpc}, "
                f"loaded by {pid}/{pc}")
        sharding = NamedSharding(self.mesh, P("data", "shard", None))
        self.eng.reset()

        def plane(name):
            def cb(index):
                di = index[0].start or 0
                si = index[1].start or 0
                return z[f"{name}_{di}_{si}"]

            return jax.make_array_from_callback((d, s, size), sharding, cb)

        self.eng.weighted = (plane("hi"), plane("lo"), plane("cnt"))
        self.eng._bytes = size * 12
        self.eng.total_kmers = tk
        self.eng.total_dropped = td
        self.total_bases, self.total_seqs = tb, ts


def count_multihost(paths: Sequence[str], k: int,
                    block: int = 4_194_304,
                    lanes_per_dest: Optional[int] = None,
                    n_bins: int = 256,
                    max_count: Optional[int] = 1023,
                    min_keep: int = 1,
                    queries=None):
    """Count canonical k-mers across every device of every host.

    Returns (hist, n_distinct) replicated on all hosts — plus, when
    `queries` = (query_hi, query_lo) numpy arrays IDENTICAL on every
    host, the distributed sort-join counts for those keys (the
    multi-host vaf path).  Callers print from process 0 only.
    Single-process invocations degrade to the plain sharded engine over
    the local devices."""
    eng = MultihostSortEngine(
        k, block_bases=block * len(jax.devices()),
        lanes_per_dest=lanes_per_dest,
    )
    eng.count_paths(paths)
    h = eng.hist(n_bins, max_count=max_count, min_keep=min_keep)
    if queries is not None:
        qc = eng.counts_for(queries[0], queries[1])
        return h, eng._n_distinct, qc
    return h, eng._n_distinct
