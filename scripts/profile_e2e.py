#!/usr/bin/env python3
"""Per-stage profile of the end-to-end kc-c4 job.

Isolates each pipeline stage of the e2e bench metric and prints one
line per stage, so "where do the seconds go" is measured, not argued:

  reader   host-only: native gzip decode + FASTQ parse + 2-bit pack,
           no device involved (the kt_pipeline step-0 analog)
  upload   host->device transfer of the SAME packed blocks through N
           uploader streams (bytes/s per stream and aggregate)
  device   extraction + stream-sort compactor on pre-staged blocks
  e2e      the real pipelined run, split into loop (last dispatch),
           drain (device catches up), finalize (hist)

Usage: python scripts/profile_e2e.py [reader|upload|device|e2e ...]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

K = 31
BLOCK_BASES = 10_000_000


def reads_path():
    from kmer_tpu.utils import synth

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return synth.ensure_reads_file(os.path.join(root, "bench_data"), 256)


def stage_reader(path):
    from kmer_tpu.pipeline.counter import _iter_packed2

    t0 = time.time()
    nb = 0
    blocks = []
    for packed, mask, n, n_bases, n_seqs, rb, _be in _iter_packed2(
        [path], K, BLOCK_BASES, BLOCK_BASES + 4096,
        ("resume", K, 3),
    ):
        nb += int(n_bases)
        blocks.append((packed, mask, n, rb))
    dt = time.time() - t0
    pk_bytes = sum(p.nbytes + (m.nbytes if m is not None else 0)
                   for p, m, _n, _rb in blocks)
    print(f"[reader] {nb/1e6:.0f} Mbases in {dt:.2f}s = {nb/1e6/dt:.1f} Mb/s "
          f"host-only; {len(blocks)} blocks, {pk_bytes/1e6:.0f} MB packed "
          f"({pk_bytes*1e3/nb:.0f} B/kbase)", flush=True)
    return blocks, nb


def stage_upload(blocks, nb):
    import jax

    from kmer_tpu.pipeline.counter import _pipelined_map, _upload_threads

    jax.device_put(np.zeros(64, np.uint8)).block_until_ready()  # init

    def up(item):
        p, m, _n, _rb = item
        t0 = time.time()
        nbytes = p.nbytes
        d = jax.device_put(p)
        if m is not None:
            jax.device_put(m).block_until_ready()
            nbytes += m.nbytes
        d.block_until_ready()
        return nbytes, time.time() - t0

    w = _upload_threads()
    t0 = time.time()
    per = list(_pipelined_map(up, iter(blocks), workers=w, depth=2 * w))
    dt = time.time() - t0
    total = sum(b for b, _ in per)
    busy = sum(t for _, t in per)
    print(f"[upload] {total/1e6:.0f} MB in {dt:.2f}s = "
          f"{total/1e6/dt:.1f} MB/s aggregate over {w} streams "
          f"({total/1e6/busy:.1f} MB/s/stream busy-weighted); "
          f"= {nb/1e6/dt:.1f} Mbases/s", flush=True)


def stage_device(blocks, nb):
    import jax.numpy as jnp

    from kmer_tpu.pipeline.counter import (_extract_step_packed,
                                           _extract_step_packed_structural)
    from kmer_tpu.table.compactor import KmerCompactor, stream_sorted_default

    dev = []
    for p, m, n, rb in blocks:
        dm = jnp.asarray(m) if m is not None else None
        dev.append((jnp.asarray(p), dm, n, rb))
    dev[-1][0].block_until_ready()

    def run():
        comp = KmerCompactor(budget_bytes=6 << 30, key_bits=2 * K,
                             stream_sorted=stream_sorted_default())
        for p, m, n, rb in dev:
            rb2 = rb if rb and rb > K else None
            if m is None:
                hi, lo, _nk = _extract_step_packed_structural(
                    p, jnp.uint32(n), K, rb2)
            else:
                hi, lo, _nk = _extract_step_packed(p, m, K, rb2)
            comp.add_raw(hi, lo)
        return comp.hist(256, max_count=1023)

    t0 = time.time()
    run()  # compile
    warm = time.time() - t0
    t0 = time.time()
    _h, nd = run()
    dt = time.time() - t0
    print(f"[device] {nb/1e6:.0f} Mbases in {dt:.2f}s = {nb/1e6/dt:.1f} Mb/s "
          f"(incl. hist finalize; warm {warm:.1f}s; {nd} distinct)",
          flush=True)


def stage_e2e(path):
    from kmer_tpu.pipeline.counter import SortCountEngine

    for i in range(2):
        eng = SortCountEngine(k=K, block_bases=BLOCK_BASES,
                              qual_policy=("resume", K, 3))
        t0 = time.time()
        eng.count_paths([path])
        t_loop = time.time() - t0
        # drain: force the dispatched stream to complete
        _ = eng.total_kmers
        t_drain = time.time() - t0 - t_loop
        eng.hist(256, max_count=1023)
        t_fin = time.time() - t0 - t_loop - t_drain
        dt = time.time() - t0
        tag = "compile" if i == 0 else "timed"
        print(f"[e2e {tag}] {eng.total_bases/1e6:.0f} Mbases in {dt:.2f}s = "
              f"{eng.total_bases/1e6/dt:.1f} Mb/s  "
              f"(loop {t_loop:.2f}s, drain {t_drain:.2f}s, "
              f"finalize {t_fin:.2f}s)", flush=True)
        del eng


def main(argv):
    stages = argv[1:] or ["reader", "upload", "device", "e2e"]
    path = reads_path()
    blocks = nb = None
    for s in stages:
        if s == "reader":
            blocks, nb = stage_reader(path)
        elif s == "upload":
            if blocks is None:
                blocks, nb = stage_reader(path)
            stage_upload(blocks, nb)
        elif s == "device":
            if blocks is None:
                blocks, nb = stage_reader(path)
            stage_device(blocks, nb)
        elif s == "e2e":
            stage_e2e(path)
        else:
            raise SystemExit(f"unknown stage {s!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
