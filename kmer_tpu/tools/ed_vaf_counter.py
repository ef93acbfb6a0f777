"""ed-vaf-counter — VAF by approximate pattern search in reads.

Reference parity with /root/reference/ed-vaf-counter.c:156-236: for
every read x every pattern, count optimal end locations of the ref and
alt k-mers within edit distance -e (edlib HW/LOC semantics), then emit
the standard VAF file.

The O(reads x patterns x read_len) search runs as the Myers bit-vector
kernel on the device (kmer_tpu.kernels.myers), batched over reads; the
reference is single-threaded edlib (ed-vaf-counter.c:137-150).
"""

from __future__ import annotations

import sys

import numpy as np

import jax.numpy as jnp

from ..io.fastx import FastxReader
from ..io.formats import read_patterns, write_vaf_file
from ..kernels.myers import (
    build_peq,
    build_peq_multiword,
    myers_hw_counts,
    myers_hw_counts_multiword,
)
from ..utils.cli import c_atoi, ketopt
from ..utils.log import minfo

# reads are batched by length bucket (powers of 4 from 1 KiB); each
# bucket compiles one kernel instance, so arbitrary read lengths
# (nanopore/PacBio) process exactly like the reference's edlib
_MIN_BUCKET = 1024
_BATCH_BYTES = 1 << 21  # rows per bucket = _BATCH_BYTES // bucket
_KERNEL_MAX_PAT = 32  # one-word limit; longer -> multi-word kernel batch


def _bucket_for(length: int) -> int:
    b = _MIN_BUCKET
    while b < length:
        b *= 4
    return b


def _alphabet_lut(kmers):
    """edlib compares RAW bytes (no case folding, 'N' == 'N'): its
    transformSequences maps each distinct byte to its own letter
    (edlib.cpp:1417).  Reproduce that with the alphabet of distinct
    PATTERN bytes; read bytes outside it map to one catch-all code that
    matches nothing (equality against a pattern byte is all that
    counting needs)."""
    alpha = sorted(set(b"".join(kmers)))
    n_alpha = max(1, len(alpha))
    assert n_alpha <= 255, "pattern bytes exceed the uint8 code space"
    # (the 255 buffer fill below stays a never-match code)
    lut = np.full(256, n_alpha, np.uint8)
    for idx, byte in enumerate(alpha):
        lut[byte] = idx
    return lut, n_alpha


def _encode(seq: bytes, lut) -> np.ndarray:
    return lut[np.frombuffer(seq, np.uint8)]


def _openable(fn) -> bool:
    if fn == "-":
        return True
    try:
        open(fn, "rb").close()
        return True
    except OSError:
        return False


def count_fastq(fn, patterns, max_e, totals):
    """Accumulate per-pattern (ref, alt) counts over all reads in fn."""
    if not _openable(fn):
        # ed-vaf-counter.c:130
        sys.stderr.write(f"Warning: failed to open {fn}\n")
        return
    # pattern kmers -> code matrix (2P, Lp); patterns longer than the
    # kernel's 32-base word go through the host multi-word path
    kmers = []
    for p in patterns:
        r = p.ref_kmer.encode("latin-1")
        a = p.alt_kmer.encode("latin-1")
        # the reference caches kmer_len = strlen(ref_kmer) once and
        # passes it for BOTH searches (ed-vaf-counter.c:77,143-146):
        # an alt k-mer longer than its ref is truncated to the ref's
        # length; a shorter one is searched over the ref's length —
        # its buffer's terminating NUL then padding (bytes past the
        # NUL are uninitialized in the C tool; see PARITY.md)
        m = len(r)
        a = a[:m] if len(a) >= m else a + b"\x00" * (m - len(a))
        kmers.append(r)
        kmers.append(a)
    lut, n_alpha = _alphabet_lut(kmers)
    long_idx = [i for i, x in enumerate(kmers) if len(x) > _KERNEL_MAX_PAT]
    if long_idx:
        # one multi-word kernel batch covers every long pattern
        # (kmer_tpu.kernels.myers.myers_hw_counts_multiword)
        lp_long = max(len(kmers[i]) for i in long_idx)
        n_words = (lp_long + 31) // 32
        PL = len(long_idx)
        PLpad = max(128, ((PL + 127) // 128) * 128)
        pcl = np.full((PLpad, lp_long), 255, np.uint8)
        plenl = np.full(PLpad, lp_long, np.int32)
        for j, i in enumerate(long_idx):
            x = kmers[i]
            pcl[j, : len(x)] = _encode(x, lut)
            plenl[j] = len(x)
        peq_long = build_peq_multiword(
            jnp.asarray(pcl), jnp.asarray(plenl), n_alpha, n_words
        )
        plenl_j = jnp.asarray(plenl)
    lp = max(
        (len(x) for x in kmers if len(x) <= _KERNEL_MAX_PAT), default=1
    )
    pc = np.full((len(kmers), lp), 255, np.uint8)
    plen = np.zeros(len(kmers), np.int32)
    for i, x in enumerate(kmers):
        if len(x) > _KERNEL_MAX_PAT:
            plen[i] = lp  # kernel lane is a dummy; host path counts it
            continue
        pc[i, : len(x)] = _encode(x, lut)
        plen[i] = len(x)
    # pad pattern axis to a lane multiple
    P = len(kmers)
    Ppad = max(128, ((P + 127) // 128) * 128)
    pc = np.vstack([pc, np.full((Ppad - P, lp), 255, np.uint8)])
    plen_pad = np.concatenate([plen, np.full(Ppad - P, lp, np.int32)])
    peq = build_peq(jnp.asarray(pc), jnp.asarray(plen_pad), n_alpha)
    plen_j = jnp.asarray(plen_pad)

    acc = np.zeros((Ppad,), np.int64)
    batches = {}  # bucket -> [codes2d, lens, fill]

    def flush(bucket):
        codes, lens, nb = batches.pop(bucket)
        if nb == 0:
            return
        # keep shapes static per bucket (one XLA compile each): flush
        # the full buffer with lens zeroed past the fill — zero-length
        # rows contribute count 0.  Buffers are freshly allocated per
        # batch and discarded after this call (no alias hazard).
        lens[nb:] = 0
        counts = myers_hw_counts(
            peq, plen_j, jnp.asarray(codes), jnp.asarray(lens), max_e
        )
        ksum = np.asarray(jnp.sum(counts, axis=0, dtype=jnp.int32)).astype(
            np.int64
        )
        for i in long_idx:
            ksum[i] = 0  # dummy kernel lane; the multi-word batch owns it
        acc[:] += ksum
        if long_idx:
            lcounts = myers_hw_counts_multiword(
                peq_long, plenl_j, jnp.asarray(codes), jnp.asarray(lens),
                max_e, n_words,
            )
            lsum = np.asarray(
                jnp.sum(lcounts, axis=0, dtype=jnp.int32)
            ).astype(np.int64)
            for j, i in enumerate(long_idx):
                acc[i] += int(lsum[j])

    for _name, seq in FastxReader(fn):
        L = len(seq)
        bucket = _bucket_for(max(L, 1))
        if bucket not in batches:
            rows = max(4, _BATCH_BYTES // bucket)
            batches[bucket] = [
                np.full((rows, bucket), 255, np.uint8),
                np.zeros(rows, np.int32),
                0,
            ]
        codes, lens, nb = batches[bucket]
        codes[nb, :L] = _encode(seq, lut)
        codes[nb, L:] = 255
        lens[nb] = L
        batches[bucket][2] = nb + 1
        if batches[bucket][2] == codes.shape[0]:
            flush(bucket)
    for bucket in list(batches):
        flush(bucket)
    for i in range(len(patterns)):
        totals[i][0] += int(acc[2 * i])
        totals[i][1] += int(acc[2 * i + 1])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    max_e = 0
    pattern_fn = out_fn = None
    opts, pos = ketopt(argv, "p:o:e:")
    for c, a in opts:
        if c == "p":
            pattern_fn = a
        elif c == "o":
            out_fn = a
        elif c == "e":
            max_e = c_atoi(a)
    if not pattern_fn or not out_fn or len(pos) < 1:
        e = sys.stderr
        e.write(
            "Usage: ed-vaf-counter [options] -p <patterns.txt> -o <output.vaf> <reads.fq> [reads2.fq ...]\n"
        )
        e.write("Options:\n")
        e.write("  -p FILE   input pattern file\n")
        e.write("  -o FILE   output VAF file\n")
        e.write(
            f"  -e INT    maximum edit distance for approximate matching [{max_e}]\n"
        )
        e.write("\nDescription:\n")
        e.write("  This program uses edlib to search for pattern k-mers in FASTQ reads.\n")
        e.write("  Unlike vaf-counter which extracts all k-mers from reads and looks them up,\n")
        e.write("  ed-vaf-counter searches for each pattern k-mer in the reads using approximate\n")
        e.write("  string matching. This can be more efficient for small pattern sets.\n")
        e.write("  Set -e 0 for exact matches only (default), or higher values to allow mismatches.\n")
        return 1

    minfo("main", "Loading patterns...")
    try:
        patterns = read_patterns(pattern_fn)
    except OSError:
        sys.stderr.write("Error: failed to load pattern file\n")
        return 1
    minfo("main", f"Loaded {len(patterns)} patterns")

    minfo(
        "main",
        f"Searching for k-mers in FASTQ files (max edit distance: {max_e})...",
    )
    totals = [[0, 0] for _ in patterns]
    for fn in pos:
        minfo("main", f"Processing {fn}...")
        count_fastq(fn, patterns, max_e, totals)

    for i, p in enumerate(patterns):
        p.ref_count, p.alt_count = totals[i]

    minfo("main", "Writing VAF file...")
    avg_depth = write_vaf_file(out_fn, patterns)
    minfo("main", f"Done. Average depth: {avg_depth:.2f}")
    return 0
