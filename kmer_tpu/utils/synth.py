"""Seeded synthetic inputs shared by bench.py and chip_smoke.py.

A 24 Mb random genome, 150 bp reads sampled from it with 0.5%
substitutions, written as a gzipped FASTQ, and an 8-column SNP pattern
file on the same genome (the snp-pattern-gen output format).  The read
codes come from one generator (iter_read_codes), so a checker can
rebuild exactly what the FASTQ holds without parsing it.  numpy only:
importing this module never starts JAX.
"""

from __future__ import annotations

import os
import zlib
from typing import Iterator

import numpy as np

READ_LEN = 150
GENOME_MB = 24
ERROR_RATE = 0.005
CHUNK_READS = 100_000
ACGT = np.frombuffer(b"ACGT", np.uint8)


def genome(genome_mb: int = GENOME_MB) -> np.ndarray:
    """Base codes 0..3 of the synthetic genome."""
    rng = np.random.default_rng(1)
    return rng.integers(0, 4, genome_mb * 1 << 20, dtype=np.uint8)


def n_reads(mbases: int, read_len: int = READ_LEN) -> int:
    return mbases * 1_000_000 // read_len


def iter_read_codes(mbases: int, read_len: int = READ_LEN,
                    ) -> Iterator[np.ndarray]:
    """(n, read_len) uint8 base-code chunks, in FASTQ order."""
    g = genome()
    total = n_reads(mbases, read_len)
    rng = np.random.default_rng(7)
    for off in range(0, total, CHUNK_READS):
        n = min(CHUNK_READS, total - off)
        starts = rng.integers(0, g.shape[0] - read_len, n)
        codes = g[starts[:, None] + np.arange(read_len)[None, :]]
        err = rng.random(codes.shape) < ERROR_RATE
        yield np.where(err, rng.integers(0, 4, codes.shape), codes).astype(
            np.uint8)


def reads_path(data_dir: str, mbases: int) -> str:
    return os.path.join(data_dir, f"reads_{mbases}M_{READ_LEN}bp.fq.gz")


def ensure_reads_file(data_dir: str, mbases: int) -> str:
    """Write (once) the gzipped FASTQ of iter_read_codes(mbases)."""
    path = reads_path(data_dir, mbases)
    if os.path.exists(path):
        return path
    os.makedirs(data_dir, exist_ok=True)
    qual = b"I" * READ_LEN
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        comp = zlib.compressobj(1, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        i = 0
        for codes in iter_read_codes(mbases):
            seqs = ACGT[codes]
            parts = []
            for row in seqs:
                parts.append(b"@r%d\n%s\n+\n%s\n" % (i, row.tobytes(), qual))
                i += 1
            f.write(comp.compress(b"".join(parts)))
        f.write(comp.flush())
    os.replace(tmp, path)
    return path


def ensure_pattern_file(data_dir: str, n_snps: int = 21_000,
                        k: int = 21) -> str:
    """Write (once) an 8-column SNP pattern file: n_snps sites on the
    synthetic genome, ref k-mer from the genome, alt = centre base
    substituted (snp-pattern-gen.c:351-353)."""
    path = os.path.join(data_dir, f"patterns_{n_snps}_k{k}.txt")
    if os.path.exists(path):
        return path
    os.makedirs(data_dir, exist_ok=True)
    g = genome()
    acgt = "ACGT"
    flank = k // 2
    rng = np.random.default_rng(13)
    pos = np.sort(rng.choice(
        np.arange(flank + 1, g.shape[0] - flank - 1, 64), n_snps,
        replace=False,
    ))
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        for i, p in enumerate(pos):
            window = g[p - flank : p + flank + 1]
            ref = acgt[window[flank]]
            alt = acgt[(window[flank] + 1 + rng.integers(0, 3)) % 4]
            ref_kmer = "".join(acgt[c] for c in window)
            alt_kmer = ref_kmer[:flank] + alt + ref_kmer[flank + 1:]
            f.write(f"chr1\t{p}\t{p + 1}\trs{i}\t{ref}\t{alt}\t"
                    f"{ref_kmer}\t{alt_kmer}\n")
    os.replace(tmp, path)
    return path
