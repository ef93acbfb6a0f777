"""Vectorized canonical k-mer extraction over flat packed base buffers.

The reference extracts k-mers with a sequential rolling window per read
(/root/reference/kc-c1.c:31-49, kc-c4.c:85-100): forward 2-bit code
appended at the bottom, reverse complement at the top, window reset on
any non-ACGT base, canonical = min(fwd, rev).

Data-parallel design: reads are packed end-to-end into one flat uint8
code buffer with a single invalid byte (code 4) separating consecutive
reads.  Because an invalid base resets the window, windows never
straddle a read boundary, so the k-mer multiset over the flat buffer
equals the union of per-read multisets — and every window is computed
independently and in parallel instead of via a sequential scan:

    fwd[i] = sum_d code[i-d] << 2d            (d = 0..k-1)
    rev[i] = sum_d (3-code[i-d]) << 2(k-1-d)

Each sum is k shifted ORs on uint32 planes (hi plane for bit positions
>= 32), i.e. ~4k elementwise ops per position, which XLA fuses into one
loop.  Window validity ("no invalid base among the last k") is an OR of
the same k shifted slices of the invalid indicator, fused alongside.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from . import u64 as u
from .hash64 import hash64

U32 = jnp.uint32


class KmerBatch(NamedTuple):
    """Per-position k-mers over a flat buffer: kmer ending at index i."""

    kmer: u.U64  # canonical k-mer (or its hash64) per position
    valid: jnp.ndarray  # bool; True where a complete ACGT-only window ends


def extract_canonical(codes: jnp.ndarray, k: int, apply_hash64: bool = True) -> KmerBatch:
    """codes: (N,) uint8 in {0..3 valid, >=4 invalid}.  Static k in [1, 32]."""
    assert 1 <= k <= 32, "reference counters are limited to k <= 32"
    n = codes.shape[0]
    is_bad = codes >= jnp.uint8(4)
    c32 = jnp.where(is_bad, jnp.uint8(0), codes).astype(U32)
    comp = jnp.uint32(3) - c32  # complement of the (sanitized) code

    pad = jnp.zeros((k - 1,), U32)
    pc = jnp.concatenate([pad, c32])
    pr = jnp.concatenate([pad, comp])
    # positions before k-1 have no full window: pad the bad flags with True
    pb = jnp.concatenate([jnp.ones((k - 1,), jnp.bool_), is_bad])

    zero = jnp.zeros((n,), U32)
    fwd_lo, fwd_hi, rev_lo, rev_hi = zero, zero, zero, zero
    win_bad = jnp.zeros((n,), jnp.bool_)
    for d in range(k):
        win_bad = win_bad | pb[k - 1 - d : k - 1 - d + n]
        vf = pc[k - 1 - d : k - 1 - d + n]  # code[i-d]
        bp = 2 * d
        if bp < 32:
            fwd_lo = fwd_lo | (vf << bp)
        else:
            fwd_hi = fwd_hi | (vf << (bp - 32))
        vr = pr[k - 1 - d : k - 1 - d + n]  # 3 - code[i-d]
        bq = 2 * (k - 1 - d)
        if bq < 32:
            rev_lo = rev_lo | (vr << bq)
        else:
            rev_hi = rev_hi | (vr << (bq - 32))

    fwd = u.U64(fwd_hi, fwd_lo)
    rev = u.U64(rev_hi, rev_lo)
    canon = u.min_(fwd, rev)
    if k == 32:
        # x86-64 reference semantics: `mask = (1ULL << k*2) - 1` shifts
        # by 64, which x86 computes mod 64, giving mask = 0 — the fwd
        # key is always 0 and canonical = min(0, rev) = 0, so EVERY
        # valid window counts as one key (kc-c1 -k32 prints one distinct
        # k-mer).  Reproduced for bit-identical output.
        canon = u.U64(jnp.zeros_like(canon.hi), jnp.zeros_like(canon.lo))

    # validity: no invalid base within the trailing window of k positions
    # (a windowed OR over the same k slices, fused into the loop above)
    valid = ~win_bad

    if apply_hash64:
        canon = hash64(canon, 2 * k)
    return KmerBatch(canon, valid)
