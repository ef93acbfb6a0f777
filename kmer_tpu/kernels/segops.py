"""Segment operations over sorted key runs — the sort-based counting core.

Counting by sort + segment reduction (the KMC/DSK approach) instead of a
khashl-style hash table (random access per k-mer,
reference khashl.h:197-221): these helpers implement the segment
machinery with sorts, scans and one scatter-add histogram.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from . import u64 as u

I32 = jnp.int32


def sort_keys(keys: u.U64, valid: jnp.ndarray) -> u.U64:
    """Sort keys ascending; invalid lanes become the all-ones sentinel and
    sort to the end.  64-bit order == lexicographic (hi, lo)."""
    hi = jnp.where(valid, keys.hi, jnp.uint32(0xFFFFFFFF))
    lo = jnp.where(valid, keys.lo, jnp.uint32(0xFFFFFFFF))
    hi_s, lo_s = jax.lax.sort((hi, lo), num_keys=2)
    return u.U64(hi_s, lo_s)


def sort_keys_with_payload(keys: u.U64, payload, valid, num_keys: int = 2):
    hi = jnp.where(valid, keys.hi, jnp.uint32(0xFFFFFFFF))
    lo = jnp.where(valid, keys.lo, jnp.uint32(0xFFFFFFFF))
    out = jax.lax.sort((hi, lo) + tuple(payload), num_keys=num_keys)
    return u.U64(out[0], out[1]), out[2:]


def segment_starts(keys_sorted: u.U64) -> jnp.ndarray:
    """True where a new key segment begins (position 0 or key != prev)."""
    hi, lo = keys_sorted.hi, keys_sorted.lo
    ne = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return jnp.concatenate([jnp.ones((1,), jnp.bool_), ne])


def segment_end_lengths(starts: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """For each lane, (is_segment_end, length_of_its_segment_if_end).

    Length of a segment = end_pos - start_pos + 1, with start positions
    propagated forward by a running max (cummax) — no gathers.
    """
    n = starts.shape[0]
    pos = jnp.arange(n, dtype=I32)
    start_pos = jax.lax.cummax(jnp.where(starts, pos, I32(0)))
    is_end = jnp.concatenate([starts[1:], jnp.ones((1,), jnp.bool_)])
    length = pos - start_pos + 1
    return is_end, length


# Masked lanes go to this many dummy bins past the end (sliced off):
# after a sort almost every lane is masked, and parking them all in one
# bin would send hundreds of millions of atomic adds to one address.
HIST_SPILL = 1024


def histogram(bins: jnp.ndarray, mask: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Histogram of min(bins, n_bins - 1) over the lanes where mask is
    True, as one scatter-add (i32 counts; masked lanes are not counted)."""
    lane = jax.lax.iota(I32, bins.shape[0])
    b = jnp.where(mask, jnp.minimum(bins, n_bins - 1),
                  n_bins + (lane & (HIST_SPILL - 1)))
    return jnp.zeros((n_bins + HIST_SPILL,), I32).at[b].add(1)[:n_bins]


def segmented_cummin(starts: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """Per-position running minimum since the last segment start (the
    classic segmented-scan combine, associative)."""

    def combine(a, b):
        af, av = a
        bf, bv = b
        return af | bf, jnp.where(bf, bv, jnp.minimum(av, bv))

    _, out = jax.lax.associative_scan(combine, (starts, vals))
    return out


def count_histogram(
    keys: u.U64, valid: jnp.ndarray, n_bins: int, max_count=None
) -> jnp.ndarray:
    """Histogram of per-distinct-key multiplicities in one fused pass:
    sort -> segment lengths -> histogram.  Equivalent to
    inserting every key into a count table (saturating at max_count)
    and binning the counts (print_hist, kc-c1.c:66-77)."""
    ks = sort_keys(keys, valid)
    starts = segment_starts(ks)
    is_end, length = segment_end_lengths(starts)
    # invalid lanes were mapped to the all-ones sentinel and sorted last;
    # subtract them from the final segment (any genuine all-ones keys —
    # only possible at k=32 — remain counted exactly).
    n = length.shape[0]
    n_invalid = jnp.sum((~valid).astype(I32))
    is_last = jnp.arange(n, dtype=I32) == (n - 1)
    length = jnp.where(is_last, length - n_invalid, length)
    mask = is_end & (length > 0)
    if max_count is not None:
        length = jnp.minimum(length, I32(max_count))
    return histogram(length, mask, n_bins)
