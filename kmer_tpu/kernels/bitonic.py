"""Bitonic merge of sorted key-plane runs — the merge primitive.

`lax.sort` cannot exploit pre-sorted input, so re-sorting the
concatenation of two sorted runs repeats the full sort.  A bitonic MERGE
is only the last log2(n) compare-exchange stages: reverse the second
run (making the whole array one bitonic sequence), then run stages at
strides n/2, n/4, ..., 1, where lane i exchanges with lane i XOR s — no
gathers, no scatters, pure strided data movement (`_xla_stage`: two
rolls and an iota-mask select per plane).

Streaming engines can sort each arriving block's planes under the
host->device ingest and pay only the final merges at finalization; see
table.compactor.KmerCompactor(stream_sorted=...).

The reference has no analog (khashl inserts in-place,
kc-c4.c:116-128).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

U32 = jnp.uint32
SENT = jnp.uint32(0xFFFFFFFF)

def _xla_stage(h, l, s):
    """One compare-exchange at stride s on flat (n,) planes: partner is
    lane i XOR s, fetched with two rolls; lane keeps min if bit s of its
    index is 0, else max.  (i XOR s == i + s when bit s is 0, i - s when
    set; the roll wrap-around only lands on lanes taking the other
    branch, so the select discards it.)"""
    n = h.shape[0]
    idx = jax.lax.iota(U32, n)
    bit0 = (idx & U32(s)) == 0
    hp, hm = jnp.roll(h, -s), jnp.roll(h, s)
    lp, lm = jnp.roll(l, -s), jnp.roll(l, s)
    ph = jnp.where(bit0, hp, hm)
    pl = jnp.where(bit0, lp, lm)
    less = (ph < h) | ((ph == h) & (pl < l))
    take = jnp.where(bit0, less, ~less)
    return jnp.where(take, ph, h), jnp.where(take, pl, l)


def _xla_stage1(l, s):
    """Single-plane _xla_stage (one-plane compactor mode: keys < 2^31
    live in the lo plane alone, the hi plane is derived afterwards)."""
    n = l.shape[0]
    idx = jax.lax.iota(U32, n)
    bit0 = (idx & U32(s)) == 0
    lp, lm = jnp.roll(l, -s), jnp.roll(l, s)
    pl = jnp.where(bit0, lp, lm)
    less = pl < l
    take = jnp.where(bit0, less, ~less)
    return jnp.where(take, pl, l)


def _xla_stage3(h, l, x, s):
    """Three-plane _xla_stage: lex comparator over (h, l, x).  Used for
    (key_hi, key_lo, lane_idx) triples — the deferred yak admission's
    stream runs, where the lane index is globally unique, so the triple
    comparator is a total order and the merge is deterministic."""
    n = h.shape[0]
    idx = jax.lax.iota(U32, n)
    bit0 = (idx & U32(s)) == 0
    hp, hm = jnp.roll(h, -s), jnp.roll(h, s)
    lp, lm = jnp.roll(l, -s), jnp.roll(l, s)
    xp, xm = jnp.roll(x, -s), jnp.roll(x, s)
    ph = jnp.where(bit0, hp, hm)
    pl = jnp.where(bit0, lp, lm)
    px = jnp.where(bit0, xp, xm)
    less = ((ph < h) | ((ph == h) & ((pl < l)
            | ((pl == l) & (px < x)))))
    take = jnp.where(bit0, less, ~less)
    return (jnp.where(take, ph, h), jnp.where(take, pl, l),
            jnp.where(take, px, x))


def _cascade(stage, planes):
    """Merge flat planes whose two halves are each ascending-sorted
    (under the lex order `stage` compares) into fully sorted planes.  n
    must be a power of two (callers pad with the all-ones sentinel,
    which sorts last and stays in the tail).  The stride is dynamic
    inside a fori_loop so buffers are reused across stages (unrolling
    materializes one temporary per stage)."""
    n = planes[0].shape[0]
    assert n & (n - 1) == 0, "merge needs power-of-two lanes"
    half = n // 2
    planes = tuple(jnp.concatenate([p[:half], p[half:][::-1]])
                   for p in planes)
    log2n = n.bit_length() - 1

    def body(i, ps):
        s = jnp.int32(1) << (log2n - 1 - i)
        out = stage(*ps, s)
        return out if isinstance(out, tuple) else (out,)

    return jax.lax.fori_loop(0, log2n, body, planes)


def _merge_core1(lo):
    """Single-plane merge (one-plane compactor keys)."""
    return _cascade(_xla_stage1, (lo,))[0]


def _merge_core(hi, lo):
    """Two-plane merge: lex keys (hi, lo)."""
    return _cascade(_xla_stage, (hi, lo))


def _merge_core3(hi, lo, x):
    """Three-plane merge: lex keys (hi, lo, x) — the deferred yak
    admission's (key_hi, key_lo, lane_idx) stream runs.  Each half must
    be ascending-sorted under the SAME triple order (lax.sort
    num_keys=3, or a stable 2-key sort of ascending-idx planes)."""
    return _cascade(_xla_stage3, (hi, lo, x))


# public jitted forms: the plain ones keep their inputs valid (tests,
# external callers); the donated ones reuse the input planes' device
# memory for the output — stream-sorted finalization merges throwaway
# concat temporaries at GB scale, where donation halves the peak
merge_sorted_halves = jax.jit(_merge_core)
merge_sorted_halves1 = jax.jit(_merge_core1)
merge_sorted_halves3 = jax.jit(_merge_core3)
merge_sorted_halves_donated = partial(jax.jit, donate_argnums=(0, 1))(
    _merge_core)
merge_sorted_halves1_donated = partial(jax.jit, donate_argnums=(0,))(
    _merge_core1)
merge_sorted_halves3_donated = partial(jax.jit, donate_argnums=(0, 1, 2))(
    _merge_core3)


# (run folding — chunk slicing, the binary-counter carry, and the
# sentinel-padded finalize merges — lives in table.stream_ladder, shared
# by the single-chip compactor and the mesh engine)
