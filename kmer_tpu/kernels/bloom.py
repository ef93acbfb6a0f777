"""Blocked bloom filter — the device equivalent of yak_bf_t.

Replicates the probe math of yak_bf_insert exactly
(/root/reference/yak-count.c:69-108): 512-bit cache-line blocks
(YAK_BLK_SHIFT 9), double-hashing probe z += h2 within the block, and
the (h2&31)==0 adjustment.  yak keeps one bloom per prefix subtable
(yak-count.c:122-125) keyed by x = y >> pre with local size
2^(n_shift - pre) bits; we lay those subtable blooms out contiguously:
global bit = pre_idx << (n_shift - pre) | local bit.

Storage is one byte per bit.  This costs 8x the memory of a packed
bitset but buys an exact vectorized OR-scatter: setting a bit is
`bits.at[idx].max(1)`, which is idempotent and duplicate-safe, with no
atomics or read-modify-write races.  (A packed bitset would need a
bitwise-OR scatter combiner, which XLA does not provide.)

Batch semantics: `insert` tests every lane against the *pre-batch*
state, then sets all probed bits.  Within-batch duplicate handling
(first occurrence sets, later occurrences pass) is reconstructed by the
caller via first-occurrence ranking (see count_table.insert_gated);
cross-key bit sharing *within one batch* is the only divergence from
the sequential reference; it is invisible in single-file yak-count
output (pass-2 recount + shrink drop FP-admitted singletons) and
observable only in two-file mode — which insert_sequential closes
exactly.  BOTH the single-chip YakEngine and the multi-chip
MeshYakEngine default to the sequential-exact form
(KMER_TPU_EXACT_BLOOM=0 opts out for speed): on the mesh each owner
chip's received lane order equals the global stream order restricted
to its keys (stable routing sort — dist.sharded._bucketize_by_sort),
so the per-chip sequential replay reproduces yak_bf_insert bit-exactly
(pinned by the mesh two-file golden,
tests/test_golden_counters.py).  The only residual admission
divergence is multi-PROCESS pod ingest, where per-host file sharding
changes the global read order itself (PARITY.md divergence 10).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import u64 as u

BLK_SHIFT = 9  # 512-bit blocks, yak-count.c:13
BLK_MASK = (1 << BLK_SHIFT) - 1


class BloomSpec(NamedTuple):
    pre: int  # prefix bits (subtable count = 2^pre)
    n_shift: int  # total bloom size = 2^n_shift bits across all subtables
    n_hashes: int
    # multi-chip partitioning: a device owning keys with
    # lo & (n_dev - 1) == d holds only the 2^(pre - owner_bits) subtable
    # blooms whose prefix is congruent to d; probe VALUES per key are
    # identical to the owner_bits=0 layout (the low owner_bits of the
    # prefix index are constant on a device and drop out of the base),
    # so sharding never changes which keys a bloom admits.
    owner_bits: int = 0


def make_bits(spec: BloomSpec) -> jnp.ndarray:
    total_bits = 1 << (spec.n_shift - spec.owner_bits)
    assert spec.n_shift - spec.owner_bits <= 31, (
        "per-shard bloom limited to 2^31 bits (engines clamp -b via "
        "pipeline.yak._clamp_bf_shift)"
    )
    local_shift = spec.n_shift - spec.pre
    assert BLK_SHIFT <= local_shift, "bloom smaller than one block per subtable"
    assert spec.owner_bits <= spec.pre
    return jnp.zeros((total_bits,), jnp.uint8)


def _probe_indices(keys: u.U64, spec: BloomSpec):
    """Global byte-per-bit indices of the n_hashes probes for each lane."""
    local_shift = spec.n_shift - spec.pre  # per-subtable bloom bits
    xs = local_shift - BLK_SHIFT  # block index bits
    pre_idx = (keys.lo & jnp.uint32((1 << spec.pre) - 1)) >> spec.owner_bits
    x = u.shr(keys, spec.pre)
    blk = u.shr(x, 0).lo & jnp.uint32((1 << xs) - 1) if xs < 32 else x.lo
    h1 = (u.shr(x, xs).lo & jnp.uint32(BLK_MASK)).astype(jnp.int32)
    h2 = (u.shr(x, local_shift).lo & jnp.uint32(BLK_MASK)).astype(jnp.int32)
    # avoid cycling over few bits (yak-count.c:99)
    h2 = jnp.where((h2 & 31) == 0, (h2 + 1) & BLK_MASK, h2)
    base = (
        pre_idx.astype(jnp.int64) << local_shift
        if spec.n_shift > 31
        else (pre_idx.astype(jnp.int32) << local_shift)
    )
    base = base + (blk.astype(jnp.int32) << BLK_SHIFT)
    idxs = []
    z = h1
    for _ in range(spec.n_hashes):
        idxs.append(base + z)
        z = (z + h2) & BLK_MASK
    return idxs


def insert(
    bits: jnp.ndarray, keys: u.U64, valid: jnp.ndarray, spec: BloomSpec
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Test-and-set all probes.  Returns (bits', preset) where preset[i]
    is True iff all n_hashes bits were set before this batch
    (the `yak_bf_insert(...) == n_hash` gate, yak-count.c:162-163)."""
    idxs = _probe_indices(keys, spec)
    n = bits.shape[0]
    # read all probes against the pre-batch state first, then set
    preset = jnp.ones_like(valid)
    for ix in idxs:
        preset = preset & (bits[jnp.where(valid, ix, 0)] == 1)
    for ix in idxs:
        ixs = jnp.where(valid, ix, n)
        bits = bits.at[ixs].max(jnp.uint8(1), mode="drop")
    return bits, preset & valid


def insert_sequential(
    bits: jnp.ndarray, keys: u.U64, valid: jnp.ndarray, spec: BloomSpec
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """insert() with the reference's SEQUENTIAL test-and-set semantics
    (yak_bf_insert runs lane by lane, yak-count.c:91-108): preset[i] is
    True iff every probe bit of lane i was set either before the batch
    OR by a strictly earlier lane of the same batch.  The batched
    insert() tests only the pre-batch state, which admits strictly
    fewer false positives — observable in two-file yak-count; this
    closes that gap and is the DEFAULT on both the single-chip and
    mesh engines (KMER_TPU_EXACT_BLOOM=0 opts out).

    Formulation without a serial loop: an in-batch probe bit b of lane
    i counts as set iff min{lane j probing b} < i — ONE (bit, lane)
    sort groups each bit's probes with the first setter at the segment
    start, and a scatter by the sorted position payload restores probe
    order.  Costs one 3-plane sort + one gather + one scatter of
    n_hashes x lanes — only the exact mode pays it.

    Same-lane duplicate probes (h2 cycling back over the 512-bit
    block, yak-count.c:100) also count as set, because yak_bf_insert
    tests AFTER setting earlier probes of the SAME call
    (`cnt += !!(*q & u); *q |= u;`, yak-count.c:103-104): within equal
    (bit, lane) the stable sort keeps probe order, so every non-first
    duplicate is marked set."""
    idxs = _probe_indices(keys, spec)
    n = bits.shape[0]
    n_lanes = keys.lo.shape[0]
    pos32 = jnp.arange(n_lanes, dtype=jnp.uint32)
    sent = jnp.uint32(0xFFFFFFFF)
    fb = jnp.concatenate(
        [jnp.where(valid, ix.astype(jnp.uint32), sent) for ix in idxs]
    )
    fl = jnp.tile(pos32, spec.n_hashes)
    fpos = jnp.arange(fb.shape[0], dtype=jnp.uint32)
    s_bit, s_lane, s_pos = jax.lax.sort((fb, fl, fpos), num_keys=2)
    p = jnp.arange(fb.shape[0], dtype=jnp.int32)
    starts = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), s_bit[1:] != s_bit[:-1]]
    )
    start_pos = jax.lax.cummax(jnp.where(starts, p, jnp.int32(0)))
    first_lane = jnp.take(s_lane, start_pos)
    dup_prev = jnp.concatenate([
        jnp.zeros((1,), jnp.bool_),
        (s_bit[1:] == s_bit[:-1]) & (s_lane[1:] == s_lane[:-1]),
    ])
    in_batch = ((first_lane < s_lane) | dup_prev).astype(jnp.uint32)
    # restore probe order: s_pos is a permutation, so one scatter.  (A
    # 1-key sort on it is the same result, but XLA's GPU compiler
    # rewrites such a sort into a scatter that its verifier rejects.)
    verdict = jnp.zeros_like(in_batch).at[s_pos].set(
        in_batch, unique_indices=True)
    by_probe = verdict.reshape(spec.n_hashes, n_lanes)
    preset = valid
    for h, ix in enumerate(idxs):
        pre = bits[jnp.where(valid, ix, 0)] == 1
        preset = preset & (pre | (by_probe[h] == 1))
    for ix in idxs:
        ixs = jnp.where(valid, ix, n)
        bits = bits.at[ixs].max(jnp.uint8(1), mode="drop")
    return bits, preset


def test(bits: jnp.ndarray, keys: u.U64, valid: jnp.ndarray, spec: BloomSpec) -> jnp.ndarray:
    """Pure membership test (all bits set), no mutation."""
    idxs = _probe_indices(keys, spec)
    ok = jnp.ones_like(valid)
    for ix in idxs:
        ok = ok & (bits[jnp.where(valid, ix, 0)] == 1)
    return ok & valid
