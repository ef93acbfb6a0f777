"""Device-resident open-addressing k-mer count table.

The device replacement for khashl-based count tables
(/root/reference/khashl.h:197-221 linear-probe put,
/root/reference/kc-c4.c:116-128 per-bucket lock-free insert,
/root/reference/yak-count.c:112-277 yak_ch_t insert/get/clear/hist/shrink).

Design (no atomics, no data-dependent host control flow inside a batch):

* Keys are 64-bit values stored as two uint32 planes plus a one-byte
  state plane (EMPTY / FULL / DELETED) and a uint32 count plane.
* A batch of M k-mers is inserted with a *scatter-arbitrate* loop:
  every unresolved lane probes its next slot, lanes that hit an EMPTY
  slot propose themselves by scatter-max of a unique ticket, the winner
  writes its key, losers re-examine the same slot next round (they will
  either match the winner — a duplicate — or move on).  All lanes
  resolve to a unique slot per distinct key, after which per-slot count
  deltas are applied with one scatter-add (duplicates combine exactly).
* Count saturation (`< KC_MAX` gate, kc-c4.c:126) is reproduced by
  clamping after the batched add: min(cnt + delta, max) == the result
  of sequential gated increments.
* Deletion only marks DELETED (probe chains stay intact); shrink
  rebuilds into a fresh table like yak_ch_shrink (yak-count.c:243-277).

Everything is functional: ops take and return a CountTable pytree, so
they jit/donate cleanly and compose with shard_map for the multi-chip
prefix-sharded layout (see kmer_tpu.dist).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..kernels import u64 as u
from ..kernels.hash64 import slot_mix32

U32 = jnp.uint32
EMPTY, FULL, DELETED = 0, 1, 2


class CountTable(NamedTuple):
    state: jnp.ndarray  # (cap,) uint8: EMPTY/FULL/DELETED
    key_hi: jnp.ndarray  # (cap,) uint32
    key_lo: jnp.ndarray  # (cap,) uint32
    cnt: jnp.ndarray  # (cap,) uint32
    n_full: jnp.ndarray  # () int32, number of FULL slots

    @property
    def capacity(self) -> int:
        return self.state.shape[0]


def make(capacity: int) -> CountTable:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return CountTable(
        state=jnp.zeros((capacity,), jnp.uint8),
        key_hi=jnp.zeros((capacity,), U32),
        key_lo=jnp.zeros((capacity,), U32),
        cnt=jnp.zeros((capacity,), U32),
        n_full=jnp.zeros((), jnp.int32),
    )


class ResolveResult(NamedTuple):
    table: CountTable
    slot: jnp.ndarray  # (M,) int32; == capacity when absent/invalid (drop index)
    found: jnp.ndarray  # (M,) bool; key existed before this batch
    created: jnp.ndarray  # (cap,) bool; slot was claimed by this batch


def resolve_slots(
    table: CountTable,
    keys: u.U64,
    valid: jnp.ndarray,
    create_new: bool,
) -> ResolveResult:
    """Map every valid lane's key to its table slot (claiming new slots).

    With create_new=False, lanes whose key is absent resolve to
    slot == capacity (a drop index for subsequent scatters).
    """
    cap = table.capacity
    m = keys.lo.shape[0]
    lane = jnp.arange(m, dtype=U32)
    base = slot_mix32(keys) & U32(cap - 1)
    cap_mask = U32(cap - 1)

    def cond(c):
        return jnp.any(c["active"])

    def body(c):
        state, key_hi, key_lo = c["state"], c["key_hi"], c["key_lo"]
        active = c["active"]
        idx = ((base + c["off"]) & cap_mask).astype(jnp.int32)
        st = state[idx]
        kh = key_hi[idx]
        kl = key_lo[idx]
        is_empty = (st == EMPTY) & active
        is_match = (st == FULL) & (kh == keys.hi) & (kl == keys.lo) & active

        if create_new:
            # one-shot arbitration: tickets strictly increase across rounds,
            # and a slot is only ever contested in a single round (it becomes
            # FULL immediately after), so no reset is needed.
            tag = c["round"] * U32(m) + lane + U32(1)
            idx_p = jnp.where(is_empty, idx, cap)
            ticket = c["ticket"].at[idx_p].max(tag, mode="drop")
            won = is_empty & (ticket[idx] == tag)
            idx_w = jnp.where(won, idx, cap)
            key_hi = key_hi.at[idx_w].set(keys.hi, mode="drop")
            key_lo = key_lo.at[idx_w].set(keys.lo, mode="drop")
            state = state.at[idx_w].set(jnp.uint8(FULL), mode="drop")
            created = c["created"].at[idx_w].set(True, mode="drop")
            absent_stop = jnp.zeros_like(is_empty)
        else:
            ticket = c["ticket"]
            created = c["created"]
            won = jnp.zeros_like(is_empty)
            absent_stop = is_empty  # terminal empty slot => key absent

        resolved = is_match | won | absent_stop
        slot = jnp.where(is_match | won, idx, c["slot"])
        found = c["found"] | is_match
        # advance past occupied-by-other or deleted slots; lanes that lost an
        # empty-slot claim stay put and re-examine the (now FULL) slot.
        advance = active & ~is_empty & ~is_match
        return dict(
            state=state,
            key_hi=key_hi,
            key_lo=key_lo,
            ticket=ticket,
            created=created,
            off=c["off"] + advance.astype(U32),
            slot=slot,
            found=found,
            active=active & ~resolved,
            round=c["round"] + U32(1),
        )

    init = dict(
        state=table.state,
        key_hi=table.key_hi,
        key_lo=table.key_lo,
        ticket=jnp.zeros((cap,), U32),
        created=jnp.zeros((cap,), jnp.bool_),
        off=jnp.zeros((m,), U32),
        slot=jnp.full((m,), cap, jnp.int32),
        found=jnp.zeros((m,), jnp.bool_),
        active=valid,
        round=jnp.zeros((), U32),
    )
    out = jax.lax.while_loop(cond, body, init)
    new_table = table._replace(
        state=out["state"], key_hi=out["key_hi"], key_lo=out["key_lo"]
    )
    return ResolveResult(new_table, out["slot"], out["found"], out["created"])


def _slot_delta(cap: int, slot: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Per-slot sum of lane weights (slot == cap lanes are dropped)."""
    d = jnp.zeros((cap + 1,), U32).at[slot].add(weights.astype(U32))
    return d[:cap]


def insert(
    table: CountTable,
    keys: u.U64,
    valid: jnp.ndarray,
    max_count: Optional[int],
    weights: Optional[jnp.ndarray] = None,
) -> Tuple[CountTable, jnp.ndarray]:
    """Insert a batch; returns (table, n_new_keys).

    Equivalent to sequentially running the gated-increment insert of the
    reference (kc-c2.c:65-72 / kc-c4.c:116-128) over every valid lane.
    """
    res = resolve_slots(table, keys, valid, create_new=True)
    w = weights if weights is not None else jnp.ones_like(valid, U32)
    w = jnp.where(valid, w, 0)
    delta = _slot_delta(table.capacity, res.slot, w)
    cnt = res.table.cnt + delta
    if max_count is not None:
        cnt = jnp.minimum(cnt, U32(max_count))
    n_new = jnp.sum(res.created).astype(jnp.int32)
    t = res.table._replace(cnt=cnt, n_full=res.table.n_full + n_new)
    return t, n_new


def insert_gated(
    table: CountTable,
    keys: u.U64,
    valid: jnp.ndarray,
    preset: jnp.ndarray,
    max_count: Optional[int],
) -> Tuple[CountTable, jnp.ndarray]:
    """Bloom-gated insert reproducing yak_ch_insert_list with a bloom
    (/root/reference/yak-count.c:156-169): per distinct key with c
    occurrences in the batch, the first occurrence only *sets* bloom
    bits (unless all were already set — `preset`), so the key receives
    c-1+preset increments; keys receiving zero increments are not
    created at all.

    `preset` is bloom.insert's all-bits-were-set flag per lane.
    Slots claimed for keys that end up with zero increments are rolled
    back to DELETED (probe chains through them stay valid).
    """
    res = resolve_slots(table, keys, valid, create_new=True)
    cap = table.capacity
    m = keys.lo.shape[0]
    lane = jnp.arange(m, dtype=jnp.int32)
    first_lane = jnp.full((cap + 1,), m, jnp.int32).at[res.slot].min(lane)
    is_first = first_lane[jnp.minimum(res.slot, cap)] == lane
    contrib = valid & (preset | ~is_first)
    delta = _slot_delta(cap, res.slot, contrib.astype(U32))
    cnt = res.table.cnt + delta
    if max_count is not None:
        cnt = jnp.minimum(cnt, U32(max_count))
    dead = res.created & (delta == 0)
    state = jnp.where(dead, jnp.uint8(DELETED), res.table.state)
    n_dead = jnp.sum(dead).astype(jnp.int32)
    n_new = (jnp.sum(res.created) - n_dead).astype(jnp.int32)
    t = res.table._replace(
        state=state, cnt=cnt, n_full=res.table.n_full + n_new
    )
    # n_dead: DELETED tombstones left by this batch.  Tombstones are
    # probe-opaque (never reclaimed in place — reclaiming would need a
    # khashl-style match-scan before claim) and invisible to n_full, so
    # callers MUST track them and rebuild before they degrade the probe
    # chains: on a singleton-heavy stream every not-yet-admitted key
    # leaves one, and an untracked table runs its data-parallel probe
    # loop minutes long.
    return t, n_new, n_dead


def add_existing(
    table: CountTable,
    keys: u.U64,
    valid: jnp.ndarray,
    max_count: Optional[int],
    weights: Optional[jnp.ndarray] = None,
) -> CountTable:
    """Increment counts only for keys already present (yak pass 2,
    create_new=0: /root/reference/yak-count.c:170-174)."""
    res = resolve_slots(table, keys, valid, create_new=False)
    w = weights if weights is not None else jnp.ones_like(valid, U32)
    w = jnp.where(valid & res.found, w, 0)
    delta = _slot_delta(table.capacity, res.slot, w)
    cnt = res.table.cnt + delta
    if max_count is not None:
        cnt = jnp.minimum(cnt, U32(max_count))
    return res.table._replace(cnt=cnt)


def get(table: CountTable, keys: u.U64, valid: jnp.ndarray) -> jnp.ndarray:
    """Per-lane count, or -1 if absent (yak_ch_get, yak-count.c:179-186)."""
    res = resolve_slots(table, keys, valid, create_new=False)
    safe_slot = jnp.where(res.found, res.slot, 0)
    c = res.table.cnt[safe_slot].astype(jnp.int32)
    return jnp.where(valid & res.found, c, -1)


def hist(table: CountTable, n_bins: int) -> jnp.ndarray:
    """Count histogram over FULL slots: bin = min(cnt, n_bins-1).

    Mirrors print_hist / yak_ch_hist (kc-c1.c:66-77, kc-c4.c:206-234,
    yak-count.c:208-241); bin 0 exists but callers print 1..n_bins-1.
    """
    is_full = table.state == FULL
    b = jnp.minimum(table.cnt, U32(n_bins - 1)).astype(jnp.int32)
    b = jnp.where(is_full, b, n_bins)  # park non-full slots in a dropped bin
    h = jnp.zeros((n_bins + 1,), jnp.int64 if jax.config.jax_enable_x64 else jnp.int32)
    h = h.at[b].add(1)
    return h[:n_bins]


def clear_counts(table: CountTable) -> CountTable:
    """Zero all counts, keep keys (yak_ch_clear, yak-count.c:190-204)."""
    return table._replace(cnt=jnp.zeros_like(table.cnt))


def occupancy(table: CountTable) -> jnp.ndarray:
    return jnp.sum((table.state == FULL).astype(jnp.int32))


def rebuild(
    table: CountTable,
    new_capacity: int,
    min_count: int = 0,
    max_count: Optional[int] = None,
) -> CountTable:
    """Rebuild into a fresh table keeping keys with cnt in [min_count, max].

    With min_count=2 this is yak_ch_shrink (yak-count.c:243-277); with
    min_count=0 it is a plain resize (khashl.h:152-195 rehash).
    """
    hi_max = max_count if max_count is not None else 0xFFFFFFFF
    keep = (
        (table.state == FULL)
        & (table.cnt >= U32(min_count))
        & (table.cnt <= U32(hi_max))
    )
    fresh = make(new_capacity)
    keys = u.U64(table.key_hi, table.key_lo)
    new_table, _ = insert(fresh, keys, keep, max_count=None, weights=table.cnt)
    return new_table
