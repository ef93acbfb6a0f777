"""The invertible 64-bit integer hash used by the reference counters.

Bit-for-bit equivalent to hash64()/yak_hash64() in the reference
(/root/reference/kc-c4.c:40-50, /root/reference/yak-count.c:48-58),
implemented on (hi, lo) uint32 planes (kernels/u64.py).

Also provides the khashl stock kh_hash_uint64 (/root/reference/khashl.h:334-343)
and the murmur-finalizer kmer_hash of vaf-counter
(/root/reference/vaf-counter.c:56-63) — both only used to derive *slot*
indices, where our tables are free to differ, but having exact versions
keeps unit-testing honest.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import u64 as u


def hash64(key: u.U64, mask_nbits: int) -> u.U64:
    """Jenkins-style invertible hash, masked to the low `mask_nbits` bits.

    mask_nbits = 2*k for k-mer size k (see kc-c4.c:88 `mask = (1ULL<<k*2)-1`).
    """
    mask = (1 << mask_nbits) - 1

    def m(x: u.U64) -> u.U64:
        if mask_nbits >= 64:
            return x
        return u.and_const(x, mask)

    # key = (~key + (key << 21)) & mask
    key = m(u.add(u.not_(key), u.shl(key, 21)))
    # key = key ^ key >> 24
    key = u.xor(key, u.shr(key, 24))
    # key = ((key + (key << 3)) + (key << 8)) & mask   (key * 265)
    key = m(u.add(u.add(key, u.shl(key, 3)), u.shl(key, 8)))
    # key = key ^ key >> 14
    key = u.xor(key, u.shr(key, 14))
    # key = ((key + (key << 2)) + (key << 4)) & mask   (key * 21)
    key = m(u.add(u.add(key, u.shl(key, 2)), u.shl(key, 4)))
    # key = key ^ key >> 28
    key = u.xor(key, u.shr(key, 28))
    # key = (key + (key << 31)) & mask
    key = m(u.add(key, u.shl(key, 31)))
    return key


def slot_mix32(key: u.U64) -> jnp.ndarray:
    """Cheap 32-bit mix of a u64 key for table slot addressing.

    This does NOT need to match any reference function (bucket layout is
    invisible in outputs); it just needs good dispersion even for raw
    (un-hash64'ed) k-mers as used by kc-c1 (/root/reference/kc-c1.c:43).
    Uses two rounds of the murmur3 finalizer pattern on 32-bit lanes.
    """
    x = key.lo ^ (key.hi * jnp.uint32(0x9E3779B9))
    x ^= x >> 16
    x = x * jnp.uint32(0x85EBCA6B)
    x ^= x >> 13
    x = x * jnp.uint32(0xC2B2AE35)
    x ^= x >> 16
    return x
