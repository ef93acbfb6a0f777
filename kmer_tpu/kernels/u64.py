"""Emulated 64-bit unsigned integer ops as (hi, lo) uint32 plane pairs.

Every k-mer / hash value is carried as two uint32 planes, so the code
needs no 64-bit integer support (JAX runs with x64 disabled).  All ops are elementwise,
shape-polymorphic, and jit-safe.  Shift amounts are Python ints (static),
which is all the k-mer kernels need.

Semantics mirror C uint64_t arithmetic (mod 2^64) as used throughout the
reference counters (e.g. /root/reference/kc-c4.c:40-50 hash64,
/root/reference/kc-c1.c:35-48 rolling window update).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_U32_MAX = np.uint32(0xFFFFFFFF)


class U64(NamedTuple):
    """A 64-bit unsigned integer as two uint32 planes."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def u64(hi, lo) -> U64:
    return U64(jnp.asarray(hi, U32), jnp.asarray(lo, U32))


def from_int(value: int, shape=()) -> U64:
    """Broadcast a Python int constant to a U64 of the given shape."""
    value &= (1 << 64) - 1
    hi = jnp.full(shape, np.uint32(value >> 32), U32)
    lo = jnp.full(shape, np.uint32(value & 0xFFFFFFFF), U32)
    return U64(hi, lo)


def from_np(arr: np.ndarray) -> U64:
    arr = np.asarray(arr, np.uint64)
    return U64(
        jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def to_np(x: U64) -> np.ndarray:
    hi = np.asarray(x.hi, np.uint64)
    lo = np.asarray(x.lo, np.uint64)
    return (hi << np.uint64(32)) | lo


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(U32)
    return U64(a.hi + b.hi + carry, lo)


def sub(a: U64, b: U64) -> U64:
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(U32)
    return U64(a.hi - b.hi - borrow, lo)


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def and_(a: U64, b: U64) -> U64:
    return U64(a.hi & b.hi, a.lo & b.lo)


def or_(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


def not_(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


def shl(a: U64, s: int) -> U64:
    """Left shift by a static amount s in [0, 64)."""
    if s == 0:
        return a
    if s < 32:
        return U64((a.hi << s) | (a.lo >> (32 - s)), a.lo << s)
    if s == 32:
        return U64(a.lo, jnp.zeros_like(a.lo))
    return U64(a.lo << (s - 32), jnp.zeros_like(a.lo))


def shr(a: U64, s: int) -> U64:
    """Logical right shift by a static amount s in [0, 64)."""
    if s == 0:
        return a
    if s < 32:
        return U64(a.hi >> s, (a.lo >> s) | (a.hi << (32 - s)))
    if s == 32:
        return U64(jnp.zeros_like(a.hi), a.hi)
    return U64(jnp.zeros_like(a.hi), a.hi >> (s - 32))


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def lt(a: U64, b: U64) -> jnp.ndarray:
    """Unsigned a < b."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def min_(a: U64, b: U64) -> U64:
    take_a = lt(a, b)
    return U64(jnp.where(take_a, a.hi, b.hi), jnp.where(take_a, a.lo, b.lo))


def where(cond: jnp.ndarray, a: U64, b: U64) -> U64:
    return U64(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))


def mask_bits(nbits: int) -> Tuple[int, int]:
    """(hi, lo) uint32 constants of a mask with the low `nbits` bits set."""
    assert 0 < nbits <= 64
    full = (1 << nbits) - 1
    return (full >> 32) & 0xFFFFFFFF, full & 0xFFFFFFFF


def and_const(a: U64, const: int) -> U64:
    hi_c = np.uint32((const >> 32) & 0xFFFFFFFF)
    lo_c = np.uint32(const & 0xFFFFFFFF)
    return U64(a.hi & hi_c, a.lo & lo_c)
